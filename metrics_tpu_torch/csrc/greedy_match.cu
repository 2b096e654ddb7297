// Greedy COCO matching of detections to ground truths, for Hopper (sm_90a).
//
// Replaces `_merged_greedy_match` in metrics_tpu/ops/kernels/iou_matching.py:83.
// That function is not a Pallas kernel: it is a lax.scan over the D detections,
// vmapped over (area range x IoU threshold) and over images, which XLA runs as
// one fused loop. In PyTorch the same scan is a Python loop of D steps of about
// ten launches each, so it becomes this kernel.
//
// What it computes, per image b, area range a and threshold t, with the
// detections in score-descending order: a matched flag per ground truth, all
// false at first; then for d = 0 .. D-1, in order,
//   candidate[g] = gt_labels[g] == det_labels[d] && gt_ok[g] && !gt_ignore[a][g]
//                  && !matched[g]
//   v[g] = ious[d][g] * candidate[g]                (float32 multiply)
//   m = argmax v (first index of the maximum, as jnp.argmax and torch.argmax)
//   ok = max v > thresholds[t] && det_ok[d]
//   if ok: matched[m] = true
//   out[b][a][t][d] = ok
// Inputs: ious (B, D, G) f32, already zero outside valid pairs; det_ok (B, D)
// and gt_ok (B, G) bool; det_labels (B, D) and gt_labels (B, G) int32;
// gt_ignore (B, A, G) bool; thresholds (T,) f32. Output: (B, A, T, D) bool.
// Results equal the PyTorch plain version bit for bit.
//
// What bounds it on an H100: bytes, B*D*G*4 of IoU rows read once plus the
// flags and labels, and B*A*T*D flags written: 5.6 MB, or 1.71 us at 3.35 TB/s,
// at the shape `compute` runs on COCO (B=256, A=4, T=10, D=128, G=32); 9.7 MB or
// 2.9 us at G=64. Before that, the dependency chain: each (image, area,
// threshold) takes its D steps in order, and a step needs the matches of the
// one before. At about 100 cycles a step (a shared-memory load, a warp
// reduction, a ballot), 128 steps take about 6.5 us at 1.98 GHz.
//
// How the design meets that:
// - One block per image stages the image's IoU rows, detection labels and
//   det_ok in shared memory, each with one bulk asynchronous copy
//   (cp.async.bulk, completion on an mbarrier) where its rows are 16-byte
//   aligned, else with plain loads. Every chain of the image then reads its
//   steps from shared memory. Where the rows do not fit (large D * G), the D
//   axis is staged in slabs, double-buffered: slab s+1 is in flight while slab
//   s is matched. Beyond G = 1,024 (the word-mask path below) only the
//   detection operands are staged; the IoU rows and ground-truth labels are
//   read in global memory, so G is bounded by the mask registers alone:
//   kMaxG = 38,912.
// - A warp carries the chains of one area range, up to kChains = 10 of its
//   thresholds (all of COCO's): the block has A * ceil(T / 10) warps, 4 at
//   COCO's A = 4, T = 10, and none of them is idle (beyond G = 1,024 a warp
//   carries one chain). Within an area the candidate test label == det_label
//   && eligible is the same for every threshold, so the warp does it, and
//   loads the step's IoU, once; only the matched sets differ. The chains'
//   steps are independent and run without branches, so their warp reductions
//   overlap; the next step's inputs are loaded while this step's chains run.
//   The compiler keeps warp-synchronous operations in program order, so the
//   source issues each one (reduce, ballot) for all the warp's chains before
//   the next.
// - Steps that change nothing cost next to nothing: a detection that is not
//   det_ok is skipped; where no lane holds a candidate of any chain (its
//   label has no eligible ground truth in the image: most detections at
//   COCO's 80 classes), v is iou * 0 in every chain and one argmax serves
//   them all, and where every IoU of the image is finite that maximum is 0.0,
//   which passes no threshold >= 0, so the step is skipped too.
// - Each chain's matched set is a bit mask in registers: lane l owns ground
//   truths l, l + 32, l + 64, ... and bit j of its mask is ground truth l + 32j.
// - The argmax is three warp operations on an order-preserving uint32 key of
//   v (NaN on top, -0.0 folded onto +0.0 so that the float compare's ties
//   stay ties): __reduce_max_sync, then __ballot_sync(key == max), and the
//   lowest set lane wins, which is torch.argmax's first index. Beyond G = 32
//   each lane first folds its strided ground truths (the first of its
//   maxima), and a __reduce_min_sync over the tied lanes' indices replaces the
//   ballot. The threshold test compares keys: for non-NaN values the key
//   order is the float order.
// - Each chain keeps its flags of 32 consecutive steps in one warp-uniform
//   register; every 32 steps the warp writes them as 32 consecutive bytes.
//
// The caller allocates the output and passes PyTorch's current stream; nothing
// here allocates or synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNanKey = 0xffffffffu;
constexpr int kChains = 10;           // (area, threshold) chains per warp: COCO's 10 thresholds
constexpr int kMaxWarps = 8;          // warps per block at most; more chains take more blocks
constexpr int kHugeWords = 38;        // beyond G = 1,024: mask words per lane, one chain per warp
constexpr int kMaxG = kHugeWords * kWarp * kWarp;  // 38,912
constexpr int kSharedLimit = 227 * 1024;  // an H100 block's dynamic shared memory, after opt-in
constexpr int kDefaultShared = 48 * 1024;
constexpr int kWholeBudget = 128 * 1024;  // stage every row at once up to this many bytes
constexpr int kSlabBudget = 80 * 1024;    // else each of two slab buffers holds up to this

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// Monotone map of float32 to uint32 for non-NaN values, with -0.0 folded onto
// +0.0 (they compare equal as floats) and every NaN on top. Key 0 is below
// every float and marks a lane that holds no ground truth.
__device__ __forceinline__ unsigned order_key(float v) {
  if (v != v) return kNanKey;
  const unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy global -> shared, completing on `bar`; 16-byte aligned ends.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// How the D axis is staged, decided on the host from the shapes and the
// operands' alignment and passed to the kernel as it is.
// `stage_rows`: the IoU rows and ground-truth labels are staged too (the
// slot paths, G <= 1,024); else only the detection operands are, and the
// word-mask path reads the rest from global memory.
struct Plan {
  int slab_rows;  // detections per slab
  int n_slabs;
  int buffers;    // 1 when every row fits at once, else 2
  int iou_off, lab_off, ok_off, buffer_bytes;  // per buffer, 16-byte aligned
  int label_off;  // the image's ground-truth labels (G int32, when staged), after the buffers
  int bar_off;    // two mbarriers, after the labels
  int shared_bytes;
  bool bulk_iou, bulk_lab, bulk_ok;  // which operands take a bulk copy
};

Plan make_plan(const float* ious, const int* det_labels, const uint8_t* det_ok, int d, int g, bool stage_rows) {
  Plan plan{};
  const int iou_row = stage_rows ? g * 4 : 0;
  const long long row = static_cast<long long>(iou_row) + 4 + 1;
  int rows = d;
  if (row * d > kWholeBudget) {
    rows = static_cast<int>(kSlabBudget / row);
    if (rows >= 16) rows &= ~15;  // keeps the detection operands' slabs 16-byte aligned
    if (rows < 1) rows = 1;
  }
  plan.slab_rows = rows;
  plan.n_slabs = (d + rows - 1) / rows;
  plan.buffers = plan.n_slabs > 1 ? 2 : 1;
  plan.iou_off = 0;
  plan.lab_off = round16(rows * iou_row);
  plan.ok_off = plan.lab_off + round16(rows * 4);
  plan.buffer_bytes = plan.ok_off + round16(rows);
  plan.label_off = plan.buffers * plan.buffer_bytes;
  plan.bar_off = plan.label_off + (stage_rows ? round16(g * 4) : 0);
  plan.shared_bytes = plan.bar_off + 16;
  const bool whole = plan.n_slabs == 1;
  plan.bulk_iou = stage_rows && g % 4 == 0 && aligned16(ious);
  plan.bulk_lab = d % 4 == 0 && (whole || rows % 4 == 0) && aligned16(det_labels);
  plan.bulk_ok = d % 16 == 0 && (whole || rows % 16 == 0) && aligned16(det_ok);
  return plan;
}

// Stage slab s of image b into buffer `buf`: bulk copies issued by thread 0
// (they complete on full[buf]), plain loads by the whole block for the rest.
// The caller makes the plain loads visible with __syncthreads.
__device__ void stage_slab(const Plan& plan, int s, uint8_t* buffer, uint64_t* full, const float* iou_rows,
                           const int* labels, const uint8_t* oks, int d, int g, bool stage_rows) {
  const int row0 = s * plan.slab_rows;
  const int rows = min(plan.slab_rows, d - row0);
  float* s_iou = reinterpret_cast<float*>(buffer + plan.iou_off);
  int* s_lab = reinterpret_cast<int*>(buffer + plan.lab_off);
  uint8_t* s_ok = buffer + plan.ok_off;
  const float* src_iou = iou_rows + static_cast<size_t>(row0) * g;
  if (threadIdx.x == 0) {
    const unsigned tx = (plan.bulk_iou ? rows * g * 4 : 0) + (plan.bulk_lab ? rows * 4 : 0) + (plan.bulk_ok ? rows : 0);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // earlier reads of this buffer come first
    if (tx == 0) {
      mbar_arrive(full);
    } else {
      mbar_expect_tx(full, tx);
      if (plan.bulk_iou) {
        for (long long off = 0; off < static_cast<long long>(rows) * g * 4; off += 32768) {
          const long long left = static_cast<long long>(rows) * g * 4 - off;
          bulk_copy(reinterpret_cast<uint8_t*>(s_iou) + off, reinterpret_cast<const uint8_t*>(src_iou) + off,
                    static_cast<unsigned>(left < 32768 ? left : 32768), full);
        }
      }
      if (plan.bulk_lab) bulk_copy(s_lab, labels + row0, rows * 4, full);
      if (plan.bulk_ok) bulk_copy(s_ok, oks + row0, rows, full);
    }
  }
  if (stage_rows && !plan.bulk_iou) {
    for (int i = threadIdx.x; i < rows * g; i += blockDim.x) s_iou[i] = src_iou[i];
  }
  if (!plan.bulk_lab) {
    for (int i = threadIdx.x; i < rows; i += blockDim.x) s_lab[i] = labels[row0 + i];
  }
  if (!plan.bulk_ok) {
    for (int i = threadIdx.x; i < rows; i += blockDim.x) s_ok[i] = oks[row0 + i];
  }
}

// Lane l owns ground truths l + 32j. kSlots > 0 (G <= 32 * kSlots <= 1,024):
// slot j < kSlots of the lane is bit j of its one-word masks, and the step's
// per-slot keys are computed once per warp and shared by its chains; kSlots
// == 1 takes the ballot argmax. kSlots == 0 (G <= kMaxG): kHugeWords mask
// words per lane, the keys computed per chain from IoU rows and ground-truth
// labels read in global memory (at G = kMaxG a row alone is 152 KB).
template <int kSlots, int kCh>
__global__ void __launch_bounds__(kMaxWarps * kWarp) greedy_match_kernel(
    const float* __restrict__ ious, const uint8_t* __restrict__ det_ok, const int* __restrict__ det_labels,
    const int* __restrict__ gt_labels, const uint8_t* __restrict__ gt_ok, const uint8_t* __restrict__ gt_ignore,
    const float* __restrict__ thresholds, uint8_t* __restrict__ out, const Plan plan, int n_areas, int n_thr, int d,
    int g) {
  constexpr int kMaskWords = kSlots > 0 ? 1 : kHugeWords;
  constexpr bool kStaged = kSlots > 0;  // the IoU rows and ground-truth labels are in shared memory
  extern __shared__ __align__(16) uint8_t smem[];
  int* s_label = reinterpret_cast<int*>(smem + plan.label_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + plan.bar_off);

  const int b = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  // warp (area a, threshold group tg) carries thresholds tg * kCh .. + kCh - 1 of area a
  const int groups = (n_thr + kCh - 1) / kCh;
  const int warp_id = blockIdx.y * (blockDim.x / kWarp) + warp;
  const int area = min(warp_id / groups, n_areas - 1);
  const int first_t = (warp_id - (warp_id / groups) * groups) * kCh;
  const float* iou_rows = ious + static_cast<size_t>(b) * d * g;
  const int* labels = det_labels + static_cast<size_t>(b) * d;
  const uint8_t* oks = det_ok + static_cast<size_t>(b) * d;
  const int* gt_lab = kStaged ? s_label : gt_labels + static_cast<size_t>(b) * g;

  if (threadIdx.x == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  stage_slab(plan, 0, smem, &full[0], iou_rows, labels, oks, d, g, kStaged);
  if (kStaged) {
    for (int i = threadIdx.x; i < g; i += blockDim.x) s_label[i] = gt_labels[static_cast<size_t>(b) * g + i];
  }

  // This warp's chains: their thresholds as keys and their flags (warp-
  // uniform), their matched masks, and the area's eligibility mask.
  unsigned thr_key[kCh], matched[kCh][kMaskWords], flags[kCh], elig[kMaskWords];
  uint8_t* out_area = out + (static_cast<size_t>(b) * n_areas + area) * n_thr * d;
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    const int t = min(first_t + c, n_thr - 1);  // a spare slot repeats the last threshold, never stored
    thr_key[c] = order_key(thresholds[t]);
    flags[c] = 0u;
#pragma unroll
    for (int w = 0; w < kMaskWords; ++w) matched[c][w] = 0u;
  }
  const uint8_t* ok_g = gt_ok + static_cast<size_t>(b) * g;
  const uint8_t* ignore_g = gt_ignore + (static_cast<size_t>(b) * n_areas + area) * g;
#pragma unroll
  for (int w = 0; w < kMaskWords; ++w) {
    unsigned bits = 0u;
    for (int j = 0; j < 32; ++j) {
      const int gi = lane + kWarp * (w * 32 + j);
      if (gi >= g) break;
      bits |= static_cast<unsigned>(ok_g[gi] != 0 && ignore_g[gi] == 0) << j;
    }
    elig[w] = bits;
  }
  // whether +0.0, the maximum of a step without candidates in a finite
  // image, passes any of this warp's thresholds (only a negative one does)
  bool zero_passes = false;
#pragma unroll
  for (int c = 0; c < kCh; ++c) zero_passes |= 0x80000000u > thr_key[c];
  // chains this warp stores: 0 only for a spare warp of the last block
  const int n_mine = warp_id < n_areas * groups ? min(kCh, n_thr - first_t) : 0;
  __syncthreads();  // the plain-load part of slab 0 and the labels
  // a slot-mode lane's ground-truth labels, in registers
  int my_label[kSlots > 0 ? kSlots : 1];
#pragma unroll
  for (int j = 0; j < (kSlots > 0 ? kSlots : 1); ++j) {
    my_label[j] = kStaged && lane + kWarp * j < g ? s_label[lane + kWarp * j] : 0;
  }

  for (int s = 0; s < plan.n_slabs; ++s) {
    const int buf = s & 1;
    if (s + 1 < plan.n_slabs) {  // the other buffer was released by the last slab's closing barrier
      stage_slab(plan, s + 1, smem + (buf ^ 1) * plan.buffer_bytes, &full[buf ^ 1], iou_rows, labels, oks, d, g,
                 kStaged);
    }
    mbar_wait(&full[buf], (s >> 1) & 1);
    const uint8_t* buffer = smem + buf * plan.buffer_bytes;
    const float* s_iou = reinterpret_cast<const float*>(buffer + plan.iou_off);
    const int* s_lab = reinterpret_cast<const int*>(buffer + plan.lab_off);
    const uint8_t* s_ok = buffer + plan.ok_off;
    const int row0 = s * plan.slab_rows;
    const int rows = min(plan.slab_rows, d - row0);
    // Where every IoU of the slab is finite, iou * 0 is a zero and its key
    // that of +0.0 in every lane: a step without candidates then needs no
    // warp reduction at all (its maximum is 0.0, first at ground truth 0).
    int not_finite = 0;
    if (kStaged) {
      for (int q = threadIdx.x; q < rows * g; q += blockDim.x) not_finite |= !isfinite(s_iou[q]);
    }
    const bool all_finite = __syncthreads_or(not_finite) == 0;

    // a slot-mode step's shared inputs, loaded one step ahead so that the
    // loads fly while the chains of the step before run
    constexpr int kS = kSlots > 0 ? kSlots : 1;
    float iou_next[kS];
    int label_next = s_lab[0];
    bool ok_next = s_ok[0] != 0;
#pragma unroll
    for (int j = 0; j < kS; ++j) iou_next[j] = kSlots > 0 && lane + kWarp * j < g ? s_iou[lane + kWarp * j] : 0.f;
    for (int i = 0; n_mine > 0 && i < rows; ++i) {
      const int step = row0 + i;
      const int label = label_next;
      const bool step_ok = ok_next;
      const float* row = kStaged ? s_iou + static_cast<size_t>(i) * g : iou_rows + static_cast<size_t>(step) * g;
      float iou[kS];
#pragma unroll
      for (int j = 0; j < kS; ++j) iou[j] = iou_next[j];
      if (i + 1 < rows) {
        label_next = s_lab[i + 1];
        ok_next = s_ok[i + 1] != 0;
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          if (kSlots > 0 && lane + kWarp * j < g) iou_next[j] = row[g + lane + kWarp * j];
        }
      }
      // Every chain slot runs, so the compiler can interleave their
      // independent reductions; a spare slot repeats the last chain and only
      // its store is skipped.
      if (!step_ok) {
        // ok is false in every chain: no flag, no match
      } else if (kSlots > 0) {
        // shared by the warp's chains: per slot, the key of v when its ground
        // truth is a candidate and when it is not, and the candidate test but
        // for the matched sets
        unsigned key_in[kS], key_out[kS], same = 0u;
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          const bool valid = lane + kWarp * j < g;
          key_in[j] = valid ? order_key(__fmul_rn(iou[j], 1.f)) : 0u;
          key_out[j] = valid ? order_key(__fmul_rn(iou[j], 0.f)) : 0u;
          same |= static_cast<unsigned>(valid && my_label[j] == label) << j;
        }
        same &= elig[0];
        // Each of the warp's operations (reduce, ballot) runs for every chain
        // before the next one: the compiler keeps warp-synchronous
        // operations in program order, so chain by chain their latencies
        // would add up; phase by phase they overlap.
        unsigned key[kCh], top[kCh], pick[kCh];
        if (__ballot_sync(kFull, same != 0u) == 0u) {
          // No lane holds a candidate of any chain (the detection's label
          // has no eligible ground truth here): v = iou * 0 everywhere, and
          // one argmax serves every chain. In a finite image its maximum is
          // 0.0, which passes no threshold >= 0: then no chain changes.
          if (!all_finite || zero_passes) {
            unsigned top0 = 0x80000000u, win = 0u;  // +0.0's key, first at ground truth 0 (lane 0, slot 0)
            if (!all_finite) {
              unsigned best = 0u, best_j = 0u;
#pragma unroll
              for (int j = 0; j < kS; ++j) {
                if (key_out[j] > best) {
                  best = key_out[j];
                  best_j = j;
                }
              }
              top0 = __reduce_max_sync(kFull, best);
              if (kS == 1) {  // the lane and slot of the first maximum
                win = __ffs(__ballot_sync(kFull, best == top0)) - 1;
              } else {
                win = __reduce_min_sync(kFull, best == top0 ? (best_j << 5 | lane) : 0xffffffffu);
              }
            }
#pragma unroll
            for (int c = 0; c < kCh; ++c) {
              const bool ok = top0 > thr_key[c] && top0 != kNanKey;
              if (ok && static_cast<int>(win & 31u) == lane) matched[c][0] |= 1u << (win >> 5);
              flags[c] |= static_cast<unsigned>(ok) << (step & 31);
            }
          }
        } else if (kS == 1) {
#pragma unroll
          for (int c = 0; c < kCh; ++c) key[c] = (same & ~matched[c][0]) ? key_in[0] : key_out[0];
#pragma unroll
          for (int c = 0; c < kCh; ++c) top[c] = __reduce_max_sync(kFull, key[c]);
#pragma unroll
          for (int c = 0; c < kCh; ++c) pick[c] = __ballot_sync(kFull, key[c] == top[c]);
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            const bool ok = top[c] > thr_key[c] && top[c] != kNanKey;
            // the lowest lane holding the maximum wins: torch.argmax's first index
            const bool first = key[c] == top[c] && (pick[c] & ((1u << lane) - 1u)) == 0u;
            matched[c][0] |= static_cast<unsigned>(ok && first);
            flags[c] |= static_cast<unsigned>(ok) << (step & 31);
          }
        } else {
          unsigned slot[kCh];
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            const unsigned cand = same & ~matched[c][0];
            key[c] = 0u;
            slot[c] = 0u;
#pragma unroll
            for (int j = 0; j < kS; ++j) {
              const unsigned k = (cand >> j & 1u) ? key_in[j] : key_out[j];
              if (k > key[c]) {  // strictly greater: the first of this lane's maxima
                key[c] = k;
                slot[c] = j;
              }
            }
          }
#pragma unroll
          for (int c = 0; c < kCh; ++c) top[c] = __reduce_max_sync(kFull, key[c]);
          // the lowest index among the lanes holding the maximum: slot first, then lane
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            pick[c] = __reduce_min_sync(kFull, key[c] == top[c] ? (slot[c] << 5 | lane) : 0xffffffffu);
          }
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            const bool ok = top[c] > thr_key[c] && top[c] != kNanKey;
            if (ok && static_cast<int>(pick[c] & 31u) == lane) matched[c][0] |= 1u << (pick[c] >> 5);
            flags[c] |= static_cast<unsigned>(ok) << (step & 31);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          unsigned best = 0u, best_g = 0xffffffffu;
#pragma unroll
          for (int w = 0; w < kMaskWords; ++w) {
            for (int j = 0; j < 32; ++j) {
              const int gi = lane + kWarp * (w * 32 + j);
              if (gi >= g) break;
              const bool cand = gt_lab[gi] == label && ((elig[w] & ~matched[c][w]) >> j & 1u);
              const unsigned key = order_key(__fmul_rn(row[gi], cand ? 1.f : 0.f));
              if (key > best) {  // strictly greater: the first of this lane's maxima
                best = key;
                best_g = gi;
              }
            }
          }
          const unsigned top = __reduce_max_sync(kFull, best);
          const unsigned m = __reduce_min_sync(kFull, best == top ? best_g : 0xffffffffu);
          const bool ok = top > thr_key[c] && top != kNanKey && step_ok;
          if (ok && static_cast<int>(m % kWarp) == lane) {
            const unsigned slot = m / kWarp;
#pragma unroll
            for (int w = 0; w < kMaskWords; ++w) {
              if (static_cast<int>(slot / 32) == w) matched[c][w] |= 1u << (slot % 32);
            }
          }
          flags[c] |= static_cast<unsigned>(ok) << (step & 31);
        }
      }
      if ((step & 31) == 31 || step == d - 1) {  // the warp writes 32 steps' flags as 32 bytes
        const int base = step & ~31;
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          if (c < n_mine && base + lane <= step) {
            out_area[static_cast<size_t>(first_t + c) * d + base + lane] = (flags[c] >> lane) & 1u;
          }
          flags[c] = 0u;
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is staged again
  }
}

template <int kSlots, int kCh>
int launch(const float* ious, const uint8_t* det_ok, const int* det_labels, const int* gt_labels,
           const uint8_t* gt_ok, const uint8_t* gt_ignore, const float* thresholds, uint8_t* out, int b, int a,
           int t, int d, int g, cudaStream_t stream) {
  const Plan plan = make_plan(ious, det_labels, det_ok, d, g, kSlots > 0);
  if (plan.shared_bytes > kSharedLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (plan.shared_bytes > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(greedy_match_kernel<kSlots, kCh>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, plan.shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // every warp of a block carries chains: A * ceil(T / kCh) warps, split over
  // as few blocks per image as the block limit allows
  const int warps_needed = a * ((t + kCh - 1) / kCh);
  const int blocks_y = (warps_needed + kMaxWarps - 1) / kMaxWarps;
  const int warps = (warps_needed + blocks_y - 1) / blocks_y;
  const dim3 grid(b, blocks_y);
  greedy_match_kernel<kSlots, kCh><<<grid, warps * kWarp, plan.shared_bytes, stream>>>(
      ious, det_ok, det_labels, gt_labels, gt_ok, gt_ignore, thresholds, out, plan, a, t, d, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest G the kernel takes: kHugeWords mask words per lane, one chain per warp.
int greedy_match_max_g() { return kMaxG; }

// Shapes as in the header; b, a, t, d >= 1 and 1 <= g <= greedy_match_max_g().
// Returns cudaGetLastError() after the launch (0 on success).
int greedy_match_launch(const float* ious, const uint8_t* det_ok, const int* det_labels, const int* gt_labels,
                        const uint8_t* gt_ok, const uint8_t* gt_ignore, const float* thresholds, uint8_t* out,
                        int b, int a, int t, int d, int g, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GREEDY_MATCH_ARGS ious, det_ok, det_labels, gt_labels, gt_ok, gt_ignore, thresholds, out, b, a, t, d, g, s
  if (g < 1 || g > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  if (g <= kWarp) return launch<1, kChains>(GREEDY_MATCH_ARGS);
  if (g <= 2 * kWarp) return launch<2, kChains>(GREEDY_MATCH_ARGS);
  if (g <= 4 * kWarp) return launch<4, kChains>(GREEDY_MATCH_ARGS);
  if (g <= 8 * kWarp) return launch<8, kChains>(GREEDY_MATCH_ARGS);
  if (g <= 32 * kWarp) return launch<32, kChains>(GREEDY_MATCH_ARGS);
  return launch<0, 1>(GREEDY_MATCH_ARGS);
#undef GREEDY_MATCH_ARGS
}

}  // extern "C"
