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
// What bounds it on an H100: bytes B*D*G*4 read (the IoU rows, shared by the
// A*T warps of an image through L1 and L2) plus B*A*T*D written: 9.7 MB, or
// 2.9 us at 3.35 TB/s, at the COCO chunk shape B=256, A=4, T=10, D=128, G=64.
// Before that, the dependency chain: each warp takes D steps in order, each at
// least one load and one five-step shuffle reduction.
//
// How the design meets that: one warp per (b, a, t), up to 8 warps of one (b, a)
// in a block. The block stages the image's ground-truth labels and eligibility
// (gt_ok && !gt_ignore[a]) in shared memory once; each warp keeps its matched
// flags there too, so G up to the shared-memory limit works. At each step the
// lanes read the IoU row with coalesced loads, each lane keeps the first
// maximum over its strided ground truths, and a shuffle reduction picks the
// maximum with ties to the lower index. Each lane buffers the flag of one of 32
// consecutive steps and the warp stores the 32 bytes together.
//
// The caller allocates the output and passes PyTorch's current stream; nothing
// here allocates or synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr int kSharedLimit = 227 * 1024;  // an H100 block's dynamic shared memory, after opt-in
constexpr int kDefaultShared = 48 * 1024;

size_t shared_bytes(int g, int warps) {
  return static_cast<size_t>(g) * (sizeof(int) + 1 + warps);
}

__global__ void greedy_match_kernel(
    const float* __restrict__ ious, const uint8_t* __restrict__ det_ok, const int* __restrict__ det_labels,
    const int* __restrict__ gt_labels, const uint8_t* __restrict__ gt_ok, const uint8_t* __restrict__ gt_ignore,
    const float* __restrict__ thresholds, uint8_t* __restrict__ out, int n_areas, int n_thr, int d, int g) {
  extern __shared__ int smem[];
  int* s_label = smem;                                             // [g]
  uint8_t* s_eligible = reinterpret_cast<uint8_t*>(smem + g);      // [g]
  uint8_t* s_matched_all = s_eligible + g;                         // [warps][g]

  const int b = blockIdx.x / n_areas;
  const int a = blockIdx.x - b * n_areas;
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int t = blockIdx.y * warps + warp;

  const size_t gt_row = static_cast<size_t>(b) * g;
  const size_t ignore_row = (static_cast<size_t>(b) * n_areas + a) * g;
  for (int i = threadIdx.x; i < g; i += blockDim.x) {
    s_label[i] = gt_labels[gt_row + i];
    s_eligible[i] = gt_ok[gt_row + i] != 0 && gt_ignore[ignore_row + i] == 0;
  }
  for (int i = threadIdx.x; i < warps * g; i += blockDim.x) s_matched_all[i] = 0;
  __syncthreads();
  if (t >= n_thr) return;  // whole warps leave together, after the block's barrier

  uint8_t* s_matched = s_matched_all + static_cast<size_t>(warp) * g;
  const float thr = thresholds[t];
  const float* iou_rows = ious + static_cast<size_t>(b) * d * g;
  const uint8_t* ok_in = det_ok + static_cast<size_t>(b) * d;
  const int* labels = det_labels + static_cast<size_t>(b) * d;
  uint8_t* out_row = out + ((static_cast<size_t>(b) * n_areas + a) * n_thr + t) * d;

  uint8_t mine = 0;  // the flag of step (base + lane) of the current group of 32 steps
  for (int step = 0; step < d; ++step) {
    const float* row = iou_rows + static_cast<size_t>(step) * g;
    const int label = labels[step];
    float best = __int_as_float(0xff800000);  // -inf: any real value wins over an idle lane
    int best_i = g;
    for (int i = lane; i < g; i += kWarp) {
      const bool candidate = s_label[i] == label && s_eligible[i] && !s_matched[i];
      const float v = __fmul_rn(row[i], candidate ? 1.f : 0.f);
      if (v > best) {  // strictly greater: the first maximum among this lane's indices
        best = v;
        best_i = i;
      }
    }
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float other = __shfl_xor_sync(0xffffffffu, best, off);
      const int other_i = __shfl_xor_sync(0xffffffffu, best_i, off);
      if (other > best || (other == best && other_i < best_i)) {
        best = other;
        best_i = other_i;
      }
    }
    const bool ok = best > thr && ok_in[step] != 0;
    if (ok && best_i < g && lane == (best_i % kWarp)) s_matched[best_i] = 1;
    if (lane == step % kWarp) mine = ok;
    if (step % kWarp == kWarp - 1 || step == d - 1) {
      const int base = step - step % kWarp;
      if (base + lane <= step) out_row[base + lane] = mine;
    }
    __syncwarp();  // the matched flag is visible to every lane before the next step
  }
}

int warps_for(int g, int n_thr) {
  int warps = n_thr < kMaxWarps ? n_thr : kMaxWarps;
  while (warps > 1 && shared_bytes(g, warps) > static_cast<size_t>(kSharedLimit)) --warps;
  return warps;
}

}  // namespace

extern "C" {

// The largest G the kernel takes (one warp per block, all shared memory).
int greedy_match_max_g() { return static_cast<int>(kSharedLimit / (sizeof(int) + 2)); }

// Shapes as in the header; b, a, t, d >= 1 and 1 <= g <= greedy_match_max_g().
// Returns cudaGetLastError() after the launch (0 on success).
int greedy_match_launch(const float* ious, const uint8_t* det_ok, const int* det_labels, const int* gt_labels,
                        const uint8_t* gt_ok, const uint8_t* gt_ignore, const float* thresholds, uint8_t* out,
                        int b, int a, int t, int d, int g, void* stream) {
  const int warps = warps_for(g, t);
  const size_t smem = shared_bytes(g, warps);
  if (smem > static_cast<size_t>(kDefaultShared)) {
    const cudaError_t err = cudaFuncSetAttribute(greedy_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(b * a, (t + warps - 1) / warps);
  greedy_match_kernel<<<grid, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      ious, det_ok, det_labels, gt_labels, gt_ok, gt_ignore, thresholds, out, a, t, d, g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
