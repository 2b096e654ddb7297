// Binned threshold counts for the binned PR-curve metrics, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_counts_kernel` in
// metrics_tpu/ops/classification/binned_pallas.py (launched by
// `_binned_counts_pallas`), which streams (block_n, C) tiles through VMEM and
// sweeps every threshold over each tile: O(N*C*T) compares, f32 sums.
//
// What it computes: for scores preds[n, c] (f32), targets target[n, c]
// (bool/uint8) and T thresholds, per class c and threshold t,
//   TP = #{n : target, preds >= thr[t]}, FP = #{n : !target, preds >= thr[t]},
//   FN = #{n : target, preds < thr[t]}        (NaN scores count as < every threshold)
// as three float32 (C, T) arrays in the caller's threshold order.
//
// What bounds it on an H100: bytes. The least traffic is N*C*(4 + 1) bytes read
// plus 3*C*T*4 bytes written; the work per element is one binary search of
// log2(T) compares, far below the card's compute rate.
//
// How the design meets that: each score is read once and reduced to its bucket,
// the number of sorted thresholds <= score, in [0, T] (the bucketize form of
// `_binned_counts_xla`), so no (N, C, T) compare is ever formed.
//  1. binned_hist_kernel: a grid of (class block) x (row block). Threads on
//     consecutive classes of one row, so every warp load is contiguous. Each
//     block counts positives and negatives per (class, bucket) in an int32
//     shared-memory histogram of (2, C_block, T+1), sized from T, then adds its
//     non-zero bins into the global int32 histogram with atomicAdd. When T is
//     so large that one class does not fit in shared memory, the same kernel
//     adds straight into the global histogram.
//  2. binned_finish_kernel: one warp per class scans its T+1 buckets (warp
//     shuffles) and writes tp = pos_total - cum_pos, fp = neg_total - cum_neg,
//     fn = cum_pos, scattered back to the caller's threshold order.
// Counts stay int32 throughout (exact to 2^31; the TPU kernel's f32 sums are
// exact only to 2^24). Integer atomics make the result independent of the
// order in which blocks run, so it is bitwise reproducible.
//
// The caller allocates and zeroes every buffer and passes PyTorch's current
// stream; nothing here allocates or synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kMaxClassBlock = 32;
constexpr int kSharedBudget = 48 * 1024;  // no opt-in attribute needed below this

// Number of sorted thresholds th with !(th > p): torch.searchsorted(right=True).
// NaN scores land in bucket 0, i.e. below every threshold.
__device__ __forceinline__ int bucket_of(float p, const float* __restrict__ thr, int t) {
  if (isnan(p)) return 0;
  int lo = 0, hi = t;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!(__ldg(thr + mid) > p)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// hist layout: [2][c][t + 1], side 0 = positives, side 1 = negatives.
template <bool kShared>
__global__ void __launch_bounds__(kThreads) binned_hist_kernel(
    const float* __restrict__ preds, const uint8_t* __restrict__ target,
    const float* __restrict__ thr, int* __restrict__ hist,
    int n, int c, int t, int cb, int rows_per_block) {
  extern __shared__ int smem[];  // [2][cb][t + 1] when kShared
  const int nb = t + 1;
  const int tx = threadIdx.x % cb;
  const int ty = threadIdx.x / cb;
  const int row_lanes = blockDim.x / cb;
  const int col = blockIdx.x * cb + tx;
  const int row0 = blockIdx.y * rows_per_block;
  const int row1 = min(n, row0 + rows_per_block);

  if (kShared) {
    for (int i = threadIdx.x; i < 2 * cb * nb; i += blockDim.x) smem[i] = 0;
    __syncthreads();
  }
  if (col < c) {
    for (int r = row0 + ty; r < row1; r += row_lanes) {
      const size_t off = static_cast<size_t>(r) * c + col;
      const int side = target[off] != 0 ? 0 : 1;
      const int b = bucket_of(preds[off], thr, t);
      if (kShared) {
        atomicAdd(&smem[(side * cb + tx) * nb + b], 1);
      } else {
        atomicAdd(&hist[(static_cast<size_t>(side) * c + col) * nb + b], 1);
      }
    }
  }
  if (kShared) {
    __syncthreads();
    const int per_side = cb * nb;
    for (int i = threadIdx.x; i < 2 * per_side; i += blockDim.x) {
      const int v = smem[i];
      if (v == 0) continue;
      const int side = i / per_side;
      const int k = (i - side * per_side) / nb;
      const int b = i - side * per_side - k * nb;
      const int cc = blockIdx.x * cb + k;
      if (cc < c) atomicAdd(&hist[(static_cast<size_t>(side) * c + cc) * nb + b], v);
    }
  }
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One warp per class: inclusive scan of the bucket counts, written as float32
// counts at the caller's threshold positions (order[b] is the caller's index of
// the b-th smallest threshold).
__global__ void __launch_bounds__(kThreads) binned_finish_kernel(
    const int* __restrict__ hist, const int* __restrict__ order,
    float* __restrict__ tp, float* __restrict__ fp, float* __restrict__ fn, int c, int t) {
  const int cls = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (cls >= c) return;  // whole warps exit together
  const int nb = t + 1;
  const int* pos = hist + static_cast<size_t>(cls) * nb;
  const int* neg = hist + (static_cast<size_t>(c) + cls) * nb;

  int pos_total = 0, neg_total = 0;
  for (int b = lane; b < nb; b += kWarp) {
    pos_total += pos[b];
    neg_total += neg[b];
  }
  pos_total = warp_sum(pos_total);
  neg_total = warp_sum(neg_total);

  int carry_pos = 0, carry_neg = 0;
  for (int base = 0; base < t; base += kWarp) {
    const int b = base + lane;
    int vp = b < t ? pos[b] : 0;
    int vn = b < t ? neg[b] : 0;
    for (int off = 1; off < kWarp; off <<= 1) {
      const int up_p = __shfl_up_sync(0xffffffffu, vp, off);
      const int up_n = __shfl_up_sync(0xffffffffu, vn, off);
      if (lane >= off) {
        vp += up_p;
        vn += up_n;
      }
    }
    const int cum_pos = carry_pos + vp;
    const int cum_neg = carry_neg + vn;
    if (b < t) {
      const size_t o = static_cast<size_t>(cls) * t + order[b];
      tp[o] = static_cast<float>(pos_total - cum_pos);
      fp[o] = static_cast<float>(neg_total - cum_neg);
      fn[o] = static_cast<float>(cum_pos);
    }
    carry_pos += __shfl_sync(0xffffffffu, vp, kWarp - 1);
    carry_neg += __shfl_sync(0xffffffffu, vn, kWarp - 1);
  }
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Class-block width the histogram kernel uses for c classes and t thresholds;
// 0 means the global-atomic path (one class's 2*(t+1) counters exceed the
// shared-memory budget). Exposed so callers and tests can tell the paths apart.
int binned_counts_class_block(int c, int t) {
  const size_t per_class = 2 * static_cast<size_t>(t + 1) * sizeof(int);
  if (per_class > static_cast<size_t>(kSharedBudget)) return 0;
  int cb = next_pow2(c < kMaxClassBlock ? c : kMaxClassBlock);
  while (cb > 1 && cb * per_class > static_cast<size_t>(kSharedBudget)) cb >>= 1;
  return cb;
}

// preds (n, c) f32, target (n, c) uint8, thr_sorted (t,) f32 ascending, order (t,)
// int32, hist (2, c, t + 1) int32 zeroed; tp/fp/fn (c, t) f32. Returns
// cudaGetLastError() after both launches (0 on success).
int binned_counts_launch(const float* preds, const uint8_t* target, const float* thr_sorted,
                         const int* order, int* hist, float* tp, float* fp, float* fn,
                         int n, int c, int t, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);

  const int shared_cb = binned_counts_class_block(c, t);
  const bool shared = shared_cb > 0;
  const int cb = shared ? shared_cb : next_pow2(c < kMaxClassBlock ? c : kMaxClassBlock);
  const int row_lanes = kThreads / cb;
  const int class_blocks = (c + cb - 1) / cb;
  // about two blocks per SM in all, each with at least one row per lane
  int row_blocks = (2 * sms + class_blocks - 1) / class_blocks;
  const int max_row_blocks = (n + row_lanes - 1) / row_lanes;
  if (row_blocks > max_row_blocks) row_blocks = max_row_blocks;
  if (row_blocks < 1) row_blocks = 1;
  const int rows_per_block = (n + row_blocks - 1) / row_blocks;
  row_blocks = (n + rows_per_block - 1) / rows_per_block;

  const dim3 grid(class_blocks, row_blocks);
  if (shared) {
    const size_t smem = 2 * static_cast<size_t>(cb) * (t + 1) * sizeof(int);
    binned_hist_kernel<true><<<grid, kThreads, smem, s>>>(preds, target, thr_sorted, hist, n, c, t, cb,
                                                          rows_per_block);
  } else {
    binned_hist_kernel<false><<<grid, kThreads, 0, s>>>(preds, target, thr_sorted, hist, n, c, t, cb,
                                                        rows_per_block);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int warps_per_block = kThreads / kWarp;
  const int finish_blocks = (c + warps_per_block - 1) / warps_per_block;
  binned_finish_kernel<<<finish_blocks, kThreads, 0, s>>>(hist, order, tp, fp, fn, c, t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
