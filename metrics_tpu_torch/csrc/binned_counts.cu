// Binned threshold counts for the binned PR-curve metrics, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_counts_kernel` in
// metrics_tpu/ops/classification/binned_pallas.py (launched by
// `_binned_counts_pallas`), which streams (block_n, C) tiles through VMEM and
// sweeps every threshold over each tile: O(N*C*T) compares, f32 sums.
//
// What it computes: for scores preds[n, c] (f32), a target and T thresholds,
// per class c and threshold t,
//   TP = #{n : pos, preds >= thr[t]}, FP = #{n : !pos, preds >= thr[t]},
//   FN = #{n : pos, preds < thr[t]}        (NaN scores count as < every threshold)
// as three float32 (C, T) arrays in the caller's threshold order. The target
// takes one of two forms: dense, (N, C) bool/uint8 with pos = target[n, c] != 0;
// or class labels, (N,) int32/int64 with pos = (label[n] == c), so a label
// outside [0, C), negatives included, makes an all-negative row (as a one-hot
// of it would).
//
// What bounds it on an H100: bytes. The least traffic is N*C*4 bytes of scores,
// N*C (dense) or N*8 (int64 labels) bytes of target, and 3*C*T*4 bytes written;
// the work per element is one binary search of log2(T) compares, far below the
// card's compute rate. At the ImageNet batch (1024, 1000, 100) that is 1.9 us
// (dense) or 1.6 us (labels) at 3.35 TB/s, so launches and latency set the
// time, and the design spends one launch per call:
//
//  1. Each score is reduced to its bucket, the number of sorted thresholds
//     <= score in [0, T] (the bucketize form of `_binned_counts_xla`), over
//     the thresholds (and their order) staged in shared memory; no (N, C, T)
//     compare is formed.
//     The bucket is exactly what torch.searchsorted(right=True) returns: a
//     guess from the grid's span, moved at most 3 steps until
//     !(thr[g-1] > p) and thr[g] > p hold, which fixes it where no threshold
//     is NaN; else searchsorted's own binary search, same midpoints.
//  2. A block owns a class block (cb classes, a power of two) and a run of rows,
//     and counts positives and negatives per (class, bucket) in an int32
//     shared-memory histogram of (2, cb, T+1). Where a row's scores are
//     16-byte aligned (C % 4 == 0, aligned base) each thread reads 4 classes
//     with one float4 (and their 4 target bytes with one word); otherwise the
//     same kernel reads scalars. A thread issues its next batch's loads before
//     it counts the current one, and its first before the thresholds are
//     staged. Class blocks narrow (down to 4) until the grid holds about 3
//     blocks per SM.
//  3. The blocks of one class block form a thread-block cluster along the rows
//     (up to 8, the portable size). Each (side, class) histogram row is owned
//     by one rank. After a first cluster.sync() (every histogram zeroed) and
//     the counting, each block adds the nonzero bins of the rows it does not
//     own into their owners' copies through distributed shared memory; after
//     a second cluster.sync() each owner scans its rows (one warp a row, warp
//     shuffles) and writes tp = pos_total - cum_pos, fp = neg_total - cum_neg,
//     fn = cum_pos at the caller's threshold positions.
//  4. Where one class's histogram and the thresholds exceed the opt-in 227 KB
//     of shared memory (T > binned_counts_max_shared_t()), blocks add straight
//     into a global int32 workspace, and the last block of each class block to
//     take a ticket (one atomic counter per class block) scans it, then sets
//     the workspace rows and its ticket back to zero. The caller keeps one
//     workspace per stream, zeroed once when it is made, so no launch needs a
//     memset and two streams never share one; the cluster path needs none.
// Counts stay int32 throughout (exact to 2^31; the TPU kernel's f32 sums are
// exact only to 2^24). Integer atomics make the result independent of the
// order in which blocks run, so it is bitwise reproducible.
//
// The caller allocates the output and the workspace and passes PyTorch's
// current stream; nothing here allocates or synchronises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxClassBlock = 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kBatch = 4;  // elements a thread loads before it counts them (one float4 where rows are aligned)
constexpr int kMinElemsPerBlock = 4 * kThreads;
constexpr int kBlocksPerSmWanted = 3;  // narrower class blocks until the grid has this many
constexpr int kStaticSmemReserve = 1024;  // the kernels' static shared memory, with room to spare
constexpr int kMaxDevices = 64;

enum TargetForm { kDense = 0, kLabels32 = 1, kLabels64 = 2 };

struct Params {
  const float* preds;   // (n, c)
  const void* target;   // (n, c) uint8 or (n,) int32 / int64 labels
  const float* thr;     // (t,) ascending
  const int* order;     // (t,): order[b] is the caller's index of the b-th smallest threshold
  float* out;           // (3, c, t): tp, fp, fn
  int* tickets;         // global path's workspace: one counter per class block, zero on entry and exit
  int* ws;              // global path's workspace: (2, c, t + 1) int32, zero on entry and exit
  int n, c, t;
  int cb;               // class-block width, a power of two
  int cb_log2;
  int chunk_log2;       // log2 of the chunks per row of a class block (cb / 4 vector, cb scalar)
  long long rows_per_block;
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int kForm>
__device__ __forceinline__ long long label_of(const Params& p, long long row) {
  if constexpr (kForm == kLabels32) {
    return __ldg(static_cast<const int*>(p.target) + row);
  } else {
    return __ldg(static_cast<const long long*>(p.target) + row);
  }
}

// kBatch elements of one thread: kChunks chunks of kLanes consecutive classes
// of one row each (one float4 where the rows are aligned, else one float).
template <int kForm, bool kVec>
struct Batch {
  static constexpr int kLanes = kVec ? 4 : 1;
  static constexpr int kChunks = kBatch / kLanes;
  float v[kBatch];
  unsigned int tg[kChunks];  // dense: the chunk's target bytes
  long long lab[kChunks];    // labels: the chunk's row label
  int kk[kChunks];           // class of the chunk's first element within the block
  bool ok[kChunks];
};

// Issues the loads of chunks base, base + kThreads, ... (nothing for chunks
// past the end or past the class block).
template <int kForm, bool kVec>
__device__ __forceinline__ void load_batch(const Params& p, long long base, long long chunks, long long row0, int c0,
                                           int width, Batch<kForm, kVec>& bt) {
  using B = Batch<kForm, kVec>;
  const int chunk_mask = (1 << p.chunk_log2) - 1;
#pragma unroll
  for (int u = 0; u < B::kChunks; ++u) {
    const long long q = base + static_cast<long long>(u) * kThreads;
    bt.kk[u] = static_cast<int>(q & chunk_mask) * B::kLanes;
    bt.ok[u] = q < chunks && bt.kk[u] < width;
#pragma unroll
    for (int j = 0; j < B::kLanes; ++j) bt.v[u * B::kLanes + j] = 0.f;
    if (bt.ok[u]) {
      const long long row = row0 + (q >> p.chunk_log2);
      const size_t off = static_cast<size_t>(row) * p.c + c0 + bt.kk[u];
      if constexpr (kVec) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(p.preds + off));
        bt.v[u * 4 + 0] = x.x;
        bt.v[u * 4 + 1] = x.y;
        bt.v[u * 4 + 2] = x.z;
        bt.v[u * 4 + 3] = x.w;
        if constexpr (kForm == kDense) {
          bt.tg[u] = __ldg(reinterpret_cast<const unsigned int*>(static_cast<const uint8_t*>(p.target) + off));
        }
      } else {
        bt.v[u] = __ldg(p.preds + off);
        if constexpr (kForm == kDense) bt.tg[u] = __ldg(static_cast<const uint8_t*>(p.target) + off);
      }
      if constexpr (kForm != kDense) bt.lab[u] = label_of<kForm>(p, row);
    }
  }
}

template <bool kShared>
__device__ __forceinline__ float thr_at(const float* __restrict__ thr, int i) {
  if constexpr (kShared) {
    return thr[i];
  } else {
    return __ldg(thr + i);
  }
}

// Where the sorted thresholds lie, for a first guess of a score's bucket.
struct Guess {
  float base;      // the smallest threshold
  float scale;     // (t - 1) / (largest - smallest), 0 where that is not finite and positive
  bool monotone;   // no NaN threshold (NaN sorts last)
};

template <bool kShared>
__device__ __forceinline__ Guess make_guess(const float* __restrict__ thr, int t) {
  const float lo = thr_at<kShared>(thr, 0);
  const float hi = thr_at<kShared>(thr, t - 1);
  const float span = hi - lo;
  const bool usable = t > 1 && span > 0.f && isfinite(span);
  return Guess{lo, usable ? static_cast<float>(t - 1) / span : 0.f, !isnan(hi)};
}

// The bucket of score p: the number of sorted thresholds th with !(th > p),
// which torch.searchsorted(right=True) finds by binary search. NaN scores
// land in bucket 0, below every threshold. Without NaN thresholds that
// predicate holds for a prefix of the sorted thresholds, and the bucket is
// the one g with !(thr[g-1] > p) and thr[g] > p: a guess from the grid's
// span, moved up or down at most 3 steps, settles there for an evenly spaced
// grid. Otherwise (a guess that does not settle, or NaN thresholds) the
// binary search runs with searchsorted's midpoints, so even NaN thresholds
// land where it puts them.
template <bool kShared>
__device__ __forceinline__ int bucket_of(float p, const float* __restrict__ thr, int t, const Guess& guess) {
  if (isnan(p)) return 0;
  if (guess.monotone) {
    const float x = floorf((p - guess.base) * guess.scale);
    int g = !(x >= 0.f) ? 0 : (x >= static_cast<float>(t) ? t : static_cast<int>(x) + 1);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const bool up = g < t && !(thr_at<kShared>(thr, g) > p);
      const bool down = !up && g > 0 && thr_at<kShared>(thr, g - 1) > p;
      if (!up && !down) return g;
      g += up ? 1 : -1;
    }
  }
  int lo = 0, hi = t;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!(thr_at<kShared>(thr, mid) > p)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Buckets a batch and hands each element to add(side, k, bucket) (side 0
// positive, 1 negative; k the class within the block).
template <int kForm, bool kVec, bool kSharedThr, class Add>
__device__ __forceinline__ void count_batch(const Params& p, const float* __restrict__ thr, const Guess& guess, int c0,
                                            const Batch<kForm, kVec>& bt, Add add) {
  using B = Batch<kForm, kVec>;
#pragma unroll
  for (int u = 0; u < B::kChunks; ++u) {
    if (!bt.ok[u]) continue;
#pragma unroll
    for (int j = 0; j < B::kLanes; ++j) {
      bool pos;
      if constexpr (kForm == kDense) {
        pos = ((bt.tg[u] >> (8 * j)) & 0xffu) != 0u;
      } else {
        pos = bt.lab[u] == static_cast<long long>(c0 + bt.kk[u] + j);
      }
      add(pos ? 0 : 1, bt.kk[u] + j, bucket_of<kSharedThr>(bt.v[u * B::kLanes + j], thr, p.t, guess));
    }
  }
}

// Counts the rows [row0, row1) of the class block starting at c0. The first
// batch's loads are issued before prologue() (which stages the thresholds),
// and each next batch's before the current one is searched.
template <int kForm, bool kVec, bool kSharedThr, class Prologue, class Add>
__device__ __forceinline__ void count_rows(const Params& p, const float* thr, long long row0, long long row1, int c0,
                                           Prologue prologue, Add add) {
  using B = Batch<kForm, kVec>;
  const int width = min(p.cb, p.c - c0);
  const long long chunks = (row1 - row0) << p.chunk_log2;
  const long long stride = static_cast<long long>(B::kChunks) * kThreads;
  B cur, next;
  load_batch(p, threadIdx.x, chunks, row0, c0, width, cur);
  prologue();
  const Guess guess = make_guess<kSharedThr>(thr, p.t);
  for (long long base = threadIdx.x; base < chunks; base += stride) {
    load_batch(p, base + stride, chunks, row0, c0, width, next);
    count_batch<kForm, kVec, kSharedThr>(p, thr, guess, c0, cur, add);
    cur = next;
  }
}

// One warp scans the t + 1 buckets of one (side, class) row, bins(b) giving
// bucket b, and writes its counts at the caller's threshold positions; total
// is the row's sum. Bins are read once each, then handed to done(b) (the
// workspace path zeroes them there).
template <class Bins, class Done>
__device__ __forceinline__ void scan_write(const Params& p, const int* __restrict__ order, int side, int cls, int total,
                                           Bins bins, Done done) {
  const int lane = threadIdx.x % kWarp;
  const size_t plane = static_cast<size_t>(p.c) * p.t;
  float* row_tp = p.out + static_cast<size_t>(cls) * p.t;
  float* row_fp = row_tp + plane;
  float* row_fn = row_fp + plane;
  int carry = 0;
  for (int base = 0; base <= p.t; base += kWarp) {
    const int b = base + lane;
    int v = b <= p.t ? bins(b) : 0;
    if (b <= p.t) done(b);
    for (int off = 1; off < kWarp; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += up;
    }
    const int cum = carry + v;
    if (b < p.t) {
      const int o = order[b];
      if (side == 0) {
        row_tp[o] = static_cast<float>(total - cum);
        row_fn[o] = static_cast<float>(cum);
      } else {
        row_fp[o] = static_cast<float>(total - cum);
      }
    }
    carry += __shfl_sync(0xffffffffu, v, kWarp - 1);
  }
}

// grid (cluster size, class blocks), one cluster along x per class block.
template <int kForm, bool kVec>
__global__ void __launch_bounds__(kThreads) binned_cluster_kernel(Params p) {
  extern __shared__ __align__(16) int smem[];  // hist [2][cb][t + 1], then thr [t], then order [t]
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int nb = p.t + 1;
  const int hist_len = 2 * p.cb * nb;
  int* hist = smem;
  float* thr = reinterpret_cast<float*>(smem + hist_len);
  int* order = smem + hist_len + p.t;
  const int c0 = blockIdx.y * p.cb;
  const long long row0 = min(static_cast<long long>(p.n), blockIdx.x * p.rows_per_block);
  const long long row1 = min(static_cast<long long>(p.n), row0 + p.rows_per_block);

  // (side, class) row `item` of the histogram belongs to rank item % cs
  count_rows<kForm, kVec, true>(
      p, thr, row0, row1, c0,
      [&] {
        for (int i = threadIdx.x; i < hist_len; i += kThreads) hist[i] = 0;
        for (int i = threadIdx.x; i < p.t; i += kThreads) {
          thr[i] = p.thr[i];
          order[i] = p.order[i];
        }
        cluster.sync();  // every histogram of the cluster is zeroed before any rank adds to it
      },
      [&](int side, int k, int b) { atomicAdd(&hist[((side << p.cb_log2) + k) * nb + b], 1); });
  __syncthreads();  // this block has counted its rows

  // add each row this rank does not own into its owner's copy, skipping zero
  // bins; the owner's own counting adds to the same bins, so all adds are atomic
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int width = min(p.cb, p.c - c0);
  for (int item = warp; item < 2 * p.cb; item += kWarps) {
    const int owner = item % cs;
    if (owner == rank || (item & (p.cb - 1)) >= width) continue;
    int* row = hist + item * nb;
    int* remote = cluster.map_shared_rank(row, owner);
    for (int b = lane; b < nb; b += kWarp) {
      const int v = row[b];
      if (v != 0) atomicAdd(remote + b, v);
    }
  }
  cluster.sync();  // every add has landed; no rank touches another's shared memory after this
  // one warp scans each owned row
  for (int item = warp * cs + rank; item < 2 * p.cb; item += kWarps * cs) {
    if ((item & (p.cb - 1)) >= width) continue;
    const int* row = hist + item * nb;
    int total = 0;
    for (int b = lane; b < nb; b += kWarp) total += row[b];
    scan_write(p, order, item >> p.cb_log2, c0 + (item & (p.cb - 1)), warp_sum(total), [&](int b) { return row[b]; },
               [](int) {});
  }
}

// T beyond shared memory: grid (row blocks, class blocks), adds go straight to
// the workspace. Once a block's adds are visible it takes its class block's
// ticket; the last to arrive scans the rows (one warp each), zeroes them and
// the ticket.
template <int kForm, bool kVec>
__global__ void __launch_bounds__(kThreads) binned_global_kernel(Params p) {
  __shared__ int s_last;
  const int nb = p.t + 1;
  const int c0 = blockIdx.y * p.cb;
  const long long row0 = min(static_cast<long long>(p.n), blockIdx.x * p.rows_per_block);
  const long long row1 = min(static_cast<long long>(p.n), row0 + p.rows_per_block);
  count_rows<kForm, kVec, false>(p, p.thr, row0, row1, c0, [] {}, [&](int side, int k, int b) {
    atomicAdd(p.ws + (static_cast<size_t>(side) * p.c + c0 + k) * nb + b, 1);
  });
  __syncthreads();  // every add of this block is issued
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(p.tickets + blockIdx.y, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int lane = threadIdx.x % kWarp;
  const int width = min(p.cb, p.c - c0);
  for (int item = threadIdx.x / kWarp; item < 2 * p.cb; item += kWarps) {
    const int side = item >> p.cb_log2;
    const int k = item & (p.cb - 1);
    if (k >= width) continue;
    int* row = p.ws + (static_cast<size_t>(side) * p.c + c0 + k) * nb;
    int total = 0;
    for (int b = lane; b < nb; b += kWarp) total += __ldcg(row + b);
    total = warp_sum(total);
    scan_write(p, p.order, side, c0 + k, total, [&](int b) { return __ldcg(row + b); }, [&](int b) { row[b] = 0; });
  }
  if (threadIdx.x == 0) p.tickets[blockIdx.y] = 0;
}

using KernelFn = void (*)(Params);

// [cluster or global][form][vector]
const KernelFn kKernels[2][3][2] = {
    {{binned_cluster_kernel<kDense, false>, binned_cluster_kernel<kDense, true>},
     {binned_cluster_kernel<kLabels32, false>, binned_cluster_kernel<kLabels32, true>},
     {binned_cluster_kernel<kLabels64, false>, binned_cluster_kernel<kLabels64, true>}},
    {{binned_global_kernel<kDense, false>, binned_global_kernel<kDense, true>},
     {binned_global_kernel<kLabels32, false>, binned_global_kernel<kLabels32, true>},
     {binned_global_kernel<kLabels64, false>, binned_global_kernel<kLabels64, true>}},
};

struct DeviceInfo {
  int sms = 0;
  int smem_budget = 0;  // dynamic shared memory a block may opt into
};

std::mutex g_info_mutex;
std::atomic<bool> g_info_ready[kMaxDevices];
DeviceInfo g_info[kMaxDevices];

// The SM count and shared-memory budget of the current device, queried once
// per device; the kernels' dynamic shared-memory limit is raised then too.
int device_info(DeviceInfo* info) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!g_info_ready[device].load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(g_info_mutex);
    if (!g_info_ready[device].load(std::memory_order_relaxed)) {
      DeviceInfo d;
      int optin = 0;
      if ((err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
          (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != cudaSuccess) {
        return static_cast<int>(err);
      }
      d.smem_budget = optin - kStaticSmemReserve;
      for (const auto& forms : kKernels[0]) {
        for (KernelFn fn : forms) {
          err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem_budget);
          if (err != cudaSuccess) return static_cast<int>(err);
        }
      }
      g_info[device] = d;
      g_info_ready[device].store(true, std::memory_order_release);
    }
  }
  *info = g_info[device];
  return 0;
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

int log2_of(int pow2) {
  int l = 0;
  while ((1 << l) < pow2) ++l;
  return l;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// the histogram, the thresholds and their order
size_t shared_bytes(int cb, int t) { return (2 * static_cast<size_t>(cb) * (t + 1) + 2 * static_cast<size_t>(t)) * sizeof(int); }

// The widest class block (at most 32 classes) whose histogram fits, narrowed
// (not below 4, the float4 width) while full clusters of the class blocks
// would give fewer than kBlocksPerSmWanted blocks per SM: the searches are
// latency-bound, so more, shorter blocks finish sooner. 0: none fits.
int class_block(int c, int t, const DeviceInfo& info) {
  int cb = next_pow2(c < kMaxClassBlock ? c : kMaxClassBlock);
  while (cb > 1 && shared_bytes(cb, t) > static_cast<size_t>(info.smem_budget)) cb >>= 1;
  if (shared_bytes(cb, t) > static_cast<size_t>(info.smem_budget)) return 0;
  while (cb > 4 && ceil_div(c, cb) * kMaxCluster < static_cast<long long>(kBlocksPerSmWanted) * info.sms) cb >>= 1;
  return cb;
}

}  // namespace

extern "C" {

// Class-block width of the cluster path for c classes and t thresholds on the
// current device; 0 means the global-workspace path (one class's histogram
// and the thresholds exceed the shared memory a block may opt into).
int binned_counts_class_block(int c, int t) {
  DeviceInfo info;
  if (device_info(&info) != 0) return -1;
  return class_block(c, t, info);
}

// The largest t the cluster path takes on the current device.
int binned_counts_max_shared_t(void) {
  DeviceInfo info;
  if (device_info(&info) != 0) return -1;
  // 2 * (t + 1) + 2 * t int32 for one class
  return (info.smem_budget / static_cast<int>(sizeof(int)) - 2) / 4;
}

// Workspace int32 elements a call with c classes and t thresholds needs on
// the current device: 0 on the cluster path; on the global path, tickets (at
// most one per class), then the (2, c, t + 1) histogram. -1 on a device error.
long long binned_counts_workspace_len(int c, int t) {
  DeviceInfo info;
  if (device_info(&info) != 0) return -1;
  if (class_block(c, t, info) > 0) return 0;
  return static_cast<long long>(c) + 2LL * c * (t + 1);
}

// preds (n, c) f32; target (n, c) uint8 (form 0) or (n,) int32 (form 1) or
// int64 (form 2) labels; thr_sorted (t,) f32 ascending and order (t,) int32;
// out (3, c, t) f32; ws a zeroed int32 workspace of ws_len >=
// binned_counts_workspace_len(c, t) elements (NULL where that is 0), left
// zeroed. n, c, t >= 1, all contiguous. Returns cudaGetLastError() after the launch (0 on success).
int binned_counts_launch(const float* preds, const void* target, int form, const float* thr_sorted, const int* order,
                         float* out, int* ws, long long ws_len, int n, int c, int t, void* stream) {
  if (form < kDense || form > kLabels64 || n < 1 || c < 1 || t < 1) return static_cast<int>(cudaErrorInvalidValue);
  DeviceInfo info;
  int status = device_info(&info);
  if (status != 0) return status;
  const int shared_cb = class_block(c, t, info);
  const bool cluster_path = shared_cb > 0;
  if (!cluster_path && (ws == nullptr || ws_len < static_cast<long long>(c) + 2LL * c * (t + 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  Params p;
  p.preds = preds;
  p.target = target;
  p.thr = thr_sorted;
  p.order = order;
  p.out = out;
  p.tickets = ws;
  p.ws = cluster_path ? nullptr : ws + c;
  p.n = n;
  p.c = c;
  p.t = t;

  p.cb = cluster_path ? shared_cb : next_pow2(c < kMaxClassBlock ? c : kMaxClassBlock);
  p.cb_log2 = log2_of(p.cb);
  const bool vec = p.cb >= 4 && c % 4 == 0 && reinterpret_cast<uintptr_t>(preds) % 16 == 0 &&
                   (form != kDense || reinterpret_cast<uintptr_t>(target) % 4 == 0);
  p.chunk_log2 = vec ? p.cb_log2 - 2 : p.cb_log2;
  const long long class_blocks = ceil_div(c, p.cb);
  if (class_blocks > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  // rows enough that a block reads at least kMinElemsPerBlock elements
  const int width = c < p.cb ? c : p.cb;
  const long long min_rows = ceil_div(kMinElemsPerBlock, width);
  const long long row_blocks_max = ceil_div(n, min_rows);
  const KernelFn fn = kKernels[cluster_path ? 0 : 1][form][vec ? 1 : 0];
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  if (!cluster_path) {
    long long row_blocks = ceil_div(2LL * info.sms, class_blocks);
    if (row_blocks > row_blocks_max) row_blocks = row_blocks_max;
    p.rows_per_block = ceil_div(n, row_blocks);
    row_blocks = ceil_div(n, p.rows_per_block);
    fn<<<dim3(static_cast<unsigned>(row_blocks), static_cast<unsigned>(class_blocks)), kThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }

  const size_t smem = shared_bytes(p.cb, t);
  int cs = 1;
  while (cs * 2 <= kMaxCluster && cs * 2 <= row_blocks_max) cs *= 2;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (smem > 48 * 1024) {  // make sure such a cluster fits on the card at all
    for (; cs > 1; cs >>= 1) {
      attr[0].val.clusterDim.x = cs;
      cfg.gridDim = dim3(cs, static_cast<unsigned>(class_blocks));
      int clusters = 0;
      if (cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg) == cudaSuccess && clusters > 0) break;
    }
    cudaGetLastError();  // a refused query leaves no error behind
  }
  p.rows_per_block = ceil_div(n, cs);
  attr[0].val.clusterDim.x = cs;
  cfg.gridDim = dim3(static_cast<unsigned>(cs), static_cast<unsigned>(class_blocks));
  cudaError_t err = cudaLaunchKernelEx(&cfg, fn, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
