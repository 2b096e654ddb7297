// Batched pairwise IoU of xyxy boxes for MeanAveragePrecision, with the
// valid-pair mask in the same pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_iou_kernel` in metrics_tpu/ops/kernels/iou_matching.py:41
// (launched by `_pairwise_iou_pallas`, one grid step per image), together with
// the zeroing of invalid pairs that `_image_eval` applies to its output
// (iou_matching.py:169-170).
//
// What it computes: for det (B, D, 4) and gt (B, G, 4) float32 boxes and,
// optionally, per-image counts det_counts (B,) and gt_counts (B,) int32,
//   out[b, d, g] = (d < det_counts[b] && g < gt_counts[b]) ? iou(det[b, d], gt[b, g]) : +0.0
// (without the counts every pair is valid), where iou is
// exactly the operations of `box_iou` (metrics_tpu/ops/detection/boxes.py:59-77),
// in its order, each one IEEE float32 rounded to nearest:
//   area_d = (x2 - x1) * (y2 - y1), area_g likewise
//   lt = max(top-left corners), rb = min(bottom-right corners)
//   wh = rb - lt, with every negative set to 0 (NaN passes, as in jnp.clip)
//   inter = wh_x * wh_y
//   union = (area_d + area_g) - inter
//   out = union > 0 ? inter / union : 0
// The adds, multiplies and the divide are the _rn intrinsics, so no build flag
// can contract them into an FMA (union is exactly where a contraction would
// change the rounding) or swap in a fast divide. The build also passes
// --fmad=false. fmaxf/fminf drop a NaN corner where torch.maximum keeps it,
// but a NaN corner makes its box's area NaN, so the union is NaN and both give
// 0. Results equal the PyTorch plain version bit for bit.
//
// What bounds it on an H100: bytes. At the COCO compute's chunk B=256, D=128,
// G=32 the least traffic is B*(D+G)*16 bytes of boxes and B*8 of counts read
// plus B*D*G*4 written, 4.85 MB, or 1.45 us at 3.35 TB/s; about 12 flops per
// pair is 0.2 us at 67 TFLOP/s. Launch and DRAM latency set the time.
//
// How the design meets that: a grid of a few blocks per SM strides over work
// items, an item being (image, tile of up to 252 detections, tile of up to 64
// ground truths, a power of two wide), so for COCO shapes one item is one
// image. A block stages its item's boxes in shared memory with 16-byte loads
// (one box is one float4; scalar loads where a base is not 16-byte aligned),
// computes each box's area once, and keeps the ground truths as columns
// (x1[], y1[], x2[], y2[], area[]) so that a thread reads 4 consecutive ground
// truths with one float4 per coordinate. Each thread then writes 4 consecutive
// g of one row with one 16-byte store where G % 4 == 0 and the output is
// 16-byte aligned, and with scalar stores otherwise. A warp covers 16 rows x 8
// ground truths, so that whether its columns are valid is one answer for the
// whole warp: rows and columns beyond the counts are written as +0.0 without
// computing an IoU, and in a COCO chunk (about 7 valid of 32 columns) most
// warps compute none. Index arithmetic in the pair loop is shifts and masks;
// the co-resident blocks of an SM overlap one image's box loads with
// another's stores.
//
// The caller allocates the output and passes PyTorch's current stream; nothing
// here allocates or synchronises.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileG = 64;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDevices = 64;

struct Params {
  const float* det;
  const float* gt;
  const int* det_counts;  // both null: every pair valid
  const int* gt_counts;
  float* out;
  int b, d, g;
  int tile_d, tile_g;
  int group_log2;  // log2(tile_g / 4): groups of 4 ground truths per row
  int rows_log2;   // log2 of tile_d rounded up to a power of two
  int d_tiles, g_tiles;
  long long items;
  bool box_vec;  // det and gt bases 16-byte aligned
};

__device__ __forceinline__ float clip_at_zero(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float area_of(float4 box) {
  return __fmul_rn(__fsub_rn(box.z, box.x), __fsub_rn(box.w, box.y));
}

__device__ __forceinline__ float4 load_box(const float* base, size_t index, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(base) + index);
  const float* p = base + index * 4;
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ float iou_of(float4 a, float area_a, float bx1, float by1, float bx2, float by2,
                                        float area_b) {
  const float ltx = fmaxf(a.x, bx1);
  const float lty = fmaxf(a.y, by1);
  const float rbx = fminf(a.z, bx2);
  const float rby = fminf(a.w, by2);
  const float wx = clip_at_zero(__fsub_rn(rbx, ltx));
  const float wy = clip_at_zero(__fsub_rn(rby, lty));
  const float inter = __fmul_rn(wx, wy);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__device__ __forceinline__ int valid_in_tile(const int* counts, int image, int start, int len) {
  if (counts == nullptr) return len;
  return min(max(__ldg(counts + image) - start, 0), len);
}

template <bool kVecStore>
__global__ void __launch_bounds__(kThreads) pairwise_iou_kernel(Params p) {
  __shared__ float4 s_det[kThreads];
  __shared__ float s_area_d[kThreads];
  __shared__ __align__(16) float s_gt[5][kMaxTileG];  // x1, y1, x2, y2, area by column

  const int tid = threadIdx.x;
  const int row_mask = (1 << p.rows_log2) - 1;
  for (long long item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int gi = static_cast<int>(item % p.g_tiles);
    const long long rest = item / p.g_tiles;
    const int di = static_cast<int>(rest % p.d_tiles);
    const int image = static_cast<int>(rest / p.d_tiles);
    const int d0 = di * p.tile_d;
    const int g0 = gi * p.tile_g;
    const int td = min(p.tile_d, p.d - d0);
    const int tg = min(p.tile_g, p.g - g0);
    const int nd = valid_in_tile(p.det_counts, image, d0, td);  // valid rows [0, nd)
    const int ng = valid_in_tile(p.gt_counts, image, g0, tg);   // valid columns [0, ng)

    // tile_d + tile_g <= kThreads: one box per thread
    if (tid < nd) {
      const float4 box = load_box(p.det, static_cast<size_t>(image) * p.d + d0 + tid, p.box_vec);
      s_det[tid] = box;
      s_area_d[tid] = area_of(box);
    } else if (tid >= p.tile_d && tid - p.tile_d < ng) {
      const int j = tid - p.tile_d;
      const float4 box = load_box(p.gt, static_cast<size_t>(image) * p.g + g0 + j, p.box_vec);
      s_gt[0][j] = box.x;
      s_gt[1][j] = box.y;
      s_gt[2][j] = box.z;
      s_gt[3][j] = box.w;
      s_gt[4][j] = area_of(box);
    }
    __syncthreads();

    // q's bits, low to high: one bit of group within a pair of groups, the
    // row, the pair: a warp takes 16 rows x 2 groups, so whether its groups
    // lie within the valid columns is the same for all its lanes, and each
    // row's two groups are one 32-byte segment of the output
    float* out_tile = p.out + (static_cast<size_t>(image) * p.d + d0) * p.g + g0;
    const int work = (2 << p.rows_log2) << (p.group_log2 > 0 ? p.group_log2 - 1 : 0);
    for (int q = tid; q < work; q += kThreads) {
      const int dd = (q >> 1) & row_mask;
      const int gg = (((q >> (p.rows_log2 + 1)) << 1) + (q & 1)) * 4;
      if (dd >= td || gg >= tg) continue;
      float r[4] = {0.f, 0.f, 0.f, 0.f};
      if (dd < nd && gg < ng) {
        const float4 a = s_det[dd];
        const float area_a = s_area_d[dd];
        const float4 x1 = *reinterpret_cast<const float4*>(&s_gt[0][gg]);
        const float4 y1 = *reinterpret_cast<const float4*>(&s_gt[1][gg]);
        const float4 x2 = *reinterpret_cast<const float4*>(&s_gt[2][gg]);
        const float4 y2 = *reinterpret_cast<const float4*>(&s_gt[3][gg]);
        const float4 ar = *reinterpret_cast<const float4*>(&s_gt[4][gg]);
        r[0] = iou_of(a, area_a, x1.x, y1.x, x2.x, y2.x, ar.x);
        r[1] = gg + 1 < ng ? iou_of(a, area_a, x1.y, y1.y, x2.y, y2.y, ar.y) : 0.f;
        r[2] = gg + 2 < ng ? iou_of(a, area_a, x1.z, y1.z, x2.z, y2.z, ar.z) : 0.f;
        r[3] = gg + 3 < ng ? iou_of(a, area_a, x1.w, y1.w, x2.w, y2.w, ar.w) : 0.f;
      }
      float* dst = out_tile + static_cast<size_t>(dd) * p.g + gg;
      if constexpr (kVecStore) {
        *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (gg + j < tg) dst[j] = r[j];
        }
      }
    }
    __syncthreads();  // the next item's boxes overwrite these
  }
}

std::atomic<int> g_sms[kMaxDevices];

int sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int n = g_sms[device].load(std::memory_order_relaxed);
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sms[device].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return 0;
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// det (b, d, 4) f32, gt (b, g, 4) f32, out (b, d, g) f32, all contiguous;
// det_counts and gt_counts (b,) int32, or both null; b, d, g >= 1. Returns
// cudaGetLastError() after the launch (0 on success).
int pairwise_iou_launch(const float* det, const float* gt, const int* det_counts, const int* gt_counts, float* out,
                        int b, int d, int g, void* stream) {
  if (b < 1 || d < 1 || g < 1 || (det_counts == nullptr) != (gt_counts == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  const int status = sm_count(&sms);
  if (status != 0) return status;
  Params p;
  p.det = det;
  p.gt = gt;
  p.det_counts = det_counts;
  p.gt_counts = gt_counts;
  p.out = out;
  p.b = b;
  p.d = d;
  p.g = g;
  p.tile_g = next_pow2(g < kMaxTileG ? g : kMaxTileG);
  if (p.tile_g < 4) p.tile_g = 4;
  p.group_log2 = 0;
  while ((4 << p.group_log2) < p.tile_g) ++p.group_log2;
  p.tile_d = d < kThreads - p.tile_g ? d : kThreads - p.tile_g;
  p.rows_log2 = 0;
  while ((1 << p.rows_log2) < p.tile_d) ++p.rows_log2;
  p.d_tiles = (d + p.tile_d - 1) / p.tile_d;
  p.g_tiles = (g + p.tile_g - 1) / p.tile_g;
  p.items = static_cast<long long>(b) * p.d_tiles * p.g_tiles;
  p.box_vec = reinterpret_cast<uintptr_t>(det) % 16 == 0 && reinterpret_cast<uintptr_t>(gt) % 16 == 0;
  const bool vec_store = g % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  const unsigned grid = static_cast<unsigned>(p.items < most ? p.items : most);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_store) {
    pairwise_iou_kernel<true><<<grid, kThreads, 0, s>>>(p);
  } else {
    pairwise_iou_kernel<false><<<grid, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
