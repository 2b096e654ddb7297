// Batched pairwise IoU of xyxy boxes for MeanAveragePrecision, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_iou_kernel` in metrics_tpu/ops/kernels/iou_matching.py:41
// (launched by `_pairwise_iou_pallas`, one grid step per image).
//
// What it computes: for det (B, D, 4) and gt (B, G, 4) float32 boxes, out (B, D, G)
// float32 with, per image b and pair (d, g), exactly the operations of
// `box_iou` (metrics_tpu/ops/detection/boxes.py:59-77), in its order, each one
// IEEE float32 rounded to nearest:
//   area_d = (x2 - x1) * (y2 - y1), area_g likewise
//   lt = max(top-left corners), rb = min(bottom-right corners)
//   wh = rb - lt, with every negative set to 0 (NaN passes, as in jnp.clip)
//   inter = wh_x * wh_y
//   union = (area_d + area_g) - inter
//   out = union > 0 ? inter / union : 0
// The adds, multiplies and the divide are the _rn intrinsics, so no build flag
// can contract them into an FMA (union is exactly where a contraction would
// change the rounding) or swap in a fast divide. The build also passes
// --fmad=false. Results equal the PyTorch plain version bit for bit.
//
// What bounds it on an H100: bytes. At the COCO chunk shape B=256, D=128, G=64
// the least traffic is B*(D+G)*16 bytes read plus B*D*G*4 written, 9.18 MB, or
// 2.74 us at 3.35 TB/s; about 12 flops per pair is 0.4 us at 67 TFLOP/s.
//
// How the design meets that: one block per (image, tile of 32 detections,
// tile of 64 ground truths). The tile's boxes and their areas sit in shared
// memory, each computed once. Threads walk the tile's pairs with the ground
// truth index fastest, so consecutive threads store consecutive floats of one
// output row: every store is coalesced, and each output byte is written once.
//
// The caller allocates the output and passes PyTorch's current stream; nothing
// here allocates or synchronises.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileD = 32;
constexpr int kTileG = 64;

__device__ __forceinline__ float area_of(const float* box) {
  return __fmul_rn(__fsub_rn(box[2], box[0]), __fsub_rn(box[3], box[1]));
}

__device__ __forceinline__ float clip_at_zero(float v) { return v < 0.f ? 0.f : v; }

__global__ void __launch_bounds__(kThreads) pairwise_iou_kernel(
    const float* __restrict__ det, const float* __restrict__ gt, float* __restrict__ out, int d, int g) {
  __shared__ float s_det[kTileD][4];
  __shared__ float s_gt[kTileG][4];
  __shared__ float s_area_d[kTileD];
  __shared__ float s_area_g[kTileG];

  const int b = blockIdx.x;
  const int d0 = blockIdx.y * kTileD;
  const int g0 = blockIdx.z * kTileG;
  const int td = min(kTileD, d - d0);
  const int tg = min(kTileG, g - g0);
  const int tid = threadIdx.x;

  if (tid < td) {
    const float* box = det + (static_cast<size_t>(b) * d + d0 + tid) * 4;
    for (int k = 0; k < 4; ++k) s_det[tid][k] = box[k];
    s_area_d[tid] = area_of(box);
  } else if (tid >= kTileD && tid - kTileD < tg) {
    const int j = tid - kTileD;
    const float* box = gt + (static_cast<size_t>(b) * g + g0 + j) * 4;
    for (int k = 0; k < 4; ++k) s_gt[j][k] = box[k];
    s_area_g[j] = area_of(box);
  }
  __syncthreads();

  float* out_tile = out + (static_cast<size_t>(b) * d + d0) * g + g0;
  for (int i = tid; i < td * tg; i += kThreads) {
    const int dd = i / tg;
    const int gg = i - dd * tg;
    const float ltx = fmaxf(s_det[dd][0], s_gt[gg][0]);
    const float lty = fmaxf(s_det[dd][1], s_gt[gg][1]);
    const float rbx = fminf(s_det[dd][2], s_gt[gg][2]);
    const float rby = fminf(s_det[dd][3], s_gt[gg][3]);
    const float wx = clip_at_zero(__fsub_rn(rbx, ltx));
    const float wy = clip_at_zero(__fsub_rn(rby, lty));
    const float inter = __fmul_rn(wx, wy);
    const float uni = __fsub_rn(__fadd_rn(s_area_d[dd], s_area_g[gg]), inter);
    out_tile[static_cast<size_t>(dd) * g + gg] = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
  }
}

}  // namespace

extern "C" {

// det (b, d, 4) f32, gt (b, g, 4) f32, out (b, d, g) f32, all contiguous;
// b, d, g >= 1. Returns cudaGetLastError() after the launch (0 on success).
int pairwise_iou_launch(const float* det, const float* gt, float* out, int b, int d, int g, void* stream) {
  const dim3 grid(b, (d + kTileD - 1) / kTileD, (g + kTileG - 1) / kTileG);
  pairwise_iou_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(det, gt, out, d, g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
