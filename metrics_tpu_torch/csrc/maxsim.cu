// Row and column maxima of batched token similarities for BERTScore, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_maxsim_kernel` in metrics_tpu/ops/kernels/cosine_matching.py:53
// (launched by `_pr_f1_pallas`, one grid step per (batch, layer)).
//
// What it computes: for preds (B, L, P, D) and target (B, L, R, D) float32, per
// pair (b, l) of the B*L pairs,
//   rowmax[b, l, p] = max_r sum_d preds[b, l, p, d] * target[b, l, r, d]
//   colmax[b, l, r] = max_p of the same sum
// in float32 with float32 accumulation. The (B, L, P, R) similarity never
// reaches device memory. Every product is added with __fmaf_rn, one rounding
// per step whatever the build flags (the build passes --fmad=false, which
// would split a plain a * b + c in two). The sum runs over d in increasing
// order; cuBLAS, behind the plain version, sums in another order, so the two
// agree within rounding (about 1e-6 for unit vectors at D = 1024), not to the
// bit. A max propagates NaN, as torch.amax does: every NaN maps to the top key
// below and decodes back to NaN. -0.0 and +0.0 get different keys, so where
// both occur the kernel may return either sign of zero; they compare equal.
//
// What bounds it on an H100: operations. At BERTScore's full width (P = R =
// 512, D = 1024) each pair is 2 * 512 * 512 * 1024 = 0.54 GFLOP on 4 MB of
// input, 128 flops a byte, far above the card's 20 flops a byte for float32
// outside the tensor cores (67 TFLOP/s over 3.35 TB/s). Tensor cores in TF32
// would round the operands to 10 bits of mantissa, far outside the bound the
// metric is held to, so the products run on the float32 pipes.
//
// How the design meets that: the classic register-tiled SGEMM. One block of
// 256 threads owns a 128 x 128 tile of one pair's (P, R) similarity; each
// thread holds an 8 x 8 sub-tile of sums in registers. D is walked in chunks of
// 16: each chunk of both operands is staged in shared memory, transposed so
// that a thread reads its 8 rows and 8 columns as four 16-byte loads (64 fmas
// per 4 loads), while the next chunk is fetched from device memory into
// registers. At the end each tile folds its sums into row and column maxima
// (warp shuffles, then shared-memory atomics) and merges them into per-pair
// scratch in device memory with atomicMax on an order-preserving unsigned
// encoding of the float bits. A max is exact, so the result does not depend on
// the order of the atomics and is the same from run to run. A second small
// kernel decodes the keys to float32.
//
// Offsets into the operands are 64-bit: at B*P*D = 2000 * 512 * 1024 an
// operand holds half of 2^31 elements.
//
// The caller allocates the outputs and the scratch and passes PyTorch's
// current stream; nothing here allocates or synchronises.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;       // output tile side, in rows of P and in columns of R
constexpr int kChunk = 16;       // depth staged per step
constexpr int kLd = kTile + 4;   // shared row stride: keeps 16-byte alignment, at most 2-way store conflicts
constexpr int kHalf = kTile / 2;

// Monotone map of float32 to uint32 (a < b as floats => key(a) < key(b));
// every NaN maps to the top key. Key 0 is below every float and marks
// "nothing seen yet" in the zeroed scratch.
__device__ __forceinline__ unsigned int order_key(float v) {
  if (v != v) return 0xFFFFFFFFu;
  const unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned int k) {
  if (k == 0xFFFFFFFFu) return __uint_as_float(0x7FC00000u);
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// Rows of a thread's sub-tile: 4 in the first half of the tile and 4 in the
// second, so that the 16 threads of a half-warp read 256 contiguous bytes.
__device__ __forceinline__ int sub_index(int lane16, int i) {
  return (i < 4 ? 0 : kHalf) + lane16 * 4 + (i & 3);
}

// Fetch depth [k0, k0 + kChunk) of rows [row0, row0 + kTile) of a row-major
// (rows, d) matrix into registers, zero outside it: thread t holds 4
// consecutive depth values of rows (t >> 2) and (t >> 2) + 64.
template <bool kVec>
__device__ __forceinline__ void fetch_chunk(const float* __restrict__ src, int rows, int d, int row0, int k0,
                                            int tid, float (&reg)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int idx = tid + h * kThreads;
    const int row = row0 + (idx >> 2);
    const int k = k0 + (idx & 3) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows && k < d) {
      const float* p = src + static_cast<size_t>(row) * d + k;
      if (kVec) {  // d % 4 == 0 and 16-byte aligned rows: k < d implies k + 3 < d
        v = *reinterpret_cast<const float4*>(p);
      } else {
        v.x = p[0];
        if (k + 1 < d) v.y = p[1];
        if (k + 2 < d) v.z = p[2];
        if (k + 3 < d) v.w = p[3];
      }
    }
    reg[h * 4 + 0] = v.x;
    reg[h * 4 + 1] = v.y;
    reg[h * 4 + 2] = v.z;
    reg[h * 4 + 3] = v.w;
  }
}

// Write a fetched chunk to shared memory transposed: dst[depth][row].
__device__ __forceinline__ void stage_chunk(const float (&reg)[8], float (*dst)[kLd], int tid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int idx = tid + h * kThreads;
    const int m = idx >> 2;
    const int kk = (idx & 3) * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) dst[kk + c][m] = reg[h * 4 + c];
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2) maxsim_kernel(
    const float* __restrict__ preds, const float* __restrict__ target, unsigned int* __restrict__ row_keys,
    unsigned int* __restrict__ col_keys, int p, int r, int d, int tiles_r, int tiles) {
  __shared__ __align__(16) float s_a[kChunk][kLd];
  __shared__ __align__(16) float s_b[kChunk][kLd];
  __shared__ unsigned int s_row[kTile];
  __shared__ unsigned int s_col[kTile];

  const long long pair = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x - pair * tiles);
  const int p0 = (tile / tiles_r) * kTile;
  const int r0 = (tile % tiles_r) * kTile;
  const float* a = preds + static_cast<size_t>(pair) * p * d;
  const float* b = target + static_cast<size_t>(pair) * r * d;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column group
  const int ty = tid >> 4;  // row group; a warp holds two, ty even in lanes 0-15

  if (tid < kTile) {
    s_row[tid] = 0u;
    s_col[tid] = 0u;
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ra[8], rb[8];
  fetch_chunk<kVec>(a, p, d, p0, 0, tid, ra);
  fetch_chunk<kVec>(b, r, d, r0, 0, tid, rb);
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    stage_chunk(ra, s_a, tid);
    stage_chunk(rb, s_b, tid);
    __syncthreads();
    if (k0 + kChunk < d) {  // the next chunk's loads fly while this one is multiplied
      fetch_chunk<kVec>(a, p, d, p0, k0 + kChunk, tid, ra);
      fetch_chunk<kVec>(b, r, d, r0, k0 + kChunk, tid, rb);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s_a[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s_a[k][kHalf + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s_b[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s_b[k][kHalf + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  __syncthreads();  // the scratch initialisation, when d == 0 skipped the loop

  // Epilogue: per-tile row and column maxima as keys; padded rows and
  // columns (beyond P or R) take key 0 and so never win.
  unsigned int col_key[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) col_key[j] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool row_ok = p0 + sub_index(ty, i) < p;
    unsigned int row_key = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned int key = (row_ok && r0 + sub_index(tx, j) < r) ? order_key(acc[i][j]) : 0u;
      row_key = max(row_key, key);
      col_key[j] = max(col_key[j], key);
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) row_key = max(row_key, __shfl_xor_sync(0xFFFFFFFFu, row_key, off));
    if (tx == 0 && row_ok) atomicMax(&s_row[sub_index(ty, i)], row_key);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned int key = max(col_key[j], __shfl_xor_sync(0xFFFFFFFFu, col_key[j], 16));
    if ((tid & 16) == 0) atomicMax(&s_col[sub_index(tx, j)], key);
  }
  __syncthreads();
  if (tid < kTile) {
    if (p0 + tid < p) atomicMax(&row_keys[static_cast<size_t>(pair) * p + p0 + tid], s_row[tid]);
  } else {
    const int c = tid - kTile;
    if (r0 + c < r) atomicMax(&col_keys[static_cast<size_t>(pair) * r + r0 + c], s_col[c]);
  }
}

__global__ void decode_kernel(const unsigned int* __restrict__ keys, float* __restrict__ rowmax,
                              float* __restrict__ colmax, size_t n_row, size_t n_total) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_total; i += stride) {
    const float v = from_key(keys[i]);
    if (i < n_row) {
      rowmax[i] = v;
    } else {
      colmax[i - n_row] = v;
    }
  }
}

}  // namespace

extern "C" {

// preds (pairs, p, d) f32 and target (pairs, r, d) f32, contiguous; keys
// (pairs * (p + r)) u32 scratch; rowmax (pairs, p) and colmax (pairs, r) f32.
// pairs, p, r >= 1, d >= 0. Returns the first CUDA error of the memset and the
// two launches (0 on success); cudaErrorInvalidValue when the grid,
// pairs * ceil(p / 128) * ceil(r / 128) blocks, would not fit in an int.
int maxsim_launch(const float* preds, const float* target, unsigned int* keys, float* rowmax, float* colmax,
                  long long pairs, int p, int r, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n_row = static_cast<size_t>(pairs) * p;
  const size_t n_total = n_row + static_cast<size_t>(pairs) * r;
  cudaError_t err = cudaMemsetAsync(keys, 0, n_total * sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tiles_r = (r + kTile - 1) / kTile;
  const int tiles = ((p + kTile - 1) / kTile) * tiles_r;
  const long long blocks = pairs * tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  unsigned int* row_keys = keys;
  unsigned int* col_keys = keys + n_row;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(preds) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(target) % 16 == 0;
  if (vec) {
    maxsim_kernel<true><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(preds, target, row_keys, col_keys,
                                                                              p, r, d, tiles_r, tiles);
  } else {
    maxsim_kernel<false><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(preds, target, row_keys, col_keys,
                                                                               p, r, d, tiles_r, tiles);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t want = (n_total + kThreads - 1) / kThreads;
  const unsigned int grid = static_cast<unsigned int>(want < 8192 ? want : 8192);
  decode_kernel<<<grid, kThreads, 0, s>>>(keys, rowmax, colmax, n_row, n_total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
