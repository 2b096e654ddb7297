// Row and column maxima of batched token similarities for BERTScore, on the
// tensor cores in 3xTF32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_maxsim_kernel` in metrics_tpu/ops/kernels/cosine_matching.py:53
// (launched by `_pr_f1_pallas`, one grid step per (batch, layer)). It takes
// the shapes TMA can describe, D a multiple of 4 and both operands 16-byte
// aligned; the wrapper (ops/kernels/cosine_matching.py) first copies any other
// operands with D padded by zero columns.
//
// What it computes: for preds (B, L, P, D) and target (B, L, R, D) float32, per
// pair (b, l) of the B*L pairs,
//   rowmax[b, l, p] = max_r sum_d preds[b, l, p, d] * target[b, l, r, d]
//   colmax[b, l, r] = max_p of the same sum
// to float32 accuracy. The (B, L, P, R) similarity never reaches device memory.
// A max propagates NaN, as torch.amax does: every NaN maps to the top key below
// and decodes back to NaN. -0.0 and +0.0 get different keys, so where both occur
// the kernel may return either sign of zero; they compare equal.
//
// 3xTF32: each operand is split as x = big + small, big = tf32(x) and
// small = tf32(x - big), both rounded with cvt.rna.tf32.f32, and each dot
// product is small_a.big_b + big_a.small_b + big_a.big_b; the small.small term
// (about 2^-22 of the product) is dropped. The products run on the TF32 tensor
// cores with float32 accumulation. How the tensor cores round their float32
// sums is not documented (earlier generations were found to truncate), so a
// wgmma accumulator never sums more than one slab of 128 of D: each slab's sum
// is added into a float32 register total with __fadd_rn. A truncating adder
// then loses at most about 48 ulp of a slab sum of 1/8 (7e-7) per slab, not
// 384 ulp of the whole sum (4.6e-5) at D = 1024. An operand of magnitude near
// FLT_MAX, or infinite, gives NaN (its small part is inf - inf); token
// embeddings are normalised.
//
// What bounds it on an H100: operations. At BERTScore's full width (P = R =
// 512, D = 1024) each pair is 2 * 512 * 512 * 1024 = 0.54 GFLOP, three times
// over in TF32: 3.22e12 TF32 operations for 2,000 pairs, 6.51 ms at the dense
// TF32 peak of 495 TFLOP/s, against 2.51 ms to read the 8.40 GB once.
//
// How the design meets that (the usual shape of a Hopper GEMM): a block of
// 384 threads owns 128 rows of P of one pair and walks every 128-column tile
// of R, so its row maxima stay in registers and are written once. Per stage
// of 32 of D:
// - thread 0 of the converter warpgroup (warps 8-11) issues two TMA loads (a
//   3-D tensor map per operand, (D, P or R, pairs), boxes of 32 x 128 x 1 with
//   the 128-byte swizzle) into a ring of 4 raw stages of 32 KB (A, then B);
//   rows beyond P or R and columns beyond D arrive as zeros;
// - the converter warpgroup splits the B tile into big and small TF32 halves,
//   in a ring of 3 converted stages of 32 KB (B big, B small, each 16 KB in the
//   same swizzled layout): 4 * 32 + 3 * 32 = 224 KB of shared memory;
// - two consumer warpgroups (warps 0-7), 64 rows each, read their A rows of
//   the raw tile into registers (the wgmma fragment layout), split them there,
//   and issue 3 x 4 wgmma m64n128k8 with A from registers and B from shared
//   memory (K-major, as .tf32 requires) into a 64 x 128 accumulator of 64
//   registers a thread beside a 64-register total. A fed from registers keeps
//   A's split and A's wgmma reads off shared memory, whose bandwidth the
//   tensor cores' B reads, the B split and TMA already share. setmaxnreg moves
//   registers from the converter (56) to the consumers (224). A warpgroup waits
//   for its products before it reuses its A registers; the two warpgroups
//   alternate on the tensor cores.
// After each column tile, each thread folds its fragment into keys: row maxima
// over a quad of lanes, kept across tiles; column maxima over the warpgroup's
// lanes and warps (shuffles, then shared-memory atomicMax), merged into
// per-pair scratch in device memory with atomicMax on an order-preserving
// uint32 key of the float bits, since the 4 row tiles of a pair are 4 blocks.
// Rows beyond P and columns beyond R are masked there, not counted: they hold
// zeros, and a true maximum can be negative. A max is exact, so the result
// does not depend on the order of the atomics. A second small kernel decodes
// the column keys.
//
// The tensor maps come from cuTensorMapEncodeTiled, which lives in libcuda;
// it is fetched with cudaGetDriverEntryPoint, so the library needs no -lcuda.
// Offsets into the operands are 64-bit: at B*P*D = 2000 * 512 * 1024 an
// operand holds half of 2^31 elements.
//
// The caller allocates the outputs and the scratch and passes PyTorch's
// current stream; nothing here allocates or synchronises.

#include <climits>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the function itself comes from the runtime
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;             // rows of P per block, columns of R per column tile
constexpr int kDepth = 32;             // D per stage: 32 floats, one 128-byte swizzle row
constexpr int kRawStages = 4;          // TMA ring of float32 A and B tiles
constexpr int kConvStages = 3;         // ring of split TF32 B tiles
constexpr int kSlabStages = 4;         // a wgmma accumulator sums 4 stages, 128 of D
constexpr int kConsumerThreads = 256;  // two warpgroups issue wgmma
constexpr int kThreads = 384;          // and one converter warpgroup
constexpr int kConverterRegs = 56;     // setmaxnreg: 128 * 56 + 256 * 224 = 384 * 168, the launch's registers
constexpr int kConsumerRegs = 224;
constexpr int kTileBytes = kTile * kDepth * 4;  // 16 KB
constexpr int kRawBytes = 2 * kTileBytes;        // the A and B tiles of a stage
constexpr int kConvBytes = 2 * kTileBytes;       // B big, B small
constexpr int kRingBytes = kRawStages * kRawBytes + kConvStages * kConvBytes;  // 224 KB
constexpr int kSmemBytes = kRingBytes + 128 + kTile * 4 + 1024;  // + mbarriers, column keys, alignment slack
constexpr unsigned kFull = 0xFFFFFFFFu;

// Monotone map of float32 to uint32 (a < b as floats => key(a) < key(b));
// every NaN maps to the top key. Key 0 is below every float and marks
// "nothing seen yet" in the zeroed scratch.
__device__ __forceinline__ unsigned order_key(float v) {
  if (v != v) return 0xFFFFFFFFu;
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
  if (k == 0xFFFFFFFFu) return __uint_as_float(0x7FC00000u);
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
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

// Arrive when `pred` holds, as one predicated instruction: no branch that the
// compiler would have to treat as divergent around in-flight wgmma.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile("{\n .reg .pred p;\n setp.ne.u32 p, %1, 0;\n @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
                   smem_u32(bar)),
               "r"(static_cast<unsigned>(pred))
               : "memory");
}

// Spin in PTX until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n @!p bra WAIT;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void named_barrier(unsigned id, unsigned threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Box (32, 128, 1) of a (D, rows, pairs) tensor map at (k0, row0, pair).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int k0, int row0,
                                         int pair) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0), "r"(row0), "r"(pair)
      : "memory");
}

__device__ __forceinline__ float to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ float4 split_big(float4 x) {
  return make_float4(to_tf32(x.x), to_tf32(x.y), to_tf32(x.z), to_tf32(x.w));
}

__device__ __forceinline__ float4 split_small(float4 x, float4 big) {
  return make_float4(to_tf32(__fsub_rn(x.x, big.x)), to_tf32(__fsub_rn(x.y, big.y)), to_tf32(__fsub_rn(x.z, big.z)),
                     to_tf32(__fsub_rn(x.w, big.w)));
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// TMA writes: rows of 128 bytes, 8-row atoms 1,024 bytes apart (the stride
// byte offset); the leading byte offset is unused for this layout. The start
// address must lie in a 1,024-byte-aligned atom; moving 8 along K adds 32
// bytes, 2 in the 16-byte units of the address field.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving accesses to the accumulator across the
// asynchronous wgmma that writes it.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, float32) = A (64 x 8) . B (8 x 128) + (scale_d ? d : 0), TF32,
// A from registers: this thread's a[0..3] are A's (g, t), (g + 8, t), (g, t + 4)
// and (g + 8, t + 4), g = 16 * warp + lane / 4, t = lane % 4.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const unsigned (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__global__ void __launch_bounds__(kThreads, 1) maxsim_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                                                                 const __grid_constant__ CUtensorMap map_b,
                                                                 unsigned* __restrict__ col_keys,
                                                                 float* __restrict__ rowmax, int p, int r, int d,
                                                                 int row_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);  // swizzle atoms need 1,024 B
  uint8_t* raw = smem;
  uint8_t* conv = smem + kRawStages * kRawBytes;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem + kRingBytes);  // TMA bytes landed
  uint64_t* raw_empty = raw_full + kRawStages;    // B split and A read into every consumer warp's registers
  uint64_t* conv_full = raw_empty + kRawStages;   // B split, ready for wgmma
  uint64_t* conv_empty = conv_full + kConvStages;  // every consumer warp's products on it are done
  unsigned* s_col = reinterpret_cast<unsigned*>(smem + kRingBytes + 128);  // column keys of a tile

  const int pair = blockIdx.x / row_tiles;
  const int p0 = (blockIdx.x - pair * row_tiles) * kTile;
  const int nk = (d + kDepth - 1) / kDepth;
  const int n_col_tiles = (r + kTile - 1) / kTile;
  const int total = nk * n_col_tiles;  // stages
  const int tid = threadIdx.x;
  constexpr unsigned kConsumerWarps = kConsumerThreads / 32;

  if (tid == 0) {
    for (int s = 0; s < kRawStages; ++s) {
      mbar_init(&raw_full[s], 1);
      mbar_init(&raw_empty[s], 1 + kConsumerWarps);
    }
    for (int s = 0; s < kConvStages; ++s) {
      mbar_init(&conv_full[s], 1);
      mbar_init(&conv_empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < kTile) s_col[tid] = 0u;
  __syncthreads();

  // the warpgroup index, broadcast so that the compiler sees it uniform
  const int wg = __shfl_sync(kFull, tid / 128, 0);
  if (wg == kConsumerThreads / 128) {
    // ---- converter warpgroup; its thread 0 also issues the TMA loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kConverterRegs));
    const int ct = tid - kConsumerThreads;
    auto issue = [&](int j) {  // stage j into raw slot j % kRawStages, once its last use is released
      const int s = j % kRawStages;
      mbar_wait(&raw_empty[s], ((j / kRawStages) & 1) ^ 1);  // the first use of each slot passes
      const int col_tile = j / nk;
      const int k0 = (j - col_tile * nk) * kDepth;
      uint8_t* dst = raw + s * kRawBytes;
      mbar_expect_tx(&raw_full[s], kRawBytes);
      tma_load(dst, &map_a, &raw_full[s], k0, p0, pair);
      tma_load(dst + kTileBytes, &map_b, &raw_full[s], k0, col_tile * kTile, pair);
    };
    if (ct == 0) {
      for (int j = 0; j < kRawStages - 1 && j < total; ++j) issue(j);
    }
    for (int i = 0; i < total; ++i) {
      const int s = i % kRawStages;
      const int c = i % kConvStages;
      mbar_wait(&raw_full[s], (i / kRawStages) & 1);
      mbar_wait(&conv_empty[c], ((i / kConvStages) & 1) ^ 1);
      const float4* src = reinterpret_cast<const float4*>(raw + s * kRawBytes + kTileBytes);
      float4* dst = reinterpret_cast<float4*>(conv + c * kConvBytes);
#pragma unroll 4
      for (int j = 0; j < kTileBytes / 16 / 128; ++j) {
        const int q = ct + 128 * j;  // float4 index in the B tile; big at q, small 16 KB on
        const float4 x = src[q];
        const float4 big = split_big(x);
        dst[q] = big;
        dst[q + kTileBytes / 16] = split_small(x, big);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to wgmma and to TMA
      named_barrier(1, 128);
      if (ct == 0) {
        mbar_arrive(&conv_full[c]);
        mbar_arrive(&raw_empty[s]);  // the converter's share of the slot's release
        if (i + kRawStages - 1 < total) issue(i + kRawStages - 1);
      }
    }
  } else {
    // ---- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int g = wg * 64 + warp * 16 + (lane >> 2);  // this thread's rows of the tile: g and g + 8
    const int t = lane & 3;
    const int row_lo = p0 + g;
    const bool row_ok0 = row_lo < p;
    const bool row_ok1 = row_lo + 8 < p;
    // this thread's A elements in a 128-byte-swizzled tile: rows g and g + 8
    // share their swizzle; 16-byte chunk 2ks holds k = 8ks + t, 2ks + 1 holds k + 4
    const int a_lo = g * 128 + t * 4;
    const int a_hi = a_lo + 8 * 128;
    const int swz = g & 7;
    float acc[64], sum[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      acc[j] = 0.f;
      sum[j] = 0.f;
    }
    unsigned row_key0 = 0u, row_key1 = 0u;
    int i = 0;  // the stage
    for (int col_tile = 0; col_tile < n_col_tiles; ++col_tile) {
      for (int k = 0; k < nk; ++k, ++i) {
        const int s = i % kRawStages;
        const int c = i % kConvStages;
        const bool slab_start = k % kSlabStages == 0;
        const bool slab_end = k == nk - 1 || k % kSlabStages == kSlabStages - 1;
        // A from the raw tile into registers, split into big and small halves
        mbar_wait(&raw_full[s], (i / kRawStages) & 1);
        const uint8_t* a_tile = raw + s * kRawBytes;
        float x[kDepth / 8][4];
#pragma unroll
        for (int ks = 0; ks < kDepth / 8; ++ks) {
          const int lo = ((2 * ks) ^ swz) << 4;
          const int hi = ((2 * ks + 1) ^ swz) << 4;
          x[ks][0] = *reinterpret_cast<const float*>(a_tile + a_lo + lo);
          x[ks][1] = *reinterpret_cast<const float*>(a_tile + a_hi + lo);
          x[ks][2] = *reinterpret_cast<const float*>(a_tile + a_lo + hi);
          x[ks][3] = *reinterpret_cast<const float*>(a_tile + a_hi + hi);
        }
        mbar_arrive_if(&raw_empty[s], lane == 0);
        unsigned a_big[kDepth / 8][4], a_small[kDepth / 8][4];
#pragma unroll
        for (int ks = 0; ks < kDepth / 8; ++ks) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float big = to_tf32(x[ks][e]);
            a_big[ks][e] = __float_as_uint(big);
            a_small[ks][e] = __float_as_uint(to_tf32(__fsub_rn(x[ks][e], big)));
          }
        }
        mbar_wait(&conv_full[c], (i / kConvStages) & 1);
        const uint32_t base = smem_u32(conv + c * kConvBytes);
        const uint64_t b_big = smem_desc(base);
        const uint64_t b_small = smem_desc(base + kTileBytes);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kDepth / 8; ++ks) {
          const uint64_t off = 2 * ks;
          wgmma_tf32(acc, a_small[ks], b_big + off, (slab_start && ks == 0) ? 0 : 1);
          wgmma_tf32(acc, a_big[ks], b_small + off, 1);
          wgmma_tf32(acc, a_big[ks], b_big + off, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();  // the A registers are read until the products are done
        fence_acc(acc);
        mbar_arrive_if(&conv_empty[c], lane == 0);
        if (slab_end) {
#pragma unroll
          for (int j = 0; j < 64; ++j) {
            sum[j] = __fadd_rn(sum[j], acc[j]);
            acc[j] = 0.f;
          }
        }
      }
      // ---- epilogue of one column tile: fragment value 4j + 2h + e is row
      // row_lo + 8h, column 8j + 2 * (lane % 4) + e
      const int c0 = col_tile * kTile;
      named_barrier(2, kConsumerThreads);  // the last tile's column keys are flushed
      unsigned rk0 = 0u, rk1 = 0u, ck[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) {  // x = 2j + e: column 8j + 2t + e
        const int col = 8 * (x / 2) + 2 * t + x % 2;
        const bool col_ok = c0 + col < r;
        const unsigned k0 = (col_ok && row_ok0) ? order_key(sum[4 * (x / 2) + x % 2]) : 0u;
        const unsigned k1 = (col_ok && row_ok1) ? order_key(sum[4 * (x / 2) + 2 + x % 2]) : 0u;
        rk0 = max(rk0, k0);
        rk1 = max(rk1, k1);
        ck[x] = max(k0, k1);
      }
      // shuffles level by level: warp-synchronous operations stay in program
      // order, so column by column their latencies would add up
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
        for (int x = 0; x < 32; ++x) ck[x] = max(ck[x], __shfl_xor_sync(kFull, ck[x], off));
      }
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int col = 8 * (x / 2) + 2 * t + x % 2;
        if (lane < 4 && c0 + col < r) atomicMax(&s_col[col], ck[x]);
      }
      rk0 = max(rk0, __shfl_xor_sync(kFull, rk0, 1));
      rk0 = max(rk0, __shfl_xor_sync(kFull, rk0, 2));
      rk1 = max(rk1, __shfl_xor_sync(kFull, rk1, 1));
      rk1 = max(rk1, __shfl_xor_sync(kFull, rk1, 2));
      row_key0 = max(row_key0, rk0);
      row_key1 = max(row_key1, rk1);
      named_barrier(2, kConsumerThreads);
      if (tid < kTile) {
        if (c0 + tid < r) atomicMax(&col_keys[static_cast<size_t>(pair) * r + c0 + tid], s_col[tid]);
        s_col[tid] = 0u;
      }
#pragma unroll
      for (int j = 0; j < 64; ++j) sum[j] = 0.f;
    }
    // every column tile seen: this block's rows are complete
    if (t == 0) {
      if (row_ok0) rowmax[static_cast<size_t>(pair) * p + row_lo] = from_key(row_key0);
      if (row_ok1) rowmax[static_cast<size_t>(pair) * p + row_lo + 8] = from_key(row_key1);
    }
  }
}

__global__ void decode_kernel(const unsigned* __restrict__ keys, float* __restrict__ out, size_t n) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    out[i] = from_key(keys[i]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled lookup_encode() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &status);
#else
  const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &status);
#endif
  if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

// The (D, rows, pairs) float32 tensor map of a contiguous (pairs, rows, D)
// operand, boxes of (32, 128, 1) with the 128-byte swizzle; out-of-range
// elements load as zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const float* base, long long pairs, int rows, int d) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(pairs)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 4, static_cast<cuuint64_t>(rows) * d * 4};
  const cuuint32_t box[3] = {kDepth, kTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// preds (pairs, p, d) f32 and target (pairs, r, d) f32, contiguous and 16-byte
// aligned, d a positive multiple of 4; col_keys (pairs * r) u32 scratch; rowmax
// (pairs, p) and colmax (pairs, r) f32. pairs, p, r >= 1. Returns the first
// CUDA error of the memset and the two launches (0 on success);
// cudaErrorInvalidValue for a shape or alignment TMA cannot describe or a grid
// that would not fit in an int; cudaErrorSymbolNotFound when
// cuTensorMapEncodeTiled cannot be found.
int maxsim_tc_launch(const float* preds, const float* target, unsigned int* col_keys, float* rowmax, float* colmax,
                     long long pairs, int p, int r, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pairs < 1 || p < 1 || r < 1 || d < 4 || d % 4 != 0 || pairs > INT_MAX ||
      reinterpret_cast<uintptr_t>(preds) % 16 != 0 || reinterpret_cast<uintptr_t>(target) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long row_tiles = (p + kTile - 1) / kTile;
  if (pairs * row_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static const EncodeTiled encode = lookup_encode();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap map_a, map_b;
  if (!make_map(encode, &map_a, preds, pairs, p, d) || !make_map(encode, &map_b, target, pairs, r, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t n_col = static_cast<size_t>(pairs) * r;
  cudaError_t err = cudaMemsetAsync(col_keys, 0, n_col * sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(maxsim_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  maxsim_tc_kernel<<<static_cast<unsigned int>(pairs * row_tiles), kThreads, kSmemBytes, s>>>(
      map_a, map_b, col_keys, rowmax, p, r, d, static_cast<int>(row_tiles));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t want = (n_col + 255) / 256;
  decode_kernel<<<static_cast<unsigned int>(want < 8192 ? want : 8192), 256, 0, s>>>(col_keys, colmax, n_col);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
