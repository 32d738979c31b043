// The Hopper attention core shared by attention_rope.cu (K2, K2') and
// attention_block.cu (K4): non-causal, length-masked attention over one
// (64 query rows, head, batch row) per block, for a head width D that is a
// multiple of 16 up to 128, q, k and v read as (B, H, T, D) through their
// strides. The kernel is a template on its 16-bit element type E: bf16 (the
// DiT's default) or fp16 (`IndexTTS2(use_fp16=True)`; the TPU kernels take
// q's dtype). E sets the tensor maps' element type, the wgmma form (f32 sums
// of E.E products), the rounding of P before P.V (to v's dtype, as the TPU
// kernels round it) and of the output; the rest is f32 and the same in
// both, so the bf16 instantiation computes what the bf16-only core did.
//
// Shape of the kernel (the usual Hopper attention layout):
//   - one producer warp: one thread loads the Q tile once, then keeps K and V
//     tiles of 64 keys in flight with TMA (cp.async.bulk.tensor, a tensor map
//     per operand over (D, T, H, B)) into a 2-stage ring guarded by full /
//     empty mbarriers. A row is 64 lanes (128 bytes) per box, in the 128-byte
//     swizzle wgmma reads without bank conflicts; D = 128 takes two boxes, and
//     lanes past D and rows past T are zero-filled by the TMA unit. Key tiles
//     wholly past the row's length are never loaded;
//   - one consumer warpgroup (4 warps, 16 query rows each): S = Q.K^T as
//     wgmma m64n64k16 with both operands in shared memory (D / 16 steps), f32
//     accumulators in registers; masking, the row max and sum (quad shuffles
//     over the accumulator layout) and the rounding of P to E work on those
//     registers; P.V as wgmma with P in registers (the register-A form) and V
//     in shared memory as it was loaded (the transpose bit); O stays in
//     registers until the epilogue writes it.
// Scores live in log2 units (s * scale * log2 e, exponentials by exp2f), the
// TPU kernels' -1e9 mask scaled alike; exp2(x log2 e - m log2 e) is exp(x - m).
//
// Two softmax forms, by template flag:
//   NORMALIZED = false (K2, K2'): one pass, online: p = exp(s - running max)
//     rounded to E unnormalized, O rescaled by the max's change, and the
//     f32 row sum divides at the end. The length is clamped to [1, T].
//   NORMALIZED = true (K4): two passes over the key tiles, the TPU kernel's
//     rounding order: pass 1 (K tiles only) gets each row's max m and sum l,
//     pass 2 forms p = exp(s - m) * (1 / l) in f32 and rounds it to E
//     before P.V. Keys past T score -inf; a length of 0 masks every key to
//     -1e9, so the row averages every key < T.
//
// Its PTX helpers (mbarriers, the cluster barrier, stores into rank 0's
// shared memory) also serve int8_gemv.cu and decode_attention.cu.

#pragma once

#include <cuda.h>          // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace attn_tma {

using bf16 = __nv_bfloat16;
using f16 = __half;

template <typename E>
constexpr bool is_f16 = std::is_same<E, f16>::value;

constexpr int BQ = 64;                   // query rows per block: one warpgroup
constexpr int BK = 64;                   // keys per tile
constexpr int STAGES = 2;                // depth of the K / V ring
constexpr int CONSUMERS = 128;           // the warpgroup's threads
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int BOX = 64 * 64 * 2;         // one TMA box: 64 rows x 64 lanes of 16 bits
constexpr uint32_t ROWS8 = 8 * 128;      // 8 swizzled 128-byte rows: the SBO
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = -1e9f * LOG2E;  // the TPU kernels' -1e9, log2 units

template <int D>
struct Shape {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head width");
  static constexpr int BOXES = (D + 63) / 64;  // 64-lane boxes of a row
  static constexpr int DP = BOXES * 64;        // lanes P.V covers (N of wgmma)
  static constexpr int TILE = BOXES * BOX;     // bytes of a 64-row tile
  // 1 KB of alignment slack, the Q tile, the K / V ring, 5 mbarriers
  static constexpr int SMEM = 1024 + TILE * (1 + 2 * STAGES) + 64;
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 2;  // blocks per SM
};

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Spin until the barrier's phase of the given parity has completed. A wait
// past 2^32 cycles (seconds) can only be a fault: it traps, and the launch
// reports an error, instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 32)) __trap();
}

// Arrive on the cluster barrier without a release fence: what it orders is
// rank 0's mbarrier initialisation, which fence.mbarrier_init already
// publishes to the cluster.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address of p in rank 0's shared memory.
__device__ __forceinline__ uint32_t rank0_addr(const void* p) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;" : "=r"(remote) : "r"(smem_addr(p)));
  return remote;
}

// 16 bytes into rank 0's shared memory, counted on rank 0's mbarrier bar
// (no fence: the barrier's transaction count tracks the write)
__device__ __forceinline__ void store_to_rank0(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// One 64 x 64 box at lanes [d, d + 64), rows [t, t + 64) of head h of batch
// row b, into shared memory at dst; completion counted on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int t, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(t), "r"(h), "r"(b), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand (layout
// type 1): start address, leading and stride byte offsets, all >> 4.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma (issue .. wait).
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The accumulator operands and registers of the wgmma forms below; ``TY``
// is the PTX name of the operands' type, "bf16" or "f16".
#define ATTN_ACC32                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define ATTN_ACC64                                                                          \
  ATTN_ACC32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),         \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),         \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),         \
      "+f"(d[62]), "+f"(d[63])
#define ATTN_REGS32                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31"
#define ATTN_REGS64                                                              \
  ATTN_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
              "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
              "%57, %58, %59, %60, %61, %62, %63"
#define ATTN_MMA_SS_N64(TY)                                                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                               \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" ATTN_REGS32  \
               "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                         \
               : ATTN_ACC32                                                               \
               : "l"(a), "l"(b), "r"(accumulate))
#define ATTN_MMA_RS_N64(TY)                                                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                               \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" ATTN_REGS32  \
               "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                            \
               : ATTN_ACC32                                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
#define ATTN_MMA_RS_N128(TY)                                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                               \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" ATTN_REGS64 \
               "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                            \
               : ATTN_ACC64                                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

// D (64 x 64, f32) (+)= A (64 x 16 E, shared, K-major) . B (64 x 16 E,
// shared, K-major)^T; ``accumulate`` = 0 overwrites D.
template <typename E>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                           int accumulate) {
  if constexpr (is_f16<E>)
    ATTN_MMA_SS_N64("f16");
  else
    ATTN_MMA_SS_N64("bf16");
}

// D (64 x 64, f32) += A (64 x 16 E, registers) . B (16 x 64 E, shared,
// N-major: the transpose bit)
template <typename E>
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b) {
  if constexpr (is_f16<E>)
    ATTN_MMA_RS_N64("f16");
  else
    ATTN_MMA_RS_N64("bf16");
}

// D (64 x 128, f32) += A (64 x 16 E, registers) . B (16 x 128 E, shared,
// N-major: the transpose bit)
template <typename E>
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b) {
  if constexpr (is_f16<E>)
    ATTN_MMA_RS_N128("f16");
  else
    ATTN_MMA_RS_N128("bf16");
}

#undef ATTN_MMA_SS_N64
#undef ATTN_MMA_RS_N64
#undef ATTN_MMA_RS_N128
#undef ATTN_REGS64
#undef ATTN_REGS32
#undef ATTN_ACC64
#undef ATTN_ACC32

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// two f32 values rounded to E, packed as one 32-bit word (lo in the low half)
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_f16<E>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// 8 values of E in 16 bytes -> 8 bf16, each rounded to nearest (bf16: as
// they are). K1 and K6 take their activations and cache at E and compute on
// bf16 (gemv_core.cuh, decode_attention_core.cuh).
template <typename E>
__device__ __forceinline__ uint4 to_bf16x8(uint4 v) {
  if constexpr (is_f16<E>) {
    const __half2* h = reinterpret_cast<const __half2*>(&v);
    uint4 o;
    __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = __float22bfloat162_rn(__half22float2(h[i]));
    return o;
  } else {
    return v;
  }
}

// 8 bf16 in 16 bytes -> 8 values of E (fp16: exact within its range)
template <typename E>
__device__ __forceinline__ uint4 from_bf16x8(uint4 v) {
  if constexpr (is_f16<E>) {
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint4 o;
    __half2* h = reinterpret_cast<__half2*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __float22half2_rn(__bfloat1622float2(b[i]));
    return o;
  } else {
    return v;
  }
}

// P.V for one tile: the four k16 steps over its 64 keys, P from registers.
// V's rows are 16 keys (2048 bytes) a step; a second 64-lane box (D > 64)
// lies one box further (the LBO).
template <typename E, int DP>
__device__ __forceinline__ void pv_product(float (&o)[DP / 2], const uint32_t (&p)[4][4],
                                           uint32_t sV) {
  pin(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv = sw128_desc(sV + kk * 2 * ROWS8, BOX, ROWS8);
    if constexpr (DP == 64) mma_rs_n64<E>(o, p[kk], dv);
    else mma_rs_n128<E>(o, p[kk], dv);
  }
  wg_commit();
  wg_wait_all();
  pin(o);
}

// ---------------------------------------------------------------- kernel
template <int D, bool NORMALIZED, typename E>
__global__ void __launch_bounds__(THREADS, Shape<D>::MIN_BLOCKS)
attention_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const int* __restrict__ lengths,
                 E* __restrict__ out, long long o_sb, long long o_sh, long long o_st,
                 int T, float scale) {
  using S = Shape<D>;
  extern __shared__ unsigned char smem[];
  // 1024-byte alignment: the swizzle pattern is a function of address bits
  const uint32_t sQ = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t bars = sQ + S::TILE * (1 + 2 * STAGES);  // Q, full[2], empty[2]
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;

  const int len = lengths[b];
  int valid, n_kt;  // keys at or past ``valid`` score -1e9; key tiles visited
  if constexpr (NORMALIZED) {
    valid = len >= 1 ? min(len, T) : 0;
    n_kt = ((valid ? valid : T) + BK - 1) / BK;
  } else {
    valid = max(1, min(len, T));
    n_kt = (valid + BK - 1) / BK;
  }
  const int n_load = NORMALIZED ? 2 * n_kt : n_kt;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      mbar_init(bars + 8 * (1 + STAGES + s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one thread issues
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(bars, S::TILE);
      for (int c = 0; c < S::BOXES; ++c) tma_load(sQ + c * BOX, &tq, bars, 64 * c, q0, h, b);
      for (int i = 0; i < n_load; ++i) {
        const int s = i % STAGES;
        const uint32_t full = bars + 8 * (1 + s), empty = bars + 8 * (1 + STAGES + s);
        if (i >= STAGES) mbar_wait(empty, (i / STAGES - 1) & 1);
        const bool second = NORMALIZED && i >= n_kt;  // K4's pass 2 reloads K, adds V
        const bool with_v = !NORMALIZED || second;
        const int t0 = (second ? i - n_kt : i) * BK;
        const uint32_t sK = sQ + S::TILE * (1 + 2 * s);
        mbar_expect_tx(full, S::TILE * (with_v ? 2 : 1));
        for (int c = 0; c < S::BOXES; ++c) tma_load(sK + c * BOX, &tk, full, 64 * c, t0, h, b);
        if (with_v)
          for (int c = 0; c < S::BOXES; ++c)
            tma_load(sK + S::TILE + c * BOX, &tv, full, 64 * c, t0, h, b);
      }
    }
    return;
  }

  // the consumer warpgroup; a thread holds rows g and g + 8 of its warp's 16,
  // columns 8j + 2c4 + {0, 1} of each 8-column block j
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c4 = lane % 4;
  const float sl2 = scale * LOG2E;
  float o[S::DP / 2];
#pragma unroll
  for (int i = 0; i < S::DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
  mbar_wait(bars, 0);

  for (int i = 0; i < n_load; ++i) {
    const int s = i % STAGES;
    const bool second = NORMALIZED && i >= n_kt;
    const int kt = second ? i - n_kt : i;
    const uint32_t sK = sQ + S::TILE * (1 + 2 * s);
    mbar_wait(bars + 8 * (1 + s), (i / STAGES) & 1);

    // S = Q . K^T over D / 16 k-steps of 32 bytes inside each 64-lane box
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    pin(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
      mma_ss_n64<E>(acc, sw128_desc(sQ + off, 16, ROWS8), sw128_desc(sK + off, 16, ROWS8),
                    kk > 0);
    }
    wg_commit();
    wg_wait_all();
    pin(acc);

    // scale and mask in place; the row max over the quad
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kt * BK + 8 * j + 2 * c4 + e;
          float& x = acc[4 * j + 2 * r + e];
          x = key >= T ? -INFINITY : (key >= valid ? MASKED : x * sl2);
          tmax[r] = fmaxf(tmax[r], x);
        }

    if (NORMALIZED && !second) {  // K4 pass 1: running max and (partial) sum
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(tmax[r]));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) sum += exp2f(acc[4 * j + 2 * r + e] - m_new);
        l[r] = l[r] * exp2f(m[r] - m_new) + sum;
        m[r] = m_new;
      }
      mbar_arrive(bars + 8 * (1 + STAGES + s));
      if (i == n_kt - 1)
#pragma unroll
        for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / quad_sum(l[r]);
      continue;
    }

    if constexpr (!NORMALIZED) {  // online: rescale O and the sum to the new max
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(tmax[r]));
        const float alpha = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha;
#pragma unroll
        for (int j = 0; j < S::DP / 8; ++j) {
          o[4 * j + 2 * r] *= alpha;
          o[4 * j + 2 * r + 1] *= alpha;
        }
      }
    }
    // p in f32 (K2: unnormalized, summed; K4: times 1 / l), rounded to E
    // into the A fragments of the four k16 steps
    uint32_t p[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x0 = exp2f(acc[4 * j + 2 * r] - m[r]), x1 = exp2f(acc[4 * j + 2 * r + 1] - m[r]);
        if constexpr (NORMALIZED) {
          x0 *= inv_l[r];
          x1 *= inv_l[r];
        } else {
          l[r] += x0 + x1;
        }
        p[j / 2][(j % 2) * 2 + r] = pack2<E>(x0, x1);
      }
    pv_product<E, S::DP>(o, p, sK + S::TILE);
    mbar_arrive(bars + 8 * (1 + STAGES + s));
  }

  if constexpr (!NORMALIZED) {
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + g + 8 * r;
    if (t >= T) continue;
    E* row = out + b * o_sb + h * o_sh + t * o_st;
#pragma unroll
    for (int j = 0; j < S::DP / 8; ++j) {
      const int col = 8 * j + 2 * c4;
      if (col >= D) continue;
      float x0 = o[4 * j + 2 * r], x1 = o[4 * j + 2 * r + 1];
      if constexpr (!NORMALIZED) {
        x0 /= l[r];
        x1 /= l[r];
      }
      *reinterpret_cast<uint32_t*>(row + col) = pack2<E>(x0, x1);
    }
  }
}

// ---------------------------------------------------------------- host
// cuTensorMapEncodeTiled, fetched at run time with
// cudaGetDriverEntryPoint*, so the library links with plain nvcc and no
// -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a (B, H, T, D) 16-bit operand (fp16 if ``f16``, else
// bf16) with element strides sb, sh,
// st (D contiguous), over dims (D, T, H, B) in 64 x 64 boxes, 128-byte
// swizzle, zero fill out of bounds. A dim of extent 1 takes a packed stride
// (its own is never stepped). False if TMA cannot take the layout: a base or
// stride that is not a multiple of 16 bytes.
inline bool encode_operand(CUtensorMap* map, const void* ptr, int B, int H, int T, int D,
                           long long sb, long long sh, long long st, bool f16) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  const long long s_t = T > 1 ? st : D, s_h = H > 1 ? sh : s_t * T, s_b = B > 1 ? sb : s_h * H;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s_t * 2, (cuuint64_t)s_h * 2, (cuuint64_t)s_b * 2};
  for (int i = 0; i < 3; ++i)
    if (strides[i] == 0 || strides[i] % 16 || strides[i] >= (1ull << 40)) return false;
  const cuuint32_t box[4] = {64, 64, 1, 1}, unit[4] = {1, 1, 1, 1};
  return fn(map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

struct Strides {  // elements between neighbours along b, h, t
  long long b, h, t;
};

// Launches attention_kernel<D, NORMALIZED, E> on (B, H, T, D) q, k, v and out
// of element type E (q, k, v, out strides); returns a cudaError_t.
template <int D, bool NORMALIZED, typename E>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out, int B,
           int H, int T, Strides qs, Strides ks, Strides vs, Strides os, float scale,
           cudaStream_t stream) {
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode_operand(&tq, q, B, H, T, D, qs.b, qs.h, qs.t, is_f16<E>) ||
      !encode_operand(&tk, k, B, H, T, D, ks.b, ks.h, ks.t, is_f16<E>) ||
      !encode_operand(&tv, v, B, H, T, D, vs.b, vs.h, vs.t, is_f16<E>))
    return (int)cudaErrorInvalidValue;
  auto kernel = attention_kernel<D, NORMALIZED, E>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Shape<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, Shape<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<const int*>(lengths), static_cast<E*>(out), os.b, os.h, os.t, T,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace attn_tma
