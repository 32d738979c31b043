// K7a / K7b and the four projections of K1: weight-only int8 or int4
// matrix-vector product for a handful of rows, y = x @ q^T, with an optional
// LayerNorm prologue and an optional scale / bias / gelu_new / residual
// epilogue.
//
// Replaces the TPU kernels indextts_tpu/ops/pallas/int8_matmul.py::
// int8_matvec (K7a) and ::int8_mlp (K7b, two launches of this kernel: fc with
// the gelu epilogue, then proj), and the weight streaming of the dense
// layers inside indextts_tpu/ops/pallas/decode_step.py::fused_decode_step
// (decode_step.py:460), int8 and its W4 variant (int4 weights, `consume_w`
// and `unpack4` there). Same math as the TPU kernels:
//   - prologue (optional): LayerNorm of each of the M input rows in f32
//     (two-pass mean and variance, eps 1e-5), times w plus b, rounded to bf16;
//   - int8 (or int4) -> bf16 is exact, a bf16 x bf16 product is exact in f32,
//     and the products are summed in f32 (only the order of the sum differs);
//   - epilogue: none (f32 out, K7a), or acc * scale + bias in f32 rounded to
//     bf16, then either gelu_new on that bf16 value in f32 rounded again, or
//     a bf16 residual add x + bf16(...).
//
// W4 (half_span h > 0): the weight is (N, K/2) int8, two values a byte along
// the contraction axis (nn.quantize_dense_int4): in each group of 2h input
// columns, the lo nibble of packed byte j holds column j and its hi nibble
// column h + j (h = 320 at the shipped widths, or one group spanning the row).
//
// What bounds it on the H100: decode runs M = B*K <= 24 rows (3 on the main
// path), so it does 2*M flops per weight value: it is bound by reading the
// weight once, 4.9 MB int8 (2.5 MB int4) at the qkv shape (3840 x 1280),
// ~1.5 us (~0.7 us) at 3.35 TB/s. Reaching that rate needs ~2.3 MB in flight
// across the card (3.35 TB/s x ~0.7 us of loaded latency): about half the qkv
// weight, so each block has to ask for its whole share of the weight at once.
// The design, with the launch plan (`ops/int8.py::gemv_plan`: 16-row tiles a
// block, split, span, shared-memory bytes) passed in:
//   1. The weight at entry. A block owns one tile of 16 output rows (up to 4
//      where one would make more blocks than two an SM) x one split's span of
//      K (<= 1280 columns: <= 20 KB a tile). Before any other work, one thread
//      issues TMA bulk copies (cp.async.bulk global -> shared) of the block's
//      whole slab, each tile completing on its own mbarrier: one copy a tile
//      when the block spans K (the tile's rows are contiguous), one a row
//      otherwise. So the card's in-flight need is met from the first cycle,
//      and the block computes tile r while tile r + 1 lands. Meanwhile the
//      threads stage x's M rows over the span (and the LayerNorm vectors) in
//      shared memory, each issuing its 16-byte loads together; the LayerNorm
//      runs in place (statistics one warp a row, from device memory only when
//      K is split). x over a span is <= 61 KB (M = 24), never staged in K
//      tiles. (Staging x by TMA as well was slower: every block of the grid
//      asks for the same few KB at once.)
//   2. Tensor cores for the products: mma.sync m16n8k16 bf16 with f32
//      accumulators; A = 16 weight rows x 16 columns dequantised to bf16 in
//      registers, two values an instruction pair: bytes (0, 2) or (1, 3) of a
//      word masked into bf16 0x4300 | (b & 0x7f) = 128 + (b & 0x7f) and 0x4300
//      | (b & 0x80) = 128 or 256, one bf16x2 fma taking the difference;
//      nibbles (0, 4), (1, 5), ... of the biased word masked into 0x4300 (136
//      + v), one fma subtracting 136. B = x^T, the M rows padded to 8, 16 or
//      24 (1-3 n-tiles; padded rows are zero registers). The sum over K may
//      take any order, so the MMA's k index runs over a permutation of the
//      columns: a lane reads 16 weight bytes of each of its rows g and g + 8
//      with one shared load (a 64-byte chunk a row: 64 int8 columns, 4
//      k-steps, or 128 int4 columns, 8 k-steps), and its B fragments are x's
//      matching columns, read in natural order and paired by one __byte_perm
//      each (for int4 the lo-nibble columns j and hi-nibble columns h + j of a
//      group). x's rows sit 16 bytes past a multiple of 128 in shared memory,
//      so a phase's loads hit distinct banks. Each warp keeps two accumulator
//      sets (even and odd k-steps), halving its chain of dependent MMAs.
//   3. Split-K in a fixed order, in one launch: a block owns at most 1280
//      columns of K (int4: whole nibble groups), so K = 5120 (mlp-proj)
//      runs in clusters of 4 blocks and K6's K = 2560 in clusters of 2. Each
//      block sums its 8 warps' accumulators in warp order; each peer then
//      writes its sums into its own slot in rank 0's shared memory
//      (distributed shared memory, st.async, counted on rank 0's mbarrier);
//      rank 0 adds ranks 1..s-1 in turn and runs the epilogue. No scratch in
//      device memory, no atomics, no second launch, no memory fence, and one
//      cluster barrier (arrived at entry, waited on before the writes) so
//      that rank 0's mbarrier is initialised before any peer writes.
// A warp takes the chunks w, w + 8, ... of its span in order, and the split
// follows from K alone, so the f32 sum order of an output depends on K only,
// never on N or the row's place in its tile: the same bits from run to run,
// and K6's qkv shard (N = 1920) equals the unsharded qkv (N = 3840) column
// for column.
// Measured on the H100 (PERF.md): at the qkv shape about 3x the byte
// bound, on par with cuBLAS's bf16 GEMV; what remains is the launch, the
// slab's wait, x's staging and the epilogue, and a dequantise loop bound by
// instruction issue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tma.cuh"  // mbarrier and cluster helpers (sm_90)

namespace {

using bf16 = __nv_bfloat16;
using attn_tma::cluster_arrive;
using attn_tma::cluster_wait;
using attn_tma::mbar_expect_tx;
using attn_tma::mbar_init;
using attn_tma::mbar_wait;
using attn_tma::rank0_addr;
using attn_tma::smem_addr;
using attn_tma::store_to_rank0;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAXM = 24;        // rows a launch takes (B*K of the decode)
constexpr int MAXRT = 4;        // 16-row tiles a block
constexpr int MAXSPLIT = 8;     // blocks of a cluster
constexpr int CB = 64;          // weight bytes of a chunk row
constexpr int SMEM_MAX = 227 * 1024;

enum Epilogue { EPI_NONE = 0, EPI_BIAS = 1, EPI_GELU = 2, EPI_RESIDUAL = 3 };

struct Plan {
  int rows, split, span;  // as ops/int8.py::gemv_plan
  int sw, sx;             // shared row strides (weights, x)
  int nt;                 // n-tiles
  int x_off, ln_off, red_off, bar_off, stat_off, smem;
};

// The shared-memory layout; the same formula as ops/int8.py::_gemv_smem:
// the weight slab (+ one chunk of overrun), x's M rows of a span (16 bytes
// past a multiple of 128, so rows g and g + 1 fall on other banks), the
// LayerNorm vectors of the span, the warps' partial sums and the cluster
// peers' (rank 0's slots), the mbarriers (one a tile, one for the peers)
// and the row statistics.
__host__ __device__ inline void layout(Plan& p, int M, int K, bool w4) {
  const int span_bytes = w4 ? p.span / 2 : p.span;
  p.sw = p.split == 1 ? (w4 ? K / 2 : K) : span_bytes;  // one copy a tile, or a row
  p.sx = (p.span * 2 + 127) / 128 * 128 + 16;
  p.nt = (M + 7) / 8;
  p.x_off = (16 * p.rows * p.sw + CB + 15) / 16 * 16;
  p.ln_off = p.x_off + M * p.sx;
  p.red_off = p.ln_off + 2 * p.span * 2;
  p.bar_off = p.red_off + (WARPS + p.split - 1) * p.rows * p.nt * 32 * 4 * 4;
  p.stat_off = p.bar_off + 48;
  p.smem = p.stat_off + 2 * MAXM * 4;
}

struct Args {
  const bf16* x;
  const int8_t* q;
  const bf16* ln_w;
  const bf16* ln_b;
  const float* scale;
  const bf16* bias;
  const bf16* res;
  void* out;
  int M, N, K, half, epi;
  Plan p;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf(const bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// a - b on bf16 pairs (one fma: b * -1 + a), exact for the integers here
__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(b), "r"(0xBF80BF80u), "r"(a));
  return d;
}

// Signed bytes 0 and 2 of w -> a bf16 pair, exact: bf16 0x4300 | (b & 0x7f)
// is 128 + (b & 0x7f), and 0x4300 | (b & 0x80) is 128, or 256 for a
// negative b; their difference is b.
__device__ __forceinline__ uint32_t s8x2_to_bf16(uint32_t w) {
  return bf2_sub((w & 0x007F007Fu) | 0x43004300u, (w & 0x00800080u) | 0x43004300u);
}

// Signed nibbles 0 and 4 of u ^ 0x88888888 -> a bf16 pair, exact: bf16
// 0x4300 | (v + 8) is 136 + v.
__device__ __forceinline__ uint32_t s4x2_to_bf16(uint32_t u) {
  return bf2_sub((u & 0x000F000Fu) | 0x43004300u, 0x43084308u);
}

// __byte_perm selectors: the low halves of two words, their high halves
constexpr uint32_t LO_HALVES = 0x5410, HI_HALVES = 0x7632;

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float sum8(const uint4& v, float mean, bool sq) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
  float d[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    d[j] = bf(e[j]) - mean;
    if (sq) d[j] *= d[j];
  }
  return ((d[0] + d[1]) + (d[2] + d[3])) + ((d[4] + d[5]) + (d[6] + d[7]));
}

// Mean and 1 / std of a row of K bf16 values (K % 8 == 0) by one warp, two
// passes over the lane's values, summed as trees: up to 2048 columns (a
// lane's 8 loads of 16 bytes) from registers, beyond from a second read.
__device__ __forceinline__ void row_stats(const bf16* row, int K, int lane, float& mean,
                                          float& rstd) {
  uint4 v[8];
  float s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = 256 * i + 8 * lane;
    v[i] = k < K ? *reinterpret_cast<const uint4*>(row + k) : make_uint4(0, 0, 0, 0);
    s[i] = sum8(v[i], 0.f, false);
  }
  float sum = ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
  for (int k = 2048 + 8 * lane; k < K; k += 256)
    sum += sum8(*reinterpret_cast<const uint4*>(row + k), 0.f, false);
  mean = warp_sum(sum) / K;
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = 256 * i + 8 * lane < K ? sum8(v[i], mean, true) : 0.f;
  float var = ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
  for (int k = 2048 + 8 * lane; k < K; k += 256)
    var += sum8(*reinterpret_cast<const uint4*>(row + k), mean, true);
  rstd = rsqrtf(warp_sum(var) / K + 1e-5f);
}

template <bool LN, bool W4, int NT>
__global__ void __launch_bounds__(THREADS, 2)
int8_gemv_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& p = a.p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rank = blockIdx.x % p.split;
  const int n0 = (blockIdx.x / p.split) * 16 * p.rows;
  const int kb = rank * p.span, ks = min(p.span, a.K - kb);  // this split's columns
  const int rb = W4 ? ks / 2 : ks;                              // its bytes of a row
  bf16* lnw = reinterpret_cast<bf16*>(smem + p.ln_off);
  bf16* lnb = lnw + p.span;
  float* mu = reinterpret_cast<float*>(smem + p.stat_off);
  float* rstd = mu + MAXM;
  const uint32_t wbar = smem_addr(smem + p.bar_off), rbar = wbar + 8 * MAXRT;
  const int rows = min(16 * p.rows, a.N - n0), tiles = (rows + 15) / 16;

  // the epilogue's operands of this thread's first output, read at entry so
  // that their latency hides behind the slab's
  float pre_scale = 0.f, pre_bias = 0.f, pre_res = 0.f;
  if (a.epi != EPI_NONE && rank == 0 && threadIdx.x < a.M * rows) {
    const int n = n0 + threadIdx.x % rows;
    pre_scale = a.scale[n];
    pre_bias = bf(a.bias[n]);
    if (a.epi == EPI_RESIDUAL) pre_res = bf(a.res[(size_t)(threadIdx.x / rows) * a.N + n]);
  }

  // 1. the whole weight slab, requested before anything else, a tile (16
  // rows) an mbarrier
  if (warp == 0) {
    const int row_stride = W4 ? a.K / 2 : a.K;
    const int8_t* src = a.q + (size_t)n0 * row_stride + (W4 ? kb / 2 : kb);
    if (lane == 0) {
      for (int r = 0; r < tiles; ++r) mbar_init(wbar + 8 * r, 1);
      if (p.split > 1 && rank == 0) mbar_init(rbar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      if (p.split > 1 && rank == 0)  // the peers' sums, 4 bytes a float
        mbar_expect_tx(rbar, (p.split - 1) * p.rows * NT * 32 * 4 * 4);
      for (int r = 0; r < tiles; ++r) {
        const int n = min(16, rows - 16 * r);
        mbar_expect_tx(wbar + 8 * r, n * rb);
        if (p.split == 1)  // the tile's rows are contiguous
          bulk_copy(smem_addr(smem + 16 * r * p.sw), src + (size_t)16 * r * row_stride, n * rb,
                    wbar + 8 * r);
      }
    }
    __syncwarp();
    if (p.split > 1)
      for (int r = lane; r < rows; r += 32)
        bulk_copy(smem_addr(smem + r * p.sw), src + (size_t)r * row_stride, rb,
                  wbar + 8 * (r / 16));
  }
  if (p.split > 1) cluster_arrive();  // rank 0's barrier for the peers initialised

  // x's M rows over the span (and the LayerNorm vectors) into shared memory
  // in natural order while the slab streams in: a thread's loads, up to 4
  // of 16 bytes, issued together
  if (LN && p.split > 1)  // statistics of the whole row from device memory
    for (int m = warp; m < a.M; m += WARPS) {
      float mean, inv;
      row_stats(a.x + (size_t)m * a.K, a.K, lane, mean, inv);
      if (lane == 0) mu[m] = mean, rstd[m] = inv;
    }
  const int v8 = ks / 8, units = (a.M + (LN ? 2 : 0)) * v8;
  const float inv_v8 = 1.f / v8;  // u / v8 exactly for u < 2^20 (rounded up by 0.5)
  for (int u0 = 0; u0 < units; u0 += 4 * THREADS) {
    uint4 v[4];
    unsigned char* dst[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = u0 + i * THREADS + threadIdx.x;
      const int m = (int)((u + 0.5f) * inv_v8), k = 8 * (u - m * v8);
      dst[i] = m < a.M ? smem + p.x_off + m * p.sx + 2 * k
                       : reinterpret_cast<unsigned char*>(m == a.M ? lnw : lnb) + 2 * k;
      if (u < units)
        v[i] = *reinterpret_cast<const uint4*>(
            m < a.M ? a.x + (size_t)m * a.K + kb + k : (m == a.M ? a.ln_w : a.ln_b) + kb + k);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (u0 + i * THREADS + (int)threadIdx.x < units) *reinterpret_cast<uint4*>(dst[i]) = v[i];
  }
  __syncthreads();  // x staged; the mbarrier initialised before anyone waits on it

  // the LayerNorm, in place: statistics one warp a row (from shared memory
  // when the block spans K), then y = (x - mean) / std * w + b in bf16
  if (LN) {
    if (p.split == 1) {
      for (int m = warp; m < a.M; m += WARPS) {
        float mean, inv;
        row_stats(reinterpret_cast<const bf16*>(smem + p.x_off + m * p.sx), a.K, lane, mean,
                  inv);
        if (lane == 0) mu[m] = mean, rstd[m] = inv;
      }
      __syncthreads();
    }
    for (int u = threadIdx.x; u < a.M * v8; u += THREADS) {
      const int m = u / v8, k = 8 * (u % v8);
      uint4* xv = reinterpret_cast<uint4*>(smem + p.x_off + m * p.sx + 2 * k);
      const uint4 xr = *xv, wr = *reinterpret_cast<const uint4*>(lnw + k),
                  br = *reinterpret_cast<const uint4*>(lnb + k);
      const bf16 *xe = reinterpret_cast<const bf16*>(&xr),
                 *we = reinterpret_cast<const bf16*>(&wr),
                 *be = reinterpret_cast<const bf16*>(&br);
      __align__(16) bf16 y[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = (bf(xe[i]) - mu[m]) * rstd[m];
        y[i] = __float2bfloat16(v * bf(we[i]) + bf(be[i]));
      }
      *xv = *reinterpret_cast<const uint4*>(y);
    }
    __syncthreads();
  }

  // 2. products: warp w takes chunks w, w + 8, ... in order. A lane reads
  // 16 bytes of its weight rows g and g + 8 a chunk: 4 words, each 4 k-steps
  // of ... int8: k-step j = word j, its bytes (0, 2) at slots (0, 1) and
  // (1, 3) at slots (2, 3), against x columns 4j + (0, 2) and 4j + (1, 3)
  // of the lane's 16; int4: word w = k-steps 2w, 2w + 1, lo nibbles of
  // bytes (0, 2), hi (0, 2), then lo (1, 3), hi (1, 3), against the lane's
  // lo-nibble columns 4w + (0, 2) and hi-nibble columns 4w + (0, 2), then
  // + (1, 3).
  float* red = reinterpret_cast<float*>(smem + p.red_off);
  const int per = p.rows * NT * 32 * 4;  // floats of a warp's partial sums
  const int nch = (rb + CB - 1) / CB;      // this split's chunks
  for (int r = 0; r < tiles; ++r) {        // a tile's products while the next lands
    mbar_wait(wbar + 8 * r, 0);
    float acc[2][NT][4] = {};           // even and odd k-steps
    // int4: the nibble group of the lane's packed bytes and their offset in
    // it, stepped along with the chunk
    int grp = 0, off = 0;
    if (W4) {
      const int pb = kb / 2 + warp * CB + 16 * t;
      grp = pb / a.half, off = pb % a.half;
    }
#pragma unroll 2
    for (int c = warp; c < nch; c += WARPS) {
      // the lane's x columns in the span: int8 16 from xlo; int4 16
      // lo-nibble columns from xlo, 16 hi-nibble from xlo + h
      int xlo;
      bool valid;
      if (W4) {
        valid = 2 * (c * CB + 16 * t) < ks;
        xlo = grp * 2 * a.half + off - kb;
        for (off += WARPS * CB; off >= a.half; off -= a.half) ++grp;
      } else {
        xlo = c * CB + 16 * t;
        valid = xlo < ks;
      }
      const int xhi = W4 ? xlo + a.half : xlo + 8;
      uint32_t X[NT][8];  // per n-tile: the lane's x words (int8: 16 columns;
      uint32_t Y[NT][8];  // int4: 16 lo-nibble columns in X, 16 hi in Y)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int m = 8 * n + g;
        uint4 v[4] = {};
        if (valid && m < a.M) {
          const unsigned char* row = smem + p.x_off + m * p.sx;
          v[0] = *reinterpret_cast<const uint4*>(row + 2 * xlo);
          if (W4) {
            v[1] = *reinterpret_cast<const uint4*>(row + 2 * xlo + 16);
            v[2] = *reinterpret_cast<const uint4*>(row + 2 * xhi);
            v[3] = *reinterpret_cast<const uint4*>(row + 2 * xhi + 16);
          } else {
            v[1] = *reinterpret_cast<const uint4*>(row + 2 * xhi);
          }
        }
        X[n][0] = v[0].x, X[n][1] = v[0].y, X[n][2] = v[0].z, X[n][3] = v[0].w;
        X[n][4] = v[1].x, X[n][5] = v[1].y, X[n][6] = v[1].z, X[n][7] = v[1].w;
        Y[n][0] = v[2].x, Y[n][1] = v[2].y, Y[n][2] = v[2].z, Y[n][3] = v[2].w;
        Y[n][4] = v[3].x, Y[n][5] = v[3].y, Y[n][6] = v[3].z, Y[n][7] = v[3].w;
      }
      const unsigned char* wg = smem + (16 * r + g) * p.sw + c * CB + 16 * t;
      const uint4 w0 = *reinterpret_cast<const uint4*>(wg);
      const uint4 w1 = *reinterpret_cast<const uint4*>(wg + 8 * p.sw);
      const uint32_t rg[4] = {w0.x, w0.y, w0.z, w0.w}, rh[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (W4) {  // word j: k-steps 2j and 2j + 1
          const uint32_t ug = rg[j] ^ 0x88888888u, uh = rh[j] ^ 0x88888888u;
          const uint32_t g0 = s4x2_to_bf16(ug), g1 = s4x2_to_bf16(ug >> 4),
                         g2 = s4x2_to_bf16(ug >> 8), g3 = s4x2_to_bf16(ug >> 12);
          const uint32_t h0 = s4x2_to_bf16(uh), h1 = s4x2_to_bf16(uh >> 4),
                         h2 = s4x2_to_bf16(uh >> 8), h3 = s4x2_to_bf16(uh >> 12);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const uint32_t lx0 = X[n][2 * j], lx1 = X[n][2 * j + 1];
            const uint32_t hx0 = Y[n][2 * j], hx1 = Y[n][2 * j + 1];
            mma_bf16(acc[0][n], g0, h0, g1, h1, __byte_perm(lx0, lx1, LO_HALVES),
                     __byte_perm(hx0, hx1, LO_HALVES));
            mma_bf16(acc[1][n], g2, h2, g3, h3, __byte_perm(lx0, lx1, HI_HALVES),
                     __byte_perm(hx0, hx1, HI_HALVES));
          }
        } else {  // word j: k-step j
          const uint32_t g0 = s8x2_to_bf16(rg[j]), g1 = s8x2_to_bf16(rg[j] >> 8);
          const uint32_t h0 = s8x2_to_bf16(rh[j]), h1 = s8x2_to_bf16(rh[j] >> 8);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const uint32_t x0 = X[n][2 * j], x1 = X[n][2 * j + 1];
            mma_bf16(acc[j & 1][n], g0, h0, g1, h1, __byte_perm(x0, x1, LO_HALVES),
                     __byte_perm(x0, x1, HI_HALVES));
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float4*>(red + warp * per + ((r * NT + n) * 32 + lane) * 4) =
          make_float4(acc[0][n][0] + acc[1][n][0], acc[0][n][1] + acc[1][n][1],
                      acc[0][n][2] + acc[1][n][2], acc[0][n][3] + acc[1][n][3]);
  }

  // 3. fixed-order sums: the two sets (above), the warps in turn (in the
  // epilogue when K is not split), then the cluster's ranks in turn: each
  // peer writes its block sum into its slot in rank 0's shared memory
  // (st.async, counted on rank 0's mbarrier); rank 0 waits, adds the slots
  // of ranks 1..s-1 in order and runs the epilogue
  __syncthreads();
  if (p.split > 1) {
    for (int e = threadIdx.x; e < per; e += THREADS) {
      float v = red[e];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) v += red[w * per + e];
      red[e] = v;
    }
    float* slots = red + WARPS * per;  // rank s at slots + (s - 1) * per
    __syncthreads();                   // the block sum complete
    cluster_wait();
    if (rank != 0) {
      const uint32_t dst = rank0_addr(slots + (rank - 1) * per);
      const uint32_t bar = rank0_addr(smem + p.bar_off + 8 * MAXRT);
      for (int e = 4 * threadIdx.x; e < per; e += 4 * THREADS)
        store_to_rank0(dst + 4 * e, *reinterpret_cast<const float4*>(red + e), bar);
      return;
    }
    mbar_wait(rbar, 0);
    for (int e = threadIdx.x; e < per; e += THREADS) {
      float v = red[e];
      for (int s = 1; s < p.split; ++s) v += slots[(s - 1) * per + e];
      red[e] = v;
    }
    __syncthreads();
  }

  // 4. epilogue, from the accumulator layout: thread (g, t) of an n-tile
  // held rows g, g + 8 of the 16-row tile and decode rows 2t, 2t + 1
  for (int e = threadIdx.x; e < a.M * rows; e += THREADS) {
    const int m = e / rows, nl = e % rows, n = n0 + nl;
    const int r = nl / 16, rr = nl % 16, nt = m / 8, mm = m % 8;
    const int idx = ((r * NT + nt) * 32 + 4 * (rr % 8) + mm / 2) * 4 + 2 * (rr / 8) + mm % 2;
    float acc_v = red[idx];
    if (p.split == 1)  // the warps' sums in turn, here
#pragma unroll
      for (int w = 1; w < WARPS; ++w) acc_v += red[w * per + idx];
    const size_t o = (size_t)m * a.N + n;
    if (a.epi == EPI_NONE) {
      static_cast<float*>(a.out)[o] = acc_v;
      continue;
    }
    const bool first = e == (int)threadIdx.x;
    float v = round_bf(acc_v * (first ? pre_scale : a.scale[n]) +
                       (first ? pre_bias : bf(a.bias[n])));
    if (a.epi == EPI_GELU) {
      v = 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
    } else if (a.epi == EPI_RESIDUAL) {
      v = (first ? pre_res : bf(a.res[o])) + v;
    }
    static_cast<bf16*>(a.out)[o] = __float2bfloat16(v);
  }
}

// The dynamic shared-memory limit is raised once per device for each
// instantiation, at its first launch outside a graph capture.
template <bool LN, bool W4, int NT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = int8_gemv_kernel<LN, W4, NT>;
  static unsigned raised = 0;  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (a.p.smem > 48 * 1024 && dev < 32 && !(raised >> dev & 1u)) {
    cudaStreamCaptureStatus cap = cudaStreamCaptureStatusNone;
    err = cudaStreamIsCapturing(stream, &cap);
    if (err != cudaSuccess) return err;
    if (cap != cudaStreamCaptureStatusNone) return cudaErrorStreamCaptureUnsupported;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    raised |= 1u << dev;
  }
  const int blocks = (a.N + 16 * a.p.rows - 1) / (16 * a.p.rows);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * a.p.split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = a.p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.p.split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x: (M, K) bf16; q: (N, K) int8 (K % 16 == 0), or with half_span h > 0 the
// int4 weight (N, K/2) int8 in groups of 2h columns (K % 2h == 0, h % 16 ==
// 0); ln_w, ln_b: (K,) bf16 or null (no LayerNorm); scale (N,) f32 and bias
// (N,) bf16 for every epilogue but 0; res: (M, N) bf16 for epilogue 3; out:
// (M, N) f32 for epilogue 0, else bf16. All contiguous, x, q, ln_w and ln_b
// 16-byte aligned. Epilogue: 0 none, 1 scale + bias, 2 scale + bias +
// gelu_new, 3 scale + bias + residual. The launch plan (rows, split, span,
// smem) is ops/int8.py::gemv_plan's; a plan this entry does not
// recompute to the same shared-memory bytes is refused. Returns
// cudaGetLastError() after the launch.
extern "C" int int8_gemv_launch(const void* x, const void* q, const void* ln_w,
                                const void* ln_b, const void* scale,
                                const void* bias, const void* res, void* out,
                                int M, int N, int K, int half_span,
                                int epilogue, int rows, int split, int span, int smem,
                                void* stream) {
  const bool ln = ln_w != nullptr, w4 = half_span > 0;
  const int unit = w4 ? 2 * half_span : CB;  // a split's granularity
  if (M < 1 || M > MAXM || N < 1 || K < 16 || K % 16 != 0 || epilogue < 0 ||
      epilogue > 3 || half_span < 0 ||
      (w4 && (half_span % 16 != 0 || K % (2 * half_span) != 0)) ||
      rows < 1 || rows > MAXRT || split < 1 || split > MAXSPLIT || span < 1 ||
      span % unit != 0 || span * (split - 1) >= K || span * split < K || !aligned16(x) ||
      !aligned16(q) || (ln && (!aligned16(ln_w) || !aligned16(ln_b))))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
         static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
         static_cast<const float*>(scale), static_cast<const bf16*>(bias),
         static_cast<const bf16*>(res), out, M, N, K, half_span, epilogue, {}};
  a.p.rows = rows, a.p.split = split, a.p.span = span;
  layout(a.p, M, K, w4);
  if (a.p.smem != smem || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define INT8_GEMV_NT(L, W)                                                      \
  (a.p.nt == 1 ? launch<L, W, 1>(a, s) : a.p.nt == 2 ? launch<L, W, 2>(a, s) \
                                                    : launch<L, W, 3>(a, s))
  const cudaError_t err = ln ? (w4 ? INT8_GEMV_NT(true, true) : INT8_GEMV_NT(true, false))
                             : (w4 ? INT8_GEMV_NT(false, true) : INT8_GEMV_NT(false, false));
#undef INT8_GEMV_NT
  return (int)err;
}
