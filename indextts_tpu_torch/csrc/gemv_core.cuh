// The arithmetic of the weight-only int8 / int4 GEMV, shared by the
// standalone kernel (int8_gemv.cu: K7a, K7b, the int4 GEMVs, the chains of
// K1 and K6) and the persistent decode step (decode_step.cu: K1, and K6
// with both tp shards on one card). Each
// piece below is one step of int8_gemv.cu's design (its header says why):
// staging x (and the LayerNorm prologue), a 16-row tile's tensor-core
// products into the warps' partial sums, the fixed-order sums of the warps
// and of a cluster's ranks, and the epilogue. Both kernels call the same
// functions, so an output's f32 sum order depends on K and the split alone
// and the two give the same bits. Every product that meets an add is
// written with rounding intrinsics (__fmul_rn, __fmaf_rn, ...): the
// compiler may fuse a plain a * b + c into an FMA in one kernel and not in
// the other, which moves the last bit.
//
// The persistent step takes its activations, biases and LayerNorm vectors
// at a 16-bit type E (bf16, or fp16 for IndexTTS2(use_fp16=True)) and
// computes on bf16 as the TPU kernel does: x's rows are rounded to bf16 as
// they are staged (`stage_x`'s XT), the bias and LayerNorm vectors are read
// exactly into f32 (`bf` of either type), and everything between stays
// bf16 with f32 sums. The standalone kernel takes bf16 throughout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tma.cuh"  // mbarrier and cluster helpers (sm_90)

namespace gemv {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAXM = 24;        // rows a launch takes (B*K of the decode)
constexpr int CB = 64;          // weight bytes of a chunk row
constexpr int SMEM_MAX = 227 * 1024;

// EPI_TP: K6's exchange folded into the row-parallel product (decode_step.cu
// with TP): tp_allreduce.cu's arithmetic on the summed pair, a product and a
// sum each rounded to f32 (no FMA), then the bf16 residual add
enum Epilogue { EPI_NONE = 0, EPI_BIAS = 1, EPI_GELU = 2, EPI_RESIDUAL = 3, EPI_TP = 4 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf(const bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float bf(const __half v) { return __half2float(v); }
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 16 bytes from device memory through L2 only: activations that another
// block of a persistent launch wrote since this SM last read the address
__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldcg(reinterpret_cast<const uint4*>(p));
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
    if (sq) d[j] = __fmul_rn(d[j], d[j]);  // never fused into the sum's adds
  }
  return ((d[0] + d[1]) + (d[2] + d[3])) + ((d[4] + d[5]) + (d[6] + d[7]));
}

// 16 bytes from a row in device memory (through L2) or in shared memory
template <bool GLOBAL>
__device__ __forceinline__ uint4 row16(const bf16* p) {
  return GLOBAL ? load16(p) : *reinterpret_cast<const uint4*>(p);
}

// Mean and 1 / std of a row of K bf16 values (K % 8 == 0) by one warp, two
// passes over the lane's values, summed as trees: up to 2048 columns (a
// lane's 8 loads of 16 bytes) from registers, beyond from a second read.
// GLOBAL: the row is in device memory, else in shared memory.
template <bool GLOBAL>
__device__ __forceinline__ void row_stats(const bf16* row, int K, int lane, float& mean,
                                          float& rstd) {
  uint4 v[8];
  float s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = 256 * i + 8 * lane;
    v[i] = k < K ? row16<GLOBAL>(row + k) : make_uint4(0, 0, 0, 0);
    s[i] = sum8(v[i], 0.f, false);
  }
  float sum = ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
  for (int k = 2048 + 8 * lane; k < K; k += 256) sum += sum8(row16<GLOBAL>(row + k), 0.f, false);
  mean = warp_sum(sum) / K;
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = 256 * i + 8 * lane < K ? sum8(v[i], mean, true) : 0.f;
  float var = ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
  for (int k = 2048 + 8 * lane; k < K; k += 256) var += sum8(row16<GLOBAL>(row + k), mean, true);
  rstd = rsqrtf(warp_sum(var) / K + 1e-5f);
}

// Where x's rows (and the LayerNorm vectors and statistics) sit in shared
// memory: row m at xs + m * sx (sx bytes, 16 past a multiple of 128, so rows
// g and g + 1 fall on other banks).
struct XStage {
  unsigned char* xs;
  int sx;
  bf16* lnw;   // the span of the LayerNorm weight, then of its bias (16-bit
  bf16* lnb;   // values of the type `layer_norm_staged` is given)
  float* mu;   // MAXM means, then MAXM 1 / std
  float* rstd;
};

__host__ __device__ inline int x_stride(int span) { return (span * 2 + 127) / 128 * 128 + 16; }

// The LayerNorm of x's M staged rows over [kb, kb + ks), in place:
// statistics one warp a row from shared memory when the block spans K
// (else `stage_x` took them from device memory), then y = (x - mean) / std
// * w + b in bf16 against the staged vectors, which hold E (each read
// exactly into f32). Ends with the block synchronised.
template <typename E = bf16>
__device__ __forceinline__ void layer_norm_staged(int M, int K, int ks, const XStage& s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int v8 = ks / 8;
  if (ks == K) {
#pragma unroll 1
    for (int m = warp; m < M; m += WARPS) {
      float mean, inv;
      row_stats<false>(reinterpret_cast<const bf16*>(s.xs + m * s.sx), K, lane, mean, inv);
      if (lane == 0) s.mu[m] = mean, s.rstd[m] = inv;
    }
    __syncthreads();
  }
#pragma unroll 1
  for (int u = threadIdx.x; u < M * v8; u += THREADS) {
    const int m = u / v8, k = 8 * (u % v8);
    uint4* xv = reinterpret_cast<uint4*>(s.xs + m * s.sx + 2 * k);
    const uint4 xr = *xv, wr = *reinterpret_cast<const uint4*>(s.lnw + k),
                br = *reinterpret_cast<const uint4*>(s.lnb + k);
    const bf16* xe = reinterpret_cast<const bf16*>(&xr);
    const E *we = reinterpret_cast<const E*>(&wr), *be = reinterpret_cast<const E*>(&br);
    __align__(16) bf16 y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = __fmul_rn(__fsub_rn(bf(xe[i]), s.mu[m]), s.rstd[m]);
      y[i] = __float2bfloat16(__fmaf_rn(v, bf(we[i]), bf(be[i])));
    }
    *xv = *reinterpret_cast<const uint4*>(y);
  }
  __syncthreads();
}

// x's M rows over columns [kb, kb + ks) of K (and the LayerNorm vectors) into
// shared memory in natural order, a thread's loads (up to 4 of 16 bytes)
// issued together; with LN the LayerNorm runs in place (statistics one warp
// a row, from device memory when the block does not span K, else from
// shared memory), then y = (x - mean) / std * w + b in bf16. x's elements
// are XT, rounded to bf16 as they are staged (the persistent step's layer 0
// at fp16, without LN). Ends with the block synchronised.
template <bool LN, typename XT = bf16>
__device__ __forceinline__ void stage_x(const XT* x, const bf16* ln_w, const bf16* ln_b,
                                        int M, int K, int kb, int ks, const XStage& s) {
  static_assert(!LN || std::is_same<XT, bf16>::value, "the LayerNorm prologue reads bf16 x");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool whole = ks == K;
  if constexpr (LN) {
    if (!whole)  // statistics of the whole row from device memory
#pragma unroll 1
      for (int m = warp; m < M; m += WARPS) {
        float mean, inv;
        row_stats<true>(x + (size_t)m * K, K, lane, mean, inv);
        if (lane == 0) s.mu[m] = mean, s.rstd[m] = inv;
      }
  }
  const int v8 = ks / 8, units = (M + (LN ? 2 : 0)) * v8;
  const float inv_v8 = 1.f / v8;  // u / v8 exactly for u < 2^20 (rounded up by 0.5)
#pragma unroll 1
  for (int u0 = 0; u0 < units; u0 += 4 * THREADS) {
    uint4 v[4];
    unsigned char* dst[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = u0 + i * THREADS + threadIdx.x;
      const int m = (int)((u + 0.5f) * inv_v8), k = 8 * (u - m * v8);
      dst[i] = m < M ? s.xs + m * s.sx + 2 * k
                     : reinterpret_cast<unsigned char*>(m == M ? s.lnw : s.lnb) + 2 * k;
      if (u < units) {
        v[i] = m < M ? load16(x + (size_t)m * K + kb + k)
                     : load16((m == M ? ln_w : ln_b) + kb + k);
        if (m < M) v[i] = attn_tma::to_bf16x8<XT>(v[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (u0 + i * THREADS + (int)threadIdx.x < units) *reinterpret_cast<uint4*>(dst[i]) = v[i];
  }
  __syncthreads();  // x staged (and any mbarrier initialised before anyone waits on it)
  if (LN) layer_norm_staged(M, K, ks, s);
}

// The products of one 16-row weight tile in shared memory (row g at wt + g *
// sw) against x's staged rows over this split's columns [kb, kb + ks): warp
// w takes chunks w, w + 8, ... in order. A lane reads 16 bytes of its weight
// rows g and g + 8 a chunk: 4 words, each 4 k-steps of ... int8: k-step j =
// word j, its bytes (0, 2) at slots (0, 1) and (1, 3) at slots (2, 3),
// against x columns 4j + (0, 2) and 4j + (1, 3) of the lane's 16; int4:
// word w = k-steps 2w, 2w + 1, lo nibbles of bytes (0, 2), hi (0, 2), then lo
// (1, 3), hi (1, 3), against the lane's lo-nibble columns 4w + (0, 2) and
// hi-nibble columns 4w + (0, 2), then + (1, 3). The warp's sums (its even and
// odd k-step sets added) go to red_w[(n * 32 + lane) * 4 ...] for n-tile n.
// ``warp`` (-1: this warp) takes another warp's chunks: the sums depend on
// the chunks alone, so a block may spread two short slabs' heavy warps.
template <bool W4, int NT>
__device__ __forceinline__ void tile_products(const unsigned char* wt, int sw, const XStage& s,
                                              int M, int kb, int ks, int half, float* red_w,
                                              int warp = -1) {
  if (warp < 0) warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rb = W4 ? ks / 2 : ks;  // this split's bytes of a row
  const int nch = (rb + CB - 1) / CB;
  float acc[2][NT][4] = {};         // even and odd k-steps
  // int4: the nibble group of the lane's packed bytes and their offset in
  // it, stepped along with the chunk
  int grp = 0, off = 0;
  if (W4) {
    const int pb = kb / 2 + warp * CB + 16 * t;
    grp = pb / half, off = pb % half;
  }
#pragma unroll 2
  for (int c = warp; c < nch; c += WARPS) {
    // the lane's x columns in the span: int8 16 from xlo; int4 16
    // lo-nibble columns from xlo, 16 hi-nibble from xlo + h
    int xlo;
    bool valid;
    if (W4) {
      valid = 2 * (c * CB + 16 * t) < ks;
      xlo = grp * 2 * half + off - kb;
      for (off += WARPS * CB; off >= half; off -= half) ++grp;
    } else {
      xlo = c * CB + 16 * t;
      valid = xlo < ks;
    }
    const int xhi = W4 ? xlo + half : xlo + 8;
    uint32_t X[NT][8];  // per n-tile: the lane's x words (int8: 16 columns;
    uint32_t Y[NT][8];  // int4: 16 lo-nibble columns in X, 16 hi in Y)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int m = 8 * n + g;
      uint4 v[4] = {};
      if (valid && m < M) {
        const unsigned char* row = s.xs + m * s.sx;
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
    const unsigned char* wg = wt + g * sw + c * CB + 16 * t;
    const uint4 w0 = *reinterpret_cast<const uint4*>(wg);
    const uint4 w1 = *reinterpret_cast<const uint4*>(wg + 8 * sw);
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
    *reinterpret_cast<float4*>(red_w + (n * 32 + lane) * 4) =
        make_float4(acc[0][n][0] + acc[1][n][0], acc[0][n][1] + acc[1][n][1],
                    acc[0][n][2] + acc[1][n][2], acc[0][n][3] + acc[1][n][3]);
}

// The block's sums: red[e] = warp 0's + warp 1's + ... + warp 7's, in turn
// (per floats a warp). The same order as `epilogue` takes when unsplit.
__device__ __forceinline__ void sum_warps(float* red, int per) {
#pragma unroll 1
  for (int e = threadIdx.x; e < per; e += THREADS) {
    float v = red[e];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += red[w * per + e];
    red[e] = v;
  }
}

// Rank 0 of a split: red[e] += rank 1's, ..., rank split-1's block sums, in
// turn, from their slots (rank s at slots + (s - 1) * per).
__device__ __forceinline__ void sum_peers(float* red, const float* slots, int per, int split) {
#pragma unroll 1
  for (int e = threadIdx.x; e < per; e += THREADS) {
    float v = red[e];
    for (int s = 1; s < split; ++s) v += slots[(s - 1) * per + e];
    red[e] = v;
  }
}

// The peers' block sums (per floats) into their slots in rank 0's shared
// memory, 16 bytes a store, counted on rank 0's mbarrier at rank0_bar.
__device__ __forceinline__ void send_to_rank0(const float* red, const float* slots, int per,
                                              int rank, const void* rank0_bar) {
  const uint32_t dst = attn_tma::rank0_addr(slots + (rank - 1) * per);
  const uint32_t bar = attn_tma::rank0_addr(rank0_bar);
#pragma unroll 1
  for (int e = 4 * threadIdx.x; e < per; e += 4 * THREADS)
    attn_tma::store_to_rank0(dst + 4 * e, *reinterpret_cast<const float4*>(red + e), bar);
}

// The sum of a tp pair's row-parallel tile (decode_step.cu with TP), whose
// 2q parts are the block's own sums (red) and q ... 2q - 1 more at slots +
// (s - 1) * per, [0, q) shard 0's spans of K and [q, 2q) shard 1's: each
// shard's sum in sum_peers' order, as the chain's two partial products take
// it, then lo + hi, as tp_allreduce.cu adds them. (sum_peers' one
// sequential order over the 2q parts differs in the last bit.) With q = 1
// and slots = red + per it adds the two halves of red.
__device__ __forceinline__ void sum_shards(float* red, const float* slots, int per, int q) {
#pragma unroll 1
  for (int e = threadIdx.x; e < per; e += THREADS) {
    float lo = red[e];
    for (int s = 1; s < q; ++s) lo = __fadd_rn(lo, slots[(s - 1) * per + e]);
    float hi = slots[(q - 1) * per + e];
    for (int s = q + 1; s < 2 * q; ++s) hi = __fadd_rn(hi, slots[(s - 1) * per + e]);
    red[e] = __fadd_rn(lo, hi);
  }
}

// The outputs of a block: M rows x `tiles` 16-row tiles, tile r at output
// rows n0 + 16 r tstride (tstride 1: contiguous tiles). Output e is row m
// of tile r, its row rr: n = n0 + 16 r tstride + rr; false past N.
__device__ __forceinline__ bool out_index(int e, int tiles, int n0, int tstride, int N, int& m,
                                          int& r, int& rr, int& n) {
  const int per_m = tiles * 16, nl = e % per_m;
  m = e / per_m, r = nl / 16, rr = nl % 16;
  n = n0 + 16 * r * tstride + rr;
  return n < N;
}

// The epilogue's operands of a thread's first output (output e = the
// thread's index), read before the products so that their latency hides
// behind the slab's.
struct Pre {
  float scale = 0.f, bias = 0.f, res = 0.f;
};

// TP: the kernel takes EPI_TP (decode_step.cu's TP variant; the others
// compile without it). E: the bias's type (read exactly into f32).
template <bool TP = false, typename E = bf16>
__device__ __forceinline__ Pre pre_read(const float* scale, const E* bias, const bf16* res,
                                        int epi, int M, int N, int n0, int tiles, int tstride) {
  Pre p;
  int m, r, rr, n;
  if (epi != EPI_NONE && (int)threadIdx.x < M * tiles * 16 &&
      out_index(threadIdx.x, tiles, n0, tstride, N, m, r, rr, n)) {
    p.scale = scale[n];
    p.bias = bf(bias[n]);
    if (epi == EPI_RESIDUAL || (TP && epi == EPI_TP)) p.res = bf(__ldcg(res + (size_t)m * N + n));
  }
  return p;
}

// The block's outputs (`out_index`), from the accumulator layout: thread
// (g, t) of an n-tile held rows g, g + 8 of the 16-row tile and decode rows
// 2t, 2t + 1. ``whole`` (the block spans K): the warps' sums are added
// here, in turn; else red holds the summed split already. Epilogue: none
// (f32 out), or acc * scale + bias in f32 rounded to bf16, then gelu_new on
// that in f32 rounded again, or a bf16 residual add (EPI_TP, with TP: the
// product and the sum rounded apart, as tp_allreduce.cu). The bias is E,
// read exactly into f32.
template <int NT, bool TP = false, typename E = bf16>
__device__ __forceinline__ void epilogue(const float* red, int per, bool whole, int M, int N,
                                         int n0, int tiles, int tstride, int epi,
                                         const float* scale, const E* bias, const bf16* res,
                                         void* out, const Pre& pre) {
#pragma unroll 1
  for (int e = threadIdx.x; e < M * tiles * 16; e += THREADS) {
    int m, r, rr, n;
    if (!out_index(e, tiles, n0, tstride, N, m, r, rr, n)) continue;
    const int nt = m / 8, mm = m % 8;
    const int idx = ((r * NT + nt) * 32 + 4 * (rr % 8) + mm / 2) * 4 + 2 * (rr / 8) + mm % 2;
    float acc_v = red[idx];
    if (whole)  // the warps' sums in turn, here
#pragma unroll
      for (int w = 1; w < WARPS; ++w) acc_v += red[w * per + idx];
    const size_t o = (size_t)m * N + n;
    if (epi == EPI_NONE) {
      static_cast<float*>(out)[o] = acc_v;
      continue;
    }
    const bool first = e == (int)threadIdx.x;
    if (TP && epi == EPI_TP) {
      const float v = round_bf(__fadd_rn(__fmul_rn(acc_v, first ? pre.scale : scale[n]),
                                         first ? pre.bias : bf(bias[n])));
      static_cast<bf16*>(out)[o] =
          __float2bfloat16(__fadd_rn(first ? pre.res : bf(__ldcg(res + o)), v));
      continue;
    }
    float v = round_bf(__fmaf_rn(acc_v, first ? pre.scale : scale[n],
                                 first ? pre.bias : bf(bias[n])));
    if (epi == EPI_GELU) {
      const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, v), v), v);
      const float t = tanhf(__fmul_rn(0.7978845608028654f, __fadd_rn(v, cube)));
      v = __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.f, t));
    } else if (epi == EPI_RESIDUAL) {
      v = (first ? pre.res : bf(__ldcg(res + o))) + v;
    }
    static_cast<bf16*>(out)[o] = __float2bfloat16(v);
  }
}

}  // namespace gemv
