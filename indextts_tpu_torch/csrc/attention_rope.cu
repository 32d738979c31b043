// K2: non-causal, length-masked attention with the half-split rope fused in.
//
// Replaces the TPU kernel indextts_tpu/ops/pallas/attn.py::
// packed_pair_attention_rope (the DiT backbone's attention,
// indextts_tpu/models/s2mel/dit.py). Same math:
//   - q and k rows are rotated in f32 (half-split rope: lanes [0, D/2) and
//     [D/2, D) of each head are the two halves) and rounded to bf16;
//   - scores q.k * 1/sqrt(D) in f32; keys >= lengths[b] get -1e9;
//   - softmax in f32 against the row max; the probabilities are rounded to
//     bf16 before the PV product, and the f32 row sum divides at the end.
// Query rows past lengths[b] are computed like any other (they attend the
// valid keys) and are masked by the caller, as on the TPU.
//
// What bounds it on the H100: the DiT calls it at B=2 (the CFG pair), H=8,
// D=64 and T = prompt + mel frames (~1-3.5k), i.e. 4*B*H*T^2*D flops
// (~22 GFLOP at T=2304) over only ~4*B*T*H*D*2 bytes of q/k/v/out: it is
// compute bound, so the (T, T) scores must never reach device memory and
// the two products must run on the tensor cores.
// Design: one block per (64-row query tile, head, batch row); 4 warps, each
// owning 16 query rows. Key/value tiles of 64 rows stream through shared
// memory (roped on load), the products run as bf16 WMMA 16x16x16 with f32
// accumulators, and an online softmax (running max and sum per row, in f32)
// replaces the TPU kernel's whole-row softmax, so any T works: the ragged
// last tile is zero-filled and masked, and key tiles wholly past the row's
// length are skipped. Later work: wgmma + TMA pipelines.
//
// K2' (the ROPE=false instantiation, `packed_attention_launch`) replaces
// indextts_tpu/ops/pallas/attn.py::packed_pair_attention, the same kernel
// without the rope: q and k tiles are loaded as they are, and everything
// else (p rounded to bf16 unnormalized, the divide after PV) is unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int D = 64;          // head dim
constexpr int HALF = D / 2;
constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int NWARPS = BQ / 16;
constexpr int THREADS = NWARPS * 32;
constexpr int LDS = BK + 4;    // f32 score row stride (wmma: multiple of 4)
constexpr int LDP = BK + 8;    // bf16 prob row stride (wmma: multiple of 8)
constexpr int SMEM_BYTES = (BQ * D + 2 * BK * D) * 2 + NWARPS * 16 * LDS * 4
                           + NWARPS * 16 * LDP * 2;

// Rows [t0, t0 + 64) of head h of batch row b into s (64 x D, bf16); rows
// past T are zero. With rope, each element is rotated in f32 first.
__device__ void load_tile(bf16* s, const bf16* __restrict__ src,
                          const float* __restrict__ cosv,
                          const float* __restrict__ sinv, int b, int h, int t0,
                          int T, int HD, bool rope) {
  for (int e = threadIdx.x; e < 64 * D; e += THREADS) {
    const int r = e / D, d = e % D, t = t0 + r;
    float val = 0.f;
    if (t < T) {
      const bf16* row = src + ((size_t)b * T + t) * HD + h * D;
      const float x = __bfloat162float(row[d]);
      if (rope) {
        const int j = d % HALF;
        const float c = cosv[(size_t)t * HALF + j];
        const float sn = sinv[(size_t)t * HALF + j];
        if (d < HALF) {
          const float x2 = __bfloat162float(row[d + HALF]);
          val = __fsub_rn(__fmul_rn(x, c), __fmul_rn(x2, sn));
        } else {
          const float x1 = __bfloat162float(row[d - HALF]);
          val = __fadd_rn(__fmul_rn(x, c), __fmul_rn(x1, sn));
        }
      } else {
        val = x;
      }
    }
    s[r * D + d] = __float2bfloat16(val);
  }
}

template <bool ROPE>
__global__ void __launch_bounds__(THREADS)
attention_rope_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ lengths,
                      const float* __restrict__ cosv,
                      const float* __restrict__ sinv, bf16* __restrict__ out,
                      int T, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * D;
  bf16* sV = sK + BK * D;
  float* sS = reinterpret_cast<float*>(sV + BK * D);
  bf16* sP = reinterpret_cast<bf16*>(sS + NWARPS * 16 * LDS);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = max(1, min(lengths[b], T));
  const int n_kt = (len + BK - 1) / BK;

  float* wS = sS + warp * 16 * LDS;   // this warp's 16 x BK scores / PV out
  bf16* wP = sP + warp * 16 * LDP;    // this warp's 16 x BK probabilities
  const int row = lane % 16;          // a lane owns half of one query row
  const int c0 = (lane / 16) * 32;

  load_tile(sQ, q, cosv, sinv, b, h, q0, T, HD, ROPE);

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // sQ written / previous sK, sV consumed
    load_tile(sK, k, cosv, sinv, b, h, kt * BK, T, HD, ROPE);
    load_tile(sV, v, cosv, sinv, b, h, kt * BK, T, HD, false);
    __syncthreads();

    // scores: (16 x D) x (D x BK)
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + warp * 16 * D + kk * 16, D);
        wmma::load_matrix_sync(fb, sK + n * 16 * D + kk * 16, D);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(wS + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the lane's 32 columns; the two lanes of a row
    // (lane, lane ^ 16) combine with one shuffle
    float s[32];
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = wS[row * LDS + c0 + i] * scale;
      s[i] = (kt * BK + c0 + i < len) ? x : -1e9f;
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 16));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = expf(s[i] - m_new);
      psum += p;
      wP[row * LDP + c0 + i] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 16);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha;
    __syncwarp();

    // PV: (16 x BK) x (BK x D), staged through wS
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, wP + kk * 16, LDP);
        wmma::load_matrix_sync(fb, sV + kk * 16 * D + n * 16, D);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(wS + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] += wS[row * LDS + c0 + i];
    __syncwarp();
  }

  const int t = q0 + warp * 16 + row;
  if (t < T) {
    bf16* dst = out + ((size_t)b * T + t) * HD + h * D + c0;
#pragma unroll
    for (int i = 0; i < 32; ++i) dst[i] = __float2bfloat16(o[i] / l);
  }
}

template <bool ROPE>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* cosv, const void* sinv, void* out, int B, int T, int H,
           int Dh, float scale, void* stream) {
  if (Dh != D || B < 1 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_rope_kernel<ROPE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  attention_rope_kernel<ROPE><<<grid, THREADS, SMEM_BYTES,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(lengths),
      static_cast<const float*>(cosv), static_cast<const float*>(sinv),
      static_cast<bf16*>(out), T, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B, T, H*D) bf16, contiguous; lengths: (B,) int32;
// cosv, sinv: (T, D/2) f32. Returns cudaGetLastError() after the launch.
extern "C" int attention_rope_launch(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     const void* cosv, const void* sinv,
                                     void* out, int B, int T, int H, int Dh,
                                     float scale, void* stream) {
  return launch<true>(q, k, v, lengths, cosv, sinv, out, B, T, H, Dh, scale,
                      stream);
}

// K2': the same without the rope (no cos/sin tables).
extern "C" int packed_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int B, int T, int H, int Dh,
                                       float scale, void* stream) {
  return launch<false>(q, k, v, lengths, nullptr, nullptr, out, B, T, H, Dh,
                       scale, stream);
}
