// K4: (B, H, T, D) non-causal, length-masked attention whose probabilities
// are normalized before the PV product.
//
// Replaces the TPU kernel indextts_tpu/ops/pallas/attn.py::
// single_block_attention, which the JAX DiT reaches through nn.mha_flash
// when the packed kernel's gate fails (head width other than 64, or
// INDEXTTS_PACKED_ATTN=0). Same math, per (b, h) and query row:
//   s = (q . k) * scale in f32 (products of bf16 values, exact in f32);
//   keys >= lengths[b] get -1e9 (a row of length 0 then averages every key,
//   as on the TPU);
//   p = exp(s - max) / sum, in f32, THEN rounded to bf16;
//   out = p . v with f32 sums, rounded to bf16.
// The rounding order is what separates it from K2, which rounds the
// unnormalized p and divides after PV: an online softmax in one pass can
// only give K2's order. So the kernel makes two passes over the 64-key
// tiles: pass 1 gets each query row's max and sum (online rescale), pass 2
// recomputes the scores, forms the normalized p, rounds it to bf16 and
// accumulates PV in f32.
//
// What bounds it on the H100: at the DiT's shapes (B=2, H=4..16, T ~1-3.5k,
// D=32..128) it does 6*B*H*T*L*D flops (QK^T twice, PV once) over
// ~4*B*H*T*D*2 bytes: compute bound, so the (T, T) scores never reach device
// memory and the products run on the tensor cores (bf16 WMMA 16x16x16, f32
// accumulators). The TPU kernel held the whole (T, T) score block in VMEM;
// an SM has 227 KB, hence the key tiles. One block per (64 query rows, head,
// batch row), 4 warps of 16 rows; q, k and v are read through their strides
// (the DiT hands over transposed (B, T, H, D) views: no copy), D
// contiguous. D is a multiple of 16 up to 128 (one instantiation each).
// A simple kernel, correct first: the QK^T of pass 1 is recomputed in pass 2
// and the tile loads are not pipelined (later work: wgmma + TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int NWARPS = BQ / 16;
constexpr int THREADS = NWARPS * 32;
constexpr int LDP = BK + 8;    // bf16 prob row stride (wmma: multiple of 8)

struct Strides {               // elements between neighbours along b, h, t
  long long b, h, t;
};

template <int D>
struct Shape {
  static constexpr int LDS = (D > BK ? D : BK) + 4;  // f32 scores / PV out
  static constexpr int SMEM = 3 * 64 * D * 2 + NWARPS * 16 * LDS * 4 +
                              NWARPS * 16 * LDP * 2;
};

// Rows [t0, t0 + 64) of head h of batch row b into s (64 x D, bf16); rows
// past T are zero.
template <int D>
__device__ void load_tile(bf16* s, const bf16* __restrict__ src, Strides st,
                          int b, int h, int t0, int T) {
  const bf16* base = src + b * st.b + h * st.h;
  for (int e = threadIdx.x; e < 64 * D; e += THREADS) {
    const int r = e / D, d = e % D, t = t0 + r;
    s[e] = t < T ? base[t * st.t + d] : __float2bfloat16(0.f);
  }
}

// This warp's 16 query rows against the 64 keys of sK: raw f32 dot
// products into wS (16 x BK, row stride LDS).
template <int D>
__device__ void tile_scores(const bf16* wQ, const bf16* sK, float* wS,
                            int lds) {
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, wQ + kk * 16, D);
      wmma::load_matrix_sync(fb, sK + n * 16 * D + kk * 16, D);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(wS + n * 16, acc, lds, wmma::mem_row_major);
  }
}

// The masked, scaled score of key j: -1e9 past the row's length, -inf past
// T (the zero-filled rows of a ragged last tile, which take no mass).
__device__ __forceinline__ float masked(float dot, int j, int len, int T,
                                        float scale) {
  return j >= T ? -INFINITY : (j >= len ? -1e9f : dot * scale);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attention_block_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const int* __restrict__ lengths, bf16* __restrict__ out,
                       Strides qs, Strides ks, Strides vs, Strides os, int T,
                       float scale) {
  constexpr int LDS = Shape<D>::LDS;
  constexpr int HALF = D / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * D;
  bf16* sV = sK + BK * D;
  float* sS = reinterpret_cast<float*>(sV + BK * D);
  bf16* sP = reinterpret_cast<bf16*>(sS + NWARPS * 16 * LDS);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = lengths[b];
  // keys past the length score -1e9 and take exactly no mass beside a valid
  // key, so their tiles are skipped; a row of length 0 attends every key
  const int n_kt = (len >= 1 ? min(len, T) + BK - 1 : T + BK - 1) / BK;

  const bf16* wQ = sQ + warp * 16 * D;
  float* wS = sS + warp * 16 * LDS;   // this warp's 16 x BK scores / PV out
  bf16* wP = sP + warp * 16 * LDP;    // this warp's 16 x BK probabilities
  const int row = lane % 16;          // a lane owns half of one query row
  const int c0 = (lane / 16) * 32;    // its score columns
  const int d0 = (lane / 16) * HALF;  // its output columns

  load_tile<D>(sQ, q, qs, b, h, q0, T);

  // pass 1: the row max m and the sum l of exp(s - m), online
  float m = -INFINITY, l = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // sQ written / previous sK consumed
    load_tile<D>(sK, k, ks, b, h, kt * BK, T);
    __syncthreads();
    tile_scores<D>(wQ, sK, wS, LDS);
    __syncwarp();
    float s[32];
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = masked(wS[row * LDS + c0 + i], kt * BK + c0 + i, len, T, scale);
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 16));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) psum += expf(s[i] - m_new);
    psum += __shfl_xor_sync(0xffffffffu, psum, 16);
    l = l * expf(m - m_new) + psum;
    m = m_new;
    __syncwarp();
  }

  // pass 2: p = exp(s - m) / l rounded to bf16, PV in f32
  float o[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) o[i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<D>(sK, k, ks, b, h, kt * BK, T);
    load_tile<D>(sV, v, vs, b, h, kt * BK, T);
    __syncthreads();
    tile_scores<D>(wQ, sK, wS, LDS);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float s =
          masked(wS[row * LDS + c0 + i], kt * BK + c0 + i, len, T, scale);
      wP[row * LDP + c0 + i] = __float2bfloat16(__fdiv_rn(expf(s - m), l));
    }
    __syncwarp();
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
    for (int i = 0; i < HALF; ++i) o[i] += wS[row * LDS + d0 + i];
    __syncwarp();
  }

  const int t = q0 + warp * 16 + row;
  if (t < T) {
    bf16* dst = out + b * os.b + h * os.h + t * os.t + d0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) dst[i] = __float2bfloat16(o[i]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int H, int T, Strides qs, Strides ks, Strides vs,
           Strides os, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_block_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Shape<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  attention_block_kernel<D><<<grid, THREADS, Shape<D>::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(lengths),
      static_cast<bf16*>(out), qs, ks, vs, os, T, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B, H, T, D) bf16 read and written through the element
// strides *_sb, *_sh, *_st (D contiguous); lengths: (B,) int32. D is a
// multiple of 16 up to 128. Returns cudaGetLastError() after the launch.
extern "C" int attention_block_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int H, int T, int D, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long o_sb,
    long long o_sh, long long o_st, float scale, void* stream) {
  if (B < 1 || H < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st},
      vs{v_sb, v_sh, v_st}, os{o_sb, o_sh, o_st};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, scale, st);
    case 32: return launch<32>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, scale, st);
    case 48: return launch<48>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, scale, st);
    case 64: return launch<64>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, scale, st);
    case 80: return launch<80>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, scale, st);
    case 96: return launch<96>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, scale, st);
    case 112: return launch<112>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, scale, st);
    case 128: return launch<128>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
