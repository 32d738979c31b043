// K7a / K7b and the four projections of K1: weight-only int8 matrix-vector
// product for a handful of rows, y = x @ q^T, with an optional LayerNorm
// prologue and an optional scale / bias / gelu_new / residual epilogue.
//
// Replaces the TPU kernels indextts_tpu/ops/pallas/int8_matmul.py::
// int8_matvec (K7a) and ::int8_mlp (K7b, two launches of this kernel: fc with
// the gelu epilogue, then proj), and the weight streaming of the dense
// layers inside indextts_tpu/ops/pallas/decode_step.py::fused_decode_step.
// Same math as the TPU kernels:
//   - prologue (optional): LayerNorm of each of the M input rows in f32
//     (two-pass mean and variance, eps 1e-5), times w plus b, rounded to bf16;
//   - int8 -> bf16 is exact, a bf16 x bf16 product is exact in f32, and the
//     products are summed in f32 (only the order of the sum differs);
//   - epilogue: none (f32 out, K7a), or acc * scale + bias in f32 rounded to
//     bf16, then either gelu_new on that bf16 value in f32 rounded again, or
//     a bf16 residual add x + bf16(...).
//
// What bounds it on the H100: decode runs M = B*K <= 24 rows (3 on the main
// path), so it does 2*M flops per weight byte: it is bound by reading the
// (N, K) int8 weight once, e.g. 4.9 MB at the qkv shape (3840 x 1280),
// ~1.5 us at 3.35 TB/s. Design: one warp per output row; each lane reads 16
// weight bytes at a time, neighbouring lanes neighbouring bytes (the port's
// (out, in) layout puts the contraction axis in memory order), so a warp
// reads 512 contiguous bytes per load. The M activation rows are staged in
// shared memory in tiles of KT columns (LayerNorm applied on the way in;
// each block recomputes the row statistics, which costs M*K reads of a few
// KB) and every weight chunk is applied to all M rows from registers. Each
// output is reduced with warp shuffles; no atomics, so the sum order and the
// result are fixed from run to run. Later work: more bytes in flight per SM
// (cp.async / TMA ring), split-K at M*K beyond one tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
// activation columns staged per tile: M * KT bf16 stays within 24 KB
constexpr int KT_SMALL_M = 1024, KT_LARGE_M = 512;
constexpr int MAXM = 24;      // rows a launch takes (B*K of the decode)

enum Epilogue { EPI_NONE = 0, EPI_BIAS = 1, EPI_GELU = 2, EPI_RESIDUAL = 3 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf(const bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <bool LN, int EPI>
__global__ void __launch_bounds__(THREADS)
int8_gemv_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                 const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b,
                 const float* __restrict__ scale, const bf16* __restrict__ bias,
                 const bf16* __restrict__ res, void* __restrict__ out, int M,
                 int N, int K, int KT) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);      // M x KT
  __shared__ float mu[MAXM], rstd[MAXM];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (LN) {
    for (int m = warp; m < M; m += WARPS) {
      const bf16* row = x + (size_t)m * K;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += bf(row[k]);
      const float mean = warp_sum(s) / K;
      float v = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float d = bf(row[k]) - mean;
        v += d * d;
      }
      v = warp_sum(v) / K;
      if (lane == 0) {
        mu[m] = mean;
        rstd[m] = rsqrtf(v + 1e-5f);
      }
    }
  }

  const int n = blockIdx.x * WARPS + warp;
  float acc[MAXM];
#pragma unroll
  for (int m = 0; m < MAXM; ++m) acc[m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KT) {
    const int kt = min(KT, K - k0);
    __syncthreads();  // statistics ready / the previous tile consumed
    for (int e = threadIdx.x; e < M * kt; e += THREADS) {
      const int m = e / kt, k = e - m * kt;
      const bf16 xv = x[(size_t)m * K + k0 + k];
      if (LN) {
        const float y = (bf(xv) - mu[m]) * rstd[m];
        xs[m * KT + k] = __float2bfloat16(y * bf(ln_w[k0 + k]) + bf(ln_b[k0 + k]));
      } else {
        xs[m * KT + k] = xv;
      }
    }
    __syncthreads();
    if (n < N) {
      const int8_t* wrow = q + (size_t)n * K + k0;
      for (int c = lane; c < kt / 16; c += 32) {
        const int4 wv = __ldg(reinterpret_cast<const int4*>(wrow) + c);
        const int8_t* wb = reinterpret_cast<const int8_t*>(&wv);
        float w[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j] = (float)wb[j];
#pragma unroll
        for (int m = 0; m < MAXM; ++m) {
          if (m < M) {
            const uint4* xp = reinterpret_cast<const uint4*>(xs + m * KT + 16 * c);
            const uint4 xa = xp[0], xb = xp[1];
            const __nv_bfloat162* h0 = reinterpret_cast<const __nv_bfloat162*>(&xa);
            const __nv_bfloat162* h1 = reinterpret_cast<const __nv_bfloat162*>(&xb);
            float a = acc[m];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = __bfloat1622float2(h0[j]);
              a = fmaf(f.x, w[2 * j], a);
              a = fmaf(f.y, w[2 * j + 1], a);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = __bfloat1622float2(h1[j]);
              a = fmaf(f.x, w[8 + 2 * j], a);
              a = fmaf(f.y, w[8 + 2 * j + 1], a);
            }
            acc[m] = a;
          }
        }
      }
    }
  }
  if (n >= N) return;

#pragma unroll
  for (int m = 0; m < MAXM; ++m)
    if (m < M) acc[m] = warp_sum(acc[m]);
  if (lane != 0) return;
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m >= M) break;
    const size_t o = (size_t)m * N + n;
    if (EPI == EPI_NONE) {
      static_cast<float*>(out)[o] = acc[m];
      continue;
    }
    float v = round_bf(acc[m] * scale[n] + bf(bias[n]));
    if (EPI == EPI_GELU) {
      v = 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
    } else if (EPI == EPI_RESIDUAL) {
      v = bf(res[o]) + v;
    }
    static_cast<bf16*>(out)[o] = __float2bfloat16(v);
  }
}

template <bool LN, int EPI>
cudaError_t launch(const void* x, const void* q, const void* ln_w,
                   const void* ln_b, const void* scale, const void* bias,
                   const void* res, void* out, int M, int N, int K,
                   cudaStream_t stream) {
  const int KT = M <= 12 ? KT_SMALL_M : KT_LARGE_M;
  const int smem = M * KT * (int)sizeof(bf16);
  dim3 grid((N + WARPS - 1) / WARPS);
  int8_gemv_kernel<LN, EPI><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
      static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
      static_cast<const float*>(scale), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(res), out, M, N, K, KT);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) bf16; q: (N, K) int8, 16-byte aligned rows (K % 16 == 0);
// ln_w, ln_b: (K,) bf16 or null (no LayerNorm); scale (N,) f32 and bias (N,)
// bf16 for every epilogue but 0; res: (M, N) bf16 for epilogue 3; out: (M, N)
// f32 for epilogue 0, else bf16. All contiguous. Epilogue: 0 none, 1 scale +
// bias, 2 scale + bias + gelu_new, 3 scale + bias + residual. Returns
// cudaGetLastError() after the launch.
extern "C" int int8_gemv_launch(const void* x, const void* q, const void* ln_w,
                                const void* ln_b, const void* scale,
                                const void* bias, const void* res, void* out,
                                int M, int N, int K, int epilogue,
                                void* stream) {
  if (M < 1 || M > MAXM || N < 1 || K < 16 || K % 16 != 0 || epilogue < 0 ||
      epilogue > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ln = ln_w != nullptr;
#define INT8_GEMV_CASE(E)                                                    \
  case E:                                                                    \
    return (int)(ln ? launch<true, E>(x, q, ln_w, ln_b, scale, bias, res,    \
                                      out, M, N, K, s)                       \
                    : launch<false, E>(x, q, ln_w, ln_b, scale, bias, res,   \
                                       out, M, N, K, s));
  switch (epilogue) {
    INT8_GEMV_CASE(EPI_NONE)
    INT8_GEMV_CASE(EPI_BIAS)
    INT8_GEMV_CASE(EPI_GELU)
    INT8_GEMV_CASE(EPI_RESIDUAL)
  }
#undef INT8_GEMV_CASE
  return (int)cudaErrorInvalidValue;
}
