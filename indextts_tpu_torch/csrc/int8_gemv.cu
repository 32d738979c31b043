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
// column h + j (h = 320 at the shipped widths). A lane's 16 packed bytes
// therefore pair with two runs of 16 activations h apart, so the activation
// tile holds whole 2h-column groups (KT a multiple of 2h). The nibbles are
// sign-extended with arithmetic shifts of int8 values: lo = (int8)(b << 4)
// >> 4, hi = b >> 4.
//
// What bounds it on the H100: decode runs M = B*K <= 24 rows (3 on the main
// path), so it does 2*M flops per weight value: it is bound by reading the
// weight once, e.g. 4.9 MB int8 (2.5 MB int4) at the qkv shape (3840 x
// 1280), ~1.5 us (~0.7 us) at 3.35 TB/s. Design: one warp per output row;
// each lane reads 16 weight bytes at a time, neighbouring lanes neighbouring
// bytes (the port's (out, in) layout puts the contraction axis in memory
// order), so a warp reads 512 contiguous bytes per load; a ragged end of a
// row (640 packed int4 bytes per 1280-column tile) leaves some lanes idle
// in the last load. The M activation rows are staged in shared memory in
// tiles of KT columns (LayerNorm applied on the way in; each block
// recomputes the row statistics, which costs M*K reads of a few KB) and
// every weight chunk is applied to all M rows from registers. Each output
// is reduced with warp shuffles; no atomics, so the sum order and the result
// are fixed from run to run. Later work: more bytes in flight per SM
// (cp.async / TMA ring), split-K at M*K beyond one tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
// activation columns staged per tile: M * KT bf16 stays within 24 KB (int8)
// or 30 KB (int4, whole 2h-column groups at h = 320); with one nibble group
// spanning the row (small widths) the tile is the row, checked at launch
constexpr int KT_SMALL_M = 1024, KT_LARGE_M = 512;
constexpr int KT_W4_SMALL_M = 1280, KT_W4_LARGE_M = 640;
constexpr int SMEM_LIMIT = 48 * 1024 - 1024;  // dynamic tile under the default
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

// a + sum_j xp[j] * w[j] over 16 bf16 activations (32-byte aligned) in order
__device__ __forceinline__ float dot16(const bf16* xp, const float* w, float a) {
  const uint4 xa = reinterpret_cast<const uint4*>(xp)[0];
  const uint4 xb = reinterpret_cast<const uint4*>(xp)[1];
  const __nv_bfloat162* h0 = reinterpret_cast<const __nv_bfloat162*>(&xa);
  const __nv_bfloat162* h1 = reinterpret_cast<const __nv_bfloat162*>(&xb);
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
  return a;
}

// the two signed nibbles of a packed int4 byte
__device__ __forceinline__ float lo_nibble(int8_t b) {
  return (float)(static_cast<int8_t>(static_cast<uint8_t>(b) << 4) >> 4);
}
__device__ __forceinline__ float hi_nibble(int8_t b) { return (float)(b >> 4); }

// W4: q is (N, K/2) nibble-packed in groups of 2 * half columns; the tile
// width KT is then a multiple of 2 * half
template <bool LN, int EPI, bool W4>
__global__ void __launch_bounds__(THREADS)
int8_gemv_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                 const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b,
                 const float* __restrict__ scale, const bf16* __restrict__ bias,
                 const bf16* __restrict__ res, void* __restrict__ out, int M,
                 int N, int K, int KT, int half) {
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
    if (n < N && W4) {
      // packed bytes [k0/2, (k0 + kt)/2) of row n: whole nibble groups
      const int8_t* wrow = q + (size_t)n * (K / 2) + k0 / 2;
      for (int c = lane; c < kt / 32; c += 32) {
        const int4 wv = __ldg(reinterpret_cast<const int4*>(wrow) + c);
        const int8_t* wb = reinterpret_cast<const int8_t*>(&wv);
        float lo[16], hi[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          lo[j] = lo_nibble(wb[j]);
          hi[j] = hi_nibble(wb[j]);
        }
        const int j0 = 16 * c;  // never crosses a group: half % 16 == 0
        const int col = (j0 / half) * 2 * half + j0 % half;
#pragma unroll
        for (int m = 0; m < MAXM; ++m) {
          if (m < M) {
            acc[m] = dot16(xs + m * KT + col, lo, acc[m]);
            acc[m] = dot16(xs + m * KT + col + half, hi, acc[m]);
          }
        }
      }
    } else if (n < N) {
      const int8_t* wrow = q + (size_t)n * K + k0;
      for (int c = lane; c < kt / 16; c += 32) {
        const int4 wv = __ldg(reinterpret_cast<const int4*>(wrow) + c);
        const int8_t* wb = reinterpret_cast<const int8_t*>(&wv);
        float w[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j] = (float)wb[j];
#pragma unroll
        for (int m = 0; m < MAXM; ++m)
          if (m < M) acc[m] = dot16(xs + m * KT + 16 * c, w, acc[m]);
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

template <bool LN, int EPI, bool W4>
cudaError_t launch(const void* x, const void* q, const void* ln_w,
                   const void* ln_b, const void* scale, const void* bias,
                   const void* res, void* out, int M, int N, int K, int half,
                   cudaStream_t stream) {
  int KT = M <= 12 ? KT_SMALL_M : KT_LARGE_M;
  if (W4) {
    const int group = 2 * half;
    KT = min(K, max(1, (M <= 12 ? KT_W4_SMALL_M : KT_W4_LARGE_M) / group) * group);
  }
  const int smem = M * KT * (int)sizeof(bf16);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  dim3 grid((N + WARPS - 1) / WARPS);
  int8_gemv_kernel<LN, EPI, W4><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
      static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
      static_cast<const float*>(scale), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(res), out, M, N, K, KT, half);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) bf16; q: (N, K) int8, 16-byte aligned rows (K % 16 == 0), or
// with half_span h > 0 the int4 weight (N, K/2) int8 in groups of 2h columns
// (K % 2h == 0, h % 16 == 0); ln_w, ln_b: (K,) bf16 or null (no LayerNorm);
// scale (N,) f32 and bias (N,) bf16 for every epilogue but 0; res: (M, N)
// bf16 for epilogue 3; out: (M, N) f32 for epilogue 0, else bf16. All
// contiguous. Epilogue: 0 none, 1 scale + bias, 2 scale + bias + gelu_new,
// 3 scale + bias + residual. Returns cudaGetLastError() after the launch.
extern "C" int int8_gemv_launch(const void* x, const void* q, const void* ln_w,
                                const void* ln_b, const void* scale,
                                const void* bias, const void* res, void* out,
                                int M, int N, int K, int half_span,
                                int epilogue, void* stream) {
  if (M < 1 || M > MAXM || N < 1 || K < 16 || K % 16 != 0 || epilogue < 0 ||
      epilogue > 3 || half_span < 0 ||
      (half_span > 0 && (half_span % 16 != 0 || K % (2 * half_span) != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ln = ln_w != nullptr, w4 = half_span > 0;
#define INT8_GEMV_LN(E, W)                                                   \
  (ln ? launch<true, E, W>(x, q, ln_w, ln_b, scale, bias, res, out, M, N, K, \
                           half_span, s)                                     \
      : launch<false, E, W>(x, q, ln_w, ln_b, scale, bias, res, out, M, N,   \
                            K, half_span, s))
#define INT8_GEMV_CASE(E)                                                    \
  case E:                                                                    \
    return (int)(w4 ? INT8_GEMV_LN(E, true) : INT8_GEMV_LN(E, false));
  switch (epilogue) {
    INT8_GEMV_CASE(EPI_NONE)
    INT8_GEMV_CASE(EPI_BIAS)
    INT8_GEMV_CASE(EPI_GELU)
    INT8_GEMV_CASE(EPI_RESIDUAL)
  }
#undef INT8_GEMV_CASE
#undef INT8_GEMV_LN
  return (int)cudaErrorInvalidValue;
}
