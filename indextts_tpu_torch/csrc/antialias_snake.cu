// K3: BigVGAN's anti-aliased SnakeBeta activation (Activation1d) in one pass.
//
// Replaces the TPU kernel indextts_tpu/ops/pallas/antialias.py::
// fused_antialias_folded. Same math as indextts_tpu/ops/snake.py::
// antialias_activation_xla, per channel c of a (B, T, C) row with valid
// length L (x_rep = x replicate-clamped to [0, L-1]; f0 = 2 f[0::2],
// f1 = 2 f[1::2] from the 12-tap kaiser-sinc up filter, g the 12-tap
// lowpass):
//   p0(i) = sum_j f0[j] x_rep(i-3+j),  p1(i) = sum_j f1[j] x_rep(i-2+j)
//   s0, s1 = SnakeBeta(p0), SnakeBeta(p1):  u + sin^2(e^a u) / (e^b + 1e-9)
//   the 2x-rate signal is edge-replicated: s(i<0) = s0(0), s(i>L-1) = s1(L-1)
//   y(t) = sum_j g[2j+1] s0(t-2+j) + sum_m g[2m] s1(t-3+m)
// Rows t >= L are computed like the others and masked by the caller.
//
// What bounds it on the H100: per element it reads 2 bytes and writes 2
// bytes against ~60 flops plus two sinf; at BigVGAN's sizes (up to
// 196k x 24 and 3k x 768 per call, 109 calls per vocoder pass) it is
// bound by memory traffic and by the sin throughput. The TPU kernel folded
// time into lanes to fill 128-wide vector registers; that layout trick has
// no purpose here and is dropped.
// Design: one block per (64 output rows, 32 channels, batch row), threads
// channel-fastest so every global access is a coalesced row segment of the
// (B, T, C) layout. The block stages x with a 6-row halo (replicate-clamped
// at 0 and L-1) in shared memory, computes both 2x-rate phases and the snake
// for its rows plus a 3-row halo in f32, applies the edge replication and
// the lowpass, and writes bf16 once: the 2x-rate signal never touches
// device memory.
//
// The same kernel serves two more TPU kernels' entries, with a `logscale`
// flag (alpha and beta taken as they are, or as logs): K5
// fused_antialias_activation (ops/pallas/antialias.py:457, K3's math on
// unfolded (T, C) tiles) and K3' fused_antialias_prefolded (:322, K3 on a
// (B, T/f, f*C) stream that is, row-major, the very (B, T, C) tensor). On
// this card the three compute the same function on the same bytes; the TPU
// kept separate kernels only to fill its 128 lanes in different ways.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TT = 64;        // output rows per block
constexpr int CG = 32;        // channels per block (threadIdx.x)
constexpr int TY = 8;         // threadIdx.y
constexpr int XR = TT + 12;   // staged x rows: [t0 - 6, t0 + TT + 6)
constexpr int SR = TT + 6;    // snake rows:    [t0 - 3, t0 + TT + 3)

__device__ __forceinline__ float snake_beta(float u, float a, float bb) {
  const float s = sinf(u * a);
  return u + s * s / bb;
}

__global__ void __launch_bounds__(CG * TY)
antialias_snake_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ alpha,
                       const float* __restrict__ beta,
                       const int* __restrict__ lengths,
                       const float* __restrict__ taps, bf16* __restrict__ out,
                       int T, int C, int logscale) {
  __shared__ float xs[XR][CG];
  __shared__ float s0[SR][CG];
  __shared__ float s1[SR][CG];
  __shared__ float edge[2][CG];

  const int t0 = blockIdx.x * TT, cl = threadIdx.x;
  const int c = blockIdx.y * CG + cl, b = blockIdx.z;
  const bool cok = c < C;
  const int L = max(1, min(lengths[b], T));
  const bf16* xb = x + (size_t)b * T * C;

  float f0[6], f1[6], g[12];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    f0[j] = taps[j];
    f1[j] = taps[6 + j];
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) g[j] = taps[12 + j];
  float a = 0.f, bb = 1.f;
  if (cok) {
    a = logscale ? expf(alpha[c]) : alpha[c];
    bb = (logscale ? expf(beta[c]) : beta[c]) + 1e-9f;
  }
  auto xrep = [&](int i) -> float {
    const int j = min(max(i, 0), L - 1);
    return __bfloat162float(xb[(size_t)j * C + c]);
  };

  for (int r = threadIdx.y; r < XR; r += TY) xs[r][cl] = cok ? xrep(t0 - 6 + r) : 0.f;
  if (threadIdx.y == 0 && cok) {  // the 2x-rate edge values s0(0), s1(L-1)
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) p += f0[j] * xrep(j - 3);
    edge[0][cl] = snake_beta(p, a, bb);
    p = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) p += f1[j] * xrep(L - 3 + j);
    edge[1][cl] = snake_beta(p, a, bb);
  }
  __syncthreads();

  for (int r = threadIdx.y; r < SR; r += TY) {
    const int i = t0 - 3 + r;
    float v0, v1;
    if (!cok) {
      v0 = v1 = 0.f;
    } else if (i < 0) {
      v0 = v1 = edge[0][cl];
    } else if (i > L - 1) {
      v0 = v1 = edge[1][cl];
    } else {
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        p0 += f0[j] * xs[r + j][cl];
        p1 += f1[j] * xs[r + 1 + j][cl];
      }
      v0 = snake_beta(p0, a, bb);
      v1 = snake_beta(p1, a, bb);
    }
    s0[r][cl] = v0;
    s1[r][cl] = v1;
  }
  __syncthreads();

  if (!cok) return;
  for (int r = threadIdx.y; r < TT; r += TY) {
    const int t = t0 + r;
    if (t >= T) break;
    float y0 = 0.f, y1 = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) y0 += g[2 * j + 1] * s0[r + 1 + j][cl];
#pragma unroll
    for (int m = 0; m < 6; ++m) y1 += g[2 * m] * s1[r + m][cl];
    out[((size_t)b * T + t) * C + c] = __float2bfloat16(y0 + y1);
  }
}

}  // namespace

// x, out: (B, T, C) bf16, contiguous; alpha, beta: (C,) f32 (logs when
// logscale != 0); lengths: (B,) int32; taps: 24 f32 = [2 f[0::2] | 2 f[1::2]
// | g]. Returns cudaGetLastError() after the launch.
extern "C" int antialias_snake_launch(const void* x, const void* alpha,
                                      const void* beta, const void* lengths,
                                      const void* taps, void* out, int B,
                                      int T, int C, int logscale,
                                      void* stream) {
  if (B < 1 || T < 1 || C < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((T + TT - 1) / TT, (C + CG - 1) / CG, B);
  dim3 block(CG, TY);
  antialias_snake_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(alpha),
      static_cast<const float*>(beta), static_cast<const int*>(lengths),
      static_cast<const float*>(taps), static_cast<bf16*>(out), T, C, logscale);
  return (int)cudaGetLastError();
}
