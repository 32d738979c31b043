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
// bytes (104 MB over BigVGAN's six stage shapes, 0.031 ms at 3.35 TB/s),
// against two sines on the SFUs (16 a clock an SM: 0.012 ms for the six
// shapes at 1.98 GHz) and 53 instructions an element and row step in its
// SASS (42 floating-point: two 6-tap phases, two snakes, the 12-tap
// lowpass), 69 an output row with a run's 5-row halo: an estimated 0.053
// ms of instruction issue at 4 warp instructions a clock an SM (a count
// by hand, kept in chip_smoke.py's K3_INSTR_PER_ELEMENT; recount it when
// this loop changes). So issue bounds it, then bytes; the design
// spends few instructions an element, keeps every byte in flight and
// enough warps on each SM to issue back to back:
//   - registers, not shared memory: a thread owns VEC = 4 channels (one
//     8-byte load or store a row) and a run of R = 16 output rows. It slides
//     over x rows t0 - 5 .. t0 + R + 4, each read once (prefetched 3 rows
//     ahead), keeps the 6 newest rows in f32, and at each row computes the
//     two snake values s0(n - 2), s1(n - 3) once and adds them, with their
//     lowpass taps, into the 6 outputs they reach (y(n - 5) .. y(n)); y(n -
//     5) is then whole and is written as bf16 (or fp16). The window and
//     the outputs rotate through registers with a period of 6, so the loop runs
//     unrolled by 6 with no register moves. 4 channels, not 8: with 8 (one
//     16-byte piece) a thread's window and outputs took all 255 registers,
//     two blocks of 128 threads an SM, and the kernel ran slower; with 4 it
//     takes 114 (PERF.md has the times of both);
//   - threads map channel piece first (C / 4 lanes a row, then the runs):
//     at C = 24 six lanes a row and no idle lanes;
//   - the snake: e^a and 1 / (e^b + 1e-9) once a channel; the sine's
//     argument reduced to [-pi, pi] (rounded to the nearest multiple of 2 pi
//     by the 1.5 * 2^23 addition, two-constant Cody-Waite) and then the SFU
//     sine (__sinf, about 2^-21.4 absolute error there);
//   - runs that touch an edge (the first 5 rows, or rows past L - 6) take a
//     second copy of the loop with the clamps and the edge replication; all
//     other runs take none of that.
// C must be a multiple of 4 (every BigVGAN width is, 24-1536); the wrapper
// refuses other widths.
//
// Element types: bf16 (IndexTTS2's BigVGAN-v2) and fp16 (IndexTTS-1's
// BigVGAN v1, which runs at fp16 by default). The kernel is a template on
// the 16-bit type: only the load's widening and the store's rounding differ
// (`Io<E>`); the arithmetic is f32 in both, and the bf16 instantiation is
// the kernel as it was before fp16 was added.
//
// The same kernel serves two more TPU kernels' entries, with a `logscale`
// flag (alpha and beta taken as they are, or as logs): K5
// fused_antialias_activation (ops/pallas/antialias.py:457, K3's math on
// unfolded (T, C) tiles) and K3' fused_antialias_prefolded (:322, K3 on a
// (B, T/f, f*C) stream that is, row-major, the very (B, T, C) tensor). On
// this card the three compute the same function on the same bytes; the TPU
// kept separate kernels only to fill its 128 lanes in different ways.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int VEC = 4;        // channels a thread: one 8-byte row piece (ops/snake.py::SNAKE_VEC)
constexpr int RUN = 16;       // output rows a thread (ops/snake.py::SNAKE_RUN)
constexpr int THREADS = 128;
constexpr int WIN = 6;        // the period of the register rotation
constexpr int PREFETCH = 3;   // rows loaded ahead of their use
constexpr float INV_2PI = 0.15915494309189535f;
constexpr float ROUND = 12582912.f;                      // 1.5 * 2^23: x + ROUND - ROUND = rint(x)
constexpr float TWO_PI_HI = 6.28318548202514648f;        // float(2 pi)
constexpr float TWO_PI_LO = -1.7484555314695172e-7f;     // 2 pi - float(2 pi)

static_assert(PREFETCH < WIN, "a prefetched row must not overwrite one still in use");

struct Taps {
  float f0[6], f1[6], g[12];
};

__device__ __forceinline__ float snake(float u, float a, float inv_b) {
  const float z = u * a;
  const float k = __fadd_rn(__fmaf_rn(z, INV_2PI, ROUND), -ROUND);  // |z| < 2^22 pi
  const float r = fmaf(-k, TWO_PI_LO, fmaf(-k, TWO_PI_HI, z));
  const float s = __sinf(r);
  return fmaf(s * s, inv_b, u);
}

// a thread's piece of a row: VEC 16-bit values, VEC / 2 words
struct __align__(2 * VEC) Piece {
  uint32_t w[VEC / 2];
};

template <typename E>
__device__ __forceinline__ Piece load_piece(const E* p) {
  return *reinterpret_cast<const Piece*>(p);
}

// the widening of a piece to f32 and the rounding of VEC f32 values to one
template <typename E>
struct Io;

template <>
struct Io<bf16> {
  static __device__ __forceinline__ void unpack(const Piece& v, float (&x)[VEC]) {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      x[2 * i] = __uint_as_float(v.w[i] << 16);
      x[2 * i + 1] = __uint_as_float(v.w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ Piece pack(const float (&y)[VEC]) {
    Piece v;
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
      v.w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return v;
  }
};

template <>
struct Io<f16> {
  static __device__ __forceinline__ void unpack(const Piece& v, float (&x)[VEC]) {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&v.w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ Piece pack(const float (&y)[VEC]) {
    Piece v;
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      const __half2 h = __floats2half2_rn(y[2 * i], y[2 * i + 1]);
      v.w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return v;
  }
};

// One thread's run: output rows [t0, t0 + RUN) of channels [c0, c0 + VEC) of
// batch row b. Step k = 0 .. RUN + 9 takes x row n = t0 - 5 + k (into
// window slot k % 6); from k = 5 on it forms s0(n - 2) and s1(n - 3) from
// the window x(n - 5 .. n) and adds them into the outputs y(n - 5 + i), i
// = 0..5 (slot (k + 1 + i) % 6) with taps g[2(5 - i) + 1] and g[2(5 - i)];
// from k = 10 on y(n - 5) = y(t0 + k - 10) is whole and written. EDGE adds
// the clamps of x to [0, L - 1], the edge replication of s and the T mask.
template <typename E, bool EDGE>
__device__ __forceinline__ void run_rows(const E* __restrict__ xb, E* __restrict__ ob,
                                         int t0, int T, int C, int L, const Taps& tp,
                                         const float (&a)[VEC], const float (&ib)[VEC],
                                         const float (&e0)[VEC], const float (&e1)[VEC]) {
  float xw[WIN][VEC], y[WIN][VEC];
  Piece raw[WIN];
#pragma unroll
  for (int s = 0; s < WIN; ++s)
#pragma unroll
    for (int c = 0; c < VEC; ++c) y[s][c] = 0.f;
  constexpr int STEPS = RUN + 10;
  auto load = [&](int k) {  // x row t0 - 5 + k, clamped at the edges
    int n = t0 - 5 + k;
    if (EDGE) n = min(max(n, 0), L - 1);
    return load_piece(xb + (size_t)n * C);
  };
#pragma unroll
  for (int k = 0; k < PREFETCH; ++k) raw[k] = load(k);
  for (int k0 = 0; k0 < STEPS; k0 += WIN) {
#pragma unroll
    for (int u = 0; u < WIN; ++u) {
      const int k = k0 + u;
      if (k >= STEPS) break;
      if (k + PREFETCH < STEPS) raw[(u + PREFETCH) % WIN] = load(k + PREFETCH);
      Io<E>::unpack(raw[u], xw[u]);
      if (k < 5) continue;
      const int n = t0 - 5 + k;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int j = 0; j < 6; ++j) {  // x(n - 5 + j): slot (u + 1 + j) % 6
          p0 = fmaf(tp.f0[j], xw[(u + 1 + j) % WIN][c], p0);
          p1 = fmaf(tp.f1[j], xw[(u + 1 + j) % WIN][c], p1);
        }
        float s0 = snake(p0, a[c], ib[c]), s1 = snake(p1, a[c], ib[c]);
        if (EDGE) {
          const int i0 = n - 2, i1 = n - 3;
          s0 = i0 < 0 ? e0[c] : i0 > L - 1 ? e1[c] : s0;
          s1 = i1 < 0 ? e0[c] : i1 > L - 1 ? e1[c] : s1;
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          float& acc = y[(u + 1 + i) % WIN][c];
          acc = fmaf(tp.g[2 * (5 - i) + 1], s0, acc);
          acc = fmaf(tp.g[2 * (5 - i)], s1, acc);
        }
      }
      if (k >= 10) {  // y(n - 5) is whole
        float(&done)[VEC] = y[(u + 1) % WIN];
        const int t = n - 5;
        if (!EDGE || t < T) *reinterpret_cast<Piece*>(ob + (size_t)t * C) = Io<E>::pack(done);
      }
#pragma unroll
      for (int c = 0; c < VEC; ++c) y[(u + 1) % WIN][c] = 0.f;
    }
  }
}

// s0(0) (phase 0, left edge) or s1(L - 1) (phase 1, right edge) of VEC channels
template <typename E>
__device__ __forceinline__ void edge_value(const E* __restrict__ xb, int C, int L, int phase,
                                           const Taps& tp, const float (&a)[VEC],
                                           const float (&ib)[VEC], float (&e)[VEC]) {
  float p[VEC] = {};
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int n = phase == 0 ? j - 3 : L - 3 + j;
    float x[VEC];
    Io<E>::unpack(load_piece(xb + (size_t)min(max(n, 0), L - 1) * C), x);
#pragma unroll
    for (int c = 0; c < VEC; ++c) p[c] = fmaf(phase == 0 ? tp.f0[j] : tp.f1[j], x[c], p[c]);
  }
#pragma unroll
  for (int c = 0; c < VEC; ++c) e[c] = snake(p[c], a[c], ib[c]);
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
antialias_snake_kernel(const E* __restrict__ x, const float* __restrict__ alpha,
                       const float* __restrict__ beta, const int* __restrict__ lengths,
                       const float* __restrict__ taps, E* __restrict__ out, int B, int T,
                       int C, int logscale) {
  const int vecs = C / VEC, runs = (T + RUN - 1) / RUN;
  const long long gid = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (gid >= (long long)B * runs * vecs) return;
  const int v = (int)(gid % vecs);
  const long long rest = gid / vecs;
  const int run = (int)(rest % runs), b = (int)(rest / runs);
  const int t0 = run * RUN, c0 = v * VEC;
  const int L = max(1, min(lengths[b], T));
  const E* xb = x + (size_t)b * T * C + c0;
  E* ob = out + (size_t)b * T * C + c0;

  Taps tp;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    tp.f0[j] = taps[j];
    tp.f1[j] = taps[6 + j];
  }
#pragma unroll
  for (int j = 0; j < 12; ++j) tp.g[j] = taps[12 + j];
  float a[VEC], ib[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) {
    const float al = alpha[c0 + c], be = beta[c0 + c];
    a[c] = logscale ? expf(al) : al;
    ib[c] = 1.f / ((logscale ? expf(be) : be) + 1e-9f);
  }

  float e0[VEC], e1[VEC];
  if (t0 >= 5 && t0 + RUN + 4 <= L - 1) {  // the run's x rows all lie in [0, L - 1]
    run_rows<E, false>(xb, ob, t0, T, C, L, tp, a, ib, e0, e1);
  } else {
    edge_value(xb, C, L, 0, tp, a, ib, e0);
    edge_value(xb, C, L, 1, tp, a, ib, e1);
    run_rows<E, true>(xb, ob, t0, T, C, L, tp, a, ib, e0, e1);
  }
}

}  // namespace

// x, out: (B, T, C) 16-bit floats (half == 0: bf16, half == 1: fp16),
// contiguous, 8-byte aligned, C % 4 == 0; alpha, beta: (C,) f32 (logs when
// logscale != 0); lengths: (B,) int32; taps: 24 f32 = [2 f[0::2] | 2
// f[1::2] | g]. Returns cudaGetLastError() after the launch.
extern "C" int antialias_snake_launch(const void* x, const void* alpha,
                                      const void* beta, const void* lengths,
                                      const void* taps, void* out, int B,
                                      int T, int C, int logscale, int half,
                                      void* stream) {
  if (B < 1 || T < 1 || C < VEC || C % VEC != 0 || (half != 0 && half != 1) ||
      (reinterpret_cast<uintptr_t>(x) & (2 * VEC - 1)) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & (2 * VEC - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)B * ((T + RUN - 1) / RUN) * (C / VEC);
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* b = static_cast<const float*>(beta);
  const int* lens = static_cast<const int*>(lengths);
  const float* tp = static_cast<const float*>(taps);
  if (half)
    antialias_snake_kernel<f16><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const f16*>(x), a, b, lens, tp, static_cast<f16*>(out), B, T, C, logscale);
  else
    antialias_snake_kernel<bf16><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const bf16*>(x), a, b, lens, tp, static_cast<bf16*>(out), B, T, C,
        logscale);
  return (int)cudaGetLastError();
}
