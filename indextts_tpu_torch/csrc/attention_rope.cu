// K2: non-causal, length-masked attention with the half-split rope, as two
// launches: a rope pass over q and k, then the attention of K2'.
//
// Replaces the TPU kernel indextts_tpu/ops/pallas/attn.py::
// packed_pair_attention_rope (the DiT backbone's attention,
// indextts_tpu/models/s2mel/dit.py). Same math:
//   - q and k rows are rotated in f32 (half-split rope: lanes [0, D/2) and
//     [D/2, D) of each head are the two halves) and rounded to bf16;
//   - scores q.k * 1/sqrt(D) in f32; keys >= lengths[b] get -1e9;
//   - softmax in f32 against the running row max; the probabilities are
//     rounded to bf16 unnormalized before the PV product, and the f32 row
//     sum divides at the end.
// Query rows past lengths[b] are computed like any other (they attend the
// valid keys) and are masked by the caller, as on the TPU. Both passes take
// bf16 or fp16 operands (the TPU kernel takes q's dtype): the rope rounds
// its f32 results to that type, the attention core is instantiated for it.
// K2' (`packed_attention_launch`) replaces indextts_tpu/ops/pallas/attn.py::
// packed_pair_attention, the same attention without the rope; K2 is the rope
// pass (`rope_qk_launch`) followed by K2'.
//
// What bounds it on the H100: the DiT calls it at B=2 (the CFG pair), H=8,
// D=64 and T = prompt + mel frames (~1-3.5k): 4*B*H*T*L*D flops over the
// valid keys L (~5 GFLOP at T=1280), over ~4*B*T*H*D*2 bytes of q/k/v/out:
// bound by operations. The attention core is attention_tma.cuh (TMA ring,
// wgmma for both products, softmax on the accumulators in registers). What
// it does about the WMMA kernel it replaced:
//   1. loads were scalar and synchronous: TMA moves whole 64 x 64 tiles, one
//      thread issues, and the producer keeps the next tile in flight while
//      the warpgroup computes on the last;
//   2. every query-tile block re-roped every key tile (T/64 times over, three
//      more loads an element): the rope runs once per call here, in
//      `rope_qk_kernel`, into a bf16 scratch q and k the wrapper allocates,
//      with the same f32 __fmul_rn / __fsub_rn / __fadd_rn chain (bit-equal
//      to the twin's rope); it reads freqs_cis's (T, D/2, 2) f32 table as it
//      is, with no per-call cos / sin copies;
//   3. scores and partial outputs round-tripped through shared memory: the
//      wgmma accumulators stay in registers, P goes to PV as the register A
//      operand, O leaves registers once, in the epilogue;
//   4. WMMA fragments read unswizzled 128-byte rows with bank conflicts: TMA
//      writes the 128-byte swizzle wgmma's descriptors read;
//   5. 16-row warps issued 16x16x16 WMMA one at a time: one warpgroup issues
//      m64n64k16 wgmma over 64 query rows; three blocks share an SM.

#include "attention_tma.cuh"

namespace {

using attn_tma::bf16;
using attn_tma::f16;
constexpr int D = 64;          // the kernel's head width
constexpr int HALF = D / 2;
constexpr int ROPE_THREADS = 256;

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(f16 x) { return __half2float(x); }
template <typename E>
__device__ __forceinline__ E from_f32(float x) {
  if constexpr (attn_tma::is_f16<E>) return __float2half_rn(x);
  else return __float2bfloat16(x);
}

// One thread per 8 rotation pairs of one head row of q or of k: lanes
// [8c, 8c + 8) and [HALF + 8c, HALF + 8c + 8), read and written 16 bytes at
// a time; freqs (>= T, HALF, 2) f32 holds (cos, sin) per (t, pair). E is
// bf16 or fp16.
template <typename E>
__global__ void __launch_bounds__(ROPE_THREADS)
rope_qk_kernel(const E* __restrict__ q, const E* __restrict__ k,
               const float2* __restrict__ freqs, E* __restrict__ qr,
               E* __restrict__ kr, long long rows, int T, int H) {
  const long long idx = (long long)blockIdx.x * ROPE_THREADS + threadIdx.x;
  const int c = idx % (HALF / 8);
  const bool is_k = (idx / (HALF / 8)) % 2;
  const long long row = idx / (HALF / 4);   // (b * T + t) * H + h
  if (row >= rows) return;
  const int t = (row / H) % T;
  const E* src = (is_k ? k : q) + row * D + 8 * c;
  E* dst = (is_k ? kr : qr) + row * D + 8 * c;
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const uint4 z = *reinterpret_cast<const uint4*>(src + HALF);
  const E* x1 = reinterpret_cast<const E*>(&a);
  const E* x2 = reinterpret_cast<const E*>(&z);
  const float2* cs = freqs + (long long)t * HALF + 8 * c;
  uint4 lo, hi;
  E* y1 = reinterpret_cast<E*>(&lo);
  E* y2 = reinterpret_cast<E*>(&hi);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float u = to_f32(x1[i]), w = to_f32(x2[i]);
    const float2 f = cs[i];
    y1[i] = from_f32<E>(__fsub_rn(__fmul_rn(u, f.x), __fmul_rn(w, f.y)));
    y2[i] = from_f32<E>(__fadd_rn(__fmul_rn(w, f.x), __fmul_rn(u, f.y)));
  }
  *reinterpret_cast<uint4*>(dst) = lo;
  *reinterpret_cast<uint4*>(dst + HALF) = hi;
}

template <typename E>
int rope_qk(const void* q, const void* k, const void* freqs, void* qr, void* kr, long long rows,
            int T, int H, cudaStream_t stream) {
  const long long threads = rows * (HALF / 4);
  const unsigned blocks = (unsigned)((threads + ROPE_THREADS - 1) / ROPE_THREADS);
  rope_qk_kernel<E><<<blocks, ROPE_THREADS, 0, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const float2*>(freqs),
      static_cast<E*>(qr), static_cast<E*>(kr), rows, T, H);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, qr, kr: (B, T, H*D) bf16 (fp16 if ``half``), contiguous; freqs:
// (>= T, D/2, 2) f32, contiguous. qr, kr = the rotated q, k. Returns
// cudaGetLastError().
extern "C" int rope_qk_launch(const void* q, const void* k, const void* freqs, void* qr,
                              void* kr, int B, int T, int H, int Dh, int half, void* stream) {
  if (Dh != D || B < 1 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * T * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return half ? rope_qk<f16>(q, k, freqs, qr, kr, rows, T, H, st)
              : rope_qk<bf16>(q, k, freqs, qr, kr, rows, T, H, st);
}

// K2': q, k, v, out: (B, T, H*D) bf16 (fp16 if ``half``), contiguous, 16-byte
// aligned; lengths: (B,) int32. Returns a cudaError_t.
extern "C" int packed_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, int B, int T, int H,
                                       int Dh, float scale, int half, void* stream) {
  if (Dh != D) return (int)cudaErrorInvalidValue;
  // the (B, H, T, D) view of a (B, T, H*D) buffer
  const attn_tma::Strides s{(long long)T * H * D, D, (long long)H * D};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return half ? attn_tma::launch<D, false, f16>(q, k, v, lengths, out, B, H, T, s, s, s, s,
                                                scale, st)
              : attn_tma::launch<D, false, bf16>(q, k, v, lengths, out, B, H, T, s, s, s, s,
                                                 scale, st);
}

// K2: the rope pass into the scratch qr, kr, then K2' on (qr, kr, v); one
// call from the host for the two launches. Shapes and types as above.
extern "C" int attention_rope_launch(const void* q, const void* k, const void* v,
                                     const void* lengths, const void* freqs, void* qr,
                                     void* kr, void* out, int B, int T, int H, int Dh,
                                     float scale, int half, void* stream) {
  const int err = rope_qk_launch(q, k, freqs, qr, kr, B, T, H, Dh, half, stream);
  if (err != cudaSuccess) return err;
  return packed_attention_launch(qr, kr, v, lengths, out, B, T, H, Dh, scale, half, stream);
}
