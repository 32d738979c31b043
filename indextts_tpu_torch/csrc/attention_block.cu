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
//   p = exp(s - max) / sum, in f32 (the divide as a product with the f32
//   reciprocal of the sum), THEN rounded to v's type (bf16, or fp16 for a
//   float16 pipeline: the TPU kernel takes q's dtype);
//   out = p . v with f32 sums, rounded to that type.
// The rounding order is what separates it from K2, which rounds the
// unnormalized p and divides after PV: an online softmax in one pass can
// only give K2's order. So the kernel makes two passes over the 64-key
// tiles (attention_tma.cuh, NORMALIZED): pass 1 loads K only and gets each
// query row's max and sum (online rescale); pass 2 reloads K with V,
// recomputes the scores, forms the normalized p, rounds it to bf16 and
// accumulates PV in f32.
//
// What bounds it on the H100: at the DiT's shapes (B=2, H=4..16, T ~1-3.5k,
// D=32..128) it does 6*B*H*T*L*D flops over the valid keys L (QK^T twice, PV
// once) over ~4*B*H*T*D*2 bytes: bound by operations, so the (T, T) scores
// never reach device memory and both products run on wgmma. q, k and v are
// read through their strides by TMA tensor maps over (D, T, H, B) (the DiT
// hands over transposed (B, T, H, D) views: no copy; a base or stride TMA
// cannot take, not a multiple of 16 bytes, makes the launch fail and the
// wrapper refuses it first). D is a multiple of 16 up to 128, one
// instantiation each: QK^T takes D / 16 k-steps, PV the 64 or 128 lanes of
// the one or two 64-lane boxes a row loads (lanes past D are zero-filled and
// never stored). What the design does about the WMMA kernel it replaced:
// scalar synchronous tile loads became a TMA ring kept in flight by a
// producer warp; scores, probabilities and PV partials no longer pass
// through shared memory (softmax on the wgmma accumulators, P as the
// register A operand of PV); the 128-byte swizzle removes the bank
// conflicts of unswizzled rows; one warpgroup issues m64 wgmma for 64 query
// rows; the per-probability __fdiv_rn became one reciprocal a row.

#include "attention_tma.cuh"

namespace {

template <typename E>
int launch_d(const void* q, const void* k, const void* v, const void* lengths, void* out,
             int B, int H, int T, int D, attn_tma::Strides qs, attn_tma::Strides ks,
             attn_tma::Strides vs, attn_tma::Strides os, float scale, cudaStream_t st) {
  using attn_tma::launch;
  switch (D) {
    case 16: return launch<16, true, E>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, scale, st);
    case 32: return launch<32, true, E>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, scale, st);
    case 48: return launch<48, true, E>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, scale, st);
    case 64: return launch<64, true, E>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, scale, st);
    case 80: return launch<80, true, E>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, scale, st);
    case 96: return launch<96, true, E>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, scale, st);
    case 112:
      return launch<112, true, E>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, scale, st);
    case 128:
      return launch<128, true, E>(q, k, v, lengths, out, B, H, T, qs, ks, vs, os, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: (B, H, T, D) bf16 (fp16 if ``half``) read and written
// through the element strides *_sb, *_sh, *_st (D contiguous; bases and
// strides of q, k, v multiples of 16 bytes); lengths: (B,) int32. D is a
// multiple of 16 up to 128. Returns a cudaError_t.
extern "C" int attention_block_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int H, int T, int D, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long o_sb,
    long long o_sh, long long o_st, float scale, int half, void* stream) {
  const attn_tma::Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st}, vs{v_sb, v_sh, v_st},
      os{o_sb, o_sh, o_st};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return half ? launch_d<attn_tma::f16>(q, k, v, lengths, out, B, H, T, D, qs, ks, vs, os,
                                        scale, st)
              : launch_d<attn_tma::bf16>(q, k, v, lengths, out, B, H, T, D, qs, ks, vs, os,
                                         scale, st);
}
