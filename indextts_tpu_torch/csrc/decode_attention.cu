// K1's attention: one decode token of M = B*K rows against one layer of the
// flat (M, S, D) cache, bf16 or int8 (KVQ), split over the positions
// (flash-decoding), with the beam ancestry map read in the kernel.
//
// Replaces the attention inside the TPU kernel indextts_tpu/ops/pallas/
// decode_step.py::fused_decode_step (decode_step.py:460; lines 257-419
// there), with the bf16 cache and with its KVQ variant (the flat int8 cache,
// lines 305-320, 331-337, 352-359, 370-386 and the row write 627-636); the
// projections around it are int8_gemv.cu. Same rounding chain as the TPU
// kernel:
//   - q is scaled by 1/sqrt(Dh) in f32 and rounded to bf16;
//   - each product k_d * q_d is rounded to bf16, and a head's products are
//     summed in f32 (KVQ: k int8 -> bf16 is exact, and the sum is then
//     multiplied by the position's bf16 k-scale, before the mask);
//   - softmax statistics (max, sum) in f32; the probabilities are rounded to
//     bf16 (KVQ: p times the position's v-scale in f32, then rounded; the
//     softmax sum keeps the unscaled p), each p * v product is rounded to
//     bf16, and those are summed in f32; the f32 sum of the unrounded
//     probabilities divides at the end;
//   - the current token's own k and v enter unquantized as a final term
//     (its p rounded to bf16, times v in f32), and the output o / l is
//     rounded to bf16.
// Valid cached keys of row r are [start_r, pos), start_r = pos + 1 -
// popcount(kv_valid[r]) (the decode mask is left padding plus everything
// generated so far). With the ancestry map (group = K > 1) the key, value and
// scale row of row r at position g come from physical row (r / K) * K +
// anc[r, g]: the raw values are selected before any arithmetic, so the
// result is bit-identical to a physically gathered cache. The combine pass
// writes the current token's k and v into the cache at pos of the row's own
// physical row; KVQ quantizes them as gpt2.py::kv_quantize_flat does: per
// head, scale = bf16(max|x| / 127), q = clip(rint(x / max(scale, 1e-8)),
// -127, 127) with an IEEE division, and one packed bf16 scale row per
// position (k-scales on lanes [0, H), v-scales on [128, 128 + H), zeros
// elsewhere). Only positions < pos are read, so the write races no read.
//
// What bounds it on the H100: it reads each valid cached position's k and v
// once, 2 * D bytes per row and position in bf16 (a few MB a layer), D
// bytes plus 4 * H scale bytes in int8, and does ~4 flops per byte: memory
// bound. Only M * H (60 on the main path) (row, head) pairs exist, so the
// position axis is split into chunks of CHUNK positions: grid (chunks, H, M)
// of 64-thread blocks. In a block, thread t scores position chunk0 + t (its
// k row is 128 contiguous bytes in bf16, 64 in int8), the chunk's max and
// sum are block reductions, and thread d then sums the p * v products of
// dim d over the chunk (neighbouring threads read neighbouring bytes of each
// v row). The combine kernel (grid (H, M)) merges the chunks' (max, sum, o)
// in a fixed order, adds the current token, and writes the output and the
// cache row: no atomics, so results repeat exactly. Later work: one
// persistent kernel for the whole step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int DH = 64;        // head dim
constexpr int CHUNK = 64;     // positions per split block
constexpr int THREADS = 64;   // == DH == CHUNK
constexpr float NEG = -1e9f;  // the TPU kernel's mask value
constexpr int SCALE_LANES = 256, SCALE_HALF = 128;  // KVQ's packed scale row

static_assert(THREADS == DH && THREADS == CHUNK, "one thread per dim / position");

__device__ __forceinline__ float bf(const bf16 v) { return __bfloat162float(v); }

// sum / max over the 64 threads of a block (2 warps) through `red`
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  return red[0] + red[1];
}

__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  return fmaxf(red[0], red[1]);
}

// first valid position of row r: pos + 1 - popcount(kv_valid[r])
__device__ int row_start(const uint8_t* __restrict__ kv_valid, int r, int S,
                         int pos, float* red) {
  float n = 0.f;
  for (int g = threadIdx.x; g < S; g += THREADS) n += kv_valid[(size_t)r * S + g] ? 1.f : 0.f;
  return pos + 1 - (int)block_sum(n, red);
}

// q of head h of row r, scaled by 1/sqrt(Dh) in f32 and rounded to bf16
__device__ bf16 scaled_q(const bf16* __restrict__ qkv, int r, int D, int h,
                         int d, float scale) {
  return __float2bfloat16(bf(qkv[(size_t)r * 3 * D + h * DH + d]) * scale);
}

// the cache's element type: bf16, or int8 for KVQ (int8 -> bf16 is exact)
template <bool KVQ>
using cache_t = typename std::conditional<KVQ, int8_t, bf16>::type;

__device__ __forceinline__ bf16 as_bf16(bf16 v) { return v; }
__device__ __forceinline__ bf16 as_bf16(int8_t v) { return __float2bfloat16((float)v); }

template <bool KVQ>
__global__ void __launch_bounds__(THREADS)
split_kernel(const bf16* __restrict__ qkv, const cache_t<KVQ>* __restrict__ ck,
             const cache_t<KVQ>* __restrict__ cv, const bf16* __restrict__ kvs,
             const uint8_t* __restrict__ kv_valid, const int* __restrict__ anc,
             float* __restrict__ part_ml, float* __restrict__ part_o, int S,
             int D, int pos, int group, float scale) {
  __shared__ __align__(16) bf16 sq[DH];
  __shared__ bf16 sp[CHUNK];
  __shared__ int sphys[CHUNK];
  __shared__ float red[2];
  const int c = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int n_chunks = gridDim.x, H = gridDim.y;
  const int t = threadIdx.x;
  const int start = row_start(kv_valid, r, S, pos, red);

  sq[t] = scaled_q(qkv, r, D, h, t, scale);
  const int g = c * CHUNK + t;
  const bool valid = g >= start && g < pos;
  const int phys = anc ? (r / group) * group + anc[(size_t)r * S + min(g, S - 1)] : r;
  sphys[t] = phys;
  __syncthreads();

  // score of position g: sum_d f32(bf16(k_d * q_d)) (KVQ: times its k-scale)
  float s = NEG, v_scale = 1.f;
  if (valid) {
    const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(sq);
    float acc = 0.f;
    if constexpr (KVQ) {
      const uint4* kp = reinterpret_cast<const uint4*>(
          ck + ((size_t)phys * S + g) * D + h * DH);
#pragma unroll
      for (int i = 0; i < DH / 16; ++i) {
        const uint4 kv = kp[i];
        const int8_t* kb = reinterpret_cast<const int8_t*>(&kv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat162 k2 = __floats2bfloat162_rn((float)kb[2 * j], (float)kb[2 * j + 1]);
          const float2 prod = __bfloat1622float2(__hmul2(k2, q2[8 * i + j]));
          acc += prod.x;
          acc += prod.y;
        }
      }
      const bf16* srow = kvs + ((size_t)phys * S + g) * SCALE_LANES;
      acc *= bf(srow[h]);
      v_scale = bf(srow[SCALE_HALF + h]);
    } else {
      const uint4* kp = reinterpret_cast<const uint4*>(
          ck + ((size_t)phys * S + g) * D + h * DH);
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        const uint4 kv = kp[i];
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 prod = __bfloat1622float2(__hmul2(k2[j], q2[4 * i + j]));
          acc += prod.x;
          acc += prod.y;
        }
      }
    }
    s = acc;
  }
  const float m = block_max(s, red);
  const float p = valid ? expf(s - m) : 0.f;
  const float l = block_sum(p, red);
  sp[t] = __float2bfloat16(KVQ ? p * v_scale : p);
  __syncthreads();

  // thread t is now dim t: o_t = sum_g f32(bf16(bf16(p_g) * v_g,t))
  float o = 0.f;
  const int g0 = c * CHUNK;
  const int g1 = min(g0 + CHUNK, pos);
  for (int gg = max(g0, start); gg < g1; ++gg) {
    const int i = gg - g0;
    const cache_t<KVQ> v = cv[((size_t)sphys[i] * S + gg) * D + h * DH + t];
    o += bf(__hmul(sp[i], as_bf16(v)));
  }
  const size_t pi = ((size_t)r * H + h) * n_chunks + c;
  part_o[pi * DH + t] = o;
  if (t == 0) {
    part_ml[2 * pi] = m;
    part_ml[2 * pi + 1] = l;
  }
}

// KVQ's row quantization of one value against its head's bf16 scale
__device__ int8_t quantize(float x, bf16 scale) {
  const float q = rintf(__fdiv_rn(x, fmaxf(bf(scale), 1e-8f)));
  return (int8_t)fminf(fmaxf(q, -127.f), 127.f);
}

template <bool KVQ>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const bf16* __restrict__ qkv, cache_t<KVQ>* __restrict__ ck,
               cache_t<KVQ>* __restrict__ cv, bf16* __restrict__ kvs,
               const uint8_t* __restrict__ kv_valid,
               const float* __restrict__ part_ml,
               const float* __restrict__ part_o, bf16* __restrict__ out,
               int n_chunks, int S, int D, int pos, float scale) {
  __shared__ float red[2];
  const int h = blockIdx.x, r = blockIdx.y, H = gridDim.x;
  const int t = threadIdx.x;
  const int start = row_start(kv_valid, r, S, pos, red);
  const size_t base = ((size_t)r * H + h) * n_chunks;

  float m = NEG;
  for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, part_ml[2 * (base + c)]);
  const bf16 kc = qkv[(size_t)r * 3 * D + D + h * DH + t];
  const bf16 vc = qkv[(size_t)r * 3 * D + 2 * D + h * DH + t];
  const bool cur_valid = start <= pos;
  float s_cur = block_sum(bf(__hmul(scaled_q(qkv, r, D, h, t, scale), kc)), red);
  if (!cur_valid) s_cur = NEG;
  m = fmaxf(m, s_cur);

  float o = 0.f, l = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float w = expf(part_ml[2 * (base + c)] - m);
    o += part_o[(base + c) * DH + t] * w;
    l += part_ml[2 * (base + c) + 1] * w;
  }
  const float p_cur = cur_valid ? expf(s_cur - m) : 0.f;
  l += p_cur;
  o += bf(__float2bfloat16(p_cur)) * bf(vc);
  out[(size_t)r * D + h * DH + t] = __float2bfloat16(o / fmaxf(l, 1e-30f));
  const size_t row = (size_t)r * S + pos;
  if constexpr (KVQ) {
    const bf16 k_scale = __float2bfloat16(__fdiv_rn(block_max(fabsf(bf(kc)), red), 127.f));
    const bf16 v_scale = __float2bfloat16(__fdiv_rn(block_max(fabsf(bf(vc)), red), 127.f));
    ck[row * D + h * DH + t] = quantize(bf(kc), k_scale);
    cv[row * D + h * DH + t] = quantize(bf(vc), v_scale);
    bf16* srow = kvs + row * SCALE_LANES;
    if (t == 0) {
      srow[h] = k_scale;
      srow[SCALE_HALF + h] = v_scale;
    }
    if (h == 0) {  // the lanes no head owns
      for (int lane = H + t; lane < SCALE_HALF; lane += THREADS) {
        srow[lane] = __float2bfloat16(0.f);
        srow[SCALE_HALF + lane] = __float2bfloat16(0.f);
      }
    }
  } else {
    ck[row * D + h * DH + t] = kc;
    cv[row * D + h * DH + t] = vc;
  }
}

template <bool KVQ>
cudaError_t launch(const void* qkv, void* ck, void* cv, void* kvs,
                   const void* kv_valid, const void* anc, void* part_ml,
                   void* part_o, void* out, int M, int S, int D, int H, int pos,
                   int group, float scale, cudaStream_t s) {
  const int n_chunks = (pos + CHUNK - 1) / CHUNK;
  if (n_chunks > 0) {
    split_kernel<KVQ><<<dim3(n_chunks, H, M), THREADS, 0, s>>>(
        static_cast<const bf16*>(qkv), static_cast<const cache_t<KVQ>*>(ck),
        static_cast<const cache_t<KVQ>*>(cv), static_cast<const bf16*>(kvs),
        static_cast<const uint8_t*>(kv_valid), static_cast<const int*>(anc),
        static_cast<float*>(part_ml), static_cast<float*>(part_o), S, D, pos,
        group, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  combine_kernel<KVQ><<<dim3(H, M), THREADS, 0, s>>>(
      static_cast<const bf16*>(qkv), static_cast<cache_t<KVQ>*>(ck),
      static_cast<cache_t<KVQ>*>(cv), static_cast<bf16*>(kvs),
      static_cast<const uint8_t*>(kv_valid), static_cast<const float*>(part_ml),
      static_cast<const float*>(part_o), static_cast<bf16*>(out), n_chunks, S,
      D, pos, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv: (M, 3D) bf16 (q, k, v of the current token); ck, cv: (M, S, D), one
// layer of the cache, written at pos: bf16, or int8 when kvs, the layer's
// (M, S, 256) bf16 scale rows, is not null (KVQ; H <= 128); kv_valid: (M, S)
// bool; anc: (M, S) int32 in-group ancestry or null (group is then 1);
// part_ml: (M, H, chunks, 2) f32 and part_o: (M, H, chunks, Dh) f32
// scratch, chunks = ceil(pos / 64); out: (M, D) bf16. Dh must be 64.
// Returns cudaGetLastError().
extern "C" int decode_attention_launch(const void* qkv, void* ck, void* cv,
                                       void* kvs, const void* kv_valid,
                                       const void* anc, void* part_ml,
                                       void* part_o, void* out, int M, int S,
                                       int D, int H, int pos, int group,
                                       float scale, void* stream) {
  if (M < 1 || H < 1 || D != H * DH || pos < 0 || pos >= S || group < 1 ||
      M % group != 0 || (kvs != nullptr && H > SCALE_HALF))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(kvs != nullptr
                   ? launch<true>(qkv, ck, cv, kvs, kv_valid, anc, part_ml,
                                  part_o, out, M, S, D, H, pos, group, scale, s)
                   : launch<false>(qkv, ck, cv, kvs, kv_valid, anc, part_ml,
                                   part_o, out, M, S, D, H, pos, group, scale,
                                   s));
}
