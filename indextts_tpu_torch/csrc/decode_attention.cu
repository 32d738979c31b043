// K1's attention: one decode token of M = B*K rows against the flat bf16
// (M, S, D) cache of one layer, split over the positions (flash-decoding),
// with the beam ancestry map read in the kernel.
//
// Replaces the attention inside the TPU kernel indextts_tpu/ops/pallas/
// decode_step.py::fused_decode_step (lines 257-419 there); the projections
// around it are int8_gemv.cu. Same rounding chain as the TPU kernel:
//   - q is scaled by 1/sqrt(Dh) in f32 and rounded to bf16;
//   - each product k_d * q_d is rounded to bf16, and a head's products are
//     summed in f32;
//   - softmax statistics (max, sum) in f32; the probabilities are rounded to
//     bf16, each p * v product is rounded to bf16, and those are summed in
//     f32; the f32 sum of the unrounded probabilities divides at the end;
//   - the current token's own k and v enter as a final term (its p rounded
//     to bf16, times v in f32), and the output o / l is rounded to bf16.
// Valid cached keys of row r are [start_r, pos), start_r = pos + 1 -
// popcount(kv_valid[r]) (the decode mask is left padding plus everything
// generated so far). With the ancestry map (group = K > 1) the key and value
// of row r at position g come from physical row (r / K) * K + anc[r, g]: the
// raw bf16 values are selected before any arithmetic, so the result is
// bit-identical to a physically gathered cache. The combine pass writes the
// current token's k and v into the cache at pos of the row's own physical
// row.
//
// What bounds it on the H100: it reads each valid cached position's k and v
// once, 2 * 2 * D bytes per row and position (a few MB a layer), and does
// ~4 flops per byte: memory bound. Only M * H (60 on the main path)
// (row, head) pairs exist, so the position axis is split into chunks of
// CHUNK positions: grid (chunks, H, M) of 64-thread blocks. In a block, thread
// t scores position chunk0 + t (its k row is 128 contiguous bytes), the
// chunk's max and sum are block reductions, and thread d then sums the
// p * v products of dim d over the chunk (neighbouring threads read
// neighbouring bytes of each v row). The combine kernel (grid (H, M)) merges
// the chunks' (max, sum, o) in a fixed order, adds the current token, and
// writes the output and the cache row: no atomics, so results repeat
// exactly. Later work: one persistent kernel for the whole step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int DH = 64;        // head dim
constexpr int CHUNK = 64;     // positions per split block
constexpr int THREADS = 64;   // == DH == CHUNK
constexpr float NEG = -1e9f;  // the TPU kernel's mask value

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

__global__ void __launch_bounds__(THREADS)
split_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ ck,
             const bf16* __restrict__ cv, const uint8_t* __restrict__ kv_valid,
             const int* __restrict__ anc, float* __restrict__ part_ml,
             float* __restrict__ part_o, int S, int D, int pos, int group,
             float scale) {
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

  // score of position g: sum_d f32(bf16(k_d * q_d))
  float s = NEG;
  if (valid) {
    const uint4* kp = reinterpret_cast<const uint4*>(ck + ((size_t)phys * S + g) * D + h * DH);
    const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(sq);
    float acc = 0.f;
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
    s = acc;
  }
  const float m = block_max(s, red);
  const float p = valid ? expf(s - m) : 0.f;
  const float l = block_sum(p, red);
  sp[t] = __float2bfloat16(p);
  __syncthreads();

  // thread t is now dim t: o_t = sum_g f32(bf16(bf16(p_g) * v_g,t))
  float o = 0.f;
  const int g0 = c * CHUNK;
  const int g1 = min(g0 + CHUNK, pos);
  for (int gg = max(g0, start); gg < g1; ++gg) {
    const int i = gg - g0;
    const bf16 v = cv[((size_t)sphys[i] * S + gg) * D + h * DH + t];
    o += bf(__hmul(sp[i], v));
  }
  const size_t pi = ((size_t)r * H + h) * n_chunks + c;
  part_o[pi * DH + t] = o;
  if (t == 0) {
    part_ml[2 * pi] = m;
    part_ml[2 * pi + 1] = l;
  }
}

__global__ void __launch_bounds__(THREADS)
combine_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ck,
               bf16* __restrict__ cv, const uint8_t* __restrict__ kv_valid,
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
  ck[((size_t)r * S + pos) * D + h * DH + t] = kc;
  cv[((size_t)r * S + pos) * D + h * DH + t] = vc;
}

}  // namespace

// qkv: (M, 3D) bf16 (q, k, v of the current token); ck, cv: (M, S, D) bf16,
// one layer of the cache, written at pos; kv_valid: (M, S) bool; anc: (M, S)
// int32 in-group ancestry or null (group is then 1); part_ml: (M, H, chunks,
// 2) f32 and part_o: (M, H, chunks, Dh) f32 scratch, chunks = ceil(pos /
// 64); out: (M, D) bf16. Dh must be 64. Returns cudaGetLastError().
extern "C" int decode_attention_launch(const void* qkv, void* ck, void* cv,
                                       const void* kv_valid, const void* anc,
                                       void* part_ml, void* part_o, void* out,
                                       int M, int S, int D, int H, int pos,
                                       int group, float scale, void* stream) {
  if (M < 1 || H < 1 || D != H * DH || pos < 0 || pos >= S || group < 1 ||
      M % group != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (pos + CHUNK - 1) / CHUNK;
  if (n_chunks > 0) {
    split_kernel<<<dim3(n_chunks, H, M), THREADS, 0, s>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(ck),
        static_cast<const bf16*>(cv), static_cast<const uint8_t*>(kv_valid),
        static_cast<const int*>(anc), static_cast<float*>(part_ml),
        static_cast<float*>(part_o), S, D, pos, group, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  combine_kernel<<<dim3(H, M), THREADS, 0, s>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(ck),
      static_cast<bf16*>(cv), static_cast<const uint8_t*>(kv_valid),
      static_cast<const float*>(part_ml), static_cast<const float*>(part_o),
      static_cast<bf16*>(out), n_chunks, S, D, pos, scale);
  return (int)cudaGetLastError();
}
