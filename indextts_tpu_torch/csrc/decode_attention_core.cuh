// The arithmetic of K1's attention, shared by the standalone kernel
// (decode_attention.cu: one launch a layer call, in K1's chain and K6) and
// the persistent decode step (decode_step.cu: K1). `attend` is one (row,
// head span) unit on one block of a cluster: decode_attention.cu's header
// says what it computes and why it is built so. Every f32 sum's order
// depends on the chunk and the head alone, so both kernels give the same
// bits; the merge's products are written as explicit FMAs (__fmaf_rn), so
// that no compiler choice to fuse them or not can tell the two apart.
//
// The cache's element type: bf16, int8 (KVQ), or, in the persistent step
// at E = fp16, fp16. An fp16 element is rounded to bf16 where it is read
// from the ring (after the copy: cp.async moves bytes), before the score
// and p.v, and the token's k / v rows are written back at fp16; so the fp16
// cache gives the bits of the bf16 cache holding its values rounded to bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tma.cuh"  // mbarrier and cluster helpers (sm_90)

namespace dattn {

using bf16 = __nv_bfloat16;
using attn_tma::cluster_arrive;
using attn_tma::cluster_wait;
using attn_tma::mbar_expect_tx;
using attn_tma::mbar_init;
using attn_tma::mbar_wait;
using attn_tma::rank0_addr;
using attn_tma::smem_addr;
using attn_tma::store_to_rank0;

constexpr int DH = 64;          // head dim
constexpr int CHUNK = 64;       // positions a chunk: the rounding unit
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_HEADS = 8;    // heads a block (one warp each for p.v)
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int MAX_STAGES = 4;
constexpr int SLOT = 68;        // floats of a (chunk, head) partial: m, l, 2 pad, o[64]
constexpr int MISC = 1024;      // reductions, the current scores, the mbarrier
// MISC: red_max and red_sum [warp][head] f32, s_cur [head] f32, then the
// mbarrier
constexpr int BAR_OFFSET = (2 * WARPS * MAX_HEADS + MAX_HEADS) * 4;
static_assert(BAR_OFFSET % 8 == 0 && BAR_OFFSET + 8 <= MISC, "MISC holds the mbarrier");
constexpr int SMEM_MAX = 227 * 1024;
constexpr float NEG = -1e9f;    // the TPU kernel's mask value
constexpr int SCALE_LANES = 256, SCALE_HALF = 128;  // KVQ's packed scale row
constexpr unsigned FULL = 0xffffffffu;

static_assert(THREADS == 4 * CHUNK, "4 threads score a position");

// the cache's element type: E (bf16 or fp16), or int8 for KVQ (int8 -> bf16
// is exact)
template <bool KVQ, typename E = bf16>
using cache_t = typename std::conditional<KVQ, int8_t, E>::type;

struct Plan {
  int heads, chunks, cluster, stages;  // as ops/decode_step.py::attention_plan
};

// Byte offsets of the shared-memory layout; the same formula as
// ops/decode_step.py::_attention_smem: the ring of chunk stages (k then v
// rows of the head span), the cluster's partials (rank 0 gathers every
// chunk's), KVQ's (k, v) scales of the block's positions, their physical
// rows, q / k / v of the current token and the chunk's p (heads x 64 bf16
// each), and MISC. `stage` is the bytes of one stage (the ring starts at 0),
// the others offsets.
struct Layout {
  int stage, slots, scales, phys, vec, misc, smem;
};

__host__ __device__ inline Layout layout(const Plan& p, bool kvq) {
  Layout l;
  l.stage = 2 * CHUNK * p.heads * DH * (kvq ? 1 : 2);
  l.slots = p.stages * l.stage;
  l.scales = l.slots + p.cluster * p.chunks * p.heads * SLOT * 4;
  l.phys = l.scales + (kvq ? p.chunks * CHUNK * p.heads * 4 : 0);
  l.vec = l.phys + p.chunks * CHUNK * 4;
  l.misc = l.vec + 4 * p.heads * DH * 2;
  l.smem = l.misc + MISC;
  return l;
}

struct Args {
  const bf16* qkv;
  void* ck;
  void* cv;
  bf16* kvs;
  const uint8_t* kv_valid;
  const int* anc;
  bf16* out;
  int M, S, D, H, pos, group;
  float scale;
  Plan p;
};

__device__ __forceinline__ float bf(const bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most n of this thread's copy groups are still in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
}

// sum_d f32(bf16(k_d * q_d)) over 16 dims in ascending order
__device__ __forceinline__ float dot16(const bf16* k, const bf16* q) {
  uint4 kv[2] = {reinterpret_cast<const uint4*>(k)[0], reinterpret_cast<const uint4*>(k)[1]};
  uint4 qv[2] = {reinterpret_cast<const uint4*>(q)[0], reinterpret_cast<const uint4*>(q)[1]};
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(kv);
  const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(qv);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float2 prod = __bfloat1622float2(__hmul2(k2[e], q2[e]));
    acc += prod.x;
    acc += prod.y;
  }
  return acc;
}

// the same on fp16 k, each element rounded to bf16 first
__device__ __forceinline__ float dot16(const __half* k, const bf16* q) {
  const uint4 kb[2] = {attn_tma::to_bf16x8<__half>(reinterpret_cast<const uint4*>(k)[0]),
                       attn_tma::to_bf16x8<__half>(reinterpret_cast<const uint4*>(k)[1])};
  return dot16(reinterpret_cast<const bf16*>(kb), q);
}

__device__ __forceinline__ float dot16(const int8_t* k, const bf16* q) {
  const uint4 kv = *reinterpret_cast<const uint4*>(k);
  uint4 qv[2] = {reinterpret_cast<const uint4*>(q)[0], reinterpret_cast<const uint4*>(q)[1]};
  const int8_t* kb = reinterpret_cast<const int8_t*>(&kv);
  const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(qv);
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const __nv_bfloat162 k2 = __floats2bfloat162_rn((float)kb[2 * e], (float)kb[2 * e + 1]);
    const float2 prod = __bfloat1622float2(__hmul2(k2, q2[e]));
    acc += prod.x;
    acc += prod.y;
  }
  return acc;
}

// o[e] += f32(bf16(p * v_e)) for 8 dims of one position
__device__ __forceinline__ void pv8(float (&o)[8], const bf16* v, bf16 p) {
  const uint4 vv = *reinterpret_cast<const uint4*>(v);
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&vv);
  const __nv_bfloat162 pp = __halves2bfloat162(p, p);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 prod = __bfloat1622float2(__hmul2(pp, v2[e]));
    o[2 * e] += prod.x;
    o[2 * e + 1] += prod.y;
  }
}

// the same on fp16 v, each element rounded to bf16 first
__device__ __forceinline__ void pv8(float (&o)[8], const __half* v, bf16 p) {
  const uint4 vb = attn_tma::to_bf16x8<__half>(*reinterpret_cast<const uint4*>(v));
  pv8(o, reinterpret_cast<const bf16*>(&vb), p);
}

__device__ __forceinline__ void pv8(float (&o)[8], const int8_t* v, bf16 p) {
  const uint2 vv = *reinterpret_cast<const uint2*>(v);
  const int8_t* vb = reinterpret_cast<const int8_t*>(&vv);
  const __nv_bfloat162 pp = __halves2bfloat162(p, p);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 v2 = __floats2bfloat162_rn((float)vb[2 * e], (float)vb[2 * e + 1]);
    const float2 prod = __bfloat1622float2(__hmul2(pp, v2));
    o[2 * e] += prod.x;
    o[2 * e + 1] += prod.y;
  }
}

// KVQ's row quantization of one value against its head's bf16 scale
__device__ __forceinline__ int8_t quantize(float x, bf16 scale) {
  const float q = rintf(__fdiv_rn(x, fmaxf(bf(scale), 1e-8f)));
  return (int8_t)fminf(fmaxf(q, -127.f), 127.f);
}

// One (row r, head span [h0, h0 + heads)) unit of K1's attention on one
// block of a thread-block cluster of p.cluster ranks (the block takes the
// chunks of run ``run``: [run * p.chunks, ...); the standalone kernel's
// run is its rank), over the layer's cache in ``a``: steps 1-6 of the
// header, in the shared memory at ``smem`` (the `layout`; its mbarrier slot
// is unused). The caller has armed rank 0's mbarrier at ``bar_ptr`` (the
// same offset in every rank's shared memory) for the peers' partials and
// arrived on the cluster barrier (step 0); rank 0 waits on it at
// ``parity``. Peers return after sending their partials; rank 0 writes the
// output and the cache row at pos. E: the element type of the non-KVQ
// cache (the k / v rows are computed in bf16 and written at E).
template <bool KVQ, typename E = bf16>
__device__ __forceinline__ void attend(const Args& a, unsigned char* smem,
                                       unsigned char* bar_ptr, int rank, int run, int h0,
                                       int r, uint32_t parity) {
  using T = cache_t<KVQ, E>;
  const Plan& p = a.p;
  const Layout lay = layout(p, KVQ);
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int hb = p.heads;
  const int S = a.S, D = a.D, pos = a.pos;
  const int n_chunks = (pos + CHUNK - 1) / CHUNK;
  const int c_lo = run * p.chunks, cnt = max(0, min(p.chunks, n_chunks - c_lo));
  const int span = hb * DH;  // elements of a position's k (or v) row in the head span
  const T* ck = static_cast<const T*>(a.ck);
  const T* cv = static_cast<const T*>(a.cv);
  float* slots = reinterpret_cast<float*>(smem + lay.slots);  // [chunk][head][SLOT]
  bf16* scales = reinterpret_cast<bf16*>(smem + lay.scales);  // [position][head][k, v]
  int* sphys = reinterpret_cast<int*>(smem + lay.phys);
  bf16* sq = reinterpret_cast<bf16*>(smem + lay.vec);
  bf16* skc = sq + span;
  bf16* svc = skc + span;
  bf16* sp = svc + span;  // [head][position] of the chunk
  float* red_max = reinterpret_cast<float*>(smem + lay.misc);  // [warp][head]
  float* red_sum = red_max + WARPS * MAX_HEADS;
  float* s_cur = red_sum + WARPS * MAX_HEADS;
  const uint32_t bar = smem_addr(bar_ptr);
  const bool clustered = p.cluster > 1;

  // 1. the physical row of each of the block's positions, or -1 where that
  // row's kv_valid does not mark the position (the block attends exactly
  // the marked slots, whatever their layout); q (scaled, rounded), k and v
  // of the current token over the head span
  const int gb = c_lo * CHUNK;
  const int npos = max(0, min(cnt * CHUNK, pos - gb));
#pragma unroll 1
  for (int i = t; i < npos; i += THREADS) {
    const int ph = a.anc ? (r / a.group) * a.group + a.anc[(size_t)r * S + gb + i] : r;
    sphys[i] = a.kv_valid[(size_t)ph * S + gb + i] ? ph : -1;
  }
  const int vecs = span / 8;  // 16-byte pieces of q (or k, v) over the span
#pragma unroll 1
  for (int i = t; i < 3 * vecs; i += THREADS) {
    const int which = i / vecs, k8 = 8 * (i - which * vecs);
    uint4 v = __ldcg(reinterpret_cast<const uint4*>(a.qkv + (size_t)r * 3 * D + which * D +
                                                    h0 * DH + k8));
    if (which == 0) {
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(bf(e[j]) * a.scale);
    }
    *reinterpret_cast<uint4*>((which == 0 ? sq : which == 1 ? skc : svc) + k8) = v;
  }
  const int ph_cur = a.anc ? (r / a.group) * a.group + a.anc[(size_t)r * S + pos] : r;
  const bool cur_valid = a.kv_valid[(size_t)ph_cur * S + pos] != 0;
  __syncthreads();

  // 2. the block's k / v rows into the ring, all stages at once: chunk i of
  // the block into stage i % stages, its valid positions only, 16-byte
  // pieces, neighbouring threads on neighbouring bytes of a row
  const int pieces = span * (int)sizeof(T) / 16;  // of a k (or v) row
  const int stage_elems = lay.stage / (int)sizeof(T) / 2;
  auto stage_k = [&](int s) { return reinterpret_cast<T*>(smem + lay.stage * s); };
  auto chunk_end = [&](int i) {  // chunk i's positions below pos, local
    const int g0 = (c_lo + i) * CHUNK;
    return min(pos, g0 + CHUNK) - g0;
  };
  auto issue = [&](int i) {
    const int hi = chunk_end(i);
    T* sk = stage_k(i % p.stages);
    const int per_kv = hi * pieces;
    for (int u = t; u < 2 * per_kv; u += THREADS) {
      const int kv = u >= per_kv, rest = u - kv * per_kv;
      const int pp = rest / pieces, w = rest % pieces;
      const int ph = sphys[i * CHUNK + pp];
      if (ph < 0) continue;
      const int g = (c_lo + i) * CHUNK + pp;
      const size_t src = ((size_t)ph * S + g) * D + h0 * DH;
      const int off = pp * span + w * (16 / (int)sizeof(T));
      cp_async16(sk + kv * stage_elems + off, (kv ? cv : ck) + src + w * (16 / sizeof(T)));
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int s = 0; s < p.stages; ++s) {
    if (s < cnt)
      issue(s);
    else
      cp_async_commit();
  }
  if (KVQ)
#pragma unroll 1
    for (int u = t; u < npos * hb; u += THREADS) {
      const int i = u / hb, j = u - i * hb, g = gb + i;
      if (sphys[i] < 0) continue;
      const bf16* srow = a.kvs + ((size_t)sphys[i] * S + g) * SCALE_LANES;
      scales[2 * u] = srow[h0 + j];
      scales[2 * u + 1] = srow[SCALE_HALF + h0 + j];
    }

  // 3. the block's chunks in order, each to its (max, sum, o) per head
#pragma unroll 1
  for (int i = 0; i < cnt; ++i) {
    cp_async_wait(p.stages - 1);
    __syncthreads();
    const int hi = chunk_end(i);
    const int* cphys = sphys + i * CHUNK;  // -1: not attended
    float* slot = slots + (size_t)(c_lo + i) * hb * SLOT;
    const T* sk = stage_k(i % p.stages);
    const T* sv = sk + stage_elems;
    {
      // scores: thread t is position t / 4, quarter t % 4 of the 64 dims (a
      // chunk without a valid position ends with m = NEG, l = 0, o = 0)
      const int pp = t / 4, qq = t % 4;
      const bool valid = pp < hi && cphys[pp] >= 0;
      float sc[MAX_HEADS];
#pragma unroll
      for (int j = 0; j < MAX_HEADS; ++j) {
        if (j >= hb) break;
        float s = valid ? dot16(sk + pp * span + j * DH + 16 * qq, sq + j * DH + 16 * qq) : 0.f;
        s += __shfl_xor_sync(FULL, s, 1);
        s += __shfl_xor_sync(FULL, s, 2);
        if (KVQ && valid) s = __fmul_rn(s, bf(scales[2 * ((i * CHUNK + pp) * hb + j)]));
        sc[j] = valid ? s : NEG;
        float m = sc[j];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
        if (lane == 0) red_max[warp * MAX_HEADS + j] = m;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < MAX_HEADS; ++j) {
        if (j >= hb) break;
        float m = red_max[j];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red_max[w * MAX_HEADS + j]);
        const float pr = valid ? expf(sc[j] - m) : 0.f;
        float l = pr;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) l += __shfl_xor_sync(FULL, l, o);
        if (lane == 0) red_sum[warp * MAX_HEADS + j] = l;
        if (qq == 0) {
          const float v_scale = KVQ && valid ? bf(scales[2 * ((i * CHUNK + pp) * hb + j) + 1])
                                             : 1.f;
          sp[j * CHUNK + pp] = __float2bfloat16(pr * v_scale);
        }
        if (t == 0) slot[j * SLOT] = m;
      }
      __syncthreads();
      // p.v: warp j is head j; lane: dims 8 * (lane % 8), positions
      // [16 q, 16 q + 16) of the chunk, q = lane / 8, then a butterfly
      if (warp < hb) {
        const int j = warp, dg = lane % 8, pq = lane / 8;
        float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        const int q1 = min(hi, 16 * pq + 16);
        for (int q = 16 * pq; q < q1; ++q)
          if (cphys[q] >= 0) pv8(o, sv + q * span + j * DH + 8 * dg, sp[j * CHUNK + q]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          o[e] += __shfl_xor_sync(FULL, o[e], 8);
          o[e] += __shfl_xor_sync(FULL, o[e], 16);
        }
        float* so = slot + j * SLOT + 4 + 8 * dg;
        if (pq == 0) {
          reinterpret_cast<float4*>(so)[0] = make_float4(o[0], o[1], o[2], o[3]);
          reinterpret_cast<float4*>(so)[1] = make_float4(o[4], o[5], o[6], o[7]);
        }
        if (lane == 0) {
          float l = red_sum[j];
#pragma unroll
          for (int w = 1; w < WARPS; ++w) l += red_sum[w * MAX_HEADS + j];
          slot[j * SLOT + 1] = l;
        }
      }
    }
    __syncthreads();  // the stage and the chunk's scratch are free again
    if (i + p.stages < cnt)
      issue(i + p.stages);
    else
      cp_async_commit();
  }

  // 4. the peers' partials into rank 0's slots (16 bytes a store, counted on
  // rank 0's mbarrier); rank 0 goes on
  if (clustered) {
    __syncthreads();
    cluster_wait();
    if (rank != 0) {
      const float* mine = slots + (size_t)c_lo * hb * SLOT;
      const uint32_t dst = rank0_addr(mine), rbar = rank0_addr(bar_ptr);
#pragma unroll 1
      for (int e = t; e < cnt * hb * SLOT / 4; e += THREADS)
        store_to_rank0(dst + 16 * e, reinterpret_cast<const float4*>(mine)[e], rbar);
      return;
    }
  }

  // 5. rank 0: the current token's score per head (warp 0: lane = 4 j + quarter)
  if (warp == 0) {
    const int j = lane / 4, qq = lane % 4;
    float s = j < hb ? dot16(skc + j * DH + 16 * qq, sq + j * DH + 16 * qq) : 0.f;
    s += __shfl_xor_sync(FULL, s, 1);
    s += __shfl_xor_sync(FULL, s, 2);
    if (qq == 0 && j < hb) s_cur[j] = cur_valid ? s : NEG;
  }
  // the cache row at pos of the row's own physical row (KVQ: quantized per head)
  const size_t row = (size_t)r * S + pos;
  if constexpr (KVQ) {
    int8_t* qk = static_cast<int8_t*>(a.ck) + row * D + h0 * DH;
    int8_t* qv = static_cast<int8_t*>(a.cv) + row * D + h0 * DH;
    bf16* srow = a.kvs + row * SCALE_LANES;
#pragma unroll 1
    for (int j = warp; j < hb; j += WARPS) {
      const float k0 = bf(skc[j * DH + 2 * lane]), k1 = bf(skc[j * DH + 2 * lane + 1]);
      const float v0 = bf(svc[j * DH + 2 * lane]), v1 = bf(svc[j * DH + 2 * lane + 1]);
      float km = fmaxf(fabsf(k0), fabsf(k1)), vm = fmaxf(fabsf(v0), fabsf(v1));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        km = fmaxf(km, __shfl_xor_sync(FULL, km, o));
        vm = fmaxf(vm, __shfl_xor_sync(FULL, vm, o));
      }
      const bf16 k_scale = __float2bfloat16(__fdiv_rn(km, 127.f));
      const bf16 v_scale = __float2bfloat16(__fdiv_rn(vm, 127.f));
      qk[j * DH + 2 * lane] = quantize(k0, k_scale);
      qk[j * DH + 2 * lane + 1] = quantize(k1, k_scale);
      qv[j * DH + 2 * lane] = quantize(v0, v_scale);
      qv[j * DH + 2 * lane + 1] = quantize(v1, v_scale);
      if (lane == 0) {
        srow[h0 + j] = k_scale;
        srow[SCALE_HALF + h0 + j] = v_scale;
      }
    }
    if (h0 == 0)  // the lanes no head owns
#pragma unroll 1
      for (int lane_ = a.H + t; lane_ < SCALE_HALF; lane_ += THREADS) {
        srow[lane_] = __float2bfloat16(0.f);
        srow[SCALE_HALF + lane_] = __float2bfloat16(0.f);
      }
  } else {
    for (int i = t; i < 2 * vecs; i += THREADS) {
      const int which = i / vecs, k8 = 8 * (i - which * vecs);
      E* dst = static_cast<E*>(which ? a.cv : a.ck) + row * D + h0 * DH + k8;
      *reinterpret_cast<uint4*>(dst) =
          attn_tma::from_bf16x8<E>(*reinterpret_cast<const uint4*>((which ? svc : skc) + k8));
    }
  }
  if (clustered) mbar_wait(bar, parity);
  __syncthreads();

  // 6. the merge: thread (head, dim); chunks in ascending order, then the
  // current token
#pragma unroll 1
  for (int u = t; u < span; u += THREADS) {
    const int j = u / DH, d = u % DH;
    const float sc = s_cur[j];
    float m = NEG;
#pragma unroll 1
    for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, slots[(c * hb + j) * SLOT]);
    m = fmaxf(m, sc);
    float o = 0.f, l = 0.f;
#pragma unroll 1
    for (int c = 0; c < n_chunks; ++c) {
      const float* s = slots + (c * hb + j) * SLOT;
      const float w = expf(s[0] - m);
      o = __fmaf_rn(s[4 + d], w, o);
      l = __fmaf_rn(s[1], w, l);
    }
    const float p_cur = cur_valid ? expf(sc - m) : 0.f;
    l += p_cur;
    o = __fmaf_rn(bf(__float2bfloat16(p_cur)), bf(svc[u]), o);
    a.out[(size_t)r * D + h0 * DH + u] = __float2bfloat16(o / fmaxf(l, 1e-30f));
  }
}

// The bytes the peers send rank 0 for a unit: every chunk but those of
// rank 0's own run.
__host__ __device__ inline int peer_bytes(const Plan& p, int pos, int run0) {
  const int n_chunks = (pos + CHUNK - 1) / CHUNK;
  const int own = n_chunks - run0 * p.chunks;
  return (n_chunks - (own < 0 ? 0 : own < p.chunks ? own : p.chunks)) * p.heads * SLOT * 4;
}

}  // namespace dattn
