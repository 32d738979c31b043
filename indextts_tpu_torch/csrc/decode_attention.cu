// K1's attention: one decode token of M = B*K rows against one layer of the
// flat (M, S, D) cache, bf16 or int8 (KVQ), split over the positions
// (flash-decoding) in one launch, with the beam ancestry map read in the
// kernel.
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
//   - softmax statistics (max, sum) in f32 over chunks of 64 positions, each
//     chunk's probabilities taken against that chunk's own max and rounded
//     to bf16 (KVQ: p times the position's v-scale in f32, then rounded; the
//     softmax sum keeps the unscaled p), each p * v product is rounded to
//     bf16, and those are summed in f32; the chunks are merged in ascending
//     order against the row's max, and the f32 sum of the unrounded
//     probabilities divides at the end;
//   - the current token's own k and v enter unquantized as a final term
//     (its p rounded to bf16, times v in f32), and the output o / l is
//     rounded to bf16.
// Valid cached keys of row r are [start_r, pos), start_r = pos + 1 -
// popcount(kv_valid[r]) (the decode mask is left padding plus everything
// generated so far). With the ancestry map (group = K > 1) the key, value and
// scale row of row r at position g come from physical row (r / K) * K +
// anc[r, g]: the raw values are selected before any arithmetic, so the
// result is bit-identical to a physically gathered cache. The kernel also
// writes the current token's k and v into the cache at pos of the row's own
// physical row; KVQ quantizes them as gpt2.py::kv_quantize_flat does: per
// head, scale = bf16(max|x| / 127), q = clip(rint(x / max(scale, 1e-8)),
// -127, 127) with an IEEE division, and one packed bf16 scale row per
// position (k-scales on lanes [0, H), v-scales on [128, 128 + H), zeros
// elsewhere). Only positions < pos are read, so the write races no read.
//
// What bounds it on the H100: it reads each valid cached position's k and v
// once, 2 * D bytes per row and position in bf16 (3.9 MB a layer at the
// main path's 3 rows, pos 300: ~1.2 us at 3.35 TB/s), D bytes plus 4 * H
// scale bytes in int8, and does ~4 flops a byte. But one layer call is a
// few microseconds of work spread over a few hundred (row, head, chunk)
// units: it is bound by latency, the launch and the chain of dependent
// loads (kv_valid and the ancestry map, then the cache rows they select),
// not by bytes. The design, with the launch plan (`ops/decode_step.py::
// attention_plan`: heads a block, chunks a block, cluster size, ring
// stages, shared-memory bytes) passed in:
//   1. One launch a layer call. The grid is (cluster, H / heads, M): a block
//      takes one row, a span of heads and a run of chunks; the blocks of a
//      thread-block cluster (up to 8) split the row's chunks, and the plan
//      takes as few heads a block as keep the whole grid resident at once
//      (three blocks an SM). Each block sends its chunks' (max, sum, o) to the
//      cluster's rank 0 through distributed shared memory (st.async, counted
//      on rank 0's mbarrier: no scratch in device memory, no atomics, no
//      second launch); rank 0 adds the current token, merges the chunks in
//      ascending order and writes the output and the cache row.
//   2. Per-position work done once a block, for all its heads: a block
//      counts its row's valid positions with one pass of 16-byte loads of
//      kv_valid and __popc (no block-wide scan of bytes), and resolves each
//      of its positions' physical row from the ancestry map once, into
//      shared memory.
//   3. Bytes in flight: every thread issues 16-byte cp.async copies of the
//      valid positions' k and v rows of the block's head span (one row is a
//      contiguous 128 * heads bytes in bf16) into a ring of chunk stages in
//      shared memory, all stages at entry, so the block's whole share of the
//      cache is requested before any arithmetic (the ring refills a stage as
//      its chunk is done when a block has more chunks than stages). KVQ's
//      scales are read once per (position, head) into shared memory.
//   4. CUDA cores, 16-byte shared-memory reads: 4 threads score a
//      (position, head), 16 dims each, summed by a butterfly; a warp takes
//      a head's p.v, a lane 8 dims over 16 positions, summed by a butterfly.
// Every f32 sum has a fixed order that depends on the chunk and the head
// alone, never on the plan or on H: two launches give the same bits, and
// K6's shard of 10 heads equals the same heads of an H=20 call.
// Measured on the H100 (PERF.md): about 6.6 us a layer call at the
// main path's shape, whether the cache comes from L2 or HBM, of which 2.7
// us at pos = 0; what remains is the launch and the two dependent round
// trips, which a kernel alone cannot overlap with its predecessor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tma.cuh"  // mbarrier and cluster helpers (sm_90)

namespace {

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
// MISC: red_max and red_sum [warp][head] f32, red_cnt [warp] int, s_cur
// [head] f32, then the mbarrier
constexpr int BAR_OFFSET = (2 * WARPS * MAX_HEADS + WARPS + MAX_HEADS) * 4;
static_assert(BAR_OFFSET % 8 == 0 && BAR_OFFSET + 8 <= MISC, "MISC holds the mbarrier");
constexpr int SMEM_MAX = 227 * 1024;
constexpr float NEG = -1e9f;    // the TPU kernel's mask value
constexpr int SCALE_LANES = 256, SCALE_HALF = 128;  // KVQ's packed scale row
constexpr unsigned FULL = 0xffffffffu;

static_assert(THREADS == 4 * CHUNK, "4 threads score a position");

// the cache's element type: bf16, or int8 for KVQ (int8 -> bf16 is exact)
template <bool KVQ>
using cache_t = typename std::conditional<KVQ, int8_t, bf16>::type;

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

// the number of nonzero bytes of a word
__device__ __forceinline__ int nonzero_bytes(uint32_t w) {
  return __popc((((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u);
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

template <bool KVQ>
__global__ void __launch_bounds__(THREADS, 3)
decode_attention_kernel(const Args a) {
  using T = cache_t<KVQ>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& p = a.p;
  const Layout lay = layout(p, KVQ);
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int rank = blockIdx.x, hb = p.heads, h0 = blockIdx.y * hb, r = blockIdx.z;
  const int S = a.S, D = a.D, pos = a.pos;
  const int n_chunks = (pos + CHUNK - 1) / CHUNK;
  const int c_lo = rank * p.chunks, cnt = max(0, min(p.chunks, n_chunks - c_lo));
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
  int* red_cnt = reinterpret_cast<int*>(red_sum + WARPS * MAX_HEADS);
  float* s_cur = reinterpret_cast<float*>(red_cnt + WARPS);
  unsigned char* bar_ptr = smem + lay.misc + BAR_OFFSET;
  const uint32_t bar = smem_addr(bar_ptr);
  const bool clustered = p.cluster > 1;

  // 0. rank 0's barrier for the peers' partials, initialised before any
  // peer passes the cluster barrier
  if (clustered) {
    if (rank == 0 && t == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_expect_tx(bar, (n_chunks - cnt) * hb * SLOT * 4);
    }
    cluster_arrive();
  }

  // 1. kv_valid's popcount, the physical rows of the block's positions, and
  // q (scaled, rounded), k and v of the current token over the head span
  const int gb = c_lo * CHUNK;
  const int npos = max(0, min(cnt * CHUNK, pos - gb));
  const uint8_t* vrow = a.kv_valid + (size_t)r * S;
  int n_valid = 0;
  if (S % 16 == 0) {
    for (int i = t; i < S / 16; i += THREADS) {
      const uint4 v = reinterpret_cast<const uint4*>(vrow)[i];
      n_valid += nonzero_bytes(v.x) + nonzero_bytes(v.y) + nonzero_bytes(v.z) +
                 nonzero_bytes(v.w);
    }
  } else {
    for (int i = t; i < S; i += THREADS) n_valid += vrow[i] != 0;
  }
  for (int i = t; i < npos; i += THREADS)
    sphys[i] = a.anc ? (r / a.group) * a.group + a.anc[(size_t)r * S + gb + i] : r;
  const int vecs = span / 8;  // 16-byte pieces of q (or k, v) over the span
  for (int i = t; i < 3 * vecs; i += THREADS) {
    const int which = i / vecs, k8 = 8 * (i - which * vecs);
    uint4 v = *reinterpret_cast<const uint4*>(a.qkv + (size_t)r * 3 * D + which * D + h0 * DH +
                                              k8);
    if (which == 0) {
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(bf(e[j]) * a.scale);
    }
    *reinterpret_cast<uint4*>((which == 0 ? sq : which == 1 ? skc : svc) + k8) = v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n_valid += __shfl_xor_sync(FULL, n_valid, o);
  if (lane == 0) red_cnt[warp] = n_valid;
  __syncthreads();
  n_valid = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) n_valid += red_cnt[w];
  const int start = pos + 1 - n_valid;

  // 2. the block's k / v rows into the ring, all stages at once: chunk i of
  // the block into stage i % stages, its valid positions only, 16-byte
  // pieces, neighbouring threads on neighbouring bytes of a row
  const int pieces = span * (int)sizeof(T) / 16;  // of a k (or v) row
  const int stage_elems = lay.stage / (int)sizeof(T) / 2;
  auto stage_k = [&](int s) { return reinterpret_cast<T*>(smem + lay.stage * s); };
  auto valid_range = [&](int i, int& lo, int& hi) {  // chunk i's valid positions, local
    const int g0 = (c_lo + i) * CHUNK;
    lo = max(start, g0) - g0;
    hi = min(pos, g0 + CHUNK) - g0;
  };
  auto issue = [&](int i) {
    int lo, hi;
    valid_range(i, lo, hi);
    T* sk = stage_k(i % p.stages);
    const int per_kv = max(0, hi - lo) * pieces;
    for (int u = t; u < 2 * per_kv; u += THREADS) {
      const int kv = u >= per_kv, rest = u - kv * per_kv;
      const int pp = lo + rest / pieces, w = rest % pieces;
      const int g = (c_lo + i) * CHUNK + pp;
      const size_t src = ((size_t)sphys[i * CHUNK + pp] * S + g) * D + h0 * DH;
      const int off = pp * span + w * (16 / (int)sizeof(T));
      cp_async16(sk + kv * stage_elems + off, (kv ? cv : ck) + src + w * (16 / sizeof(T)));
    }
    cp_async_commit();
  };
  for (int s = 0; s < p.stages; ++s) {
    if (s < cnt)
      issue(s);
    else
      cp_async_commit();
  }
  if (KVQ)
    for (int u = t; u < npos * hb; u += THREADS) {
      const int i = u / hb, j = u - i * hb, g = gb + i;
      if (g < start) continue;
      const bf16* srow = a.kvs + ((size_t)sphys[i] * S + g) * SCALE_LANES;
      scales[2 * u] = srow[h0 + j];
      scales[2 * u + 1] = srow[SCALE_HALF + h0 + j];
    }

  // 3. the block's chunks in order, each to its (max, sum, o) per head
  for (int i = 0; i < cnt; ++i) {
    cp_async_wait(p.stages - 1);
    __syncthreads();
    int lo, hi;
    valid_range(i, lo, hi);
    float* slot = slots + (size_t)(c_lo + i) * hb * SLOT;
    const T* sk = stage_k(i % p.stages);
    const T* sv = sk + stage_elems;
    if (lo >= hi) {  // no valid position: m = NEG, l = 0, o = 0
      for (int u = t; u < hb * SLOT; u += THREADS) slot[u] = u % SLOT == 0 ? NEG : 0.f;
    } else {
      // scores: thread t is position t / 4, quarter t % 4 of the 64 dims
      const int pp = t / 4, qq = t % 4;
      const bool valid = pp >= lo && pp < hi;
      float sc[MAX_HEADS];
#pragma unroll
      for (int j = 0; j < MAX_HEADS; ++j) {
        if (j >= hb) break;
        float s = valid ? dot16(sk + pp * span + j * DH + 16 * qq, sq + j * DH + 16 * qq) : 0.f;
        s += __shfl_xor_sync(FULL, s, 1);
        s += __shfl_xor_sync(FULL, s, 2);
        if (KVQ && valid) s *= bf(scales[2 * ((i * CHUNK + pp) * hb + j)]);
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
        for (int q = max(lo, 16 * pq); q < q1; ++q)
          pv8(o, sv + q * span + j * DH + 8 * dg, sp[j * CHUNK + q]);
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
    if (qq == 0 && j < hb) s_cur[j] = start <= pos ? s : NEG;
  }
  // the cache row at pos of the row's own physical row (KVQ: quantized per head)
  const size_t row = (size_t)r * S + pos;
  if constexpr (KVQ) {
    int8_t* qk = static_cast<int8_t*>(a.ck) + row * D + h0 * DH;
    int8_t* qv = static_cast<int8_t*>(a.cv) + row * D + h0 * DH;
    bf16* srow = a.kvs + row * SCALE_LANES;
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
      for (int lane_ = a.H + t; lane_ < SCALE_HALF; lane_ += THREADS) {
        srow[lane_] = __float2bfloat16(0.f);
        srow[SCALE_HALF + lane_] = __float2bfloat16(0.f);
      }
  } else {
    for (int i = t; i < 2 * vecs; i += THREADS) {
      const int which = i / vecs, k8 = 8 * (i - which * vecs);
      bf16* dst = static_cast<bf16*>(which ? a.cv : a.ck) + row * D + h0 * DH + k8;
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>((which ? svc : skc) + k8);
    }
  }
  if (clustered) mbar_wait(bar, 0);
  __syncthreads();

  // 6. the merge: thread (head, dim); chunks in ascending order, then the
  // current token
  const bool cur_valid = start <= pos;
  for (int u = t; u < span; u += THREADS) {
    const int j = u / DH, d = u % DH;
    const float sc = s_cur[j];
    float m = NEG;
    for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, slots[(c * hb + j) * SLOT]);
    m = fmaxf(m, sc);
    float o = 0.f, l = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const float* s = slots + (c * hb + j) * SLOT;
      const float w = expf(s[0] - m);
      o += s[4 + d] * w;
      l += s[1] * w;
    }
    const float p_cur = cur_valid ? expf(sc - m) : 0.f;
    l += p_cur;
    o += bf(__float2bfloat16(p_cur)) * bf(svc[u]);
    a.out[(size_t)r * D + h0 * DH + u] = __float2bfloat16(o / fmaxf(l, 1e-30f));
  }
}

// The dynamic shared-memory limit is raised once per device for each
// instantiation, at its first launch outside a graph capture.
template <bool KVQ>
cudaError_t launch(const Args& a, int smem, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<KVQ>;
  static unsigned raised = 0;  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024 && dev < 32 && !(raised >> dev & 1u)) {
    cudaStreamCaptureStatus cap = cudaStreamCaptureStatusNone;
    err = cudaStreamIsCapturing(stream, &cap);
    if (err != cudaSuccess) return err;
    if (cap != cudaStreamCaptureStatusNone) return cudaErrorStreamCaptureUnsupported;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    raised |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.p.cluster, a.H / a.p.heads, a.M);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.p.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// qkv: (M, 3D) bf16 (q, k, v of the current token); ck, cv: (M, S, D), one
// layer of the cache, written at pos: bf16, or int8 when kvs, the layer's
// (M, S, 256) bf16 scale rows, is not null (KVQ; H <= 128); kv_valid: (M, S)
// bool; anc: (M, S) int32 in-group ancestry or null (group is then 1);
// part_ml, part_o: not read (the partials stay in shared memory; null);
// out: (M, D) bf16. Dh must be 64; qkv, ck, cv and kv_valid 16-byte
// aligned. The launch plan (heads, chunks, cluster, stages, smem) is
// ops/decode_step.py::attention_plan's; a plan that does not cover the
// positions or that this entry does not recompute to the same shared-memory
// bytes is refused. Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_launch(const void* qkv, void* ck, void* cv,
                                       void* kvs, const void* kv_valid,
                                       const void* anc, void* part_ml,
                                       void* part_o, void* out, int M, int S,
                                       int D, int H, int pos, int group,
                                       float scale, int heads, int chunks,
                                       int cluster, int stages, int smem,
                                       void* stream) {
  (void)part_ml;
  (void)part_o;
  const bool kvq = kvs != nullptr;
  const int n_chunks = (pos + CHUNK - 1) / CHUNK;
  if (M < 1 || H < 1 || D != H * DH || pos < 0 || pos >= S || group < 1 ||
      M % group != 0 || (kvq && H > SCALE_HALF) || heads < 1 || heads > MAX_HEADS ||
      H % heads != 0 || chunks < 1 || cluster < 1 || cluster > MAX_CLUSTER ||
      cluster != (n_chunks > 0 ? (n_chunks + chunks - 1) / chunks : 1) || stages < 1 ||
      stages > MAX_STAGES || stages > chunks || !aligned16(qkv) || !aligned16(ck) ||
      !aligned16(cv) || !aligned16(kv_valid))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(qkv), ck, cv, static_cast<bf16*>(kvs),
         static_cast<const uint8_t*>(kv_valid), static_cast<const int*>(anc),
         static_cast<bf16*>(out), M, S, D, H, pos, group, scale,
         Plan{heads, chunks, cluster, stages}};
  if (layout(a.p, kvq).smem != smem || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(kvq ? launch<true>(a, smem, s) : launch<false>(a, smem, s));
}
