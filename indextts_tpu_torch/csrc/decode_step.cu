// K1: the fused GPT-2 decode step on quantized weights as ONE persistent
// launch for all L layers.
//
// Replaces the TPU kernel indextts_tpu/ops/pallas/decode_step.py::
// fused_decode_step (decode_step.py:460; its one pallas_call over
// grid=(L,), :572-576), in its four configurations (int8 or nibble-packed
// int4 weights, W4; the bf16 or the flat int8 cache, KVQ) at group=1 and
// with the beam ancestry map at group=K. For every layer in turn it
// computes what the port's chain of five launches a layer computes (the
// standalone kernels of int8_gemv.cu and decode_attention.cu):
//   1. ln_1 + qkv GEMV (bias epilogue)           -> qkv (M, 3D)
//   2. attention over the cache + the token, writing the token's k/v row
//      (KVQ: quantized, with its scale row) at pos -> att (M, D)
//   3. out-projection + residual                  -> xb (M, D)
//   4. ln_2 + fc + gelu_new                       -> h (M, F)
//   5. mlp-projection + residual                  -> the next layer's x
// with the same arithmetic: gemv_core.cuh and decode_attention_core.cuh
// hold it for both kernels, every GEMV takes the split of K that
// ops/int8.py::gemv_plan gives that K, and the attention's sums depend on
// the chunk and head alone, so this kernel gives the chain's bits. ln_f
// stays with the caller, as in the TPU kernel's wrapper.
//
// What bounds it on the H100: the weights, read once a step (19.7 MB a
// layer in int8 at D = 1280, 472 MB over 24 layers: 0.14 ms at 3.35
// TB/s), then the cache rows. The chain lost most of its time to fixed
// cost: 120 launches a step, each waiting for the previous kernel to end
// before its first weight byte was asked for. The design is the TPU
// kernel's, carried to this card:
//   1. A persistent grid. One launch of as many thread-block clusters (of
//      `cluster` blocks, the largest split of K: 4 at D = 1280) as the
//      occupancy query says are resident at once (one block an SM: the
//      weight ring takes most of the shared memory). The wrapper refuses a
//      grid the query does not allow. A block walks the layers in a loop;
//      a grid-wide barrier replaces each launch boundary: after qkv, after
//      the attention, after the out-projection, after fc and after the
//      mlp-projection (5 L - 1 a step).
//   2. The barrier, as cooperative groups' grid sync builds it: each
//      block's thread 0, after a __syncthreads, adds to an arrival word at
//      gpu scope (release; block 0 adds 2^31 - (blocks - 1), the others 1,
//      so the word's top bit flips when the last arrives and its low bits
//      return to 0) and spins on the top bit (acquire), then a second
//      __syncthreads. (One arrival a cluster, after a cluster barrier,
//      measured slower on the H100: PERF.md.) The word needs no reset
//      between launches (a CUDA graph of the step replays as is); a second
//      word counts the barriers for the caller. A spin that lasts 2^32 cycles (~2 s) traps: a grid that is
//      not co-resident fails with a launch error instead of hanging.
//      Activations cross blocks only through device memory, written with
//      generic stores and read after the barrier through L2 (ld.global.cg);
//      the weights are read-only and the cache rows a layer reads (< pos)
//      are not written in the launch.
//   3. The TPU kernel's cross-layer prefetch. No weight depends on an
//      activation, so each block streams its weight tiles (16 rows x one
//      split's span, <= 20 KB int8, <= 10 KB int4) through a ring of
//      `slots` shared-memory slots with TMA bulk copies (cp.async.bulk, one
//      mbarrier a slot), in the order it will consume them across phases
//      and layers: a slot is refilled as soon as its tile's products are
//      done, so when a block arrives at a barrier its tiles of the next
//      phase (at a layer's end, the next layer's qkv tiles) are in flight.
//      A phase's 16-row tiles go round-robin over the blocks, rotated by
//      the tiles handed out before, so that every block streams the same
//      share of a layer; a phase whose K is split takes one tile a cluster,
//      its ranks each one span, summed on rank 0 through distributed
//      shared memory as in int8_gemv.cu. The block's last warp issues the
//      refills while the others run the epilogue.
//   4. The attention phase: a (row, head span) unit a cluster, its chunks
//      split over the cluster's ranks and merged on rank 0 in ascending
//      order, as decode_attention.cu does over its own cluster (rank 0,
//      which merges, takes the last and shortest run of chunks); the units
//      go round-robin over the clusters (`heads` a unit: the fewest rounds,
//      then the fewest heads). Its shared memory is a union with the GEMV
//      phases' x staging; the ring and the mbarriers stay outside it.
//   5. Small operands off the critical path: the layer table (the weights'
//      pointers) is copied into shared memory at entry, and each layer's
//      LayerNorm vectors arrive by TMA into shared memory a layer ahead.
//   6. Few instructions: a layer's five phases run in a loop that is not
//      unrolled, so each phase's code exists once and stays in the
//      instruction cache (four inlined copies of the GEMV phase measured
//      slower, PERF.md section 6).
// The plan (ops/decode_step.py::step_plan: cluster, blocks, ring slots,
// the GEMVs' split and span for K = D and K = F, the attention's heads,
// chunks a rank and stages) is passed in; this side recomputes the layout
// and refuses a plan whose shared-memory bytes it does not reproduce.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_attention_core.cuh"
#include "gemv_core.cuh"

namespace {

using bf16 = __nv_bfloat16;
using attn_tma::cluster_wait;
using attn_tma::mbar_expect_tx;
using attn_tma::mbar_init;
using attn_tma::mbar_wait;
using attn_tma::smem_addr;

constexpr int THREADS = gemv::THREADS;
constexpr int WARPS = gemv::WARPS;
constexpr int MAXM = gemv::MAXM;
constexpr int CB = gemv::CB;
constexpr int SMEM_MAX = gemv::SMEM_MAX;
constexpr int MAX_SLOTS = 16;        // weight slots of the ring
constexpr int MAX_CLUSTER = 8;
constexpr int MISC = 256;            // the mbarriers: the ring's, the split's, the attention's
constexpr int ATTN_REGION = 80 * 1024;  // the attention phase's shared memory, at least
constexpr int PHASES = 4;            // GEMV phases: qkv, attn-proj, fc, mlp-proj
constexpr int STEPS = 5;             // a layer's phases: the GEMVs' and the attention
constexpr int MARKS = 34;            // trace stamps a layer and block (see the layer loop)
constexpr int MAX_TILES = 4;         // a GEMV phase's tiles a block takes together
constexpr int MAX_LAYERS = 32;       // the layer table's room in shared memory

static_assert(THREADS == dattn::THREADS, "one block shape for both phases");
static_assert((MAX_SLOTS + 4) * 8 <= MISC, "MISC holds the mbarriers");

// One layer's weights (device pointers), by GEMV phase; the wrapper's
// table is (L, 16) of these 8-byte words.
struct Layer {
  const int8_t* q[PHASES];
  const float* scale[PHASES];
  const bf16* bias[PHASES];
  const bf16* ln[4];  // ln_1 weight, bias; ln_2 weight, bias
};
static_assert(sizeof(Layer) == 16 * 8, "the wrapper's table layout");

struct Plan {
  int cluster, blocks, slots;            // as ops/decode_step.py::step_plan
  int split_d, span_d, split_f, span_f;  // the GEMVs' split of K = D and K = F
  int heads, chunks, stages;             // the attention's plan at pos
  // derived by `layout`
  int nt, slot_bytes, region, region_off, misc_off, ln_off, smem;
};

// Shared memory: [slots x slot_bytes: the weight ring][region: the GEMV
// phases' x, LayerNorm vectors, warp / peer sums and row statistics, or
// the attention's layout][MISC: mbarriers][the layer table, MAX_LAYERS x
// 128 bytes][the LayerNorm vectors: ln_1 weight, bias, ln_2 weight, bias,
// D bf16 each]. The same formula as ops/decode_step.py::_step_layout.
__host__ __device__ inline int gemv_region(int M, int span, int cluster, int nt) {
  return M * gemv::x_stride(span) + 2 * span * 2 +
         (WARPS + cluster - 1) * MAX_TILES * nt * 32 * 4 * 4 + 2 * MAXM * 4;
}

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline void layout(Plan& p, int M, int D, int F, bool w4) {
  // the columns of K a block's tile covers, for K = D and K = F
  const int span = imax(p.split_d == 1 ? D : p.span_d, p.split_f == 1 ? F : p.span_f);
  p.nt = (M + 7) / 8;
  p.slot_bytes = (16 * (w4 ? span / 2 : span) + CB + 127) / 128 * 128;
  p.region = (imax(gemv_region(M, span, p.cluster, p.nt), ATTN_REGION) + 127) / 128 * 128;
  p.region_off = p.slots * p.slot_bytes;
  p.misc_off = p.region_off + p.region;
  p.ln_off = p.misc_off + MISC + MAX_LAYERS * (int)sizeof(Layer);
  p.smem = p.ln_off + 4 * D * 2;
}

struct Args {
  const Layer* layers;  // (L) weight tables
  const bf16* x_in;     // (M, D): layer 0's input
  bf16* xs;             // (xslots, M, D): layer l's input at l % xslots (l >= 1)
  bf16* qkv;            // (M, 3D)
  bf16* att;            // (M, D)
  bf16* xb;             // (M, D)
  bf16* h;              // (M, F)
  void* ck;             // (L, M, S, D) bf16, or int8 with kvs (L, M, S, 256) bf16
  void* cv;
  bf16* kvs;
  const uint8_t* kv_valid;  // (M, S)
  const int* anc;           // (M, S) or null
  unsigned* bar;            // the grid barrier: arrival word, barriers completed
  unsigned long long* trace;  // (blocks, L, MARKS) %globaltimer stamps, or null
  int L, M, D, H, F, S, pos, group, half_d, half_f, xslots;
  float scale;
  Plan p;
};

// ---------------------------------------------------------------------------
// the grid barrier

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The grid barrier on two words in device memory: bar[0], whose top bit
// flips at every barrier (each block's thread 0 adds 1, block 0's adds 2^31
// - (blocks - 1), so the low bits return to 0 whatever the grid), and
// bar[1], the barriers completed (diagnostics).
struct GridBarrier {
  unsigned* bar;
  unsigned add;

  __device__ __forceinline__ void init(unsigned* b, unsigned blocks) {
    bar = b;
    add = blockIdx.x == 0 ? 0x80000000u - (blocks - 1) : 1u;
  }

  __device__ __forceinline__ void sync() {
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned old;
      asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;"
                   : "=r"(old) : "l"(bar), "r"(add) : "memory");
      if (((ld_acquire(bar) ^ old) & 0x80000000u) == 0) {
        const long long start = clock64();
        while (((ld_acquire(bar) ^ old) & 0x80000000u) == 0)
          if (clock64() - start > (1ll << 32)) __trap();
      }
      if (blockIdx.x == 0)
        asm volatile("red.relaxed.gpu.global.add.u32 [%0], 1;" ::"l"(bar + 1) : "memory");
    }
    __syncthreads();
  }
};

// ---------------------------------------------------------------------------
// the weight stream

struct Phase {
  int N, K, split, span, half;
};

__device__ __forceinline__ Phase phase_shape(const Args& a, int ph) {
  const int N = ph == 0 ? 3 * a.D : ph == 2 ? a.F : a.D;
  return ph == 3 ? Phase{N, a.F, a.p.split_f, a.p.span_f, a.half_f}
                 : Phase{N, a.D, a.p.split_d, a.p.span_d, a.half_d};
}

// Block units a layer's GEMV phases hand out: a tile of an unsplit phase
// is one, a cluster tile of a split phase `cluster`.
__device__ __forceinline__ int phase_units(const Args& a, int ph) {
  const Phase s = phase_shape(a, ph);
  return (s.N + 15) / 16 * s.split;
}

// The tiles of phase ph of layer l that this block takes: i = first, first
// + stride, ... < tiles. Tiles go round-robin over the blocks (unsplit) or
// the clusters (split), rotated by the units handed out before in the step
// (ops/decode_step.py::step_tiles).
struct Owned {
  int first, stride, count;
};

__device__ __forceinline__ Owned owned(const Args& a, int l, int ph) {
  const Plan& p = a.p;
  int per_layer = 0, before = 0;
  for (int q = 0; q < PHASES; ++q) {
    const int u = phase_units(a, q);
    per_layer += u;
    if (q < ph) before += u;
  }
  const int acc = l * per_layer + before;
  const Phase s = phase_shape(a, ph);
  const int tiles = (s.N + 15) / 16;
  const int clusters = p.blocks / p.cluster;
  int first, stride;
  if (s.split == 1) {
    stride = p.blocks;
    first = ((int)blockIdx.x - acc % p.blocks + p.blocks) % p.blocks;
  } else {
    stride = clusters;
    const int c = blockIdx.x / p.cluster;
    first = (c - (acc / p.cluster) % clusters + clusters) % clusters;
  }
  const int count = first < tiles ? (tiles - first + stride - 1) / stride : 0;
  return Owned{first, stride, count};
}

// The producer's place in the block's stream of tiles: layer, phase, the
// j-th of its n tiles there (tile first + j stride).
struct Stream {
  int l, ph, j, n, first, stride;
};

__device__ __forceinline__ void stream_settle(const Args& a, Stream& s) {
  while (s.l < a.L && s.j >= s.n) {
    s.j = 0;
    if (++s.ph == PHASES) s.ph = 0, ++s.l;
    if (s.l < a.L) {
      const Owned o = owned(a, s.l, s.ph);
      s.n = o.count, s.first = o.first, s.stride = o.stride;
    }
  }
}

// The producer warp (converged): the TMA bulk copies of the stream's next
// tile into slot `slot`, counted on its mbarrier; then the stream advances.
// The weight pointers come from the layer table in shared memory.
template <bool W4>
__device__ __forceinline__ void issue_tile(const Args& a, const Layer* lt, Stream& s,
                                           unsigned char* ring, uint32_t full, int slot) {
  const int lane = threadIdx.x % 32;
  const Phase sh = phase_shape(a, s.ph);
  const int i = s.first + s.j * s.stride;
  const int rows = min(16, sh.N - 16 * i);
  const int rank = sh.split == 1 ? 0 : (int)(blockIdx.x % a.p.cluster);
  const int kb = rank * sh.span, ks = sh.split == 1 ? sh.K : min(sh.span, sh.K - kb);
  const int rb = W4 ? ks / 2 : ks, rs = W4 ? sh.K / 2 : sh.K;
  const int8_t* src = lt[s.l].q[s.ph] + (size_t)16 * i * rs + (W4 ? kb / 2 : kb);
  const uint32_t dst = smem_addr(ring + slot * a.p.slot_bytes);
  const uint32_t bar = full + 8 * slot;
  if (lane == 0) {
    mbar_expect_tx(bar, rows * rb);
    if (sh.split == 1) gemv::bulk_copy(dst, src, rows * rb, bar);  // the rows are contiguous
  }
  __syncwarp();
  if (sh.split > 1)
    for (int r = lane; r < rows; r += 32)
      gemv::bulk_copy(dst + r * rb, src + (size_t)r * rs, rb, bar);
  ++s.j;
  stream_settle(a, s);
}

// ---------------------------------------------------------------------------
// the phases

struct Ctx {
  const Layer* lt;        // the layer table, in shared memory
  unsigned char* ring;
  unsigned char* region;
  uint32_t full;          // the ring's mbarriers, 8 bytes apart
  unsigned char* rbar;    // rank 0's mbarrier for the split's peer sums
  unsigned char* abar;    // rank 0's mbarrier for the attention's peer partials
  bf16* ln;               // the LayerNorm vectors of the current layer (ln_1 w, b, ln_2 w, b)
  uint32_t lnbar;         // their mbarriers, ln_1's then ln_2's
  Stream prod;            // the last warp: the next tile to request
  int cons;               // tiles consumed so far
  uint32_t rpar, apar;    // the two mbarriers' phase parities
  int rank;
};

// With a trace, thread 0 stamps mark k of layer l (the layer loop and
// gemv_phase say which).
__device__ __forceinline__ void stamp(const Args& a, int l, int k) {
  if (a.trace && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.trace[((size_t)blockIdx.x * a.L + l) * MARKS + k] = t;
  }
}

// One GEMV phase of layer l: the block's tiles in batches of up to
// MAX_TILES, fewer where the ring has fewer slots (x staged once, behind
// the first batch's epilogue operands):
// a batch's products tile by tile as the slots land, one synchronisation,
// the batch's slots refilled with the stream's next tiles, then the sums
// (across the cluster where K is split) and one epilogue.
template <bool W4, int NT>
__device__ __forceinline__ void gemv_phase(const Args& a, Ctx& c, int l, int ph, const bf16* x,
                                           const bf16* res, bf16* out) {
  const Plan& p = a.p;
  const Owned o = owned(a, l, ph);
  const bool ln = ph == 0 || ph == 2;
  // a LayerNorm phase waits for its vectors, then asks for the next
  // layer's into the same buffer once x is staged (or at once)
  const uint32_t lnbar = c.lnbar + (ph == 0 ? 0 : 8);
  bf16* lnbuf = c.ln + (ph == 0 ? 0 : 2 * a.D);
  auto next_ln = [&]() {
    if (threadIdx.x == 0 && l + 1 < a.L) {
      mbar_expect_tx(lnbar, 4 * a.D);
      for (int v = 0; v < 2; ++v)
        gemv::bulk_copy(smem_addr(lnbuf + v * a.D), c.lt[l + 1].ln[ph + v], 2 * a.D, lnbar);
    }
  };
  if (ln) mbar_wait(lnbar, l & 1);
  if (o.count == 0) {
    if (ln) {
      __syncthreads();
      next_ln();
    }
    return;
  }
  const Phase sh = phase_shape(a, ph);
  const Layer& w = c.lt[l];
  const int warp = threadIdx.x / 32;
  const bool split = sh.split > 1;
  const int rank = split ? c.rank : 0;
  const int kb = rank * sh.span, ks = split ? min(sh.span, sh.K - kb) : sh.K;
  const int rb = W4 ? ks / 2 : ks;
  const int epi = ph == 2 ? gemv::EPI_GELU : ph == 0 ? gemv::EPI_BIAS : gemv::EPI_RESIDUAL;
  gemv::XStage st;
  const int span = split ? sh.span : sh.K;
  st.xs = c.region;
  st.sx = gemv::x_stride(span);
  st.lnw = reinterpret_cast<bf16*>(c.region + a.M * st.sx);
  st.lnb = st.lnw + span;
  float* red = reinterpret_cast<float*>(st.lnb + span);
  float* slots = red + WARPS * MAX_TILES * NT * 128;  // the peers' block sums on rank 0
  st.mu = slots + (p.cluster - 1) * MAX_TILES * NT * 128;
  st.rstd = st.mu + MAXM;

  const int batch = min(MAX_TILES, p.slots);  // a batch's slots are in the ring at once
  for (int j0 = 0; j0 < o.count; j0 += batch) {
    const int tiles = min(batch, o.count - j0);
    const int n0 = 16 * (o.first + j0 * o.stride);
    const int per = tiles * NT * 128;  // floats of a warp's sums of the batch
    gemv::Pre pre;
    if (rank == 0)
      pre = gemv::pre_read(w.scale[ph], w.bias[ph], res, epi, a.M, sh.N, n0, tiles, o.stride);
    if (j0 == 0) {
      gemv::stage_x<false>(x, nullptr, nullptr, a.M, sh.K, kb, ks, st);
      if (ln) {  // the block spans K (split_d is 1): the statistics from the staged rows
        stamp(a, l, 30 + ph / 2);  // x's rows staged
        st.lnw = lnbuf, st.lnb = lnbuf + a.D;
        gemv::layer_norm_staged(a.M, sh.K, ks, st);
        stamp(a, l, 32 + ph / 2);  // the LayerNorm done
        next_ln();
      }
      stamp(a, l, 10 + 4 * ph);  // the first batch: x staged
    }
    if (split) {  // a round of the cluster: rank 0's slots are free again
      if (rank == 0 && threadIdx.x == 0)
        mbar_expect_tx(smem_addr(c.rbar), (sh.split - 1) * per * 4);
      cluster_arrive_release();
    }
    const int first_slot = c.cons;
    for (int r = 0; r < tiles; ++r, ++c.cons) {
      const int slot = c.cons % p.slots;
      mbar_wait(c.full + 8 * slot, (c.cons / p.slots) & 1);
      if (r == 0 && j0 == 0) stamp(a, l, 26 + ph);  // the first tile's wait done
      gemv::tile_products<W4, NT>(c.ring + slot * p.slot_bytes, rb, st, a.M, kb, ks, sh.half,
                                  red + warp * per + r * NT * 128);
    }
    __syncthreads();  // the batch's slots are read: refill them in order
    if (j0 == 0) stamp(a, l, 11 + 4 * ph);  // its products done
    // the last warp refills (its TMA requests can wait on the memory
    // system) while the first warps take the epilogue's outputs
    if (warp == WARPS - 1)
      for (int r = 0; r < tiles && c.prod.l < a.L; ++r)
        issue_tile<W4>(a, c.lt, c.prod, c.ring, c.full, (first_slot + r) % p.slots);
    if (split) {
      gemv::sum_warps(red, per);
      __syncthreads();
      cluster_wait();
      if (rank != 0) {
        gemv::send_to_rank0(red, slots, per, rank, c.rbar);
      } else {
        mbar_wait(smem_addr(c.rbar), c.rpar);
        gemv::sum_peers(red, slots, per, sh.split);
        __syncthreads();
        gemv::epilogue<NT>(red, per, false, a.M, sh.N, n0, tiles, o.stride, epi, w.scale[ph],
                           w.bias[ph], res, out, pre);
      }
      c.rpar ^= 1;
    } else {
      gemv::epilogue<NT>(red, per, true, a.M, sh.N, n0, tiles, o.stride, epi, w.scale[ph],
                         w.bias[ph], res, out, pre);
    }
    __syncthreads();  // the sums are read
    if (j0 == 0) stamp(a, l, 13 + 4 * ph);  // its epilogue (and refill) done
  }
}

// The attention phase of layer l: (row, head span) units round-robin over
// the clusters, each split over the cluster's ranks.
template <bool KVQ>
__device__ __forceinline__ void attention_phase(const Args& a, Ctx& c, int l) {
  using T = dattn::cache_t<KVQ>;
  const Plan& p = a.p;
  const size_t layer = (size_t)l * a.M * a.S;
  dattn::Args at;
  at.qkv = a.qkv;
  at.ck = static_cast<T*>(a.ck) + layer * a.D;
  at.cv = static_cast<T*>(a.cv) + layer * a.D;
  at.kvs = KVQ ? a.kvs + layer * dattn::SCALE_LANES : nullptr;
  at.kv_valid = a.kv_valid;
  at.anc = a.anc;
  at.out = a.att;
  at.M = a.M, at.S = a.S, at.D = a.D, at.H = a.H, at.pos = a.pos, at.group = a.group;
  at.scale = a.scale;
  at.p = dattn::Plan{p.heads, p.chunks, p.cluster, p.stages};
  const int spans = a.H / p.heads, units = a.M * spans, clusters = p.blocks / p.cluster;
  // rank 0 merges: it takes the last run of chunks (the shortest, often
  // none), rank k the run k - 1
  const int run = (c.rank + p.cluster - 1) % p.cluster;
  const int bytes = dattn::peer_bytes(at.p, a.pos, p.cluster - 1);
  for (int u = blockIdx.x / p.cluster; u < units; u += clusters) {
    __syncthreads();  // the region is free again
    if (p.cluster > 1) {
      if (c.rank == 0 && threadIdx.x == 0) mbar_expect_tx(smem_addr(c.abar), bytes);
      cluster_arrive_release();
    }
    dattn::attend<KVQ>(at, c.region, c.abar, c.rank, run, (u % spans) * p.heads, u / spans,
                       c.apar);
    c.apar ^= 1;
  }
}

template <bool W4, bool KVQ, int NT>
__global__ void __launch_bounds__(THREADS, 1)
decode_step_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& p = a.p;
  Ctx c;
  c.ring = smem;
  c.region = smem + p.region_off;
  c.full = smem_addr(smem + p.misc_off);
  c.rbar = smem + p.misc_off + 8 * MAX_SLOTS;
  c.abar = c.rbar + 8;
  c.lnbar = smem_addr(c.abar + 8);
  c.ln = reinterpret_cast<bf16*>(smem + p.ln_off);
  c.cons = 0;
  c.rpar = c.apar = 0;
  c.rank = (int)(blockIdx.x % p.cluster);
  GridBarrier gb;
  gb.init(a.bar, p.blocks);

  // the layer table into shared memory, then the ring: every slot's
  // mbarrier and the first `slots` tiles of the block's stream
  Layer* lt = reinterpret_cast<Layer*>(smem + p.misc_off + MISC);
  for (int i = threadIdx.x; i < a.L * (int)(sizeof(Layer) / 8); i += THREADS)
    reinterpret_cast<uint64_t*>(lt)[i] = reinterpret_cast<const uint64_t*>(a.layers)[i];
  c.lt = lt;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.slots; ++s) mbar_init(c.full + 8 * s, 1);
    mbar_init(smem_addr(c.rbar), 1);
    mbar_init(smem_addr(c.abar), 1);
    mbar_init(c.lnbar, 1);
    mbar_init(c.lnbar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int v = 0; v < 2; ++v) {  // layer 0's LayerNorm vectors
      mbar_expect_tx(c.lnbar + 8 * v, 4 * a.D);
      for (int u = 0; u < 2; ++u)
        gemv::bulk_copy(smem_addr(c.ln + (2 * v + u) * a.D), lt[0].ln[2 * v + u], 2 * a.D,
                        c.lnbar + 8 * v);
    }
  }
  __syncthreads();  // the mbarriers initialised
  if (threadIdx.x / 32 == WARPS - 1) {
    const Owned o = owned(a, 0, 0);
    c.prod = Stream{0, 0, 0, o.count, o.first, o.stride};
    stream_settle(a, c.prod);
    for (int s = 0; s < p.slots && c.prod.l < a.L; ++s)
      issue_tile<W4>(a, c.lt, c.prod, c.ring, c.full, s);
  }
  // (the peers' first remote write to rank 0's mbarriers follows a cluster
  // barrier that rank 0 passes after initialising them)
  const size_t md = (size_t)a.M * a.D;

  for (int l = 0; l < a.L; ++l) {
    const bf16* x = l == 0 ? a.x_in : a.xs + (l % a.xslots) * md;
    bf16* x_next = a.xs + ((l + 1) % a.xslots) * md;
    // with a trace, thread 0 stamps the layer's start (0), each phase's end
    // (odd) and each barrier's end (even); gemv_phase stamps 10-33
    stamp(a, l, 0);
    // the layer's phases in turn: qkv, attention, attn-proj, fc, mlp-proj.
    // One copy of each phase's code (a loop, not unrolled: the kernel's
    // instructions stay few, and hot in the instruction cache), and a grid
    // barrier after each phase but the step's last.
#pragma unroll 1
    for (int step = 0; step < STEPS; ++step) {
      if (step == 1) {
        attention_phase<KVQ>(a, c, l);
      } else {
        const int ph = step == 0 ? 0 : step - 1;
        const bf16* in = ph == 0 ? x : ph == 1 ? a.att : ph == 2 ? a.xb : a.h;
        const bf16* res = ph == 1 ? x : ph == 3 ? a.xb : nullptr;
        bf16* out = ph == 0 ? a.qkv : ph == 1 ? a.xb : ph == 2 ? a.h : x_next;
        gemv_phase<W4, NT>(a, c, l, ph, in, res, out);
      }
      stamp(a, l, 2 * step + 1);
      if (step + 1 < STEPS || l + 1 < a.L) {
        gb.sync();
        if (step + 1 < STEPS) stamp(a, l, 2 * step + 2);
      }
    }
  }
}

// The bare barrier floor: `barriers` grid barriers on the step's grid.
__global__ void __launch_bounds__(THREADS, 1)
step_barrier_kernel(unsigned* bar, int barriers) {
  GridBarrier gb;
  gb.init(bar, gridDim.x);
  for (int i = 0; i < barriers; ++i) gb.sync();
}

// The dynamic shared-memory limit raised once per device for each kernel,
// outside a graph capture.
template <typename K>
cudaError_t raise_smem(K kernel, unsigned& raised, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || (raised >> dev & 1u)) return cudaSuccess;
  if (stream) {
    cudaStreamCaptureStatus cap = cudaStreamCaptureStatusNone;
    err = cudaStreamIsCapturing(stream, &cap);
    if (err != cudaSuccess) return err;
    if (cap != cudaStreamCaptureStatusNone) return cudaErrorStreamCaptureUnsupported;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err == cudaSuccess) raised |= 1u << dev;
  return err;
}

template <typename K>
cudaError_t occupancy(K kernel, unsigned& raised, int cluster, int smem, int* clusters) {
  cudaError_t err = raise_smem(kernel, raised, nullptr);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

template <typename K, typename... A>
cudaError_t launch(K kernel, int blocks, int cluster, int smem, bool cooperative,
                   cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cooperative ? 2 : 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// raised-limit bits a device, by variant (w4, kvq, n-tiles)
unsigned step_raised[2][2][3];
unsigned barrier_raised;

template <bool W4, bool KVQ>
auto step_kernel(int nt) {
  return nt == 1 ? decode_step_kernel<W4, KVQ, 1>
                 : nt == 2 ? decode_step_kernel<W4, KVQ, 2> : decode_step_kernel<W4, KVQ, 3>;
}

#define STEP_VARIANT(W4, KVQ, EXPR)             \
  (W4 ? (KVQ ? EXPR(true, true) : EXPR(true, false)) \
      : (KVQ ? EXPR(false, true) : EXPR(false, false)))

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// The resident clusters of `cluster` blocks for the step kernel of this
// variant (w4, kvq, nt = n-tiles of the rows) at `smem` bytes of shared
// memory, from cudaOccupancyMaxActiveClusters; into *clusters.
extern "C" int decode_step_occupancy(int w4, int kvq, int nt, int cluster, int smem,
                                     int* clusters) {
  if (nt < 1 || nt > 3 || cluster < 1 || cluster > MAX_CLUSTER || smem < 0 || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
#define OCC(W, Q) occupancy(step_kernel<W, Q>(nt), step_raised[W][Q][nt - 1], cluster, smem, \
                            clusters)
  return (int)STEP_VARIANT(w4, kvq, OCC);
#undef OCC
}

// layers: (L) weight tables (16 device pointers a layer: q, scale, bias of
// c_attn, attn c_proj, c_fc, mlp c_proj, then ln_1 w, b, ln_2 w, b); x_in
// (M, D) bf16; xs (xslots, M, D) bf16: layer l's input (l >= 1) at slot l %
// xslots (2, or L + 1 to keep every layer's; slot 0 is then unused); qkv (M, 3D),
// att, xb (M, D), h (M, F) bf16 scratch; ck, cv (L, M, S, D) bf16, or int8
// with kvs (L, M, S, 256) bf16 (KVQ); kv_valid (M, S) bool; anc (M, S)
// int32 or null (group 1); bar: the grid barrier's two words (the first's
// low bits 0 at rest); trace: null, or (blocks, L, 34) u64 for each block's
// %globaltimer stamps (the layer loop says where). half_d / half_f: the int4 nibble groups for K = D and K = F (0:
// int8 weights). The plan is ops/decode_step.py::step_plan's; one whose
// layout this entry does not reproduce, or whose grid the occupancy query
// does not allow, is refused. Returns cudaGetLastError() after the launch.
extern "C" int decode_step_launch(const void* layers, const void* x_in, void* xs, int xslots,
                                  void* qkv, void* att, void* xb, void* h, void* ck, void* cv,
                                  void* kvs, const void* kv_valid, const void* anc, void* bar,
                                  void* trace,
                                  int L, int M, int D, int H, int F, int S, int pos, int group,
                                  float scale, int half_d, int half_f, int cluster, int blocks,
                                  int slots, int split_d, int span_d, int split_f, int span_f,
                                  int heads, int chunks, int stages, int smem, void* stream) {
  const bool w4 = half_d > 0, kvq = kvs != nullptr;
  const int n_chunks = (pos + dattn::CHUNK - 1) / dattn::CHUNK;
  auto split_ok = [&](int K, int split, int span, int half) {
    const int unit = w4 ? 2 * half : CB;
    return (split == 1 || split == cluster) && span % unit == 0 && span * (split - 1) < K &&
           span * split >= K && (!w4 || (half % 16 == 0 && K % (2 * half) == 0));
  };
  if (L < 1 || L > MAX_LAYERS || M < 1 || M > MAXM || D != H * dattn::DH || F < 16 || F % 64 != 0 ||
      S < 1 || pos < 0 || pos >= S || group < 1 || M % group != 0 || (group > 1 && !anc) ||
      (w4 != (half_f > 0)) || (kvq && H > dattn::SCALE_HALF) || cluster < 1 ||
      cluster > MAX_CLUSTER || blocks < cluster || blocks % cluster != 0 || slots < 2 ||
      slots > MAX_SLOTS || !split_ok(D, split_d, span_d, half_d) ||
      !split_ok(F, split_f, span_f, half_f) || split_d != 1 || split_f != cluster || heads < 1 ||
      heads > dattn::MAX_HEADS || H % heads != 0 || chunks < 1 ||
      chunks * cluster < n_chunks || (n_chunks > 0 && chunks != (n_chunks + cluster - 1) / cluster) ||
      stages < 1 || stages > dattn::MAX_STAGES || stages > chunks || (xslots != 2 && xslots != L + 1) ||
      !aligned16(layers) || !aligned16(x_in) || !aligned16(xs) || !aligned16(qkv) ||
      !aligned16(att) || !aligned16(xb) || !aligned16(h) || !aligned16(ck) || !aligned16(cv) ||
      !aligned16(kv_valid))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const Layer*>(layers), static_cast<const bf16*>(x_in), static_cast<bf16*>(xs),
         static_cast<bf16*>(qkv), static_cast<bf16*>(att), static_cast<bf16*>(xb),
         static_cast<bf16*>(h), ck, cv, static_cast<bf16*>(kvs),
         static_cast<const uint8_t*>(kv_valid), static_cast<const int*>(anc),
         static_cast<unsigned*>(bar), static_cast<unsigned long long*>(trace), L, M, D, H, F, S,
         pos, group, half_d, half_f, xslots,
         scale, {}};
  Plan& p = a.p;
  p.cluster = cluster, p.blocks = blocks, p.slots = slots;
  p.split_d = split_d, p.span_d = span_d, p.split_f = split_f, p.span_f = span_f;
  p.heads = heads, p.chunks = chunks, p.stages = stages;
  layout(p, M, D, F, w4);
  const dattn::Plan ap{heads, chunks, cluster, stages};
  if (p.smem != smem || smem > SMEM_MAX || dattn::layout(ap, kvq).smem > p.region)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int resident = 0;
#define RUN(W, Q)                                                                           \
  [&]() -> cudaError_t {                                                                    \
    auto kernel = step_kernel<W, Q>(p.nt);                                                  \
    cudaError_t err = raise_smem(kernel, step_raised[W][Q][p.nt - 1], s);                   \
    if (err == cudaSuccess)                                                                 \
      err = occupancy(kernel, step_raised[W][Q][p.nt - 1], cluster, smem, &resident);       \
    if (err != cudaSuccess) return err;                                                     \
    if (resident * cluster < blocks) return cudaErrorCooperativeLaunchTooLarge;             \
    return launch(kernel, blocks, cluster, smem, false, s, a);                              \
  }()
  return (int)STEP_VARIANT(w4, kvq, RUN);
#undef RUN
}

// The resident clusters of the bare-barrier kernel (into *clusters), at the
// step's cluster size and shared memory.
extern "C" int step_barrier_occupancy(int cluster, int smem, int* clusters) {
  if (cluster < 1 || cluster > MAX_CLUSTER || smem < 0 || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  return (int)occupancy(step_barrier_kernel, barrier_raised, cluster, smem, clusters);
}

// `barriers` grid barriers on `blocks` blocks in clusters of `cluster`, at
// `smem` bytes of shared memory (unused: it sets the residency of the
// step's grid); cooperative: also the cooperative-launch attribute.
extern "C" int step_barrier_launch(void* bar, int barriers, int blocks, int cluster, int smem,
                                   int cooperative, void* stream) {
  if (barriers < 0 || cluster < 1 || cluster > MAX_CLUSTER || blocks < cluster ||
      blocks % cluster != 0 || smem < 0 || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = raise_smem(step_barrier_kernel, barrier_raised, s);
  if (err != cudaSuccess) return (int)err;
  int resident = 0;
  err = occupancy(step_barrier_kernel, barrier_raised, cluster, smem, &resident);
  if (err != cudaSuccess) return (int)err;
  if (resident * cluster < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  return (int)launch(step_barrier_kernel, blocks, cluster, smem, cooperative != 0, s,
                     static_cast<unsigned*>(bar), barriers);
}
