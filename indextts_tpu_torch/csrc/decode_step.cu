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
//
// K6 with both tp shards on one card (the TP flag; its own entries,
// decode_step_tp_launch / _occupancy). Replaces the TPU kernel
// indextts_tpu/ops/pallas/decode_step_tp.py::fused_decode_step_tp_shard
// (decode_step_tp.py:367; its pallas_call at :438), which runs one program
// over the layers per shard with the all-reduce inside it (remote copies,
// :201-216). Here one launch runs both shards' layers (int8 weights, the
// bf16 cache, parallel/mesh.py::shard_gpt2_tp's split: shard t's weights in
// tensors of their own, so the layer table is (L, 2) entries) and gives
// the bits of the chain it replaced (ops/decode_step_tp.py::
// fused_decode_step_tp_chain: K1's standalone kernels at shard shapes and
// tp_allreduce.cu). A layer's phases, for both shards:
//   1. qkv and fc (column-parallel, K = D): x staged and LayerNormed once
//      a block for both shards; both shards' 16-row tiles, interleaved, go
//      round-robin over the whole grid, so every block streams the same
//      share of the step's weights (and, the grid being even, a block's
//      tiles are one shard's: one scale, bias and output a batch).
//   2. the attention: (shard, row, head span) units over each shard's own
//      cache at H / 2 heads, the ancestry map shared.
//   3. the out-projection and the MLP projection (row-parallel): on one
//      card the pair's product is one product whose K is split in two, so
//      the all-reduce folds into the product's own sum, in the chain's
//      order (each shard's partial summed as the chain's GEMV sums it,
//      then lo + hi: gemv_core.cuh::sum_shards), and ends in
//      tp_allreduce.cu's epilogue (EPI_TP: the full scale and bias after
//      the reduce, then the residual). No f32 partial goes to device
//      memory, and the exchange costs no barrier and no launch.
//      - mlp-proj (a shard's K = F / 2, split 2 at D = 1280 as gemv_plan
//        splits it): a cluster of 2 split_f ranks takes a tile, shard 0's
//        spans on its first ranks, and rank 0 sums the four through
//        distributed shared memory, as K1 sums its split.
//      - attn-proj (a shard's K = D / 2, unsplit): one block takes a
//        tile's slab of both shards (two slots of the ring) against both
//        shards' attention rows and adds the two in its own shared
//        memory. A first build gave each shard's slab to its own rank of
//        a cluster and summed them across it, as mlp-proj does: the phase
//        took 5.6 µs a layer against K1's 2.9 for the same bytes on the
//        H100, the cluster's exchange costing what the rest of the phase
//        costs (PERF.md).
//   4. The refill of a phase's last batch waits for the grid barrier: the
//      last warp issues it between the block's arrival and its wait for
//      the others (GridBarrier's `during`), not before the batch's closing
//      __syncthreads. Issued there, it held every warp of the block 1.2-1.9
//      µs a phase on the H100 (the timeline's "epilogue and refill", 2.4
//      µs against K1's 0.6 with as many slabs), which took K6 from 1.07 to
//      0.98 ms a step (PERF.md).
// The barriers stay K1's, 5 L - 1 a step; the two shards' residual streams
// are one stream by construction (one rank writes each output once).

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
// table is (L, 16) of these 8-byte words, with TP (L, 2, 16): each shard's
// (the LayerNorm vectors, and the row-parallel phases' scale and bias, are
// read from shard 0's: the shards hold copies).
struct Layer {
  const int8_t* q[PHASES];
  const float* scale[PHASES];
  const bf16* bias[PHASES];
  const bf16* ln[4];  // ln_1 weight, bias; ln_2 weight, bias
};
static_assert(sizeof(Layer) == 16 * 8, "the wrapper's table layout");

struct Plan {
  int cluster, blocks, slots;            // as ops/decode_step.py::step_plan (TP: step_tp_plan)
  int split_d, span_d, split_f, span_f;  // the GEMVs' split of K = D and K = F (TP: F / 2)
  int heads, chunks, stages;             // the attention's plan at pos
  // derived by `layout`
  int nt, slot_bytes, region, region_off, misc_off, ln_off, smem;
};

// Shared memory: [slots x slot_bytes: the weight ring][region: the GEMV
// phases' x, LayerNorm vectors, warp / peer sums and row statistics, or
// the attention's layout][MISC: mbarriers][the layer table, MAX_LAYERS x
// 128 bytes][the LayerNorm vectors: ln_1 weight, bias, ln_2 weight, bias,
// D bf16 each]. The same formula as ops/decode_step.py::_step_layout. TP:
// the table holds 2 x MAX_LAYERS entries, and F is the MLP projection's K
// (F / 2).
__host__ __device__ inline int gemv_region(int M, int span, int cluster, int nt) {
  return M * gemv::x_stride(span) + 2 * span * 2 +
         (WARPS + cluster - 1) * MAX_TILES * nt * 32 * 4 * 4 + 2 * MAXM * 4;
}

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline void layout(Plan& p, int M, int D, int F, bool w4, int shards) {
  // the columns of K a block's tile covers, for K = D and K = F
  const int span = imax(p.split_d == 1 ? D : p.span_d, p.split_f == 1 ? F : p.span_f);
  p.nt = (M + 7) / 8;
  p.slot_bytes = (16 * (w4 ? span / 2 : span) + CB + 127) / 128 * 128;
  p.region = (imax(gemv_region(M, span, p.cluster, p.nt), ATTN_REGION) + 127) / 128 * 128;
  p.region_off = p.slots * p.slot_bytes;
  p.misc_off = p.region_off + p.region;
  p.ln_off = p.misc_off + MISC + shards * MAX_LAYERS * (int)sizeof(Layer);
  p.smem = p.ln_off + 4 * D * 2;
}

// TP: qkv, att and h hold both shards' (2, M, width / 2), shard 0's first,
// and ck / cv [t] are shard t's (L, M, S, D / 2) caches; D, H and F are the
// model's.
struct Args {
  const Layer* layers;  // (L) weight tables, TP (L, 2)
  const bf16* x_in;     // (M, D): layer 0's input
  bf16* xs;             // (xslots, M, D): layer l's input at l % xslots (l >= 1)
  bf16* qkv;            // (M, 3D)
  bf16* att;            // (M, D)
  bf16* xb;             // (M, D)
  bf16* h;              // (M, F)
  void* ck[2];          // (L, M, S, D) bf16, or int8 with kvs (L, M, S, 256) bf16
  void* cv[2];
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
// bar[1], the barriers completed (diagnostics). `during` runs on every
// thread between the block's arrival and its wait for the others: work
// that needs nothing of theirs.
template <typename Hook>
struct GridBarrier {
  Hook during;
  unsigned* bar;
  unsigned add;

  __device__ __forceinline__ void init(unsigned* b, unsigned blocks) {
    bar = b;
    add = blockIdx.x == 0 ? 0x80000000u - (blocks - 1) : 1u;
  }

  __device__ __forceinline__ void sync() {
    __syncthreads();
    unsigned old = 0;
    if (threadIdx.x == 0)
      asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;"
                   : "=r"(old) : "l"(bar), "r"(add) : "memory");
    during();
    if (threadIdx.x == 0) {
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

// A GEMV phase's shape: N output rows of K columns, K split over `split`
// ranks of `span` columns. TP: qkv and fc count both shards' rows, tile i
// being shard i % 2's tile i / 2 (the grid is whole clusters of an even
// size, so a block's tiles, i + k blocks, lie in one shard); attn-proj has
// a shard's K, and a block takes a tile's slab of both shards (its two
// halves of the pair's K); mlp-proj has a shard's K split over the
// cluster, shard 0's spans on the first split_f ranks.
struct Phase {
  int N, K, split, span, half;
};

template <bool TP>
__device__ __forceinline__ Phase phase_shape(const Args& a, int ph) {
  if constexpr (TP) {  // selects, not a switch: no table in local memory
    const int Dl = a.D / 2, Fl = a.F / 2;
    const bool mlp = ph == 3;
    return Phase{ph == 0 ? 6 * Dl : ph == 2 ? 2 * Fl : a.D, ph == 1 ? Dl : mlp ? Fl : a.D,
                 mlp ? 2 * a.p.split_f : 1, ph == 1 ? Dl : mlp ? a.p.span_f : a.D, 0};
  }
  const int N = ph == 0 ? 3 * a.D : ph == 2 ? a.F : a.D;
  return ph == 3 ? Phase{N, a.F, a.p.split_f, a.p.span_f, a.half_f}
                 : Phase{N, a.D, a.p.split_d, a.p.span_d, a.half_d};
}

// TP's attn-proj: a tile is two slabs (shard 0's, then shard 1's), two
// slots of the ring; every other phase's tile is one.
template <bool TP>
__device__ __forceinline__ int slabs_of(int ph) {
  return TP && ph == 1 ? 2 : 1;
}

// TP's mlp-proj: the rank's shard and its span of that shard's K.
__device__ __forceinline__ void tp_rank_span(const Args& a, const Phase& s, int rank, int& shard,
                                             int& kb, int& ks) {
  shard = rank / a.p.split_f;
  kb = (rank - shard * a.p.split_f) * s.span;
  ks = min(s.span, s.K - kb);
}

// Block units a layer's GEMV phases hand out: a tile of an unsplit phase
// is one, a cluster tile of a split phase `cluster`.
template <bool TP>
__device__ __forceinline__ int phase_units(const Args& a, int ph) {
  const Phase s = phase_shape<TP>(a, ph);
  return (s.N + 15) / 16 * s.split;
}

// The tiles of phase ph of layer l that this block takes: i = first, first
// + stride, ... < tiles. Tiles go round-robin over the blocks (unsplit) or
// the clusters (split), rotated by the units handed out before in the step
// (ops/decode_step.py::step_tiles, step_tp_tiles).
struct Owned {
  int first, stride, count;
};

template <bool TP>
__device__ __forceinline__ Owned owned(const Args& a, int l, int ph) {
  const Plan& p = a.p;
  int per_layer = 0, before = 0;
  for (int q = 0; q < PHASES; ++q) {
    const int u = phase_units<TP>(a, q);
    per_layer += u;
    if (q < ph) before += u;
  }
  const int acc = l * per_layer + before;
  const Phase s = phase_shape<TP>(a, ph);
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

// The producer's place in the block's stream of slabs: layer, phase, the
// j-th of its n slabs there (tile first + (j / slabs) stride).
struct Stream {
  int l, ph, j, n, first, stride;
};

template <bool TP>
__device__ __forceinline__ void stream_settle(const Args& a, Stream& s) {
  while (s.l < a.L && s.j >= s.n) {
    s.j = 0;
    if (++s.ph == PHASES) s.ph = 0, ++s.l;
    if (s.l < a.L) {
      const Owned o = owned<TP>(a, s.l, s.ph);
      s.n = o.count * slabs_of<TP>(s.ph), s.first = o.first, s.stride = o.stride;
    }
  }
}

// The producer warp (converged): the TMA bulk copies of the stream's next
// slab into slot `slot`, counted on its mbarrier; then the stream advances.
// The weight pointers come from the layer table in shared memory (TP: the
// slab's shard's).
template <bool W4, bool TP>
__device__ __forceinline__ void issue_tile(const Args& a, const Layer* lt, Stream& s,
                                           unsigned char* ring, uint32_t full, int slot) {
  const int lane = threadIdx.x % 32;
  const Phase sh = phase_shape<TP>(a, s.ph);
  const int slabs = slabs_of<TP>(s.ph);
  const int i = s.first + s.j / slabs * s.stride;
  const int rows = min(16, sh.N - 16 * i);
  const int rank = sh.split == 1 ? 0 : (int)(blockIdx.x % a.p.cluster);
  int kb = rank * sh.span, ks = sh.split == 1 ? sh.K : min(sh.span, sh.K - kb);
  int shard = 0, row0 = 16 * i;
  if constexpr (TP) {
    if (slabs == 2)
      shard = s.j % 2;
    else if (sh.split > 1)
      tp_rank_span(a, sh, rank, shard, kb, ks);
    else  // qkv, fc: tile i is shard i % 2's tile i / 2
      shard = i % 2, row0 = 16 * (i / 2);
  }
  const int rb = W4 ? ks / 2 : ks, rs = W4 ? sh.K / 2 : sh.K;
  const int8_t* src = lt[TP ? 2 * s.l + shard : s.l].q[s.ph] + (size_t)row0 * rs +
                      (W4 ? kb / 2 : kb);
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
  stream_settle<TP>(a, s);
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
  Stream prod;            // the last warp: the next slab to request
  int cons;               // slabs consumed so far
  int pend, pend_slot;    // TP: slots to refill at the next grid barrier, from pend_slot
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
// MAX_TILES slabs, fewer where the ring has fewer slots (x staged once,
// behind the first batch's epilogue operands):
// a batch's products slab by slab as the slots land, one synchronisation,
// the batch's slots refilled with the stream's next slabs, then the sums
// (across the cluster where K is split) and one epilogue. TP: qkv's and
// fc's tiles lie in one shard (its scale, bias and output, of the (2, M,
// width) pair); attn-proj stages both shards' attention rows (att is (2,
// M, D/2): 2M rows), takes each tile's two slabs, adds each slab's warps
// in turn and then lo + hi; mlp-proj's rank 0 sums each shard's spans and
// then lo + hi (gemv_core.cuh::sum_shards). Both end in tp_allreduce.cu's
// epilogue (EPI_TP), so the pair's all-reduce never leaves the block or
// the cluster.
template <bool W4, int NT, bool TP>
__device__ __forceinline__ void gemv_phase(const Args& a, Ctx& c, int l, int ph, const bf16* x,
                                           const bf16* res, bf16* out) {
  const Plan& p = a.p;
  const Owned o = owned<TP>(a, l, ph);
  const bool ln = ph == 0 || ph == 2;
  // a LayerNorm phase waits for its vectors, then asks for the next
  // layer's into the same buffer once x is staged (or at once)
  const uint32_t lnbar = c.lnbar + (ph == 0 ? 0 : 8);
  bf16* lnbuf = c.ln + (ph == 0 ? 0 : 2 * a.D);
  auto next_ln = [&]() {
    if (threadIdx.x == 0 && l + 1 < a.L) {
      mbar_expect_tx(lnbar, 4 * a.D);
      for (int v = 0; v < 2; ++v)
        gemv::bulk_copy(smem_addr(lnbuf + v * a.D), c.lt[TP ? 2 * (l + 1) : l + 1].ln[ph + v],
                        2 * a.D, lnbar);
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
  const Phase sh = phase_shape<TP>(a, ph);
  const Layer* w = &c.lt[TP ? 2 * l : l];
  const int warp = threadIdx.x / 32;
  const bool split = sh.split > 1;
  const int rank = split ? c.rank : 0;
  int kb = rank * sh.span, ks = split ? min(sh.span, sh.K - kb) : sh.K;
  const int slabs = slabs_of<TP>(ph);
  int xrows = a.M;
  if constexpr (TP) {
    if (split) {  // the rank's shard's rows of h
      int shard;
      tp_rank_span(a, sh, rank, shard, kb, ks);
      x += (size_t)shard * a.M * sh.K;
    }
    xrows = slabs * a.M;  // attn-proj: both shards' rows of att
  }
  const int rb = W4 ? ks / 2 : ks;
  const int epi = ph == 2 ? gemv::EPI_GELU
                  : ph == 0 ? gemv::EPI_BIAS
                            : TP ? gemv::EPI_TP : gemv::EPI_RESIDUAL;
  gemv::XStage st;
  const int span = split ? sh.span : sh.K;
  st.xs = c.region;
  st.sx = gemv::x_stride(span);
  st.lnw = reinterpret_cast<bf16*>(c.region + xrows * st.sx);
  st.lnb = st.lnw + span;
  float* red = reinterpret_cast<float*>(st.lnb + span);
  float* slots = red + WARPS * MAX_TILES * NT * 128;  // the peers' block sums on rank 0
  st.mu = slots + (p.cluster - 1) * MAX_TILES * NT * 128;
  st.rstd = st.mu + MAXM;

  const int batch = min(MAX_TILES, p.slots) / slabs;  // a batch's slots are in the ring at once
  for (int j0 = 0; j0 < o.count; j0 += batch) {
    const int tiles = min(batch, o.count - j0);
    int n0 = 16 * (o.first + j0 * o.stride), N = sh.N, tstride = o.stride;
    bf16* dst = out;
    const Layer* wb = w;
    if constexpr (TP) {
      if (ph == 0 || ph == 2) {  // tile i is shard i % 2's tile i / 2, and the
        const int i0 = o.first + j0 * o.stride, shard = i0 % 2;  // stride is even
        N = sh.N / 2, n0 = 16 * (i0 / 2), tstride = o.stride / 2;
        wb += shard, dst += (size_t)shard * a.M * N;
      }
    }
    const int per = slabs * tiles * NT * 128;  // floats of a warp's sums of the batch
    gemv::Pre pre;
    if (rank == 0)
      pre = gemv::pre_read<TP>(wb->scale[ph], wb->bias[ph], res, epi, a.M, N, n0, tiles,
                               tstride);
    if (j0 == 0) {
      gemv::stage_x<false>(x, nullptr, nullptr, xrows, sh.K, kb, ks, st);
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
    for (int r = 0; r < slabs * tiles; ++r, ++c.cons) {
      const int slot = c.cons % p.slots;
      mbar_wait(c.full + 8 * slot, (c.cons / p.slots) & 1);
      if (r == 0 && j0 == 0) stamp(a, l, 26 + ph);  // the first tile's wait done
      // two slabs a tile: tile r / 2's shard r % 2, against that shard's
      // rows, its sums after all of shard 0's; shard 1's chunks go to the
      // warps after those that took shard 0's extra chunks (a warp takes
      // chunks w, w + 8, ...: at K = 640, ten chunks, warps 0 and 1 two)
      gemv::XStage sr = st;
      int at = r, vw = warp;
      if (slabs == 2 && r % 2)
        sr.xs += a.M * st.sx, at = tiles + r / 2,
            vw = (warp + WARPS - (rb + CB - 1) / CB % WARPS) % WARPS;
      else if (slabs == 2)
        at = r / 2;
      gemv::tile_products<W4, NT>(c.ring + slot * p.slot_bytes, rb, sr, a.M, kb, ks, sh.half,
                                  red + vw * per + at * NT * 128, vw);
    }
    __syncthreads();  // the batch's slots are read: refill them in order
    if (j0 == 0) stamp(a, l, 11 + 4 * ph);  // its products done
    // the last warp refills (its TMA requests can wait on the memory
    // system) while the first warps take the epilogue's outputs; TP: the
    // phase's last batch leaves its refill to the grid barrier's wait
    // (`pending`), where it costs nothing
    if (TP && j0 + batch >= o.count) {
      c.pend_slot = first_slot, c.pend = slabs * tiles;
    } else if (warp == WARPS - 1) {
      for (int r = 0; r < slabs * tiles && c.prod.l < a.L; ++r)
        issue_tile<W4, TP>(a, c.lt, c.prod, c.ring, c.full, (first_slot + r) % p.slots);
    }
    if (split) {
      gemv::sum_warps(red, per);
      __syncthreads();
      cluster_wait();
      if (rank != 0) {
        gemv::send_to_rank0(red, slots, per, rank, c.rbar);
      } else {
        mbar_wait(smem_addr(c.rbar), c.rpar);
        if constexpr (TP)
          gemv::sum_shards(red, slots, per, a.p.split_f);
        else
          gemv::sum_peers(red, slots, per, sh.split);
        __syncthreads();
        gemv::epilogue<NT, TP>(red, per, false, a.M, N, n0, tiles, tstride, epi, wb->scale[ph],
                               wb->bias[ph], res, dst, pre);
      }
      c.rpar ^= 1;
    } else if (slabs == 2) {  // each slab's warps in turn, then lo + hi
      const int half = per / 2;
      gemv::sum_warps(red, per);
      __syncthreads();
      gemv::sum_shards(red, red + half, half, 1);
      __syncthreads();
      gemv::epilogue<NT, TP>(red, half, false, a.M, N, n0, tiles, tstride, epi, wb->scale[ph],
                             wb->bias[ph], res, dst, pre);
    } else {
      gemv::epilogue<NT, TP>(red, per, true, a.M, N, n0, tiles, tstride, epi, wb->scale[ph],
                             wb->bias[ph], res, dst, pre);
    }
    __syncthreads();  // the sums are read
    if (j0 == 0) stamp(a, l, 13 + 4 * ph);  // its epilogue (and refill) done
  }
}

// The attention phase of layer l: (row, head span) units round-robin over
// the clusters, each split over the cluster's ranks. TP: (shard, row, head
// span) units, shard 0's first, each over its shard's qkv, cache and
// output at H / 2 heads.
template <bool KVQ, bool TP>
__device__ __forceinline__ void attention_phase(const Args& a, Ctx& c, int l) {
  using T = dattn::cache_t<KVQ>;
  constexpr int shards = TP ? 2 : 1;
  const Plan& p = a.p;
  const int D = a.D / shards, H = a.H / shards;
  const size_t layer = (size_t)l * a.M * a.S;
  dattn::Args at;
  at.qkv = a.qkv;
  at.ck = static_cast<T*>(a.ck[0]) + layer * D;
  at.cv = static_cast<T*>(a.cv[0]) + layer * D;
  at.kvs = KVQ ? a.kvs + layer * dattn::SCALE_LANES : nullptr;
  at.kv_valid = a.kv_valid;
  at.anc = a.anc;
  at.out = a.att;
  at.M = a.M, at.S = a.S, at.D = D, at.H = H, at.pos = a.pos, at.group = a.group;
  at.scale = a.scale;
  at.p = dattn::Plan{p.heads, p.chunks, p.cluster, p.stages};
  const int spans = H / p.heads, units = a.M * spans, clusters = p.blocks / p.cluster;
  // rank 0 merges: it takes the last run of chunks (the shortest, often
  // none), rank k the run k - 1
  const int run = (c.rank + p.cluster - 1) % p.cluster;
  const int bytes = dattn::peer_bytes(at.p, a.pos, p.cluster - 1);
  for (int u = blockIdx.x / p.cluster; u < shards * units; u += clusters) {
    int v = u;
    if constexpr (TP) {
      if (u >= units) {  // shard 1's
        v = u - units;
        at.qkv = a.qkv + (size_t)a.M * 3 * D;
        at.ck = static_cast<T*>(a.ck[1]) + layer * D;
        at.cv = static_cast<T*>(a.cv[1]) + layer * D;
        at.out = a.att + (size_t)a.M * D;
      }
    }
    __syncthreads();  // the region is free again
    if (p.cluster > 1) {
      if (c.rank == 0 && threadIdx.x == 0) mbar_expect_tx(smem_addr(c.abar), bytes);
      cluster_arrive_release();
    }
    dattn::attend<KVQ>(at, c.region, c.abar, c.rank, run, (v % spans) * p.heads, v / spans,
                       c.apar);
    c.apar ^= 1;
  }
}

template <bool W4, bool KVQ, int NT, bool TP>
__global__ void __launch_bounds__(THREADS, 1)
decode_step_kernel(const Args a) {
  constexpr int shards = TP ? 2 : 1;
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
  c.pend = 0;
  c.rank = (int)(blockIdx.x % p.cluster);
  // TP: the refill a phase's last batch left to the grid barrier's wait
  auto pending = [&]() {
    if constexpr (TP) {
      if (threadIdx.x / 32 == WARPS - 1)
        for (int r = 0; r < c.pend && c.prod.l < a.L; ++r)
          issue_tile<W4, TP>(a, c.lt, c.prod, c.ring, c.full, (c.pend_slot + r) % p.slots);
      c.pend = 0;
    }
  };
  GridBarrier<decltype(pending)> gb{pending};
  gb.init(a.bar, p.blocks);

  // the layer table into shared memory, then the ring: every slot's
  // mbarrier and the first `slots` slabs of the block's stream
  Layer* lt = reinterpret_cast<Layer*>(smem + p.misc_off + MISC);
  for (int i = threadIdx.x; i < a.L * shards * (int)(sizeof(Layer) / 8); i += THREADS)
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
    const Owned o = owned<TP>(a, 0, 0);
    c.prod = Stream{0, 0, 0, o.count, o.first, o.stride};
    stream_settle<TP>(a, c.prod);
    for (int s = 0; s < p.slots && c.prod.l < a.L; ++s)
      issue_tile<W4, TP>(a, c.lt, c.prod, c.ring, c.full, s);
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
        attention_phase<KVQ, TP>(a, c, l);
      } else {
        const int ph = step == 0 ? 0 : step - 1;
        const bf16* in = ph == 0 ? x : ph == 1 ? a.att : ph == 2 ? a.xb : a.h;
        const bf16* res = ph == 1 ? x : ph == 3 ? a.xb : nullptr;
        bf16* out = ph == 0 ? a.qkv : ph == 1 ? a.xb : ph == 2 ? a.h : x_next;
        gemv_phase<W4, NT, TP>(a, c, l, ph, in, res, out);
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
  auto none = []() {};
  GridBarrier<decltype(none)> gb{none};
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

// raised-limit bits a device, by variant (w4, kvq, n-tiles), and of TP by
// n-tiles
unsigned step_raised[2][2][3];
unsigned tp_raised[3];
unsigned barrier_raised;

template <bool W4, bool KVQ, bool TP = false>
auto step_kernel(int nt) {
  return nt == 1 ? decode_step_kernel<W4, KVQ, 1, TP>
                 : nt == 2 ? decode_step_kernel<W4, KVQ, 2, TP> : decode_step_kernel<W4, KVQ, 3, TP>;
}

#define STEP_VARIANT(W4, KVQ, EXPR)             \
  (W4 ? (KVQ ? EXPR(true, true) : EXPR(true, false)) \
      : (KVQ ? EXPR(false, true) : EXPR(false, false)))

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The checks both entries make of the attention's plan at pos, and of the
// grid.
bool attention_ok(int H, int pos, int cluster, int blocks, int slots, int heads, int chunks,
                  int stages) {
  const int n_chunks = (pos + dattn::CHUNK - 1) / dattn::CHUNK;
  return cluster >= 1 && cluster <= MAX_CLUSTER && blocks >= cluster && blocks % cluster == 0 &&
         slots >= 2 && slots <= MAX_SLOTS && heads >= 1 && heads <= dattn::MAX_HEADS &&
         H % heads == 0 && chunks >= 1 && chunks * cluster >= n_chunks &&
         (n_chunks == 0 || chunks == (n_chunks + cluster - 1) / cluster) && stages >= 1 &&
         stages <= dattn::MAX_STAGES && stages <= chunks;
}

// The occupancy check and the launch of one variant's kernel.
template <typename K>
cudaError_t run(K kernel, unsigned& raised, const Args& a, cudaStream_t s) {
  const Plan& p = a.p;
  cudaError_t err = raise_smem(kernel, raised, s);
  int resident = 0;
  if (err == cudaSuccess) err = occupancy(kernel, raised, p.cluster, p.smem, &resident);
  if (err != cudaSuccess) return err;
  if (resident * p.cluster < p.blocks) return cudaErrorCooperativeLaunchTooLarge;
  return launch(kernel, p.blocks, p.cluster, p.smem, false, s, a);
}

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
  auto split_ok = [&](int K, int split, int span, int half) {
    const int unit = w4 ? 2 * half : CB;
    return (split == 1 || split == cluster) && span % unit == 0 && span * (split - 1) < K &&
           span * split >= K && (!w4 || (half % 16 == 0 && K % (2 * half) == 0));
  };
  if (L < 1 || L > MAX_LAYERS || M < 1 || M > MAXM || D != H * dattn::DH || F < 16 || F % 64 != 0 ||
      S < 1 || pos < 0 || pos >= S || group < 1 || M % group != 0 || (group > 1 && !anc) ||
      (w4 != (half_f > 0)) || (kvq && H > dattn::SCALE_HALF) ||
      !attention_ok(H, pos, cluster, blocks, slots, heads, chunks, stages) ||
      !split_ok(D, split_d, span_d, half_d) || !split_ok(F, split_f, span_f, half_f) ||
      split_d != 1 || split_f != cluster || (xslots != 2 && xslots != L + 1) ||
      !aligned16(layers) || !aligned16(x_in) || !aligned16(xs) || !aligned16(qkv) ||
      !aligned16(att) || !aligned16(xb) || !aligned16(h) || !aligned16(ck) || !aligned16(cv) ||
      !aligned16(kv_valid))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const Layer*>(layers), static_cast<const bf16*>(x_in), static_cast<bf16*>(xs),
         static_cast<bf16*>(qkv), static_cast<bf16*>(att), static_cast<bf16*>(xb),
         static_cast<bf16*>(h), {ck, nullptr}, {cv, nullptr}, static_cast<bf16*>(kvs),
         static_cast<const uint8_t*>(kv_valid), static_cast<const int*>(anc),
         static_cast<unsigned*>(bar), static_cast<unsigned long long*>(trace), L, M, D, H, F, S,
         pos, group, half_d, half_f, xslots,
         scale, {}};
  Plan& p = a.p;
  p.cluster = cluster, p.blocks = blocks, p.slots = slots;
  p.split_d = split_d, p.span_d = span_d, p.split_f = split_f, p.span_f = span_f;
  p.heads = heads, p.chunks = chunks, p.stages = stages;
  layout(p, M, D, F, w4, 1);
  const dattn::Plan ap{heads, chunks, cluster, stages};
  if (p.smem != smem || smem > SMEM_MAX || dattn::layout(ap, kvq).smem > p.region)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RUN(W, Q) run(step_kernel<W, Q>(p.nt), step_raised[W][Q][p.nt - 1], a, s)
  return (int)STEP_VARIANT(w4, kvq, RUN);
#undef RUN
}

// The resident clusters of `cluster` blocks for K6's kernel (the TP
// variant: int8 weights, the bf16 cache) with nt n-tiles of rows at `smem`
// bytes of shared memory; into *clusters.
extern "C" int decode_step_tp_occupancy(int nt, int cluster, int smem, int* clusters) {
  if (nt < 1 || nt > 3 || cluster < 1 || cluster > MAX_CLUSTER || smem < 0 || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  return (int)occupancy(step_kernel<false, false, true>(nt), tp_raised[nt - 1], cluster, smem,
                        clusters);
}

// K6 with both tp shards on this card: as decode_step_launch with int8
// weights and the bf16 cache, for the tree of parallel/mesh.py::
// shard_gpt2_tp. layers: (L, 2) weight tables, shard 0's then shard 1's a
// layer (c_attn and c_fc: the shard's rows; the c_proj weights: its
// columns, with the full scale and bias); qkv (2, M, 3D/2), att (2, M, D/2),
// h (2, M, F/2) bf16 scratch; ck0, cv0, ck1, cv1: each shard's (L, M, S,
// D/2) bf16 cache; D, H, F the model's. The plan is ops/decode_step.py::
// step_tp_plan's: split_d 1 (K = D), split_f / span_f the split of a
// shard's K = F/2, cluster 2 split_f.
extern "C" int decode_step_tp_launch(const void* layers, const void* x_in, void* xs, int xslots,
                                     void* qkv, void* att, void* xb, void* h, void* ck0,
                                     void* cv0, void* ck1, void* cv1, const void* kv_valid,
                                     const void* anc, void* bar, void* trace, int L, int M, int D,
                                     int H, int F, int S, int pos, int group, float scale,
                                     int cluster, int blocks, int slots, int split_d, int span_d,
                                     int split_f, int span_f, int heads, int chunks, int stages,
                                     int smem, void* stream) {
  const int Dl = D / 2, Fl = F / 2;
  if (L < 1 || L > MAX_LAYERS || M < 1 || M > MAXM || D != H * dattn::DH || H % 2 != 0 ||
      F < 32 || F % 64 != 0 || S < 1 || pos < 0 || pos >= S || group < 1 || M % group != 0 ||
      (group > 1 && !anc) || !attention_ok(H / 2, pos, cluster, blocks, slots, heads, chunks, stages) ||
      split_d != 1 || span_d != D || split_f < 1 || cluster != 2 * split_f ||
      span_f % CB != 0 || span_f * (split_f - 1) >= Fl || span_f * split_f < Fl ||
      (xslots != 2 && xslots != L + 1) || Dl % CB != 0 || !aligned16(layers) ||
      !aligned16(x_in) || !aligned16(xs) || !aligned16(qkv) || !aligned16(att) ||
      !aligned16(xb) || !aligned16(h) || !aligned16(ck0) || !aligned16(cv0) || !aligned16(ck1) ||
      !aligned16(cv1) || !aligned16(kv_valid))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const Layer*>(layers), static_cast<const bf16*>(x_in), static_cast<bf16*>(xs),
         static_cast<bf16*>(qkv), static_cast<bf16*>(att), static_cast<bf16*>(xb),
         static_cast<bf16*>(h), {ck0, ck1}, {cv0, cv1}, nullptr,
         static_cast<const uint8_t*>(kv_valid), static_cast<const int*>(anc),
         static_cast<unsigned*>(bar), static_cast<unsigned long long*>(trace), L, M, D, H, F, S,
         pos, group, 0, 0, xslots,
         scale, {}};
  Plan& p = a.p;
  p.cluster = cluster, p.blocks = blocks, p.slots = slots;
  p.split_d = split_d, p.span_d = span_d, p.split_f = split_f, p.span_f = span_f;
  p.heads = heads, p.chunks = chunks, p.stages = stages;
  layout(p, M, D, Fl, false, 2);
  const dattn::Plan ap{heads, chunks, cluster, stages};
  if (p.smem != smem || smem > SMEM_MAX || dattn::layout(ap, false).smem > p.region)
    return (int)cudaErrorInvalidValue;
  return (int)run(step_kernel<false, false, true>(p.nt), tp_raised[p.nt - 1], a,
                  static_cast<cudaStream_t>(stream));
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
