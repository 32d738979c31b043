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
//
// Both variants are templates on E, the type of the activations coming in
// (x), of the non-int8 cache and of the tree's biases and LayerNorm vectors:
// bf16, or fp16 for IndexTTS2(use_fp16=True) with a quantization. The body
// stays the TPU kernel's bf16 (it takes x.astype(bf16) and casts its k / v
// blocks to bf16; its f32 rows are `row3`'s exact casts): x is rounded to
// bf16 once, at entry, each fp16 cache element as it is read from the ring
// (decode_attention_core.cuh), the biases and LayerNorm vectors are read
// exactly into f32, and the token's k / v rows are written at E. Layer 0
// stages x from x_in with the rounding, and its residual reads the bf16 copy
// the blocks write into xs slot 0 at entry (slot 0 is next written by layer
// 1's MLP projection, or never when every layer's input is kept). The step's
// output (xs) stays bf16; the wrapper casts it to E. Given bf16 copies of
// its fp16 inputs, the bf16 instantiation returns the same bits. The int8
// cache's scale rows stay bf16 at either E.
//
// The kernel's code lives in this header, included by two translation units
// that nvcc compiles in parallel: decode_step.cu (the entry points, and the
// E = bf16 instantiations) and decode_step_fp16.cu (the E = fp16 ones,
// reached through `dstep::run_fp16` / `dstep::occupancy_fp16`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_attention_core.cuh"
#include "gemv_core.cuh"

namespace dstep {

using bf16 = __nv_bfloat16;

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
  const void* bias[PHASES];  // E
  const void* ln[4];         // E: ln_1 weight, bias; ln_2 weight, bias
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
  const void* x_in;     // (M, D) E: layer 0's input
  bf16* xs;             // (xslots, M, D): layer l's input at l % xslots (l >= 1);
                        // E = fp16: bf16(x_in) at slot 0 (layer 0's residual)
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

}  // namespace dstep

namespace {

using namespace dstep;

using attn_tma::cluster_wait;
using attn_tma::mbar_expect_tx;
using attn_tma::mbar_init;
using attn_tma::mbar_wait;
using attn_tma::smem_addr;

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
  bf16* ln;               // the LayerNorm vectors of the current layer (ln_1 w, b, ln_2 w,
                          // b), each D values of E
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
// the cluster. ``xe`` (non-null: layer 0's qkv at E = fp16) is x at E,
// rounded to bf16 as it is staged.
template <bool W4, int NT, bool TP, typename E>
__device__ __forceinline__ void gemv_phase(const Args& a, Ctx& c, int l, int ph, const bf16* x,
                                           const E* xe, const bf16* res, bf16* out) {
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
    const E* bias = nullptr;
    if constexpr (TP) {
      if (ph == 0 || ph == 2) {  // tile i is shard i % 2's tile i / 2, and the
        const int i0 = o.first + j0 * o.stride, shard = i0 % 2;  // stride is even
        N = sh.N / 2, n0 = 16 * (i0 / 2), tstride = o.stride / 2;
        wb += shard, dst += (size_t)shard * a.M * N;
      }
    }
    bias = static_cast<const E*>(wb->bias[ph]);
    const int per = slabs * tiles * NT * 128;  // floats of a warp's sums of the batch
    gemv::Pre pre;
    if (rank == 0)
      pre = gemv::pre_read<TP, E>(wb->scale[ph], bias, res, epi, a.M, N, n0, tiles, tstride);
    if (j0 == 0) {
      if constexpr (attn_tma::is_f16<E>) {
        if (xe)
          gemv::stage_x<false, E>(xe, nullptr, nullptr, xrows, sh.K, kb, ks, st);
        else
          gemv::stage_x<false>(x, nullptr, nullptr, xrows, sh.K, kb, ks, st);
      } else {
        gemv::stage_x<false>(x, nullptr, nullptr, xrows, sh.K, kb, ks, st);
      }
      if (ln) {  // the block spans K (split_d is 1): the statistics from the staged rows
        stamp(a, l, 30 + ph / 2);  // x's rows staged
        st.lnw = lnbuf, st.lnb = lnbuf + a.D;
        gemv::layer_norm_staged<E>(a.M, sh.K, ks, st);
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
        gemv::epilogue<NT, TP, E>(red, per, false, a.M, N, n0, tiles, tstride, epi,
                                  wb->scale[ph], bias, res, dst, pre);
      }
      c.rpar ^= 1;
    } else if (slabs == 2) {  // each slab's warps in turn, then lo + hi
      const int half = per / 2;
      gemv::sum_warps(red, per);
      __syncthreads();
      gemv::sum_shards(red, red + half, half, 1);
      __syncthreads();
      gemv::epilogue<NT, TP, E>(red, half, false, a.M, N, n0, tiles, tstride, epi,
                                wb->scale[ph], bias, res, dst, pre);
    } else {
      gemv::epilogue<NT, TP, E>(red, per, true, a.M, N, n0, tiles, tstride, epi,
                                wb->scale[ph], bias, res, dst, pre);
    }
    __syncthreads();  // the sums are read
    if (j0 == 0) stamp(a, l, 13 + 4 * ph);  // its epilogue (and refill) done
  }
}

// The attention phase of layer l: (row, head span) units round-robin over
// the clusters, each split over the cluster's ranks. TP: (shard, row, head
// span) units, shard 0's first, each over its shard's qkv, cache and
// output at H / 2 heads.
template <bool KVQ, bool TP, typename E>
__device__ __forceinline__ void attention_phase(const Args& a, Ctx& c, int l) {
  using T = dattn::cache_t<KVQ, E>;
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
    dattn::attend<KVQ, E>(at, c.region, c.abar, c.rank, run, (v % spans) * p.heads, v / spans,
                          c.apar);
    c.apar ^= 1;
  }
}

template <bool W4, bool KVQ, int NT, bool TP, typename E>
__global__ void __launch_bounds__(THREADS, 1)
decode_step_kernel(const Args a) {
  constexpr int shards = TP ? 2 : 1;
  constexpr bool CONV = attn_tma::is_f16<E>;  // x_in is not bf16
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
  if constexpr (CONV)  // bf16(x_in) into slot 0 for layer 0's residual (read after two barriers)
    for (int u = blockIdx.x * THREADS + threadIdx.x; u < (int)(md / 8); u += p.blocks * THREADS)
      reinterpret_cast<uint4*>(a.xs)[u] =
          attn_tma::to_bf16x8<E>(gemv::load16(static_cast<const E*>(a.x_in) + 8 * (size_t)u));

  for (int l = 0; l < a.L; ++l) {
    const bf16* x = l == 0 ? (CONV ? a.xs : static_cast<const bf16*>(a.x_in))
                           : a.xs + (l % a.xslots) * md;
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
        attention_phase<KVQ, TP, E>(a, c, l);
      } else {
        const int ph = step == 0 ? 0 : step - 1;
        const bf16* in = ph == 0 ? x : ph == 1 ? a.att : ph == 2 ? a.xb : a.h;
        const E* xe = CONV && l == 0 && ph == 0 ? static_cast<const E*>(a.x_in) : nullptr;
        const bf16* res = ph == 1 ? x : ph == 3 ? a.xb : nullptr;
        bf16* out = ph == 0 ? a.qkv : ph == 1 ? a.xb : ph == 2 ? a.h : x_next;
        gemv_phase<W4, NT, TP, E>(a, c, l, ph, in, xe, res, out);
      }
      stamp(a, l, 2 * step + 1);
      if (step + 1 < STEPS || l + 1 < a.L) {
        gb.sync();
        if (step + 1 < STEPS) stamp(a, l, 2 * step + 2);
      }
    }
  }
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

template <bool W4, bool KVQ, bool TP, typename E>
auto step_kernel(int nt) {
  return nt == 1   ? decode_step_kernel<W4, KVQ, 1, TP, E>
         : nt == 2 ? decode_step_kernel<W4, KVQ, 2, TP, E>
                   : decode_step_kernel<W4, KVQ, 3, TP, E>;
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

// The occupancy query (resident clusters of `cluster` blocks at `smem`
// bytes of shared memory) and the launch of the E instantiation of K1's
// variant (w4, kvq) or of K6's (tp), by the rows' n-tiles; each variant's
// raised-limit bits a device kept here.
template <typename E>
unsigned& raised_bits(bool w4, bool kvq, bool tp, int nt) {
  static unsigned bits[2][2][2][3];
  return bits[w4][kvq][tp][nt - 1];
}

#define STEP_VARIANT(W4, KVQ, TP, EXPR)                                      \
  (TP ? EXPR(false, false, true)                                             \
      : W4 ? (KVQ ? EXPR(true, true, false) : EXPR(true, false, false))      \
           : (KVQ ? EXPR(false, true, false) : EXPR(false, false, false)))

template <typename E>
cudaError_t variant_occupancy(bool w4, bool kvq, bool tp, int nt, int cluster, int smem,
                              int* clusters) {
#define OCC(W, Q, T) \
  occupancy(step_kernel<W, Q, T, E>(nt), raised_bits<E>(W, Q, T, nt), cluster, smem, clusters)
  return STEP_VARIANT(w4, kvq, tp, OCC);
#undef OCC
}

template <typename E>
cudaError_t variant_run(bool w4, bool kvq, bool tp, const Args& a, cudaStream_t s) {
#define RUN(W, Q, T) run(step_kernel<W, Q, T, E>(a.p.nt), raised_bits<E>(W, Q, T, a.p.nt), a, s)
  return STEP_VARIANT(w4, kvq, tp, RUN);
#undef RUN
}

#undef STEP_VARIANT

}  // namespace
