// The entry points of K1 and K6 co-located (the persistent decode step;
// decode_step.cuh holds the kernel and says what it computes and why) and
// of the bare grid barrier. The E = bf16 instantiations compile here, the
// E = fp16 ones in decode_step_fp16.cu, in parallel.

#include "decode_step.cuh"

namespace dstep {

// decode_step_fp16.cu: `variant_occupancy` / `variant_run` at E = fp16
cudaError_t occupancy_fp16(bool w4, bool kvq, bool tp, int nt, int cluster, int smem,
                           int* clusters);
cudaError_t run_fp16(bool w4, bool kvq, bool tp, const Args& a, cudaStream_t s);

}  // namespace dstep

namespace {

// The bare barrier floor: `barriers` grid barriers on the step's grid.
__global__ void __launch_bounds__(THREADS, 1)
step_barrier_kernel(unsigned* bar, int barriers) {
  auto none = []() {};
  GridBarrier<decltype(none)> gb{none};
  gb.init(bar, gridDim.x);
  for (int i = 0; i < barriers; ++i) gb.sync();
}

unsigned barrier_raised;

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

}  // namespace

// The resident clusters of `cluster` blocks for the step kernel of this
// variant (w4, kvq, fp16 = E is fp16, nt = n-tiles of the rows) at `smem`
// bytes of shared memory, from cudaOccupancyMaxActiveClusters; into
// *clusters.
extern "C" int decode_step_occupancy(int w4, int kvq, int fp16, int nt, int cluster, int smem,
                                     int* clusters) {
  if (nt < 1 || nt > 3 || cluster < 1 || cluster > MAX_CLUSTER || smem < 0 || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  return (int)(fp16 ? dstep::occupancy_fp16(w4, kvq, false, nt, cluster, smem, clusters)
                    : variant_occupancy<bf16>(w4, kvq, false, nt, cluster, smem, clusters));
}

// layers: (L) weight tables (16 device pointers a layer: q, scale, bias of
// c_attn, attn c_proj, c_fc, mlp c_proj, then ln_1 w, b, ln_2 w, b); x_in
// (M, D) bf16; xs (xslots, M, D) bf16: layer l's input (l >= 1) at slot l %
// xslots (2, or L + 1 to keep every layer's; slot 0 is then unused but at
// fp16); qkv (M, 3D),
// att, xb (M, D), h (M, F) bf16 scratch; ck, cv (L, M, S, D) bf16, or int8
// with kvs (L, M, S, 256) bf16 (KVQ); kv_valid (M, S) bool; anc (M, S)
// int32 or null (group 1); bar: the grid barrier's two words (the first's
// low bits 0 at rest); trace: null, or (blocks, L, 34) u64 for each block's
// %globaltimer stamps (the layer loop says where). half_d / half_f: the int4 nibble groups for K = D and K = F (0:
// int8 weights). fp16: x_in, the bf16-cache variant's ck / cv and the
// tables' biases and LayerNorm vectors are fp16 (E), else bf16. The plan is
// ops/decode_step.py::step_plan's; one whose
// layout this entry does not reproduce, or whose grid the occupancy query
// does not allow, is refused. Returns cudaGetLastError() after the launch.
extern "C" int decode_step_launch(const void* layers, const void* x_in, void* xs, int xslots,
                                  void* qkv, void* att, void* xb, void* h, void* ck, void* cv,
                                  void* kvs, const void* kv_valid, const void* anc, void* bar,
                                  void* trace,
                                  int L, int M, int D, int H, int F, int S, int pos, int group,
                                  float scale, int half_d, int half_f, int fp16, int cluster,
                                  int blocks,
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
  Args a{static_cast<const Layer*>(layers), x_in, static_cast<bf16*>(xs),
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
  return (int)(fp16 ? dstep::run_fp16(w4, kvq, false, a, s)
                    : variant_run<bf16>(w4, kvq, false, a, s));
}

// The resident clusters of `cluster` blocks for K6's kernel (the TP
// variant: int8 weights, the bf16 or (fp16) the fp16 cache) with nt n-tiles
// of rows at `smem` bytes of shared memory; into *clusters.
extern "C" int decode_step_tp_occupancy(int fp16, int nt, int cluster, int smem,
                                        int* clusters) {
  if (nt < 1 || nt > 3 || cluster < 1 || cluster > MAX_CLUSTER || smem < 0 || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  return (int)(fp16 ? dstep::occupancy_fp16(false, false, true, nt, cluster, smem, clusters)
                    : variant_occupancy<bf16>(false, false, true, nt, cluster, smem, clusters));
}

// K6 with both tp shards on this card: as decode_step_launch with int8
// weights and the bf16 (fp16: the fp16) cache, for the tree of parallel/mesh.py::
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
                                     int fp16, int cluster, int blocks, int slots, int split_d,
                                     int span_d,
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
  Args a{static_cast<const Layer*>(layers), x_in, static_cast<bf16*>(xs),
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(fp16 ? dstep::run_fp16(false, false, true, a, s)
                    : variant_run<bf16>(false, false, true, a, s));
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
