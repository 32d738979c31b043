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

#include "decode_attention_core.cuh"  // the arithmetic, shared with decode_step.cu

namespace {

using namespace dattn;

template <bool KVQ>
__global__ void __launch_bounds__(THREADS, 3)
decode_attention_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rank = blockIdx.x;
  unsigned char* bar_ptr = smem + layout(a.p, KVQ).misc + BAR_OFFSET;
  // 0. rank 0's barrier for the peers' partials, initialised before any
  // peer passes the cluster barrier
  if (a.p.cluster > 1) {
    if (rank == 0 && threadIdx.x == 0) {
      const uint32_t bar = smem_addr(bar_ptr);
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_expect_tx(bar, peer_bytes(a.p, a.pos, 0));
    }
    cluster_arrive();
  }
  attend<KVQ>(a, smem, bar_ptr, rank, rank, blockIdx.y * a.p.heads, blockIdx.z, 0);
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
