// K6's all-reduce: the exchange between the two tensor-parallel shards of the
// fused decode step, each shard reading its peer's f32 partial through the
// peer's device pointer.
//
// Replaces the in-kernel all-reduce of the TPU kernel
// indextts_tpu/ops/pallas/decode_step_tp.py::fused_decode_step_tp_shard
// (decode_step_tp.py:367; `all_reduce`, lines 201-216, and the scale / bias /
// residual that follow it at 335-337 and 359-361), whose remote DMA over ICI
// becomes a plain load here. The rest of a shard's layer runs the port's
// other kernels at shard shapes (int8_gemv.cu, decode_attention.cu; see
// ops/decode_step_tp.py). Same math as the TPU kernel, per output element
// (m, n) of a row-parallel projection (attention out-projection or MLP
// down-projection):
//   - acc = lo + hi in f32, lo the partial of tp rank 0 and hi that of rank
//     1 whichever shard runs it, so both shards hold the same sum;
//   - the full per-output-channel int8 scale and the bias apply after the
//     reduce: v = bf16(acc * scale[n] + bias[n]), a product and a sum each
//     rounded to f32 (no fused multiply-add: the plain twin's two torch ops);
//   - out = bf16(residual + v), the bf16 residual add of the TPU kernel.
// So the two shards' residual streams are bit-identical, and so is the
// plain twin on the same partials.
//
// The peer pointer: with both shards on one card (the tp pair co-located on
// two streams, each with its own weights, cache and partials) it is local
// memory; with the shards on two cards it is the peer card's memory, read
// over NVLink once `tp_enable_peer_access` has run for the pair
// (parallel/mesh.py::make_mesh). The kernel is the same for both. Ordering is
// the caller's: a shard's launch waits on the event recorded on the peer's
// stream after the peer's partial product, and each (layer, exchange) has its
// own partial buffers, so no later write races a read.
//
// What bounds it on the H100: it reads two (M, N) f32 partials and the bf16
// residual and writes the bf16 output, ~46 KB at M = 3, N = 1280: bytes, and
// so little that one launch costs more than the transfer. Design: one thread
// per output element (M <= 24 rows, N = 1280), neighbouring threads on
// neighbouring addresses. With both shards on one card the persistent step
// folds this exchange, with the same arithmetic, into its row-parallel
// products (decode_step.cu, TP; gemv_core.cuh's EPI_TP); this kernel serves
// the chain (ops/decode_step_tp.py::fused_decode_step_tp_chain), the route
// of a mesh over two cards.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;

__global__ void tp_allreduce_kernel(const float* __restrict__ lo,
                                    const float* __restrict__ hi,
                                    const float* __restrict__ scale,
                                    const bf16* __restrict__ bias,
                                    const bf16* __restrict__ residual,
                                    bf16* __restrict__ out, int M, int N) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= M * N) return;
  const int n = i % N;
  const float acc = __fadd_rn(lo[i], hi[i]);
  const float v = __bfloat162float(__float2bfloat16(
      __fadd_rn(__fmul_rn(acc, scale[n]), __bfloat162float(bias[n]))));
  out[i] = __float2bfloat16(__fadd_rn(__bfloat162float(residual[i]), v));
}

}  // namespace

// own: this shard's (M, N) f32 partial; peer: the other shard's (on this card
// or, with peer access enabled, on the peer card); rank: this shard's tp index
// (0 or 1), which names the lo and the hi partial.
extern "C" int tp_allreduce_launch(const void* own, const void* peer,
                                   const void* scale, const void* bias,
                                   const void* residual, void* out, int M,
                                   int N, int rank, void* stream) {
  if (M < 1 || N < 1 || (rank != 0 && rank != 1))
    return (int)cudaErrorInvalidValue;
  const float* lo = static_cast<const float*>(rank == 0 ? own : peer);
  const float* hi = static_cast<const float*>(rank == 0 ? peer : own);
  const int blocks = (M * N + THREADS - 1) / THREADS;
  tp_allreduce_kernel<<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      lo, hi, static_cast<const float*>(scale), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(residual), static_cast<bf16*>(out), M, N);
  return (int)cudaGetLastError();
}

// Let kernels on `device` read memory of `peer` (the two cards of a tp pair).
// Returns 0 when access is enabled (or was already), else the CUDA error.
extern "C" int tp_enable_peer_access(int device, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaDeviceEnablePeerAccess(peer, 0);
  cudaSetDevice(prev);
  if (e == cudaErrorPeerAccessAlreadyEnabled) e = cudaSuccess;
  cudaGetLastError();  // leave no error behind for the next launch's check
  return (int)e;
}
