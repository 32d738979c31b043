// K7a / K7b and the four projections of K1: weight-only int8 or int4
// matrix-vector product for a handful of rows, y = x @ q^T, with an optional
// LayerNorm prologue and an optional scale / bias / gelu_new / residual
// epilogue.
//
// Replaces the TPU kernels indextts_tpu/ops/pallas/int8_matmul.py::
// int8_matvec (K7a) and ::int8_mlp (K7b, two launches of this kernel: fc with
// the gelu epilogue, then proj), and the weight streaming of the dense
// layers inside indextts_tpu/ops/pallas/decode_step.py::fused_decode_step
// (decode_step.py:460), int8 and its W4 variant (int4 weights, `consume_w`
// and `unpack4` there). Same math as the TPU kernels:
//   - prologue (optional): LayerNorm of each of the M input rows in f32
//     (two-pass mean and variance, eps 1e-5), times w plus b, rounded to bf16;
//   - int8 (or int4) -> bf16 is exact, a bf16 x bf16 product is exact in f32,
//     and the products are summed in f32 (only the order of the sum differs);
//   - epilogue: none (f32 out, K7a), or acc * scale + bias in f32 rounded to
//     bf16, then either gelu_new on that bf16 value in f32 rounded again, or
//     a bf16 residual add x + bf16(...).
//
// W4 (half_span h > 0): the weight is (N, K/2) int8, two values a byte along
// the contraction axis (nn.quantize_dense_int4): in each group of 2h input
// columns, the lo nibble of packed byte j holds column j and its hi nibble
// column h + j (h = 320 at the shipped widths, or one group spanning the row).
//
// What bounds it on the H100: decode runs M = B*K <= 24 rows (3 on the main
// path), so it does 2*M flops per weight value: it is bound by reading the
// weight once, 4.9 MB int8 (2.5 MB int4) at the qkv shape (3840 x 1280),
// ~1.5 us (~0.7 us) at 3.35 TB/s. Reaching that rate needs ~2.3 MB in flight
// across the card (3.35 TB/s x ~0.7 us of loaded latency): about half the qkv
// weight, so each block has to ask for its whole share of the weight at once.
// The design, with the launch plan (`ops/int8.py::gemv_plan`: 16-row tiles a
// block, split, span, shared-memory bytes) passed in:
//   1. The weight at entry. A block owns one tile of 16 output rows (up to 4
//      where one would make more blocks than two an SM) x one split's span of
//      K (<= 1280 columns: <= 20 KB a tile). Before any other work, one thread
//      issues TMA bulk copies (cp.async.bulk global -> shared) of the block's
//      whole slab, each tile completing on its own mbarrier: one copy a tile
//      when the block spans K (the tile's rows are contiguous), one a row
//      otherwise. So the card's in-flight need is met from the first cycle,
//      and the block computes tile r while tile r + 1 lands. Meanwhile the
//      threads stage x's M rows over the span (and the LayerNorm vectors) in
//      shared memory, each issuing its 16-byte loads together; the LayerNorm
//      runs in place (statistics one warp a row, from device memory only when
//      K is split). x over a span is <= 61 KB (M = 24), never staged in K
//      tiles. (Staging x by TMA as well was slower: every block of the grid
//      asks for the same few KB at once.)
//   2. Tensor cores for the products: mma.sync m16n8k16 bf16 with f32
//      accumulators; A = 16 weight rows x 16 columns dequantised to bf16 in
//      registers, two values an instruction pair: bytes (0, 2) or (1, 3) of a
//      word masked into bf16 0x4300 | (b & 0x7f) = 128 + (b & 0x7f) and 0x4300
//      | (b & 0x80) = 128 or 256, one bf16x2 fma taking the difference;
//      nibbles (0, 4), (1, 5), ... of the biased word masked into 0x4300 (136
//      + v), one fma subtracting 136. B = x^T, the M rows padded to 8, 16 or
//      24 (1-3 n-tiles; padded rows are zero registers). The sum over K may
//      take any order, so the MMA's k index runs over a permutation of the
//      columns: a lane reads 16 weight bytes of each of its rows g and g + 8
//      with one shared load (a 64-byte chunk a row: 64 int8 columns, 4
//      k-steps, or 128 int4 columns, 8 k-steps), and its B fragments are x's
//      matching columns, read in natural order and paired by one __byte_perm
//      each (for int4 the lo-nibble columns j and hi-nibble columns h + j of a
//      group). x's rows sit 16 bytes past a multiple of 128 in shared memory,
//      so a phase's loads hit distinct banks. Each warp keeps two accumulator
//      sets (even and odd k-steps), halving its chain of dependent MMAs.
//   3. Split-K in a fixed order, in one launch: a block owns at most 1280
//      columns of K (int4: whole nibble groups), so K = 5120 (mlp-proj)
//      runs in clusters of 4 blocks and K6's K = 2560 in clusters of 2. Each
//      block sums its 8 warps' accumulators in warp order; each peer then
//      writes its sums into its own slot in rank 0's shared memory
//      (distributed shared memory, st.async, counted on rank 0's mbarrier);
//      rank 0 adds ranks 1..s-1 in turn and runs the epilogue. No scratch in
//      device memory, no atomics, no second launch, no memory fence, and one
//      cluster barrier (arrived at entry, waited on before the writes) so
//      that rank 0's mbarrier is initialised before any peer writes.
// A warp takes the chunks w, w + 8, ... of its span in order, and the split
// follows from K alone, so the f32 sum order of an output depends on K only,
// never on N or the row's place in its tile: the same bits from run to run,
// and K6's qkv shard (N = 1920) equals the unsharded qkv (N = 3840) column
// for column.
// Measured on the H100 (PERF.md): at the qkv shape about 3x the byte
// bound, on par with cuBLAS's bf16 GEMV; what remains is the launch, the
// slab's wait, x's staging and the epilogue, and a dequantise loop bound by
// instruction issue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_core.cuh"  // the arithmetic, shared with decode_step.cu

namespace {

using namespace gemv;
using attn_tma::cluster_arrive;
using attn_tma::cluster_wait;
using attn_tma::mbar_expect_tx;
using attn_tma::mbar_init;
using attn_tma::mbar_wait;
using attn_tma::smem_addr;

constexpr int MAXRT = 4;        // 16-row tiles a block
constexpr int MAXSPLIT = 8;     // blocks of a cluster

struct Plan {
  int rows, split, span;  // as ops/int8.py::gemv_plan
  int sw, sx;             // shared row strides (weights, x)
  int nt;                 // n-tiles
  int x_off, ln_off, red_off, bar_off, stat_off, smem;
};

// The shared-memory layout; the same formula as ops/int8.py::_gemv_smem:
// the weight slab (+ one chunk of overrun), x's M rows of a span (16 bytes
// past a multiple of 128, so rows g and g + 1 fall on other banks), the
// LayerNorm vectors of the span, the warps' partial sums and the cluster
// peers' (rank 0's slots), the mbarriers (one a tile, one for the peers)
// and the row statistics.
__host__ __device__ inline void layout(Plan& p, int M, int K, bool w4) {
  const int span_bytes = w4 ? p.span / 2 : p.span;
  p.sw = p.split == 1 ? (w4 ? K / 2 : K) : span_bytes;  // one copy a tile, or a row
  p.sx = x_stride(p.span);
  p.nt = (M + 7) / 8;
  p.x_off = (16 * p.rows * p.sw + CB + 15) / 16 * 16;
  p.ln_off = p.x_off + M * p.sx;
  p.red_off = p.ln_off + 2 * p.span * 2;
  p.bar_off = p.red_off + (WARPS + p.split - 1) * p.rows * p.nt * 32 * 4 * 4;
  p.stat_off = p.bar_off + 48;
  p.smem = p.stat_off + 2 * MAXM * 4;
}

struct Args {
  const bf16* x;
  const int8_t* q;
  const bf16* ln_w;
  const bf16* ln_b;
  const float* scale;
  const bf16* bias;
  const bf16* res;
  void* out;
  int M, N, K, half, epi;
  Plan p;
};

template <bool LN, bool W4, int NT>
__global__ void __launch_bounds__(THREADS, 2)
int8_gemv_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& p = a.p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rank = blockIdx.x % p.split;
  const int n0 = (blockIdx.x / p.split) * 16 * p.rows;
  const int kb = rank * p.span, ks = min(p.span, a.K - kb);  // this split's columns
  const int rb = W4 ? ks / 2 : ks;                              // its bytes of a row
  XStage st;
  st.xs = smem + p.x_off;
  st.sx = p.sx;
  st.lnw = reinterpret_cast<bf16*>(smem + p.ln_off);
  st.lnb = st.lnw + p.span;
  st.mu = reinterpret_cast<float*>(smem + p.stat_off);
  st.rstd = st.mu + MAXM;
  const uint32_t wbar = smem_addr(smem + p.bar_off), rbar = wbar + 8 * MAXRT;
  const int rows = min(16 * p.rows, a.N - n0), tiles = (rows + 15) / 16;

  // the epilogue's operands of this thread's first output, read at entry so
  // that their latency hides behind the slab's
  Pre pre;
  if (rank == 0) pre = pre_read(a.scale, a.bias, a.res, a.epi, a.M, a.N, n0, tiles, 1);

  // 1. the whole weight slab, requested before anything else, a tile (16
  // rows) an mbarrier
  if (warp == 0) {
    const int row_stride = W4 ? a.K / 2 : a.K;
    const int8_t* src = a.q + (size_t)n0 * row_stride + (W4 ? kb / 2 : kb);
    if (lane == 0) {
      for (int r = 0; r < tiles; ++r) mbar_init(wbar + 8 * r, 1);
      if (p.split > 1 && rank == 0) mbar_init(rbar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      if (p.split > 1 && rank == 0)  // the peers' sums, 4 bytes a float
        mbar_expect_tx(rbar, (p.split - 1) * p.rows * NT * 32 * 4 * 4);
      for (int r = 0; r < tiles; ++r) {
        const int n = min(16, rows - 16 * r);
        mbar_expect_tx(wbar + 8 * r, n * rb);
        if (p.split == 1)  // the tile's rows are contiguous
          bulk_copy(smem_addr(smem + 16 * r * p.sw), src + (size_t)16 * r * row_stride, n * rb,
                    wbar + 8 * r);
      }
    }
    __syncwarp();
    if (p.split > 1)
      for (int r = lane; r < rows; r += 32)
        bulk_copy(smem_addr(smem + r * p.sw), src + (size_t)r * row_stride, rb,
                  wbar + 8 * (r / 16));
  }
  if (p.split > 1) cluster_arrive();  // rank 0's barrier for the peers initialised

  // x's M rows over the span (and the LayerNorm vectors, LayerNorm in
  // place) into shared memory while the slab streams in
  stage_x<LN>(a.x, a.ln_w, a.ln_b, a.M, a.K, kb, ks, st);

  // 2. products: a tile's while the next lands
  float* red = reinterpret_cast<float*>(smem + p.red_off);
  const int per = p.rows * NT * 32 * 4;  // floats of a warp's partial sums
  for (int r = 0; r < tiles; ++r) {
    mbar_wait(wbar + 8 * r, 0);
    tile_products<W4, NT>(smem + 16 * r * p.sw, p.sw, st, a.M, kb, ks, a.half,
                          red + warp * per + r * NT * 32 * 4);
  }

  // 3. fixed-order sums: the two sets (above), the warps in turn (in the
  // epilogue when K is not split), then the cluster's ranks in turn: each
  // peer writes its block sum into its slot in rank 0's shared memory
  // (st.async, counted on rank 0's mbarrier); rank 0 waits, adds the slots
  // of ranks 1..s-1 in order and runs the epilogue
  __syncthreads();
  if (p.split > 1) {
    sum_warps(red, per);
    float* slots = red + WARPS * per;  // rank s at slots + (s - 1) * per
    __syncthreads();                   // the block sum complete
    cluster_wait();
    if (rank != 0) {
      send_to_rank0(red, slots, per, rank, smem + p.bar_off + 8 * MAXRT);
      return;
    }
    mbar_wait(rbar, 0);
    sum_peers(red, slots, per, p.split);
    __syncthreads();
  }

  // 4. epilogue
  epilogue<NT>(red, per, p.split == 1, a.M, a.N, n0, tiles, 1, a.epi, a.scale, a.bias, a.res,
               a.out, pre);
}

// The dynamic shared-memory limit is raised once per device for each
// instantiation, at its first launch outside a graph capture.
template <bool LN, bool W4, int NT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = int8_gemv_kernel<LN, W4, NT>;
  static unsigned raised = 0;  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (a.p.smem > 48 * 1024 && dev < 32 && !(raised >> dev & 1u)) {
    cudaStreamCaptureStatus cap = cudaStreamCaptureStatusNone;
    err = cudaStreamIsCapturing(stream, &cap);
    if (err != cudaSuccess) return err;
    if (cap != cudaStreamCaptureStatusNone) return cudaErrorStreamCaptureUnsupported;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    raised |= 1u << dev;
  }
  const int blocks = (a.N + 16 * a.p.rows - 1) / (16 * a.p.rows);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * a.p.split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = a.p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.p.split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x: (M, K) bf16; q: (N, K) int8 (K % 16 == 0), or with half_span h > 0 the
// int4 weight (N, K/2) int8 in groups of 2h columns (K % 2h == 0, h % 16 ==
// 0); ln_w, ln_b: (K,) bf16 or null (no LayerNorm); scale (N,) f32 and bias
// (N,) bf16 for every epilogue but 0; res: (M, N) bf16 for epilogue 3; out:
// (M, N) f32 for epilogue 0, else bf16. All contiguous, x, q, ln_w and ln_b
// 16-byte aligned. Epilogue: 0 none, 1 scale + bias, 2 scale + bias +
// gelu_new, 3 scale + bias + residual. The launch plan (rows, split, span,
// smem) is ops/int8.py::gemv_plan's; a plan this entry does not
// recompute to the same shared-memory bytes is refused. Returns
// cudaGetLastError() after the launch.
extern "C" int int8_gemv_launch(const void* x, const void* q, const void* ln_w,
                                const void* ln_b, const void* scale,
                                const void* bias, const void* res, void* out,
                                int M, int N, int K, int half_span,
                                int epilogue, int rows, int split, int span, int smem,
                                void* stream) {
  const bool ln = ln_w != nullptr, w4 = half_span > 0;
  const int unit = w4 ? 2 * half_span : CB;  // a split's granularity
  if (M < 1 || M > MAXM || N < 1 || K < 16 || K % 16 != 0 || epilogue < 0 ||
      epilogue > 3 || half_span < 0 ||
      (w4 && (half_span % 16 != 0 || K % (2 * half_span) != 0)) ||
      rows < 1 || rows > MAXRT || split < 1 || split > MAXSPLIT || span < 1 ||
      span % unit != 0 || span * (split - 1) >= K || span * split < K || !aligned16(x) ||
      !aligned16(q) || (ln && (!aligned16(ln_w) || !aligned16(ln_b))))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
         static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
         static_cast<const float*>(scale), static_cast<const bf16*>(bias),
         static_cast<const bf16*>(res), out, M, N, K, half_span, epilogue, {}};
  a.p.rows = rows, a.p.split = split, a.p.span = span;
  layout(a.p, M, K, w4);
  if (a.p.smem != smem || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define INT8_GEMV_NT(L, W)                                                      \
  (a.p.nt == 1 ? launch<L, W, 1>(a, s) : a.p.nt == 2 ? launch<L, W, 2>(a, s) \
                                                    : launch<L, W, 3>(a, s))
  const cudaError_t err = ln ? (w4 ? INT8_GEMV_NT(true, true) : INT8_GEMV_NT(true, false))
                             : (w4 ? INT8_GEMV_NT(false, true) : INT8_GEMV_NT(false, false));
#undef INT8_GEMV_NT
  return (int)err;
}
