"""Weight-only int8 and int4 products for decode: kernels K7a and K7b, the
int4 GEMV of K1's W4 variant, and their plain twins.

`int8_matvec` is the port of `indextts_tpu/ops/pallas/int8_matmul.py::
int8_matvec` and `int8_mlp` of `::int8_mlp`. `int4_matvec` and `int4_mlp`
are the same products on nibble-packed int4 weights (`nn.quantize_dense_int4`),
the weight streaming of `indextts_tpu/ops/pallas/decode_step.py::
fused_decode_step` with ``W4`` (`consume_w` / `unpack4` there). All four
run the hand-written Hopper kernel `csrc/int8_gemv.cu` on CUDA tensors (or
raise); on CPU tensors they run their ``*_plain`` twins, the same
arithmetic in plain PyTorch, which the CPU tests hold against the JAX
kernels and `chip_smoke.py` holds the CUDA kernel against on the card. The
int4 twins unpack the nibbles and run the int8 twins: int4 values are exact
in bf16, so an int4 product equals the int8 product on the unpacked values.

Layout: x (M, K) bf16 with M = B*K <= 24 decode rows; the int8 weight is the
port's (N, K) = (out, in) layout, its per-output-channel scale (N,) f32 and
bias (N,) bf16 (`nn.quantize_dense_int8`); the int4 weight is (N, K/2)
int8, two values a byte in groups of 2h columns along K
(`nn.int4_halfspan`). With no options they return the f32 product, as the
JAX kernels do. The options are the fused prologue and epilogue the fused
decode step (K1, `ops/decode_step.py`) uses:

- ``ln=(w, b)``: LayerNorm of x in f32, rounded to bf16, before the product;
- ``scale, bias``: ``acc * scale + bias`` in f32, rounded to bf16;
- ``residual``: then ``residual + that`` in bf16.

`gemv_plan` is the kernel's launch plan (16-row tiles a block, the split of
K over a thread-block cluster, shared-memory bytes), computed from the
shapes alone and passed to the kernel, which recomputes the shared-memory
layout and refuses a plan that disagrees.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from indextts_tpu_torch import nn
from indextts_tpu_torch.ops import cuda

EPI_NONE, EPI_BIAS, EPI_GELU, EPI_RESIDUAL = range(4)
MAX_ROWS = 24

# The kernel's launch plan (`csrc/int8_gemv.cu`, whose header says why).
SMS = 132                  # the H100's SMs
SPAN = 1280                # columns of K a block owns at most; more split over a cluster
SMEM_MAX = 227 * 1024      # dynamic shared memory a block may use
GEMV_WARPS = 8
MAX_TILES = 4              # 16-row tiles a block owns at most
BLOCKS_PER_SM = 2          # the kernel's __launch_bounds__ minimum
MAX_SPLIT = 8              # blocks of a cluster


class GemvPlan(NamedTuple):
    rows: int    # 16-row tiles a block owns
    split: int   # blocks of a cluster, each owning ``span`` columns of K
    span: int    # columns a split owns (the last one the rest)
    smem: int    # dynamic shared-memory bytes a block


def _gemv_smem(M: int, K: int, rows: int, split: int, span: int, w4: bool) -> int:
    """Shared-memory bytes of a block: the kernel's `layout`
    (`csrc/int8_gemv.cu`) in the same formula."""
    sw = (K // 2 if w4 else K) if split == 1 else (span // 2 if w4 else span)
    x_off = -(-(16 * rows * sw + 64) // 16) * 16
    sx = -(-span * 2 // 128) * 128 + 16
    nt = -(-M // 8)
    red = (GEMV_WARPS + split - 1) * rows * nt * 32 * 16   # the warps' and the peers' sums
    return x_off + M * sx + 4 * span + red + 48 + 2 * MAX_ROWS * 4


def gemv_plan(M: int, N: int, K: int, half: int = 0) -> GemvPlan:
    """The launch plan of `int8_gemv_launch` for x (M, K) and an (N, K) int8
    weight, or with ``half`` > 0 the int4 weight in groups of 2 * half
    columns. K is split in spans of at most SPAN columns (64-column units;
    int4: whole nibble groups) over a cluster of blocks, so the order of the
    f32 sum depends on K alone: the split never depends on N, and K6's qkv
    shard sums as the unsharded qkv does. A block takes one 16-row tile, or
    as many (up to MAX_TILES) as keep the grid within one wave of
    BLOCKS_PER_SM blocks an SM; it computes one tile while the next lands.
    Raises ValueError for a shape no plan fits."""
    w4 = half > 0
    tiles = -(-N // 16)
    unit = 2 * half if w4 else 64
    units = -(-K // unit)
    per = min(units, max(1, SPAN // unit))
    split = -(-units // per)
    for rows in range(min(MAX_TILES, -(-tiles * split // (BLOCKS_PER_SM * SMS))), 0, -1):
        smem = _gemv_smem(M, K, rows, split, per * unit, w4)
        if split <= MAX_SPLIT and smem <= SMEM_MAX:
            return GemvPlan(rows, split, per * unit, smem)
    raise ValueError(f"int8 gemv: no launch plan takes x ({M}, {K}) and a weight of {N} rows "
                     f"(at most {MAX_SPLIT} splits of {SPAN} columns, {SMEM_MAX} bytes of "
                     f"shared memory)")


LN = Optional[Tuple[torch.Tensor, torch.Tensor]]


def layer_norm_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (two-pass statistics), ``y * w + b`` rounded to bf16."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()).to(torch.bfloat16)


def gelu_new_bf16(v: torch.Tensor) -> torch.Tensor:
    """GPT-2's tanh GELU of a bf16 value, computed in f32, rounded to bf16."""
    h = v.float()
    return (0.5 * h * (1.0 + torch.tanh(0.7978845608028654 * (h + 0.044715 * h * h * h)))
            ).to(torch.bfloat16)


def _gemv_plain(x, q, ln: LN, scale, bias, epilogue: int, residual):
    if ln is not None:
        x = layer_norm_bf16(x, *ln)
    acc = x.float() @ q.float().t()
    if epilogue == EPI_NONE:
        return acc
    v = (acc * scale.float() + bias.float()).to(torch.bfloat16)
    if epilogue == EPI_GELU:
        return gelu_new_bf16(v)
    if epilogue == EPI_RESIDUAL:
        return residual + v
    return v


def _check(name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} {tuple(shape)} on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _gemv_cuda(x, q, ln: LN, scale, bias, epilogue: int, residual, w4: bool = False):
    """One launch of `int8_gemv_launch` (``w4``: q is int4 nibble-packed);
    validates what the kernel takes."""
    if x.device.type != "cuda":
        raise ValueError(f"int8 gemv: unsupported device {x.device}")
    dev = x.device
    M, K = x.shape
    N = q.shape[0]
    if not 1 <= M <= MAX_ROWS or K % (32 if w4 else 16):
        raise ValueError(f"int8 gemv: kernel takes 1..{MAX_ROWS} rows and K % "
                         f"{32 if w4 else 16} == 0, got x {tuple(x.shape)}")
    half_span = nn.int4_halfspan(K // 2) if w4 else 0
    plan = gemv_plan(M, N, K, half_span)
    _check("int8 gemv x", x, torch.bfloat16, (M, K), dev)
    _check("int8 gemv q", q, torch.int8, (N, K // 2 if w4 else K), dev)
    if ln is not None:
        for t in ln:
            _check("int8 gemv LayerNorm weight", t, torch.bfloat16, (K,), dev)
    if epilogue != EPI_NONE:
        _check("int8 gemv scale", scale, torch.float32, (N,), dev)
        _check("int8 gemv bias", bias, torch.bfloat16, (N,), dev)
    if epilogue == EPI_RESIDUAL:
        _check("int8 gemv residual", residual, torch.bfloat16, (M, N), dev)
    if any(t.data_ptr() % 16 for t in (x, q, *(ln or ()))):
        raise ValueError("int8 gemv: x, the weight and the LayerNorm vectors must be "
                         "16-byte aligned (the weight is read with TMA bulk copies)")
    out = torch.empty((M, N), dtype=torch.float32 if epilogue == EPI_NONE else torch.bfloat16,
                      device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        code = cuda.library().int8_gemv_launch(
            x.data_ptr(), q.data_ptr(), *(ptr(t) for t in (ln or (None, None))),
            ptr(scale), ptr(bias), ptr(residual), out.data_ptr(), M, N, K, half_span,
            epilogue, *plan, cuda.stream_ptr(x))
    cuda.check(code, "int8_gemv")
    return out


def _epilogue(scale, bias, residual) -> int:
    if scale is None:
        if bias is not None or residual is not None:
            raise ValueError("bias / residual need the scale epilogue")
        return EPI_NONE
    return EPI_BIAS if residual is None else EPI_RESIDUAL


def int8_matvec_plain(x: torch.Tensor, q: torch.Tensor, *, ln: LN = None,
                      scale=None, bias=None, residual=None) -> torch.Tensor:
    """The plain twin of `int8_matvec` (any device)."""
    return _gemv_plain(x, q, ln, scale, bias, _epilogue(scale, bias, residual), residual)


def int8_matvec(x: torch.Tensor, q: torch.Tensor, *, ln: LN = None, scale=None,
                bias=None, residual=None) -> torch.Tensor:
    """K7a: (M, K) bf16 @ (N, K)^T int8 -> (M, N) f32, or bf16 with the
    scale / bias (/ residual) epilogue; ``ln`` LayerNorms x first. CPU tensors
    run the plain twin; CUDA tensors launch the kernel; anything else raises."""
    cuda.refuse_grad("int8_matvec", x, ln, scale, bias, residual)
    epi = _epilogue(scale, bias, residual)
    if x.device.type == "cpu":
        return _gemv_plain(x, q, ln, scale, bias, epi, residual)
    out = _gemv_cuda(x, q, ln, scale, bias, epi, residual)
    int8_matvec.launches += 1
    return out


def int8_mlp_plain(x: torch.Tensor, w1q: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                   w2q: torch.Tensor, *, ln: LN = None, scale2=None, bias2=None,
                   residual=None) -> torch.Tensor:
    """The plain twin of `int8_mlp` (any device)."""
    h = _gemv_plain(x, w1q, ln, s1, b1, EPI_GELU, None)
    return _gemv_plain(h, w2q, None, scale2, bias2, _epilogue(scale2, bias2, residual),
                       residual)


def int8_mlp(x: torch.Tensor, w1q: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
             w2q: torch.Tensor, *, ln: LN = None, scale2=None, bias2=None,
             residual=None) -> torch.Tensor:
    """K7b: gelu_new(x @ w1q^T * s1 + b1) @ w2q^T -> (M, K) f32, with w1q
    (F, K) and w2q (K, F) int8; the hidden activation is rounded to bf16
    after the bias and again after gelu_new. ``scale2, bias2`` (and
    ``residual``) apply the second layer's epilogue, ``ln`` LayerNorms x
    first. Two launches of the GEMV kernel; CPU tensors run the plain twin."""
    cuda.refuse_grad("int8_mlp", x, ln, s1, b1, scale2, bias2, residual)
    epi2 = _epilogue(scale2, bias2, residual)
    if x.device.type == "cpu":
        return int8_mlp_plain(x, w1q, s1, b1, w2q, ln=ln, scale2=scale2, bias2=bias2,
                              residual=residual)
    h = _gemv_cuda(x, w1q, ln, s1, b1, EPI_GELU, None)
    out = _gemv_cuda(h, w2q, None, scale2, bias2, epi2, residual)
    int8_mlp.launches += 1
    return out


def int4_matvec_plain(x: torch.Tensor, q4: torch.Tensor, *, ln: LN = None,
                      scale=None, bias=None, residual=None) -> torch.Tensor:
    """The plain twin of `int4_matvec` (any device)."""
    return int8_matvec_plain(x, nn.unpack_int4(q4), ln=ln, scale=scale, bias=bias,
                             residual=residual)


def int4_matvec(x: torch.Tensor, q4: torch.Tensor, *, ln: LN = None, scale=None,
                bias=None, residual=None) -> torch.Tensor:
    """`int8_matvec` on int4 weights q4 (N, K/2) (`nn.quantize_dense_int4`),
    the nibbles unpacked in the kernel. CPU tensors run the plain twin; CUDA
    tensors launch the kernel; anything else raises."""
    cuda.refuse_grad("int4_matvec", x, ln, scale, bias, residual)
    epi = _epilogue(scale, bias, residual)
    if x.device.type == "cpu":
        return int4_matvec_plain(x, q4, ln=ln, scale=scale, bias=bias, residual=residual)
    out = _gemv_cuda(x, q4, ln, scale, bias, epi, residual, w4=True)
    int4_matvec.launches += 1
    return out


def int4_mlp_plain(x: torch.Tensor, w1q4: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                   w2q4: torch.Tensor, *, ln: LN = None, scale2=None, bias2=None,
                   residual=None) -> torch.Tensor:
    """The plain twin of `int4_mlp` (any device)."""
    return int8_mlp_plain(x, nn.unpack_int4(w1q4), s1, b1, nn.unpack_int4(w2q4), ln=ln,
                          scale2=scale2, bias2=bias2, residual=residual)


def int4_mlp(x: torch.Tensor, w1q4: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
             w2q4: torch.Tensor, *, ln: LN = None, scale2=None, bias2=None,
             residual=None) -> torch.Tensor:
    """`int8_mlp` on int4 weights w1q4 (F, K/2) and w2q4 (K, F/2): two
    launches of the GEMV kernel; CPU tensors run the plain twin."""
    cuda.refuse_grad("int4_mlp", x, ln, s1, b1, scale2, bias2, residual)
    epi2 = _epilogue(scale2, bias2, residual)
    if x.device.type == "cpu":
        return int4_mlp_plain(x, w1q4, s1, b1, w2q4, ln=ln, scale2=scale2, bias2=bias2,
                              residual=residual)
    h = _gemv_cuda(x, w1q4, ln, s1, b1, EPI_GELU, None, w4=True)
    out = _gemv_cuda(h, w2q4, None, scale2, bias2, epi2, residual, w4=True)
    int4_mlp.launches += 1
    return out


int8_matvec.launches = 0
int8_mlp.launches = 0
int4_matvec.launches = 0
int4_mlp.launches = 0
