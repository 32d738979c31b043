"""Weight-only int8 products for decode: kernels K7a and K7b and their plain twins.

`int8_matvec` is the port of `indextts_tpu/ops/pallas/int8_matmul.py::
int8_matvec` and `int8_mlp` of `::int8_mlp`. Both run the hand-written
Hopper kernel `csrc/int8_gemv.cu` on CUDA tensors (or raise); on CPU tensors
they run `int8_matvec_plain` / `int8_mlp_plain`, the same arithmetic in
plain PyTorch, which the CPU tests hold against the JAX kernels and
`chip_smoke.py` holds the CUDA kernel against on the card.

Layout: x (M, K) bf16 with M = B*K <= 24 decode rows; the int8 weight is the
port's (N, K) = (out, in) layout, its per-output-channel scale (N,) f32 and
bias (N,) bf16 (`nn.quantize_dense_int8`). With no options both return the
f32 product, as the JAX kernels do. The options are the fused prologue and
epilogue the fused decode step (K1, `ops/decode_step.py`) uses:

- ``ln=(w, b)``: LayerNorm of x in f32, rounded to bf16, before the product;
- ``scale, bias``: ``acc * scale + bias`` in f32, rounded to bf16;
- ``residual``: then ``residual + that`` in bf16.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from indextts_tpu_torch.ops import cuda

EPI_NONE, EPI_BIAS, EPI_GELU, EPI_RESIDUAL = range(4)
MAX_ROWS = 24

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


def _gemv_cuda(x, q, ln: LN, scale, bias, epilogue: int, residual):
    """One launch of `int8_gemv_launch`; validates what the kernel takes."""
    if x.device.type != "cuda":
        raise ValueError(f"int8 gemv: unsupported device {x.device}")
    dev = x.device
    M, K = x.shape
    N = q.shape[0]
    if not 1 <= M <= MAX_ROWS or K % 16:
        raise ValueError(f"int8 gemv: kernel takes 1..{MAX_ROWS} rows and K % 16 == 0, "
                         f"got x {tuple(x.shape)}")
    _check("int8 gemv x", x, torch.bfloat16, (M, K), dev)
    _check("int8 gemv q", q, torch.int8, (N, K), dev)
    if ln is not None:
        for t in ln:
            _check("int8 gemv LayerNorm weight", t, torch.bfloat16, (K,), dev)
    if epilogue != EPI_NONE:
        _check("int8 gemv scale", scale, torch.float32, (N,), dev)
        _check("int8 gemv bias", bias, torch.bfloat16, (N,), dev)
    if epilogue == EPI_RESIDUAL:
        _check("int8 gemv residual", residual, torch.bfloat16, (M, N), dev)
    out = torch.empty((M, N), dtype=torch.float32 if epilogue == EPI_NONE else torch.bfloat16,
                      device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        code = cuda.library().int8_gemv_launch(
            x.data_ptr(), q.data_ptr(), *(ptr(t) for t in (ln or (None, None))),
            ptr(scale), ptr(bias), ptr(residual), out.data_ptr(), M, N, K, epilogue,
            cuda.stream_ptr(x))
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
    epi2 = _epilogue(scale2, bias2, residual)
    if x.device.type == "cpu":
        return int8_mlp_plain(x, w1q, s1, b1, w2q, ln=ln, scale2=scale2, bias2=bias2,
                              residual=residual)
    h = _gemv_cuda(x, w1q, ln, s1, b1, EPI_GELU, None)
    out = _gemv_cuda(h, w2q, None, scale2, bias2, epi2, residual)
    int8_mlp.launches += 1
    return out


int8_matvec.launches = 0
int8_mlp.launches = 0
