"""BigVGAN's anti-aliased SnakeBeta (Activation1d): kernels K3, K5, K3' and
their plain twin.

Three TPU kernels compute this one function, and each has its entry here:
- `antialias_snake` (K3) is the port of `indextts_tpu/ops/pallas/
  antialias.py::fused_antialias_folded`, BigVGAN's activation;
- `fused_antialias_activation` (K5) is `fused_antialias_activation`, K3's
  math on unfolded (T, C) tiles;
- `antialias_activation_prefolded` (K3') is `ops/snake.py::
  antialias_activation_prefolded` over `fused_antialias_prefolded`, K3 on a
  time-folded (B, T/f, f*C) stream.
On the card all three launch the one hand-written Hopper kernel
`csrc/antialias_snake.cu`: they compute the same function on the same bytes
(a folded (B, T/f, f*C) tensor is, row-major, the very (B, T, C) one, so K3'
launches on that view without a copy). The TPU kept separate kernels only
to fill its 128 lanes in different ways, and K3's port already dropped that
lane folding; a second kernel for the same function would carry a TPU
layout over. Each entry keeps its own launch counter (``.launches``). On a
CPU tensor each runs `antialias_snake_plain`, the same math as
`indextts_tpu/ops/snake.py::antialias_activation_xla` in plain PyTorch; a
CUDA tensor launches the kernel or raises.

The kaiser-sinc filters are re-derived here in numpy (the JAX package's
filter code lives in a module that imports jax); they equal its
`up_filter(2)` and `down_filter(2)` exactly.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from indextts_tpu_torch.ops import cuda


def kaiser_window(n: int, beta: float) -> np.ndarray:
    """torch.kaiser_window(periodic=False)."""
    if n == 1:
        return np.ones(1)
    k = np.arange(n, dtype=np.float64)
    alpha = (n - 1) / 2.0
    return np.i0(beta * np.sqrt(1 - ((k - alpha) / alpha) ** 2)) / np.i0(beta)


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """BigVGAN's `filter.kaiser_sinc_filter1d`: (kernel_size,) float32, unit DC gain."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    A = 2.285 * (half_size - 1) * math.pi * (4 * half_width) + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = kaiser_window(kernel_size, beta)
    time = (np.arange(-half_size, half_size) + 0.5 if even
            else np.arange(kernel_size) - half_size)
    if cutoff == 0:
        return np.zeros(kernel_size, np.float32)
    f = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    f /= f.sum()
    return f.astype(np.float32)


@functools.lru_cache(maxsize=4)
def up_filter(ratio: int = 2) -> np.ndarray:
    return kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, int(6 * ratio // 2) * 2)


@functools.lru_cache(maxsize=4)
def down_filter(ratio: int = 2) -> np.ndarray:
    return kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, int(6 * ratio // 2) * 2)


def _taps() -> np.ndarray:
    """The kernel's 24 taps: [2 f[0::2] | 2 f[1::2] | g], f32."""
    f = up_filter(2)
    return np.concatenate([f[0::2] * 2.0, f[1::2] * 2.0, down_filter(2)]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _taps_on(device: str) -> torch.Tensor:
    return torch.as_tensor(_taps(), device=device)


def antialias_snake_plain(x: torch.Tensor, alpha: torch.Tensor,
                          beta: Optional[torch.Tensor],
                          lengths: Optional[torch.Tensor] = None,
                          logscale: bool = True) -> torch.Tensor:
    """Activation1d on (B, T, C): x2 kaiser-sinc upsample (polyphase), SnakeBeta
    with alpha/beta (their logs when ``logscale``; beta None = Snake), 12-tap
    lowpass, x2 down, all in f32; the input is replicate-extended from its
    valid region and the 2x-rate signal edge-replicated with s0[0] (left)
    and s1[L-1] (right)."""
    B, T, C = x.shape
    taps = torch.as_tensor(_taps(), device=x.device)
    f0, f1, g = taps[:6], taps[6:12], taps[12:]
    xf = x.float()
    if lengths is None:
        lengths = torch.full((B,), T, device=x.device)
    lengths = lengths.to(x.device).long()
    last = torch.clamp(lengths - 1, min=0)[:, None, None].expand(B, 1, C)
    edge = torch.gather(xf, 1, last)
    tail = (torch.arange(T, device=x.device)[None, :] < lengths[:, None])[:, :, None]
    xf = torch.where(tail, xf, edge)
    x_ext = torch.cat([xf[:, :1].expand(B, 3, C), xf, edge.expand(B, 4, C)], dim=1)
    p0 = sum(f0[j] * x_ext[:, j:j + T] for j in range(6))
    p1 = sum(f1[j] * x_ext[:, j + 1:j + 1 + T] for j in range(6))
    a = torch.exp(alpha.float()) if logscale else alpha.float()
    b = a if beta is None else (torch.exp(beta.float()) if logscale else beta.float())
    sn0, sn1 = torch.sin(p0 * a), torch.sin(p1 * a)
    s0 = p0 + sn0 * sn0 / (b + 1e-9)
    s1 = p1 + sn1 * sn1 / (b + 1e-9)
    s1_edge = torch.gather(s1, 1, last)
    s0 = torch.where(tail, s0, s1_edge)
    s1 = torch.where(tail, s1, s1_edge)
    left, right = s0[:, :1].expand(B, 3, C), s1_edge.expand(B, 3, C)
    s0f = torch.cat([left, s0, right], dim=1)
    s1f = torch.cat([left, s1, right], dim=1)
    y = sum(g[2 * j + 1] * s0f[:, j + 1:j + 1 + T] for j in range(6))
    y = y + sum(g[2 * m] * s1f[:, m:m + T] for m in range(6))
    return y.to(x.dtype)


# The kernel's launch (`csrc/antialias_snake.cu`, whose header says why): a
# thread owns 4 channels (one 8-byte piece of a row) and a run of 16 output
# rows; threads run channel piece first, then the runs, then the batch rows.
SNAKE_VEC = 4
SNAKE_RUN = 16
SNAKE_THREADS = 128
# the element types the kernel reads and writes (its arithmetic is f32):
# bf16, BigVGAN-v2's, and fp16, BigVGAN v1's default
SNAKE_DTYPES = (torch.bfloat16, torch.float16)


def kernel_takes(dtype: torch.dtype, device) -> bool:
    """Whether K3 takes a ``dtype`` activation on ``device``: on the card it
    is instantiated for bf16 and fp16 only, so a float32 BigVGAN runs the
    plain activation there (`models/vocoder/bigvgan.py::_act`), as the JAX
    BigVGAN does off the TPU; on the CPU the plain version takes any
    dtype."""
    return torch.device(device).type != "cuda" or dtype in SNAKE_DTYPES


class SnakePlan(NamedTuple):
    rows: int       # output rows a thread
    threads: int    # threads a block
    blocks: int


def snake_plan(B: int, T: int, C: int) -> SnakePlan:
    """K3's grid for x (B, T, C), as `antialias_snake_launch` computes it.
    Raises ValueError for a C that is not a multiple of 4 (the kernel reads
    and writes 4 channels as one 8-byte piece; every BigVGAN width is)."""
    if C % SNAKE_VEC or C < SNAKE_VEC:
        raise ValueError(f"antialias_snake: the kernel takes C a multiple of {SNAKE_VEC} "
                         f"(8-byte pieces of a row), got C={C}")
    n = B * -(-T // SNAKE_RUN) * (C // SNAKE_VEC)
    return SnakePlan(SNAKE_RUN, SNAKE_THREADS, -(-n // SNAKE_THREADS))


def _launch(name: str, x: torch.Tensor, alpha: torch.Tensor, beta: Optional[torch.Tensor],
            lengths: Optional[torch.Tensor], logscale: bool) -> torch.Tensor:
    """The kernel on a (B, T, C) CUDA tensor, for the entry ``name``."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    B, T, C = x.shape
    if x.dtype not in SNAKE_DTYPES or not x.is_contiguous() or x.data_ptr() % 8:
        raise ValueError(f"{name}: x must be contiguous 8-byte aligned bf16 or fp16, got "
                         f"{x.dtype} (contiguous={x.is_contiguous()})")
    snake_plan(B, T, C)                         # refuses a C the kernel does not take
    beta = alpha if beta is None else beta
    for label, t in (("alpha", alpha), ("beta", beta)):
        if t.numel() != C or t.device != x.device:
            raise ValueError(f"{name}: {label} must hold {C} values on {x.device}")
    if lengths is None:
        lengths = torch.full((B,), T, device=x.device)
    if lengths.shape != (B,) or lengths.device != x.device:
        raise ValueError(f"{name}: lengths must be ({B},) on {x.device}")
    a = alpha.reshape(C).float().contiguous()
    b = beta.reshape(C).float().contiguous()
    lens = lengths.to(torch.int32).contiguous()
    taps = _taps_on(str(x.device))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = cuda.library().antialias_snake_launch(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), lens.data_ptr(),
            taps.data_ptr(), out.data_ptr(), B, T, C, int(logscale),
            int(x.dtype == torch.float16), cuda.stream_ptr(x))
    cuda.check(code, name)
    return out


def antialias_snake(x: torch.Tensor, alpha: torch.Tensor,
                    beta: Optional[torch.Tensor],
                    lengths: Optional[torch.Tensor] = None,
                    logscale: bool = True) -> torch.Tensor:
    """K3. x: (B, T, C); alpha, beta: (C,), logs when ``logscale`` (beta None
    = Snake); lengths: (B,) valid frames. CPU tensors run the plain version;
    CUDA tensors (x contiguous bf16 or fp16) launch the kernel; anything
    else raises."""
    cuda.refuse_grad("antialias_snake", x, alpha, beta)
    if x.device.type == "cpu":
        return antialias_snake_plain(x, alpha, beta, lengths, logscale)
    out = _launch("antialias_snake", x, alpha, beta, lengths, logscale)
    cuda.count(antialias_snake)
    return out


antialias_snake.launches = 0


def fused_antialias_activation(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                               lengths: Optional[torch.Tensor] = None,
                               logscale: bool = True) -> torch.Tensor:
    """K5 (`ops/pallas/antialias.py::fused_antialias_activation`): x (B, T,
    C), alpha and beta (C,), lengths (B,) valid frames (default T). The TPU
    kernel's tiling (T % t_tile, C % c_tile) is its own; any T and C run
    here. CPU tensors run the plain version; CUDA tensors (x contiguous
    bf16 or fp16) launch the kernel; anything else raises."""
    cuda.refuse_grad("fused_antialias_activation", x, alpha, beta)
    if x.device.type == "cpu":
        return antialias_snake_plain(x, alpha, beta, lengths, logscale)
    out = _launch("fused_antialias_activation", x, alpha, beta, lengths, logscale)
    cuda.count(fused_antialias_activation)
    return out


fused_antialias_activation.launches = 0


def antialias_activation_prefolded(xf: torch.Tensor, alpha: torch.Tensor,
                                   beta: Optional[torch.Tensor], f: int, C: int,
                                   lengths: Optional[torch.Tensor] = None,
                                   logscale: bool = True) -> torch.Tensor:
    """K3' (`ops/snake.py::antialias_activation_prefolded`): the activation on
    a time-folded stream xf (B, R, f*C) == x.reshape(B, R*f, C), folded out
    the same way; alpha, beta (C,); lengths (B,) valid frames of the
    unfolded time axis (default R*f). The folded tensor must be contiguous:
    it is then, row-major, the (B, R*f, C) tensor, which the kernel takes
    as a view (no copy). CPU tensors run the plain version; CUDA tensors
    (bf16 or fp16) launch the kernel; anything else raises."""
    cuda.refuse_grad("antialias_activation_prefolded", xf, alpha, beta)
    B, R, fC = xf.shape
    if fC != f * C:
        raise ValueError(f"antialias_activation_prefolded: last axis {fC} != f*C = {f}*{C}")
    if not xf.is_contiguous():
        raise ValueError("antialias_activation_prefolded: the folded input must be "
                         "contiguous (it is then the unfolded tensor, read in place)")
    x = xf.view(B, R * f, C)
    if xf.device.type == "cpu":
        return antialias_snake_plain(x, alpha, beta, lengths, logscale).view(B, R, fC)
    out = _launch("antialias_activation_prefolded", x, alpha, beta, lengths, logscale)
    cuda.count(antialias_activation_prefolded)
    return out.view(B, R, fC)


antialias_activation_prefolded.launches = 0
