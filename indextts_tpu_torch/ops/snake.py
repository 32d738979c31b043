"""BigVGAN's anti-aliased SnakeBeta (Activation1d): kernel K3 and its plain twin.

`antialias_snake` is the port of `indextts_tpu/ops/pallas/antialias.py::
fused_antialias_folded`. On a CUDA tensor it launches the hand-written
Hopper kernel `csrc/antialias_snake.cu` (or raises); on a CPU tensor it runs
`antialias_snake_plain`, the same math as `indextts_tpu/ops/snake.py::
antialias_activation_xla` in plain PyTorch.

The kaiser-sinc filters are re-derived here in numpy (the JAX package's
filter code lives in a module that imports jax); they equal its
`up_filter(2)` and `down_filter(2)` exactly.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

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
                          lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Activation1d on (B, T, C): x2 kaiser-sinc upsample (polyphase), SnakeBeta
    with log-scale alpha/beta (beta None = Snake), 12-tap lowpass, x2 down, all
    in f32; the input is replicate-extended from its valid region and the
    2x-rate signal edge-replicated with s0[0] (left) and s1[L-1] (right)."""
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
    a = torch.exp(alpha.float())
    b = a if beta is None else torch.exp(beta.float())
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


def antialias_snake(x: torch.Tensor, alpha: torch.Tensor,
                    beta: Optional[torch.Tensor],
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3. x: (B, T, C); alpha, beta: (C,) log-scale (beta None = Snake);
    lengths: (B,) valid frames. CPU tensors run the plain version; CUDA
    tensors (x contiguous bf16) launch the kernel; anything else raises."""
    if x.device.type == "cpu":
        return antialias_snake_plain(x, alpha, beta, lengths)
    if x.device.type != "cuda":
        raise ValueError(f"antialias_snake: unsupported device {x.device}")
    B, T, C = x.shape
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"antialias_snake: x must be contiguous bf16, got "
                         f"{x.dtype} (contiguous={x.is_contiguous()})")
    beta = alpha if beta is None else beta
    for name, t in (("alpha", alpha), ("beta", beta)):
        if t.numel() != C or t.device != x.device:
            raise ValueError(f"antialias_snake: {name} must hold {C} values on {x.device}")
    if lengths is None:
        lengths = torch.full((B,), T, device=x.device)
    if lengths.shape != (B,) or lengths.device != x.device:
        raise ValueError(f"antialias_snake: lengths must be ({B},) on {x.device}")
    a = alpha.reshape(C).float().contiguous()
    b = beta.reshape(C).float().contiguous()
    lens = lengths.to(torch.int32).contiguous()
    taps = _taps_on(str(x.device))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = cuda.library().antialias_snake_launch(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), lens.data_ptr(),
            taps.data_ptr(), out.data_ptr(), B, T, C, cuda.stream_ptr(x))
    cuda.check(code, "antialias_snake")
    antialias_snake.launches += 1
    return out


antialias_snake.launches = 0
