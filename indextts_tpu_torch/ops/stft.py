"""STFT primitives (PyTorch counterpart of `indextts_tpu/ops/stft.py`)."""

from __future__ import annotations

import numpy as np
import torch


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (torch.hann_window(periodic=True))."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def povey_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Kaldi's 'povey' window: hann(periodic=False) ** 0.85."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win_length - 1))
    return (w ** 0.85).astype(dtype)


def frame_signal(y: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Slice (B, T) into (B, num_frames, frame_length); drops the tail."""
    if y.shape[1] < frame_length:
        return y.new_zeros((y.shape[0], 0, frame_length))
    return y.unfold(1, frame_length, hop)


def stft_magnitude(y: torch.Tensor, window: torch.Tensor, n_fft: int, hop: int,
                   eps: float = 1e-9) -> torch.Tensor:
    """|STFT| of (B, T) with center=False and win_length == n_fft ->
    (B, n_freq, frames), sqrt(re^2 + im^2 + eps) as in the JAX package."""
    frames = frame_signal(y.float(), n_fft, hop) * window[None, None, :]
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + eps)
    return mag.transpose(1, 2)
