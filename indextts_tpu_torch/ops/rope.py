"""Rotary position embeddings (PyTorch counterpart of `indextts_tpu/ops/rope.py`).

The DiT's wqkv columns are pair-deinterleaved (each head's even lanes first,
then its odd lanes), so rope works on contiguous halves. The attention
kernel applies the same rotation in-kernel (`ops/attn.py`).
"""

from __future__ import annotations

import numpy as np
import torch


def precompute_freqs_cis(seq_len: int, n_elem: int, base: float = 10000.0) -> np.ndarray:
    """(seq_len, n_elem // 2, 2) float32 with [..., 0] = cos, [..., 1] = sin."""
    freqs = 1.0 / (base ** (np.arange(0, n_elem, 2)[: n_elem // 2].astype(np.float64)
                            / n_elem))
    angles = np.outer(np.arange(seq_len, dtype=np.float64), freqs)
    return np.stack([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)


def apply_rotary_emb_half(x: torch.Tensor, freqs_cis: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, D) with half-split lanes, freqs_cis (>=T, D/2, 2); rotation
    in f32, result in x's dtype."""
    T, half = x.shape[1], x.shape[-1] // 2
    cos = freqs_cis[:T, :, 0].float()[None, :, None, :]
    sin = freqs_cis[:T, :, 1].float()[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
