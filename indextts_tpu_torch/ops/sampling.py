"""Logits warpers (PyTorch counterpart of `indextts_tpu/ops/sampling.py`).

HF order and semantics: repetition penalty -> temperature -> top-k -> top-p.
All work on the last axis and keep masked entries at -1e10.
"""

from __future__ import annotations

import torch

NEG_INF = -1e10


def apply_repetition_penalty(logits: torch.Tensor, token_counts: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor: seen tokens' scores are divided by
    the penalty if positive, multiplied if negative."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(token_counts > 0, penalized, logits)


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits / max(float(temperature), 1e-5)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask tokens whose exclusive descending cumulative probability reaches
    top_p (the argmax is always kept)."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    kept = torch.where(cum_excl < top_p, sorted_logits,
                       torch.full_like(sorted_logits, float("inf")))
    threshold = kept.min(dim=-1, keepdim=True).values
    return logits.masked_fill(logits < threshold, NEG_INF)
