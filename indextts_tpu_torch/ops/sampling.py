"""Logits warpers and the sampler (PyTorch counterpart of
`indextts_tpu/ops/sampling.py`).

HF order and semantics: repetition penalty -> temperature -> top-k ->
typical -> top-p -> categorical draw. All work on the last axis and keep
masked entries at -1e10. The draw takes an explicit `torch.Generator`: it
cannot reproduce `jax.random`'s numbers, so the tests hold the port to the
warped logits and to greedy decoding.
"""

from __future__ import annotations

from typing import Optional

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


def apply_typical(logits: torch.Tensor, mass: float = 0.9,
                  min_tokens_to_keep: int = 1) -> torch.Tensor:
    """TypicalLogitsWarper: keep the tokens whose surprisal is closest to the
    entropy until their probability reaches ``mass``."""
    lf = logits.float()
    normalized = torch.log_softmax(lf, dim=-1)
    p = normalized.exp()
    ent = -torch.where(p > 0, p * normalized, torch.zeros_like(p)).sum(-1, keepdim=True)
    shifted = (-normalized - ent).abs()
    order = torch.argsort(shifted, dim=-1, stable=True)
    sorted_logits = torch.gather(lf, -1, order)
    cumprobs = torch.softmax(sorted_logits, dim=-1).cumsum(-1)
    last_ind = (cumprobs < mass).sum(-1, keepdim=True).clamp(min=min_tokens_to_keep - 1)
    ranks = torch.argsort(order, dim=-1)             # rank of each vocab entry
    return logits.masked_fill(ranks > last_ind, NEG_INF)


def warp_logits(logits: torch.Tensor, token_counts: Optional[torch.Tensor] = None,
                temperature: float = 0.8, top_k: int = 30, top_p: float = 0.8,
                repetition_penalty: float = 10.0,
                typical_mass: Optional[float] = None) -> torch.Tensor:
    """The whole warper chain on (B, V) logits, in f32: the logits the
    categorical draw of `sample_logits` samples from."""
    lf = logits.float()
    if token_counts is not None:
        lf = apply_repetition_penalty(lf, token_counts, repetition_penalty)
    lf = apply_top_k(apply_temperature(lf, temperature), top_k)
    if typical_mass is not None:
        lf = apply_typical(lf, typical_mass)
    return apply_top_p(lf, top_p)


def sample_logits(generator: torch.Generator, logits: torch.Tensor,
                  token_counts: Optional[torch.Tensor] = None,
                  temperature: float = 0.8, top_k: int = 30, top_p: float = 0.8,
                  repetition_penalty: float = 10.0, do_sample: bool = True,
                  typical_mass: Optional[float] = None) -> torch.Tensor:
    """`warp_logits`, then a categorical draw from ``generator``: (B, V)
    logits -> (B,) token ids (int64). Greedy (``do_sample=False``) takes the
    argmax after the repetition penalty."""
    if not do_sample:
        lf = logits.float()
        if token_counts is not None:
            lf = apply_repetition_penalty(lf, token_counts, repetition_penalty)
        return lf.argmax(-1)
    lf = warp_logits(logits, token_counts, temperature, top_k, top_p, repetition_penalty,
                     typical_mass)
    return torch.multinomial(torch.softmax(lf, dim=-1), 1, generator=generator)[:, 0]
