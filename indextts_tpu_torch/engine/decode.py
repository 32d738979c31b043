"""Decode-engine pieces the beam engine uses (PyTorch counterpart of the
matching parts of `indextts_tpu/engine/decode.py`).

Reference quirks kept: mel position indices during incremental decode are
[0] for start_mel and i + 2 for the i-th generated token; HF's repetition
penalty sees the fake prefix ids (all 1s plus start_mel), so token 1 and
start_mel are penalized from the first step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from indextts_tpu_torch.nn import Params


@dataclass(frozen=True)
class SamplingConfig:
    """The generation kwargs of `IndexTTS2.infer` that the port's beam
    engine honours (HF semantics)."""

    do_sample: bool = True
    temperature: float = 0.8
    top_k: int = 30
    top_p: float = 0.8
    repetition_penalty: float = 10.0
    num_beams: int = 3
    length_penalty: float = 0.0
    min_new_tokens: int = 0


def _cache_len(P: int, span: int) -> int:
    """Cache slots for prefix P + 1 start token + ``span`` generated tokens."""
    return P + 1 + span


def _embed_mel_token(params: Params, token: torch.Tensor, pos: int, dtype) -> torch.Tensor:
    """mel_embedding(token) + mel_pos_embedding(pos); token (B,), pos int."""
    emb = params["mel_embedding"]["weight"].to(dtype)[token.long()]
    return emb + params["mel_pos_embedding"]["weight"][pos].to(dtype)[None, :]
