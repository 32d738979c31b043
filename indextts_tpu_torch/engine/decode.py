"""Decode-engine pieces the beam engine uses (PyTorch counterpart of the
matching parts of `indextts_tpu/engine/decode.py`).

Reference quirks kept: mel position indices during incremental decode are
[0] for start_mel and i + 2 for the i-th generated token; HF's repetition
penalty sees the fake prefix ids (all 1s plus start_mel), so token 1 and
start_mel are penalized from the first step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims, gpt2_decode_step, is_quantized
from indextts_tpu_torch.nn import Params
from indextts_tpu_torch.ops.decode_step import fused_decode_step
from indextts_tpu_torch.ops.int8 import MAX_ROWS


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
    # the flat int8 KV cache with packed scale rows (`quantization="int8kv"`
    # / `"int4kv"`); prefill attention stays exact, decode runs K1's KVQ
    kv_quant: bool = False


def _cache_len(P: int, span: int) -> int:
    """Cache slots for prefix P + 1 start token + ``span`` generated tokens."""
    return P + 1 + span


def _embed_mel_token(params: Params, token: torch.Tensor, pos: int, dtype) -> torch.Tensor:
    """mel_embedding(token) + mel_pos_embedding(pos); token (B,), pos int."""
    emb = params["mel_embedding"]["weight"].to(dtype)[token.long()]
    return emb + params["mel_pos_embedding"]["weight"][pos].to(dtype)[None, :]


def decode_route(params: Params, batch: int, kv_quant: bool = False) -> str:
    """The decode step a (B*K)-row batch takes (`engine/decode.py::
    _fused_decode_ok` of the JAX package): "fused" (kernel K1) for int8 or
    int4 GPT-2 weights and B*K <= 24, with the bf16 or (``kv_quant``) the
    int8 cache; "plain" (`gpt2_decode_step`) for float weights and the bf16
    cache. The rest raises: the port has no plain quantized decode, and the
    JAX package's XLA path for the int8 cache at float weights (its 5D ks/vs
    cache) is not ported. The JAX package's D % 640 and S % 128 gates come
    from TPU memory tiling; the port's kernels mask ragged tiles."""
    if not is_quantized(params["gpt"]):
        if kv_quant:
            raise NotImplementedError(
                "the int8 KV cache with float weights (the JAX package's XLA 5D ks/vs "
                "cache) is not ported; see ROADMAP.md, queue 1")
        return "plain"
    if batch > MAX_ROWS:
        raise NotImplementedError(
            f"quantized decode of {batch} rows: kernel K1 takes at most {MAX_ROWS} "
            "(larger batches are not ported; see ROADMAP.md, queue 2)")
    return "fused"


# called as check(args, hidden) after each fused step when set by the caller
StepCheck = Optional[Callable[[Dict, torch.Tensor], None]]


def decode_step(route: str, params: Params, x: torch.Tensor, dims: GPT2Dims, pos: int,
                kv: Dict[str, torch.Tensor], kv_valid: torch.Tensor,
                anc: Optional[torch.Tensor] = None, group: int = 1,
                check: StepCheck = None) -> torch.Tensor:
    """One token through the GPT-2 backbone by ``route``; returns (B, D)
    after ln_f. ``check`` sees every fused call's arguments, with each
    layer's input under "layer_inputs", and its output (the smoke test holds
    the kernel against its plain twin there)."""
    if route == "fused":
        args = dict(params=params["gpt"], x=x, dims=dims, pos=pos, kv_cache=kv,
                    kv_valid=kv_valid, anc=anc, group=group,
                    layer_inputs=None if check is None else [])
        h = fused_decode_step(**args)
        if check is not None:
            check(args, h)
        return h
    return gpt2_decode_step(params["gpt"], x, dims, pos, kv, kv_valid)
