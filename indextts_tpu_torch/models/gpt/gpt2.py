"""GPT-2 decoder backbone (PyTorch counterpart of `indextts_tpu/models/gpt/gpt2.py`).

- `gpt2_forward`: full-sequence causal pass (teacher forcing / latents);
- `gpt2_prefill`: the same pass writing K/V into the cache at [0, T);
- `gpt2_decode_step`: one token against the flat (L, B, S, D) cache.

Weights run in the pipeline's dtype (bf16 on the card) with LayerNorm and
softmax in f32. Unlike the JAX package, the cache is updated in place: the
decode loop then never holds two copies of it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

from indextts_tpu_torch import nn
from indextts_tpu_torch.nn import InitRng, Params


@dataclass(frozen=True)
class GPT2Dims:
    layers: int
    dim: int
    heads: int

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def init_gpt2(rng: InitRng, dims: GPT2Dims) -> Params:
    """Stacked-layer params, HF init scheme (normal 0.02, zero bias)."""
    L, D = dims.layers, dims.dim
    layers = [{
        "ln_1": nn.layer_norm_init(rng, D),
        "attn": {"c_attn": nn.dense_init(rng, D, 3 * D, std=0.02),
                 "c_proj": nn.dense_init(rng, D, D, std=0.02 / math.sqrt(2 * L))},
        "ln_2": nn.layer_norm_init(rng, D),
        "mlp": {"c_fc": nn.dense_init(rng, D, 4 * D, std=0.02),
                "c_proj": nn.dense_init(rng, 4 * D, D, std=0.02 / math.sqrt(2 * L))},
    } for _ in range(L)]
    return {"h": nn.stack_layers(layers), "ln_f": nn.layer_norm_init(rng, D)}


def init_kv_cache(dims: GPT2Dims, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cpu") -> Dict[str, torch.Tensor]:
    """Flat (L, B, S, D) K and V caches, heads merged on the last axis."""
    shape = (dims.layers, batch, max_len, dims.dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _heads(t: torch.Tensor, dims: GPT2Dims) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, Dh)."""
    B, T, _ = t.shape
    return t.reshape(B, T, dims.heads, dims.head_dim).transpose(1, 2)


def _mlp(lp: Params, x: torch.Tensor) -> torch.Tensor:
    h = nn.layer_norm(lp["ln_2"], x)
    return x + nn.dense(lp["mlp"]["c_proj"], nn.gelu_new(nn.dense(lp["mlp"]["c_fc"], h)))


def _causal_mask(attn_mask: torch.Tensor, T: int) -> torch.Tensor:
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=attn_mask.device))
    return causal[None, None] & attn_mask[:, None, None, :].bool()


def _layer(lp: Params, x: torch.Tensor, dims: GPT2Dims, mask, cache=None,
           li: int = 0) -> torch.Tensor:
    B, T, D = x.shape
    q, k, v = torch.chunk(nn.dense(lp["attn"]["c_attn"], nn.layer_norm(lp["ln_1"], x)), 3, -1)
    if cache is not None:
        cache["k"][li, :, :T] = k.to(cache["k"].dtype)
        cache["v"][li, :, :T] = v.to(cache["v"].dtype)
    out = nn.mha(_heads(q, dims), _heads(k, dims), _heads(v, dims), mask=mask)
    x = x + nn.dense(lp["attn"]["c_proj"], out.transpose(1, 2).reshape(B, T, D))
    return _mlp(lp, x)


def gpt2_forward(params: Params, x: torch.Tensor, dims: GPT2Dims,
                 attn_mask: torch.Tensor = None) -> torch.Tensor:
    """Causal pass over input embeddings x (B, T, D); optional (B, T) key
    validity mask. Returns hidden states after ln_f."""
    B, T, _ = x.shape
    if attn_mask is None:
        attn_mask = torch.ones((B, T), dtype=torch.bool, device=x.device)
    mask = _causal_mask(attn_mask, T)
    for lp in params["h"]:
        x = _layer(lp, x, dims, mask)
    return nn.layer_norm(params["ln_f"], x)


def gpt2_prefill(params: Params, x: torch.Tensor, dims: GPT2Dims,
                 attn_mask: torch.Tensor, kv_cache: Dict[str, torch.Tensor]) -> torch.Tensor:
    """`gpt2_forward` that also writes every layer's K/V at cache slots
    [0, T) (in place). Returns hidden states after ln_f."""
    T = x.shape[1]
    mask = _causal_mask(attn_mask, T)
    for li, lp in enumerate(params["h"]):
        x = _layer(lp, x, dims, mask, kv_cache, li)
    return nn.layer_norm(params["ln_f"], x)


def gpt2_decode_step(params: Params, x: torch.Tensor, dims: GPT2Dims, pos: int,
                     kv_cache: Dict[str, torch.Tensor],
                     kv_valid: torch.Tensor) -> torch.Tensor:
    """One token x (B, D): writes its K/V at slot ``pos`` (in place) and
    attends every slot ``kv_valid`` (B, S) marks. Returns (B, D) after ln_f."""
    B, D = x.shape
    mask = kv_valid[:, None, None, :]
    xc = x[:, None, :]
    for li, lp in enumerate(params["h"]):
        q, k, v = torch.chunk(nn.dense(lp["attn"]["c_attn"], nn.layer_norm(lp["ln_1"], xc)), 3, -1)
        kc, vc = kv_cache["k"][li], kv_cache["v"][li]
        kc[:, pos] = k[:, 0].to(kc.dtype)
        vc[:, pos] = v[:, 0].to(vc.dtype)
        out = nn.mha(_heads(q, dims), _heads(kc, dims), _heads(vc, dims), mask=mask)
        xc = xc + nn.dense(lp["attn"]["c_proj"], out.transpose(1, 2).reshape(B, 1, D))
        xc = _mlp(lp, xc)
    return nn.layer_norm(params["ln_f"], xc[:, 0])
