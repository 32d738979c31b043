"""GPT-2 decoder backbone (PyTorch counterpart of `indextts_tpu/models/gpt/gpt2.py`).

- `gpt2_forward`: full-sequence causal pass (teacher forcing / latents);
- `gpt2_prefill`: the same pass writing K/V into the cache at [0, T);
- `gpt2_decode_step`: one token against the flat (L, B, S, D) cache;
- the weight-only int8 / int4 trees and the flat int8 cache
  (`kv_quantize_flat`) of the memory-knob configurations, whose decode
  steps run kernel K1 (`ops/decode_step.py`).

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


def _quantize_blocks(params: Params, quantize) -> Params:
    def block(lp):
        return {**lp,
                "attn": {k: quantize(v) for k, v in lp["attn"].items()},
                "mlp": {k: quantize(v) for k, v in lp["mlp"].items()}}
    return {**params, "h": [block(lp) for lp in params["h"]]}


def quantize_gpt2_int8(params: Params) -> Params:
    """Weight-only int8 of the four dense layers of every block (the
    decode loop reads every weight once a step; int8 halves that against
    bf16). Called on the tree after its cast to the pipeline dtype, the
    JAX pipeline's order, so the scales come from the bf16 weights."""
    return _quantize_blocks(params, nn.quantize_dense_int8)


def quantize_gpt2_int4(params: Params) -> Params:
    """Weight-only int4 of the same four layers (`nn.quantize_dense_int4`:
    nibble-packed in 640-column groups, half int8's weight bytes), also
    after the cast to the pipeline dtype."""
    return _quantize_blocks(params, nn.quantize_dense_int4)


def is_quantized(params: Params) -> bool:
    """Whether a GPT-2 tree carries weight-only int8 (`quantize_gpt2_int8`)
    or int4 (`quantize_gpt2_int4`) weights."""
    c_attn = params["h"][0]["attn"]["c_attn"]
    return "q" in c_attn or "q4" in c_attn


# lanes of a packed scale row of the int8 cache: k-scales on [0, H), v-scales
# on [SCALE_LANES // 2, SCALE_LANES // 2 + H)
SCALE_LANES = 256


def init_kv_cache(dims: GPT2Dims, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cpu", quantized: bool = False) -> Dict[str, torch.Tensor]:
    """Flat (L, B, S, D) K and V caches, heads merged on the last axis.
    ``quantized=True`` gives the flat int8 cache of the JAX package's fused
    decode: int8 k and v plus ``"kvs"`` (L, B, S, 256) bf16, one packed
    scale row per (row, position) (see `kv_quantize_flat`)."""
    shape = (dims.layers, batch, max_len, dims.dim)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "kvs": torch.zeros(shape[:-1] + (SCALE_LANES,), dtype=torch.bfloat16,
                                   device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_quantize_flat(k: torch.Tensor, v: torch.Tensor, heads: int):
    """Quantize flat (..., D) k and v rows per head for the int8 cache:
    per (row, head) scale = bf16(max|x| / 127) in f32, values
    clip(round_half_even(x / max(scale, 1e-8)), -127, 127), so the int8
    value times the stored scale rebuilds what was quantized against.
    Returns (k int8 (..., D), v int8 (..., D), scale rows (..., 256) bf16
    with the k-scales on lanes [0, H), the v-scales on [128, 128 + H) and
    zeros elsewhere)."""
    *lead, D = k.shape
    half = SCALE_LANES // 2
    if heads > half:
        raise ValueError(f"the packed scale row holds at most {half} heads, got {heads}")

    def quant(x):
        xf = x.reshape(*lead, heads, D // heads).float()
        scale = (xf.abs().amax(-1) / 127.0).to(torch.bfloat16)
        safe = scale.float().clamp(min=1e-8)
        q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127)
        return q.to(torch.int8).reshape(*lead, D), scale

    kq, ks = quant(k)
    vq, vs = quant(v)
    kvs = torch.zeros((*lead, SCALE_LANES), dtype=torch.bfloat16, device=k.device)
    kvs[..., :heads], kvs[..., half:half + heads] = ks, vs
    return kq, vq, kvs


def _kv_dequant_flat(q8: torch.Tensor, kvs: torch.Tensor, heads: int, offset: int,
                     dtype) -> torch.Tensor:
    """An int8 cache slice (B, S, D) back to ``dtype`` against its scale
    rows (B, S, 256); ``offset`` 0 takes the k-scales, 128 the v-scales."""
    B, S, D = q8.shape
    scale = kvs[..., offset:offset + heads].float()
    x = q8.reshape(B, S, heads, D // heads).float() * scale[..., None]
    return x.reshape(B, S, D).to(dtype)


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
    if cache is not None and "kvs" in cache:
        # the int8 cache keeps the quantized rows; attention here uses k, v
        cache["k"][li, :, :T], cache["v"][li, :, :T], cache["kvs"][li, :, :T] = \
            kv_quantize_flat(k, v, dims.heads)
    elif cache is not None:
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
    [0, T) (in place; an int8 cache gets `kv_quantize_flat` rows, while the
    prefill's own attention uses the unquantized k and v, as in the JAX
    package). Returns hidden states after ln_f."""
    T = x.shape[1]
    mask = _causal_mask(attn_mask, T)
    for li, lp in enumerate(params["h"]):
        x = _layer(lp, x, dims, mask, kv_cache, li)
    return nn.layer_norm(params["ln_f"], x)


def gpt2_decode_step(params: Params, x: torch.Tensor, dims: GPT2Dims, pos: int,
                     kv_cache: Dict[str, torch.Tensor],
                     kv_valid: torch.Tensor) -> torch.Tensor:
    """One token x (B, D): writes its K/V at slot ``pos`` (in place) and
    attends every slot ``kv_valid`` (B, S) marks. Returns (B, D) after ln_f.
    ``gpt2_decode_step.calls`` counts the calls (int8 decode must not come
    here: it runs the fused kernel K1, as does every step on the int8
    cache)."""
    if "kvs" in kv_cache:
        raise NotImplementedError("gpt2_decode_step takes the bf16 cache; the int8 cache is "
                                  "decoded by kernel K1 (the JAX package's 5D ks/vs cache "
                                  "path is not ported, ROADMAP.md queue 1)")
    gpt2_decode_step.calls += 1
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


gpt2_decode_step.calls = 0
