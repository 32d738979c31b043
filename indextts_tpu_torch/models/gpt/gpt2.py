"""GPT-2 decoder backbone (PyTorch counterpart of `indextts_tpu/models/gpt/gpt2.py`).

- `gpt2_forward`: full-sequence causal pass (teacher forcing / latents);
- `gpt2_prefill`: the same pass writing K/V into the cache at [0, T);
- `gpt2_decode_step`: one token against the flat (L, B, S, D) cache, on
  every weight format (float, int8 "q", int4 "q4") and both caches (bf16,
  or the flat int8 one with its "kvs" scale rows), optionally with every
  layer's input (DoLa); the plain step, which the JAX package runs on XLA;
- `gpt2_chunk_step`: G consecutive tokens in one pass, the verify step of
  speculative decoding, on the same formats and caches;
- the weight-only int8 / int4 trees and the flat int8 cache
  (`kv_quantize_flat`) of the memory-knob configurations, whose decode
  steps run kernel K1 (`ops/decode_step.py`) up to 24 rows;
- the tensor-parallel int8 tree (`parallel/mesh.py::shard_gpt2_tp`):
  `gpt2_forward` and `gpt2_prefill` run it shard by shard (what GSPMD makes
  of the JAX package's passes on the tp-sharded tree), and
  `init_kv_cache(mesh=...)` gives each shard its (L, B, S, D/2) cache; its
  decode steps run kernel K6 (`ops/decode_step_tp.py`).

Weights run in the pipeline's dtype (bf16 on the card) with LayerNorm and
softmax in f32. Unlike the JAX package, the cache is updated in place: the
decode loop then never holds two copies of it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from indextts_tpu_torch import nn
from indextts_tpu_torch.nn import InitRng, Params
from indextts_tpu_torch.parallel.mesh import Mesh, is_tp


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
    """Whether a GPT-2 tree (or the tensor-parallel tree of one) carries
    weight-only int8 (`quantize_gpt2_int8`) or int4 (`quantize_gpt2_int4`)
    weights."""
    layers = params["shards"][0] if is_tp(params) else params["h"]
    c_attn = layers[0]["attn"]["c_attn"]
    return "q" in c_attn or "q4" in c_attn


# lanes of a packed scale row of the int8 cache: k-scales on [0, H), v-scales
# on [SCALE_LANES // 2, SCALE_LANES // 2 + H)
SCALE_LANES = 256


def init_kv_cache(dims: GPT2Dims, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cpu", quantized: bool = False, mesh: Optional[Mesh] = None) -> Dict:
    """Flat (L, B, S, D) K and V caches, heads merged on the last axis.
    ``quantized=True`` gives the flat int8 cache of the JAX package's fused
    decode: int8 k and v plus ``"kvs"`` (L, B, S, 256) bf16, one packed
    scale row per (row, position) (see `kv_quantize_flat`). With a tp
    ``mesh``: ``{"shards": [cache of rank t]}``, each the bf16 cache of the
    rank's heads, (L, B, S, D/tp) on its device."""
    if mesh is not None:
        if quantized:
            raise NotImplementedError("the int8 KV cache under tensor parallelism is not "
                                      "ported (ROADMAP.md, queue 1)")
        sub = GPT2Dims(dims.layers, dims.dim // mesh.tp, dims.heads // mesh.tp)
        return {"shards": [init_kv_cache(sub, batch, max_len, dtype, d) for d in mesh.devices]}
    shape = (dims.layers, batch, max_len, dims.dim)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "kvs": torch.zeros(shape[:-1] + (SCALE_LANES,), dtype=torch.bfloat16,
                                   device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def map_cache(kv: Dict, fn: Callable[[torch.Tensor], torch.Tensor]) -> Dict:
    """The cache with ``fn`` applied to every buffer (each shard's, under tp)."""
    if "shards" in kv:
        return {"shards": [map_cache(c, fn) for c in kv["shards"]]}
    return {name: fn(buf) for name, buf in kv.items()}


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


def _tp_partial(p: Params, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel int8 layer's f32 partial product on one shard (the
    scale and bias apply after the reduce)."""
    if "q" not in p:
        raise NotImplementedError("the tensor-parallel passes take int8 weights (the JAX "
                                  "package's GSPMD passes for float and int4 weights are not "
                                  "ported; ROADMAP.md, queue 1)")
    return torch.matmul(x.float(), p["q"].t().float())


def _tp_reduce(p: Params, parts: List[torch.Tensor], dtype) -> torch.Tensor:
    """Sum the shards' partials lo + hi on rank 0's device, then the full
    per-channel scale and bias, rounded once (`nn.dense`'s int8 order)."""
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part.to(acc.device)
    return (acc * p["scale"] + p["bias"].float()).to(dtype)


def _layer_tp(layers: List[Params], x: torch.Tensor, dims: GPT2Dims, mask,
              caches: Optional[List[Dict]] = None, li: int = 0) -> torch.Tensor:
    """One block on the tensor-parallel tree: each shard (``layers[t]``, on
    its device) runs its heads and its half of the MLP on a copy of x; the
    row-parallel partials are reduced on rank 0's device, where x lives."""
    B, T, _ = x.shape
    tp = len(layers)
    H, Dh = dims.heads // tp, dims.head_dim

    def heads(t):
        return t.reshape(B, T, H, Dh).transpose(1, 2)

    parts = []
    for t, lp in enumerate(layers):
        dev = lp["ln_1"]["weight"].device
        q, k, v = torch.chunk(nn.dense(lp["attn"]["c_attn"],
                                       nn.layer_norm(lp["ln_1"], x.to(dev))), 3, -1)
        if caches is not None:
            caches[t]["k"][li, :, :T] = k.to(caches[t]["k"].dtype)
            caches[t]["v"][li, :, :T] = v.to(caches[t]["v"].dtype)
        out = nn.mha(heads(q), heads(k), heads(v), mask=mask.to(dev))
        parts.append(_tp_partial(lp["attn"]["c_proj"], out.transpose(1, 2).reshape(B, T, -1)))
    x = x + _tp_reduce(layers[0]["attn"]["c_proj"], parts, x.dtype)
    parts = []
    for lp in layers:
        h = nn.layer_norm(lp["ln_2"], x.to(lp["ln_2"]["weight"].device))
        parts.append(_tp_partial(lp["mlp"]["c_proj"],
                                 nn.gelu_new(nn.dense(lp["mlp"]["c_fc"], h))))
    return x + _tp_reduce(layers[0]["mlp"]["c_proj"], parts, x.dtype)


def _blocks(params: Params, x: torch.Tensor, dims: GPT2Dims, mask,
            kv_cache: Optional[Dict] = None, hiddens: Optional[list] = None) -> torch.Tensor:
    """The blocks, then ln_f; ``hiddens`` collects each block's input at the
    last position."""
    if is_tp(params):
        if hiddens is not None:
            raise NotImplementedError("collect_hiddens on the tensor-parallel tree is not "
                                      "ported (ROADMAP.md, queue 1 item 10)")
        caches = None if kv_cache is None else kv_cache["shards"]
        for li, layers in enumerate(zip(*params["shards"])):
            x = _layer_tp(list(layers), x, dims, mask, caches, li)
    else:
        for li, lp in enumerate(params["h"]):
            if hiddens is not None:
                hiddens.append(x[:, -1])
            x = _layer(lp, x, dims, mask, kv_cache, li)
    return nn.layer_norm(params["ln_f"], x)


def gpt2_forward(params: Params, x: torch.Tensor, dims: GPT2Dims,
                 attn_mask: torch.Tensor = None) -> torch.Tensor:
    """Causal pass over input embeddings x (B, T, D); optional (B, T) key
    validity mask. Returns hidden states after ln_f. A tensor-parallel tree
    runs shard by shard (`_layer_tp`)."""
    B, T, _ = x.shape
    if attn_mask is None:
        attn_mask = torch.ones((B, T), dtype=torch.bool, device=x.device)
    return _blocks(params, x, dims, _causal_mask(attn_mask, T))


def gpt2_prefill(params: Params, x: torch.Tensor, dims: GPT2Dims,
                 attn_mask: torch.Tensor, kv_cache: Dict, collect_hiddens: bool = False):
    """`gpt2_forward` that also writes every layer's K/V at cache slots
    [0, T) (in place; an int8 cache gets `kv_quantize_flat` rows, while the
    prefill's own attention uses the unquantized k and v, as in the JAX
    package; a tensor-parallel tree writes each shard's heads into its own
    cache). Returns hidden states after ln_f; with ``collect_hiddens`` also
    (L, B, D), each block's input at the last position (HF
    ``hidden_states[i]`` for i < L, what DoLa's early exits read)."""
    hiddens = [] if collect_hiddens else None
    h = _blocks(params, x, dims, _causal_mask(attn_mask, x.shape[1]), kv_cache, hiddens)
    return (h, torch.stack(hiddens)) if collect_hiddens else h


def _cache_write(kv_cache: Dict, li: int, pos0: int, k: torch.Tensor, v: torch.Tensor,
                 heads: int) -> None:
    """Layer ``li``'s k and v rows (B, G, D) at slots [pos0, pos0 + G), in
    place; the int8 cache gets `kv_quantize_flat` rows and their scales."""
    end = pos0 + k.shape[1]
    if "kvs" in kv_cache:
        kv_cache["k"][li, :, pos0:end], kv_cache["v"][li, :, pos0:end], \
            kv_cache["kvs"][li, :, pos0:end] = kv_quantize_flat(k, v, heads)
    else:
        kv_cache["k"][li, :, pos0:end] = k.to(kv_cache["k"].dtype)
        kv_cache["v"][li, :, pos0:end] = v.to(kv_cache["v"].dtype)


def _cache_layer(kv_cache: Dict, li: int, heads: int, dtype):
    """Layer ``li``'s (k, v) (B, S, D) as attention reads them: the bf16
    cache as it is, the int8 cache dequantized to ``dtype`` against its
    scale rows (the JAX package's XLA path for that cache)."""
    if "kvs" in kv_cache:
        kvs = kv_cache["kvs"][li]
        return (_kv_dequant_flat(kv_cache["k"][li], kvs, heads, 0, dtype),
                _kv_dequant_flat(kv_cache["v"][li], kvs, heads, SCALE_LANES // 2, dtype))
    return kv_cache["k"][li], kv_cache["v"][li]


def _cached_blocks(params: Params, x: torch.Tensor, dims: GPT2Dims, pos0: int,
                   kv_cache: Dict, mask: torch.Tensor,
                   hiddens: Optional[list] = None) -> torch.Tensor:
    """x (B, G, D) through every block against the cache: each layer writes
    its k / v at [pos0, pos0 + G), then attends the cache under ``mask``
    (B, 1, G, S). Returns (B, G, D) after ln_f; ``hiddens`` collects each
    block's input."""
    if is_tp(params):
        raise NotImplementedError("the plain decode step on the tensor-parallel tree (the JAX "
                                  "package's GSPMD decode) is not ported; see ROADMAP.md, "
                                  "queue 1 item 10")
    for li, lp in enumerate(params["h"]):
        if hiddens is not None:
            hiddens.append(x)
        x = cached_layer(lp, x, dims, pos0, kv_cache, li, mask)
    return nn.layer_norm(params["ln_f"], x)


def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """The decode's attention: (B, H, G, Dh) queries against the (B, H, S,
    Dh) cache under the keep-mask ``mask`` (B, 1, G, S). The JAX package's
    `nn.mha` written out: f32 scores of the input-dtype products, -1e9
    where the mask is False, an f32 softmax, the probabilities rounded to
    v's dtype, f32 sums of p.v, the output in q's dtype. Both products are
    f32 GEMMs, whose bits depend on the shapes alone. The library's fused
    attention (`nn.mha`, which PyTorch hands to cuDNN for a masked bf16
    attention on the H100) is not used here: with it, two sampled decodes of
    one request on the card (the speculative decoder's single steps and the
    plain loop, the same computation from the same generator) parted at
    token 20 of 400; written out, they share every token."""
    B, H, G, Dh = q.shape
    S = k.shape[2]

    def f32(t, rows):            # one copy: f32 and contiguous, (B * H, rows, Dh)
        return t.new_empty((B, H, rows, Dh), dtype=torch.float32).copy_(t).view(B * H, rows, Dh)

    s = torch.baddbmm(q.new_empty((), dtype=torch.float32), f32(q, G), f32(k, S).transpose(1, 2),
                      beta=0.0, alpha=1.0 / math.sqrt(Dh)).view(B, H, G, S)
    p = torch.softmax(torch.where(mask, s, -1e9), dim=-1).to(v.dtype).float()
    return torch.bmm(p.view(B * H, G, S), f32(v, S)).view(B, H, G, Dh).to(q.dtype)


def cached_layer(lp: Params, x: torch.Tensor, dims: GPT2Dims, pos0: int, kv_cache: Dict,
                 li: int, mask: torch.Tensor) -> torch.Tensor:
    """One block of `_cached_blocks` (layer ``li`` of the cache) on x (B, G,
    D); the checks hold a chunk's layers against single steps' with it."""
    B, G, D = x.shape
    q, k, v = torch.chunk(nn.dense(lp["attn"]["c_attn"], nn.layer_norm(lp["ln_1"], x)), 3, -1)
    _cache_write(kv_cache, li, pos0, k, v, dims.heads)
    kc, vc = _cache_layer(kv_cache, li, dims.heads, x.dtype)
    out = cached_attention(_heads(q, dims), _heads(kc, dims), _heads(vc, dims), mask)
    return _mlp(lp, x + nn.dense(lp["attn"]["c_proj"], out.transpose(1, 2).reshape(B, G, D)))


def gpt2_decode_step(params: Params, x: torch.Tensor, dims: GPT2Dims, pos: int,
                     kv_cache: Dict[str, torch.Tensor], kv_valid: torch.Tensor,
                     collect_hiddens: bool = False):
    """The plain decode step: one token x (B, D) writes its K/V at slot
    ``pos`` (in place) and attends every slot ``kv_valid`` (B, S) marks.
    Float, int8 and int4 weights (`nn.dense` dequantizes), the bf16 cache or
    the int8 one (the new rows quantized, the layer dequantized to x's
    dtype). Returns (B, D) after ln_f; with ``collect_hiddens`` also (L, B,
    D), each block's input (HF ``hidden_states[i]`` for i < L, DoLa's
    premature exits). ``gpt2_decode_step.calls`` counts the calls."""
    gpt2_decode_step.calls += 1
    hiddens = [] if collect_hiddens else None
    h = _cached_blocks(params, x[:, None], dims, pos, kv_cache, kv_valid[:, None, None, :],
                       hiddens)[:, 0]
    return (h, torch.stack([t[:, 0] for t in hiddens])) if collect_hiddens else h


gpt2_decode_step.calls = 0


def gpt2_chunk_step(params: Params, x: torch.Tensor, dims: GPT2Dims, pos0: int,
                    kv_cache: Dict[str, torch.Tensor], kv_valid: torch.Tensor) -> torch.Tensor:
    """G consecutive tokens x (B, G, D) in one pass, the verify step of
    speculative decoding (`indextts_tpu/models/gpt/gpt2.py::gpt2_chunk_step`):
    their K/V are written at slots [pos0, pos0 + G) (in place), and query g
    attends every ``kv_valid`` slot plus the chunk's slots pos0 .. pos0 + g
    (the caller passes ``kv_valid`` without the chunk's slots and marks the
    committed ones afterwards). The weight formats and caches of
    `gpt2_decode_step`. Returns (B, G, D) after ln_f.
    ``gpt2_chunk_step.calls`` counts the calls."""
    gpt2_chunk_step.calls += 1
    return _cached_blocks(params, x, dims, pos0, kv_cache, chunk_mask(kv_valid, pos0, x.shape[1]))


def chunk_mask(kv_valid: torch.Tensor, pos0: int, G: int) -> torch.Tensor:
    """The (B, 1, G, S) mask of a chunk of G tokens at [pos0, pos0 + G):
    query g attends the ``kv_valid`` slots and the chunk's slots up to its
    own."""
    S = kv_valid.shape[1]
    s = torch.arange(S, device=kv_valid.device)
    g = torch.arange(G, device=kv_valid.device)
    chunk_ok = (s[None, :] >= pos0) & (s[None, :] <= pos0 + g[:, None])          # (G, S)
    return kv_valid[:, None, None, :] | chunk_ok[None, None]


gpt2_chunk_step.calls = 0
