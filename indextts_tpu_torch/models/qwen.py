"""Qwen3 causal LM, the emotion-text classifier's backbone (PyTorch
counterpart of `indextts_tpu/models/qwen.py`).

Architecture (HF Qwen3): RMSNorm pre-norm, GQA attention with per-head q/k
RMS norms, rotary embeddings in the half-split layout, a SwiGLU MLP and an
optional tied head. The parameter tree is the JAX package's: layer leaves
stacked on a leading (L, ...) axis, projection kernels stored so that the
forward is ``x @ W``; the weight bridge (`utils/jax_params.py::to_torch`)
carries it over unchanged.

- `qwen_prefill`: the left-padded prompt through every layer, writing the
  dense (L, B, S, KV, Dh) cache at [0, T);
- `qwen_decode_step`: one token against that cache, its k/v row written at
  ``pos`` (in place);
- `qwen_generate_greedy`: prefill + greedy decode, the classifier's only
  generation mode (it emits a short JSON object).

Positions are absolute over the padded row (0 .. T-1 for the prompt, and
P + step - 1 for decode step ``step``), as in the JAX package, not the
cumsum positions of HF's left-padded generate; with one row (the
classifier) the two agree. The matrix products and the attention are stock
PyTorch (`x @ W`, SDPA with `nn.mha`'s -1e9 mask bias): the JAX package runs
this model on XLA, with no Pallas kernel. The rotary tables and the mask
bias are made once a forward, for every layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from indextts_tpu_torch.nn import InitRng, Params

# decode steps between two reads of the all-rows-finished flag (the greedy
# loop's only device -> host copy)
_DONE_POLL = 8


@dataclass(frozen=True)
class QwenConfig:
    vocab_size: int = 151936
    hidden_size: int = 1024
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    tie_word_embeddings: bool = True
    eos_token_id: int = 151645  # <|im_end|>

    @classmethod
    def from_hf(cls, d: dict) -> "QwenConfig":
        """An HF ``config.json`` dict (Qwen3ForCausalLM) -> QwenConfig; a
        list of eos ids keeps its first, as the JAX package does."""
        eos = d.get("eos_token_id", 151645)
        if isinstance(eos, (list, tuple)):
            eos = eos[0]
        return cls(
            vocab_size=d["vocab_size"], hidden_size=d["hidden_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
            head_dim=d.get("head_dim", d["hidden_size"] // d["num_attention_heads"]),
            intermediate_size=d["intermediate_size"],
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            rope_theta=d.get("rope_theta", 1e6),
            tie_word_embeddings=d.get("tie_word_embeddings", True),
            eos_token_id=eos)


def init_qwen(rng: InitRng, c: QwenConfig) -> Params:
    """Seeded random weights in the JAX package's layout (normal 0.02
    kernels and embedding, unit norm scales), drawn on ``rng``'s device."""
    D, H, KV, Dh, I = (c.hidden_size, c.num_attention_heads, c.num_key_value_heads,
                       c.head_dim, c.intermediate_size)
    L = c.num_hidden_layers

    def stack(shape):
        return rng.normal((L,) + shape, std=0.02)

    p: Params = {
        "embed": rng.normal((c.vocab_size, D), std=0.02),
        "layers": {
            "input_ln": rng.ones((L, D)),
            "post_ln": rng.ones((L, D)),
            "q_proj": stack((D, H * Dh)),
            "k_proj": stack((D, KV * Dh)),
            "v_proj": stack((D, KV * Dh)),
            "o_proj": stack((H * Dh, D)),
            "q_norm": rng.ones((L, Dh)),
            "k_norm": rng.ones((L, Dh)),
            "gate_proj": stack((D, I)),
            "up_proj": stack((D, I)),
            "down_proj": stack((I, D)),
        },
        "final_ln": rng.ones((D,)),
    }
    if not c.tie_word_embeddings:
        p["lm_head"] = rng.normal((c.vocab_size, D), std=0.02)
    return p


def convert_qwen(sd: Dict[str, np.ndarray], c: QwenConfig) -> Params:
    """HF Qwen3ForCausalLM state dict -> the stacked tree (kernels stored
    transposed, so the forward is x @ W), as the JAX package's
    `convert_qwen`; f32 numpy leaves."""
    L = c.num_hidden_layers

    def take(fmt, transpose=True):
        ws = [np.asarray(sd[fmt.format(i)], np.float32) for i in range(L)]
        return np.stack([w.T if transpose else w for w in ws])

    p: Params = {
        "embed": np.asarray(sd["model.embed_tokens.weight"], np.float32),
        "layers": {
            "input_ln": take("model.layers.{}.input_layernorm.weight", transpose=False),
            "post_ln": take("model.layers.{}.post_attention_layernorm.weight", transpose=False),
            "q_proj": take("model.layers.{}.self_attn.q_proj.weight"),
            "k_proj": take("model.layers.{}.self_attn.k_proj.weight"),
            "v_proj": take("model.layers.{}.self_attn.v_proj.weight"),
            "o_proj": take("model.layers.{}.self_attn.o_proj.weight"),
            "q_norm": take("model.layers.{}.self_attn.q_norm.weight", transpose=False),
            "k_norm": take("model.layers.{}.self_attn.k_norm.weight", transpose=False),
            "gate_proj": take("model.layers.{}.mlp.gate_proj.weight"),
            "up_proj": take("model.layers.{}.mlp.up_proj.weight"),
            "down_proj": take("model.layers.{}.mlp.down_proj.weight"),
        },
        "final_ln": np.asarray(sd["model.norm.weight"], np.float32),
    }
    if not c.tie_word_embeddings and "lm_head.weight" in sd:
        p["lm_head"] = np.asarray(sd["lm_head.weight"], np.float32)
    return p


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's dtype (as the JAX package's `_rms`)."""
    return F.rms_norm(x.float(), (x.shape[-1],), w.float(), eps).to(x.dtype)


def _rope_tables(pos: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the half-split rotary for positions ``pos`` (T,), each
    (T, 1, Dh) in f32, ``sin`` negated on its first half: one table serves
    every layer's q and k."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=pos.device) / half))
    ang = pos.to(torch.float32)[:, None] * inv               # (T, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([cos, cos], dim=-1)[:, None], torch.cat([-sin, sin], dim=-1)[:, None]


def _rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Half-split rotary (HF layout) of x (..., T, H, Dh): [x1 cos - x2 sin,
    x2 cos + x1 sin], computed in f32 as x cos + [x2, x1] (+-sin) (the same
    products and sums)."""
    cos, sin = tables
    half = x.shape[-1] // 2
    return (x * cos + torch.cat([x[..., half:], x[..., :half]], dim=-1) * sin).to(x.dtype)


def _mask_bias(mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The additive attention bias of a boolean keep-mask, as `nn.mha`
    builds it (masked scores get -1e9), made once for every layer."""
    bias = torch.zeros(mask.shape, dtype=dtype, device=mask.device)
    return bias.masked_fill(~mask, max(-1e9, torch.finfo(dtype).min))


def _attention_in(lp: Params, li: int, c: QwenConfig, x: torch.Tensor,
                  rope) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Layer ``li``'s normed, roped q (B, T, H, Dh) and k, v (B, T, KV, Dh)."""
    B, T, _ = x.shape
    H, KV, Dh, eps = c.num_attention_heads, c.num_key_value_heads, c.head_dim, c.rms_norm_eps
    h = _rms(x, lp["input_ln"][li], eps)
    q = (h @ lp["q_proj"][li].to(h.dtype)).reshape(B, T, H, Dh)
    k = (h @ lp["k_proj"][li].to(h.dtype)).reshape(B, T, KV, Dh)
    v = (h @ lp["v_proj"][li].to(h.dtype)).reshape(B, T, KV, Dh)
    return _rope(_rms(q, lp["q_norm"][li], eps), rope), _rope(_rms(k, lp["k_norm"][li], eps),
                                                              rope), v


def _attention_out(lp: Params, li: int, c: QwenConfig, x: torch.Tensor, q: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """GQA attention of q over k, v (each kv head repeated for its q heads;
    the f32 softmax of the fused library attention), then the out
    projection, the residual and the SwiGLU MLP."""
    B, T, H, Dh = q.shape
    rep = H // c.num_key_value_heads
    kr = k.repeat_interleave(rep, dim=2).to(q.dtype)
    vr = v.repeat_interleave(rep, dim=2).to(q.dtype)
    out = F.scaled_dot_product_attention(q.transpose(1, 2), kr.transpose(1, 2),
                                         vr.transpose(1, 2), attn_mask=bias)
    x = x + out.transpose(1, 2).reshape(B, T, H * Dh) @ lp["o_proj"][li].to(x.dtype)
    h = _rms(x, lp["post_ln"][li], c.rms_norm_eps)
    g = F.silu(h @ lp["gate_proj"][li].to(h.dtype))
    return x + (g * (h @ lp["up_proj"][li].to(h.dtype))) @ lp["down_proj"][li].to(x.dtype)


def _logits(p: Params, c: QwenConfig, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the (tied) head of (B, D) hidden states, in f32."""
    x = _rms(x, p["final_ln"], c.rms_norm_eps)
    head = p.get("lm_head", p["embed"]).to(x.dtype)
    return (x @ head.t()).float()


def qwen_prefill(p: Params, c: QwenConfig, ids: torch.Tensor, attn_mask: torch.Tensor,
                 max_len: int, dtype: torch.dtype = torch.bfloat16
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """ids (B, T) left-padded, attn_mask (B, T) 1 on real tokens; returns
    (the last position's logits (B, V) in f32, the cache {"k", "v"} of
    (L, B, max_len, KV, Dh) in ``dtype``, zero past T)."""
    B, T = ids.shape
    L, KV, Dh = c.num_hidden_layers, c.num_key_value_heads, c.head_dim
    lp = p["layers"]
    x = p["embed"][ids].to(dtype)
    rope = _rope_tables(torch.arange(T, device=ids.device), Dh, c.rope_theta)
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=ids.device))[None, None]
    bias = _mask_bias(causal & attn_mask.bool()[:, None, None, :], dtype)
    cache = {n: torch.zeros((L, B, max_len, KV, Dh), dtype=dtype, device=ids.device)
             for n in ("k", "v")}
    for li in range(L):
        q, k, v = _attention_in(lp, li, c, x, rope)
        cache["k"][li, :, :T] = k
        cache["v"][li, :, :T] = v
        x = _attention_out(lp, li, c, x, q, k, v, bias)
    return _logits(p, c, x[:, -1]), cache


def qwen_decode_step(p: Params, c: QwenConfig, tok: torch.Tensor, cache: Dict[str, torch.Tensor],
                     kv_valid: torch.Tensor, pos: int,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One token per row (``tok`` (B,)) at absolute position ``pos``: writes
    its k/v rows into ``cache`` at ``pos`` (in place) and attends the slots
    of the whole cache that ``kv_valid`` (B, S) marks (as the JAX package:
    every step has the same shapes, so the library's per-shape set-up is
    paid once, not once a step); returns the logits (B, V) in f32."""
    lp = p["layers"]
    x = p["embed"][tok].to(dtype)[:, None]                     # (B, 1, D)
    rope = _rope_tables(torch.tensor([pos], device=tok.device), c.head_dim, c.rope_theta)
    bias = _mask_bias(kv_valid[:, None, None, :], dtype)
    for li in range(c.num_hidden_layers):
        q, k, v = _attention_in(lp, li, c, x, rope)
        cache["k"][li, :, pos] = k[:, 0]
        cache["v"][li, :, pos] = v[:, 0]
        x = _attention_out(lp, li, c, x, q, cache["k"][li], cache["v"][li], bias)
    return _logits(p, c, x[:, 0])


@torch.inference_mode()
def qwen_generate_greedy(p: Params, c: QwenConfig, ids: torch.Tensor, attn_mask: torch.Tensor,
                         max_new_tokens: int, dtype: torch.dtype = torch.bfloat16
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode of left-padded ``ids`` (B, P); returns (tokens (B, N),
    lengths (B,)), as the JAX package's `qwen_generate_greedy`: tokens past
    a row's eos are eos; a row's length is 1 when its first token is eos,
    the step + 1 where eos first comes, else ``max_new_tokens``. The
    all-finished flag is read every ``_DONE_POLL`` steps; a finished row
    only emits eos, so the steps run past the JAX loop's exit change
    nothing."""
    B, P = ids.shape
    N, eos = max_new_tokens, c.eos_token_id
    logits, cache = qwen_prefill(p, c, ids, attn_mask, P + N, dtype)
    kv_valid = torch.zeros((B, P + N), dtype=torch.bool, device=ids.device)
    kv_valid[:, :P] = attn_mask.bool()
    tok = torch.argmax(logits, dim=-1)
    tokens = torch.full((B, N), eos, dtype=torch.long, device=ids.device)
    tokens[:, 0] = tok
    finished = tok == eos
    lengths = torch.where(finished, 1, N)
    for step in range(1, N):
        if step % _DONE_POLL == 0 and bool(finished.all()):
            break
        pos = P + step - 1                  # the absolute slot of token step - 1
        kv_valid[:, pos] = True
        logits = qwen_decode_step(p, c, tokens[:, step - 1], cache, kv_valid, pos, dtype)
        tok = torch.where(finished, eos, torch.argmax(logits, dim=-1))
        tokens[:, step] = tok
        lengths = torch.where(~finished & (tok == eos), step + 1, lengths)
        finished = finished | (tok == eos)
    return tokens, lengths
