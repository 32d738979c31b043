"""Wav2Vec2-BERT 2.0 encoder (PyTorch counterpart of
`indextts_tpu/models/codec/w2vbert.py`).

feature_projection (LayerNorm(160) + Linear 160->1024) -> conformer layers
(half-step FFN1 -> relative_key self-attention -> causal depthwise conv
module -> half-step FFN2 -> final LayerNorm); returns HF `hidden_states[n]`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from indextts_tpu_torch import nn
from indextts_tpu_torch.config import W2VBertConfig
from indextts_tpu_torch.nn import InitRng, Params


def init_w2vbert(rng: InitRng, cfg: W2VBertConfig) -> Params:
    D, inner = cfg.hidden_size, cfg.intermediate_size
    num_pos = cfg.left_max_position_embeddings + cfg.right_max_position_embeddings + 1
    head = D // cfg.num_attention_heads

    def ffn():
        return {"intermediate_dense": nn.dense_init(rng, D, inner),
                "output_dense": nn.dense_init(rng, inner, D)}

    layers = []
    for _ in range(cfg.num_hidden_layers):
        layers.append({
            "ffn1_layer_norm": nn.layer_norm_init(rng, D),
            "ffn1": ffn(),
            "self_attn_layer_norm": nn.layer_norm_init(rng, D),
            "attn": {
                "linear_q": nn.dense_init(rng, D, D),
                "linear_k": nn.dense_init(rng, D, D),
                "linear_v": nn.dense_init(rng, D, D),
                "linear_out": nn.dense_init(rng, D, D),
                "distance_embedding": nn.embedding_init(rng, num_pos, head),
            },
            "conv": {
                "layer_norm": nn.layer_norm_init(rng, D),
                "pointwise_conv1": nn.conv1d_init(rng, D, 2 * D, 1, bias=False),
                "depthwise_conv": nn.conv1d_init(rng, D, D, cfg.conv_depthwise_kernel_size,
                                                 bias=False, groups=D),
                "depthwise_layer_norm": nn.layer_norm_init(rng, D),
                "pointwise_conv2": nn.conv1d_init(rng, D, D, 1, bias=False),
            },
            "ffn2_layer_norm": nn.layer_norm_init(rng, D),
            "ffn2": ffn(),
            "final_layer_norm": nn.layer_norm_init(rng, D),
        })
    return {
        "feature_projection": {
            "layer_norm": nn.layer_norm_init(rng, cfg.feature_projection_input_dim),
            "projection": nn.dense_init(rng, cfg.feature_projection_input_dim, D),
        },
        "layers": layers,
    }


def _ffn_half(fp: Params, x: torch.Tensor) -> torch.Tensor:
    return nn.dense(fp["output_dense"], F.silu(nn.dense(fp["intermediate_dense"], x)))


def _rel_key_attention(ap: Params, cfg: W2VBertConfig, x: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> torch.Tensor:
    B, T, D = x.shape
    H = cfg.num_attention_heads
    Dh = D // H

    def heads(p):
        return nn.dense(p, x).reshape(B, T, H, Dh).transpose(1, 2)

    q, k, v = heads(ap["linear_q"]), heads(ap["linear_k"]), heads(ap["linear_v"])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(Dh)
    pos = torch.arange(T, device=x.device)
    dist = torch.clamp(pos[None, :] - pos[:, None], -cfg.left_max_position_embeddings,
                       cfg.right_max_position_embeddings)
    pe = ap["distance_embedding"]["weight"].to(x.dtype)[
        dist + cfg.left_max_position_embeddings]                       # (T, T, Dh)
    rel = torch.einsum("bhld,lrd->bhlr", q.float(), pe.float())
    scores = scores + rel / math.sqrt(Dh)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], -1e9)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs.float(), v.float()).to(x.dtype)
    return nn.dense(ap["linear_out"], out.transpose(1, 2).reshape(B, T, D))


def _conv_module(cp: Params, cfg: W2VBertConfig, x: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    h = nn.layer_norm(cp["layer_norm"], x, cfg.layer_norm_eps)
    if mask is not None:
        h = h * mask[:, :, None].to(h.dtype)
    h = nn.glu(nn.conv1d(cp["pointwise_conv1"], h, padding="VALID"))
    k = cfg.conv_depthwise_kernel_size
    h = nn.conv1d(cp["depthwise_conv"], h, padding=(k - 1, 0), groups=h.shape[-1])
    h = F.silu(nn.layer_norm(cp["depthwise_layer_norm"], h, cfg.layer_norm_eps))
    return nn.conv1d(cp["pointwise_conv2"], h, padding="VALID")


def w2vbert_forward(params: Params, cfg: W2VBertConfig, features: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    output_layer: Optional[int] = None) -> torch.Tensor:
    """features (B, T, 160) -> hidden state ``output_layer`` (HF indexing:
    0 is the projection output); lengths (B,) valid frames."""
    if output_layer is None:
        output_layer = cfg.output_hidden_layer
    eps = cfg.layer_norm_eps
    fp = params["feature_projection"]
    h = nn.dense(fp["projection"], nn.layer_norm(fp["layer_norm"], features, eps))
    mask = None
    if lengths is not None:
        mask = nn.sequence_mask(lengths, h.shape[1])
        h = h * mask[:, :, None].to(h.dtype)
    for lp in params["layers"][:output_layer]:
        h = h + 0.5 * _ffn_half(lp["ffn1"], nn.layer_norm(lp["ffn1_layer_norm"], h, eps))
        h = h + _rel_key_attention(lp["attn"], cfg,
                                   nn.layer_norm(lp["self_attn_layer_norm"], h, eps), mask)
        h = h + _conv_module(lp["conv"], cfg, h, mask)
        h = h + 0.5 * _ffn_half(lp["ffn2"], nn.layer_norm(lp["ffn2_layer_norm"], h, eps))
        h = nn.layer_norm(lp["final_layer_norm"], h, eps)
    return h
