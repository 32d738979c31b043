"""Perceiver resampler (PyTorch counterpart of
`indextts_tpu/models/gpt/perceiver.py`): learned latents cross-attend
[latents; context], GEGLU feed-forward, scaled-L2 output norm."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from indextts_tpu_torch import nn
from indextts_tpu_torch.nn import InitRng, Params


@dataclass(frozen=True)
class PerceiverDims:
    dim: int
    dim_context: int
    num_latents: int = 32
    dim_head: int = 64
    heads: int = 8
    ff_mult: int = 4
    depth: int = 2

    @property
    def ff_inner(self) -> int:
        # GEGLU: dim_inner = int(dim * mult * 2 / 3)
        return int(self.dim * self.ff_mult * 2 / 3)


def init_perceiver(rng: InitRng, d: PerceiverDims) -> Params:
    inner = d.dim_head * d.heads
    p: Params = {"latents": rng.normal((d.num_latents, d.dim), std=0.02)}
    if d.dim_context != d.dim:
        p["proj_context"] = nn.dense_init(rng, d.dim_context, d.dim)
    p["layers"] = [{
        "attn": {"to_q": nn.dense_init(rng, d.dim, inner, bias=False),
                 "to_kv": nn.dense_init(rng, d.dim, inner * 2, bias=False),
                 "to_out": nn.dense_init(rng, inner, d.dim, bias=False)},
        "ff": {"w_in": nn.dense_init(rng, d.dim, d.ff_inner * 2),
               "w_out": nn.dense_init(rng, d.ff_inner, d.dim)},
    } for _ in range(d.depth)]
    p["norm"] = nn.l2norm_scale_init(rng, d.dim)
    return p


def perceiver_resample(p: Params, d: PerceiverDims, ctx: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ctx (B, T, dim_context); mask (B, num_latents + T) keep-mask (latents
    first). Returns (B, num_latents, dim)."""
    B = ctx.shape[0]
    if "proj_context" in p:
        ctx = nn.dense(p["proj_context"], ctx)
    latents = p["latents"].to(ctx.dtype)[None].expand(B, -1, -1)
    m = None if mask is None else mask[:, None, None, :]
    for lp in p["layers"]:
        context = torch.cat([latents, ctx], dim=1)
        q = nn.dense(lp["attn"]["to_q"], latents)
        k, v = torch.chunk(nn.dense(lp["attn"]["to_kv"], context), 2, dim=-1)

        def heads(t):
            return t.reshape(B, t.shape[1], d.heads, d.dim_head).transpose(1, 2)

        out = nn.mha(heads(q), heads(k), heads(v), mask=m, scale=1.0 / math.sqrt(d.dim_head))
        out = out.transpose(1, 2).reshape(B, d.num_latents, d.heads * d.dim_head)
        latents = latents + nn.dense(lp["attn"]["to_out"], out)
        a, gate = torch.chunk(nn.dense(lp["ff"]["w_in"], latents), 2, dim=-1)
        latents = latents + nn.dense(lp["ff"]["w_out"], F.gelu(gate) * a)
    return nn.l2norm_scaled(p["norm"], latents, d.dim)
