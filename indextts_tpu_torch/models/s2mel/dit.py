"""Flow-matching DiT velocity estimator (PyTorch counterpart of
`indextts_tpu/models/s2mel/dit.py`).

input = concat[noisy mel 80, prompt mel 80, cond, style 192] -> hidden;
body  = non-causal rope transformer with AdaptiveLayerNorm (RMSNorm
        modulated by the timestep embedding); attention by the JAX DiT's
        three tiers (`attention_tier`): kernel K2 with the rope fused in,
        kernel K4 through `nn.mha_flash`, or dense `nn.mha`;
skip  = skip_linear(concat[body, noisy mel]);
head  = WaveNet (gated tanh/sigmoid, reflect padding around each row's
        valid region) + FinalLayer (adaLN LayerNorm + linear) + 1x1 conv.

Under a mesh (`parallel/mesh.py::shard_dit`), `dit_forward_mesh` runs the
same network over sp x tp ranks: each tp rank its heads and its part of the
FFN (the attention on the tier `attention_tier` picks for the shard's
heads: K2 once a shard on the packed tier, K4 on the flash tier), the wo
and w2 partials reduced on the tp group's rank 0; each sp rank its block of
frames, attending its query rows against the gathered k and v in the dense
form (GSPMD's form of the JAX DiT under ``seq_sharding``) and reading a
halo of frames from the other blocks for each WaveNet convolution.

Activations are (B, T, C). As in the JAX package, the input concat promotes
the stream to the widest of its parts: the f32 Euler state makes the
residual stream, the WaveNet head and the velocity f32 even when ``cond``,
the prompt mel and the style come in the pipeline's bf16. Only the kernels
(K2, K4) take q, k, v in ``cond``'s dtype (bf16 on the card, their input
type) and their output goes back to the stream's dtype. The timestep
embeddings and adaLN modulations are f32.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional

import torch
import torch.nn.functional as F

from indextts_tpu_torch import nn
from indextts_tpu_torch.config import DiTConfig, S2MelConfig, WaveNetConfig
from indextts_tpu_torch.nn import InitRng, Params
from indextts_tpu_torch.ops.attn import attention_rope
from indextts_tpu_torch.ops.rope import apply_rotary_emb_half


def init_timestep_embedder(rng: InitRng, hidden: int, freq_dim: int = 256) -> Params:
    return {"mlp0": nn.dense_init(rng, freq_dim, hidden),
            "mlp2": nn.dense_init(rng, hidden, hidden)}


def timestep_embedding(t: torch.Tensor, freq_dim: int = 256, max_period: float = 10000.0,
                       scale: float = 1000.0) -> torch.Tensor:
    """(B,) -> (B, freq_dim) f32 [cos | sin] features."""
    half = freq_dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = scale * t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def timestep_embed(p: Params, t: torch.Tensor) -> torch.Tensor:
    return nn.dense(p["mlp2"], F.silu(nn.dense(p["mlp0"], timestep_embedding(t))))


def _ada_ln_init(rng: InitRng, dim: int) -> Params:
    return {"project": nn.dense_init(rng, dim, 2 * dim), "norm": nn.rms_norm_init(rng, dim)}


def _ada_ln(p: Params, x: torch.Tensor, c: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm(x) * w + b with (w, b) = project(c) computed in f32 and
    applied in x's dtype. c: (B, 1, D) f32."""
    normed = nn.rms_norm(p["norm"], x, eps)
    w, b = torch.chunk(nn.dense(p["project"], c.float()), 2, dim=-1)
    return w.to(x.dtype) * normed + b.to(x.dtype)


def init_dit_backbone(rng: InitRng, cfg: DiTConfig) -> Params:
    D, H, Dh = cfg.hidden_dim, cfg.num_heads, cfg.head_dim
    inter = cfg.intermediate_size
    layers = [{
        "attention_norm": _ada_ln_init(rng, D),
        "attn": {"wqkv": nn.dense_init(rng, D, 3 * H * Dh, bias=False),
                 "wo": nn.dense_init(rng, H * Dh, D, bias=False)},
        "ffn_norm": _ada_ln_init(rng, D),
        "ff": {"w1": nn.dense_init(rng, D, inter, bias=False),
               "w3": nn.dense_init(rng, D, inter, bias=False),
               "w2": nn.dense_init(rng, inter, D, bias=False)},
    } for _ in range(cfg.depth)]
    return {"layers": nn.stack_layers(layers), "norm": _ada_ln_init(rng, D)}


def attention_tier(cfg: DiTConfig, lengths: Optional[torch.Tensor]) -> str:
    """The JAX DiT's attention tier, by its own gates and switches
    (`indextts_tpu/models/s2mel/dit.py:157-168`), fastest first:
    "packed" (K2, rope in the kernel) for H even and 2 * head_dim == 128
    unless INDEXTTS_PACKED_ATTN=0; else "flash" (rope outside, then
    `nn.mha_flash`: K4 on the card) unless INDEXTTS_FLASH_DIT=0; else
    "dense" (`nn.mha`). Both kernels need ``lengths``. The TPU's own caps
    (T <= 3456 packed, T <= 1536 flash, T % 128 == 0, a TPU backend) are
    VMEM and tiling limits the card's kernels do not have, and are dropped."""
    if lengths is None:
        return "dense"
    if (cfg.num_heads % 2 == 0 and 2 * cfg.head_dim == 128
            and os.environ.get("INDEXTTS_PACKED_ATTN", "1") != "0"):
        return "packed"
    if os.environ.get("INDEXTTS_FLASH_DIT", "1") != "0":
        return "flash"
    return "dense"


def _attention(cfg: DiTConfig, tier: str, q, k, v, freqs_cis, lengths,
               attn_dtype) -> torch.Tensor:
    """(B, T, H*Dh) pre-rope q, k, v of the stream -> (B, T, H*Dh) in the
    stream's dtype; the kernels run in ``attn_dtype``."""
    B, T, _ = q.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    if tier == "packed":
        q, k, v = (a.to(attn_dtype).contiguous() for a in (q, k, v))
        return attention_rope(q, k, v, lengths, freqs_cis, H)
    qh = apply_rotary_emb_half(q.reshape(B, T, H, Dh), freqs_cis)
    kh = apply_rotary_emb_half(k.reshape(B, T, H, Dh), freqs_cis)
    vh = v.reshape(B, T, H, Dh)
    if tier == "flash":
        qh, kh, vh = (a.to(attn_dtype) for a in (qh, kh, vh))
        out = nn.mha_flash(qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2), lengths)
    else:
        mask = None if lengths is None else nn.sequence_mask(lengths, T)[:, None, None, :]
        out = nn.mha(qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2), mask=mask)
    return out.transpose(1, 2).reshape(B, T, H * Dh)


def dit_backbone_forward(p: Params, cfg: DiTConfig, x: torch.Tensor, c: torch.Tensor,
                         freqs_cis: torch.Tensor, lengths: Optional[torch.Tensor],
                         attn_dtype: torch.dtype, tier: Optional[str] = None) -> torch.Tensor:
    """x (B, T, D), c (B, 1, D) f32 time conditioning, lengths (B,) valid
    frames (keys past them are masked; None: no mask, the dense tier). The
    kernels' attention runs in ``attn_dtype``; the dense tier in the
    stream's dtype, as in the JAX package. ``tier`` names the attention tier
    ("packed", "flash" or "dense"; default `attention_tier`'s): training
    asks for "dense", the one differentiable tier (the kernels have no
    backward). Query rows past a length are garbage the caller masks. One
    device: `dit_backbone_forward_mesh` on one rank."""
    block = {"transformer": {"shards": [p["layers"]], "norm": p["norm"]}}
    return dit_backbone_forward_mesh([block], cfg, [x], [c], freqs_cis, lengths, attn_dtype,
                                     [0], x.shape[1], tier)[0]


def init_wavenet(rng: InitRng, w: WaveNetConfig) -> Params:
    hc = w.hidden_dim
    layers = [{"in_layer": nn.conv1d_init(rng, hc, 2 * hc, w.kernel_size),
               "res_skip": nn.conv1d_init(rng, hc, 2 * hc if i < w.num_layers - 1 else hc, 1)}
              for i in range(w.num_layers)]
    return {"layers": layers,
            "cond_layer": nn.conv1d_init(rng, hc, 2 * hc * w.num_layers, 1)}


def wavenet_forward(p: Params, w: WaveNetConfig, x: torch.Tensor, mask: torch.Tensor,
                    g: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Non-causal WN with gated units; x (B, T, hc), g (B, 1, hc). The
    in_layer convs pad by reflection around each row's valid region (encodec
    SConv1d semantics). One device: `wavenet_forward_mesh` on one rank."""
    return wavenet_forward_mesh([p], w, [x], [mask], [g], lengths, [0], x.shape[1])[0]


def init_dit(rng: InitRng, s2: S2MelConfig) -> Params:
    cfg, w = s2.DiT, s2.wavenet
    D = cfg.hidden_dim
    if cfg.final_layer_type != "wavenet" or not cfg.style_condition or cfg.style_as_token:
        raise NotImplementedError("only the shipped DiT (wavenet head, style "
                                  "concatenated to the input) is ported")
    merge_in = D + cfg.in_channels * 2 + s2.style_encoder.dim
    return {
        "x_embedder": nn.dense_init(rng, cfg.in_channels, D),
        "cond_projection": nn.dense_init(rng, cfg.content_dim, D),
        "t_embedder": init_timestep_embedder(rng, D),
        "cond_x_merge_linear": nn.dense_init(rng, merge_in, D),
        "skip_linear": nn.dense_init(rng, D + cfg.in_channels, D),
        "transformer": init_dit_backbone(rng, cfg),
        "t_embedder2": init_timestep_embedder(rng, w.hidden_dim),
        "conv1": nn.dense_init(rng, D, w.hidden_dim),
        "wavenet": init_wavenet(rng, w),
        "res_projection": nn.dense_init(rng, D, w.hidden_dim),
        "final_layer": {"linear": nn.dense_init(rng, w.hidden_dim, w.hidden_dim),
                        "adaLN": nn.dense_init(rng, D, 2 * w.hidden_dim)},
        "conv2": nn.conv1d_init(rng, w.hidden_dim, cfg.in_channels, 1),
    }


def dit_forward(p: Params, s2: S2MelConfig, x: torch.Tensor, prompt_x: torch.Tensor,
                x_lens: torch.Tensor, t: torch.Tensor, style: torch.Tensor,
                cond: torch.Tensor, freqs_cis: torch.Tensor,
                tier: Optional[str] = None) -> torch.Tensor:
    """Velocity (B, T, 80) f32 for noisy mel x and prompt mel prompt_x (B, T,
    80), valid lengths x_lens (B,), times t (B,), style (B, 192) and cond
    (B, T, content_dim); freqs_cis (>= T, head_dim/2, 2); ``tier`` the
    backbone's attention tier (`dit_backbone_forward`). One device:
    `dit_forward_mesh` on one rank."""
    block = {**p, "transformer": {"shards": [p["transformer"]["layers"]],
                                  "norm": p["transformer"]["norm"]}}
    return dit_forward_mesh({"sp": [block]}, s2, [x], [prompt_x], x_lens, t, style, [cond],
                            freqs_cis, [0], x.shape[1], tier)[0]


# ---------------------------------------------------------------------------
# the DiT over a mesh (sp x tp ranks of one dp rank)
# ---------------------------------------------------------------------------

def _shard_cfg(cfg: DiTConfig, tp: int) -> DiTConfig:
    """One tp shard's DiT widths: H/tp heads of the same head width."""
    if cfg.num_heads % tp:
        raise ValueError(f"the DiT's {cfg.num_heads} heads do not split over tp={tp}")
    return dataclasses.replace(cfg, hidden_dim=cfg.hidden_dim // tp,
                               num_heads=cfg.num_heads // tp)


def _row_parallel(ps: List[Params], xs: List[torch.Tensor], out_dtype) -> torch.Tensor:
    """A row-parallel layer over a tp group: ``ps[t]`` on ``xs[t]``; one
    rank is `nn.dense` itself, more are f32 partials reduced on rank 0."""
    if len(ps) == 1:
        return nn.dense(ps[0], xs[0]).to(out_dtype)
    return nn.dense_reduce(ps[0], [nn.dense_partial(p, x) for p, x in zip(ps, xs)], out_dtype)


def _gathered_attention(cfg: DiTConfig, qkv, freqs_cis, lengths, offsets, T: int):
    """The sp form of one tp rank's attention: ``qkv[s]`` the (q, k, v)
    (B, Tl, Hs*Dh) of sp block s (frames from ``offsets[s]``); each block's
    rows roped at their own positions, k and v gathered from every block to
    the querying block's device, the dense masked attention over T frames.
    Returns the (B, Tl, Hs*Dh) outputs, one per block."""
    H, Dh = cfg.num_heads, cfg.head_dim
    roped = []
    for (q, k, v), off in zip(qkv, offsets):
        B, Tl, _ = q.shape
        fc = freqs_cis[off:off + Tl].to(q.device)
        roped.append((apply_rotary_emb_half(q.reshape(B, Tl, H, Dh), fc).transpose(1, 2),
                      apply_rotary_emb_half(k.reshape(B, Tl, H, Dh), fc).transpose(1, 2),
                      v.reshape(B, Tl, H, Dh).transpose(1, 2)))
    outs = []
    for q, _, _ in roped:
        dev = q.device
        k = torch.cat([r[1].to(dev) for r in roped], dim=2)
        v = torch.cat([r[2].to(dev) for r in roped], dim=2)
        mask = nn.sequence_mask(lengths.to(dev), T)[:, None, None, :]
        out = nn.mha(q, k, v, mask=mask)
        outs.append(out.transpose(1, 2).reshape(q.shape[0], q.shape[2], H * Dh))
    return outs


def dit_backbone_forward_mesh(blocks: List[Params], cfg: DiTConfig, xs: List[torch.Tensor],
                              cs: List[torch.Tensor], freqs_cis: torch.Tensor,
                              lengths: torch.Tensor, attn_dtype: torch.dtype,
                              offsets: List[int], T: int,
                              tier: Optional[str] = None) -> List[torch.Tensor]:
    """The backbone over the sp x tp ranks of `shard_dit`: ``blocks[s]`` sp
    rank s's DiT, ``xs[s]`` / ``cs[s]`` its frames (B, Tl, D) and time
    conditioning (B, 1, D) on rank (s, 0)'s device, the blocks starting at
    frame ``offsets[s]`` of T (`dit_backbone_forward` is one block of one
    rank). One sp rank attends on the tier (``tier``, default
    `attention_tier` of the shard's heads); more attend in the dense form
    (`_gathered_attention`)."""
    if cfg.is_causal:
        raise NotImplementedError("causal DiT is not ported (the shipped DiT is non-causal)")
    tp = len(blocks[0]["transformer"]["shards"])
    sub = _shard_cfg(cfg, tp)
    if len(blocks) == 1 and tier is None:
        tier = attention_tier(sub, lengths)
    shards = [b["transformer"]["shards"] for b in blocks]
    for li in range(len(shards[0][0])):
        lps = [[sh[t][li] for t in range(tp)] for sh in shards]
        hs = [_ada_ln(lp[0]["attention_norm"], x, c, cfg.norm_eps)
              for lp, x, c in zip(lps, xs, cs)]
        qkv = [[torch.chunk(nn.dense(lp[t]["attn"]["wqkv"], h.to(lp[t]["attn"]["wqkv"]["weight"]
                                                             .device)), 3, dim=-1)
                for t in range(tp)] for lp, h in zip(lps, hs)]
        if len(blocks) == 1:
            outs = [[_attention(sub, tier, *qkv[0][t], freqs_cis.to(qkv[0][t][0].device),
                                None if lengths is None else lengths.to(qkv[0][t][0].device),
                                attn_dtype) for t in range(tp)]]
        else:
            per_t = [_gathered_attention(sub, [qkv[s][t] for s in range(len(blocks))],
                                         freqs_cis, lengths, offsets, T) for t in range(tp)]
            outs = [[per_t[t][s] for t in range(tp)] for s in range(len(blocks))]
        xs = [x + _row_parallel([lp[t]["attn"]["wo"] for t in range(tp)],
                                [o.to(x.dtype) for o in out], x.dtype)
              for lp, x, out in zip(lps, xs, outs)]
        hs = [_ada_ln(lp[0]["ffn_norm"], x, c, cfg.norm_eps) for lp, x, c in zip(lps, xs, cs)]
        ffs = []
        for lp, h, x in zip(lps, hs, xs):
            mids = []
            for t in range(tp):
                ff = lp[t]["ff"]
                ht = h.to(ff["w1"]["weight"].device)
                mids.append(F.silu(nn.dense(ff["w1"], ht)) * nn.dense(ff["w3"], ht))
            ffs.append(x + _row_parallel([lp[t]["ff"]["w2"] for t in range(tp)], mids, x.dtype))
        xs = ffs
    return [_ada_ln(b["transformer"]["norm"], x, c, cfg.norm_eps)
            for b, x, c in zip(blocks, xs, cs)]


def _halo_padded(xs: List[torch.Tensor], lengths: torch.Tensor, offsets: List[int], T: int,
                 pad_left: int, pad_right: int) -> List[torch.Tensor]:
    """`nn.masked_reflect_pad` of the frames split over sp blocks, each
    block's part computed from its own frames and a halo of pad_left +
    pad_right frames on either side read from the other blocks (the halo
    exchange GSPMD inserts): block s gets (B, Tl + pad_left + pad_right, C),
    the padded sequence's positions of its output frames. A reflected index
    outside the halo (rows shorter than the halo) feeds only frames past the
    row's length, which the caller masks; it is clamped into the halo."""
    halo = pad_left + pad_right
    out = []
    for x, off in zip(xs, offsets):
        dev, Tl = x.device, x.shape[1]
        lo, hi = max(off - halo, 0), min(off + Tl + halo, T)
        parts = []
        for y, o in zip(xs, offsets):
            a, b = max(lo, o), min(hi, o + y.shape[1])
            if a < b:
                parts.append(y[:, a - o:b - o].to(dev))
        window = torch.cat(parts, dim=1)                       # frames [lo, hi)
        g = torch.arange(off - pad_left, off + Tl + pad_right, device=dev)[None, :]
        last = torch.clamp(lengths.to(dev)[:, None] - 1, min=0)
        src = (last - (last - g.abs()).abs()).clamp(0, T - 1).clamp(lo, hi - 1) - lo
        out.append(torch.gather(window, 1, src[:, :, None].expand(-1, -1, x.shape[2])))
    return out


def wavenet_forward_mesh(ps: List[Params], w: WaveNetConfig, xs: List[torch.Tensor],
                         masks: List[torch.Tensor], gs: List[torch.Tensor],
                         lengths: torch.Tensor, offsets: List[int], T: int) -> List[torch.Tensor]:
    """The WaveNet head over sp blocks of frames (``ps[s]`` the head's
    weights on block s's device; `wavenet_forward` is one block): every
    convolution reads its halo (`_halo_padded`, on one block
    `nn.masked_reflect_pad`'s values), everything else is per frame."""
    hc = w.hidden_dim
    outputs = [torch.zeros_like(x) for x in xs]
    g_all = [nn.conv1d(p["cond_layer"], g, padding="VALID") for p, g in zip(ps, gs)]
    ms = [m[:, :, None].to(x.dtype) for m, x in zip(masks, xs)]
    for i in range(w.num_layers):
        dilation = w.dilation_rate ** i
        pad_total = (w.kernel_size - 1) * dilation
        pad_r = pad_total // 2
        padded = _halo_padded(xs, lengths, offsets, T, pad_total - pad_r, pad_r)
        new_xs = []
        for s, (p, x_pad) in enumerate(zip(ps, padded)):
            lp = p["layers"][i]
            acts = nn.conv1d(lp["in_layer"], x_pad, padding="VALID", dilation=dilation) \
                + g_all[s][..., i * 2 * hc:(i + 1) * 2 * hc]
            acts = torch.tanh(acts[..., :hc]) * torch.sigmoid(acts[..., hc:])
            res_skip = nn.conv1d(lp["res_skip"], acts, padding="VALID")
            if i < w.num_layers - 1:
                new_xs.append((xs[s] + res_skip[..., :hc]) * ms[s])
                outputs[s] = outputs[s] + res_skip[..., hc:]
            else:
                new_xs.append(xs[s])
                outputs[s] = outputs[s] + res_skip
        xs = new_xs
    return [o * m for o, m in zip(outputs, ms)]


def dit_forward_mesh(p: Params, s2: S2MelConfig, xs: List[torch.Tensor],
                     prompts: List[torch.Tensor], x_lens: torch.Tensor, t: torch.Tensor,
                     style: torch.Tensor, conds: List[torch.Tensor], freqs_cis: torch.Tensor,
                     offsets: List[int], T: int,
                     tier: Optional[str] = None) -> List[torch.Tensor]:
    """`dit_forward` on the tree of `shard_dit` (``p``): the noisy mel,
    prompt mel and cond split over its sp ranks into blocks of frames
    (``xs[s]`` etc. on rank (s, 0)'s device, block s from frame
    ``offsets[s]`` of T; one block when sp is 1); x_lens, t and style whole;
    ``tier`` as in `dit_backbone_forward_mesh`. Returns the velocity (B, Tl,
    80) f32 of each block."""
    cfg, w = s2.DiT, s2.wavenet
    blocks = p["sp"]
    x_res, t1s, dts, masks = [], [], [], []
    for b, x, prompt_x, cond, off in zip(blocks, xs, prompts, conds, offsets):
        dev = x.device
        B, Tl, _ = x.shape
        t1 = timestep_embed(b["t_embedder"], t.to(dev))
        cond_p = nn.dense(b["cond_projection"], cond)
        dt = torch.promote_types(torch.promote_types(x.dtype, prompt_x.dtype), cond_p.dtype)
        st = style.to(dev)
        x_in = torch.cat([x.to(dt), prompt_x.to(dt), cond_p.to(dt),
                          st[:, None, :].to(dt).expand(B, Tl, st.shape[-1])], dim=-1)
        x_res.append(nn.dense(b["cond_x_merge_linear"], x_in))
        t1s.append(t1)
        dts.append(dt)
        masks.append(nn.sequence_mask(x_lens.to(dev), T)[:, off:off + Tl])
    x_res = dit_backbone_forward_mesh(blocks, cfg, x_res, [t1[:, None, :] for t1 in t1s],
                                      freqs_cis, x_lens, conds[0].dtype, offsets, T, tier)
    hs, resid, gs = [], [], []
    for b, xr, x, dt in zip(blocks, x_res, xs, dts):
        xr = nn.dense(b["skip_linear"], torch.cat([xr, x.to(dt)], dim=-1))
        resid.append(xr)
        hs.append(nn.dense(b["conv1"], xr))
        gs.append(timestep_embed(b["t_embedder2"], t.to(x.device))[:, None, :].to(dt))
    hs = wavenet_forward_mesh([b["wavenet"] for b in blocks], w, hs, masks, gs, x_lens,
                              offsets, T)
    outs = []
    for b, h, xr, t1, dt in zip(blocks, hs, resid, t1s, dts):
        h = h + nn.dense(b["res_projection"], xr)
        shift, scale = torch.chunk(nn.dense(b["final_layer"]["adaLN"], F.silu(t1)), 2, dim=-1)
        hn = nn.layer_norm({}, h.float(), eps=1e-6) * (1 + scale[:, None, :]) + shift[:, None, :]
        hn = nn.dense(b["final_layer"]["linear"], hn.to(dt))
        outs.append(nn.conv1d(b["conv2"], hn, padding="VALID").float())
    return outs
