"""Flow-matching DiT velocity estimator (PyTorch counterpart of
`indextts_tpu/models/s2mel/dit.py`).

input = concat[noisy mel 80, prompt mel 80, cond, style 192] -> hidden;
body  = non-causal rope transformer with AdaptiveLayerNorm (RMSNorm
        modulated by the timestep embedding); attention is kernel K2
        (`ops/attn.py::attention_rope`, rope fused in);
skip  = skip_linear(concat[body, noisy mel]);
head  = WaveNet (gated tanh/sigmoid, reflect padding around each row's
        valid region) + FinalLayer (adaLN LayerNorm + linear) + 1x1 conv.

Activations are (B, T, C). As in the JAX package, the input concat promotes
the stream to the widest of its parts: the f32 Euler state makes the
residual stream, the WaveNet head and the velocity f32 even when ``cond``,
the prompt mel and the style come in the pipeline's bf16. Only K2 takes
q, k, v in ``cond``'s dtype (bf16 on the card, the kernel's input type) and
its output goes back to the stream's dtype. The timestep embeddings and
adaLN modulations are f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from indextts_tpu.config import DiTConfig, S2MelConfig, WaveNetConfig
from indextts_tpu_torch import nn
from indextts_tpu_torch.nn import InitRng, Params
from indextts_tpu_torch.ops.attn import attention_rope


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


def dit_backbone_forward(p: Params, cfg: DiTConfig, x: torch.Tensor, c: torch.Tensor,
                         freqs_cis: torch.Tensor, lengths: torch.Tensor,
                         attn_dtype: torch.dtype) -> torch.Tensor:
    """x (B, T, D), c (B, 1, D) f32 time conditioning, lengths (B,) valid
    frames (keys past them are masked). Attention runs in ``attn_dtype``."""
    if cfg.is_causal:
        raise NotImplementedError("causal DiT is not ported (the shipped DiT is non-causal)")
    for lp in p["layers"]:
        h = _ada_ln(lp["attention_norm"], x, c, cfg.norm_eps)
        q, k, v = torch.chunk(nn.dense(lp["attn"]["wqkv"], h), 3, dim=-1)
        q, k, v = (a.to(attn_dtype).contiguous() for a in (q, k, v))
        out = attention_rope(q, k, v, lengths, freqs_cis, cfg.num_heads)
        x = x + nn.dense(lp["attn"]["wo"], out.to(x.dtype))
        h = _ada_ln(lp["ffn_norm"], x, c, cfg.norm_eps)
        ff = lp["ff"]
        x = x + nn.dense(ff["w2"], F.silu(nn.dense(ff["w1"], h)) * nn.dense(ff["w3"], h))
    return _ada_ln(p["norm"], x, c, cfg.norm_eps)


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
    SConv1d semantics)."""
    hc = w.hidden_dim
    output = torch.zeros_like(x)
    g_all = nn.conv1d(p["cond_layer"], g, padding="VALID")
    m = mask[:, :, None].to(x.dtype)
    for i, lp in enumerate(p["layers"]):
        dilation = w.dilation_rate ** i
        pad_total = (w.kernel_size - 1) * dilation
        pad_r = pad_total // 2
        x_pad = nn.masked_reflect_pad(x, lengths, pad_total - pad_r, pad_r)
        acts = nn.conv1d(lp["in_layer"], x_pad, padding="VALID", dilation=dilation) \
            + g_all[..., i * 2 * hc:(i + 1) * 2 * hc]
        acts = torch.tanh(acts[..., :hc]) * torch.sigmoid(acts[..., hc:])
        res_skip = nn.conv1d(lp["res_skip"], acts, padding="VALID")
        if i < w.num_layers - 1:
            x = (x + res_skip[..., :hc]) * m
            output = output + res_skip[..., hc:]
        else:
            output = output + res_skip
    return output * m


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
                cond: torch.Tensor, freqs_cis: torch.Tensor) -> torch.Tensor:
    """Velocity (B, T, 80) f32 for noisy mel x and prompt mel prompt_x (B, T,
    80), valid lengths x_lens (B,), times t (B,), style (B, 192) and cond
    (B, T, content_dim); freqs_cis (>= T, head_dim/2, 2)."""
    cfg, w = s2.DiT, s2.wavenet
    B, T, _ = x.shape
    t1 = timestep_embed(p["t_embedder"], t)                         # (B, D) f32
    cond_p = nn.dense(p["cond_projection"], cond)
    dt = torch.promote_types(torch.promote_types(x.dtype, prompt_x.dtype), cond_p.dtype)
    x_in = torch.cat([x.to(dt), prompt_x.to(dt), cond_p.to(dt),
                      style[:, None, :].to(dt).expand(B, T, style.shape[-1])], dim=-1)
    x_in = nn.dense(p["cond_x_merge_linear"], x_in)
    mask = nn.sequence_mask(x_lens, T)
    x_res = dit_backbone_forward(p["transformer"], cfg, x_in, t1[:, None, :],
                                 freqs_cis, x_lens, cond.dtype)
    x_res = nn.dense(p["skip_linear"], torch.cat([x_res, x.to(dt)], dim=-1))
    h = nn.dense(p["conv1"], x_res)
    t2 = timestep_embed(p["t_embedder2"], t)
    h = wavenet_forward(p["wavenet"], w, h, mask, t2[:, None, :].to(dt), x_lens)
    h = h + nn.dense(p["res_projection"], x_res)
    shift, scale = torch.chunk(nn.dense(p["final_layer"]["adaLN"], F.silu(t1)), 2, dim=-1)
    hn = nn.layer_norm({}, h.float(), eps=1e-6) * (1 + scale[:, None, :]) + shift[:, None, :]
    hn = nn.dense(p["final_layer"]["linear"], hn.to(dt))
    return nn.conv1d(p["conv2"], hn, padding="VALID").float()
