"""RepCodec semantic codec (PyTorch counterpart of
`indextts_tpu/models/codec/repcodec.py`): Vocos ConvNeXt encoder + factorized
L2-normalized VQ (8-dim codebook) for `repcodec_quantize`, and the codebook
re-embedding `repcodec_vq2emb`."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from indextts_tpu.config import SemanticCodecConfig
from indextts_tpu_torch import nn
from indextts_tpu_torch.nn import InitRng, Params


def init_vocos_backbone(rng: InitRng, input_ch: int, dim: int,
                        intermediate_dim: int, num_layers: int) -> Params:
    blocks = [{
        "dwconv": nn.conv1d_init(rng, dim, dim, 7, groups=dim),
        "norm": nn.layer_norm_init(rng, dim),
        "pwconv1": nn.dense_init(rng, dim, intermediate_dim, std=0.02),
        "pwconv2": nn.dense_init(rng, intermediate_dim, dim, std=0.02),
        "gamma": rng.ones((dim,)) * (1.0 / num_layers),
    } for _ in range(num_layers)]
    return {"embed": nn.conv1d_init(rng, input_ch, dim, 7),
            "norm": nn.layer_norm_init(rng, dim),
            "convnext": blocks,
            "final_layer_norm": nn.layer_norm_init(rng, dim)}


def vocos_backbone(p: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, T, C_in) -> (B, T, dim)."""
    x = nn.layer_norm(p["norm"], nn.conv1d(p["embed"], x, padding=3), eps=1e-6)
    for bp in p["convnext"]:
        h = nn.conv1d(bp["dwconv"], x, padding=3, groups=x.shape[-1])
        h = nn.layer_norm(bp["norm"], h, eps=1e-6)
        h = nn.dense(bp["pwconv2"], F.gelu(nn.dense(bp["pwconv1"], h)))
        x = x + h * bp["gamma"].to(h.dtype)
    return nn.layer_norm(p["final_layer_norm"], x, eps=1e-6)


def init_fvq(rng: InitRng, input_dim: int, codebook_size: int, codebook_dim: int) -> Params:
    p: Params = {"codebook": nn.embedding_init(rng, codebook_size, codebook_dim, std=1.0)}
    if input_dim != codebook_dim:
        p["in_project"] = nn.dense_init(rng, input_dim, codebook_dim)
        p["out_project"] = nn.dense_init(rng, codebook_dim, input_dim)
    return p


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps))


def fvq_quantize(p: Params, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """z (B, T, D_in) -> (indices (B, T), z_q (B, T, D_in)): nearest
    L2-normalized codebook entry, then the out-projection."""
    z_e = nn.dense(p["in_project"], z) if "in_project" in p else z
    enc = _l2n(z_e.float())
    cb = _l2n(p["codebook"]["weight"].float())
    indices = torch.argmax(enc @ cb.t(), dim=-1)
    z_q = p["codebook"]["weight"].to(z.dtype)[indices]
    if "out_project" in p:
        z_q = nn.dense(p["out_project"], z_q)
    return indices, z_q


def init_repcodec(rng: InitRng, cfg: SemanticCodecConfig) -> Params:
    if cfg.downsample_scale and cfg.downsample_scale > 1:
        raise NotImplementedError("RepCodec downsampling is not ported (the "
                                  "shipped config has downsample_scale=1)")
    return {
        "encoder": init_vocos_backbone(rng, cfg.hidden_size, cfg.vocos_dim,
                                       cfg.vocos_intermediate_dim, cfg.vocos_num_layers),
        "encoder_out": nn.dense_init(rng, cfg.vocos_dim, cfg.hidden_size, std=0.02),
        "decoder": init_vocos_backbone(rng, cfg.hidden_size, cfg.vocos_dim,
                                       cfg.vocos_intermediate_dim, cfg.vocos_num_layers),
        "decoder_out": nn.dense_init(rng, cfg.vocos_dim, cfg.hidden_size, std=0.02),
        "quantizer": [init_fvq(rng, cfg.hidden_size, cfg.codebook_size, cfg.codebook_dim)
                      for _ in range(cfg.num_quantizers)],
    }


def repcodec_quantize(p: Params, cfg: SemanticCodecConfig,
                      x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, hidden) w2v-bert features -> (codes (B, T), quantized (B, T, hidden))."""
    h = nn.dense(p["encoder_out"], vocos_backbone(p["encoder"], x))
    quantized = torch.zeros_like(h)
    residual = h
    indices = []
    for q in p["quantizer"]:
        idx, z_q = fvq_quantize(q, residual)
        quantized = quantized + z_q
        residual = residual - z_q
        indices.append(idx)
    return (indices[0] if len(indices) == 1 else torch.stack(indices)), quantized


def repcodec_vq2emb(p: Params, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, T) -> (B, T, hidden) through the first quantizer's codebook
    and out-projection."""
    q = p["quantizer"][0]
    cb = q["codebook"]["weight"]
    # the stop-token padding past each row's length indexes beyond the
    # codebook; JAX clamps such gathers, so clamp to the same rows (they are
    # masked downstream)
    emb = cb[codes.long().clamp(0, cb.shape[0] - 1)]
    return nn.dense(q["out_project"], emb) if "out_project" in q else emb
