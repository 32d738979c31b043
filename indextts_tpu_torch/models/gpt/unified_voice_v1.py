"""UnifiedVoice v1 (IndexTTS-1 / 1.5), the mel-conditioned speech-token model
(PyTorch counterpart of `indextts_tpu/models/gpt/unified_voice_v1.py`).

What differs from v2 (`unified_voice.py`):
- the conditioning input is the prompt's 100-bin 24 kHz mel
  (`ops/mel.py::mel_spectrogram_24k_v1`), through the conformer + perceiver
  (v1.5, ``condition_type="conformer_perceiver"``) or through a stack of
  AttentionBlocks + perceiver (v1.0, ``"perceiver"``);
- no emotion vector and no duration tokens: the prefix is [cond latents]
  [text];
- the teacher-forced latents feed BigVGAN v1 directly (no s2mel).
The GPT-2 backbone, the decode engines and the prefix are v2's.
"""

from __future__ import annotations

import math

import torch

from indextts_tpu_torch import nn
from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.models.gpt.conformer import (ConformerDims, conformer_encode,
                                                     init_conformer)
from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims, init_gpt2
from indextts_tpu_torch.models.gpt.perceiver import (PerceiverDims, init_perceiver,
                                                     perceiver_resample)
from indextts_tpu_torch.models.gpt.unified_voice import _with_latent_mask, teacher_forced
from indextts_tpu_torch.nn import InitRng, Params


# ---------------------------------------------------------------------------
# the AttentionBlock conditioning encoder (v1.0, condition_type="perceiver")
# ---------------------------------------------------------------------------

def _gn_groups(channels: int) -> int:
    """The reference's `normalization()` group count."""
    groups = 32
    if channels <= 16:
        groups = 8
    elif channels <= 64:
        groups = 16
    while channels % groups != 0:
        groups = int(groups / 2)
    assert groups > 2
    return groups


def init_attention_block(rng: InitRng, channels: int, heads: int) -> Params:
    return {
        "norm": nn.group_norm_init(rng, channels),
        "qkv": nn.conv1d_init(rng, channels, channels * 3, 1),
        "proj_out": {"kernel": rng.zeros((1, channels, channels)),
                     "bias": rng.zeros((channels,))},
    }


def attention_block(p: Params, x: torch.Tensor, heads: int) -> torch.Tensor:
    """QKVAttentionLegacy block over (B, T, C): GroupNorm -> 1x1 qkv conv
    with per-head [q, k, v] channel groups -> q and k each scaled by
    1/sqrt(sqrt(ch)) -> softmax -> 1x1 out conv, residual. The scores, the
    softmax and the weighted sum in f32 (the probabilities rounded to x's
    dtype first), as the JAX einsums with f32 results."""
    B, T, C = x.shape
    ch = C // heads
    h = nn.group_norm(p["norm"], x, groups=_gn_groups(C))
    qkv = nn.conv1d(p["qkv"], h, padding="VALID").reshape(B, T, heads, 3 * ch)
    q, k, v = torch.split(qkv, ch, dim=-1)
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    logits = torch.einsum("bthc,bshc->bhts", (q * scale).float(), (k * scale).float())
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    a = torch.einsum("bhts,bshc->bthc", w.float(), v.float()).to(x.dtype)
    return x + nn.conv1d(p["proj_out"], a.reshape(B, T, C), padding="VALID")


def init_conditioning_encoder(rng: InitRng, spec_dim: int, embedding_dim: int,
                              attn_blocks: int = 6, heads: int = 4) -> Params:
    return {"init": nn.conv1d_init(rng, spec_dim, embedding_dim, 1),
            "attn": [init_attention_block(rng, embedding_dim, heads)
                     for _ in range(attn_blocks)]}


def conditioning_encoder(p: Params, x: torch.Tensor, heads: int,
                         mean: bool = False) -> torch.Tensor:
    """(B, T, spec_dim) -> (B, T, D), or (B, D) with ``mean``."""
    h = nn.conv1d(p["init"], x, padding="VALID")
    for bp in p["attn"]:
        h = attention_block(bp, h, heads)
    return h.mean(1) if mean else h


# ---------------------------------------------------------------------------
# the v1 model
# ---------------------------------------------------------------------------

def make_dims_v1(cfg: GPTConfig) -> dict:
    dims = {"gpt": GPT2Dims(cfg.layers, cfg.model_dim, cfg.heads)}
    if cfg.condition_type == "conformer_perceiver":
        cm = cfg.condition_module
        dims["cond_conformer"] = ConformerDims(
            input_size=cfg.cond_input_dim, output_size=cm.output_size,
            attention_heads=cm.attention_heads, linear_units=cm.linear_units,
            num_blocks=cm.num_blocks, input_layer=cm.input_layer)
        dims["cond_perceiver"] = PerceiverDims(
            dim=cfg.model_dim, dim_context=cm.output_size,
            num_latents=cfg.condition_num_latent, heads=cm.attention_heads,
            ff_mult=cm.perceiver_mult)
    else:   # "perceiver"
        dims["cond_perceiver"] = PerceiverDims(
            dim=cfg.model_dim, dim_context=cfg.model_dim,
            num_latents=cfg.condition_num_latent, heads=8)
    return dims


def init_unified_voice_v1(rng: InitRng, cfg: GPTConfig) -> Params:
    dims = make_dims_v1(cfg)
    D = cfg.model_dim
    p: Params = {}
    if cfg.condition_type == "conformer_perceiver":
        p["conditioning_encoder"] = init_conformer(rng, dims["cond_conformer"])
    else:
        p["conditioning_encoder"] = init_conditioning_encoder(
            rng, cfg.cond_input_dim, D, attn_blocks=6, heads=cfg.heads)
    p["perceiver_encoder"] = init_perceiver(rng, dims["cond_perceiver"])
    p.update({
        "text_embedding": nn.embedding_init(rng, cfg.text_vocab_size, D),
        "mel_embedding": nn.embedding_init(rng, cfg.number_mel_codes, D),
        "text_pos_embedding": nn.embedding_init(rng, cfg.max_text_positions, D),
        "mel_pos_embedding": nn.embedding_init(rng, cfg.max_mel_positions, D),
        "gpt": init_gpt2(rng, dims["gpt"]),
        "final_norm": nn.layer_norm_init(rng, D),
        "mel_head": nn.dense_init(rng, D, cfg.number_mel_codes),
        "text_head": nn.dense_init(rng, D, cfg.text_vocab_size),
    })
    return p


def get_conditioning_v1(params: Params, cfg: GPTConfig, cond_mel: torch.Tensor,
                        cond_lens: torch.Tensor) -> torch.Tensor:
    """(B, T, 100) prompt mel -> (B, 32, dim) latents. The conformer path
    masks past ``cond_lens``; the AttentionBlock path, as in the JAX
    package, attends over every frame."""
    dims = make_dims_v1(cfg)
    if cfg.condition_type == "conformer_perceiver":
        enc, mask = conformer_encode(params["conditioning_encoder"], dims["cond_conformer"],
                                     cond_mel, cond_lens)
        return perceiver_resample(params["perceiver_encoder"], dims["cond_perceiver"], enc,
                                  _with_latent_mask(mask, cfg.condition_num_latent))
    enc = conditioning_encoder(params["conditioning_encoder"], cond_mel, cfg.heads)
    return perceiver_resample(params["perceiver_encoder"], dims["cond_perceiver"], enc, None)


def forward_latents_v1(params: Params, cfg: GPTConfig, cond_latents: torch.Tensor,
                       text_ids: torch.Tensor, text_lens: torch.Tensor,
                       mel_codes: torch.Tensor, mel_lens: torch.Tensor,
                       dtype=torch.float32) -> torch.Tensor:
    """Teacher-forced latents for BigVGAN v1: final-norm hidden states over
    the mel span minus its last two positions, (B, T_mel, dim)."""
    return teacher_forced(params, cfg, cond_latents, text_ids, text_lens, mel_codes,
                          mel_lens, dtype)
