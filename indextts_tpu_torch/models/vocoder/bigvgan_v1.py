"""BigVGAN v1, IndexTTS-1's vocoder (PyTorch counterpart of
`indextts_tpu/models/vocoder/bigvgan_v1.py`).

BigVGAN-v2's core (`bigvgan.py`: its AMPBlock1 and masking, so every
anti-aliased activation is kernel K3) driven by the GPT latents instead of
a mel:
- the latent (B, T, gpt_dim), linearly upsampled x4 when ``feat_upsample``;
- an ECAPA-TDNN speaker embedding of the prompt mel (`ecapa.py`), added
  through 1x1 convs at the input (``cond_layer``) and, with
  ``cond_d_vector_in_each_upsampling_layer``, after every upsampling
  (``conds``);
- tanh at the output.
"""

from __future__ import annotations

from typing import Optional

import torch

from indextts_tpu_torch import nn
from indextts_tpu_torch.config import BigVGANV1Config
from indextts_tpu_torch.models.vocoder.bigvgan import _act, _amp_block, _mask
from indextts_tpu_torch.models.vocoder.ecapa import ecapa_forward, init_ecapa
from indextts_tpu_torch.nn import InitRng, Params


def init_bigvgan_v1(rng: InitRng, h: BigVGANV1Config) -> Params:
    ch0 = h.upsample_initial_channel
    p: Params = {"conv_pre": nn.conv1d_init(rng, h.gpt_dim, ch0, 7)}
    ups, resblocks, conds = [], [], []
    for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
        cin, cout = ch0 // (2 ** i), ch0 // (2 ** (i + 1))
        ups.append({"kernel": rng.normal((k, cin, cout), std=0.01),
                    "bias": rng.zeros((cout,))})
        if h.cond_d_vector_in_each_upsampling_layer:
            conds.append(nn.conv1d_init(rng, h.speaker_embedding_dim, cout, 1))
        for ks, dils in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes):
            convs1 = [nn.conv1d_init(rng, cout, cout, ks) for _ in dils]
            convs2 = [nn.conv1d_init(rng, cout, cout, ks) for _ in dils]
            acts = []
            for _ in range(2 * len(dils)):
                a = {"alpha": rng.zeros((cout,))}
                if h.activation == "snakebeta":
                    a["beta"] = rng.zeros((cout,))
                acts.append(a)
            resblocks.append({"convs1": convs1, "convs2": convs2, "acts": acts})
    p["ups"], p["resblocks"] = ups, resblocks
    if conds:
        p["conds"] = conds
    ch_last = ch0 // (2 ** len(h.upsample_rates))
    p["activation_post"] = {"alpha": rng.zeros((ch_last,))}
    if h.activation == "snakebeta":
        p["activation_post"]["beta"] = rng.zeros((ch_last,))
    p["conv_post"] = nn.conv1d_init(rng, ch_last, 1, 7)
    p["speaker_encoder"] = init_ecapa(rng, h.num_mels, h.speaker_embedding_dim)
    p["cond_layer"] = nn.conv1d_init(rng, h.speaker_embedding_dim, ch0, 1)
    return p


def _linear_upsample4(x: torch.Tensor) -> torch.Tensor:
    """torch F.interpolate(scale_factor=4, mode='linear', align_corners=False)
    over (B, T, C) -> (B, 4T, C), with the JAX package's index clipping and
    its arithmetic in x's dtype (a contiguous result)."""
    T = x.shape[1]
    src = (torch.arange(4 * T, dtype=torch.float32, device=x.device) + 0.5) / 4.0 - 0.5
    lo = torch.clamp(torch.floor(src).long(), 0, T - 1)
    hi = torch.clamp(lo + 1, 0, T - 1)
    w = torch.clamp(src - lo.float(), 0.0, 1.0)[None, :, None].to(x.dtype)
    return x.index_select(1, lo) * (1 - w) + x.index_select(1, hi) * w


@torch.no_grad()
def bigvgan_v1_forward(p: Params, h: BigVGANV1Config, latent: torch.Tensor,
                       mel_ref: torch.Tensor, latent_lens: Optional[torch.Tensor] = None,
                       mel_ref_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """latent (B, T, gpt_dim) GPT latents; mel_ref (B, S, num_mels) prompt
    mel. Returns the wav (B, T * h.total_upsample) in [-1, 1], zero past
    latent_lens * h.total_upsample."""
    spk = ecapa_forward(p["speaker_encoder"], mel_ref, mel_ref_lens)     # (B, 1, 512)
    lens = latent_lens
    if h.feat_upsample:
        latent = _linear_upsample4(latent)
        lens = None if lens is None else lens * 4
    x = nn.conv1d(p["conv_pre"], _mask(latent, lens), padding=3)
    x = x + nn.conv1d(p["cond_layer"], spk, padding="VALID")
    n_k = len(h.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
        x = nn.conv_transpose1d(p["ups"][i], _mask(x, lens), stride=u, padding=(k - u) // 2)
        lens = None if lens is None else lens * u
        if "conds" in p:
            x = x + nn.conv1d(p["conds"][i], spk, padding="VALID")
        x = _mask(x, lens)
        xs = None
        for j, (ks, dils) in enumerate(zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes)):
            r = _amp_block(p["resblocks"][i * n_k + j], x, ks, dils, lens, h.snake_logscale)
            xs = r if xs is None else xs + r
        x = xs / n_k
    x = _mask(_act(p["activation_post"], x, lens, h.snake_logscale), lens)
    x = torch.tanh(nn.conv1d(p["conv_post"], x, padding=3))
    return _mask(x, lens)[..., 0]
