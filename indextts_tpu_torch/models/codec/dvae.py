"""DiscreteVAE (DVAE), the origin of the 8192-entry mel-token vocabulary
(PyTorch counterpart of `indextts_tpu/models/codec/dvae.py`).

The 1-D variant (positional_dims=1) for mel inputs: a strided conv encoder,
nearest-neighbour quantization against the EMA codebook, a transposed-conv
decoder. Activations are (B, T, C); weights in the port's layouts
(`utils/jax_params.py::to_torch` of `init_dvae`, or of `utils/convert.py::
convert_dvae`).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from indextts_tpu_torch import nn
from indextts_tpu_torch.nn import InitRng, Params
from indextts_tpu_torch.ops.mel import mel_filterbank
from indextts_tpu_torch.ops.stft import hann_window, stft_magnitude


@functools.lru_cache(maxsize=1)
def _mel_consts():
    return (mel_filterbank(22050, 1024, 80, 0.0, 8000.0, scale="htk", norm="slaney"),
            hann_window(1024))


def dvae_wav_to_mel(wav: torch.Tensor, mel_norms: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """(B, T) 22.05 kHz wav -> (B, 80, frames) power mel for tokenization:
    torchaudio's MelSpectrogram(power=2, f_max 8000, slaney norm, htk
    scale; center=True with reflect padding), log-clamped at 1e-5, divided
    by per-bin ``mel_norms`` (80,)."""
    fb, win = _mel_consts()
    y = F.pad(wav.float()[:, None], (512, 512), mode="reflect")[:, 0]
    mag = stft_magnitude(y, torch.as_tensor(win, device=y.device), 1024, 256)
    mel = torch.einsum("mf,bft->bmt", torch.as_tensor(fb, device=y.device), mag ** 2)
    mel = torch.log(torch.clamp(mel, min=1e-5))
    if mel_norms is not None:
        mel = mel / mel_norms.to(mel.device)[None, :, None]
    return mel


def init_dvae(rng: InitRng, num_tokens: int = 8192, codebook_dim: int = 512,
              num_layers: int = 2, hidden_dim: int = 512, channels: int = 80,
              stride: int = 2, kernel_size: int = 4, num_resnet_blocks: int = 3) -> Params:
    """A random DVAE in the JAX package's layouts (its `init_dvae`'s tree)."""
    enc_chans = [hidden_dim * 2 ** i for i in range(num_layers)]
    dec_chans = list(reversed(enc_chans))
    enc_io = list(zip([channels] + enc_chans, enc_chans))
    dec_init = dec_chans[0] if num_resnet_blocks > 0 else codebook_dim
    dec_io = list(zip([dec_init] + dec_chans, dec_chans))

    def res_blocks(ch):
        return [{"c1": nn.conv1d_init(rng, ch, ch, 3), "c2": nn.conv1d_init(rng, ch, ch, 3),
                 "c3": nn.conv1d_init(rng, ch, ch, 1)} for _ in range(num_resnet_blocks)]

    p: Params = {
        "enc_convs": [nn.conv1d_init(rng, i, o, kernel_size) for i, o in enc_io],
        "dec_convs": [{"kernel": rng.normal((kernel_size, i, o), std=0.02),
                       "bias": rng.zeros((o,))} for i, o in dec_io],
        "enc_res": res_blocks(enc_chans[-1]),
        "dec_res": res_blocks(dec_init),
        "enc_out": nn.conv1d_init(rng, enc_chans[-1], codebook_dim, 1),
        "dec_out": nn.conv1d_init(rng, dec_chans[-1], channels, 1),
        "codebook": {"embed": rng.normal((codebook_dim, num_tokens), std=1.0)},
    }
    if num_resnet_blocks > 0:
        p["dec_in"] = nn.conv1d_init(rng, codebook_dim, dec_init, 1)
    return p


def _res_block(bp: Params, x: torch.Tensor) -> torch.Tensor:
    """conv3-relu-conv3-relu-conv1, plus the residual."""
    h = F.relu(nn.conv1d(bp["c1"], x, padding=1))
    h = F.relu(nn.conv1d(bp["c2"], h, padding=1))
    return nn.conv1d(bp["c3"], h, padding="VALID") + x


def dvae_encode(p: Params, mel: torch.Tensor, kernel_size: int = 4,
                stride: int = 2) -> torch.Tensor:
    """(B, T, 80) normalized mel -> (B, T', codebook_dim) logits."""
    x = mel
    pad = (kernel_size - 1) // 2
    for cp in p["enc_convs"]:
        x = F.relu(nn.conv1d(cp, x, stride=stride, padding=pad))
    for bp in p["enc_res"]:
        x = _res_block(bp, x)
    return nn.conv1d(p["enc_out"], x, padding="VALID")


def dvae_codebook_indices(p: Params, mel: torch.Tensor) -> torch.Tensor:
    """(B, T, 80) -> (B, T') int32 code ids, the nearest codebook entry."""
    flat = dvae_encode(p, mel).float()
    embed = p["codebook"]["embed"].float()                      # (dim, n)
    dist = (flat.square().sum(-1, keepdim=True) - 2 * torch.matmul(flat, embed)
            + embed.square().sum(0)[None, None, :])
    return torch.argmin(dist, dim=-1).to(torch.int32)


def dvae_decode(p: Params, codes: torch.Tensor, kernel_size: int = 4,
                stride: int = 2) -> torch.Tensor:
    """(B, T') codes -> (B, T, 80) reconstructed mel."""
    x = p["codebook"]["embed"].t()[codes.long()]                # (B, T', dim)
    if "dec_in" in p:
        x = nn.conv1d(p["dec_in"], x, padding="VALID")
    for bp in p["dec_res"]:
        x = _res_block(bp, x)
    pad = (kernel_size - 1) // 2
    for cp in p["dec_convs"]:
        x = F.relu(nn.conv_transpose1d(cp, x, stride=stride, padding=pad))
    return nn.conv1d(p["dec_out"], x, padding="VALID")
