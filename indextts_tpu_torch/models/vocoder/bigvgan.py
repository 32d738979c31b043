"""BigVGAN-v2 vocoder (PyTorch counterpart of `indextts_tpu/models/vocoder/bigvgan.py`).

conv_pre -> per stage: ConvTranspose1d upsample -> mean of AMPBlock1
resblocks (anti-aliased SnakeBeta between dilated convs) -> final
anti-aliased SnakeBeta -> conv_post -> clamp. Every anti-aliased activation
is kernel K3 (`ops/snake.py::antialias_snake`); the resblock convs are plain
library convolutions. All ops mask by each row's valid length.
"""

from __future__ import annotations

from typing import Optional

import torch

from indextts_tpu.config import BigVGANConfig
from indextts_tpu_torch import nn
from indextts_tpu_torch.nn import InitRng, Params
from indextts_tpu_torch.ops.snake import antialias_snake


def init_bigvgan(rng: InitRng, h: BigVGANConfig) -> Params:
    ch0 = h.upsample_initial_channel
    p: Params = {"conv_pre": nn.conv1d_init(rng, h.num_mels, ch0, 7)}
    ups, resblocks = [], []
    for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
        cin, cout = ch0 // (2 ** i), ch0 // (2 ** (i + 1))
        ups.append({"kernel": rng.normal((k, cin, cout), std=0.01),
                    "bias": rng.zeros((cout,))})
        for ks, dils in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes):
            acts = []
            for _ in range(2 * len(dils)):
                a = {"alpha": rng.zeros((cout,))}
                if h.activation == "snakebeta":
                    a["beta"] = rng.zeros((cout,))
                acts.append(a)
            resblocks.append({"convs1": [nn.conv1d_init(rng, cout, cout, ks) for _ in dils],
                              "convs2": [nn.conv1d_init(rng, cout, cout, ks) for _ in dils],
                              "acts": acts})
    p["ups"], p["resblocks"] = ups, resblocks
    ch_last = ch0 // (2 ** len(h.upsample_rates))
    p["activation_post"] = {"alpha": rng.zeros((ch_last,))}
    if h.activation == "snakebeta":
        p["activation_post"]["beta"] = rng.zeros((ch_last,))
    p["conv_post"] = nn.conv1d_init(rng, ch_last, 1, 7, bias=h.use_bias_at_final)
    return p


def activation1d_calls(h: BigVGANConfig) -> int:
    """Anti-aliased activations one `bigvgan_forward` runs (K3 launches)."""
    per_stage = sum(2 * len(d) for d in h.resblock_dilation_sizes)
    return len(h.upsample_rates) * per_stage + 1


def _mask(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    if lengths is None:
        return x
    return x * nn.sequence_mask(lengths, x.shape[1])[:, :, None].to(x.dtype)


def _act(a: Params, x: torch.Tensor, lengths) -> torch.Tensor:
    return antialias_snake(x.contiguous(), a["alpha"], a.get("beta"), lengths)


def _amp_block(bp: Params, x: torch.Tensor, ks: int, dils, lengths) -> torch.Tensor:
    """AMPBlock1."""
    for j, d in enumerate(dils):
        xt = _mask(_act(bp["acts"][2 * j], x, lengths), lengths)
        xt = _mask(nn.conv1d(bp["convs1"][j], xt, padding=(ks * d - d) // 2, dilation=d),
                   lengths)
        xt = _mask(_act(bp["acts"][2 * j + 1], xt, lengths), lengths)
        xt = nn.conv1d(bp["convs2"][j], xt, padding=(ks - 1) // 2)
        x = _mask(x + xt, lengths)
    return x


@torch.no_grad()
def bigvgan_forward(p: Params, h: BigVGANConfig, mel: torch.Tensor,
                    mel_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mel (B, T, num_mels) -> wav (B, T * prod(rates)) in [-1, 1], zero past
    mel_lens * prod(rates)."""
    if not h.snake_logscale:
        raise NotImplementedError("linear-scale snake parameters are not ported "
                                  "(BigVGAN-v2 stores them in log scale)")
    x = nn.conv1d(p["conv_pre"], _mask(mel, mel_lens), padding=3)
    lens = mel_lens
    n_k = len(h.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
        x = nn.conv_transpose1d(p["ups"][i], _mask(x, lens), stride=u, padding=(k - u) // 2)
        lens = None if lens is None else lens * u
        x = _mask(x, lens)
        xs = None
        for j, (ks, dils) in enumerate(zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes)):
            r = _amp_block(p["resblocks"][i * n_k + j], x, ks, dils, lens)
            xs = r if xs is None else xs + r
        x = xs / n_k
    x = _mask(_act(p["activation_post"], x, lens), lens)
    x = nn.conv1d(p["conv_post"], x, padding=3)
    x = torch.tanh(x) if h.use_tanh_at_final else torch.clamp(x, -1.0, 1.0)
    return _mask(x, lens)[..., 0]
