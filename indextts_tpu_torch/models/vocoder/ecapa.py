"""ECAPA-TDNN speaker encoder, BigVGAN v1's conditioning (PyTorch counterpart
of `indextts_tpu/models/vocoder/ecapa.py`).

Channels (512, 512, 512, 512, 1536), kernels (5, 3, 3, 3, 1), dilations
(1, 2, 3, 4, 1); three SE-Res2Net blocks (scale 8), multi-layer feature
aggregation, attentive statistics pooling with global context; BatchNorm in
eval mode (`campplus.bn_apply`); every conv with k > 1 pads 'same' by
*reflection*. Activations (B, T, C). With ``lengths`` the input, the
reflection, the SE means and the pooling all stop at each row's valid
frames, so a padded length bucket gives the exact-length result.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from indextts_tpu_torch import nn
from indextts_tpu_torch.models.s2mel.campplus import bn_apply, bn_init
from indextts_tpu_torch.nn import InitRng, Params

CHANNELS = (512, 512, 512, 512, 1536)
KERNELS = (5, 3, 3, 3, 1)
DILATIONS = (1, 2, 3, 4, 1)
RES2NET_SCALE = 8
SE_CHANNELS = 128
ATT_CHANNELS = 128


def _same_reflect_conv(p: Params, x: torch.Tensor, k: int, d: int,
                       lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """speechbrain Conv1d(padding='same', padding_mode='reflect')."""
    if k == 1:
        return nn.conv1d(p, x, padding="VALID")
    pad = (d * (k - 1)) // 2
    if lengths is None:
        xp = F.pad(x.transpose(1, 2), (pad, pad), mode="reflect").transpose(1, 2)
    else:
        xp = nn.masked_reflect_pad(x, lengths, pad, pad)
    return nn.conv1d(p, xp, padding="VALID", dilation=d)


def _tdnn_init(rng: InitRng, in_ch: int, out_ch: int, k: int) -> Params:
    return {"conv": nn.conv1d_init(rng, in_ch, out_ch, k), "bn": bn_init(rng, out_ch)}


def _tdnn(p: Params, x: torch.Tensor, k: int, d: int,
          lengths: Optional[torch.Tensor]) -> torch.Tensor:
    return bn_apply(p["bn"], F.relu(_same_reflect_conv(p["conv"], x, k, d, lengths)))


def init_ecapa(rng: InitRng, input_size: int = 100, lin_neurons: int = 512) -> Params:
    p: Params = {"block0": _tdnn_init(rng, input_size, CHANNELS[0], KERNELS[0])}
    blocks = []
    for i in range(1, len(CHANNELS) - 1):
        in_ch, out_ch = CHANNELS[i - 1], CHANNELS[i]
        scale_ch = out_ch // RES2NET_SCALE
        blocks.append({
            "tdnn1": _tdnn_init(rng, in_ch, out_ch, 1),
            "res2net": [_tdnn_init(rng, scale_ch, scale_ch, KERNELS[i])
                        for _ in range(RES2NET_SCALE - 1)],
            "tdnn2": _tdnn_init(rng, out_ch, out_ch, 1),
            "se": {"conv1": nn.conv1d_init(rng, out_ch, SE_CHANNELS, 1),
                   "conv2": nn.conv1d_init(rng, SE_CHANNELS, out_ch, 1)},
        })
    p["blocks"] = blocks
    p["mfa"] = _tdnn_init(rng, CHANNELS[-2] * (len(CHANNELS) - 2), CHANNELS[-1],
                          KERNELS[-1])
    p["asp"] = {"tdnn": _tdnn_init(rng, CHANNELS[-1] * 3, ATT_CHANNELS, 1),
                "conv": nn.conv1d_init(rng, ATT_CHANNELS, CHANNELS[-1], 1)}
    p["asp_bn"] = bn_init(rng, CHANNELS[-1] * 2)
    p["fc"] = nn.conv1d_init(rng, CHANNELS[-1] * 2, lin_neurons, 1)
    return p


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x.mean(1, keepdim=True)
    m = mask.to(x.dtype)[:, :, None]
    return (x * m).sum(1, keepdim=True) / torch.clamp(m.sum(1, keepdim=True), min=1.0)


def ecapa_forward(p: Params, x: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, T, input_size) mel -> (B, 1, lin_neurons) speaker embedding, in
    x's dtype; the attention softmax in f32."""
    mask = None
    if lengths is not None:
        mask = nn.sequence_mask(lengths, x.shape[1])
        x = torch.where(mask[:, :, None], x, torch.zeros_like(x))

    h = _tdnn(p["block0"], x, KERNELS[0], DILATIONS[0], lengths)
    feats: List[torch.Tensor] = []
    for i, bp in enumerate(p["blocks"], start=1):
        res = h
        t = _tdnn(bp["tdnn1"], h, 1, 1, lengths)
        # Res2Net: channel chunks through a cascade of TDNNs
        chunks = torch.chunk(t, RES2NET_SCALE, dim=-1)
        ys = [chunks[0]]
        for j in range(1, RES2NET_SCALE):
            inp = chunks[j] if j == 1 else chunks[j] + ys[-1]
            ys.append(_tdnn(bp["res2net"][j - 1], inp, KERNELS[i], DILATIONS[i], lengths))
        t = _tdnn(bp["tdnn2"], torch.cat(ys, dim=-1), 1, 1, lengths)
        # squeeze-excitation
        s = F.relu(nn.conv1d(bp["se"]["conv1"], _masked_mean(t, mask), padding="VALID"))
        s = torch.sigmoid(nn.conv1d(bp["se"]["conv2"], s, padding="VALID"))
        h = t * s + res
        feats.append(h)

    h = _tdnn(p["mfa"], torch.cat(feats, dim=-1), KERNELS[-1], DILATIONS[-1], lengths)

    # attentive statistics pooling with global context
    eps = 1e-12
    m = (torch.ones(h.shape[:2], dtype=h.dtype, device=h.device) if mask is None
         else mask.to(h.dtype))[:, :, None]
    total = torch.clamp(m.sum(1, keepdim=True), min=1.0)
    gmean = (h * m / total).sum(1, keepdim=True)
    gstd = torch.sqrt(torch.clamp((m / total * torch.square(h - gmean)).sum(1, keepdim=True),
                                  min=eps))
    attn_in = torch.cat([h, gmean.expand_as(h), gstd.expand_as(h)], dim=-1)
    a = _tdnn(p["asp"]["tdnn"], attn_in, 1, 1, lengths)
    a = nn.conv1d(p["asp"]["conv"], torch.tanh(a), padding="VALID")
    if mask is not None:
        a = torch.where(mask[:, :, None], a, torch.full_like(a, float("-inf")))
    w = torch.softmax(a.float(), dim=1).to(h.dtype)
    mean = (w * h).sum(1, keepdim=True)
    std = torch.sqrt(torch.clamp((w * torch.square(h - mean)).sum(1, keepdim=True), min=eps))
    pooled = bn_apply(p["asp_bn"], torch.cat([mean, std], dim=-1))   # (B, 1, 2C)
    return nn.conv1d(p["fc"], pooled, padding="VALID")               # (B, 1, lin)
