"""CAMPPlus D-TDNN speaker embedder (PyTorch counterpart of
`indextts_tpu/models/s2mel/campplus.py`): 80-bin mean-normalized Kaldi fbank
-> 192-d style vector. Runs in f32, as on the TPU. BatchNorm is eval-mode
(running statistics)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from indextts_tpu_torch import nn
from indextts_tpu_torch.nn import InitRng, Params


def bn_init(rng: InitRng, ch: int, affine: bool = True) -> Params:
    p = {"running_mean": rng.zeros((ch,)), "running_var": rng.ones((ch,))}
    if affine:
        p["weight"] = rng.ones((ch,))
        p["bias"] = rng.zeros((ch,))
    return p


def bn_apply(p: Params, x: torch.Tensor, channel_dim: int = -1,
             eps: float = 1e-5) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[channel_dim] = -1

    def v(t):
        return t.float().reshape(shape)

    y = (x.float() - v(p["running_mean"])) * torch.rsqrt(v(p["running_var"]) + eps)
    if "weight" in p:
        y = y * v(p["weight"]) + v(p["bias"])
    return y.to(x.dtype)


def _res_block_init(rng: InitRng, in_planes: int, planes: int, stride: int) -> Params:
    p = {"conv1": nn.conv2d_init(rng, in_planes, planes, 3, 3, bias=False),
         "bn1": bn_init(rng, planes),
         "conv2": nn.conv2d_init(rng, planes, planes, 3, 3, bias=False),
         "bn2": bn_init(rng, planes)}
    if stride != 1 or in_planes != planes:
        p["shortcut_conv"] = nn.conv2d_init(rng, in_planes, planes, 1, 1, bias=False)
        p["shortcut_bn"] = bn_init(rng, planes)
    return p


def _res_block(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """x: (B, C, F, T)."""
    h = F.relu(bn_apply(p["bn1"], nn.conv2d(p["conv1"], x, (stride, 1), (1, 1)), 1))
    h = bn_apply(p["bn2"], nn.conv2d(p["conv2"], h, (1, 1), (1, 1)), 1)
    sc = x
    if "shortcut_conv" in p:
        sc = bn_apply(p["shortcut_bn"], nn.conv2d(p["shortcut_conv"], x, (stride, 1)), 1)
    return F.relu(h + sc)


def init_campplus(rng: InitRng, feat_dim: int = 80, embedding_size: int = 192,
                  growth_rate: int = 32, bn_size: int = 4,
                  init_channels: int = 128) -> Params:
    m = 32
    p: Params = {"fcm": {
        "conv1": nn.conv2d_init(rng, 1, m, 3, 3, bias=False),
        "bn1": bn_init(rng, m),
        "layer1": [_res_block_init(rng, m, m, 2), _res_block_init(rng, m, m, 1)],
        "layer2": [_res_block_init(rng, m, m, 2), _res_block_init(rng, m, m, 1)],
        "conv2": nn.conv2d_init(rng, m, m, 3, 3, bias=False),
        "bn2": bn_init(rng, m),
    }}
    channels = m * (feat_dim // 8)
    p["tdnn"] = {"conv": nn.conv1d_init(rng, channels, init_channels, 5, bias=False),
                 "bn": bn_init(rng, init_channels)}
    channels = init_channels
    blocks = []
    for num_layers, ksz in zip((12, 24, 16), (3, 3, 3)):
        layers = []
        for i in range(num_layers):
            in_ch = channels + i * growth_rate
            bn_ch = bn_size * growth_rate
            layers.append({
                "bn1": bn_init(rng, in_ch),
                "linear1": nn.conv1d_init(rng, in_ch, bn_ch, 1, bias=False),
                "bn2": bn_init(rng, bn_ch),
                "cam": {
                    "linear_local": nn.conv1d_init(rng, bn_ch, growth_rate, ksz, bias=False),
                    "linear1": nn.conv1d_init(rng, bn_ch, bn_ch // 2, 1),
                    "linear2": nn.conv1d_init(rng, bn_ch // 2, growth_rate, 1),
                },
            })
        channels += num_layers * growth_rate
        transit = {"bn": bn_init(rng, channels),
                   "linear": nn.conv1d_init(rng, channels, channels // 2, 1, bias=False)}
        channels //= 2
        blocks.append({"layers": layers, "transit": transit})
    p["blocks"] = blocks
    p["out_bn"] = bn_init(rng, channels)
    p["dense"] = {"linear": nn.conv1d_init(rng, channels * 2, embedding_size, 1, bias=False),
                  "bn": bn_init(rng, embedding_size, affine=False)}
    return p


def _cam_layer(cp: Params, x: torch.Tensor, ksz: int, dil: int,
               n_frames: Optional[torch.Tensor]) -> torch.Tensor:
    """Context-aware masking layer on (B, T, C)."""
    y = nn.conv1d(cp["linear_local"], x, padding=(ksz - 1) // 2 * dil, dilation=dil)
    if n_frames is None:
        gmean = x.mean(1, keepdim=True)
    else:
        m = nn.sequence_mask(n_frames, x.shape[1]).to(x.dtype)[:, :, None]
        gmean = (x * m).sum(1, keepdim=True) / torch.clamp(m.sum(1, keepdim=True), min=1.0)
    seg_len, T = 100, x.shape[1]
    n_seg = -(-T // seg_len)
    xp = F.pad(x, (0, 0, 0, n_seg * seg_len - T))
    seg_sum = xp.reshape(x.shape[0], n_seg, seg_len, -1).sum(2)
    # avg_pool1d(ceil_mode=True) divides the clipped tail window by its size
    seg_cnt = torch.clamp(T - torch.arange(n_seg, device=x.device) * seg_len,
                          max=seg_len).to(x.dtype)
    seg = (seg_sum / seg_cnt[None, :, None]).repeat_interleave(seg_len, dim=1)[:, :T]
    h = F.relu(nn.conv1d(cp["linear1"], gmean + seg, padding="VALID"))
    return y * torch.sigmoid(nn.conv1d(cp["linear2"], h, padding="VALID"))


def campplus_forward(p: Params, feats: torch.Tensor,
                     n_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """feats (B, T, 80) mean-normalized Kaldi fbank -> (B, 192)."""
    f = p["fcm"]
    x = feats.transpose(1, 2)[:, None]                   # (B, 1, F, T)
    h = F.relu(bn_apply(f["bn1"], nn.conv2d(f["conv1"], x, padding=(1, 1)), 1))
    for i, bp in enumerate(f["layer1"]):
        h = _res_block(bp, h, 2 if i == 0 else 1)
    for i, bp in enumerate(f["layer2"]):
        h = _res_block(bp, h, 2 if i == 0 else 1)
    h = F.relu(bn_apply(f["bn2"], nn.conv2d(f["conv2"], h, (2, 1), (1, 1)), 1))
    B, C, F8, T = h.shape
    x = h.permute(0, 3, 1, 2).reshape(B, T, C * F8)     # torch stacks (C, F) per time
    x = F.relu(bn_apply(p["tdnn"]["bn"], nn.conv1d(p["tdnn"]["conv"], x, stride=2, padding=2)))
    if n_frames is not None:
        n_frames = (n_frames + 2 * 2 - 5) // 2 + 1
    for blk, (ksz, dil) in zip(p["blocks"], ((3, 1), (3, 2), (3, 2))):
        for lp in blk["layers"]:
            h = F.relu(bn_apply(lp["bn1"], x))
            h = F.relu(bn_apply(lp["bn2"], nn.conv1d(lp["linear1"], h, padding="VALID")))
            x = torch.cat([x, _cam_layer(lp["cam"], h, ksz, dil, n_frames)], dim=-1)
        x = F.relu(bn_apply(blk["transit"]["bn"], x))
        x = nn.conv1d(blk["transit"]["linear"], x, padding="VALID")
    x = F.relu(bn_apply(p["out_bn"], x))
    if n_frames is None:
        mean = x.mean(1)
        var = (x - mean[:, None]).square().sum(1) / max(x.shape[1] - 1, 1)
    else:
        m = nn.sequence_mask(n_frames, x.shape[1]).float()[:, :, None]
        cnt = torch.clamp(m.sum(1), min=1.0)
        mean = (x * m).sum(1) / cnt
        var = ((x - mean[:, None]).square() * m).sum(1) / torch.clamp(cnt - 1.0, min=1.0)
    stats = torch.cat([mean, torch.sqrt(var)], dim=-1)[:, None, :]
    out = bn_apply(p["dense"]["bn"], nn.conv1d(p["dense"]["linear"], stats, padding="VALID"))
    return out[:, 0]
