"""Length regulator (PyTorch counterpart of
`indextts_tpu/models/s2mel/length_regulator.py`): continuous codec features
-> nearest-neighbour interpolation to the mel rate -> conv + GroupNorm(1) +
Mish stack -> 1x1 out conv, masked by the target lengths."""

from __future__ import annotations

import torch

from indextts_tpu.config import LengthRegulatorConfig
from indextts_tpu_torch import nn
from indextts_tpu_torch.nn import InitRng, Params


def init_length_regulator(rng: InitRng, cfg: LengthRegulatorConfig) -> Params:
    ch = cfg.channels
    p: Params = {"embedding": nn.embedding_init(rng, cfg.content_codebook_size, ch)}
    if not cfg.is_discrete:
        p["content_in_proj"] = nn.dense_init(rng, cfg.in_channels, ch)
    p["convs"] = [{"conv": nn.conv1d_init(rng, ch, ch, 3),
                   "norm": nn.group_norm_init(rng, ch)} for _ in cfg.sampling_ratios]
    p["out_conv"] = nn.conv1d_init(rng, ch, cfg.out_channels or ch, 1)
    return p


def nearest_interpolate(x: torch.Tensor, in_len: torch.Tensor, out_len: torch.Tensor,
                        out_size: int) -> torch.Tensor:
    """F.interpolate(mode='nearest') of each row's in_len valid frames onto
    its out_len target frames; (B, T_in, C) -> (B, out_size, C)."""
    i = torch.arange(out_size, device=x.device, dtype=torch.float32)[None, :]
    ratio = in_len[:, None].float() / torch.clamp(out_len[:, None].float(), min=1.0)
    src = torch.floor(i * ratio).long()
    src = torch.minimum(src, torch.clamp(in_len[:, None].long() - 1, min=0))
    src = torch.clamp(src, 0, x.shape[1] - 1)
    return torch.gather(x, 1, src[:, :, None].expand(-1, -1, x.shape[2]))


def length_regulate(p: Params, cfg: LengthRegulatorConfig, code_lens: torch.Tensor,
                    ylens: torch.Tensor, out_size: int,
                    features: torch.Tensor) -> torch.Tensor:
    """features (B, T_code, in_channels), code_lens / ylens (B,) -> (B,
    out_size, out_channels), zero past ylens. Continuous-input path only
    (the shipped config; `is_discrete` regulators are not ported)."""
    if cfg.is_discrete:
        raise NotImplementedError("discrete-code length regulator is not ported")
    x = nn.dense(p["content_in_proj"], features)
    x = nearest_interpolate(x, code_lens, ylens, out_size)
    mask = nn.sequence_mask(ylens, out_size)
    m = mask[:, :, None].to(x.dtype)
    for cp in p["convs"]:
        x = nn.conv1d(cp["conv"], x * m, padding=1)
        x = nn.mish(nn.group_norm(cp["norm"], x, groups=1, mask=mask))
    return nn.conv1d(p["out_conv"], x, padding="VALID") * m
