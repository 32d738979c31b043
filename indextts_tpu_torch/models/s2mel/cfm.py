"""Conditional flow matching (PyTorch counterpart of
`indextts_tpu/models/s2mel/cfm.py`): inference, an Euler ODE solve with the
CFG pair (conditional + null) stacked into one DiT batch per step; and the
OT-CFM training loss."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from indextts_tpu_torch import nn
from indextts_tpu_torch.config import S2MelConfig
from indextts_tpu_torch.models.s2mel.dit import dit_forward
from indextts_tpu_torch.nn import Params
from indextts_tpu_torch.ops.rope import precompute_freqs_cis


@torch.no_grad()
def cfm_inference(params: Params, s2: S2MelConfig, mu: torch.Tensor,
                  x_lens: torch.Tensor, prompt: torch.Tensor, style: torch.Tensor,
                  n_timesteps: int = 25, temperature: float = 1.0,
                  inference_cfg_rate: float = 0.7,
                  prompt_len: Optional[torch.Tensor] = None,
                  z: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """mu (B, T, content_dim) regulated semantic features, prompt (B, T, 80)
    reference mel at [0, prompt_len), style (B, 192). The initial noise is
    ``z`` (B, T, 80) when given, else a standard normal draw from
    ``generator``; either is scaled by ``temperature``. Returns the (B, T,
    80) f32 mel, zero over the prompt region."""
    B, T, _ = mu.shape
    C = s2.DiT.in_channels
    dev = mu.device
    if z is None:
        z = torch.randn((B, T, C), generator=generator, device=dev)
    z = z.to(dev).float() * temperature
    t_span = np.linspace(0.0, 1.0, n_timesteps + 1).astype(np.float32)
    if prompt_len is None:
        prompt_len = torch.zeros((B,), dtype=torch.long, device=dev)
    prompt_region = nn.sequence_mask(prompt_len, T)[:, :, None]
    x = torch.where(prompt_region, torch.zeros_like(z), z)
    prompt_x = torch.where(prompt_region, prompt, torch.zeros_like(prompt))
    freqs = torch.as_tensor(precompute_freqs_cis(T, s2.DiT.head_dim, s2.DiT.rope_base),
                            device=dev)
    mu2 = torch.cat([mu, torch.zeros_like(mu)])
    prompt2 = torch.cat([prompt_x, torch.zeros_like(prompt_x)])
    style2 = torch.cat([style, torch.zeros_like(style)])
    lens2 = torch.cat([x_lens, x_lens])
    for i in range(n_timesteps):
        t0 = float(t_span[i])
        dt = np.float32(t_span[i + 1] - t_span[i])
        if inference_cfg_rate > 0:
            v2 = dit_forward(params, s2, torch.cat([x, x]), prompt2, lens2,
                             torch.full((2 * B,), t0, device=dev), style2, mu2, freqs)
            v_cond, v_null = torch.chunk(v2, 2)
            v = (1.0 + inference_cfg_rate) * v_cond - inference_cfg_rate * v_null
        else:
            v = dit_forward(params, s2, x, prompt_x, x_lens,
                            torch.full((B,), t0, device=dev), style, mu, freqs)
        x = torch.where(prompt_region, torch.zeros_like(x), x + float(dt) * v)
    return x


def cfm_noise(x1: torch.Tensor, generator: torch.Generator):
    """The loss's draws for a target x1 (B, T, C): t ~ U(0, 1) of shape (B,
    1, 1) and z ~ N(0, 1) of x1's shape, f32 from ``generator`` on its
    device, moved to x1's (host draws make a step the same on every
    device)."""
    t = torch.rand((x1.shape[0], 1, 1), generator=generator, device=generator.device)
    z = torch.randn(tuple(x1.shape), generator=generator, device=generator.device)
    return t.to(x1.device), z.to(x1.device)


def cfm_loss(params: Params, s2: S2MelConfig, x1: torch.Tensor, x_lens: torch.Tensor,
             prompt_lens: torch.Tensor, mu: torch.Tensor, style: torch.Tensor,
             t: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """OT-CFM training loss at the draws (t, z) of `cfm_noise`: x1 (B, T, 80)
    target mel, x_lens (B,) valid frames, prompt_lens (B,) the prompt region
    (its target goes in as the prompt, its y is zeroed, and it is left out of
    the loss), mu (B, T, content_dim), style (B, 192). The L1 (or, for
    ``reg_loss_type == "l2"``, squared) error over [prompt_len, x_len),
    averaged. The DiT runs its dense attention tier, the one with a
    backward."""
    B, T, C = x1.shape
    sigma_min = 1e-6
    y = (1 - (1 - sigma_min) * t) * z + t * x1
    u = x1 - (1 - sigma_min) * z
    prompt_region = nn.sequence_mask(prompt_lens, T)[:, :, None]
    prompt = torch.where(prompt_region, x1, torch.zeros_like(x1))
    y = torch.where(prompt_region, torch.zeros_like(y), y)
    freqs = torch.as_tensor(precompute_freqs_cis(T, s2.DiT.head_dim, s2.DiT.rope_base),
                            device=x1.device)
    v = dit_forward(params, s2, y, prompt, x_lens, t[:, 0, 0], style, mu, freqs, tier="dense")
    valid = nn.sequence_mask(x_lens, T)[:, :, None] & ~prompt_region
    err = (v - u).square() if s2.reg_loss_type == "l2" else (v - u).abs()
    err = torch.where(valid, err, torch.zeros_like(err))
    denom = torch.clamp(valid.sum().float() * C, min=1.0)
    return err.float().sum() / denom
