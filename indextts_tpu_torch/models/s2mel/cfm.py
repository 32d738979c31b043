"""Conditional flow matching (PyTorch counterpart of
`indextts_tpu/models/s2mel/cfm.py`): inference, an Euler ODE solve with the
CFG pair (conditional + null) stacked into one DiT batch per step, on one
device or, for the DiT tree of `parallel/mesh.py::shard_dit`, over its sp x
tp ranks; and the OT-CFM training loss."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from indextts_tpu_torch import nn
from indextts_tpu_torch.config import S2MelConfig
from indextts_tpu_torch.models.s2mel.dit import dit_forward, dit_forward_mesh
from indextts_tpu_torch.nn import Params
from indextts_tpu_torch.parallel.mesh import is_dit_sharded, seq_sharding
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
    80) f32 mel, zero over the prompt region. A DiT tree of `shard_dit`
    carries its mesh, whose sequence axis (`seq_sharding`) takes the role
    of the JAX function's ``seq_sharding``: `_cfm_mesh`."""
    B, T, _ = mu.shape
    C = s2.DiT.in_channels
    dev = mu.device
    if z is None:
        z = torch.randn((B, T, C), generator=generator, device=dev)
    z = z.to(dev).float() * temperature
    t_span = np.linspace(0.0, 1.0, n_timesteps + 1).astype(np.float32)
    if prompt_len is None:
        prompt_len = torch.zeros((B,), dtype=torch.long, device=dev)
    if is_dit_sharded(params):
        return _cfm_mesh(params, s2, mu, x_lens, prompt, style, z, t_span, inference_cfg_rate,
                         prompt_len)
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


def _cfm_mesh(params: Params, s2: S2MelConfig, mu: torch.Tensor, x_lens: torch.Tensor,
              prompt: torch.Tensor, style: torch.Tensor, z: torch.Tensor, t_span: np.ndarray,
              inference_cfg_rate: float, prompt_len: torch.Tensor) -> torch.Tensor:
    """`cfm_inference`'s Euler solve on the DiT of `shard_dit`: the frames,
    padded to a multiple of sp, cut into the mesh's `seq_sharding` blocks
    on the sp ranks' devices; every step is per frame but the DiT
    (`dit_forward_mesh`). Returns the (B, T, 80) mel on mu's device."""
    mesh = params["mesh"]
    B, T, _ = mu.shape
    cuts = seq_sharding(mesh, T) or [slice(0, T)]
    Tp = cuts[-1].stop
    offsets = [c.start for c in cuts]
    devs = [mesh.device(0, s, 0) for s in range(len(cuts))]

    def split(a):
        a = torch.nn.functional.pad(a, (0, 0, 0, Tp - T)) if Tp > T else a
        return [a[:, c].to(d) for c, d in zip(cuts, devs)]

    region = [nn.sequence_mask(prompt_len, Tp)[:, c, None].to(d) for c, d in zip(cuts, devs)]
    zs, mus, prompts = split(z), split(mu), split(prompt)
    xs = [torch.where(r, torch.zeros_like(a), a) for r, a in zip(region, zs)]
    prompt_x = [torch.where(r, a, torch.zeros_like(a)) for r, a in zip(region, prompts)]
    freqs = torch.as_tensor(precompute_freqs_cis(Tp, s2.DiT.head_dim, s2.DiT.rope_base),
                            device=mu.device)
    cfg_on = inference_cfg_rate > 0
    if cfg_on:
        mus = [torch.cat([m, torch.zeros_like(m)]) for m in mus]
        prompt_in = [torch.cat([a, torch.zeros_like(a)]) for a in prompt_x]
        style_in, lens_in = torch.cat([style, torch.zeros_like(style)]), torch.cat([x_lens,
                                                                                   x_lens])
    else:
        prompt_in, style_in, lens_in = prompt_x, style, x_lens
    for i in range(len(t_span) - 1):
        t0 = float(t_span[i])
        dt = float(np.float32(t_span[i + 1] - t_span[i]))
        x_in = [torch.cat([x, x]) for x in xs] if cfg_on else xs
        vs = dit_forward_mesh(params, s2, x_in, prompt_in, lens_in,
                              torch.full((x_in[0].shape[0],), t0, device=mu.device), style_in,
                              mus, freqs, offsets, Tp)
        if cfg_on:
            vs = [(1.0 + inference_cfg_rate) * vc - inference_cfg_rate * vn
                  for vc, vn in (torch.chunk(v, 2) for v in vs)]
        xs = [torch.where(r, torch.zeros_like(x), x + dt * v) for r, x, v in zip(region, xs, vs)]
    return torch.cat([x.to(mu.device) for x in xs], dim=1)[:, :T]


def cfm_noise(x1: torch.Tensor, generator: torch.Generator):
    """The loss's draws for a target x1 (B, T, C): t ~ U(0, 1) of shape (B,
    1, 1) and z ~ N(0, 1) of x1's shape, f32 from ``generator`` on its
    device, moved to x1's (host draws make a step the same on every
    device)."""
    t = torch.rand((x1.shape[0], 1, 1), generator=generator, device=generator.device)
    z = torch.randn(tuple(x1.shape), generator=generator, device=generator.device)
    return t.to(x1.device), z.to(x1.device)


def cfm_loss_sums(params: Params, s2: S2MelConfig, x1: torch.Tensor, x_lens: torch.Tensor,
                  prompt_lens: torch.Tensor, mu: torch.Tensor, style: torch.Tensor,
                  t: torch.Tensor, z: torch.Tensor):
    """`cfm_loss`'s numerator and denominator: (the summed error over the
    valid frames, f32; their count times the channels, before the clamp at
    1). A dp rank sums its rows' error over the whole batch's count."""
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
    return err.float().sum(), valid.sum().float() * C


def cfm_loss(params: Params, s2: S2MelConfig, x1: torch.Tensor, x_lens: torch.Tensor,
             prompt_lens: torch.Tensor, mu: torch.Tensor, style: torch.Tensor,
             t: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """OT-CFM training loss at the draws (t, z) of `cfm_noise`: x1 (B, T, 80)
    target mel, x_lens (B,) valid frames, prompt_lens (B,) the prompt region
    (its target goes in as the prompt, its y is zeroed, and it is left out of
    the loss), mu (B, T, content_dim), style (B, 192). The L1 (or, for
    ``reg_loss_type == "l2"``, squared) error over [prompt_len, x_len),
    averaged over the batch's valid frames and channels. The DiT runs its
    dense attention tier, the one with a backward."""
    total, count = cfm_loss_sums(params, s2, x1, x_lens, prompt_lens, mu, style, t, z)
    return total / torch.clamp(count, min=1.0)
