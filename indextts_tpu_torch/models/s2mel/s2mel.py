"""s2mel container (PyTorch counterpart of `indextts_tpu/models/s2mel/s2mel.py`):
CFM estimator + length regulator + the GPT-latent projection
Linear(1280 -> 256 -> 128 -> 1024)."""

from __future__ import annotations

import torch

from indextts_tpu.config import S2MelConfig
from indextts_tpu_torch import nn
from indextts_tpu_torch.models.s2mel.dit import init_dit
from indextts_tpu_torch.models.s2mel.length_regulator import init_length_regulator
from indextts_tpu_torch.nn import InitRng, Params


def init_s2mel(rng: InitRng, cfg: S2MelConfig) -> Params:
    dims = (cfg.gpt_dim,) + tuple(cfg.gpt_proj_dims)
    return {"cfm": init_dit(rng, cfg),
            "length_regulator": init_length_regulator(rng, cfg.length_regulator),
            "gpt_layer": [nn.dense_init(rng, dims[i], dims[i + 1])
                          for i in range(len(dims) - 1)]}


def gpt_layer_forward(p: Params, latent: torch.Tensor) -> torch.Tensor:
    """(B, T, 1280) GPT latents -> (B, T, 1024) codec-space features."""
    for lp in p["gpt_layer"]:
        latent = nn.dense(lp, latent)
    return latent
