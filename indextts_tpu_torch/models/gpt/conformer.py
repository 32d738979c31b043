"""Wenet-style conformer conditioning encoder (PyTorch counterpart of
`indextts_tpu/models/gpt/conformer.py`): Conv2dSubsampling2 / 4 / 6 / 8
(``conv2d2``, ``conv2d``, ``conv2d6``, ``conv2d8``) or a linear input layer
-> rel-pos MHA (u/v biases, no rel_shift) -> conv module -> FFN, pre-norm,
final norm per block, encoder after_norm."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from indextts_tpu_torch import nn
from indextts_tpu_torch.nn import InitRng, Params


@dataclass(frozen=True)
class ConformerDims:
    input_size: int = 1024
    output_size: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    input_layer: str = "conv2d2"
    cnn_module_kernel: int = 15

    @property
    def head_dim(self) -> int:
        return self.output_size // self.attention_heads


def sinusoidal_pos_table(max_len: int, d_model: int) -> np.ndarray:
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


# the conv subsampling input layers: name -> the (kernel, stride) of each
# conv after the first (3x3, stride 2), and the mask's slices after the first
# ([2::2]); the reference's subsampling.py strides
SUBSAMPLING = {"conv2d2": ((), ()),
               "conv2d": (((3, 2),), ((2, 2),)),
               "conv2d6": (((5, 3),), ((4, 3),)),
               "conv2d8": (((3, 2), (3, 2)), ((2, 2), (2, 2)))}


def init_conformer(rng: InitRng, d: ConformerDims) -> Params:
    D, H = d.output_size, d.attention_heads
    if d.input_layer == "linear":
        p: Params = {"embed": {"linear": nn.dense_init(rng, d.input_size, D),
                               "norm": nn.layer_norm_init(rng, D)}}
    elif d.input_layer in SUBSAMPLING:
        embed = {"conv": nn.conv2d_init(rng, 1, D, 3, 3)}
        f_out = (d.input_size - 1) // 2
        for i, (k, stride) in enumerate(SUBSAMPLING[d.input_layer][0]):
            embed[f"conv{i + 2}"] = nn.conv2d_init(rng, D, D, k, k)
            f_out = (f_out - k) // stride + 1
        embed["out"] = nn.dense_init(rng, D * f_out, D)
        p = {"embed": embed}
    else:
        raise ValueError(f"unsupported conformer input_layer {d.input_layer!r}")
    p["encoders"] = [{
        "norm_mha": nn.layer_norm_init(rng, D),
        "attn": {
            "linear_q": nn.dense_init(rng, D, D),
            "linear_k": nn.dense_init(rng, D, D),
            "linear_v": nn.dense_init(rng, D, D),
            "linear_out": nn.dense_init(rng, D, D),
            "linear_pos": nn.dense_init(rng, D, D, bias=False),
            "pos_bias_u": rng.xavier_uniform((H, d.head_dim)),
            "pos_bias_v": rng.xavier_uniform((H, d.head_dim)),
        },
        "norm_conv": nn.layer_norm_init(rng, D),
        "conv": {
            "pointwise_conv1": nn.conv1d_init(rng, D, 2 * D, 1),
            "depthwise_conv": nn.conv1d_init(rng, D, D, d.cnn_module_kernel, groups=D),
            "norm": nn.layer_norm_init(rng, D),
            "pointwise_conv2": nn.conv1d_init(rng, D, D, 1),
        },
        "norm_ff": nn.layer_norm_init(rng, D),
        "ff": {"w_1": nn.dense_init(rng, D, d.linear_units),
               "w_2": nn.dense_init(rng, d.linear_units, D)},
        "norm_final": nn.layer_norm_init(rng, D),
    } for _ in range(d.num_blocks)]
    p["after_norm"] = nn.layer_norm_init(rng, D)
    return p


def _rel_pos_mha(ap: Params, x: torch.Tensor, pos_emb: torch.Tensor,
                 mask: Optional[torch.Tensor], d: ConformerDims) -> torch.Tensor:
    B, T, D = x.shape
    H, Dh = d.attention_heads, d.head_dim
    q = nn.dense(ap["linear_q"], x).reshape(B, T, H, Dh)
    k = nn.dense(ap["linear_k"], x).reshape(B, T, H, Dh).transpose(1, 2)
    v = nn.dense(ap["linear_v"], x).reshape(B, T, H, Dh).transpose(1, 2)
    pm = nn.dense(ap["linear_pos"], pos_emb.to(x.dtype)).reshape(1, -1, H, Dh).transpose(1, 2)
    q_u = (q + ap["pos_bias_u"].to(x.dtype)[None, None]).transpose(1, 2)
    q_v = (q + ap["pos_bias_v"].to(x.dtype)[None, None]).transpose(1, 2)
    ac = torch.matmul(q_u.float(), k.float().transpose(-1, -2))
    bd = torch.matmul(q_v.float(), pm.float().transpose(-1, -2))
    scores = (ac + bd) / math.sqrt(Dh)
    if mask is not None:
        keep = mask[:, None, None, :]
        probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
        probs = probs.masked_fill(~keep, 0.0)
    else:
        probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(x.dtype)
    return nn.dense(ap["linear_out"], out.transpose(1, 2).reshape(B, T, D))


def _conv_module(cp: Params, x: torch.Tensor, mask: Optional[torch.Tensor],
                 d: ConformerDims) -> torch.Tensor:
    m = None if mask is None else mask[:, :, None].to(x.dtype)
    if m is not None:
        x = x * m
    h = nn.glu(nn.conv1d(cp["pointwise_conv1"], x, padding="VALID"))
    h = nn.conv1d(cp["depthwise_conv"], h, padding=(d.cnn_module_kernel - 1) // 2,
                  groups=h.shape[-1])
    h = nn.conv1d(cp["pointwise_conv2"], F.silu(nn.layer_norm(cp["norm"], h)), padding="VALID")
    return h * m if m is not None else h


def conformer_encode(p: Params, d: ConformerDims, xs: torch.Tensor,
                     xs_lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs (B, T, input_size), xs_lens (B,) -> (out (B, T', D), mask (B, T'));
    T' = (T - 1) // 2 for conv2d2 (the mask strided as [2::2]), and each
    further conv of conv2d / conv2d6 / conv2d8 subsamples again (the mask
    sliced as `SUBSAMPLING` says)."""
    B, T, _ = xs.shape
    D = d.output_size
    mask = nn.sequence_mask(xs_lens, T)
    if d.input_layer == "linear":
        x = nn.layer_norm(p["embed"]["norm"], nn.dense(p["embed"]["linear"], xs))
    else:
        h = F.relu(nn.conv2d(p["embed"]["conv"], xs[:, None], stride=(2, 2)))  # (B, D, T', F')
        mask = mask[:, 2::2]
        convs, slices = SUBSAMPLING[d.input_layer]
        for i, ((_, stride), (start, step)) in enumerate(zip(convs, slices)):
            h = F.relu(nn.conv2d(p["embed"][f"conv{i + 2}"], h, stride=(stride, stride)))
            mask = mask[:, start::step]
        Tp, Fp = h.shape[2], h.shape[3]
        x = nn.dense(p["embed"]["out"], h.permute(0, 2, 1, 3).reshape(B, Tp, D * Fp))
        mask = mask[:, : x.shape[1]]
    Tp = x.shape[1]
    pos_emb = torch.as_tensor(sinusoidal_pos_table(Tp, D), device=x.device)[None]
    x = x * math.sqrt(D)
    for bp in p["encoders"]:
        x = x + _rel_pos_mha(bp["attn"], nn.layer_norm(bp["norm_mha"], x), pos_emb, mask, d)
        x = x + _conv_module(bp["conv"], nn.layer_norm(bp["norm_conv"], x), mask, d)
        h = nn.layer_norm(bp["norm_ff"], x)
        x = x + nn.dense(bp["ff"]["w_2"], F.silu(nn.dense(bp["ff"]["w_1"], h)))
        x = nn.layer_norm(bp["norm_final"], x)
    return nn.layer_norm(p["after_norm"], x), mask
