"""PyTorch counterpart of `indextts_tpu/nn.py`: initializers and layer functions.

Parameters are nested dicts of tensors, as in the JAX package. The `*_init`
functions below build trees in the JAX package's layouts (dense kernels
``(in, out)``, conv kernels ``(W, in/groups, out)``), drawn on the target
device from a `torch.Generator`; `utils/jax_params.py` then turns any such
tree (numpy leaves from the JAX package, or these tensors) into the torch
layouts the layer functions here consume (Linear ``(out, in)``, Conv1d
``(out, in/groups, W)``). All transposes live in that one module.

Activations are ``(B, T, C)`` everywhere, as in the JAX package; convolutions
transpose to torch's ``(B, C, T)`` around the library call.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from indextts_tpu_torch.ops.attn import single_block_attention

Params = Dict[str, object]


class InitRng:
    """Seeded parameter initializer with the method set of the JAX package's
    `nn.InitRng`, drawing float32 tensors on ``device`` from a
    `torch.Generator`: building a ~1 B-parameter tree on the host first is
    slow, so the draws happen where the weights will live."""

    def __init__(self, seed: int = 0, device="cpu"):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def normal(self, shape, std=0.02):
        return torch.randn(tuple(shape), generator=self.gen,
                           device=self.device) * std

    def uniform(self, shape, a, b):
        u = torch.rand(tuple(shape), generator=self.gen, device=self.device)
        return u * (b - a) + a

    def zeros(self, shape):
        return torch.zeros(tuple(shape), device=self.device)

    def ones(self, shape):
        return torch.ones(tuple(shape), device=self.device)

    def kaiming_conv1d(self, width, in_ch, out_ch, groups=1):
        fan_in = (in_ch // groups) * width
        bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        return self.uniform((width, in_ch // groups, out_ch), -bound, bound)

    def kaiming_dense(self, in_dim, out_dim):
        bound = 1.0 / math.sqrt(in_dim)
        return self.uniform((in_dim, out_dim), -bound, bound)

    def xavier_uniform(self, shape):
        fan_in, fan_out = shape[0], shape[-1]
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        return self.uniform(shape, -bound, bound)


# ---------------------------------------------------------------------------
# initializers (JAX-package layouts; see module docstring)
# ---------------------------------------------------------------------------

def dense_init(rng: InitRng, in_dim: int, out_dim: int, bias: bool = True,
               std: Optional[float] = None) -> Params:
    if std is None:
        p = {"kernel": rng.kaiming_dense(in_dim, out_dim)}
        if bias:
            b = 1.0 / math.sqrt(in_dim)
            p["bias"] = rng.uniform((out_dim,), -b, b)
    else:
        p = {"kernel": rng.normal((in_dim, out_dim), std)}
        if bias:
            p["bias"] = rng.zeros((out_dim,))
    return p


def embedding_init(rng: InitRng, num: int, dim: int, std: float = 0.02) -> Params:
    return {"weight": rng.normal((num, dim), std)}


def layer_norm_init(rng: InitRng, dim: int, affine: bool = True) -> Params:
    return {"weight": rng.ones((dim,)), "bias": rng.zeros((dim,))} if affine else {}


def rms_norm_init(rng: InitRng, dim: int) -> Params:
    return {"weight": rng.ones((dim,))}


def l2norm_scale_init(rng: InitRng, dim: int) -> Params:
    return {"gamma": rng.ones((dim,))}


def group_norm_init(rng: InitRng, channels: int) -> Params:
    return {"weight": rng.ones((channels,)), "bias": rng.zeros((channels,))}


def conv1d_init(rng: InitRng, in_ch: int, out_ch: int, width: int,
                bias: bool = True, groups: int = 1) -> Params:
    p = {"kernel": rng.kaiming_conv1d(width, in_ch, out_ch, groups)}
    if bias:
        bound = 1.0 / math.sqrt((in_ch // groups) * width)
        p["bias"] = rng.uniform((out_ch,), -bound, bound)
    return p


def conv2d_init(rng: InitRng, in_ch: int, out_ch: int, kh: int, kw: int,
                bias: bool = True) -> Params:
    bound = 1.0 / math.sqrt(in_ch * kh * kw)
    p = {"kernel": rng.uniform((kh, kw, in_ch, out_ch), -bound, bound)}
    if bias:
        p["bias"] = rng.uniform((out_ch,), -bound, bound)
    return p


def stack_layers(layers: Sequence[Params]) -> Params:
    """List of same-structure dicts -> one dict of (L, ...)-stacked tensors
    (the JAX package's scan layout, which the weight bridge unstacks)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([lp[k] for lp in layers]) for k in first}
    return torch.stack(list(layers))


# ---------------------------------------------------------------------------
# layers (torch layouts)
# ---------------------------------------------------------------------------

def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ W + b. A weight-only int8 layer (``{"q": (out, in) int8, "scale":
    (out,) f32, "bias"}``, see `quantize_dense_int8`) computes x @ q with an
    f32 result, then ``* scale + bias`` in f32, and rounds to x's dtype once,
    as the JAX package's `nn.dense` does. A weight-only int4 layer (``"q4"``
    (out, in/2), see `quantize_dense_int4`) is unpacked first and then
    takes the same path (the decode loop's int4 GEMV is the kernel; this
    serves prefill and the teacher-forced pass)."""
    b = p.get("bias")
    if "q" in p or "q4" in p:
        q = p["q"] if "q" in p else unpack_int4(p["q4"])
        y = torch.matmul(x.float(), q.t().float()) * p["scale"]
        if b is not None:
            y = y + b.float()
        return y.to(x.dtype)
    return F.linear(x, p["weight"].to(x.dtype),
                    None if b is None else b.to(x.dtype))


def quantize_dense_int8(p: Params) -> Params:
    """Per-output-channel symmetric int8 of a torch-layout dense layer:
    scale = max|w| / 127 over the input axis in f32 (at least 1e-8 / 127),
    q = clip(round_half_even(w / scale), -127, 127). The same bytes as the
    JAX package's `nn.quantize_dense_int8` on the same weights."""
    if "weight" not in p:
        return p
    w = p["weight"].float()
    scale = torch.clamp(w.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    out = {"q": q.contiguous(), "scale": scale.contiguous()}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def int4_halfspan(half_k: int) -> int:
    """The nibble grouping of `quantize_dense_int4`: the K input columns are
    packed in groups of 2h (lo nibbles = a group's first h columns, hi
    nibbles = its last h). h = 320 when (K/2) % 320 == 0, so every 640
    columns form a group; otherwise one group spans the whole row."""
    return 320 if half_k % 320 == 0 else half_k


def quantize_dense_int4(p: Params) -> Params:
    """Per-output-channel symmetric int4 of a torch-layout dense layer:
    scale = max|w| / 7 over the input axis in f32 (at least 1e-8 / 7),
    values clip(round_half_even(w / scale), -7, 7), two per int8 byte along
    the input axis: ``{"q4": (out, in/2) int8, "scale": (out,) f32}``. The
    same bytes as the JAX package's `nn.quantize_dense_int4`, transposed."""
    if "weight" not in p:
        return p
    w = p["weight"].float()
    N, K = w.shape
    if K % 2:
        raise ValueError(f"int4 packing needs an even input width, got {K}")
    scale = torch.clamp(w.abs().amax(dim=-1), min=1e-8) / 7.0
    q = torch.clamp(torch.round(w / scale[:, None]), -7, 7).to(torch.int8)
    h = int4_halfspan(K // 2)
    v = q.reshape(N, K // (2 * h), 2, h)
    packed = (v[:, :, 1] << 4) | (v[:, :, 0] & 0xF)
    out = {"q4": packed.reshape(N, K // 2).contiguous(), "scale": scale.contiguous()}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def unpack_int4(q4: torch.Tensor) -> torch.Tensor:
    """Packed (..., K/2) int8 -> (..., K) int8 values in [-7, 7] in natural
    column order (the inverse of `quantize_dense_int4`'s packing): the lo
    nibble sign-extended by ``(b << 4) >> 4``, the hi nibble by ``b >> 4``,
    both arithmetic shifts on int8."""
    half = q4.shape[-1]
    h = int4_halfspan(half)
    v = q4.reshape(*q4.shape[:-1], half // h, h)
    return torch.stack([(v << 4) >> 4, v >> 4], dim=-2).reshape(*q4.shape[:-1], 2 * half)


def embedding(p: Params, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return p["weight"].to(dtype)[ids]


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    w, b = p.get("weight"), p.get("bias")
    y = F.layer_norm(x.float(), (x.shape[-1],),
                     None if w is None else w.float(),
                     None if b is None else b.float(), eps)
    return y.to(x.dtype)


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    y = (xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)).to(x.dtype)
    return y * p["weight"].to(x.dtype) if "weight" in p else y


def l2norm_scaled(p: Params, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Perceiver RMSNorm variant: normalize(x) * sqrt(dim) * gamma."""
    xf = x.float()
    n = xf * torch.rsqrt(torch.clamp(torch.sum(xf * xf, -1, keepdim=True), min=1e-24))
    y = n * math.sqrt(dim)
    if "gamma" in p:
        y = y * p["gamma"].float()
    return y.to(x.dtype)


def group_norm(p: Params, x: torch.Tensor, groups: int, eps: float = 1e-5,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm over (B, T, C); ``mask`` (B, T) limits the statistics to
    valid frames."""
    b, t, c = x.shape
    xf = x.float().reshape(b, t, groups, c // groups)
    if mask is not None:
        m = mask.float()[:, :, None, None]
        denom = torch.clamp(m.sum(1, keepdim=True) * (c // groups), min=1.0)
        mu = (xf * m).sum((1, 3), keepdim=True) / denom
        var = ((xf - mu).square() * m).sum((1, 3), keepdim=True) / denom
    else:
        mu = xf.mean((1, 3), keepdim=True)
        var = (xf - mu).square().mean((1, 3), keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(b, t, c)
    return (y * p["weight"].float() + p["bias"].float()).to(x.dtype)


Padding = Union[str, int, Tuple[int, int]]


def conv1d(p: Params, x: torch.Tensor, stride: int = 1, padding: Padding = "SAME",
           dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """1-D conv over (B, T, C) with a torch-layout (Cout, Cin/groups, W) weight.
    ``padding``: an int (both sides), a (left, right) pair, "VALID" or
    "SAME" (stride 1)."""
    w = p["weight"]
    width = w.shape[-1]
    if padding == "VALID":
        padding = (0, 0)
    elif padding == "SAME":
        total = (width - 1) * dilation
        padding = (total // 2, total - total // 2)
    elif isinstance(padding, int):
        padding = (padding, padding)
    xc = x.transpose(1, 2)
    if padding[0] or padding[1]:
        xc = F.pad(xc, padding)
    b = p.get("bias")
    y = F.conv1d(xc, w.to(x.dtype), None if b is None else b.to(x.dtype),
                 stride=stride, dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv_transpose1d(p: Params, x: torch.Tensor, stride: int,
                     padding: int = 0) -> torch.Tensor:
    """torch ConvTranspose1d over (B, T, Cin) with a (Cin, Cout, W) weight."""
    b = p.get("bias")
    y = F.conv_transpose1d(x.transpose(1, 2), p["weight"].to(x.dtype),
                           None if b is None else b.to(x.dtype),
                           stride=stride, padding=padding)
    return y.transpose(1, 2)


def conv2d(p: Params, x: torch.Tensor, stride: Tuple[int, int] = (1, 1),
           padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """2-D conv over (B, C, H, W) with an (out, in, kh, kw) weight."""
    b = p.get("bias")
    return F.conv2d(x, p["weight"].to(x.dtype),
                    None if b is None else b.to(x.dtype),
                    stride=stride, padding=padding)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, Tq, D) x (B, H, Tk, D) -> (B, H, Tq, D) with a boolean keep-mask
    broadcastable to (B, H, Tq, Tk). The fused library attention keeps the
    scores and the softmax in f32, as the JAX package's `nn.mha` does; masked
    scores get -1e9 added (fp16's most negative value, -65504, for fp16
    operands, whose bias cannot hold -1e9; either is exp-zero against the
    f32 scores), so a fully masked row stays finite (its output is garbage
    that callers mask, as in the JAX package)."""
    bias = None
    if mask is not None:
        bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device)
        bias = bias.masked_fill(~mask, max(-1e9, torch.finfo(q.dtype).min))
    return F.scaled_dot_product_attention(q, k.to(q.dtype), v.to(q.dtype),
                                          attn_mask=bias, scale=scale)


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lengths: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Attention over padded same-rate (B, H, T, D) q, k, v with per-row valid
    ``lengths`` (the JAX package's `nn.mha_flash`). Non-causal CUDA tensors
    run kernel K4 (`ops/attn.py::single_block_attention`, which raises on
    what it does not take); everything else runs `mha` with the length mask
    (and the causal one), as the JAX package does off the TPU. Query rows
    past a length are garbage that callers mask."""
    if q.device.type == "cuda" and not causal:
        return single_block_attention(q, k, v, lengths)
    T = q.shape[2]
    mask = (torch.arange(T, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])[:, None, None, :]
    if causal:
        mask = mask & torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    return mha(q, k.to(q.dtype), v.to(q.dtype), mask=mask)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """GPT-2's tanh-approximation GELU, computed in f32."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(0.7978845608028654 * (xf + 0.044715 * xf ** 3)))
    return y.to(x.dtype)


def mish(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.tanh(F.softplus(xf))).to(x.dtype)


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    a, b = torch.chunk(x, 2, dim=dim)
    return a * torch.sigmoid(b)


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_length) bool mask."""
    return torch.arange(max_length, device=lengths.device)[None, :] < lengths[:, None]


def masked_reflect_pad(x: torch.Tensor, lengths: torch.Tensor, pad_left: int,
                       pad_right: int) -> torch.Tensor:
    """Reflect-pad (B, T, C) around each row's valid region [0, len)."""
    T = x.shape[1]
    idx = torch.arange(-pad_left, T + pad_right, device=x.device)[None, :]
    i = idx.abs()
    last = torch.clamp(lengths[:, None] - 1, min=0)
    i = last - (last - i).abs()
    i = i.clamp(0, T - 1)
    return torch.gather(x, 1, i[:, :, None].expand(-1, -1, x.shape[2]))
