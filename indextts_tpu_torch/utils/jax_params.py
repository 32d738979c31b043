"""Weight bridge: a parameter tree in the JAX package's layouts -> the port's.

Input is what the JAX package's `init_*` functions return (numpy leaves,
`indextts_tpu/nn.py::InitRng`) or what the port's own `init_*` functions
return (the same layouts, as torch tensors drawn on the device). Output is
the same nesting with torch tensors in the layouts the port's layer
functions consume. Every layout change of the port lives here:

- dense ``{"kernel": (in, out)}`` -> ``{"weight": (out, in)}`` (nn.Linear);
- weight-only int8 dense ``{"q": (in, out) int8, "scale": (1, out) f32}``
  -> ``{"q": (out, in) int8, "scale": (out,) f32}``, and weight-only int4
  ``{"q4": (in/2, out) int8}`` -> ``{"q4": (out, in/2) int8}`` (the packed
  bytes unchanged, so the nibble grouping runs along the last axis): the
  int8 values and the f32 scales keep their types (only the bias takes
  ``dtype``); the JAX package's tp-kernel layout of the int8 qkv stack
  (`gpt_tp_layout`: q (D, 3, D), scale and bias (3, D) per layer) is a pure
  reshape of the canonical one and is taken back to it;
- conv1d ``{"kernel": (W, in/g, out)}`` -> ``{"weight": (out, in/g, W)}``;
- conv-transpose ``{"kernel": (W, in, out)}``, stored flipped for the
  lhs-dilated form -> ``{"weight": (in, out, W)}`` (nn.ConvTranspose1d);
- conv2d ``{"kernel": (kh, kw, in, out)}`` -> ``{"weight": (out, in, kh, kw)}``;
- layer stacks scanned by the JAX package (leading L axis: GPT-2 ``h``, the
  DiT backbone's ``layers``) -> a list of per-layer trees.

Everything else (norm scales, biases, embeddings, codebooks, snake alphas)
is copied unchanged. In particular the DiT's ``wqkv`` columns are already
pair-deinterleaved for the half-split rope in both packages and are not
permuted.

`to_jax` is the inverse on float trees (the trainer's checkpoints, and the
tests' gradient comparisons): numpy arrays in the JAX layouts. A torch
weight is a JAX kernel and a list a JAX stack only where `to_torch` made
them (an embedding's ``weight`` is 2-D too, and the WaveNet's ``layers`` is
a list in both packages), so `to_torch` returns those two as the marked
types `Kernel` and `LayerStack`, which behave as the dict and the list they
are.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

# keys whose value is a conv-transpose param dict / a scanned layer stack
_CONV_TRANSPOSE = ("ups", "dec_convs")
_STACKED = ("h", "layers")


class Kernel(dict):
    """A layer whose JAX ``kernel`` `to_torch` turned into a torch ``weight``."""


class LayerStack(list):
    """The per-layer list `to_torch` made of a scanned stack (leading L axis)."""


def _tensor(x, device, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        on_host = device is None or torch.device(device).type == "cpu"
        # JAX's numpy bfloat16 (ml_dtypes) has no torch counterpart to
        # convert from: carry its bits. A host tensor gets its own copy (the
        # array may be a view of a memory-mapped checkpoint file); a tensor
        # bound for the card is copied there, from a view where numpy has
        # one (a flipped conv-transpose kernel has negative strides, which
        # torch does not take)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        elif on_host:
            t = torch.from_numpy(np.array(a, order="C"))
        else:
            t = torch.as_tensor(a if min(a.strides, default=0) >= 0
                                else np.ascontiguousarray(a))
    t = t.to(device) if device is not None else t
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.contiguous()


def _kernel(k: torch.Tensor, transpose_conv: bool) -> torch.Tensor:
    if k.ndim == 2:
        return k.t()
    if k.ndim == 3:
        if transpose_conv:
            return torch.flip(k.permute(1, 2, 0), dims=(-1,))
        return k.permute(2, 1, 0)
    if k.ndim == 4:
        return k.permute(3, 2, 0, 1)
    raise ValueError(f"unsupported kernel rank {k.ndim}")


def _unstack(tree: Any) -> list:
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(tree, list):
        parts = [_unstack(v) for v in tree]
        return [[p[i] for p in parts] for i in range(len(parts[0]))]
    return [tree[i] for i in range(tree.shape[0])]


def _is_stack(tree: Any) -> bool:
    """A scanned stack is a dict of sub-layer dicts whose arrays share a
    leading layer axis (a per-layer list, as in w2v-bert, is not one)."""
    return isinstance(tree, dict) and all(isinstance(v, dict) for v in tree.values())


def to_torch(tree: Any, device=None, dtype: Optional[torch.dtype] = None,
             _transpose_conv: bool = False) -> Any:
    """Convert a JAX-layout tree (numpy or torch leaves) to the port's layout,
    moving leaves to ``device`` and casting floating leaves to ``dtype``."""
    if isinstance(tree, list):
        return [to_torch(v, device, dtype, _transpose_conv) for v in tree]
    if not isinstance(tree, dict):
        return _tensor(tree, device, dtype)
    out = Kernel() if "kernel" in tree else {}
    for qkey in ("q", "q4"):
        if qkey in tree:
            q = _tensor(tree[qkey], device, None)
            if q.ndim == 3:              # gpt_tp_layout's (in, 3, out/3)
                q = q.reshape(q.shape[0], -1)
                tree = {**tree, "bias": _tensor(tree["bias"], device, dtype).reshape(-1)}
            out[qkey] = q.t().contiguous()
            out["scale"] = _tensor(tree["scale"], device, torch.float32).reshape(-1)
            tree = {k: v for k, v in tree.items() if k not in (qkey, "scale")}
    for key, val in tree.items():
        if key == "kernel":
            out["weight"] = _kernel(_tensor(val, device, dtype),
                                    _transpose_conv).contiguous()
        elif key in _STACKED and _is_stack(val):
            out[key] = LayerStack(to_torch(lp, device, dtype) for lp in _unstack(val))
        else:
            out[key] = to_torch(val, device, dtype, key in _CONV_TRANSPOSE)
    return out


def _unkernel(w: torch.Tensor, transpose_conv: bool) -> torch.Tensor:
    """The inverse of `_kernel`."""
    if w.ndim == 2:
        return w.t()
    if w.ndim == 3:
        if transpose_conv:
            return torch.flip(w, dims=(-1,)).permute(2, 0, 1)
        return w.permute(2, 1, 0)
    if w.ndim == 4:
        return w.permute(2, 3, 1, 0)
    raise ValueError(f"unsupported weight rank {w.ndim}")


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``, never a view of a CPU tensor's storage (which
    a training step updates in place)."""
    half = t.dtype in (torch.bfloat16, torch.float16)
    t = t.detach().to("cpu", torch.float32 if half else t.dtype, copy=True)
    return np.ascontiguousarray(t.numpy())


def _stack(layers: list) -> Any:
    if isinstance(layers[0], dict):
        return {k: _stack([lp[k] for lp in layers]) for k in layers[0]}
    if isinstance(layers[0], list):
        return [_stack([lp[i] for lp in layers]) for i in range(len(layers[0]))]
    return np.stack(layers)


def to_jax(tree: Any, _transpose_conv: bool = False) -> Any:
    """The inverse of `to_torch` on a float tree: numpy arrays in the JAX
    package's layouts (weights of `Kernel` layers back to kernels,
    `LayerStack` lists stacked on a leading axis; bf16 and fp16 leaves
    widened to f32), copies that share no memory with ``tree``.
    ``to_jax(to_torch(t))`` returns every leaf of a JAX
    float tree exactly. Weight-only quantized layers raise: their scale's
    JAX shape is not kept."""
    if isinstance(tree, LayerStack):
        return _stack([to_jax(lp) for lp in tree])
    if isinstance(tree, (list, tuple)):
        return [to_jax(v, _transpose_conv) for v in tree]
    if not isinstance(tree, dict):
        return _numpy(tree)
    if "q" in tree or "q4" in tree:
        raise ValueError("to_jax takes float trees, not weight-only quantized layers")
    out = {}
    for key, val in tree.items():
        if key == "weight" and isinstance(tree, Kernel):
            out["kernel"] = _numpy(_unkernel(val, _transpose_conv))
        else:
            out[key] = to_jax(val, key in _CONV_TRANSPOSE)
    return out
