"""Weight bridge: a parameter tree in the JAX package's layouts -> the port's.

Input is what the JAX package's `init_*` functions return (numpy leaves,
`indextts_tpu/nn.py::InitRng`) or what the port's own `init_*` functions
return (the same layouts, as torch tensors drawn on the device). Output is
the same nesting with torch tensors in the layouts the port's layer
functions consume. Every layout change of the port lives here:

- dense ``{"kernel": (in, out)}`` -> ``{"weight": (out, in)}`` (nn.Linear);
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
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

# keys whose value is a conv-transpose param dict / a scanned layer stack
_CONV_TRANSPOSE = ("ups",)
_STACKED = ("h", "layers")


def _tensor(x, device, dtype) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
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
    out = {}
    for key, val in tree.items():
        if key == "kernel":
            out["weight"] = _kernel(_tensor(val, device, dtype),
                                    _transpose_conv).contiguous()
        elif key in _STACKED and _is_stack(val):
            out[key] = [to_torch(lp, device, dtype) for lp in _unstack(val)]
        else:
            out[key] = to_torch(val, device, dtype, key in _CONV_TRANSPOSE)
    return out
