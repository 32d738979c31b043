"""Tensor-parallel (tp=2) fused GPT-2 decode step: kernel K6 and its plain twin.

The port of `indextts_tpu/ops/pallas/decode_step_tp.py`:
`fused_decode_step_tp` is `fused_decode_step_tp_shard` (decode_step_tp.py:367)
run on both shards of the mesh, the shard_map entry ``tp_decode_step``
(:548) included: the tree carries its mesh, so the entry is the function
itself (`tp_decode_step` is its name there). Scope is the TPU kernel's: tp=2, int8 weights,
the bf16 cache, the sampling decode at ``group=1`` and the beam ancestry map
at ``group=K``. Per layer, each shard t (its weights from
`parallel/mesh.py::shard_gpt2_tp`, its (L, B, S, D/2) cache) runs:

1. ``ln_1`` + its column-parallel qkv projection (its 10 of 20 heads):
   `int8_matvec` with the LayerNorm prologue and the scale / bias epilogue;
2. attention over its cache at ``heads = H/2``, with the ancestry map, which
   writes the token's k/v row at ``pos``: `decode_attention`;
3. its row-parallel out-projection: `int8_matvec` with no epilogue, an f32
   partial, unscaled;
4. the all-reduce of the pair's partials, lo + hi, then the full scale and
   bias, the bf16 rounding and the residual add: `tp_allreduce`
   (`csrc/tp_allreduce.cu`), the new kernel, which reads the peer's partial
   through its device pointer;
5. ``ln_2`` + its column-parallel c_fc with the gelu epilogue, and its
   row-parallel down-projection as an f32 partial: `int8_mlp` with no second
   epilogue;
6. the second all-reduce, as in 4.

``ln_f`` applies outside, on rank 0's device, as in the JAX engine. Both
shards hold bit-identical residual streams (the same reduce on the same
partials), so rank 0's is the result.

On the card each shard runs on its own stream (`Mesh.streams`); the step
forks both from the caller's stream and joins them back at its end. A
shard's all-reduce waits on an event recorded on the peer's stream after the
peer's partial product. Every (layer, exchange) has its own partial buffers,
held until the join: no write of a later layer can race the peer's read, and
the join orders every write of the next step after this step's reads. No
library call, torch copy or collective sits between the shards: they meet
only inside `tp_allreduce`. The token x (B, D) is placed on each shard's
device, as shard_map replicates it (on one card that is the same tensor);
kv_valid and the ancestry map come as `parallel.mesh.Replicated`, a copy on
each device that the engines keep up to date, so the step copies neither.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from indextts_tpu_torch.ops import cuda
from indextts_tpu_torch.ops.decode_step import decode_attention, decode_attention_plain
from indextts_tpu_torch.ops.int8 import (MAX_ROWS, int8_matvec, int8_matvec_plain, int8_mlp,
                                         int8_mlp_plain)
from indextts_tpu_torch.parallel.mesh import Replicated


def tp_allreduce_plain(own: torch.Tensor, peer: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, residual: torch.Tensor, rank: int) -> torch.Tensor:
    """The plain twin of `tp_allreduce` (any device)."""
    lo, hi = (own, peer) if rank == 0 else (peer, own)
    dev = own.device
    v = ((lo.to(dev) + hi.to(dev)) * scale + bias.float()).to(torch.bfloat16)
    return residual + v


def tp_allreduce(own: torch.Tensor, peer: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, residual: torch.Tensor, rank: int) -> torch.Tensor:
    """K6's exchange: residual + bf16((lo + hi) * scale + bias), lo the
    (M, N) f32 partial of tp rank 0 and hi rank 1's; ``own`` is this
    shard's partial, ``peer`` the other shard's (on this card or a peer
    card), ``rank`` this shard's index; scale (N,) f32, bias (N,) bf16,
    residual (M, N) bf16 on own's device. Returns (M, N) bf16. CPU tensors
    run the plain twin; CUDA tensors launch `csrc/tp_allreduce.cu` on the
    current stream; anything else raises."""
    if own.device.type == "cpu":
        return tp_allreduce_plain(own, peer, scale, bias, residual, rank)
    if own.device.type != "cuda" or peer.device.type != "cuda":
        raise ValueError(f"tp_allreduce: unsupported devices {own.device}, {peer.device}")
    dev = own.device
    M, N = own.shape
    for name, t, dtype, shape, where in (
            ("own partial", own, torch.float32, (M, N), dev),
            ("peer partial", peer, torch.float32, (M, N), peer.device),
            ("scale", scale, torch.float32, (N,), dev), ("bias", bias, torch.bfloat16, (N,), dev),
            ("residual", residual, torch.bfloat16, (M, N), dev)):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != where \
                or not t.is_contiguous():
            raise ValueError(f"tp_allreduce: {name} must be contiguous {dtype} {shape} on "
                             f"{where}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if rank not in (0, 1):
        raise ValueError(f"tp_allreduce: rank {rank} of a tp=2 pair")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        code = cuda.library().tp_allreduce_launch(
            own.data_ptr(), peer.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            residual.data_ptr(), out.data_ptr(), M, N, rank, cuda.stream_ptr(own))
    cuda.check(code, "tp_allreduce")
    tp_allreduce.launches += 1
    return out


tp_allreduce.launches = 0


class TpOps(NamedTuple):
    """The operations of one shard's layer, as kernels (`KERNELS`) or as
    plain twins (`TWINS`)."""
    matvec: Callable
    mlp: Callable
    attention: Callable
    allreduce: Callable


KERNELS = TpOps(int8_matvec, int8_mlp, decode_attention, tp_allreduce)
TWINS = TpOps(int8_matvec_plain, int8_mlp_plain, decode_attention_plain, tp_allreduce_plain)


def _on(streams, t: int):
    return torch.cuda.stream(streams[t]) if streams is not None else contextlib.nullcontext()


def _exchange(ops: TpOps, layers, name: str, parts: List[torch.Tensor],
              xs: List[torch.Tensor], streams) -> List[torch.Tensor]:
    """Both shards' all-reduce of ``parts`` into their residual streams; on
    the card each waits first on the peer's stream (after its partial)."""
    if streams is not None:
        for t, s in enumerate(streams):
            s.wait_stream(streams[1 - t])
    out = []
    for t, lp in enumerate(layers):
        with _on(streams, t):
            p = lp[name]["c_proj"]
            out.append(ops.allreduce(parts[t], parts[1 - t], p["scale"], p["bias"], xs[t], t))
    return out


def decode_layer_tp(ops: TpOps, layers, xs: List[torch.Tensor], heads: int, pos: int,
                    caches: List[Dict[str, torch.Tensor]], li: int,
                    kv_valids: List[torch.Tensor], ancs: List[Optional[torch.Tensor]],
                    group: int = 1, streams=None,
                    keep: Optional[list] = None) -> List[torch.Tensor]:
    """One block of the step on both shards: ``layers[t]`` is rank t's layer
    tree, ``xs[t]`` its (B, D) input, ``caches[t]`` its cache (layer ``li``
    is used), ``heads`` per shard. Returns each shard's output. ``keep``
    receives the partial buffers, which the peer may read until the step's
    streams join."""
    parts = []
    for t, lp in enumerate(layers):
        with _on(streams, t):
            a = lp["attn"]
            qkv = ops.matvec(xs[t], a["c_attn"]["q"], ln=(lp["ln_1"]["weight"], lp["ln_1"]["bias"]),
                             scale=a["c_attn"]["scale"], bias=a["c_attn"]["bias"])
            att = ops.attention(qkv, caches[t]["k"][li], caches[t]["v"][li], kv_valids[t], pos,
                                heads, ancs[t], group)
            parts.append(ops.matvec(att, a["c_proj"]["q"]))
    xs = _exchange(ops, layers, "attn", parts, xs, streams)
    if keep is not None:
        keep.append(parts)
    parts = []
    for t, lp in enumerate(layers):
        with _on(streams, t):
            f = lp["mlp"]
            parts.append(ops.mlp(xs[t], f["c_fc"]["q"], f["c_fc"]["scale"], f["c_fc"]["bias"],
                                 f["c_proj"]["q"], ln=(lp["ln_2"]["weight"], lp["ln_2"]["bias"])))
    xs = _exchange(ops, layers, "mlp", parts, xs, streams)
    if keep is not None:
        keep.append(parts)
    return xs


def _check_step_tp(params, x: torch.Tensor, dims, kv_cache, group: int, anc) -> None:
    if "shards" not in params or "shards" not in kv_cache:
        raise ValueError("the tp decode step takes the tree of parallel/mesh.py::shard_gpt2_tp "
                         "and the per-shard cache of init_kv_cache(mesh=...)")
    mesh = params["mesh"]
    if mesh.tp != 2 or len(params["shards"]) != 2 or len(kv_cache["shards"]) != 2:
        raise ValueError(f"the tp decode step takes tp=2, got {mesh}")
    if "q" not in params["shards"][0][0]["attn"]["c_attn"]:
        raise ValueError("the tp decode step takes int8 weights (quantize_gpt2_int8)")
    B = x.shape[0]
    if B > MAX_ROWS:
        raise ValueError(f"the tp decode step takes at most {MAX_ROWS} rows, got {B}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the tp decode step takes bf16 activations, got {x.dtype}")
    D = dims.dim // mesh.tp
    for dev, cache in zip(mesh.devices, kv_cache["shards"]):
        if set(cache) != {"k", "v"} or any(
                t.dtype != torch.bfloat16 or t.ndim != 4 or t.shape[-1] != D or t.device != dev
                for t in cache.values()):
            got = {k: (t.dtype, tuple(t.shape), str(t.device)) for k, t in cache.items()}
            raise ValueError(f"the tp decode step takes each shard's flat bf16 (L, B, S, {D}) "
                             f"cache on its device, got {got}")
    if group > 1 and anc is None:
        raise ValueError("the tp decode step: group > 1 needs the ancestry map")


def per_rank(v, devices) -> list:
    """Each rank's copy of a replicated step input: a `Replicated`'s copy on
    the rank's device, or a tensor that lives on every rank's device (the
    shards co-located); None stays None. A tensor on another device raises:
    the step copies no mask or map between devices."""
    if v is None or isinstance(v, Replicated):
        return [None if v is None else v.on(d) for d in devices]
    if any(v.device != d for d in devices):
        raise ValueError(f"the tp decode step: an input on {v.device} for ranks on "
                         f"{[str(d) for d in devices]}; pass it as parallel.mesh.Replicated")
    return [v] * len(devices)


def _step_tp(ops: TpOps, params, x, dims, pos: int, kv_cache, kv_valid, anc, group: int,
             layer_inputs: Optional[list]) -> torch.Tensor:
    _check_step_tp(params, x, dims, kv_cache, group, anc)
    mesh, shards, caches = params["mesh"], params["shards"], kv_cache["shards"]
    devs = mesh.devices
    xs = [x.to(d) for d in devs]
    valids, ancs = per_rank(kv_valid, devs), per_rank(anc, devs)
    streams = mesh.streams() if ops is KERNELS and x.device.type == "cuda" else None
    if streams is not None:
        for d, s in zip(devs, streams):
            s.wait_stream(torch.cuda.current_stream(d))
    keep: list = []
    heads = dims.heads // mesh.tp
    for li, layers in enumerate(zip(*shards)):
        if layer_inputs is not None:
            layer_inputs.append(tuple(xs))
        xs = decode_layer_tp(ops, layers, xs, heads, pos, caches, li, valids, ancs, group,
                             streams, keep)
    if layer_inputs is not None:
        layer_inputs.append(tuple(xs))
    if streams is not None:
        for d, s in zip(devs, streams):
            torch.cuda.current_stream(d).wait_stream(s)
    return xs[0]


def fused_decode_step_tp_plain(params, x: torch.Tensor, dims, pos: int, kv_cache: Dict,
                               kv_valid: torch.Tensor, anc: Optional[torch.Tensor] = None,
                               group: int = 1,
                               layer_inputs: Optional[list] = None) -> torch.Tensor:
    """The plain twin of `fused_decode_step_tp` (any device, one stream),
    made of the kernels' plain twins."""
    return _step_tp(TWINS, params, x, dims, pos, kv_cache, kv_valid, anc, group, layer_inputs)


def fused_decode_step_tp(params, x: torch.Tensor, dims, pos: int, kv_cache: Dict,
                         kv_valid: torch.Tensor, anc: Optional[torch.Tensor] = None,
                         group: int = 1, layer_inputs: Optional[list] = None) -> torch.Tensor:
    """K6: one token x (B, D) bf16, B <= 24, through every layer of the
    tensor-parallel int8 tree ``params`` (`shard_gpt2_tp`) against the
    per-shard cache ``kv_cache`` (`init_kv_cache(mesh=...)`); x on rank 0's
    device, kv_valid (B, S) and anc (B, S) int32 (``group`` > 1: the
    in-group ancestry map, as for K1) on every rank's (`per_rank`). Writes each shard's k/v rows at ``pos``
    in place. Returns the hidden state before ``ln_f``, (B, D) on rank 0's
    device; a ``layer_inputs`` list receives, per layer, the tuple of the
    shards' inputs, and the shards' outputs last. Counts one launch a step
    (``fused_decode_step_tp.launches``) on the card."""
    h = _step_tp(KERNELS, params, x, dims, pos, kv_cache, kv_valid, anc, group, layer_inputs)
    if x.device.type == "cuda":
        fused_decode_step_tp.launches += 1
    return h


fused_decode_step_tp.launches = 0


# the JAX package's name of the entry (its shard_map over the mesh)
tp_decode_step = fused_decode_step_tp
