"""Tensor-parallel (tp=2) fused GPT-2 decode step: kernel K6 and its plain twin.

The port of `indextts_tpu/ops/pallas/decode_step_tp.py`:
`fused_decode_step_tp` is `fused_decode_step_tp_shard` (decode_step_tp.py:367)
run on both shards of the mesh, the shard_map entry ``tp_decode_step``
(:548) included: the tree carries its mesh, so the entry is the function
itself (`tp_decode_step` is its name there). Scope is the TPU kernel's: tp=2, int8 weights,
the bf16 cache, the sampling decode at ``group=1`` and the beam ancestry map
at ``group=K``. Per layer, each shard t (its weights from
`parallel/mesh.py::shard_gpt2_tp`, its (L, B, S, D/2) cache) computes:

1. ``ln_1`` + its column-parallel qkv projection (its 10 of 20 heads), with
   the scale / bias epilogue;
2. attention over its cache at ``heads = H/2``, with the ancestry map, which
   writes the token's k/v row at ``pos``;
3. its row-parallel out-projection: an f32 partial, unscaled;
4. the all-reduce of the pair's partials, lo + hi, then the full scale and
   bias, the bf16 rounding and the residual add;
5. ``ln_2`` + its column-parallel c_fc with the gelu epilogue, and its
   row-parallel down-projection as an f32 partial;
6. the second all-reduce, as in 4.

``ln_f`` applies outside, on rank 0's device, as in the JAX engine. Both
shards hold bit-identical residual streams (the same reduce on the same
partials), so rank 0's is the result.

Two routes on the card, chosen by ``mesh.devices`` alone (never a retry
after a failure):

- both shards on one card (`make_mesh(["cuda:0", "cuda:0"])`, the tp
  pipeline's and `chip_smoke.py`'s layout): ONE launch a step of the
  persistent kernel's TP variant (`csrc/decode_step.cu`,
  `decode_step_tp_launch`; `decode_step.step_tp_plan` is its plan), which
  runs both shards' layers and folds each all-reduce into the row-parallel
  product's own sum (the out-projection's in one block, which takes both
  shards' weight slabs of a tile; the MLP projection's over a thread-block
  cluster, whose ranks take both shards' spans of K): no partial in device
  memory, no `tp_allreduce` launch, no stream fork. It shares the card's grid-barrier
  words with K1 (`decode_step.step_barrier`): K1 and K6 launches on one
  card must not overlap;
- the shards on two cards: `fused_decode_step_tp_chain`, K1's standalone
  kernels at shard shapes (`int8_matvec`, `int8_mlp` with no second
  epilogue, `decode_attention`) and `tp_allreduce` (`csrc/tp_allreduce.cu`),
  which reads the peer's f32 partial through its device pointer. Each
  shard runs on its own stream (`Mesh.streams`); the step forks both from
  the caller's stream and joins them back at its end. A shard's all-reduce
  waits on an event recorded on the peer's stream after the peer's partial
  product. Every (layer, exchange) has its own partial buffers, held until
  the join: no write of a later layer can race the peer's read, and the
  join orders every write of the next step after this step's reads. No
  library call, torch copy or collective sits between the shards: they
  meet only inside `tp_allreduce`.

The persistent kernel gives the chain's bits (the same arithmetic, in the
same order), and `chip_smoke.py` holds it to that. The token x (B, D) is
placed on each shard's device, as shard_map replicates it (on one card
that is the same tensor); kv_valid and the ancestry map come as
`parallel.mesh.Replicated`, a copy on each device that the engines keep up
to date, so the step copies neither.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from indextts_tpu_torch.ops import cuda
from indextts_tpu_torch.ops.decode_step import (HEAD_DIM, STEP_MARKS, STEP_MAX_LAYERS,
                                                _layer_table, decode_attention,
                                                decode_attention_plain, step_barrier,
                                                step_tp_plan, step_tp_shape)
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
    cuda.refuse_grad("tp_allreduce", own, peer, scale, bias, residual)
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
    cuda.count(tp_allreduce)
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


def fused_decode_step_tp_chain(params, x: torch.Tensor, dims, pos: int, kv_cache: Dict,
                               kv_valid: torch.Tensor, anc: Optional[torch.Tensor] = None,
                               group: int = 1,
                               layer_inputs: Optional[list] = None) -> torch.Tensor:
    """K6 as the chain of standalone kernels, seven launches a layer and
    shard, on a stream a shard (any mesh): the route of a mesh over two
    cards; on one card `chip_smoke.py` holds the persistent kernel
    bit-identical to it and `tools/torch_kernel_bench.py` times it beside
    it. CPU tensors run the twins."""
    return _step_tp(KERNELS, params, x, dims, pos, kv_cache, kv_valid, anc, group, layer_inputs)


def co_located(mesh) -> bool:
    """Whether both tp shards of ``mesh`` live on one CUDA card, so that
    `fused_decode_step_tp` takes the persistent kernel."""
    d0, d1 = mesh.devices
    return d0 == d1 and d0.type == "cuda"


@functools.lru_cache(maxsize=16)
def _step_tp_blocks(device: torch.device, nt: int, cluster: int, smem: int) -> int:
    """K6's persistent grid: the resident clusters the occupancy query
    allows for its kernel, times the cluster."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        code = cuda.library().decode_step_tp_occupancy(nt, cluster, smem, ctypes.byref(n))
    cuda.check(code, "decode_step_tp occupancy")
    if n.value < 1:
        raise RuntimeError(f"tp decode step: no cluster of {cluster} blocks with {smem} bytes "
                           f"of shared memory is resident on {device}")
    return n.value * cluster


def _persistent_step_tp(params, x, dims, pos: int, kv_cache, kv_valid, anc, group: int,
                        layer_inputs: Optional[list], trace: Optional[list] = None):
    """One launch of K6's persistent kernel, both shards on x's card."""
    dev = x.device
    M, D = x.shape
    shards, caches = params["shards"], kv_cache["shards"]
    L, H = len(shards[0]), dims.heads
    F = 2 * shards[0][0]["mlp"]["c_fc"]["scale"].shape[0]
    Dl = D // 2
    S = caches[0]["k"].shape[2]
    valid, a = per_rank(kv_valid, params["mesh"].devices)[0], None
    checks = [("x", x, torch.bfloat16, (M, D)), ("kv_valid", valid, torch.bool, (M, S))]
    checks += [(f"shard {t}'s {k} cache", c[k], torch.bfloat16, (L, M, S, Dl))
               for t, c in enumerate(caches) for k in "kv"]
    if group > 1:
        if M % group:
            raise ValueError(f"fused_decode_step_tp: {M} rows are not groups of {group}")
        a = per_rank(anc, params["mesh"].devices)[0]
        checks.append(("anc", a, torch.int32, (M, S)))
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_decode_step_tp: {name} must be contiguous, 16-byte aligned "
                             f"{dtype} {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if L > STEP_MAX_LAYERS:
        raise ValueError(f"fused_decode_step_tp: the kernel takes at most {STEP_MAX_LAYERS} "
                         f"layers, got {L}")
    sh = step_tp_shape(M, D, F)
    blocks = _step_tp_blocks(dev, -(-M // 8), sh.cluster, sh.smem)
    plan = step_tp_plan(M, D, H, F, S, pos, blocks)
    table = _layer_table(list(zip(*shards)), dev,
                         ((3 * Dl, D), (D, Dl), (F // 2, D), (D, F // 2)), D, False,
                         "fused_decode_step_tp")
    bar = step_barrier(dev)
    xslots = 2 if layer_inputs is None else L + 1
    bf16 = torch.bfloat16
    xs = torch.empty((xslots, M, D), dtype=bf16, device=dev)
    qkv = torch.empty((2, M, 3 * Dl), dtype=bf16, device=dev)
    att = torch.empty((2, M, Dl), dtype=bf16, device=dev)
    xb = torch.empty((M, D), dtype=bf16, device=dev)
    h = torch.empty((2, M, F // 2), dtype=bf16, device=dev)
    stamps = None
    if trace is not None:
        stamps = torch.zeros((plan.blocks, L, STEP_MARKS), dtype=torch.int64, device=dev)
        trace.append(stamps)
    with torch.cuda.device(dev):
        code = cuda.library().decode_step_tp_launch(
            table.data_ptr(), x.data_ptr(), xs.data_ptr(), xslots, qkv.data_ptr(),
            att.data_ptr(), xb.data_ptr(), h.data_ptr(), caches[0]["k"].data_ptr(),
            caches[0]["v"].data_ptr(), caches[1]["k"].data_ptr(), caches[1]["v"].data_ptr(),
            valid.data_ptr(), None if a is None else a.data_ptr(), bar.data_ptr(),
            None if stamps is None else stamps.data_ptr(), L, M, D, H, F, S, pos, group,
            1.0 / math.sqrt(HEAD_DIM), *plan, cuda.stream_ptr(x))
    cuda.check(code, "decode_step_tp")
    if layer_inputs is not None:
        layer_inputs.extend((t, t) for t in (x, *xs[1:]))
    return xs[L % xslots]


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
    shards' inputs, and the shards' outputs last (on one card both entries
    are the one residual stream). CPU tensors run the twins; with both
    shards on one card, ONE launch of the persistent kernel
    (``fused_decode_step_tp.launches``); on two cards the chain
    (`fused_decode_step_tp_chain`). The module docstring says why."""
    cuda.refuse_grad("fused_decode_step_tp", params, x, kv_cache)
    if x.device.type == "cpu" or not co_located(params["mesh"]):
        return fused_decode_step_tp_chain(params, x, dims, pos, kv_cache, kv_valid, anc, group,
                                          layer_inputs)
    _check_step_tp(params, x, dims, kv_cache, group, anc)
    h = _persistent_step_tp(params, x, dims, pos, kv_cache, kv_valid, anc, group, layer_inputs)
    cuda.count(fused_decode_step_tp)
    return h


fused_decode_step_tp.launches = 0


# the JAX package's name of the entry (its shard_map over the mesh)
tp_decode_step = fused_decode_step_tp
