"""The port's device mesh and the tensor-parallel split of the GPT-2 stack
(counterpart of the tp part of `indextts_tpu/parallel/mesh.py` and of
`indextts_tpu/ops/pallas/decode_step_tp.py::gpt_tp_layout` /
`h_partition_specs`).

A `Mesh` is dp=1 by tp=2: an explicit sequence of torch devices, one per tp
rank. Nothing is inferred and nothing falls back: a rank names a device
this machine has, and two ranks share a card only when the caller names the
same device twice. Co-located shards run on two streams of that card, each
with its own half of the weights and cache and its own partial buffers,
exactly as on two cards; the exchange between them is a kernel reading the
peer's buffer through its device pointer (`csrc/tp_allreduce.cu`), local
memory on one card and peer (NVLink) memory on two, for which `make_mesh`
enables peer access. The dp axis (long-form batching) and sequence
parallelism are not ported and raise.

`shard_gpt2_tp` is the Megatron split of the int8 GPT-2 ``h`` stack in the
port's (out, in) layout (the JAX package shards the (in, out) layout the same
way on the other axis):

- c_attn, column-parallel: shard t holds the rows q[t*D/2:(t+1)*D/2] |
  k[...] | v[...] (its 10 of 20 heads, head-aligned) with their scales and
  biases;
- attn c_proj and mlp c_proj, row-parallel: the contraction columns of the
  shard's half, with the full per-channel scale and bias (they apply after
  the all-reduce);
- c_fc, column-parallel: the shard's half of the output rows with their
  scales and biases;
- the LayerNorms replicated.

Each shard's tensors live on its rank's device; ``ln_f`` (and every other
UnifiedVoice parameter) stays on rank 0's.

`Replicated` holds a decode input that every rank reads (``kv_valid``, the
beam ancestry map) on each of the mesh's devices, as shard_map replicates
it; the engines update the copies in place, so the step copies no mask or
map between the cards.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

from indextts_tpu_torch.nn import Params

TP = 2      # the tp width of the decode kernel K6 (ops/decode_step_tp.py)


class Mesh:
    """dp=1 x tp mesh over explicit devices (rank t on ``devices[t]``); the
    shard streams are made at first use on the card."""

    def __init__(self, devices: Tuple[torch.device, ...]):
        self.devices = devices
        self._streams = None

    @property
    def tp(self) -> int:
        return len(self.devices)

    def streams(self) -> List["torch.cuda.Stream"]:
        """One CUDA stream per rank, on the rank's device."""
        if self._streams is None:
            self._streams = [torch.cuda.Stream(device=d) for d in self.devices]
        return self._streams

    def __repr__(self) -> str:
        return f"Mesh(dp=1, tp={self.tp}, devices={[str(d) for d in self.devices]})"


def _moved(x, device: torch.device):
    """An index or value moved to ``device``: tensors (also inside tuples);
    anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        return tuple(_moved(i, device) for i in x)
    return x


class Replicated:
    """One tensor held on every device of a mesh: one copy per distinct
    device (co-located ranks share it). Indexing and in-place assignment
    apply to every copy, with index tensors and values moved to the copy's
    device (the beam reorder: B*K ints); `on` gives a rank's copy."""

    def __init__(self, copies: Dict[torch.device, torch.Tensor]):
        self.copies = copies

    @classmethod
    def of(cls, t: torch.Tensor, mesh: "Mesh") -> "Replicated":
        return cls({d: t.to(d) for d in dict.fromkeys(mesh.devices)})

    def on(self, device: torch.device) -> torch.Tensor:
        return self.copies[device]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Replicated":
        return Replicated({d: fn(t) for d, t in self.copies.items()})

    def __getitem__(self, idx) -> "Replicated":
        return Replicated({d: t[_moved(idx, d)] for d, t in self.copies.items()})

    def __setitem__(self, idx, value) -> None:
        for d, t in self.copies.items():
            t[_moved(idx, d)] = value.on(d) if isinstance(value, Replicated) \
                else _moved(value, d)


def _device(d: Union[str, torch.device]) -> torch.device:
    d = torch.device(d)
    return torch.device("cuda", 0 if d.index is None else d.index) if d.type == "cuda" else d


def make_mesh(devices: Union[int, Sequence[Union[str, torch.device]]], tp: int = TP,
              dp: int = 1, sp: int = 1) -> Mesh:
    """A dp=1 x tp=2 mesh over ``devices``, one per tp rank (an int n names
    cuda:0 .. cuda:n-1). Raises ValueError for a device this machine does not
    have or a rank count other than dp * tp, RuntimeError when two distinct
    cards cannot reach each other's memory, NotImplementedError for dp > 1,
    sp > 1 or tp other than 2."""
    if dp != 1:
        raise NotImplementedError(f"make_mesh(dp={dp}): the dp axis needs the long-form batched "
                                  "decode, which is not ported (ROADMAP.md, queue 1)")
    if sp != 1:
        raise NotImplementedError(f"make_mesh(sp={sp}): sequence parallelism of the DiT is not "
                                  "ported (ROADMAP.md, queue 1)")
    if tp != TP:
        raise NotImplementedError(f"make_mesh(tp={tp}): the tensor-parallel decode kernel K6 "
                                  f"takes tp={TP}")
    if isinstance(devices, int):
        devices = [f"cuda:{i}" for i in range(devices)]
    devs = tuple(_device(d) for d in devices)
    if len(devs) != dp * tp:
        raise ValueError(f"make_mesh: {len(devs)} devices for dp={dp} x tp={tp}; name one "
                         "device per rank (the same device twice co-locates two shards)")
    kinds = {d.type for d in devs}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"make_mesh: the ranks must all be CPU or all CUDA devices, got {devs}")
    if "cuda" in kinds:
        n = torch.cuda.device_count()
        missing = [str(d) for d in devs if d.index >= n]
        if missing:
            raise ValueError(f"make_mesh: {missing} named, but this machine has {n} CUDA "
                             "device(s); name the same device twice to co-locate the shards")
        _enable_peer_access(sorted({d.index for d in devs}))
    return Mesh(devs)


def _enable_peer_access(indices: List[int]) -> None:
    """Peer access between every pair of distinct cards of the mesh (the
    all-reduce kernel reads the peer's partial); raises if a pair cannot."""
    if len(indices) < 2:
        return
    from indextts_tpu_torch.ops import cuda

    for a in indices:
        for b in indices:
            if a == b:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(f"make_mesh: cuda:{a} cannot access the memory of cuda:{b} "
                                   "(no peer access between the two cards)")
            cuda.check(cuda.library().tp_enable_peer_access(a, b), "tp_enable_peer_access")


def is_tp(gpt: Params) -> bool:
    """Whether a GPT-2 tree is the tensor-parallel one of `shard_gpt2_tp`."""
    return "shards" in gpt


def _rows(p: Params, t: int, tp: int, groups: int, dev) -> Params:
    """Column-parallel: shard t's rows of each of ``groups`` equal blocks of
    the output axis, for the weight and its scale and bias alike."""
    def cut(a):
        n = a.shape[0] // groups
        blocks = a.reshape(groups, n, *a.shape[1:])[:, t * n // tp:(t + 1) * n // tp]
        return blocks.reshape(groups * (n // tp), *a.shape[1:]).contiguous().to(dev)
    return {k: cut(v) for k, v in p.items()}


def _cols(p: Params, t: int, tp: int, dev) -> Params:
    """Row-parallel: shard t's contraction columns of the weight; the
    per-output-channel scale and the bias stay whole."""
    w = "q" if "q" in p else "weight"
    K = p[w].shape[1]
    out = {k: v.to(dev) for k, v in p.items() if k != w}
    out[w] = p[w][:, t * K // tp:(t + 1) * K // tp].contiguous().to(dev)
    return out


def shard_gpt2_tp(gpt: Params, mesh: Mesh) -> Params:
    """The int8 (or float) GPT-2 tree -> its tensor-parallel tree:
    ``{"shards": [layers of rank 0, layers of rank 1], "ln_f", "mesh"}``,
    each rank's per-layer trees on its device in the layout the module
    docstring gives. int4 trees raise (their nibble groups cut along the
    contraction axis are not ported)."""
    if is_tp(gpt):
        raise ValueError("shard_gpt2_tp: the tree is sharded already")
    if "q4" in gpt["h"][0]["attn"]["c_attn"]:
        raise NotImplementedError("tensor-parallel int4 weights are not ported (the JAX "
                                  "package's GSPMD int4 decode; ROADMAP.md, queue 1)")
    tp = mesh.tp
    shards = []
    for t, dev in enumerate(mesh.devices):
        shards.append([{
            "ln_1": {k: v.to(dev) for k, v in lp["ln_1"].items()},
            "ln_2": {k: v.to(dev) for k, v in lp["ln_2"].items()},
            "attn": {"c_attn": _rows(lp["attn"]["c_attn"], t, tp, 3, dev),
                     "c_proj": _cols(lp["attn"]["c_proj"], t, tp, dev)},
            "mlp": {"c_fc": _rows(lp["mlp"]["c_fc"], t, tp, 1, dev),
                    "c_proj": _cols(lp["mlp"]["c_proj"], t, tp, dev)},
        } for lp in gpt["h"]])
    return {"shards": shards, "ln_f": gpt["ln_f"], "mesh": mesh}
