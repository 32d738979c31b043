"""The port's device mesh and the tensor-parallel splits of the GPT-2 stack
and of the DiT (counterpart of `indextts_tpu/parallel/mesh.py` and of
`indextts_tpu/ops/pallas/decode_step_tp.py::gpt_tp_layout` /
`h_partition_specs`).

A `Mesh` is dp x sp x tp ranks over an explicit sequence of torch devices,
row-major: rank (d, s, t) on ``devices[(d * sp + s) * tp + t]``. Nothing is
inferred and nothing falls back: a rank names a device this machine has,
and two ranks share a card only when the caller names the same device
twice. Co-located ranks run on their own streams of that card, each with
its own shard of the weights and cache and its own partial buffers, exactly
as on two cards.

- dp: the long-form batch's rows (`batch_sharding`); every dp rank holds the
  whole model on its devices (`replicated`) and decodes and synthesizes its
  rows;
- tp: the heads and the MLP hidden of the GPT-2 stack (`shard_gpt2_tp`) and
  of the DiT (`shard_dit`); each row-parallel product is an f32 partial,
  summed on the tp group's rank 0 (`nn.dense_partial` / `nn.dense_reduce`:
  what XLA's all-reduce does on the TPU; a plain add on one card, a peer
  copy on two). The tp=2 int8 decode kernel K6 reduces inside the kernel
  (`csrc/tp_allreduce.cu` on two cards), for which `make_mesh` enables
  peer access within a tp group;
- sp: the DiT's time axis (`seq_sharding`): each rank holds a block of
  frames, attends its query rows against the gathered k and v, and reads a
  halo of frames from its neighbours for the WaveNet head's convolutions.
  The GPT runs on the tp ranks of sp rank 0, as GSPMD replicates it over
  sp.

`shard_gpt2_tp` is the Megatron split of the GPT-2 ``h`` stack (float, int8
"q" or int4 "q4" weights) in the port's (out, in) layout (the JAX package
shards the (in, out) layout the same way on the other axis):

- c_attn, column-parallel: shard t holds the rows q[t*D/tp:(t+1)*D/tp] |
  k[...] | v[...] (its heads, head-aligned) with their scales and biases;
- attn c_proj and mlp c_proj, row-parallel: the contraction columns of the
  shard's part, with the full per-channel scale and bias (they apply after
  the reduce). An int4 shard holds its columns re-packed on its own nibble
  grouping (`nn.int4_halfspan` of its width): the same values, and where
  the shard's width is a multiple of 640 (the GPT at tp=2) the same bytes
  as a cut of the packed row on whole 640-column groups, as the JAX spec
  cuts it;
- c_fc, column-parallel: the shard's part of the output rows with their
  scales and biases;
- the LayerNorms replicated.

Each shard's tensors live on its rank's device; ``ln_f`` (and every other
UnifiedVoice parameter) stays on rank 0's. `shard_dit` splits the DiT's
transformer the same way (wqkv and ff.w1 / ff.w3 column-parallel, attn.wo
and ff.w2 row-parallel, the adaptive norms replicated) and copies the rest
of the DiT to every sp rank.

`Replicated` holds a decode input that every rank reads (``kv_valid``, the
beam ancestry map) on each of the mesh's devices, as shard_map replicates
it; the engines update the copies in place, so the step copies no mask or
map between the cards.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from indextts_tpu_torch import nn
from indextts_tpu_torch.nn import Params

TP = 2      # the tp width of the decode kernel K6 (ops/decode_step_tp.py)


class Mesh:
    """dp x sp x tp ranks over explicit devices (rank (d, s, t) on
    ``devices[(d * sp + s) * tp + t]``); the rank streams are made at first
    use on the card."""

    def __init__(self, devices: Tuple[torch.device, ...], dp: int = 1, sp: int = 1):
        self.devices = tuple(devices)
        if dp < 1 or sp < 1 or not self.devices or len(self.devices) % (dp * sp):
            raise ValueError(f"Mesh: {len(self.devices)} devices for dp={dp} x sp={sp}")
        self.dp, self.sp = dp, sp
        self._streams = None
        self._subs: Dict[tuple, "Mesh"] = {}

    @property
    def tp(self) -> int:
        return len(self.devices) // (self.dp * self.sp)

    def device(self, d: int = 0, s: int = 0, t: int = 0) -> torch.device:
        """Rank (d, s, t)'s device."""
        return self.devices[(d * self.sp + s) * self.tp + t]

    def streams(self) -> List["torch.cuda.Stream"]:
        """One CUDA stream per rank, on the rank's device."""
        if self._streams is None:
            self._streams = [torch.cuda.Stream(device=d) for d in self.devices]
        return self._streams

    def _sub(self, key: tuple, devices: Tuple[torch.device, ...], sp: int) -> "Mesh":
        if key not in self._subs:
            self._subs[key] = Mesh(devices, 1, sp)
        return self._subs[key]

    def dp_mesh(self, d: int = 0) -> "Mesh":
        """The sp x tp ranks of dp rank ``d`` as a dp=1 mesh (this mesh when
        dp is 1), made once."""
        if self.dp == 1:
            return self
        n = self.sp * self.tp
        return self._sub(("dp", d), self.devices[d * n:(d + 1) * n], self.sp)

    def tp_mesh(self, d: int = 0, s: int = 0) -> "Mesh":
        """The tp ranks of (d, s) as a dp=1, sp=1 mesh (this mesh when dp
        and sp are 1), made once: the GPT's mesh."""
        if self.dp == 1 and self.sp == 1:
            return self
        i = (d * self.sp + s) * self.tp
        return self._sub(("tp", d, s), self.devices[i:i + self.tp], 1)

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, sp={self.sp}, tp={self.tp}, "
                f"devices={[str(d) for d in self.devices]})")


def replicated(mesh: Mesh) -> List[slice]:
    """What each rank holds of a replicated array: all of it (one slice per
    rank, in rank order); the JAX package's ``NamedSharding(mesh, P())``."""
    return [slice(None)] * len(mesh.devices)


def batch_sharding(mesh: Mesh, rows: int) -> List[slice]:
    """The rows of a batch of ``rows`` that each dp rank holds (the JAX
    package's ``P("dp")``): the batch padded to a multiple of dp, then cut
    into dp equal blocks; rows past ``rows`` are padding (the pipeline
    repeats row 0 there and drops them)."""
    per = -(-rows // mesh.dp)
    return [slice(d * per, (d + 1) * per) for d in range(mesh.dp)]


def seq_sharding(mesh: Mesh, frames: int) -> Optional[List[slice]]:
    """The frames of a (B, ``frames``, C) array that each sp rank holds (the
    JAX package's ``P("dp", "sp", None)``): the time axis padded to a
    multiple of sp, then cut into sp equal blocks. None when sp is 1:
    callers skip sequence parallelism."""
    if mesh.sp == 1:
        return None
    per = -(-frames // mesh.sp)
    return [slice(s * per, (s + 1) * per) for s in range(mesh.sp)]


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


def torch_device(d: Union[str, torch.device]) -> torch.device:
    """A device name as the mesh keys it (``cuda`` is ``cuda:0``)."""
    d = torch.device(d)
    return torch.device("cuda", 0 if d.index is None else d.index) if d.type == "cuda" else d


def make_mesh(devices: Union[int, Sequence[Union[str, torch.device]]],
              tp: Optional[int] = None, dp: Optional[int] = None, sp: int = 1) -> Mesh:
    """A dp x sp x tp mesh over ``devices``, one per rank in row-major
    order (an int n names cuda:0 .. cuda:n-1, and raises ValueError where
    the machine has fewer cards: the JAX package's ``make_mesh(n)`` takes
    the first n of the devices it finds instead). ``tp`` defaults to the
    largest of 4 and 2 that divides the rank count over sp (the JAX
    package's rule without its 8, which no GPT head count here divides),
    else 1; ``dp`` to the ranks left over. Raises ValueError for a device
    this machine does not have or a rank count other than dp * sp * tp,
    RuntimeError when two distinct cards of a tp group cannot reach each
    other's memory."""
    if isinstance(devices, int):
        devices = [f"cuda:{i}" for i in range(devices)]
    devs = tuple(torch_device(d) for d in devices)
    n = len(devs)
    if sp < 1 or n == 0 or n % sp:
        raise ValueError(f"make_mesh: sp={sp} does not divide the {n} ranks named")
    if tp is None:
        tp = next((c for c in (4, 2) if (n // sp) % c == 0 and (dp is None or dp * sp * c == n)),
                  1)
    if dp is None:
        dp = n // (sp * tp) if tp >= 1 and n % (sp * tp) == 0 else 0
    if tp < 1 or dp < 1 or dp * sp * tp != n:
        raise ValueError(f"make_mesh: {n} devices for dp={dp} x sp={sp} x tp={tp}; name one "
                         "device per rank (the same device twice co-locates two ranks)")
    kinds = {d.type for d in devs}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"make_mesh: the ranks must all be CPU or all CUDA devices, got {devs}")
    mesh = Mesh(devs, dp, sp)
    if "cuda" in kinds:
        count = torch.cuda.device_count()
        missing = [str(d) for d in devs if d.index >= count]
        if missing:
            raise ValueError(f"make_mesh: {missing} named, but this machine has {count} CUDA "
                             "device(s); name the same device twice to co-locate ranks")
        for d in range(dp):
            for s in range(sp):
                _enable_peer_access(sorted({x.index for x in mesh.tp_mesh(d, s).devices}))
    return mesh


def _enable_peer_access(indices: List[int]) -> None:
    """Peer access between every pair of distinct cards of a tp group (the
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


def place(p: Params, dev) -> Params:
    """A tree of tensors (dicts and lists) moved to ``dev`` (a tensor
    already there is kept, not copied)."""
    if isinstance(p, torch.Tensor):
        return p.to(dev)
    if isinstance(p, dict):
        return {k: place(v, dev) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return type(p)(place(v, dev) for v in p)
    return p


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
    per-output-channel scale and the bias stay whole. int4 columns are
    re-packed on the shard's own nibble grouping (the module docstring)."""
    w = next(k for k in ("q", "q4", "weight") if k in p)
    out = {k: v.to(dev) for k, v in p.items() if k != w}
    full = nn.unpack_int4(p[w]) if w == "q4" else p[w]
    K = full.shape[1]
    part = full[:, t * K // tp:(t + 1) * K // tp]
    out[w] = (nn.pack_int4(part) if w == "q4" else part).contiguous().to(dev)
    return out


def shard_gpt2_tp(gpt: Params, mesh: Mesh, kernel: bool = True) -> Params:
    """A GPT-2 tree (float, int8 or int4 weights) -> its tensor-parallel
    tree over ``mesh``'s tp ranks (`Mesh.tp_mesh`): ``{"shards": [layers of
    rank t], "ln_f", "mesh", "kernel"}``, each rank's per-layer trees on its
    device in the layout the module docstring gives. ``kernel`` lets the
    decode take K6 where it applies (tp=2, int8 weights, the bf16 cache,
    at most 24 rows; `engine/decode.py::decode_route`), as the JAX
    pipeline's INDEXTTS_TP_DECODE=kernel does; otherwise every step is the
    plain one on the shards (the JAX package's GSPMD decode)."""
    if is_tp(gpt):
        raise ValueError("shard_gpt2_tp: the tree is sharded already")
    mesh = mesh.tp_mesh()
    tp = mesh.tp
    c_attn = gpt["h"][0]["attn"]["c_attn"]
    rows = next(v for k, v in c_attn.items() if k in ("q", "q4", "weight")).shape[0]
    if rows % (3 * tp):
        raise ValueError(f"shard_gpt2_tp: {rows // 3} channels do not split over tp={tp}")
    shards = []
    for t, dev in enumerate(mesh.devices):
        shards.append([{
            "ln_1": place(lp["ln_1"], dev),
            "ln_2": place(lp["ln_2"], dev),
            "attn": {"c_attn": _rows(lp["attn"]["c_attn"], t, tp, 3, dev),
                     "c_proj": _cols(lp["attn"]["c_proj"], t, tp, dev)},
            "mlp": {"c_fc": _rows(lp["mlp"]["c_fc"], t, tp, 1, dev),
                    "c_proj": _cols(lp["mlp"]["c_proj"], t, tp, dev)},
        } for lp in gpt["h"]])
    return {"shards": shards, "ln_f": gpt["ln_f"], "mesh": mesh, "kernel": kernel}


def is_dit_sharded(dit: Params) -> bool:
    """Whether a DiT tree is the one of `shard_dit`."""
    return "mesh" in dit


def shard_dit(dit: Params, mesh: Mesh) -> Params:
    """A DiT tree -> its tree over a dp=1 mesh of sp x tp ranks:
    ``{"sp": [the DiT of sp rank s], "mesh"}``. Sp rank s's DiT lives on
    rank (s, 0)'s device, its transformer as ``{"shards": [layers of tp
    rank t, on rank (s, t)'s device], "norm"}``: wqkv (q | k | v, each cut
    head-aligned), ff.w1 and ff.w3 column-parallel, attn.wo and ff.w2
    row-parallel, the adaptive norms replicated."""
    if is_dit_sharded(dit):
        raise ValueError("shard_dit: the tree is sharded already")
    if mesh.dp != 1:
        raise ValueError(f"shard_dit: takes one dp rank's mesh (Mesh.dp_mesh), got {mesh}")
    tp, layers = mesh.tp, dit["transformer"]["layers"]
    rest = {k: v for k, v in dit.items() if k != "transformer"}
    blocks = []
    for s in range(mesh.sp):
        dev0 = mesh.device(0, s, 0)
        shards = [[{
            "attention_norm": place(lp["attention_norm"], mesh.device(0, s, t)),
            "ffn_norm": place(lp["ffn_norm"], mesh.device(0, s, t)),
            "attn": {"wqkv": _rows(lp["attn"]["wqkv"], t, tp, 3, mesh.device(0, s, t)),
                     "wo": _cols(lp["attn"]["wo"], t, tp, mesh.device(0, s, t))},
            "ff": {"w1": _rows(lp["ff"]["w1"], t, tp, 1, mesh.device(0, s, t)),
                   "w3": _rows(lp["ff"]["w3"], t, tp, 1, mesh.device(0, s, t)),
                   "w2": _cols(lp["ff"]["w2"], t, tp, mesh.device(0, s, t))},
        } for lp in layers] for t in range(tp)]
        blocks.append({**place(rest, dev0),
                       "transformer": {"shards": shards,
                                       "norm": place(dit["transformer"]["norm"], dev0)}})
    return {"sp": blocks, "mesh": mesh}
