"""Fused GPT-2 decode step on quantized weights: kernel K1 and its plain twin.

`fused_decode_step` is the port of `indextts_tpu/ops/pallas/decode_step.py::
fused_decode_step` at ``group=1`` and with the beam ancestry map at
``group=K``, in the TPU kernel's four configurations: int8 or nibble-packed
int4 weights (its ``W4`` variant, `nn.quantize_dense_int4`) against the
flat bf16 (L, B, S, D) cache or the flat int8 cache with its packed bf16
scale rows ``"kvs"`` (its ``KVQ`` variant, `gpt2.kv_quantize_flat`). As on
the TPU, it is one kernel over the layers: `csrc/decode_step.cuh`, one
persistent launch a step, whose blocks walk the layers in phases separated
by grid-wide barriers, each layer's weights streamed ahead across them
(`step_plan` is its launch plan). A layer's phases:

- ``ln_1`` + qkv projection (the GEMV of `csrc/gemv_core.cuh`, with the
  LayerNorm prologue);
- attention over the cache plus the current token, which also writes the
  token's k and v into the cache at ``pos`` (quantized for the int8 cache;
  `csrc/decode_attention_core.cuh`: the positions split over a thread-block
  cluster, merged on its rank 0);
- attention out-projection + residual;
- ``ln_2`` + fc + gelu_new, then the MLP projection + residual.

``ln_f`` is applied after the layers, outside the kernel, as in the TPU
kernel's wrapper. The rounding chain is the TPU kernel's (see the CUDA
sources); `fused_decode_step_plain` repeats it in plain PyTorch with the
same split of the positions into chunks of `CHUNK`. The chain of the
standalone kernels, five launches a layer (K7a / K7b / the int4 GEMVs and
`decode_attention`, over the same two core headers), stays as
`fused_decode_step_chain`: it gives the same bits and is held against the
persistent kernel and timed beside it. The kernel's TP variant runs K6 with
both tp shards on one card (`ops/decode_step_tp.py`); `step_tp_plan` is its
plan.

Unlike the JAX kernel, which returns the new k/v rows for the caller to
write, the cache is updated in place (the port's cache is always updated in
place: the decode loop never holds two copies of it).

The step takes its token x, its non-int8 cache and the tree's biases and
LayerNorm vectors at one 16-bit type E (`STEP_DTYPES`: bf16, or fp16 for
``IndexTTS2(use_fp16=True)`` with a quantization) and computes the TPU
kernel's bf16 body on them: x is rounded to bf16 once, at entry; each fp16
cache element is rounded to bf16 as it is read, and the token's k / v rows
are written back at E; the biases and LayerNorm vectors enter the f32
arithmetic exactly. The last layer's bf16 output is cast to E, then ``ln_f``
applies at E. So an fp16 step returns what the bf16 step returns on bf16
copies of its inputs, cast to fp16 before ``ln_f``. The int8 cache and its
bf16 scale rows are the same at either E. The twin converts where the
kernel converts (`decode_layer`, `decode_attention_plain`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from indextts_tpu_torch import nn
from indextts_tpu_torch.models.gpt.gpt2 import SCALE_LANES, kv_quantize_flat
from indextts_tpu_torch.ops import cuda
from indextts_tpu_torch.ops.int8 import (GEMV_WARPS, MAX_ROWS, SMEM_MAX, SMS, gemv_plan,
                                         int4_matvec, int4_matvec_plain, int4_mlp,
                                         int4_mlp_plain, int8_matvec, int8_matvec_plain,
                                         int8_mlp, int8_mlp_plain)

CHUNK = 64          # positions a chunk of `decode_attention`: the rounding unit
# the 16-bit types K1 and K6 take their activations, non-int8 cache, biases and
# LayerNorm vectors at (the kernels' staging holds 2-byte cache elements)
STEP_DTYPES = (torch.bfloat16, torch.float16)
HEAD_DIM = 64       # the CUDA kernel's head dim
NEG = -1e9          # the TPU kernel's mask value

# The attention kernel's launch plan (`csrc/decode_attention.cu`, whose
# header says why).
MAX_HEADS = 8       # heads a block (a warp each for p.v)
MAX_CLUSTER = 8     # blocks of a cluster: the portable size
MAX_STAGES = 4      # chunk stages of a block's ring
SLOT_BYTES = 68 * 4  # a (chunk, head) partial: m, l, 2 pad, o[64] in f32
MISC_BYTES = 1024
BLOCKS_PER_SM = 3   # the kernel's __launch_bounds__ minimum
SM_SMEM = 228 * 1024  # an SM's shared memory, of which the card reserves 1 KB a block


class AttnPlan(NamedTuple):
    heads: int    # heads a block
    chunks: int   # 64-position chunks a block, at most
    cluster: int  # blocks a (row, head span): rank k takes chunks [k chunks, (k + 1) chunks)
    stages: int   # chunk stages of the block's ring in shared memory
    smem: int     # dynamic shared-memory bytes a block


def _attention_smem(heads: int, chunks: int, cluster: int, stages: int, kvq: bool) -> int:
    """Shared-memory bytes of a block: the kernel's `layout`
    (`csrc/decode_attention.cu`) in the same formula."""
    stage = 2 * CHUNK * heads * HEAD_DIM * (1 if kvq else 2)
    return (stages * stage + cluster * chunks * heads * SLOT_BYTES
            + (chunks * CHUNK * heads * 4 if kvq else 0) + chunks * CHUNK * 4
            + 4 * heads * HEAD_DIM * 2 + MISC_BYTES)


@functools.lru_cache(maxsize=4096)   # a decode step asks for the same plan in every layer
def attention_plan(M: int, H: int, pos: int, kvq: bool = False, sms: int = SMS,
                   heads: Optional[int] = None) -> AttnPlan:
    """The launch plan of `decode_attention_launch` for M rows of H heads at
    ``pos`` (int8 cache: ``kvq``). The ceil(pos / 64) chunks of a row are
    split over a cluster of at most 8 blocks, ``chunks`` a block. A block
    takes the fewest heads (a divisor of H, at most 8) whose grid of M * H /
    heads * cluster blocks is resident on the ``sms`` SMs at once (three
    blocks an SM, fewer where shared memory allows fewer), or else runs in
    the fewest waves; its ring holds as many of its chunks as keep that.
    ``heads`` fixes the heads a block instead (another plan, to time it or
    to hold its bits against this one's). The merge order (chunks 0, 1, ...
    of the row) does not depend on the plan. Raises ValueError for a shape
    no plan fits."""
    n = -(-pos // CHUNK)
    chunks = max(1, -(-n // MAX_CLUSTER))
    cluster = -(-n // chunks) if n else 1
    if heads is not None and not (1 <= heads <= MAX_HEADS and H % heads == 0):
        raise ValueError(f"decode_attention: {heads} heads a block is not a divisor of "
                         f"{H} of at most {MAX_HEADS}")
    candidates = (heads,) if heads is not None else range(1, min(H, MAX_HEADS) + 1)
    best = None
    for heads in candidates:
        if H % heads:
            continue
        blocks = M * (H // heads) * cluster
        for stages in range(min(chunks, MAX_STAGES), 0, -1):
            smem = _attention_smem(heads, chunks, cluster, stages, kvq)
            resident = sms * min(BLOCKS_PER_SM, SM_SMEM // (smem + 1024))
            if smem <= SMEM_MAX and (resident >= blocks or stages == 1):
                break
        if smem > SMEM_MAX:
            continue
        waves = -(-blocks // max(1, resident))
        if best is None or waves < best[0]:
            best = (waves, AttnPlan(heads, chunks, cluster, stages, smem))
    if best is None:
        raise ValueError(f"decode_attention: no launch plan takes {H} heads at pos {pos} "
                         f"({SMEM_MAX} bytes of shared memory)")
    return best[1]


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_attention_plain(qkv: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                           kv_valid: torch.Tensor, pos: int, heads: int,
                           anc: Optional[torch.Tensor] = None, group: int = 1,
                           kvs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain twin of `decode_attention` (any device); writes the cache
    rows at ``pos`` in place like the kernel. A 16-bit cache of another type
    than bf16 (K1's fp16 instantiation) is read rounded to bf16 and written
    from bf16, as the persistent kernel reads and writes it."""
    M, D = qkv.shape[0], qkv.shape[1] // 3
    Dh, S, dev = D // heads, ck.shape[1], qkv.device
    bf16 = torch.bfloat16
    q = (qkv[:, :D].float() * (1.0 / math.sqrt(Dh))).to(bf16)
    kc, vc = qkv[:, D:2 * D], qkv[:, 2 * D:]
    n_chunks = -(-pos // CHUNK)
    G = n_chunks * CHUNK
    g = torch.arange(G, device=dev)
    gi = g.clamp(max=S - 1)
    rows = torch.arange(M, device=dev)[:, None]
    phys = rows.expand(M, G) if anc is None else (rows // group) * group + anc[:, gi].long()
    cur_phys = rows[:, 0] if anc is None else (rows[:, 0] // group) * group + anc[:, pos].long()
    # (M, G, D) values of each row's hypothesis (int8 -> bf16 is exact)
    ks, vs = ck[phys, gi[None, :]].to(bf16), cv[phys, gi[None, :]].to(bf16)
    # the slots kv_valid marks (of each position's physical row), below pos
    valid = kv_valid[phys, gi[None, :]] & (g[None, :] < pos)              # (M, G)
    s = (ks * q[:, None, :]).float().reshape(M, G, heads, Dh).sum(-1)     # bf16 products
    if kvs is not None:                      # the int8 cache: scores times k-scales
        scales = kvs[phys, gi[None, :]].float()                             # (M, G, 256)
        s = s * scales[..., :heads]
    s = torch.where(valid[..., None], s, NEG).reshape(M, n_chunks, CHUNK, heads)
    m_c = s.amax(2) if n_chunks else torch.full((M, 0, heads), NEG, device=dev)
    p = torch.where(valid.reshape(M, n_chunks, CHUNK, 1), torch.exp(s - m_c[:, :, None]), 0.0)
    l_c = p.sum(2)
    if kvs is not None:                      # the mass above stays unscaled
        half = SCALE_LANES // 2
        p = p * scales[..., half:half + heads].reshape(M, n_chunks, CHUNK, heads)
    o_c = (p.to(bf16)[..., None] * vs.reshape(M, n_chunks, CHUNK, heads, Dh)).float().sum(2)

    s_cur = (q * kc).float().reshape(M, heads, Dh).sum(-1)
    cur_valid = kv_valid[cur_phys, pos][:, None]
    s_cur = torch.where(cur_valid, s_cur, NEG)
    m = torch.full((M, heads), NEG, device=dev)
    if n_chunks:
        m = torch.maximum(m, m_c.amax(1))
    m = torch.maximum(m, s_cur)
    w = torch.exp(m_c - m[:, None])
    p_cur = torch.where(cur_valid, torch.exp(s_cur - m), 0.0)
    l = (l_c * w).sum(1) + p_cur
    o = (o_c * w[..., None]).sum(1) \
        + p_cur.to(bf16).float()[..., None] * vc.float().reshape(M, heads, Dh)
    if kvs is None:
        ck[:, pos], cv[:, pos] = kc, vc
    else:
        ck[:, pos], cv[:, pos], kvs[:, pos] = kv_quantize_flat(kc, vc, heads)
    return (o / l.clamp(min=1e-30)[..., None]).to(bf16).reshape(M, D)


def decode_attention(qkv: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     kv_valid: torch.Tensor, pos: int, heads: int,
                     anc: Optional[torch.Tensor] = None, group: int = 1,
                     kvs: Optional[torch.Tensor] = None,
                     plan: Optional[AttnPlan] = None) -> torch.Tensor:
    """K1's attention. qkv (M, 3D) bf16 of the current token; ck, cv (M, S, D),
    one layer of the cache (the token's k and v are written at ``pos``):
    bf16, or int8 with ``kvs`` (M, S, 256) bf16, the layer's packed scale
    rows (K1's KVQ variant; the row at ``pos`` is written too); kv_valid
    (M, S) bool; anc (M, S) int32 in-group ancestry for ``group`` > 1.
    ``plan`` replaces `attention_plan`'s launch plan (the kernel refuses one
    that does not fit the call; any plan gives the same bits).
    Returns (M, D) bf16. CPU tensors run the plain twin; CUDA tensors launch
    the kernel (``decode_attention.launches`` counts the bf16-cache launches,
    ``decode_attention.kvq_launches`` the int8-cache ones); anything else
    raises."""
    cuda.refuse_grad("decode_attention", qkv, ck, cv, kvs)
    if qkv.device.type == "cpu":
        return decode_attention_plain(qkv, ck, cv, kv_valid, pos, heads, anc, group, kvs)
    if qkv.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {qkv.device}")
    dev = qkv.device
    M, D3 = qkv.shape
    D = D3 // 3
    S = ck.shape[1]
    if D != heads * HEAD_DIM:
        raise ValueError(f"decode_attention: kernel takes head dim {HEAD_DIM}, got {D}/{heads}")
    if not 0 <= pos < S:
        raise ValueError(f"decode_attention: pos {pos} outside the cache of {S} slots")
    cache_dtype = torch.bfloat16 if kvs is None else torch.int8
    if kvs is not None and heads > SCALE_LANES // 2:
        raise ValueError(f"decode_attention: the int8 cache's scale row holds at most "
                         f"{SCALE_LANES // 2} heads, got {heads}")
    checks = [("qkv", qkv, torch.bfloat16, (M, 3 * D)), ("k cache", ck, cache_dtype, (M, S, D)),
              ("v cache", cv, cache_dtype, (M, S, D)), ("kv_valid", kv_valid, torch.bool, (M, S))]
    if kvs is not None:
        checks.append(("scale rows", kvs, torch.bfloat16, (M, S, SCALE_LANES)))
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous {dtype} {shape} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if name != "scale rows" and t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte aligned (the kernel "
                             f"reads it in 16-byte pieces)")
    if group > 1:
        if anc is None or anc.dtype != torch.int32 or tuple(anc.shape) != (M, S) \
                or anc.device != dev or not anc.is_contiguous() or M % group:
            raise ValueError(f"decode_attention: group={group} needs anc, contiguous int32 "
                             f"({M}, {S}) on {dev}")
    if plan is None:
        plan = attention_plan(M, heads, pos, kvs is not None, _sm_count(dev))
    out = torch.empty((M, D), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        code = cuda.library().decode_attention_launch(
            qkv.data_ptr(), ck.data_ptr(), cv.data_ptr(),
            None if kvs is None else kvs.data_ptr(), kv_valid.data_ptr(),
            anc.data_ptr() if group > 1 else None, None, None, out.data_ptr(), M, S, D,
            heads, pos, group, 1.0 / math.sqrt(HEAD_DIM), *plan, cuda.stream_ptr(qkv))
    cuda.check(code, "decode_attention")
    if kvs is None:
        cuda.count(decode_attention)
    else:
        cuda.count(decode_attention, "kvq_launches")
    return out


decode_attention.launches = 0
decode_attention.kvq_launches = 0


def _check_step(params, x, kv_cache, group: int, anc) -> None:
    c_attn = params["h"][0]["attn"]["c_attn"]
    if "q" not in c_attn and "q4" not in c_attn:
        raise ValueError("fused_decode_step takes int8 or int4 weights "
                         "(quantize_gpt2_int8 / quantize_gpt2_int4)")
    if x.dtype not in STEP_DTYPES:
        raise ValueError(f"fused_decode_step takes bf16 or fp16 activations, got {x.dtype}")
    float_cache = set(kv_cache) == {"k", "v"} and kv_cache["k"].dtype == x.dtype
    int8_cache = set(kv_cache) == {"k", "v", "kvs"} and kv_cache["k"].dtype == torch.int8
    if not (float_cache or int8_cache) or kv_cache["k"].ndim != 4:
        raise ValueError(f"fused_decode_step takes the flat (L, B, S, D) {x.dtype} cache (x's "
                         "type) or the flat int8 cache with its 'kvs' scale rows "
                         "(init_kv_cache), got "
                         f"{ {k: (t.dtype, tuple(t.shape)) for k, t in kv_cache.items()} }")
    B = x.shape[0]
    if B > MAX_ROWS:
        raise ValueError(f"fused_decode_step takes at most {MAX_ROWS} rows, got {B}")
    if group > 1 and anc is None:
        raise ValueError("fused_decode_step: group > 1 needs the ancestry map")


class StepOps(NamedTuple):
    """The operations of one layer: the int8 and the int4 GEMVs and the
    attention, as kernels (`KERNELS`) or as plain twins (`TWINS`)."""
    matvec: Callable
    mlp: Callable
    matvec4: Callable
    mlp4: Callable
    attention: Callable


def decode_layer(ops: StepOps, lp, x: torch.Tensor, heads: int, pos: int, ck: torch.Tensor,
                 cv: torch.Tensor, kv_valid: torch.Tensor, anc: Optional[torch.Tensor] = None,
                 group: int = 1, kvs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block of the step (before ``ln_f``) on one layer ``lp`` of the
    cache (ck, cv, and the int8 cache's scale rows kvs); the int8 or int4
    GEMVs of ``ops`` by the weight leaf the layer carries ("q" or "q4").
    Checks hold each layer of the kernel path against the twins on that
    layer's input. x of another 16-bit type is rounded to bf16 first (the
    kernel's entry), and the output is bf16."""
    x = x.to(torch.bfloat16)
    a, f = lp["attn"], lp["mlp"]
    w4 = "q4" in a["c_attn"]
    matvec, mlp, w = (ops.matvec4, ops.mlp4, "q4") if w4 else (ops.matvec, ops.mlp, "q")
    qkv = matvec(x, a["c_attn"][w], ln=(lp["ln_1"]["weight"], lp["ln_1"]["bias"]),
                 scale=a["c_attn"]["scale"], bias=a["c_attn"]["bias"])
    att = ops.attention(qkv, ck, cv, kv_valid, pos, heads, anc, group, kvs)
    x = matvec(att, a["c_proj"][w], scale=a["c_proj"]["scale"], bias=a["c_proj"]["bias"],
               residual=x)
    return mlp(x, f["c_fc"][w], f["c_fc"]["scale"], f["c_fc"]["bias"], f["c_proj"][w],
               ln=(lp["ln_2"]["weight"], lp["ln_2"]["bias"]), scale2=f["c_proj"]["scale"],
               bias2=f["c_proj"]["bias"], residual=x)


KERNELS = StepOps(int8_matvec, int8_mlp, int4_matvec, int4_mlp, decode_attention)
TWINS = StepOps(int8_matvec_plain, int8_mlp_plain, int4_matvec_plain, int4_mlp_plain,
                decode_attention_plain)


def _step(ops, params, x, heads: int, pos: int, kv_cache, kv_valid, anc, group: int,
          layer_inputs: Optional[list]) -> torch.Tensor:
    kvs, dtype = kv_cache.get("kvs"), x.dtype
    for li, lp in enumerate(params["h"]):
        if layer_inputs is not None:
            layer_inputs.append(x)
        x = decode_layer(ops, lp, x, heads, pos, kv_cache["k"][li], kv_cache["v"][li],
                         kv_valid, anc, group, None if kvs is None else kvs[li])
    if layer_inputs is not None:
        layer_inputs.append(x)
    return nn.layer_norm(params["ln_f"], x.to(dtype))


def fused_decode_step_plain(params, x: torch.Tensor, dims, pos: int,
                            kv_cache: Dict[str, torch.Tensor], kv_valid: torch.Tensor,
                            anc: Optional[torch.Tensor] = None, group: int = 1,
                            layer_inputs: Optional[list] = None) -> torch.Tensor:
    """The plain twin of `fused_decode_step` (any device), made of the
    kernels' plain twins."""
    _check_step(params, x, kv_cache, group, anc)
    return _step(TWINS, params, x, dims.heads, pos, kv_cache, kv_valid, anc, group,
                 layer_inputs)


def fused_decode_step_chain(params, x: torch.Tensor, dims, pos: int,
                            kv_cache: Dict[str, torch.Tensor], kv_valid: torch.Tensor,
                            anc: Optional[torch.Tensor] = None, group: int = 1,
                            layer_inputs: Optional[list] = None) -> torch.Tensor:
    """K1 as the chain of standalone kernels, five launches a layer (K7a,
    K7b or the int4 GEMVs, and `decode_attention`): off the decode's path;
    `chip_smoke.py` holds `fused_decode_step` bit-identical to it and
    `tools/torch_kernel_bench.py` times it beside it."""
    _check_step(params, x, kv_cache, group, anc)
    return _step(KERNELS, params, x, dims.heads, pos, kv_cache, kv_valid, anc, group,
                 layer_inputs)


# ---------------------------------------------------------------------------
# the persistent step kernel (`csrc/decode_step.cuh`, whose header says why)

STEP_MAX_SLOTS = 16         # weight slots of a block's ring
STEP_MAX_CLUSTER = 8
STEP_MISC = 256             # the mbarriers
STEP_MAX_LAYERS = 32        # the layer table's room in shared memory (128 bytes a layer)
STEP_ATTN_REGION = 80 * 1024  # the attention phase's shared memory, at least
STEP_PHASES = ("qkv", "attn-proj", "fc", "mlp-proj")
STEP_MARKS = 34             # trace stamps a layer and block
STEP_MAX_TILES = 4          # a GEMV phase's tiles a block takes together


class StepPlan(NamedTuple):
    cluster: int   # blocks of a cluster: the split of K = F
    blocks: int    # the persistent grid: resident clusters x cluster
    slots: int     # weight slots of a block's ring
    split_d: int   # the GEMVs' split of K = D (gemv_plan's), and its span
    span_d: int
    split_f: int   # ... of K = F (the MLP projection)
    span_f: int
    heads: int     # the attention at pos: heads a (row, head span) unit,
    chunks: int    # 64-position chunks a rank at most,
    stages: int    # chunk stages of a rank's ring
    smem: int      # dynamic shared-memory bytes a block


class StepShape(NamedTuple):
    cluster: int
    split_d: int
    span_d: int
    split_f: int
    span_f: int
    slots: int
    slot_bytes: int
    region: int    # the union of a GEMV phase's and the attention's shared memory
    smem: int


def step_barriers(layers: int) -> int:
    """Grid barriers a step: after qkv, the attention, the out-projection,
    fc and (but in the last layer) the MLP projection."""
    return 5 * layers - 1


def _x_stride(span: int) -> int:
    return -(-span * 2 // 128) * 128 + 16


def _step_gemv_region(M: int, span: int, cluster: int) -> int:
    nt = -(-M // 8)
    return (M * _x_stride(span) + 2 * span * 2
            + (GEMV_WARPS + cluster - 1) * STEP_MAX_TILES * nt * 32 * 4 * 4 + 2 * MAX_ROWS * 4)


def _step_layout(M: int, D: int, F: int, w4: bool, cluster: int, split_d: int, span_d: int,
                 split_f: int, span_f: int, slots: int, shards: int = 1):
    """(slot bytes, region, shared-memory bytes) of a block: the kernel's
    `layout` (`csrc/decode_step.cuh`) in the same formula; F is the MLP
    projection's K (K6, ``shards`` 2: a shard's F / 2)."""
    span = max(D if split_d == 1 else span_d, F if split_f == 1 else span_f)
    slot_bytes = -(-(16 * (span // 2 if w4 else span) + 64) // 128) * 128
    region = -(-max(_step_gemv_region(M, span, cluster), STEP_ATTN_REGION) // 128) * 128
    return (slot_bytes, region,
            slots * slot_bytes + region + STEP_MISC + shards * STEP_MAX_LAYERS * 128 + 4 * D * 2)


def _slots(M: int, D: int, F: int, w4: bool, cluster: int, split_d: int, span_d: int,
           split_f: int, span_f: int, shards: int = 1):
    """(slots, slot bytes, region, shared-memory bytes): as many weight slots
    as shared memory holds beside the rest (at most `STEP_MAX_SLOTS`);
    raises ValueError below two."""
    slot_bytes, region, fixed = _step_layout(M, D, F, w4, cluster, split_d, span_d, split_f,
                                             span_f, 0, shards)
    slots = min(STEP_MAX_SLOTS, (SMEM_MAX - fixed) // slot_bytes)
    if slots < 2:
        raise ValueError(f"decode step: two weight slots of {slot_bytes} bytes do not fit "
                         f"beside {fixed} bytes in {SMEM_MAX} bytes of shared memory")
    return slots, slot_bytes, region, fixed + slots * slot_bytes


@functools.lru_cache(maxsize=256)
def step_shape(M: int, D: int, F: int, w4: bool = False) -> StepShape:
    """What of the step kernel's plan the rows and widths fix: the GEMVs'
    splits (`gemv_plan`'s, so every output sums in the chain's order; K = D
    unsplit, as the LayerNorm phases take their statistics from the staged
    rows), the cluster (the split of K = F), and as many weight slots as shared memory
    holds (at least two) beside the larger of a GEMV phase's and the
    attention's region, the layer table and the LayerNorm vectors.
    Raises ValueError for a shape no plan fits."""
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"decode step: 1..{MAX_ROWS} rows, got {M}")
    half_d = nn.int4_halfspan(D // 2) if w4 else 0
    half_f = nn.int4_halfspan(F // 2) if w4 else 0
    gd, gf = gemv_plan(M, 3 * D, D, half_d), gemv_plan(M, D, F, half_f)
    cluster = gf.split
    if gd.split != 1 or cluster > STEP_MAX_CLUSTER:
        raise ValueError(f"decode step: the LayerNorm phases (K = {D}) must span K in one "
                         f"block (split {gd.split}) and K = {F} split over a cluster of at "
                         f"most {STEP_MAX_CLUSTER} ({gf.split})")
    slots, slot_bytes, region, smem = _slots(M, D, F, w4, cluster, gd.split, gd.span, gf.split,
                                             gf.span)
    return StepShape(cluster, gd.split, gd.span, gf.split, gf.span, slots, slot_bytes, region,
                     smem)


def step_attention(M: int, H: int, pos: int, kvq: bool, cluster: int, clusters: int,
                   region: int, shards: int = 1):
    """The attention phase's (heads, chunks, stages) at ``pos``: a cluster
    takes a (row, head span) unit (K6: a (shard, row, head span) unit of
    ``shards`` shards of H heads each), its ranks ``chunks`` of the row's
    ceil(pos / 64) chunks each; the heads a unit that take the fewest rounds
    of units over the ``clusters``, then the fewest heads; as many ring
    stages (at most 4) as fit the region. Raises ValueError if none fits."""
    n = -(-pos // CHUNK)
    chunks = max(1, -(-n // cluster))
    best = None
    for heads in range(1, min(H, MAX_HEADS) + 1):
        if H % heads:
            continue
        stages = next((s for s in range(min(chunks, MAX_STAGES), 0, -1)
                       if _attention_smem(heads, chunks, cluster, s, kvq) <= region), 0)
        if not stages:
            continue
        rounds = -(-shards * M * (H // heads) // clusters)
        if best is None or rounds < best[0]:
            best = (rounds, (heads, chunks, stages))
    if best is None:
        raise ValueError(f"decode step: no attention plan takes {H} heads at pos {pos} in "
                         f"{region} bytes of shared memory")
    return best[1]


@functools.lru_cache(maxsize=4096)   # a decode asks for one plan a position
def step_plan(M: int, D: int, H: int, F: int, S: int, pos: int, kvq: bool = False,
              w4: bool = False, blocks: int = 128) -> StepPlan:
    """The launch plan of `decode_step_launch` for M rows at widths D (H
    heads of 64) and F, a cache of S slots at ``pos``, on a grid of
    ``blocks`` (the resident clusters times `step_shape`'s cluster). Raises
    ValueError for a shape no plan fits."""
    if not 0 <= pos < S:
        raise ValueError(f"decode step: pos {pos} outside the cache of {S} slots")
    if D != H * HEAD_DIM:
        raise ValueError(f"decode step: the kernel takes head dim {HEAD_DIM}, got {D}/{H}")
    sh = step_shape(M, D, F, w4)
    if blocks < sh.cluster or blocks % sh.cluster:
        raise ValueError(f"decode step: {blocks} blocks are not whole clusters of {sh.cluster}")
    heads, chunks, stages = step_attention(M, H, pos, kvq, sh.cluster, blocks // sh.cluster,
                                           sh.region)
    return StepPlan(sh.cluster, blocks, sh.slots, sh.split_d, sh.span_d, sh.split_f, sh.span_f,
                    heads, chunks, stages, sh.smem)


def step_tiles(plan: StepPlan, D: int, F: int, layers: int):
    """The weight tiles each block takes, as the kernel's `owned` derives
    them: {(layer, phase): {block: [tile, ...]}}, a tile being 16 output rows
    (and, where K is split, the block's rank's span of K). Tiles go
    round-robin over the blocks (unsplit K) or the clusters (split K), rotated
    by the block units handed out before in the step."""
    N = (3 * D, D, F, D)
    split = (plan.split_d,) * 3 + (plan.split_f,)
    units = [-(-n // 16) * s for n, s in zip(N, split)]
    clusters = plan.blocks // plan.cluster
    out = {}
    for li in range(layers):
        for ph in range(4):
            acc = li * sum(units) + sum(units[:ph])
            tiles = -(-N[ph] // 16)
            owned = {}
            for b in range(plan.blocks):
                if split[ph] == 1:
                    first, stride = (b - acc % plan.blocks) % plan.blocks, plan.blocks
                else:
                    first = (b // plan.cluster - (acc // plan.cluster) % clusters) % clusters
                    stride = clusters
                owned[b] = list(range(first, tiles, stride))
            out[li, ph] = owned
    return out


def step_units(plan: StepPlan, M: int, H: int, pos: int):
    """The attention phase's units as the kernel walks them: {cluster:
    [(row, first head, [(rank, chunks of the row it takes), ...]), ...]},
    the ranks in their runs' order (the merge order): rank k takes run
    k - 1, rank 0 (which merges) the last."""
    spans, clusters = H // plan.heads, plan.blocks // plan.cluster
    n = -(-pos // CHUNK)
    out = {c: [] for c in range(clusters)}
    for c in range(clusters):
        for u in range(c, M * spans, clusters):
            runs = [((run + 1) % plan.cluster,
                     list(range(run * plan.chunks, min(n, (run + 1) * plan.chunks))))
                    for run in range(plan.cluster)]
            out[c].append((u // spans, (u % spans) * plan.heads, runs))
    return out


# K6 with both tp shards on one card: the TP variant of the same kernel
# (`decode_step_tp_launch`), one launch a step for both shards' layers
# (`ops/decode_step_tp.py`).


@functools.lru_cache(maxsize=256)
def step_tp_shape(M: int, D: int, F: int) -> StepShape:
    """What of K6's plan the rows and the model's widths fix. Each shard's
    GEMV takes the split `gemv_plan` gives its K, as the chain's do: qkv and
    fc K = D (unsplit, so the LayerNorm takes its statistics from the staged
    rows), the out-projection a shard's K = D / 2 (unsplit), the MLP
    projection a shard's K = F / 2 (``split_f`` spans of ``span_f``). A
    row-parallel tile's ranks hold both shards' spans: the cluster is
    2 ``split_f`` (4 at D = 1280), at most 8. ``split_d`` / ``span_d`` are
    K = D's (1, D). Raises ValueError for a shape no plan fits."""
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"tp decode step: 1..{MAX_ROWS} rows, got {M}")
    if D % 128 or F % 64:
        raise ValueError(f"tp decode step: D a multiple of 128 and F of 64, got {D}, {F}")
    gd, gp = gemv_plan(M, 3 * D // 2, D), gemv_plan(M, D, D // 2)
    gf = gemv_plan(M, D, F // 2)
    cluster = 2 * gf.split
    if gd.split != 1 or gp.split != 1 or cluster > STEP_MAX_CLUSTER:
        raise ValueError(f"tp decode step: K = {D} and a shard's K = {D // 2} must not be split "
                         f"({gd.split}, {gp.split}), and both shards' spans of K = {F // 2} "
                         f"must fit a cluster of at most {STEP_MAX_CLUSTER} ({cluster})")
    slots, slot_bytes, region, smem = _slots(M, D, F // 2, False, cluster, 1, D, gf.split,
                                             gf.span, shards=2)
    return StepShape(cluster, 1, D, gf.split, gf.span, slots, slot_bytes, region, smem)


@functools.lru_cache(maxsize=4096)
def step_tp_plan(M: int, D: int, H: int, F: int, S: int, pos: int, blocks: int = 120) -> StepPlan:
    """The launch plan of `decode_step_tp_launch` (K6 co-located) for M rows
    of the model's widths D (H heads of 64, H / 2 a shard) and F, each
    shard's cache of S slots at ``pos``, on a grid of ``blocks``. Raises
    ValueError for a shape no plan fits."""
    if not 0 <= pos < S:
        raise ValueError(f"tp decode step: pos {pos} outside the cache of {S} slots")
    if D != H * HEAD_DIM or H % 2:
        raise ValueError(f"tp decode step: an even number of heads of {HEAD_DIM}, got {D}/{H}")
    sh = step_tp_shape(M, D, F)
    if blocks < sh.cluster or blocks % sh.cluster:
        raise ValueError(f"tp decode step: {blocks} blocks are not whole clusters of "
                         f"{sh.cluster}")
    heads, chunks, stages = step_attention(M, H // 2, pos, False, sh.cluster,
                                           blocks // sh.cluster, sh.region, shards=2)
    return StepPlan(sh.cluster, blocks, sh.slots, sh.split_d, sh.span_d, sh.split_f, sh.span_f,
                    heads, chunks, stages, sh.smem)


def step_tp_tiles(plan: StepPlan, D: int, F: int, layers: int):
    """K6's weight slabs each block takes, as the kernel's `owned` and
    `issue_tile` derive them: {(layer, phase): {block: [(shard, tile, span),
    ...]}}, a slab being 16 output rows of a shard's weight (``tile`` counts
    in the shard's rows) and ``span`` the block's span of that shard's K (0
    where K is whole). qkv and fc: both shards' tiles interleaved (tile i
    is shard i % 2's tile i // 2) round-robin over the blocks, so that a
    block's tiles, an even number of blocks apart, are one shard's; attn-proj: its D / 16 tiles round-robin
    over the blocks, a block taking both shards' slabs of each; mlp-proj:
    its tiles round-robin over the clusters, rank r taking shard r //
    split_f's span r % split_f. Rotated by the units handed out before in
    the step, as `step_tiles`."""
    tiles = (2 * -(-3 * D // 2 // 16), -(-D // 16), 2 * -(-F // 2 // 16), -(-D // 16))
    split = (1, 1, 1, plan.cluster)
    units = [t * s for t, s in zip(tiles, split)]
    clusters = plan.blocks // plan.cluster
    out = {}
    for li in range(layers):
        for ph in range(4):
            acc = li * sum(units) + sum(units[:ph])
            owned = {}
            for b in range(plan.blocks):
                if split[ph] == 1:
                    mine = range((b - acc % plan.blocks) % plan.blocks, tiles[ph], plan.blocks)
                    if ph == 1:
                        owned[b] = [(t, i, 0) for i in mine for t in range(2)]
                    else:
                        owned[b] = [(i % 2, i // 2, 0) for i in mine]
                    continue
                first = (b // plan.cluster - (acc // plan.cluster) % clusters) % clusters
                r = b % plan.cluster
                owned[b] = [(r // plan.split_f, i, r % plan.split_f)
                            for i in range(first, tiles[ph], clusters)]
            out[li, ph] = owned
    return out


def step_tp_units(plan: StepPlan, M: int, H: int, pos: int):
    """K6's attention units as the kernel walks them: {cluster: [(shard,
    row, first head, [(rank, chunks of the row it takes), ...]), ...]} over
    H / 2 heads a shard, shard 0's units first; the ranks in their runs'
    order, as `step_units`."""
    spans, clusters = H // 2 // plan.heads, plan.blocks // plan.cluster
    per_shard, n = M * spans, -(-pos // CHUNK)
    out = {c: [] for c in range(clusters)}
    for c in range(clusters):
        for u in range(c, 2 * per_shard, clusters):
            runs = [((run + 1) % plan.cluster,
                     list(range(run * plan.chunks, min(n, (run + 1) * plan.chunks))))
                    for run in range(plan.cluster)]
            r = u % per_shard
            out[c].append((u // per_shard, r // spans, (r % spans) * plan.heads, runs))
    return out


@functools.lru_cache(maxsize=64)
def _step_blocks(device: torch.device, w4: bool, kvq: bool, nt: int, cluster: int,
                 smem: int, fp16: bool = False) -> int:
    """The persistent grid: the resident clusters the occupancy query
    allows for this variant (``fp16``: its E = fp16 instantiation), times
    the cluster."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        code = cuda.library().decode_step_occupancy(int(w4), int(kvq), int(fp16), nt, cluster,
                                                    smem, ctypes.byref(n))
    cuda.check(code, "decode_step occupancy")
    if n.value < 1:
        raise RuntimeError(f"decode step: no cluster of {cluster} blocks with {smem} bytes of "
                           f"shared memory is resident on {device}")
    return n.value * cluster


_BARRIERS: Dict[torch.device, torch.Tensor] = {}
_TABLES: Dict[tuple, torch.Tensor] = {}


def step_barrier(device: torch.device) -> torch.Tensor:
    """The device's grid-barrier words, made once, zeroed: the arrival word
    (its low bits 0 between launches) and the count of barriers completed,
    which grows by `step_barriers` a step. Step launches on one device must
    not overlap: they share the words (and the grid must be resident
    alone)."""
    device = torch.device(device)
    bar = _BARRIERS.get(device)
    if bar is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode step: the first launch on a device must run outside a "
                               "CUDA graph capture (it makes the grid barrier)")
        bar = torch.zeros(8, dtype=torch.int32, device=device)
        torch.cuda.synchronize(device)
        _BARRIERS[device] = bar
    return bar


def _layer_table(layers, device: torch.device, shapes, D: int, w4: bool,
                 name: str = "fused_decode_step",
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The (L, shards * 16) int64 table of the layers' weight pointers the
    kernel reads (`Layer` in `csrc/decode_step.cuh`): ``layers`` holds, per
    layer, its shards' trees (one for K1; K6's two, each with its own
    pointers) and ``shapes`` the (N, K) of the four weights of one shard's
    (their f32 scale and ``dtype`` bias have N entries; the LayerNorm
    vectors are ``dtype`` too). Checked and uploaded once per set of
    pointers."""
    w = "q4" if w4 else "q"
    mats = [(lp["attn"]["c_attn"], lp["attn"]["c_proj"], lp["mlp"]["c_fc"], lp["mlp"]["c_proj"])
            for shards in layers for lp in shards]
    lns = [(lp["ln_1"]["weight"], lp["ln_1"]["bias"], lp["ln_2"]["weight"], lp["ln_2"]["bias"])
           for shards in layers for lp in shards]
    ptrs = tuple(t.data_ptr() for ms, ln in zip(mats, lns)
                 for t in (*(m[w] for m in ms), *(m["scale"] for m in ms),
                           *(m["bias"] for m in ms), *ln))
    key = (device, ptrs)
    table = _TABLES.get(key)
    if table is not None:
        return table
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{name}: call it once outside a CUDA graph capture with these "
                           "weights (it uploads their pointer table)")
    for ms, ln in zip(mats, lns):
        for m, (N, K) in zip(ms, shapes):
            for leaf, t, dtype, shape in ((w, m.get(w), torch.int8, (N, K // 2 if w4 else K)),
                                          ("scale", m["scale"], torch.float32, (N,)),
                                          ("bias", m["bias"], dtype, (N,))):
                if t is None or t.dtype != dtype or tuple(t.shape) != shape \
                        or t.device != device or not t.is_contiguous():
                    raise ValueError(f"{name}: a layer's {leaf} must be contiguous {dtype} "
                                     f"{shape} on {device}")
            if m[w].data_ptr() % 16:
                raise ValueError(f"{name}: weights must be 16-byte aligned (TMA)")
        for t in ln:
            if t.dtype != dtype or tuple(t.shape) != (D,) or t.device != device \
                    or not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{name}: LayerNorm vectors must be contiguous, 16-byte "
                                 f"aligned {dtype} ({D},) on {device}")
    if len(_TABLES) >= 16:
        _TABLES.clear()
    table = torch.tensor(ptrs, dtype=torch.int64).view(len(layers), -1).to(device)
    torch.cuda.synchronize(device)
    _TABLES[key] = table
    return table


def _persistent_step(params, x, dims, pos: int, kv_cache, kv_valid, anc, group: int,
                     layer_inputs: Optional[list], trace: Optional[list] = None) -> torch.Tensor:
    dev = x.device
    M, D = x.shape
    L, H = len(params["h"]), dims.heads
    c_fc = params["h"][0]["mlp"]["c_fc"]
    w4 = "q4" in c_fc
    F = c_fc["scale"].shape[0]
    ck, cv, kvs = kv_cache["k"], kv_cache["v"], kv_cache.get("kvs")
    S = ck.shape[2]
    cache_dtype = x.dtype if kvs is None else torch.int8
    checks = [("x", x, x.dtype, (M, D)), ("k cache", ck, cache_dtype, (L, M, S, D)),
              ("v cache", cv, cache_dtype, (L, M, S, D)), ("kv_valid", kv_valid, torch.bool, (M, S))]
    if kvs is not None:
        checks.append(("scale rows", kvs, torch.bfloat16, (L, M, S, SCALE_LANES)))
    if group > 1:
        if M % group:
            raise ValueError(f"fused_decode_step: {M} rows are not groups of {group}")
        checks.append(("anc", anc, torch.int32, (M, S)))
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_decode_step: {name} must be contiguous, 16-byte aligned "
                             f"{dtype} {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if kvs is not None and H > SCALE_LANES // 2:
        raise ValueError(f"fused_decode_step: the int8 cache's scale row holds at most "
                         f"{SCALE_LANES // 2} heads, got {H}")
    if L > STEP_MAX_LAYERS:
        raise ValueError(f"fused_decode_step: the kernel takes at most {STEP_MAX_LAYERS} layers, "
                         f"got {L}")
    sh = step_shape(M, D, F, w4)
    kvq, fp16 = kvs is not None, x.dtype == torch.float16
    blocks = _step_blocks(dev, w4, kvq, -(-M // 8), sh.cluster, sh.smem, fp16)
    plan = step_plan(M, D, H, F, S, pos, kvq, w4, blocks)
    table = _layer_table([(lp,) for lp in params["h"]], dev,
                         ((3 * D, D), (D, D), (F, D), (D, F)), D, w4, dtype=x.dtype)
    bar = step_barrier(dev)
    xslots = 2 if layer_inputs is None else L + 1
    bf16 = torch.bfloat16
    xs = torch.empty((xslots, M, D), dtype=bf16, device=dev)
    qkv = torch.empty((M, 3 * D), dtype=bf16, device=dev)
    att = torch.empty((M, D), dtype=bf16, device=dev)
    xb = torch.empty((M, D), dtype=bf16, device=dev)
    h = torch.empty((M, F), dtype=bf16, device=dev)
    half_d = nn.int4_halfspan(D // 2) if w4 else 0
    half_f = nn.int4_halfspan(F // 2) if w4 else 0
    stamps = None
    if trace is not None:
        stamps = torch.zeros((plan.blocks, L, STEP_MARKS), dtype=torch.int64, device=dev)
        trace.append(stamps)
    with torch.cuda.device(dev):
        code = cuda.library().decode_step_launch(
            table.data_ptr(), x.data_ptr(), xs.data_ptr(), xslots, qkv.data_ptr(),
            att.data_ptr(), xb.data_ptr(), h.data_ptr(), ck.data_ptr(), cv.data_ptr(),
            None if kvs is None else kvs.data_ptr(), kv_valid.data_ptr(),
            anc.data_ptr() if group > 1 else None, bar.data_ptr(),
            None if stamps is None else stamps.data_ptr(), L, M, D, H, F, S, pos,
            group, 1.0 / math.sqrt(HEAD_DIM), half_d, half_f, int(fp16), *plan,
            cuda.stream_ptr(x))
    cuda.check(code, "decode_step")
    if layer_inputs is not None:
        layer_inputs.append(x)
        layer_inputs.extend(xs[1:])
    return nn.layer_norm(params["ln_f"], xs[L % xslots].to(x.dtype))


def fused_decode_step(params, x: torch.Tensor, dims, pos: int,
                      kv_cache: Dict[str, torch.Tensor], kv_valid: torch.Tensor,
                      anc: Optional[torch.Tensor] = None, group: int = 1,
                      layer_inputs: Optional[list] = None) -> torch.Tensor:
    """K1: one token x (B, D) bf16 or fp16 (E, the tree's type) through
    every layer of the int8 or int4 GPT-2 tree ``params`` against the flat
    cache (L, B, S, D), B <= 24: {"k", "v"} at E, or {"k", "v"} int8 with
    "kvs" (L, B, S, 256) bf16 scale rows (the module docstring says how E
    enters the bf16 body). Writes each layer's k and v at slot ``pos`` in
    place (quantized
    for the int8 cache) and attends exactly the slots kv_valid (B, S) marks
    (those below ``pos``, and the token itself where it marks ``pos``), as
    the mask-based `gpt2_decode_step` does; the JAX kernel takes the window
    [pos + 1 - popcount(kv_valid[b]), pos) instead, which differs across
    the engines' unwritten slot P + 1. With ``group=K`` > 1 the
    cache is unordered and ``anc`` (B, S) int32 names, for each row and
    position, the row of its beam group that holds the entry and whose
    kv_valid byte counts (as a gather route would gather both). Returns
    (B, D) after ``ln_f`` at E; a ``layer_inputs`` list receives each layer's
    input (x, then bf16) and the last layer's output. CPU tensors run the
    plain twin; CUDA tensors
    launch the persistent kernel, one launch a step
    (``fused_decode_step.launches``); anything else raises, as does what it
    does not take: float weights, another cache layout or type, f32
    activations, B > 24."""
    cuda.refuse_grad("fused_decode_step", params, x, kv_cache)
    _check_step(params, x, kv_cache, group, anc)
    if x.device.type == "cpu":
        return _step(TWINS, params, x, dims.heads, pos, kv_cache, kv_valid, anc, group,
                     layer_inputs)
    if x.device.type != "cuda":
        raise ValueError(f"fused_decode_step: unsupported device {x.device}")
    h = _persistent_step(params, x, dims, pos, kv_cache, kv_valid, anc, group, layer_inputs)
    cuda.count(fused_decode_step)
    return h


fused_decode_step.launches = 0


def step_timeline(params, x: torch.Tensor, dims, pos: int, kv_cache: Dict,
                  kv_valid, anc=None, group: int = 1) -> Dict[str, float]:
    """One launch of the persistent step (CUDA tensors; the cache's rows at
    pos are written) with every block stamping %globaltimer at each phase's
    and each barrier's end: the step's mean µs a layer in each phase and in
    each barrier's wait, averaged over blocks and layers, the mean of a
    phase's slowest block, and the stamps' whole span (the timer ticks in
    ns on the H100; the stamps cost a store a phase and block). K1 for a
    GPT-2 tree; K6 co-located for the tp tree of `shard_gpt2_tp` (its
    per-shard cache, both shards on one card)."""
    stamps: list = []
    if "shards" in params:
        from indextts_tpu_torch.ops import decode_step_tp

        decode_step_tp._check_step_tp(params, x, dims, kv_cache, group, anc)
        decode_step_tp._persistent_step_tp(params, x, dims, pos, kv_cache, kv_valid, anc, group,
                                          None, stamps)
    else:
        _check_step(params, x, kv_cache, group, anc)
        _persistent_step(params, x, dims, pos, kv_cache, kv_valid, anc, group, None, stamps)
    t = stamps[0].double().cpu()                    # (blocks, L, 34) ns
    d = t[:, :, 1:10] - t[:, :, :9]                 # (blocks, L, 9)
    names = ("qkv", "barrier 1", "attention", "barrier 2", "attn-proj", "barrier 3", "fc",
             "barrier 4", "mlp-proj")
    out = {f"{n} us": float(d[:, :, i].mean()) / 1e3 for i, n in enumerate(names)}
    out.update({f"{n} slowest us": float(d[:, :, i].amax(0).mean()) / 1e3
                for i, n in enumerate(names) if not n.startswith("barrier")})
    last = t[:, 1:, 0] - t[:, :-1, 9]               # the layer's last barrier
    out["barrier 5 us"] = float(last.mean()) / 1e3
    out["span us"] = float(t[:, -1, 9].max() - t[:, 0, 0].min()) / 1e3
    # inside a GEMV phase (its blocks with tiles; the first batch): x staged,
    # products (of which the wait for the first tile's slab), the epilogue
    # with the slots' refill beside it
    for ph, (name, start) in enumerate(zip(STEP_PHASES, (0, 4, 6, 8))):
        marks = t[:, :, 10 + 4 * ph:14 + 4 * ph]
        busy = marks[:, :, 0] > 0
        if not busy.any():
            continue
        steps = torch.stack([marks[:, :, 0] - t[:, :, start], marks[:, :, 1] - marks[:, :, 0],
                             marks[:, :, 3] - marks[:, :, 1]])
        for part, v in zip(("stage", "products", "epilogue and refill"), steps):
            out[f"{name} {part} us"] = float(v[busy].mean()) / 1e3
        out[f"{name} first wait us"] = float((t[:, :, 26 + ph] - marks[:, :, 0])[busy].mean()) / 1e3
        if ph in (0, 2):   # a LayerNorm phase: x's rows staged, the LayerNorm, the next vectors
            rows, norm = t[:, :, 30 + ph // 2], t[:, :, 32 + ph // 2]
            out[f"{name} rows staged us"] = float((rows - t[:, :, start])[busy].mean()) / 1e3
            out[f"{name} layernorm us"] = float((norm - rows)[busy].mean()) / 1e3
            out[f"{name} next vectors us"] = float((marks[:, :, 0] - norm)[busy].mean()) / 1e3
    return out


def grid_barriers(device, barriers: int, M: int = 3, D: int = 1280, F: int = 5120,
                  cooperative: bool = False) -> None:
    """Launch the bare-barrier kernel: ``barriers`` grid barriers on the
    step kernel's grid for M rows at widths D and F (int8 weights: its
    cluster and shared memory, so its residency), nothing else; the floor
    the step's barriers cost (`tools/torch_kernel_bench.py --only barrier`).
    ``cooperative`` adds the cooperative-launch attribute (a launch error
    where the driver refuses it with clusters)."""
    device = torch.device(device)
    sh = step_shape(M, D, F)
    n = ctypes.c_int(0)
    lib = cuda.library()
    with torch.cuda.device(device):
        cuda.check(lib.step_barrier_occupancy(sh.cluster, sh.smem, ctypes.byref(n)),
                   "step_barrier occupancy")
        code = lib.step_barrier_launch(step_barrier(device).data_ptr(), barriers,
                                       n.value * sh.cluster, sh.cluster, sh.smem,
                                       int(cooperative),
                                       torch.cuda.current_stream(device).cuda_stream)
    cuda.check(code, "step_barrier")
