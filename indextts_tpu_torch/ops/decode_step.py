"""Fused GPT-2 decode step on quantized weights: kernel K1 and its plain twin.

`fused_decode_step` is the port of `indextts_tpu/ops/pallas/decode_step.py::
fused_decode_step` at ``group=1`` and with the beam ancestry map at
``group=K``, in the TPU kernel's four configurations: int8 or nibble-packed
int4 weights (its ``W4`` variant, `nn.quantize_dense_int4`) against the
flat bf16 (L, B, S, D) cache or the flat int8 cache with its packed bf16
scale rows ``"kvs"`` (its ``KVQ`` variant, `gpt2.kv_quantize_flat`). On the
TPU it is one kernel over the layers; here every operation of a layer runs
in one of the hand-written Hopper kernels, with no library call between
them:

- ``ln_1`` + qkv projection: `int8_matvec` (int4: `int4_matvec`) with the
  LayerNorm prologue (K7a, `csrc/int8_gemv.cu`);
- attention over the cache plus the current token, which also writes the
  token's k and v into the cache at ``pos`` (quantized for the int8 cache):
  `decode_attention` (`csrc/decode_attention.cu`, one launch: the positions
  split over a thread-block cluster, merged on its rank 0; the launch plan
  is `attention_plan`);
- attention out-projection + residual: `int8_matvec` / `int4_matvec` with
  the residual epilogue;
- ``ln_2`` + MLP + residual: `int8_mlp` / `int4_mlp` (K7b, two GEMV
  launches).

``ln_f`` is applied after the layers, outside the kernels, as in the TPU
kernel's wrapper. The rounding chain is the TPU kernel's (see the two CUDA
sources); `fused_decode_step_plain` repeats it in plain PyTorch with the
same split of the positions into chunks of `CHUNK`.

Unlike the JAX kernel, which returns the new k/v rows for the caller to
write, the cache is updated in place (the port's cache is always updated in
place: the decode loop never holds two copies of it).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from indextts_tpu_torch import nn
from indextts_tpu_torch.models.gpt.gpt2 import SCALE_LANES, kv_quantize_flat
from indextts_tpu_torch.ops import cuda
from indextts_tpu_torch.ops.int8 import (MAX_ROWS, SMEM_MAX, SMS, int4_matvec,
                                         int4_matvec_plain, int4_mlp, int4_mlp_plain,
                                         int8_matvec, int8_matvec_plain, int8_mlp,
                                         int8_mlp_plain)

CHUNK = 64          # positions a chunk of `decode_attention`: the rounding unit
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
    rows at ``pos`` in place like the kernel."""
    M, D = qkv.shape[0], qkv.shape[1] // 3
    Dh, S, dev = D // heads, ck.shape[1], qkv.device
    bf16 = torch.bfloat16
    q = (qkv[:, :D].float() * (1.0 / math.sqrt(Dh))).to(bf16)
    kc, vc = qkv[:, D:2 * D], qkv[:, 2 * D:]
    start = pos + 1 - kv_valid.sum(1)
    n_chunks = -(-pos // CHUNK)
    G = n_chunks * CHUNK
    g = torch.arange(G, device=dev)
    gi = g.clamp(max=S - 1)
    rows = torch.arange(M, device=dev)[:, None]
    phys = rows.expand(M, G) if anc is None else (rows // group) * group + anc[:, gi].long()
    # (M, G, D) values of each row's hypothesis (int8 -> bf16 is exact)
    ks, vs = ck[phys, gi[None, :]].to(bf16), cv[phys, gi[None, :]].to(bf16)
    valid = (g[None, :] >= start[:, None]) & (g[None, :] < pos)            # (M, G)
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
    cur_valid = (start <= pos)[:, None]
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
        decode_attention.launches += 1
    else:
        decode_attention.kvq_launches += 1
    return out


decode_attention.launches = 0
decode_attention.kvq_launches = 0


def _check_step(params, x, kv_cache, group: int, anc) -> None:
    c_attn = params["h"][0]["attn"]["c_attn"]
    if "q" not in c_attn and "q4" not in c_attn:
        raise ValueError("fused_decode_step takes int8 or int4 weights "
                         "(quantize_gpt2_int8 / quantize_gpt2_int4)")
    bf16_cache = set(kv_cache) == {"k", "v"} and kv_cache["k"].dtype == torch.bfloat16
    int8_cache = set(kv_cache) == {"k", "v", "kvs"} and kv_cache["k"].dtype == torch.int8
    if not (bf16_cache or int8_cache) or kv_cache["k"].ndim != 4:
        raise ValueError("fused_decode_step takes the flat (L, B, S, D) bf16 cache or the "
                         "flat int8 cache with its 'kvs' scale rows (init_kv_cache), got "
                         f"{ {k: (t.dtype, tuple(t.shape)) for k, t in kv_cache.items()} }")
    B = x.shape[0]
    if B > MAX_ROWS:
        raise ValueError(f"fused_decode_step takes at most {MAX_ROWS} rows, got {B}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_decode_step takes bf16 activations, got {x.dtype}")
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
    layer's input."""
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
    kvs = kv_cache.get("kvs")
    for li, lp in enumerate(params["h"]):
        if layer_inputs is not None:
            layer_inputs.append(x)
        x = decode_layer(ops, lp, x, heads, pos, kv_cache["k"][li], kv_cache["v"][li],
                         kv_valid, anc, group, None if kvs is None else kvs[li])
    if layer_inputs is not None:
        layer_inputs.append(x)
    return nn.layer_norm(params["ln_f"], x)


def fused_decode_step_plain(params, x: torch.Tensor, dims, pos: int,
                            kv_cache: Dict[str, torch.Tensor], kv_valid: torch.Tensor,
                            anc: Optional[torch.Tensor] = None, group: int = 1,
                            layer_inputs: Optional[list] = None) -> torch.Tensor:
    """The plain twin of `fused_decode_step` (any device), made of the
    kernels' plain twins."""
    _check_step(params, x, kv_cache, group, anc)
    return _step(TWINS, params, x, dims.heads, pos, kv_cache, kv_valid, anc, group,
                 layer_inputs)


def fused_decode_step(params, x: torch.Tensor, dims, pos: int,
                      kv_cache: Dict[str, torch.Tensor], kv_valid: torch.Tensor,
                      anc: Optional[torch.Tensor] = None, group: int = 1,
                      layer_inputs: Optional[list] = None) -> torch.Tensor:
    """K1: one token x (B, D) bf16 through every layer of the int8 or int4
    GPT-2 tree ``params`` against the flat cache (L, B, S, D), B <= 24:
    {"k", "v"} bf16, or {"k", "v"} int8 with "kvs" (L, B, S, 256) bf16 scale
    rows. Writes each layer's k and v at slot ``pos`` in place (quantized
    for the int8 cache) and attends [start_b, pos) plus the token itself,
    start_b = pos + 1 - popcount(kv_valid[b]). With ``group=K`` > 1 the
    cache is unordered and ``anc`` (B, S) int32 names, for each row and
    position, the row of its beam group that holds the entry. Returns (B, D)
    after ``ln_f``; a ``layer_inputs`` list receives each layer's input and
    the last layer's output. Raises on what it does not take: float weights,
    another cache layout, B > 24."""
    _check_step(params, x, kv_cache, group, anc)
    h = _step(KERNELS, params, x, dims.heads, pos, kv_cache, kv_valid, anc, group,
              layer_inputs)
    if x.device.type == "cuda":
        fused_decode_step.launches += 1
    return h


fused_decode_step.launches = 0
