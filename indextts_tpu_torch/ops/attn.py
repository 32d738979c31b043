"""The DiT's attention kernels and their plain twins.

- `attention_rope` (K2) is the port of `indextts_tpu/ops/pallas/attn.py::
  packed_pair_attention_rope`: (B, T, H*D) attention with the half-split
  rope; `packed_pair_attention` (K2') is `packed_pair_attention`, the same
  without the rope. K2 is two launches from one host call: the rope pass
  over q and k (`rope_qk`'s kernel, `csrc/attention_rope.cu`) and K2''s
  attention kernel (`csrc/attention_tma.cuh` through
  `csrc/attention_rope.cu`): the probabilities are rounded to bf16
  unnormalized and the row sum divides after PV.
- `single_block_attention` (K4) is `single_block_attention`: (B, H, T, D)
  attention whose probabilities are normalized before they are rounded to
  v's dtype, the DiT's flash tier through `nn.mha_flash`. It runs
  `csrc/attention_block.cu` (the same core, two passes).

The kernels take bf16 or fp16 operands (the JAX kernels take q's dtype; a
float16 pipeline hands them fp16): one instantiation of the core each.

On a CUDA tensor each entry launches its hand-written Hopper kernels (or
raises); on a CPU tensor it runs its ``*_plain`` twin, the same math in
plain PyTorch, which the CPU tests hold against the JAX kernel and
`chip_smoke.py` holds the CUDA kernel against on the card. Each entry counts
its calls that launch in ``.launches`` (`rope_qk`'s count includes the
rope passes K2 launches).
"""

from __future__ import annotations

import math

import torch

from indextts_tpu_torch.ops import cuda
from indextts_tpu_torch.ops.rope import apply_rotary_emb_half

NEG = -1e9          # the TPU kernels' mask value


def _pair_attention_plain(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) -> (B, T, H*D): f32 scores scaled by 1/sqrt(D); keys >=
    lengths[b] masked to -1e9; f32 softmax against the row max;
    probabilities rounded to v's dtype before PV; the f32 row sum divides
    after PV."""
    B, T, H, D = qh.shape
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) * (1.0 / math.sqrt(D))
    key_ok = (torch.arange(T, device=qh.device)[None, :]
              < lengths.to(qh.device)[:, None])[:, None, None, :]
    s = torch.where(key_ok, s, torch.full_like(s, NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    r = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(vh.dtype).float(), vh.float()) / r
    return o.permute(0, 2, 1, 3).reshape(B, T, H * D).to(qh.dtype)


def rope_qk_plain(q: torch.Tensor, k: torch.Tensor, freqs_cis: torch.Tensor,
                  heads: int) -> tuple:
    """(B, T, H*D) pre-rope q and k -> the rotated (q, k), (B, T, H*D) in
    their dtypes: the half-split rope in f32 (`apply_rotary_emb_half`)."""
    B, T, HD = q.shape
    D = HD // heads
    return tuple(apply_rotary_emb_half(t.reshape(B, T, heads, D), freqs_cis).reshape(B, T, HD)
                 for t in (q, k))


def attention_rope_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, freqs_cis: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """(B, T, H*D) pre-rope q, k and v -> (B, T, H*D) attention output.

    Rope on q and k in f32, rounded to the input dtype, then the attention
    of `packed_pair_attention_plain`. Query rows past lengths[b] are
    garbage the caller masks."""
    B, T, HD = q.shape
    D = HD // heads
    qr = apply_rotary_emb_half(q.reshape(B, T, heads, D), freqs_cis)
    kr = apply_rotary_emb_half(k.reshape(B, T, heads, D), freqs_cis)
    return _pair_attention_plain(qr, kr, v.reshape(B, T, heads, D), lengths)


def packed_pair_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                lengths: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, H*D) q, k and v -> (B, T, H*D): K2's attention without the
    rope (k and v taken in q's dtype, as the JAX kernel casts them)."""
    B, T, HD = q.shape
    D = HD // heads
    return _pair_attention_plain(q.reshape(B, T, heads, D),
                                 k.to(q.dtype).reshape(B, T, heads, D),
                                 v.to(q.dtype).reshape(B, T, heads, D), lengths)


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """TMA reads an operand whose base and strides (the last axis aside,
    which is contiguous) are multiples of 16 bytes; strides of extent-1 axes
    are never stepped."""
    if t.data_ptr() % 16 or any(n > 1 and (s <= 0 or s * t.element_size() % 16)
                                for n, s in zip(t.shape[:-1], t.stride()[:-1])):
        raise ValueError(f"{name}: the kernel's tensor-map loads take a base and strides "
                         f"that are multiples of 16 bytes, got shape {tuple(t.shape)}, "
                         f"strides {t.stride()}, base offset {t.data_ptr() % 16} mod 16")


# the operand types the kernels are instantiated for
KERNEL_DTYPES = (torch.bfloat16, torch.float16)


def _check_dtype(name: str, q: torch.Tensor) -> None:
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: q must be bf16 or fp16, got {q.dtype}")


def _check_packed(name: str, heads: int, *tensors) -> tuple:
    """(B, T, D) of the (B, T, H*64) bf16 or fp16 operands of K2, K2' or
    the rope pass (q first, the others of its dtype) on one CUDA device.
    They are contiguous, so their strides are multiples of 64 elements and
    only the base needs 16-byte alignment for TMA."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    _check_dtype(name, q)
    B, T, HD = q.shape
    D = HD // heads
    if D != 64 or heads * D != HD:
        raise ValueError(f"{name}: kernel takes head dim 64, got {HD}/{heads}")
    for label, t in zip("qkv", tensors):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous {q.dtype} "
                             f"{tuple(q.shape)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if t.data_ptr() % 16:
            _check_aligned(f"{name}: {label}", t)
    return B, T, D


def _check_freqs(name: str, freqs_cis: torch.Tensor, q: torch.Tensor, T: int, D: int) -> None:
    if freqs_cis.shape[0] < T or tuple(freqs_cis.shape[1:]) != (D // 2, 2) \
            or freqs_cis.device != q.device or freqs_cis.dtype != torch.float32 \
            or not freqs_cis.is_contiguous():
        raise ValueError(f"{name}: freqs_cis must be contiguous f32 (>={T}, {D // 2}, 2) "
                         f"on {q.device}, got {freqs_cis.dtype} {tuple(freqs_cis.shape)} "
                         f"on {freqs_cis.device}")


def _int32_lengths(name: str, lengths: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    if lengths.shape != (q.shape[0],) or lengths.device != q.device:
        raise ValueError(f"{name}: lengths must be ({q.shape[0]},) on {q.device}")
    return lengths.to(torch.int32).contiguous()


def rope_qk(q: torch.Tensor, k: torch.Tensor, freqs_cis: torch.Tensor,
            heads: int) -> tuple:
    """K2's rope pass. q, k: (B, T, H*D) with D = 64; freqs_cis: (>= T, D/2,
    2) cos/sin. CPU tensors run the plain version; CUDA tensors (q, k bf16
    or fp16 and contiguous, freqs_cis f32 and contiguous) launch the kernel,
    which writes the rotated q and k to new (B, T, H*D) tensors; anything
    else raises."""
    cuda.refuse_grad("rope_qk", q, k, freqs_cis)
    if q.device.type == "cpu":
        return rope_qk_plain(q, k, freqs_cis, heads)
    B, T, D = _check_packed("rope_qk", heads, q, k)
    _check_freqs("rope_qk", freqs_cis, q, T, D)
    qr, kr = torch.empty_like(q), torch.empty_like(k)
    with torch.cuda.device(q.device):
        code = cuda.library().rope_qk_launch(q.data_ptr(), k.data_ptr(), freqs_cis.data_ptr(),
                                             qr.data_ptr(), kr.data_ptr(), B, T, heads, D,
                                             int(q.dtype == torch.float16), cuda.stream_ptr(q))
    cuda.check(code, "rope_qk")
    cuda.count(rope_qk)
    return qr, kr


rope_qk.launches = 0


def attention_rope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lengths: torch.Tensor, freqs_cis: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """K2. q, k, v: (B, T, H*D) with D = 64; lengths: (B,) int; freqs_cis:
    (>= T, D/2, 2) f32 cos/sin. CPU tensors run the plain version; CUDA
    tensors (bf16 or fp16, contiguous; freqs_cis f32, contiguous) launch the
    rope pass into scratch q and k, then K2''s attention kernel on them (one
    host call; both counted: ``rope_qk.launches`` too); anything else
    raises."""
    cuda.refuse_grad("attention_rope", q, k, v, freqs_cis)
    if q.device.type == "cpu":
        return attention_rope_plain(q, k, v, lengths, freqs_cis, heads)
    B, T, D = _check_packed("attention_rope", heads, q, k, v)
    _check_freqs("attention_rope", freqs_cis, q, T, D)
    lens = _int32_lengths("attention_rope", lengths, q)
    # the scratch q and k are freed on return: the caching allocator hands
    # their memory only to later work on this stream
    qr, kr, out = torch.empty_like(q), torch.empty_like(k), torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = cuda.library().attention_rope_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), freqs_cis.data_ptr(),
            qr.data_ptr(), kr.data_ptr(), out.data_ptr(), B, T, heads, D, 1.0 / math.sqrt(D),
            int(q.dtype == torch.float16), cuda.stream_ptr(q))
    cuda.check(code, "attention_rope")
    cuda.count(rope_qk)
    cuda.count(attention_rope)
    return out


attention_rope.launches = 0


def packed_pair_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, heads: int) -> torch.Tensor:
    """K2'. q, k, v: (B, T, H*D) with D = 64 (the TPU kernel's pairing of
    heads on 128 lanes is a TPU layout and is not carried over: any H);
    lengths: (B,) int. CPU tensors run the plain version; CUDA tensors (bf16
    or fp16, contiguous) launch the kernel; anything else raises."""
    cuda.refuse_grad("packed_pair_attention", q, k, v)
    if q.device.type == "cpu":
        return packed_pair_attention_plain(q, k, v, lengths, heads)
    B, T, D = _check_packed("packed_pair_attention", heads, q, k, v)
    lens = _int32_lengths("packed_pair_attention", lengths, q)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = cuda.library().packed_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, T, heads, D, 1.0 / math.sqrt(D), int(q.dtype == torch.float16),
            cuda.stream_ptr(q))
    cuda.check(code, "packed_pair_attention")
    cuda.count(packed_pair_attention)
    return out


packed_pair_attention.launches = 0


def single_block_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 lengths: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B, H, T, D), the JAX kernel's math: f32 scores
    scaled by 1/sqrt(D); keys >= lengths[b] masked to -1e9; p = exp(s - max)
    / sum in f32, then rounded to v's dtype; PV with f32 sums; the output in
    q's dtype (k and v are taken in q's dtype)."""
    B, H, T, D = q.shape
    k, v = k.to(q.dtype), v.to(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(D))
    key_ok = (torch.arange(T, device=q.device)[None, :]
              < lengths.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(key_ok, s, torch.full_like(s, NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def single_block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """K4. q, k, v: (B, H, T, D) with D contiguous and the other strides
    and the base multiples of 16 bytes (a transposed (B, T, H, D) view is
    read in place, through a TMA tensor map), D a multiple of 16 up to 128;
    lengths: (B,) int. CPU tensors run the plain version; CUDA tensors (q
    bf16 or fp16; k and v taken in q's dtype) launch the kernel, whose
    output is the (B, H, T, D) view of a (B, T, H, D) buffer; anything else
    (a layout TMA cannot read included: no copy is made) raises."""
    cuda.refuse_grad("single_block_attention", q, k, v)
    if q.device.type == "cpu":
        return single_block_attention_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"single_block_attention: unsupported device {q.device}")
    B, H, T, D = q.shape
    if D % 16 or not 16 <= D <= 128:
        raise ValueError(f"single_block_attention: kernel takes a head dim that is a "
                         f"multiple of 16 up to 128, got {D}")
    _check_dtype("single_block_attention", q)
    k, v = k.to(q.dtype), v.to(q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"single_block_attention: {name} must be {tuple(q.shape)} "
                             f"on {q.device} with its last axis contiguous, got "
                             f"{tuple(t.shape)} on {t.device}, strides {t.stride()}")
        _check_aligned(f"single_block_attention: {name}", t)
    lens = _int32_lengths("single_block_attention", lengths, q)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        code = cuda.library().attention_block_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, H, T, D, *strides, 1.0 / math.sqrt(D), int(q.dtype == torch.float16),
            cuda.stream_ptr(q))
    cuda.check(code, "single_block_attention")
    cuda.count(single_block_attention)
    return out


single_block_attention.launches = 0
