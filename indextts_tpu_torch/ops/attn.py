"""The DiT's attention kernels and their plain twins.

- `attention_rope` (K2) is the port of `indextts_tpu/ops/pallas/attn.py::
  packed_pair_attention_rope`: (B, T, H*D) attention with the half-split
  rope fused in; `packed_pair_attention` (K2') is `packed_pair_attention`,
  the same without the rope. Both run `csrc/attention_rope.cu` (K2' is its
  ``ROPE=false`` instantiation): the probabilities are rounded to bf16
  unnormalized and the row sum divides after PV.
- `single_block_attention` (K4) is `single_block_attention`: (B, H, T, D)
  attention whose probabilities are normalized before they are rounded to
  v's dtype, the DiT's flash tier through `nn.mha_flash`. It runs
  `csrc/attention_block.cu`.

On a CUDA tensor each entry launches its hand-written Hopper kernel (or
raises); on a CPU tensor it runs its ``*_plain`` twin, the same math in
plain PyTorch, which the CPU tests hold against the JAX kernel and
`chip_smoke.py` holds the CUDA kernel against on the card. Each entry counts
its kernel launches in ``.launches``.
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


def _check_packed(name: str, q, k, v, lengths, heads: int):
    """The (B, T, H*64) bf16 operands of K2 / K2' on one CUDA device."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, T, HD = q.shape
    D = HD // heads
    if D != 64 or heads * D != HD:
        raise ValueError(f"{name}: kernel takes head dim 64, got {HD}/{heads}")
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != torch.bfloat16 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous bf16 "
                             f"{tuple(q.shape)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if lengths.shape != (B,) or lengths.device != q.device:
        raise ValueError(f"{name}: lengths must be ({B},) on {q.device}")
    return B, T, D, lengths.to(torch.int32).contiguous()


def attention_rope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lengths: torch.Tensor, freqs_cis: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """K2. q, k, v: (B, T, H*D) with D = 64; lengths: (B,) int; freqs_cis:
    (>= T, D/2, 2) f32 cos/sin. CPU tensors run the plain version; CUDA
    tensors (bf16, contiguous) launch the kernel; anything else raises."""
    if q.device.type == "cpu":
        return attention_rope_plain(q, k, v, lengths, freqs_cis, heads)
    B, T, D, lens = _check_packed("attention_rope", q, k, v, lengths, heads)
    if freqs_cis.shape[0] < T or tuple(freqs_cis.shape[1:]) != (D // 2, 2) \
            or freqs_cis.device != q.device:
        raise ValueError(f"attention_rope: freqs_cis must be (>={T}, {D // 2}, 2) "
                         f"on {q.device}")
    cos = freqs_cis[:T, :, 0].float().contiguous()
    sin = freqs_cis[:T, :, 1].float().contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = cuda.library().attention_rope_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            cos.data_ptr(), sin.data_ptr(), out.data_ptr(), B, T, heads, D,
            1.0 / math.sqrt(D), cuda.stream_ptr(q))
    cuda.check(code, "attention_rope")
    attention_rope.launches += 1
    return out


attention_rope.launches = 0


def packed_pair_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, heads: int) -> torch.Tensor:
    """K2'. q, k, v: (B, T, H*D) with D = 64 (the TPU kernel's pairing of
    heads on 128 lanes is a TPU layout and is not carried over: any H);
    lengths: (B,) int. CPU tensors run the plain version; CUDA tensors (bf16,
    contiguous) launch the kernel; anything else raises."""
    if q.device.type == "cpu":
        return packed_pair_attention_plain(q, k, v, lengths, heads)
    B, T, D, lens = _check_packed("packed_pair_attention", q, k, v, lengths, heads)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = cuda.library().packed_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, T, heads, D, 1.0 / math.sqrt(D), cuda.stream_ptr(q))
    cuda.check(code, "packed_pair_attention")
    packed_pair_attention.launches += 1
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
    """K4. q, k, v: (B, H, T, D), any strides with D contiguous (a
    transposed (B, T, H, D) view is read in place), D a multiple of 16 up to
    128; lengths: (B,) int. CPU tensors run the plain version; CUDA tensors
    (q bf16; k and v taken in q's dtype) launch the kernel, whose output is
    the (B, H, T, D) view of a (B, T, H, D) buffer; anything else raises."""
    if q.device.type == "cpu":
        return single_block_attention_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"single_block_attention: unsupported device {q.device}")
    B, H, T, D = q.shape
    if D % 16 or not 16 <= D <= 128:
        raise ValueError(f"single_block_attention: kernel takes a head dim that is a "
                         f"multiple of 16 up to 128, got {D}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"single_block_attention: q must be bf16, got {q.dtype}")
    k, v = k.to(q.dtype), v.to(q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"single_block_attention: {name} must be {tuple(q.shape)} "
                             f"on {q.device} with its last axis contiguous, got "
                             f"{tuple(t.shape)} on {t.device}, strides {t.stride()}")
    if lengths.shape != (B,) or lengths.device != q.device:
        raise ValueError(f"single_block_attention: lengths must be ({B},) on {q.device}")
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        code = cuda.library().attention_block_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, H, T, D, *strides, 1.0 / math.sqrt(D), cuda.stream_ptr(q))
    cuda.check(code, "single_block_attention")
    single_block_attention.launches += 1
    return out


single_block_attention.launches = 0
