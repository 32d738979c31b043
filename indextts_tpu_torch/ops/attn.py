"""DiT attention with the half-split rope fused in: kernel K2 and its plain twin.

`attention_rope` is the port of `indextts_tpu/ops/pallas/attn.py::
packed_pair_attention_rope`. On a CUDA tensor it launches the hand-written
Hopper kernel `csrc/attention_rope.cu` (or raises); on a CPU tensor it runs
`attention_rope_plain`, the same math in plain PyTorch, which the CPU tests
hold against the JAX kernel and `chip_smoke.py` holds the CUDA kernel
against on the card.
"""

from __future__ import annotations

import math

import torch

from indextts_tpu_torch.ops import cuda
from indextts_tpu_torch.ops.rope import apply_rotary_emb_half


def attention_rope_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, freqs_cis: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """(B, T, H*D) pre-rope q, k and v -> (B, T, H*D) attention output.

    Rope on q and k in f32, rounded to the input dtype; f32 scores scaled by
    1/sqrt(D); keys >= lengths[b] masked to -1e9; f32 softmax against the
    row max; probabilities rounded to v's dtype before PV; the f32 row sum
    divides after PV. Query rows past lengths[b] are garbage the caller
    masks."""
    B, T, HD = q.shape
    D = HD // heads
    qr = apply_rotary_emb_half(q.reshape(B, T, heads, D), freqs_cis)
    kr = apply_rotary_emb_half(k.reshape(B, T, heads, D), freqs_cis)
    vh = v.reshape(B, T, heads, D)
    s = torch.einsum("bqhd,bkhd->bhqk", qr.float(), kr.float()) * (1.0 / math.sqrt(D))
    key_ok = (torch.arange(T, device=q.device)[None, :]
              < lengths.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(key_ok, s, torch.full_like(s, -1e9))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    r = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vh.float()) / r
    return o.permute(0, 2, 1, 3).reshape(B, T, HD).to(q.dtype)


def attention_rope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lengths: torch.Tensor, freqs_cis: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """K2. q, k, v: (B, T, H*D) with D = 64; lengths: (B,) int; freqs_cis:
    (>= T, D/2, 2) f32 cos/sin. CPU tensors run the plain version; CUDA
    tensors (bf16, contiguous) launch the kernel; anything else raises."""
    if q.device.type == "cpu":
        return attention_rope_plain(q, k, v, lengths, freqs_cis, heads)
    if q.device.type != "cuda":
        raise ValueError(f"attention_rope: unsupported device {q.device}")
    B, T, HD = q.shape
    D = HD // heads
    if D != 64 or heads * D != HD:
        raise ValueError(f"attention_rope: kernel takes head dim 64, got {HD}/{heads}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != torch.bfloat16 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"attention_rope: {name} must be contiguous bf16 "
                             f"{tuple(q.shape)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if lengths.shape != (B,) or lengths.device != q.device:
        raise ValueError(f"attention_rope: lengths must be ({B},) on {q.device}")
    if freqs_cis.shape[0] < T or tuple(freqs_cis.shape[1:]) != (D // 2, 2) \
            or freqs_cis.device != q.device:
        raise ValueError(f"attention_rope: freqs_cis must be (>={T}, {D // 2}, 2) "
                         f"on {q.device}")
    lens = lengths.to(torch.int32).contiguous()
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
