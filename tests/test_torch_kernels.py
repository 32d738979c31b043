"""PyTorch port: the hand-written CUDA kernels against their plain twins.

Tests marked `cuda` need an NVIDIA GPU (sm_90a build) and skip elsewhere.
This file imports no jax, so on a machine with the card it runs on its own:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tolerances are the ones `chip_smoke.py` holds at the main path's shapes:
rel-L2 over valid rows <= 2e-2 for K2 (attention_rope, bf16 probabilities
before PV, online vs whole-row softmax) and <= 1e-2 for K3 (antialias_snake,
f32 inside, one bf16 rounding at the output).
"""

import pytest
import torch

from indextts_tpu_torch.ops import attn, snake
from indextts_tpu_torch.ops.rope import precompute_freqs_cis


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def rel_l2(a, b):
    return (torch.linalg.norm((a - b).float()) / torch.linalg.norm(b.float())).item()


def _attn_args(T, lengths, device, dtype=torch.bfloat16, H=8, D=64):
    g = torch.Generator().manual_seed(T)
    q, k, v = (torch.randn((len(lengths), T, H * D), generator=g).to(device, dtype)
               for _ in range(3))
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, k, v, lens, torch.as_tensor(precompute_freqs_cis(T, D), device=device), H


def _snake_args(T, C, lengths, device, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(C)
    x = (2 * torch.randn((len(lengths), T, C), generator=g)).to(device, dtype)
    alpha = (0.3 * torch.randn(C, generator=g)).to(device)
    beta = (0.3 * torch.randn(C, generator=g)).to(device)
    return x, alpha, beta, torch.tensor(lengths, device=device)


def test_cpu_tensors_run_the_plain_twins_without_counting():
    before = attn.attention_rope.launches, snake.antialias_snake.launches
    a = _attn_args(64, [64, 17], "cpu", torch.float32, H=2)
    torch.testing.assert_close(attn.attention_rope(*a), attn.attention_rope_plain(*a))
    s = _snake_args(64, 8, [64, 5], "cpu", torch.float32)
    torch.testing.assert_close(snake.antialias_snake(*s), snake.antialias_snake_plain(*s))
    assert (attn.attention_rope.launches, snake.antialias_snake.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("T,lengths", [(256, [256, 141]), (1000, [1000, 1]),
                                       (1280, [1201, 630])])
def test_attention_rope_kernel_matches_plain(cuda_device, T, lengths):
    a = _attn_args(T, lengths, cuda_device)
    before = attn.attention_rope.launches
    out = attn.attention_rope(*a)
    assert attn.attention_rope.launches == before + 1
    ref = attn.attention_rope_plain(*a)
    torch.cuda.synchronize()
    for b, L in enumerate(lengths):
        assert rel_l2(out[b, :L], ref[b, :L]) <= 2e-2
    assert torch.isfinite(out).all()


@pytest.mark.cuda
def test_attention_rope_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v, lens, fc, H = _attn_args(128, [128], cuda_device, torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        attn.attention_rope(q, k, v, lens, fc, H)
    q, k, v, lens, fc, H = _attn_args(128, [128], cuda_device, H=4, D=32)
    with pytest.raises(ValueError, match="head dim 64"):
        attn.attention_rope(q, k, v, lens, fc, H)


@pytest.mark.cuda
@pytest.mark.parametrize("T,C,lengths", [(512, 768, [512, 480]), (4096, 24, [4096, 4059]),
                                         (1000, 96, [1, 999])])
def test_antialias_snake_kernel_matches_plain(cuda_device, T, C, lengths):
    s = _snake_args(T, C, lengths, cuda_device)
    before = snake.antialias_snake.launches
    out = snake.antialias_snake(*s)
    assert snake.antialias_snake.launches == before + 1
    ref = snake.antialias_snake_plain(*s)
    torch.cuda.synchronize()
    for b, L in enumerate(lengths):
        assert rel_l2(out[b, :L], ref[b, :L]) <= 1e-2


@pytest.mark.cuda
def test_antialias_snake_kernel_rejects_non_contiguous(cuda_device):
    x, alpha, beta, lens = _snake_args(256, 32, [256], cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        snake.antialias_snake(x.transpose(1, 2).contiguous().transpose(1, 2),
                              alpha, beta, lens)
