"""PyTorch port, the DiT's attention tiers and the anti-alias entries: the
plain twins of K4 (single_block_attention), K2' (packed_pair_attention), K5
(fused_antialias_activation) and K3' (antialias_activation_prefolded)
against the JAX package's Pallas kernels in interpret mode, and the port's
DiT backbone in each of its three tiers against the JAX DiT on the CPU
(whose CPU path is the dense `nn.mha`, the same math as K4). Inputs come
from a seeded numpy generator; torch runs one intra-op thread.

Tolerances, each with its reason:
- f32: the JAX parity suite's atol 2e-4 / rtol 1e-3 (sums in another
  order); the anti-alias entries at `tests/test_pallas_antialias.py`'s
  atol 2e-5 / rtol 1e-4;
- bf16 attention: rel-L2 <= 1e-2 over valid query rows (the probabilities
  are rounded to bf16 on both sides, and a value near a rounding boundary
  can go either way after f32 sums in another order).

The CUDA kernels themselves are held against the twins on the card by
`tests/test_torch_kernels.py` and `chip_smoke.py`.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from indextts_tpu_torch.ops import attn as tattn
from indextts_tpu_torch.ops import snake as tsnake
from indextts_tpu_torch.utils.jax_params import to_torch

ATOL, RTOL = 2e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.as_tensor(np.array(x))


def _bf16(a) -> np.ndarray:
    """f32 values rounded to bf16 (kept in f32)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _rel_l2_valid(out, ref, lengths, time_axis):
    """Largest rel-L2 over each batch row's valid query rows (``time_axis``
    of the full array)."""
    worst = 0.0
    for b, L in enumerate(lengths):
        o = np.take(np.asarray(out, np.float32)[b], np.arange(L), axis=time_axis - 1)
        r = np.take(np.asarray(ref, np.float32)[b], np.arange(L), axis=time_axis - 1)
        worst = max(worst, float(np.linalg.norm(o - r) / np.linalg.norm(r)))
    return worst


# ------------------------------------------------------------ K4, K2' -------

@pytest.mark.parametrize("D", [32, 64, 128])
def test_single_block_attention_plain_matches_pallas(D):
    from indextts_tpu.ops.pallas.attn import single_block_attention

    rng = np.random.default_rng(D)
    B, H, T = 2, 3, 256
    lens = np.array([256, 131], np.int32)
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    ref = np.asarray(single_block_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(lens), interpret=True))
    out = tattn.single_block_attention(t(q), t(k), t(v), t(lens)).numpy()
    for b, L in enumerate(lens):
        np.testing.assert_allclose(out[b, :, :L], ref[b, :, :L], atol=ATOL, rtol=RTOL)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = single_block_attention(qb, kb, vb, jnp.asarray(lens), interpret=True)
    out = tattn.single_block_attention(*(t(_bf16(a)).to(torch.bfloat16) for a in (q, k, v)),
                                       t(lens))
    assert out.dtype == torch.bfloat16
    assert _rel_l2_valid(out.float(), np.asarray(ref, np.float32), lens, 2) <= 1e-2


def test_packed_pair_attention_plain_matches_pallas():
    from indextts_tpu.ops.pallas.attn import packed_pair_attention

    rng = np.random.default_rng(7)
    B, H, D, T = 2, 4, 64, 384
    lens = np.array([384, 131], np.int32)
    q, k, v = (rng.standard_normal((B, T, H * D)).astype(np.float32) for _ in range(3))
    ref = np.asarray(packed_pair_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(lens), heads=H, interpret=True))
    out = tattn.packed_pair_attention(t(q), t(k), t(v), t(lens), H).numpy()
    for b, L in enumerate(lens):
        np.testing.assert_allclose(out[b, :L], ref[b, :L], atol=ATOL, rtol=RTOL)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = packed_pair_attention(qb, kb, vb, jnp.asarray(lens), heads=H, interpret=True)
    out = tattn.packed_pair_attention(*(t(_bf16(a)).to(torch.bfloat16) for a in (q, k, v)),
                                      t(lens), H)
    assert _rel_l2_valid(out.float(), np.asarray(ref, np.float32), lens, 1) <= 1e-2


def test_mha_flash_matches_jax_off_the_tpu():
    """CPU tensors take the length-masked `nn.mha`, as the JAX package does
    off the TPU, causal or not; nothing is launched."""
    from indextts_tpu import nn as jnn
    from indextts_tpu_torch import nn as tnn

    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 2, 40, 32)).astype(np.float32) for _ in range(3))
    lens = np.array([40, 23], np.int32)
    before = tattn.single_block_attention.launches
    for causal in (False, True):
        ref = np.asarray(jnn.mha_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(lens), causal=causal))
        out = tnn.mha_flash(t(q), t(k), t(v), t(lens), causal=causal).numpy()
        for b, L in enumerate(lens):
            np.testing.assert_allclose(out[b, :, :L], ref[b, :, :L], atol=ATOL, rtol=RTOL)
    assert tattn.single_block_attention.launches == before


# ---------------------------------------------------------- DiT tiers -------

def _dit_cfgs(head_dim):
    from indextts_tpu.config import DiTConfig as JCfg
    from indextts_tpu_torch.config import DiTConfig as TCfg

    kw = dict(hidden_dim=2 * head_dim, num_heads=2, depth=2, content_dim=32)
    return JCfg(**kw), TCfg(**kw)


# (head width, the tier the port must pick, the environment that selects it)
TIERS = [(32, "flash", {}), (32, "dense", {"INDEXTTS_FLASH_DIT": "0"}),
         (64, "packed", {}), (64, "flash", {"INDEXTTS_PACKED_ATTN": "0"}),
         (64, "dense", {"INDEXTTS_PACKED_ATTN": "0", "INDEXTTS_FLASH_DIT": "0"})]


@functools.lru_cache(maxsize=None)
def _dit_case(head_dim):
    """The tiny DiT's weights and inputs at ``head_dim``, and the JAX DiT's
    output on them (one reference for every tier)."""
    from indextts_tpu.models.s2mel.dit import dit_backbone_forward as jforward
    from indextts_tpu.models.s2mel.dit import init_dit_backbone
    from indextts_tpu.nn import InitRng
    from indextts_tpu.ops.rope import precompute_freqs_cis

    jcfg, _ = _dit_cfgs(head_dim)
    p = init_dit_backbone(InitRng(head_dim), jcfg)
    rng = np.random.default_rng(head_dim)
    B, T, D = 2, 48, jcfg.hidden_dim
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    c = rng.standard_normal((B, 1, D)).astype(np.float32)
    lens = np.array([T, 29], np.int32)
    fc = precompute_freqs_cis(T, head_dim)
    mask = np.arange(T)[None, :] < lens[:, None]
    ref = np.asarray(jforward(p, jcfg, jnp.asarray(x), jnp.asarray(c), jnp.asarray(fc),
                              jnp.asarray(mask), jnp.asarray(lens)))
    return p, x, c, lens, fc, ref


@pytest.mark.parametrize("head_dim,tier,env", TIERS)
def test_dit_backbone_tier_matches_jax(monkeypatch, head_dim, tier, env):
    from indextts_tpu_torch.models.s2mel import dit as tdit

    for name in ("INDEXTTS_PACKED_ATTN", "INDEXTTS_FLASH_DIT"):
        monkeypatch.delenv(name, raising=False)
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    _, tcfg = _dit_cfgs(head_dim)
    p, x, c, lens, fc, ref = _dit_case(head_dim)
    assert tdit.attention_tier(tcfg, t(lens)) == tier
    out = tdit.dit_backbone_forward(to_torch(p), tcfg, t(x), t(c), t(fc), t(lens),
                                    torch.float32).numpy()
    for b, L in enumerate(lens):
        np.testing.assert_allclose(out[b, :L], ref[b, :L], atol=ATOL, rtol=RTOL)


def test_dit_attention_tier_dispatch(monkeypatch):
    """The JAX DiT's gate: packed for H even and 2 * head_dim == 128 unless
    INDEXTTS_PACKED_ATTN=0; else flash unless INDEXTTS_FLASH_DIT=0; else
    dense; no lengths, dense. Only the values "0" switch a tier off."""
    from indextts_tpu_torch.config import DiTConfig
    from indextts_tpu_torch.models.s2mel.dit import attention_tier

    lens = torch.tensor([5])
    monkeypatch.delenv("INDEXTTS_PACKED_ATTN", raising=False)
    monkeypatch.delenv("INDEXTTS_FLASH_DIT", raising=False)
    shipped = DiTConfig()                                  # H=8, head_dim=64
    assert attention_tier(shipped, lens) == "packed"
    assert attention_tier(shipped, None) == "dense"
    assert attention_tier(DiTConfig(hidden_dim=448, num_heads=7), lens) == "flash"  # H odd
    assert attention_tier(DiTConfig(hidden_dim=512, num_heads=16), lens) == "flash"  # Dh 32
    assert attention_tier(DiTConfig(hidden_dim=320, num_heads=8), lens) == "flash"  # Dh 40
    monkeypatch.setenv("INDEXTTS_PACKED_ATTN", "1")
    assert attention_tier(shipped, lens) == "packed"
    monkeypatch.setenv("INDEXTTS_PACKED_ATTN", "0")
    assert attention_tier(shipped, lens) == "flash"
    monkeypatch.setenv("INDEXTTS_FLASH_DIT", "0")
    assert attention_tier(shipped, lens) == "dense"


# ------------------------------------------------------------ K5, K3' -------

@pytest.mark.parametrize("logscale", [True, False])
def test_fused_antialias_activation_plain_matches_pallas(logscale):
    from indextts_tpu.ops.pallas.antialias import fused_antialias_activation

    rng = np.random.default_rng(5)
    B, T, C = 2, 256, 128
    lens = np.array([256, 150], np.int32)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    alpha = (rng.standard_normal(C) * 0.3).astype(np.float32)
    beta = (rng.standard_normal(C) * 0.3).astype(np.float32)
    if not logscale:                   # linear-scale parameters are positive
        alpha, beta = np.exp(alpha), np.exp(beta)
    ref = np.asarray(fused_antialias_activation(
        jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta), lengths=jnp.asarray(lens),
        logscale=logscale, t_tile=128, interpret=True))
    before = tsnake.fused_antialias_activation.launches
    out = tsnake.fused_antialias_activation(t(x), t(alpha), t(beta), t(lens),
                                            logscale=logscale).numpy()
    assert tsnake.fused_antialias_activation.launches == before
    for b, L in enumerate(lens):
        np.testing.assert_allclose(out[b, :L], ref[b, :L], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("T,C,f,edge_len", [(256, 24, 16, 219), (512, 48, 8, 475),
                                            (512, 96, 4, 1), (256, 192, 2, 129)])
def test_antialias_prefolded_plain_matches_pallas(T, C, f, edge_len):
    from indextts_tpu.ops.pallas.antialias import fused_antialias_prefolded

    rng = np.random.default_rng(T + C)
    B = 2
    xf = (rng.standard_normal((B, T // f, f * C)) * 2).astype(np.float32)
    alpha = (rng.standard_normal(C) * 0.3).astype(np.float32)
    beta = (rng.standard_normal(C) * 0.3).astype(np.float32)
    lens = np.array([T, edge_len], np.int32)
    ref = np.asarray(fused_antialias_prefolded(
        jnp.asarray(xf), jnp.asarray(alpha), jnp.asarray(beta), f, C, jnp.asarray(lens),
        r_tile=min(256, T // f), interpret=True)).reshape(B, T, C)
    out = tsnake.antialias_activation_prefolded(t(xf), t(alpha), t(beta), f, C, t(lens))
    assert out.shape == xf.shape
    out = out.numpy().reshape(B, T, C)
    for b, L in enumerate(lens):
        np.testing.assert_allclose(out[b, :L], ref[b, :L], atol=2e-5, rtol=1e-4)


def test_antialias_prefolded_refuses_a_layout_it_would_copy():
    xf = torch.zeros((1, 8, 4 * 32)).transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tsnake.antialias_activation_prefolded(xf, torch.zeros(32), None, 4, 32)
    with pytest.raises(ValueError, match="f\\*C"):
        tsnake.antialias_activation_prefolded(torch.zeros((1, 8, 96)), torch.zeros(32),
                                              None, 4, 32)
