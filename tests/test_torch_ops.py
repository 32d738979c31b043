"""PyTorch port, ops layer: the kernels' plain twins (K2 attention_rope, K3
antialias_snake) against the JAX package's Pallas kernels in interpret mode
and its XLA paths; the front-end features, warpers and layer helpers against
their JAX counterparts. Inputs come from a seeded numpy generator; f32.

The CUDA kernels themselves are held against the twins on the card by
`tests/test_torch_kernels.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from indextts_tpu_torch import nn as tnn
from indextts_tpu_torch.ops import attn as tattn
from indextts_tpu_torch.ops import mel as tmel
from indextts_tpu_torch.ops import sampling as tsamp
from indextts_tpu_torch.ops import snake as tsnake
from indextts_tpu_torch.ops.rope import precompute_freqs_cis
from indextts_tpu_torch.utils.jax_params import to_torch

ATOL, RTOL = 2e-4, 1e-3     # the JAX parity suite's f32 convention


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread keeps this file from oversubscribing
    the cores the other test workers share; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------- K2 -------

def _attn_inputs(rng, B=2, H=2, D=64, T=256):
    q, k, v = (rng.standard_normal((B, T, H * D)).astype(np.float32) for _ in range(3))
    lengths = np.array([T, 141], np.int32)
    return q, k, v, lengths, precompute_freqs_cis(T, D)


def test_attention_rope_plain_matches_pallas_and_dense(rng):
    from indextts_tpu import nn as jnn
    from indextts_tpu.ops.pallas.attn import packed_pair_attention_rope
    from indextts_tpu.ops.rope import apply_rotary_emb_half

    B, H, D, T = 2, 2, 64, 256
    q, k, v, lengths, freqs = _attn_inputs(rng, B, H, D, T)
    out = tattn.attention_rope(t(q), t(k), t(v), t(lengths), t(freqs), H).numpy()
    kern = np.asarray(packed_pair_attention_rope(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        jnp.asarray(freqs), heads=H, interpret=True))
    qr = apply_rotary_emb_half(jnp.asarray(q).reshape(B, T, H, D), jnp.asarray(freqs))
    kr = apply_rotary_emb_half(jnp.asarray(k).reshape(B, T, H, D), jnp.asarray(freqs))
    mask = (jnp.arange(T)[None, :] < jnp.asarray(lengths)[:, None])[:, None, None, :]
    dense = jnn.mha(qr.transpose(0, 2, 1, 3), kr.transpose(0, 2, 1, 3),
                    jnp.asarray(v).reshape(B, T, H, D).transpose(0, 2, 1, 3), mask=mask)
    dense = np.asarray(dense.transpose(0, 2, 1, 3).reshape(B, T, H * D))
    for b, L in enumerate(lengths):
        np.testing.assert_allclose(out[b, :L], kern[b, :L], atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(out[b, :L], dense[b, :L], atol=1e-4, rtol=1e-3)


def test_attention_rope_rejects_non_cpu_non_cuda():
    x = torch.zeros((1, 8, 64), device="meta")
    before = tattn.attention_rope.launches
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.attention_rope(x, x, x, torch.ones(1, dtype=torch.int32, device="meta"),
                             torch.zeros((8, 32, 2), device="meta"), 1)
    assert tattn.attention_rope.launches == before


# ---------------------------------------------------------------- K3 -------

def test_kaiser_filters_equal_jax():
    from indextts_tpu.ops.snake import down_filter, up_filter

    np.testing.assert_array_equal(tsnake.up_filter(2), up_filter(2))
    np.testing.assert_array_equal(tsnake.down_filter(2), down_filter(2))


@pytest.mark.parametrize("T,C,f", [(256, 24, 16), (512, 48, 8), (512, 96, 4),
                                   (256, 192, 2), (1024, 384, 1)])
def test_antialias_snake_plain_matches_pallas_and_xla(rng, T, C, f):
    from indextts_tpu.ops.pallas.antialias import fused_antialias_folded
    from indextts_tpu.ops.snake import antialias_activation_xla

    B = 2
    x = (rng.standard_normal((B, T, C)) * 2).astype(np.float32)
    alpha = (rng.standard_normal(C) * 0.3).astype(np.float32)
    beta = (rng.standard_normal(C) * 0.3).astype(np.float32)
    lens = np.array([T, max(T - 37, 1)], np.int32)
    out = tsnake.antialias_snake(t(x), t(alpha), t(beta), t(lens)).numpy()
    ref = np.asarray(antialias_activation_xla(jnp.asarray(x), jnp.asarray(alpha),
                                              jnp.asarray(beta), jnp.asarray(lens)))
    kern = np.asarray(fused_antialias_folded(
        jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta), f, jnp.asarray(lens),
        r_tile=min(256, T // f), interpret=True))
    for b, L in enumerate(lens):
        np.testing.assert_allclose(out[b, :L], ref[b, :L], atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(out[b, :L], kern[b, :L], atol=2e-5, rtol=1e-4)


def test_antialias_snake_plain_snake_variant(rng):
    """beta None is Snake (alpha for both), as in the JAX package."""
    from indextts_tpu.ops.snake import antialias_activation_xla

    x = rng.standard_normal((1, 64, 8)).astype(np.float32)
    alpha = (rng.standard_normal(8) * 0.3).astype(np.float32)
    out = tsnake.antialias_snake(t(x), t(alpha), None).numpy()
    ref = np.asarray(antialias_activation_xla(jnp.asarray(x), jnp.asarray(alpha), None))
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)


# ----------------------------------------------------------- front-end -----

def test_mel_spectrogram_and_kaldi_fbank_match_jax(rng):
    from indextts_tpu.ops.mel import kaldi_fbank, mel_spectrogram

    y = (0.3 * rng.standard_normal((1, 256 * 40))).astype(np.float32)
    np.testing.assert_allclose(tmel.mel_spectrogram(t(y)).numpy(),
                               np.asarray(mel_spectrogram(jnp.asarray(y))),
                               atol=ATOL, rtol=RTOL)
    y16 = (0.3 * rng.standard_normal((1, 160 * 50 + 240))).astype(np.float32)
    np.testing.assert_allclose(tmel.kaldi_fbank(t(y16)).numpy(),
                               np.asarray(kaldi_fbank(jnp.asarray(y16))),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n", [16000, 16160])    # even and odd frame counts
def test_seamless_features_match_transformers(n):
    from transformers import SeamlessM4TFeatureExtractor

    tt = np.arange(n) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 220 * tt)
           + 0.01 * np.random.default_rng(1).standard_normal(n)).astype(np.float32)[None]
    ref = SeamlessM4TFeatureExtractor()(wav, sampling_rate=16000, return_tensors="np")
    feats, mask = tmel.seamless_m4t_features(wav)
    assert feats.shape == ref["input_features"].shape
    np.testing.assert_array_equal(mask, ref["attention_mask"])
    np.testing.assert_allclose(feats, ref["input_features"], atol=1e-4)


# -------------------------------------------------------------- warpers ----

def test_warpers_match_jax(rng):
    from indextts_tpu.ops import sampling as jsamp

    logits = rng.standard_normal((3, 50)).astype(np.float32) * 3
    counts = (rng.random((3, 50)) < 0.2).astype(np.int32)
    lf = tsamp.apply_repetition_penalty(t(logits), t(counts), 10.0)
    jf = jsamp.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(counts), 10.0)
    np.testing.assert_allclose(lf.numpy(), np.asarray(jf), rtol=1e-6)
    for fn_t, fn_j, arg in ((tsamp.apply_top_k, jsamp.apply_top_k, 7),
                            (tsamp.apply_top_p, jsamp.apply_top_p, 0.8),
                            (tsamp.apply_temperature, jsamp.apply_temperature, 0.8)):
        np.testing.assert_allclose(fn_t(lf, arg).numpy(), np.asarray(fn_j(jf, arg)),
                                   rtol=1e-6)


# --------------------------------------------------------- layer helpers ---

def test_layer_helpers_match_jax(rng):
    from indextts_tpu import nn as jnn

    x = rng.standard_normal((2, 20, 12)).astype(np.float32)
    lens = np.array([20, 13], np.int32)
    p = {"weight": rng.standard_normal(12).astype(np.float32),
         "bias": rng.standard_normal(12).astype(np.float32)}
    tp = to_torch(p)
    np.testing.assert_allclose(tnn.layer_norm(tp, t(x)).numpy(),
                               np.asarray(jnn.layer_norm(p, jnp.asarray(x))), atol=ATOL)
    mask = np.arange(20)[None] < lens[:, None]
    np.testing.assert_allclose(
        tnn.group_norm(tp, t(x), 3, mask=t(mask)).numpy(),
        np.asarray(jnn.group_norm(p, jnp.asarray(x), 3, mask=jnp.asarray(mask))), atol=ATOL)
    np.testing.assert_array_equal(
        tnn.masked_reflect_pad(t(x), t(lens), 3, 2).numpy(),
        np.asarray(jnn.masked_reflect_pad(jnp.asarray(x), jnp.asarray(lens), 3, 2)))
    np.testing.assert_allclose(tnn.gelu_new(t(x)).numpy(),
                               np.asarray(jnn.gelu_new(jnp.asarray(x))), atol=1e-6)


@pytest.mark.parametrize("kind", ["dense", "conv1d", "conv_transpose1d", "conv2d"])
def test_bridge_layouts(rng, kind):
    """Each JAX kernel layout, through the bridge, computes the same layer."""
    from indextts_tpu import nn as jnn

    jr = jnn.InitRng(3)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    if kind == "dense":
        p = jnn.dense_init(jr, 6, 5)
        ref, out = jnn.dense(p, jnp.asarray(x)), tnn.dense(to_torch(p), t(x))
    elif kind == "conv1d":
        p = jnn.conv1d_init(jr, 6, 4, 3)
        ref = jnn.conv1d(p, jnp.asarray(x), padding=2, dilation=2)
        out = tnn.conv1d(to_torch(p), t(x), padding=2, dilation=2)
    elif kind == "conv_transpose1d":
        p = {"ups": [{"kernel": jr.normal((8, 6, 3), 0.3), "bias": jr.normal((3,), 0.1)}]}
        ref = jnn.conv_transpose1d(p["ups"][0], jnp.asarray(x), stride=4, padding=2)
        out = tnn.conv_transpose1d(to_torch(p)["ups"][0], t(x), stride=4, padding=2)
    else:
        p = jnn.conv2d_init(jr, 1, 4, 3, 3)
        ref = jnn.conv2d(p, jnp.asarray(x)[..., None], stride=(2, 2)).transpose(0, 3, 1, 2)
        out = tnn.conv2d(to_torch(p), t(x)[:, None], stride=(2, 2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
