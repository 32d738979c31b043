"""PyTorch port, the DVAE (`indextts_tpu_torch/models/codec/dvae.py`) and its
converter against the JAX package's on the CPU: the tokenization mel, the
codes (equal), the decode, and `convert_dvae` on a random state dict in the
reference layout. Inputs come from a seeded numpy generator.

Tolerance: the JAX parity suite's f32 atol 2e-4 / rtol 1e-3 (the mel's
log and the convolutions sum in another order); codes are held equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu.models.codec import dvae as jdvae
from indextts_tpu.nn import InitRng
from indextts_tpu_torch.models.codec import dvae as tdvae
from indextts_tpu_torch.utils.jax_params import to_torch

ATOL, RTOL = 2e-4, 1e-3
SMALL = dict(num_tokens=64, codebook_dim=16, hidden_dim=16)


def _wav(seconds: float, rows: int = 2) -> np.ndarray:
    r = np.random.default_rng(0)
    t = np.arange(int(22050 * seconds)) / 22050
    tone = 0.3 * np.sin(2 * np.pi * 220 * t)
    return (tone + 0.05 * r.standard_normal((rows, t.size))).astype(np.float32)


def _mel(seconds: float) -> tuple:
    wav = _wav(seconds)
    norms = (1.0 + np.random.default_rng(1).random(80)).astype(np.float32)
    want = np.asarray(jdvae.dvae_wav_to_mel(jnp.asarray(wav), jnp.asarray(norms)))
    got = tdvae.dvae_wav_to_mel(torch.tensor(wav), torch.tensor(norms)).numpy()
    return got, want


def test_wav_to_mel_matches_jax():
    got, want = _mel(1.0)
    assert got.shape == want.shape == (2, 80, 87)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("size", ["small", "published"])
def test_codes_and_decode_match_jax(size):
    """Codes equal and the decode within tolerance, at a small size and at
    `init_dvae`'s published defaults (8192 tokens, codebook 512, hidden 512,
    2 layers, 3 res-blocks)."""
    kw = SMALL if size == "small" else {}
    params = jax.tree_util.tree_map(np.asarray, jdvae.init_dvae(InitRng(0), **kw))
    assert to_torch(params).keys() == params.keys()
    mel = np.ascontiguousarray(_mel(1.0)[1].transpose(0, 2, 1))
    want = np.asarray(jdvae.dvae_codebook_indices(params, jnp.asarray(mel)))
    got = tdvae.dvae_codebook_indices(to_torch(params), torch.tensor(mel)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (2, 21)
    np.testing.assert_array_equal(got, want)
    recon = np.asarray(jdvae.dvae_decode(params, jnp.asarray(want)))
    out = tdvae.dvae_decode(to_torch(params), torch.tensor(want)).numpy()
    assert out.shape == recon.shape == (2, 84, 80)
    np.testing.assert_allclose(out, recon, atol=ATOL, rtol=RTOL)


def test_port_init_has_the_jax_tree_shapes():
    from indextts_tpu_torch.nn import InitRng as TRng

    want = jdvae.init_dvae(InitRng(0), **SMALL)
    got = tdvae.init_dvae(TRng(0), **SMALL)
    shapes = jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), want)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == shapes


def test_convert_dvae_matches_the_jax_converter():
    """A state dict in the reference DiscreteVAE's key layout (1-D, 2 layers,
    3 res-blocks, transposed convs) through both converters."""
    from indextts_tpu.utils import convert as jconvert
    from indextts_tpu_torch.utils import convert as tconvert

    r = np.random.default_rng(0)
    C, H, D, N, n_res, W = 8, 16, 12, 32, 3, 4
    shapes = {"encoder.0.0": (H, C, W), "encoder.1.0": (2 * H, H, W),
              "encoder.5": (D, 2 * H, 1), "decoder.0": (2 * H, D, 1),
              "decoder.4.0": (2 * H, 2 * H, W), "decoder.5.0": (2 * H, H, W),
              "decoder.6": (C, H, 1)}
    for i in range(n_res):
        for prefix, ch in ((f"encoder.{2 + i}", 2 * H), (f"decoder.{1 + i}", 2 * H)):
            for j, w in ((0, 3), (2, 3), (4, 1)):
                shapes[f"{prefix}.net.{j}"] = (ch, ch, w)
    sd = {"codebook.embed": r.standard_normal((D, N)).astype(np.float32)}
    for key, shape in shapes.items():
        sd[f"{key}.weight"] = r.standard_normal(shape).astype(np.float32)
        out_ch = shape[1] if key in ("decoder.4.0", "decoder.5.0") else shape[0]  # convT
        sd[f"{key}.bias"] = r.standard_normal((out_ch,)).astype(np.float32)
    want = jconvert.convert_dvae(sd)
    got = tconvert.convert_dvae(sd)
    fw, tw = jax.tree_util.tree_flatten(want)
    fg, tg = jax.tree_util.tree_flatten(got)
    assert tg == tw
    for a, b in zip(fg, fw):
        np.testing.assert_array_equal(a, b)
    # the converted tree runs in the port as it does in JAX
    mel = r.standard_normal((1, 24, C)).astype(np.float32)
    codes = np.asarray(jdvae.dvae_codebook_indices(want, jnp.asarray(mel)))
    np.testing.assert_array_equal(
        tdvae.dvae_codebook_indices(to_torch(got), torch.tensor(mel)).numpy(), codes)
    np.testing.assert_allclose(
        tdvae.dvae_decode(to_torch(got), torch.tensor(codes)).numpy(),
        np.asarray(jdvae.dvae_decode(want, jnp.asarray(codes))), atol=ATOL, rtol=RTOL)
