"""PyTorch port, the configuration options of ported modules that the shipped
config does not use: the conformer's conv2d / conv2d6 / conv2d8 input
layers, the discrete-code length regulator, the causal DiT, the DiT's mlp
final head, ``style_condition=False`` and ``style_as_token``, and RepCodec
downsampling, against the JAX package on the CPU.

For each option: the port's init tree has the JAX init tree's structure
(keys, shapes, dtypes; the two InitRngs draw different numbers), the port's
forward on the JAX tree (through the weight bridge) equals the JAX forward
on the same input at f32 within the JAX parity suite's atol 2e-4 / rtol
1e-3 (`tests/test_parity_gpt.py`), and a state dict in the reference
layout (written by `tools/torch_reference_ckpt.py`) converts back through
`indextts_tpu_torch/utils/convert.py` to the JAX tree: exactly, but the
weight-normed leaves the writer folds, within 1 f32 ulp. The causal DiT and
the mlp head also run on a sequence-parallel CPU mesh (sp=2) against the JAX
single-device CFM, as `tests/test_torch_mesh.py` holds the shipped DiT.

Inputs come from seeded numpy generators; torch runs one intra-op thread.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, "tests")
sys.path.insert(0, "tools")

import torch_reference_ckpt as refckpt  # noqa: E402
from test_pipeline_e2e import tiny_config  # noqa: E402

from indextts_tpu.nn import InitRng  # noqa: E402
from indextts_tpu_torch import nn as tnn  # noqa: E402
from indextts_tpu_torch.utils import convert as tconv  # noqa: E402
from indextts_tpu_torch.utils.jax_params import to_torch  # noqa: E402

ATOL, RTOL = 2e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=ATOL, rtol=RTOL)


def _same_structure(port_tree, jax_tree):
    """The port's init tree against the JAX one, both through the bridge:
    the same leaves, shapes and dtypes."""
    def structure(tree):
        return {path: (x.shape, x.dtype) for path, x in _leaves(to_torch(tree))}
    assert structure(port_tree) == structure(jax_tree)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


def _round_trip(tree, write, convert, weight_normed=()):
    """``write(sd)`` puts ``tree`` (a JAX-layout tree) into a reference-layout
    state dict; ``convert(sd)`` is the port's converter: the tree comes back,
    exactly, but the leaves named in ``weight_normed`` (the writer's weight
    norm, folded back) within 1 f32 ulp."""
    sd = {}
    write(sd)
    back = convert({k: v.numpy() for k, v in sd.items()})
    a, b = dict(_leaves(jax.device_get(tree))), dict(_leaves(back))
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    for path, x in a.items():
        y = b[path]
        assert x.shape == y.shape, path
        if any(path.endswith(w) for w in weight_normed):
            np.testing.assert_array_max_ulp(y.astype(np.float32), x.astype(np.float32), maxulp=1)
        else:
            assert np.array_equal(x.astype(np.float32), y.astype(np.float32)), path


# ---------------------------------------------------------------------------
# the conformer's subsampling input layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("input_layer", ["conv2d", "conv2d6", "conv2d8"])
def test_conformer_subsampling_layers_match_jax(input_layer):
    from indextts_tpu.models.gpt import conformer as jc
    from indextts_tpu_torch.models.gpt import conformer as tc

    dims = dict(input_size=40, output_size=32, attention_heads=2, linear_units=48,
                num_blocks=1, input_layer=input_layer, cnn_module_kernel=5)
    jd, td = jc.ConformerDims(**dims), tc.ConformerDims(**dims)
    p = jc.init_conformer(InitRng(3), jd)
    _same_structure(tc.init_conformer(tnn.InitRng(3), td), p)
    rng = np.random.default_rng(4)
    T = 71
    xs = rng.standard_normal((3, T, 40)).astype(np.float32)
    # lengths whose subsampled masks differ with every stride and offset
    lens = np.array([T, 52, 23], np.int32)
    ref, ref_mask = jc.conformer_encode(p, jd, jnp.asarray(xs), jnp.asarray(lens))
    out, mask = tc.conformer_encode(to_torch(p), td, _t(xs), _t(lens))
    assert out.shape == ref.shape and ref.shape[1] < T // 2
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    keep = np.asarray(ref_mask)
    _close(out.numpy()[keep], np.asarray(ref)[keep])
    _round_trip(p, lambda sd: refckpt.conformer(sd, p, input_layer, "enc."),
                lambda sd: tconv.convert_conformer(sd, 1, input_layer, "enc."))


def test_conformer_refuses_an_unknown_input_layer():
    from indextts_tpu_torch.models.gpt import conformer as tc

    with pytest.raises(ValueError, match="conv2d4"):
        tc.init_conformer(tnn.InitRng(0), tc.ConformerDims(input_layer="conv2d4"))


# ---------------------------------------------------------------------------
# the length regulator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "continuous"])
def test_length_regulator_matches_jax(discrete):
    from indextts_tpu.config import LengthRegulatorConfig
    from indextts_tpu.models.s2mel import length_regulator as jl
    from indextts_tpu_torch.models.s2mel import length_regulator as tl

    cfg = LengthRegulatorConfig(channels=16, is_discrete=discrete, content_codebook_size=32,
                                in_channels=24, sampling_ratios=(1, 1), out_channels=20)
    p = jl.init_length_regulator(InitRng(5), cfg)
    _same_structure(tl.init_length_regulator(tnn.InitRng(5), cfg), p)
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 32, (2, 21)).astype(np.int32)
    feats = rng.standard_normal((2, 21, 24)).astype(np.float32)
    clen, ylen = np.array([21, 13]), np.array([36, 22])
    ref = jl.length_regulate(p, cfg, jnp.asarray(codes), jnp.asarray(clen), jnp.asarray(ylen),
                             out_size=40, features=jnp.asarray(feats))
    out = tl.length_regulate(to_torch(p), cfg, _t(clen), _t(ylen), out_size=40,
                             features=None if discrete else _t(feats),
                             codes=_t(codes) if discrete else None)
    assert out.shape == (2, 40, 20)
    _close(out, ref)
    if discrete:
        with pytest.raises(ValueError, match="codes"):
            tl.length_regulate(to_torch(p), cfg, _t(clen), _t(ylen), out_size=40)
    _round_trip(p, lambda sd: refckpt.length_regulator(sd, p, cfg, "lr."),
                lambda sd: tconv.convert_length_regulator(sd, cfg, "lr."))


# ---------------------------------------------------------------------------
# the DiT's options
# ---------------------------------------------------------------------------

DIT_OPTIONS = {"causal": dict(is_causal=True), "mlp-head": dict(final_layer_type="mlp"),
               "no-style": dict(style_condition=False), "style-as-token": dict(style_as_token=True)}
# the leaves `tools/torch_reference_ckpt.py::dit` writes with a weight norm
DIT_WEIGHT_NORMED = ("x_embedder/kernel", "final_layer/linear/kernel", "in_layer/kernel",
                     "res_skip/kernel", "cond_layer/kernel")


def _dit_s2(option: str):
    s2 = tiny_config().s2mel
    return dataclasses.replace(s2, DiT=dataclasses.replace(s2.DiT, **DIT_OPTIONS[option]))


@pytest.mark.parametrize("option", list(DIT_OPTIONS))
def test_dit_option_matches_jax(option):
    from indextts_tpu.models.s2mel import dit as jdit
    from indextts_tpu.ops.rope import precompute_freqs_cis
    from indextts_tpu_torch.models.s2mel import dit as tdit

    s2 = _dit_s2(option)
    p = jdit.init_dit(InitRng(7), s2)
    _same_structure(tdit.init_dit(tnn.InitRng(7), s2), p)
    rng = np.random.default_rng(8)
    B, T = 2, 40
    x, prompt = (rng.standard_normal((B, T, 80)).astype(np.float32) for _ in range(2))
    cond = rng.standard_normal((B, T, s2.DiT.content_dim)).astype(np.float32)
    style = rng.standard_normal((B, s2.style_encoder.dim)).astype(np.float32)
    lens, tt = np.array([T, 29]), np.array([0.3, 0.7], np.float32)
    fc = precompute_freqs_cis(T, s2.DiT.head_dim, s2.DiT.rope_base)
    ref = np.asarray(jdit.dit_forward(p, s2, *map(jnp.asarray, (x, prompt, lens, tt, style,
                                                                cond)),
                                      freqs_cis=jnp.asarray(fc)))
    tier = tdit.attention_tier(s2.DiT, _t(lens))
    assert (tier == "dense") == (option == "causal")     # the kernels' tiers otherwise
    out = tdit.dit_forward(to_torch(p), s2, *map(_t, (x, prompt, lens, tt, style, cond, fc)))
    if option == "causal":          # every frame: the causal mask ignores the lengths
        _close(out, ref)
    else:
        for b, L in enumerate(lens):
            _close(out[b, :L], ref[b, :L])
    _round_trip(p, lambda sd: refckpt.dit(sd, p, s2, "est."),
                lambda sd: tconv.convert_dit(sd, s2, "est."), DIT_WEIGHT_NORMED)


def test_causal_dit_refuses_the_kernel_tiers():
    from indextts_tpu_torch.models.s2mel import dit as tdit

    s2 = _dit_s2("causal")
    p = to_torch(tdit.init_dit(tnn.InitRng(0), s2))
    B, T = 1, 16
    args = [torch.zeros((B, T, 80)), torch.zeros((B, T, 80)), torch.tensor([T]),
            torch.tensor([0.5]), torch.zeros((B, 192)), torch.zeros((B, T, 32)),
            torch.zeros((T, s2.DiT.head_dim // 2, 2))]
    for tier in ("packed", "flash"):
        with pytest.raises(ValueError, match="causal"):
            tdit.dit_forward(p, s2, *args, tier=tier)


@pytest.mark.parametrize("option", ["causal", "mlp-head", "style-as-token"])
def test_dit_option_on_a_sequence_parallel_mesh_matches_jax(option):
    """The CFM on a sp=2 CPU mesh (each rank its block of frames, dense
    attention against the gathered k and v) against the JAX single-device
    CFM with the option."""
    from indextts_tpu.models.s2mel.cfm import cfm_inference as jcfm
    from indextts_tpu.models.s2mel.dit import init_dit
    from indextts_tpu_torch.models.s2mel.cfm import cfm_inference
    from indextts_tpu_torch.parallel.mesh import make_mesh, shard_dit

    s2 = _dit_s2(option)
    params = jax.device_get(init_dit(InitRng(9), s2))
    rng = np.random.default_rng(10)
    B, T = 2, 48
    mu = rng.standard_normal((B, T, s2.DiT.content_dim)).astype(np.float32)
    prompt = rng.standard_normal((B, T, 80)).astype(np.float32)
    style = rng.standard_normal((B, s2.style_encoder.dim)).astype(np.float32)
    x_lens, p_lens = np.array([T, 31], np.int32), np.array([6, 6], np.int32)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jcfm(params, s2, jnp.asarray(mu), jnp.asarray(x_lens), jnp.asarray(prompt),
                          jnp.asarray(style), key, n_timesteps=3,
                          prompt_len=jnp.asarray(p_lens)))
    z = np.asarray(jax.random.normal(key, (B, T, 80), jnp.float32))
    tree = shard_dit(to_torch(params, "cpu", torch.float32), make_mesh(["cpu"] * 2, tp=1, sp=2))
    out = cfm_inference(tree, s2, _t(mu), _t(x_lens), _t(prompt), _t(style), n_timesteps=3,
                        prompt_len=_t(p_lens), z=_t(z))
    assert out.shape == ref.shape
    _close(out, ref)


# ---------------------------------------------------------------------------
# RepCodec downsampling
# ---------------------------------------------------------------------------

def test_repcodec_downsampling_matches_jax():
    from indextts_tpu.models.codec import repcodec as jr
    from indextts_tpu_torch.models.codec import repcodec as tr

    c = dataclasses.replace(tiny_config().semantic_codec, downsample_scale=2)
    p = jr.init_repcodec(InitRng(12), c)
    _same_structure(tr.init_repcodec(tnn.InitRng(12), c), p)
    x = np.random.default_rng(13).standard_normal((2, 31, c.hidden_size)).astype(np.float32)
    codes, q = jr.repcodec_quantize(p, c, jnp.asarray(x))
    tcodes, tq = tr.repcodec_quantize(to_torch(p), c, _t(x))
    assert tq.shape == (2, 16, c.hidden_size) == q.shape
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))
    _close(tq, q)
    _round_trip(p, lambda sd: sd.update(refckpt.repcodec_state_dict(p)),
                lambda sd: tconv.convert_repcodec(sd, c),
                ("in_project/kernel", "out_project/kernel"))
