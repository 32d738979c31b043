"""PyTorch port, the mesh: dp x sp x tp ranks on the CPU (`make_mesh(["cpu"] *
n, ...)`) against the JAX package's single-device functions.

- `make_mesh`: dp x sp x tp factoring; an int names cards and raises where
  the machine has fewer, where the JAX `make_mesh` takes the first n of its
  devices (a kept departure, both behaviours shown);
- the shard splits: each shard's leaves equal the slices `_spec_for_path`
  gives of the JAX tree (float, int8 and int4 GPT-2 stacks; the DiT), the
  qkv stacks cut head-aligned (the spec's tp cut of each of q, k and v, the
  JAX tp-kernel layout); int4 shards re-packed on their own nibble groups,
  the same bytes as the JAX cut where a shard holds whole 640-column groups;
- the plain decode step (with every layer's input) and the chunk step on
  the tp tree at tp=2 and 4 against JAX's single-device `gpt2_decode_step`
  (the int8 cache: `gpt2_chunk_step` at G=1, as tests/test_torch_modes.py
  does) for float, int8 and int4 weights and the int8 cache, the shards'
  written cache rows included;
- greedy beams, diverse beams and the adaptive decode on the plain route of
  the tp tree (the JAX package's GSPMD decode) token-equal to the unsharded
  plain route, at 27 rows and at tp=4;
- the DiT backbone at tp=2 (packed tier: K2's twin per shard) and tp=4
  (flash tier, K4's twin) against JAX's `dit_backbone_forward`; the CFM at
  sp=2 and sp=2 x tp=2 against JAX's single-device `cfm_inference` with the
  inputs of tests/test_parallel.py's sequence-parallel test;
- the tiny pipeline at dp=2 (4 segments) and dp=2 with a padded row (3
  segments) against JAX's single-device `IndexTTS2`: greedy codes equal,
  the int16 output within 2 LSB given the JAX CFM noise; `IndexTTS2(mesh=2)`
  as the int form; `cli_v2 batch --mesh 2 --device cpu`.

Tolerances: f32 throughout, atol 2e-4 / rtol 1e-3 (tests/test_parity_gpt.py);
token equality for greedy decodes. The JAX side runs single-device only (its
CPU collectives can hang on a small box). Torch runs one intra-op thread.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, "tests")

from test_torch_longform import TEXT4, _jax_noise, _jax_request, _port_request  # noqa: E402
from test_torch_pipeline import _one_torch_thread, jax_tts, model_dir, torch_tts  # noqa: E402,F401
from test_pipeline_e2e import tiny_config  # noqa: E402

from indextts_tpu.models.gpt import gpt2 as jgpt2  # noqa: E402
from indextts_tpu.nn import InitRng  # noqa: E402
from indextts_tpu.parallel.mesh import _spec_for_path  # noqa: E402
from indextts_tpu_torch import nn as tnn  # noqa: E402
from indextts_tpu_torch.models.gpt import gpt2 as tgpt2  # noqa: E402
from indextts_tpu_torch.parallel.mesh import (batch_sharding, make_mesh, replicated,  # noqa: E402
                                              seq_sharding, shard_dit, shard_gpt2_tp)
from indextts_tpu_torch.utils.jax_params import to_jax, to_torch  # noqa: E402

ATOL, RTOL = 2e-4, 1e-3


def _cpu_mesh(n, **kw):
    return make_mesh(["cpu"] * n, **kw)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# module 1: the mesh and the splits
# ---------------------------------------------------------------------------

def test_make_mesh_factors_dp_sp_tp_and_names_rows_and_frames():
    m = _cpu_mesh(8, dp=2, sp=2)
    assert (m.dp, m.sp, m.tp) == (2, 2, 2)
    assert m.tp_mesh(1, 1).devices == m.devices[6:8] and m.dp_mesh(1).sp == 2
    assert (_cpu_mesh(2).tp, _cpu_mesh(2, tp=1).dp, _cpu_mesh(4, sp=2).tp) == (2, 2, 2)
    assert replicated(m) == [slice(None)] * 8
    assert batch_sharding(_cpu_mesh(2, tp=1), 3) == [slice(0, 2), slice(2, 4)]
    assert seq_sharding(m, 61) == [slice(0, 31), slice(31, 62)]
    assert seq_sharding(_cpu_mesh(2), 61) is None
    with pytest.raises(ValueError, match="dp=3"):
        _cpu_mesh(4, dp=3, tp=1)


def test_make_mesh_int_names_cards_where_jax_truncates():
    """The kept departure (ROADMAP queue 3 item 6): the port's int form names
    cuda:0 .. cuda:n-1 and raises without them; the JAX one takes the first
    n of the devices it finds."""
    from indextts_tpu.parallel.mesh import make_mesh as jmake_mesh

    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="CUDA device"):
        make_mesh(n, tp=1)
    assert jmake_mesh(len(jax.devices()) + 1, tp=1).devices.size == len(jax.devices())


def _jslice(path: str, leaf: np.ndarray, t: int, tp: int) -> np.ndarray:
    """Shard t's part of ``leaf`` under `_spec_for_path`'s PartitionSpec."""
    spec = _spec_for_path(path, leaf)
    idx = []
    for ax, name in enumerate(tuple(spec) + (None,) * (leaf.ndim - len(spec))):
        n = leaf.shape[ax] // tp
        idx.append(slice(t * n, (t + 1) * n) if name == "tp" else slice(None))
    return leaf[tuple(idx)]


def _qkv_slice(path: str, leaf: np.ndarray, t: int, tp: int) -> np.ndarray:
    """A fused qkv leaf's shard t, head-aligned: the spec's tp cut applied to
    each of q, k and v (what the JAX tp-kernel layout `gpt_tp_layout` and its
    (L, D, 3, D) spec give)."""
    return np.concatenate([_jslice(path, part, t, tp) for part in np.split(leaf, 3, axis=-1)],
                          axis=-1)


@pytest.mark.parametrize("fmt,dims,tp", [
    ("float", (2, 64, 4), 2), ("int8", (2, 64, 4), 4), ("int4", (1, 640, 10), 2),
    ("int4", (1, 1280, 20), 2)], ids=["float", "int8-tp4", "int4-regrouped", "int4-groups"])
def test_gpt_shard_split_equals_the_jax_spec_slices(fmt, dims, tp):
    jd = jgpt2.GPT2Dims(*dims)
    p = jgpt2.init_gpt2(InitRng(1), jd)
    if fmt == "int8":
        p = jgpt2.quantize_gpt2_int8(p)
    elif fmt == "int4":
        p = jgpt2.quantize_gpt2_int4(p)
    p = jax.tree_util.tree_map(np.asarray, p)
    sharded = shard_gpt2_tp(to_torch(p, "cpu", torch.float32), _cpu_mesh(tp, tp=tp))
    h = p["h"]
    for t, layers in enumerate(sharded["shards"]):
        for li, lp in enumerate(layers):
            for grp, name in (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc"),
                              ("mlp", "c_proj")):
                for leaf, ref in h[grp][name].items():
                    path = f"gpt.h.{grp}.{name}.{leaf}"
                    ref = ref[li:li + 1]
                    if name == "c_attn":
                        want = _qkv_slice(path, ref, t, tp)[0]
                    elif leaf == "q4" and name == "c_proj":
                        # the values of the spec's cut, re-packed on the shard
                        vals = np.asarray(jax.device_get(jgpt2.nn.unpack_int4(jnp.asarray(ref))))
                        got = tnn.unpack_int4(lp[grp][name]["q4"]).numpy()
                        np.testing.assert_array_equal(got, _jslice(path.replace("q4", "q"), vals,
                                                                   t, tp)[0].T)
                        if (ref.shape[1] // tp) % 320 == 0:
                            want = _jslice(path, ref, t, tp)[0]
                        else:
                            continue
                    elif leaf == "scale" and ref.ndim == 3:
                        # the (L, 1, N) int8 scale, cut as the spec cuts its bias
                        want = _jslice(path, ref[:, 0], t, tp)[0]
                    else:
                        want = _jslice(path, ref, t, tp)[0]
                    got = lp[grp][name]["weight" if leaf == "kernel" else leaf].float().numpy()
                    if leaf in ("kernel", "q", "q4"):
                        got = lp[grp][name]["weight" if leaf == "kernel" else leaf].numpy().T
                    # scales and biases: (N,) here, (1, N) per layer in the JAX tree
                    np.testing.assert_array_equal(np.asarray(got, want.dtype).reshape(want.shape),
                                                  want, err_msg=path)
            for ln in ("ln_1", "ln_2"):
                for k in ("weight", "bias"):
                    np.testing.assert_array_equal(lp[ln][k].numpy(), h[ln][k][li])


def test_dit_shard_split_equals_the_jax_spec_slices():
    from indextts_tpu.config import DiTConfig
    from indextts_tpu.models.s2mel.dit import init_dit_backbone

    tp = 2
    p = jax.tree_util.tree_map(np.asarray, init_dit_backbone(
        InitRng(2), DiTConfig(hidden_dim=128, num_heads=4, depth=2, content_dim=32)))
    tree = {"transformer": to_torch(p, "cpu", torch.float32)}
    sharded = shard_dit(tree, _cpu_mesh(tp, tp=tp))
    assert len(sharded["sp"]) == 1
    lay = p["layers"]
    for t, layers in enumerate(sharded["sp"][0]["transformer"]["shards"]):
        for li, lp in enumerate(layers):
            for grp, name in (("attn", "wqkv"), ("attn", "wo"), ("ff", "w1"), ("ff", "w3"),
                              ("ff", "w2")):
                path = f"transformer.layers.{grp}.{name}.kernel"
                ref = lay[grp][name]["kernel"]
                want = (_qkv_slice(path, ref, t, tp) if name == "wqkv"
                        else _jslice(path, ref, t, tp))[li]
                np.testing.assert_array_equal(lp[grp][name]["weight"].numpy().T, want,
                                              err_msg=path)
            for norm in ("attention_norm", "ffn_norm"):
                np.testing.assert_array_equal(lp[norm]["norm"]["weight"].numpy(),
                                              lay[norm]["norm"]["weight"][li])


# ---------------------------------------------------------------------------
# module 2: the plain and chunk steps on the tp tree
# ---------------------------------------------------------------------------

JD = jgpt2.GPT2Dims(2, 64, 4)
TD = tgpt2.GPT2Dims(2, 64, 4)
FORMATS = {"float": (None, False), "int8": (jgpt2.quantize_gpt2_int8, False),
           "int4": (jgpt2.quantize_gpt2_int4, False), "int8-cache": (jgpt2.quantize_gpt2_int8,
                                                                     True)}


def _step_case(fmt, G=1):
    quant, kvq = FORMATS[fmt]
    p = jgpt2.init_gpt2(InitRng(3), JD)
    p = quant(p) if quant else p
    r = np.random.default_rng(4)
    B, P, S = 2, 6, 16
    prefix = (r.standard_normal((B, P, JD.dim)) * 0.3).astype(np.float32)
    mask = np.array([[False, False] + [True] * (P - 2), [True] * P])
    x = (r.standard_normal((B, G, JD.dim)) * 0.3).astype(np.float32)
    valid = np.zeros((B, S), bool)
    valid[:, :P] = mask
    jkv = jgpt2.init_kv_cache(JD, B, S, dtype=jnp.float32, quantized=kvq, flat=kvq)
    _, jkv = jgpt2.gpt2_prefill(p, jnp.asarray(prefix), JD, jnp.asarray(mask), jkv)
    return p, kvq, prefix, mask, x, valid, jkv, S


def _shards_prefilled(p, kvq, prefix, mask, S, tp):
    mesh = _cpu_mesh(tp, tp=tp)
    tree = shard_gpt2_tp(to_torch(p, "cpu", torch.float32), mesh, kernel=False)
    kv = tgpt2.init_kv_cache(TD, prefix.shape[0], S, dtype=torch.float32, quantized=kvq,
                             mesh=mesh)
    tgpt2.gpt2_prefill(tree, torch.as_tensor(prefix), TD, torch.as_tensor(mask), kv)
    return tree, kv


def _joined(kv, name, pos, heads):
    """The shards' cache rows at ``pos``, f32 (L, B, D), the int8 ones
    against their scale rows."""
    parts = []
    for c in kv["shards"]:
        rows = c[name][:, :, pos].float()
        if "kvs" in c:
            off = 0 if name == "k" else tgpt2.SCALE_LANES // 2
            sc = c["kvs"][:, :, pos, off:off + heads].float()
            rows = (rows.reshape(*rows.shape[:2], heads, -1) * sc[..., None]).flatten(2)
        parts.append(rows)
    return torch.cat(parts, -1).numpy()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_tp_plain_step_with_hiddens_matches_jax(fmt, tp):
    p, kvq, prefix, mask, x, valid, jkv, S = _step_case(fmt)
    P = prefix.shape[1]
    tree, kv = _shards_prefilled(p, kvq, prefix, mask, S, tp)
    valid[:, P] = True
    h, hs = tgpt2.gpt2_decode_step(tree, torch.as_tensor(x[:, 0]), TD, P, kv,
                                   torch.as_tensor(valid), collect_hiddens=True)
    if kvq:
        valid[:, P] = False
        jh, jkv = jgpt2.gpt2_chunk_step(p, jnp.asarray(x), JD, jnp.int32(P), jkv,
                                        jnp.asarray(valid))
        jh = np.asarray(jh)[:, 0]
        k8, kvs = (np.asarray(jkv[n], np.float32)[:, :, P] for n in ("k", "kvs"))
        jk = (k8.reshape(JD.layers, 2, JD.heads, -1) * kvs[..., :JD.heads, None]).reshape(
            JD.layers, 2, -1)
        np.testing.assert_array_equal(hs[0].numpy(), x[:, 0])
    else:
        jh, jkv, jhs = jgpt2.gpt2_decode_step(p, jnp.asarray(x[:, 0]), JD, jnp.int32(P), jkv,
                                              jnp.asarray(valid), collect_hiddens=True)
        np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), atol=ATOL, rtol=RTOL)
        jk = np.asarray(jkv["k"])[:, :, P].reshape(JD.layers, 2, -1)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_joined(kv, "k", P, JD.heads // tp), jk, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_tp_chunk_step_matches_jax(fmt):
    p, kvq, prefix, mask, x, valid, jkv, S = _step_case(fmt, G=3)
    P = prefix.shape[1]
    jh, _ = jgpt2.gpt2_chunk_step(p, jnp.asarray(x), JD, jnp.int32(P), jkv, jnp.asarray(valid))
    tree, kv = _shards_prefilled(p, kvq, prefix, mask, S, 2)
    h = tgpt2.gpt2_chunk_step(tree, torch.as_tensor(x), TD, P, kv, torch.as_tensor(valid))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# module 3: the engines on the plain route of the tp tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uv_tree():
    from indextts_tpu_torch.config import ConditionModuleConfig, GPTConfig
    from indextts_tpu_torch.models.gpt.unified_voice import init_unified_voice
    from indextts_tpu_torch.nn import InitRng as TInitRng

    cond = ConditionModuleConfig(output_size=32, linear_units=48, attention_heads=2,
                                 num_blocks=1, input_layer="linear", perceiver_mult=2)
    cfg = GPTConfig(layers=2, model_dim=64, heads=4, max_text_tokens=30, max_mel_tokens=60,
                    number_text_tokens=40, number_mel_codes=50, start_mel_token=48,
                    stop_mel_token=49, condition_module=cond, emo_condition_module=cond)
    params = to_torch(to_jax(init_unified_voice(TInitRng(5), cfg)), "cpu", torch.float32)
    rng = np.random.default_rng(6)
    prefix = torch.as_tensor(rng.normal(0, 0.3, (9, 7, 64)), dtype=torch.float32)
    mask = torch.ones((9, 7), dtype=torch.bool)
    mask[::2, 0] = False
    return cfg, params, prefix, mask


@pytest.mark.parametrize("fmt,tp,rows,engine", [
    ("float", 2, 2, "beam"), ("int4", 4, 2, "beam"), ("int8", 2, 9, "beam"),
    ("int8", 2, 2, "group_beam"), ("float", 4, 3, "adaptive"), ("int8kv", 2, 3, "adaptive")],
    ids=["float-beams", "int4-tp4-beams", "int8-27-rows", "int8-diverse", "float-tp4-adaptive",
         "int8kv-adaptive"])
def test_gspmd_route_token_equal_the_unsharded_route(uv_tree, monkeypatch, fmt, tp, rows,
                                                     engine):
    from indextts_tpu_torch.engine import beam, decode

    cfg, params, prefix, mask = uv_tree
    gpt = params["gpt"]
    if fmt in ("int8", "int8kv"):
        gpt = tgpt2.quantize_gpt2_int8(gpt)
    elif fmt == "int4":
        gpt = tgpt2.quantize_gpt2_int4(gpt)
    one = {**params, "gpt": gpt}
    tp_tree = {**params, "gpt": shard_gpt2_tp(gpt, _cpu_mesh(tp, tp=tp), kernel=False)}
    K = 1 if engine == "adaptive" else 3 if engine == "beam" else 4
    samp = decode.SamplingConfig(do_sample=False, num_beams=K, min_new_tokens=5,
                                 num_beam_groups=2 if engine == "group_beam" else 1,
                                 diversity_penalty=0.5, kv_quant=fmt == "int8kv")
    monkeypatch.setattr(decode, "MAX_ROWS", 0)       # the unsharded tree on its plain step too
    runs = []
    for p in (one, tp_tree):
        assert decode.decode_route(p, rows * K, samp.kv_quant) == "plain"
        args = (p, cfg, TD, prefix[:rows], mask[:rows], torch.Generator().manual_seed(0), 10, samp)
        if engine == "adaptive":
            runs.append(decode.generate_adaptive(*args, dtype=torch.float32, spans=(4,)))
        else:
            fn = beam.generate_beam if engine == "beam" else beam.generate_group_beam
            runs.append(fn(*args, dtype=torch.float32))
    assert torch.equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


# ---------------------------------------------------------------------------
# module 5: the DiT over tp and sp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp,tier", [(2, "packed"), (4, "flash")])
def test_dit_backbone_tp_matches_jax(monkeypatch, tp, tier):
    from indextts_tpu.config import DiTConfig as JCfg
    from indextts_tpu.models.s2mel.dit import dit_backbone_forward as jforward
    from indextts_tpu.models.s2mel.dit import init_dit_backbone
    from indextts_tpu.ops.rope import precompute_freqs_cis
    from indextts_tpu_torch.config import DiTConfig as TCfg
    from indextts_tpu_torch.models.s2mel import dit as tdit

    for name in ("INDEXTTS_PACKED_ATTN", "INDEXTTS_FLASH_DIT"):
        monkeypatch.delenv(name, raising=False)
    kw = dict(hidden_dim=256, num_heads=4, depth=2, content_dim=32)
    p = jax.tree_util.tree_map(np.asarray, init_dit_backbone(InitRng(7), JCfg(**kw)))
    rng = np.random.default_rng(8)
    B, T = 2, 40
    x = rng.standard_normal((B, T, 256)).astype(np.float32)
    c = rng.standard_normal((B, 1, 256)).astype(np.float32)
    lens = np.array([T, 23], np.int32)
    fc = precompute_freqs_cis(T, 64)
    ref = np.asarray(jforward(p, JCfg(**kw), jnp.asarray(x), jnp.asarray(c), jnp.asarray(fc),
                              jnp.asarray(np.arange(T)[None, :] < lens[:, None]),
                              jnp.asarray(lens)))
    blocks = shard_dit({"transformer": to_torch(p, "cpu", torch.float32)},
                       _cpu_mesh(tp, tp=tp))["sp"]
    cfg = TCfg(**kw)
    assert tdit.attention_tier(tdit._shard_cfg(cfg, tp), _t(lens)) == tier
    seen = []
    orig = tdit.attention_rope
    monkeypatch.setattr(tdit, "attention_rope", lambda *a, **k: seen.append(a[0].shape) or
                        orig(*a, **k))
    out = tdit.dit_backbone_forward_mesh(blocks, cfg, [_t(x)], [_t(c)], _t(fc),
                                         torch.as_tensor(lens), torch.float32, [0], T)[0]
    # K2's twin once a shard and layer, at the shard's heads; none on the flash tier
    assert seen == ([(B, T, 256 // tp)] * tp * 2 if tier == "packed" else [])
    for b, L in enumerate(lens):
        np.testing.assert_allclose(out[b, :L].numpy(), ref[b, :L], atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def cfm_case():
    """tests/test_parallel.py's sequence-parallel CFM: its config, weights
    and inputs, and the JAX single-device CFM's output."""
    from indextts_tpu.config import (DiTConfig, LengthRegulatorConfig, S2MelConfig,
                                     StyleEncoderConfig, WaveNetConfig)
    from indextts_tpu.models.s2mel.cfm import cfm_inference
    from indextts_tpu.models.s2mel.dit import init_dit

    s2 = S2MelConfig(
        DiT=DiTConfig(hidden_dim=64, num_heads=4, depth=2, in_channels=8, content_dim=16,
                      final_layer_type="wavenet"),
        wavenet=WaveNetConfig(hidden_dim=64, num_layers=3, kernel_size=5, dilation_rate=1,
                              p_dropout=0.0, style_condition=True),
        style_encoder=StyleEncoderConfig(dim=12),
        length_regulator=LengthRegulatorConfig(channels=16, is_discrete=True,
                                               content_codebook_size=32, sampling_ratios=(1, 1)))
    params = init_dit(InitRng(0), s2)
    rng = np.random.default_rng(1)
    B, T = 2, 64
    mu = rng.standard_normal((B, T, 16)).astype(np.float32)
    prompt = rng.standard_normal((B, T, 8)).astype(np.float32)
    style = rng.standard_normal((B, 12)).astype(np.float32)
    x_lens, p_lens = np.array([T, 40], np.int32), np.array([8, 8], np.int32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(cfm_inference(params, s2, jnp.asarray(mu), jnp.asarray(x_lens),
                                   jnp.asarray(prompt), jnp.asarray(style), key, n_timesteps=4,
                                   prompt_len=jnp.asarray(p_lens)))
    z = np.asarray(jax.random.normal(key, (B, T, 8), jnp.float32))
    return s2, jax.tree_util.tree_map(np.asarray, params), mu, prompt, style, x_lens, p_lens, \
        z, ref


@pytest.mark.parametrize("sp,tp", [(2, 1), (2, 2)])
def test_cfm_sequence_parallel_matches_jax_single_device(cfm_case, sp, tp):
    from indextts_tpu_torch.models.s2mel.cfm import cfm_inference

    js2, params, mu, prompt, style, x_lens, p_lens, z, ref = cfm_case
    s2 = _port_s2(js2)
    mesh = _cpu_mesh(sp * tp, sp=sp, tp=tp)
    tree = shard_dit(to_torch(params, "cpu", torch.float32), mesh)
    out = cfm_inference(tree, s2, _t(mu), torch.as_tensor(x_lens), _t(prompt), _t(style),
                        n_timesteps=4, prompt_len=torch.as_tensor(p_lens), z=_t(z))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def _port_s2(js2):
    """The port's S2MelConfig of a JAX one (the same fields)."""
    import dataclasses

    from indextts_tpu_torch import config as tc

    def conv(obj, cls):
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(obj, f.name)
            sub = getattr(tc, type(v).__name__, None)
            kw[f.name] = conv(v, sub) if dataclasses.is_dataclass(v) and sub else v
        return cls(**kw)
    return conv(js2, tc.S2MelConfig)


# ---------------------------------------------------------------------------
# modules 6-7: the pipeline and the CLI
# ---------------------------------------------------------------------------

GREEDY = dict(do_sample=False, max_mel_tokens=8, min_new_tokens=3,
              max_text_tokens_per_segment=4)


@pytest.fixture(scope="module")
def dp_tts(model_dir, jax_tts):
    """The tiny port pipeline on a dp=2 CPU mesh (the int form) with the JAX
    pipeline's weights."""
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    tts = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cpu", dtype=torch.float32,
                    cfg=tiny_config(), mesh=2)
    j = jax_tts
    tts.load_params(jax.device_get({
        "gpt": j.gpt_params, "s2mel": j.s2mel_params, "codec": j.codec_params,
        "campplus": j.campplus_params, "bigvgan": j.bigvgan_params, "w2v": j.w2v_params,
        "w2v_mean": j.w2v_mean, "w2v_std": j.w2v_std,
        "emo_matrix": np.concatenate(j.emo_matrix), "spk_matrix": np.concatenate(j.spk_matrix)}))
    return tts


@pytest.mark.parametrize("text,segments", [(TEXT4, 4), ("hello world . the cat . hello .", 3)],
                         ids=["dp2", "dp2-padded"])
def test_dp_pipeline_matches_the_jax_single_device_pipeline(dp_tts, jax_tts, model_dir,
                                                            monkeypatch, text, segments):
    from indextts_tpu_torch.pipeline import infer_v2 as iv2

    assert (dp_tts.mesh.dp, dp_tts.mesh.tp, dp_tts.device.type) == (2, 1, "cpu")
    rows = []
    orig = iv2.generate_beam

    def counted(params, cfg, dims, embeds, *a, **k):
        rows.append(embeds.shape[0])
        return orig(params, cfg, dims, embeds, *a, **k)

    monkeypatch.setattr(iv2, "generate_beam", counted)
    kw = dict(spk_audio_prompt=os.path.join(model_dir, "prompt.wav"), text=text,
              output_path=None, num_beams=2, **GREEDY)
    (sr_j, wav_j), cap = _jax_request(jax_tts, 0, **kw)
    c = cap[0]
    assert c["codes"].shape[0] == segments
    (sr_t, wav_t), calls = _port_request(dp_tts, noise=lambda s: _jax_noise(c["rng"], s), **kw)
    assert rows == [-(-segments // 2)] * 2                 # each dp rank its rows
    _, _, _, _, _, codes, clens = calls[0]
    np.testing.assert_array_equal(np.asarray(clens), np.maximum(c["code_lens"], 1))
    for b, n in enumerate(np.asarray(clens)):
        np.testing.assert_array_equal(codes[b, :n].numpy(), c["codes"][b, :n])
    assert sr_t == sr_j and wav_t.shape == wav_j.shape
    assert np.abs(wav_t.astype(np.int32) - wav_j.astype(np.int32)).max() <= 2


def test_int_mesh_names_cards_unless_the_device_is_the_cpu(model_dir):
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    if torch.cuda.device_count() < 2:
        with pytest.raises((ValueError, RuntimeError)):
            IndexTTS2(cfg_path=None, model_dir=model_dir, cfg=tiny_config(), mesh=2)
    with pytest.raises(TypeError, match="mesh"):
        IndexTTS2(cfg_path=None, model_dir=model_dir, cfg=tiny_config(), device="cpu",
                  mesh="2")
    with pytest.raises(ValueError, match="heads"):
        IndexTTS2(cfg_path=None, model_dir=model_dir, cfg=tiny_config(), device="cpu",
                  mesh=make_mesh(["cpu"] * 4, tp=4))


def test_cli_batch_mesh_reaches_a_dp_mesh(model_dir, tmp_path, monkeypatch):
    """``batch --mesh 2 --device cpu`` builds the engine with mesh=2 on two
    CPU ranks and writes the wav (it used to exit 4)."""
    from indextts_tpu import cli_v2 as jcli
    from indextts_tpu_torch import cli_v2 as tcli
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
    model = tmp_path / "model"
    for f in jcli.REQUIRED_MODEL_FILES + jcli.REQUIRED_AUX_MODEL_FILES:
        q = model.joinpath(*f.split("/"))
        q.parent.mkdir(parents=True, exist_ok=True)
        q.write_bytes(b"x")
    for d in jcli.REQUIRED_MODEL_DIRS + jcli.REQUIRED_AUX_MODEL_DIRS:
        model.joinpath(*d.split("/")).mkdir(parents=True, exist_ok=True)
    batch = tmp_path / "batch.jsonl"
    batch.write_text('{"text": "hello world . the cat .", "voice": "%s", "output": "out/a.wav"}\n'
                     % os.path.join(model_dir, "prompt.wav"), encoding="utf-8")
    made = []

    def factory(**kw):
        tts = IndexTTS2(cfg_path=None, model_dir=model_dir, cfg=tiny_config(),
                        dtype=torch.float32, device=kw["device"], mesh=kw["mesh"])
        infer = tts.infer
        tts.infer = lambda **k: infer(**k, num_beams=2, max_mel_tokens=6,
                                      max_text_tokens_per_segment=4, do_sample=False)
        made.append((kw, tts))
        return tts

    rc = tcli.main(["batch", "--batch-file", str(batch), "--model-dir", str(model), "--mesh",
                    "2", "--device", "cpu"], tts_factory=factory)
    assert rc == 0
    (kw, tts), = made
    assert kw["mesh"] == 2 and tts.mesh.dp == 2 and tts.mesh.devices == (torch.device("cpu"),) * 2
    assert Path(tmp_path / "out" / "a.wav").stat().st_size > 44
