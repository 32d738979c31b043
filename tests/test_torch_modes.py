"""PyTorch port, the plain decode step on every format and the aux decode
modes, against the JAX package on the CPU.

- the plain `gpt2_decode_step` on int8 and int4 weights, on the float cache
  (with every layer's input, `collect_hiddens`) against JAX's
  `gpt2_decode_step`, and on the flat int8 cache against JAX's
  `gpt2_chunk_step` at G=1 (the JAX package's plain step reads the int8
  cache only in its 5D layout, with f32 scales; the port keeps the flat
  one): f32, atol 2e-4, rtol 1e-3 (tests/test_parity_gpt.py);
- `resolve_dola_layers` equals JAX's on every form, raises included;
- greedy engines token-equal to JAX's: `generate_contrastive` at (top_k,
  alpha) = (4, 0.6) and (3, 0.3), at alpha=0 equal to greedy;
  `generate_dola` at "low", "high" and a list; `generate_group_beam` at
  (beams, groups) = (4, 2) and (6, 3) with a diversity penalty and
  min_new_tokens, f32 on the gather route and int8 through K1's twin at
  group=Kg (against the JAX engine on its mask-based XLA step: the JAX
  fused kernel's window differs across the decode's unwritten slot P + 1),
  at groups=1 equal
  to `generate_beam`; a 27-row int8 beam decode, past K1's 24 rows, on the
  plain step;
- the pipeline: the JAX pipeline's ValueErrors, and the three aux requests
  on the tiny pipeline token-equal to the JAX pipeline's.

Torch runs one intra-op thread.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, "tests")

from test_torch_pipeline import _one_torch_thread, jax_tts, model_dir, torch_tts  # noqa: E402,F401
from test_torch_speculative import TINY, _tt  # noqa: E402

from indextts_tpu.engine import beam as jbeam  # noqa: E402
from indextts_tpu.engine import modes as jmodes  # noqa: E402
from indextts_tpu.engine.decode import SamplingConfig as JSampling  # noqa: E402
from indextts_tpu.models.gpt import gpt2 as jgpt2  # noqa: E402
from indextts_tpu.models.gpt.unified_voice import init_unified_voice  # noqa: E402
from indextts_tpu.nn import InitRng  # noqa: E402
from indextts_tpu_torch.engine import beam as tbeam  # noqa: E402
from indextts_tpu_torch.engine import decode as tdec  # noqa: E402
from indextts_tpu_torch.engine import modes as tmodes  # noqa: E402
from indextts_tpu_torch.models.gpt import gpt2 as tgpt2  # noqa: E402
from indextts_tpu_torch.utils.jax_params import to_torch  # noqa: E402

ATOL, RTOL = 2e-4, 1e-3
STEPS = 12


# ---------------------------------------------------------------------------
# the plain step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["int8", "int4"])
@pytest.mark.parametrize("kvq", [False, True], ids=["float-cache", "int8-cache"])
def test_plain_decode_step_matches_jax(weights, kvq):
    dims = jgpt2.GPT2Dims(3, 64, 4)
    params = jgpt2.init_gpt2(InitRng(2), dims)
    params = (jgpt2.quantize_gpt2_int8 if weights == "int8" else jgpt2.quantize_gpt2_int4)(params)
    r = np.random.default_rng(3)
    B, P, S = 2, 6, 16
    prefix = (r.standard_normal((B, P, dims.dim)) * 0.3).astype(np.float32)
    mask = np.array([[False, False] + [True] * (P - 2), [True] * P])
    x = (r.standard_normal((B, dims.dim)) * 0.3).astype(np.float32)
    valid = np.zeros((B, S), bool)
    valid[:, :P] = mask
    valid[:, P] = True
    jkv = jgpt2.init_kv_cache(dims, B, S, dtype=jnp.float32, quantized=kvq, flat=kvq)
    _, jkv = jgpt2.gpt2_prefill(params, jnp.asarray(prefix), dims, jnp.asarray(mask), jkv)
    tp = to_torch(params, "cpu", torch.float32)
    tdims = tgpt2.GPT2Dims(dims.layers, dims.dim, dims.heads)
    kv = tgpt2.init_kv_cache(tdims, B, S, dtype=torch.float32, quantized=kvq)
    tgpt2.gpt2_prefill(tp, torch.as_tensor(prefix), tdims, torch.as_tensor(mask), kv)
    calls = tgpt2.gpt2_decode_step.calls
    h, hs = tgpt2.gpt2_decode_step(tp, torch.as_tensor(x), tdims, P, kv, torch.as_tensor(valid),
                                   collect_hiddens=True)
    assert tgpt2.gpt2_decode_step.calls == calls + 1 and hs.shape == (dims.layers, B, dims.dim)
    if kvq:
        valid[:, P] = False
        jh, jkv = jgpt2.gpt2_chunk_step(params, jnp.asarray(x)[:, None], dims, jnp.int32(P),
                                        jkv, jnp.asarray(valid))
        np.testing.assert_allclose(h.numpy(), np.asarray(jh)[:, 0], atol=ATOL, rtol=RTOL)
        for name in ("k", "v", "kvs"):
            np.testing.assert_allclose(kv[name].float()[:, :, P].numpy(),
                                       _tt(jkv[name]).float()[:, :, P].numpy(), atol=ATOL,
                                       rtol=RTOL)
        np.testing.assert_array_equal(hs[0].numpy(), x)
    else:
        jh, jkv, jhs = jgpt2.gpt2_decode_step(params, jnp.asarray(x), dims, jnp.int32(P), jkv,
                                              jnp.asarray(valid), collect_hiddens=True)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), atol=ATOL, rtol=RTOL)
        for name in "kv":
            np.testing.assert_allclose(kv[name][:, :, P].numpy(),
                                       np.asarray(jkv[name])[:, :, P].reshape(dims.layers, B, -1),
                                       atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# resolve_dola_layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", ["low", "high", (0, 5, 99), [1, 3], (99,), "middle", ()])
@pytest.mark.parametrize("L", [1, 2, 3, 6, 24, 48])
def test_resolve_dola_layers_matches_jax(layers, L):
    try:
        want = jmodes.resolve_dola_layers(layers, L)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(",")[0][:20]):
            tmodes.resolve_dola_layers(layers, L)
        return
    assert tmodes.resolve_dola_layers(layers, L) == want


# ---------------------------------------------------------------------------
# the engines, greedy, against JAX's
# ---------------------------------------------------------------------------

def _f32_case(layers=2):
    """TINY (f32) at ``layers`` layers, and two left-padded prefixes."""
    cfg = dataclasses.replace(TINY, layers=layers)
    params = init_unified_voice(InitRng(1), cfg)
    r = np.random.default_rng(7)
    B, P = 2, 8
    prefix = (r.standard_normal((B, P, cfg.model_dim)) * 0.5).astype(np.float32)
    prefix[1, :3] = 0
    mask = np.ones((B, P), bool)
    mask[1, :3] = False
    return cfg, params, prefix, mask


def _both(fn_j, fn_t, cfg, params, prefix, mask, sampling, dtype=torch.float32, tparams=None,
          steps=STEPS, **tkw):
    """The JAX engine and the port's on one case; returns both (codes,
    lengths) as numpy."""
    dims = jgpt2.GPT2Dims(cfg.layers, cfg.model_dim, cfg.heads)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jc, jl = fn_j(params, cfg, dims, jnp.asarray(prefix), jnp.asarray(mask),
                  jax.random.PRNGKey(0), steps, JSampling(**sampling), jdt)
    tp = tparams if tparams is not None else to_torch(params, "cpu", dtype)
    tc, tl = fn_t(tp, cfg, tgpt2.GPT2Dims(cfg.layers, cfg.model_dim, cfg.heads),
                  torch.as_tensor(np.asarray(prefix, np.float32)).to(dtype),
                  torch.as_tensor(mask), torch.Generator().manual_seed(0), steps,
                  tdec.SamplingConfig(**sampling), dtype, **tkw)
    return (np.asarray(jc), np.asarray(jl)), (tc.numpy(), np.asarray(tl))


def _assert_same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("k,alpha", [(4, 0.6), (3, 0.3)])
def test_contrastive_token_equal_jax(k, alpha):
    cfg, params, prefix, mask = _f32_case()
    samp = dict(do_sample=False, num_beams=1, top_k=k, penalty_alpha=alpha,
                repetition_penalty=1.3)
    calls = tgpt2.gpt2_decode_step.calls
    j, t = _both(jmodes.generate_contrastive, tmodes.generate_contrastive, cfg, params, prefix,
                 mask, samp)
    _assert_same(j, t)
    assert tgpt2.gpt2_decode_step.calls > calls


def test_contrastive_alpha0_is_greedy():
    cfg, params, prefix, mask = _f32_case()
    samp = dict(do_sample=False, num_beams=1, top_k=4, penalty_alpha=0.0,
                repetition_penalty=1.3)
    j, t = _both(jmodes.generate_contrastive, tmodes.generate_contrastive, cfg, params, prefix,
                 mask, samp)
    _assert_same(j, t)
    greedy = tdec.generate_adaptive(
        to_torch(params, "cpu", torch.float32), cfg, tgpt2.GPT2Dims(cfg.layers, cfg.model_dim,
                                                                    cfg.heads),
        torch.as_tensor(prefix), torch.as_tensor(mask), torch.Generator().manual_seed(0),
        STEPS, tdec.SamplingConfig(**{**samp, "penalty_alpha": 0.0}), torch.float32)
    _assert_same(t, (greedy[0].numpy(), greedy[1]))


@pytest.mark.parametrize("layers", ["low", "high", (0, 2, 4)])
def test_dola_token_equal_jax(layers):
    """Six layers: "high" picks between layers 3 and 5 by the JSD each
    step."""
    cfg, params, prefix, mask = _f32_case(layers=6)
    samp = dict(do_sample=False, num_beams=1, dola_layers=layers, repetition_penalty=1.3)
    j, t = _both(jmodes.generate_dola, tmodes.generate_dola, cfg, params, prefix, mask, samp)
    _assert_same(j, t)


@pytest.mark.parametrize("beams,groups", [(4, 2), (6, 3)])
def test_group_beam_token_equal_jax(beams, groups):
    cfg, params, prefix, mask = _f32_case()
    samp = dict(do_sample=False, num_beams=beams, num_beam_groups=groups,
                diversity_penalty=1.0, min_new_tokens=4, repetition_penalty=1.3,
                length_penalty=1.0)
    gathers = tbeam.kv_gathers
    j, t = _both(jbeam.generate_group_beam, tbeam.generate_group_beam, cfg, params, prefix,
                 mask, samp)
    _assert_same(j, t)
    assert tbeam.last_use_anc is False and tbeam.kv_gathers > gathers


def test_group_beam_one_group_is_beam_search():
    cfg, params, prefix, mask = _f32_case()
    samp = dict(do_sample=False, num_beams=3, num_beam_groups=1, repetition_penalty=1.3)
    tp = to_torch(params, "cpu", torch.float32)
    args = (tp, cfg, tgpt2.GPT2Dims(cfg.layers, cfg.model_dim, cfg.heads),
            torch.as_tensor(prefix), torch.as_tensor(mask), torch.Generator().manual_seed(0),
            STEPS, tdec.SamplingConfig(**samp), torch.float32)
    g, b = tbeam.generate_group_beam(*args), tbeam.generate_beam(*args)
    assert torch.equal(g[0], b[0])
    np.testing.assert_array_equal(g[1], b[1])


@pytest.mark.parametrize("beams,groups", [(4, 2), (6, 3)])
def test_int8_group_beam_through_k1_twin_token_equal_jax(monkeypatch, beams, groups):
    """int8 (bf16): K1's twin with the ancestry map at group=Kg against the
    JAX engine's mask-based XLA step (its gather route), which attends the
    same slots."""
    from indextts_tpu_torch.ops import decode_step as tds
    from test_torch_int8 import _beam_cfg, _bf16

    cfg = _beam_cfg()
    params = jax.tree_util.tree_map(_bf16, init_unified_voice(InitRng(0), cfg))
    params["gpt"] = jgpt2.quantize_gpt2_int8(params["gpt"])
    r = np.random.default_rng(3)
    prefix = _bf16(r.normal(0, 0.3, (1, 7, cfg.model_dim)))
    mask = np.ones((1, 7), bool)
    mask[0, 0] = False
    monkeypatch.setenv("INDEXTTS_FUSED_DECODE", "0")
    seen = []
    real = tds.fused_decode_step
    monkeypatch.setattr(tdec, "fused_decode_step",
                        lambda *a, **k: seen.append((k["group"], k["anc"] is not None))
                        or real(*a, **k))
    samp = dict(do_sample=False, num_beams=beams, num_beam_groups=groups,
                diversity_penalty=1.0, min_new_tokens=3)
    jbeam.generate_group_beam.clear_cache()
    try:
        j, t = _both(jbeam.generate_group_beam, tbeam.generate_group_beam, cfg, params, prefix,
                     mask, samp, dtype=torch.bfloat16, steps=6)
        assert jbeam.last_use_anc is False
    finally:
        jbeam.generate_group_beam.clear_cache()
    _assert_same(j, t)
    assert tbeam.last_use_anc is True and set(seen) == {(beams // groups, True)}


def test_int8_beam_past_24_rows_takes_the_plain_step():
    """9 prefix rows x 3 beams = 27 rows: past K1's 24, the plain step on
    int8 weights with the per-step cache gather, token-equal to the JAX
    package's XLA path."""
    from test_torch_int8 import _bf16

    cfg = TINY
    params = jax.tree_util.tree_map(_bf16, init_unified_voice(InitRng(0), cfg))
    params["gpt"] = jgpt2.quantize_gpt2_int8(params["gpt"])
    r = np.random.default_rng(5)
    prefix = _bf16(r.normal(0, 0.5, (9, 6, cfg.model_dim)))
    mask = np.ones((9, 6), bool)
    mask[::2, :2] = False
    samp = dict(do_sample=False, num_beams=3, repetition_penalty=1.3)
    assert tdec.decode_route({"gpt": to_torch(params["gpt"], "cpu", torch.bfloat16)}, 27) \
        == "plain"
    calls = tgpt2.gpt2_decode_step.calls
    j, t = _both(jbeam.generate_beam, tbeam.generate_beam, cfg, params, prefix, mask, samp,
                 dtype=torch.bfloat16, steps=8)
    _assert_same(j, t)
    assert tgpt2.gpt2_decode_step.calls == calls + 7 and tbeam.last_use_anc is False


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,match", [
    (dict(num_beams=3, num_beam_groups=2, do_sample=False), "divisible"),
    (dict(num_beams=4, num_beam_groups=2), "do_sample=False"),
    (dict(num_beams=3, dola_layers="low"), "num_beams=1"),
])
def test_pipeline_raises_the_jax_value_errors(jax_tts, torch_tts, model_dir, kwargs, match):
    kw = dict(spk_audio_prompt=os.path.join(model_dir, "prompt.wav"), text="hello world .",
              output_path=None, max_mel_tokens=4, **kwargs)
    for tts in (jax_tts, torch_tts):
        with pytest.raises(ValueError, match=match):
            tts.infer(**kw)


@pytest.mark.parametrize("kwargs,engine", [
    (dict(num_beams=4, num_beam_groups=2, diversity_penalty=1.0), "generate_group_beam"),
    (dict(num_beams=1, penalty_alpha=0.6, top_k=4), "generate_contrastive"),
    (dict(num_beams=1, dola_layers="high"), "generate_dola"),
], ids=["diverse-beam", "contrastive", "dola"])
def test_pipeline_aux_requests_token_equal_jax(jax_tts, torch_tts, model_dir, monkeypatch,
                                               kwargs, engine):
    from indextts_tpu_torch.pipeline import infer_v2

    kw = dict(spk_audio_prompt=os.path.join(model_dir, "prompt.wav"), text="hello world .",
              output_path=None, do_sample=False, max_mel_tokens=16, min_new_tokens=4, **kwargs)
    j = jax_tts
    j.capture, j._rng = [], jax.random.PRNGKey(0)
    try:
        j.infer(**kw)
        cap = j.capture
    finally:
        j.capture = None
    ran = []
    for name in ("generate_group_beam", "generate_contrastive", "generate_dola",
                 "generate_spec_adaptive", "generate_adaptive", "generate_beam"):
        real = getattr(infer_v2, name)
        monkeypatch.setattr(infer_v2, name,
                            lambda *a, _n=name, _f=real, **k: ran.append(_n) or _f(*a, **k))
    calls = []
    orig = torch_tts.codes_to_wav
    monkeypatch.setattr(torch_tts, "codes_to_wav",
                        lambda *a, **k: calls.append(a) or orig(*a, **k))
    sr, wav = torch_tts.infer(**kw)
    assert ran == [engine] and len(cap) == len(calls) == 1
    codes, clen = calls[0][5].numpy(), int(calls[0][6])
    assert clen == max(int(cap[0]["code_lens"][0]), 1)
    np.testing.assert_array_equal(codes[0, :clen], cap[0]["codes"][0, :clen])
    assert sr == 22050 and wav.shape == (int(np.float32(clen) * np.float32(1.72)) * 256, 1)
