"""PyTorch port, the one-row speculative decoder (`engine/speculative.py`) and
its verify step `gpt2_chunk_step`, against the JAX package on the CPU.

- `_lookup_draft` equals JAX's (the most recent match, no match, a tail
  shorter than the n-gram);
- `gpt2_chunk_step` equals JAX's in f32 for float, int8 and int4 weights
  on the float cache and for int8 weights on the flat int8 cache (hidden
  and the written slots, dequantized; atol 2e-4, rtol 1e-3, as
  tests/test_parity_gpt.py), and G single `gpt2_decode_step`s of the port;
- greedy: `generate_spec_adaptive` token-equal to JAX's, with the same
  stats (so the gate decides the same);
- sampling: `generate_spec_adaptive` token-equal to the port's own
  `generate_adaptive` for one generator seed, across oracle, adversarial and
  lookup drafts, no verify at all (f32 and bf16), a demotion, span ends,
  min_new_tokens, max_new_tokens=1,
  the int8 cache, and int8 weights through K1's twin at group=1 (bf16;
  `torch.Generator` cannot draw `jax.random`'s numbers, so sampled tokens
  are not compared across frameworks);
- the tiny pipeline at num_beams=1 runs the speculative decoder (its stats
  in `last_spec_stats`), INDEXTTS_SPEC_DECODE=0 returns it to
  `generate_adaptive`, and greedy codes equal the JAX pipeline's.

Torch runs one intra-op thread.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, "tests")

from test_torch_pipeline import _one_torch_thread, jax_tts, model_dir, torch_tts  # noqa: E402,F401

from indextts_tpu.config import ConditionModuleConfig, GPTConfig  # noqa: E402
from indextts_tpu.models.gpt import gpt2 as jgpt2  # noqa: E402
from indextts_tpu.models.gpt.unified_voice import (init_unified_voice,  # noqa: E402
                                                   prepare_prefix_embeds)
from indextts_tpu.nn import InitRng  # noqa: E402
from indextts_tpu_torch.engine import decode as tdec  # noqa: E402
from indextts_tpu_torch.engine import speculative as tspec  # noqa: E402
from indextts_tpu_torch.models.gpt import gpt2 as tgpt2  # noqa: E402
from indextts_tpu_torch.utils.jax_params import to_torch  # noqa: E402

_COND = ConditionModuleConfig(output_size=32, linear_units=48, attention_heads=2, num_blocks=1,
                              input_layer="linear", perceiver_mult=2)
# tests/test_speculative.py's tiny GPT
TINY = GPTConfig(layers=2, model_dim=64, heads=4, max_text_tokens=30, max_mel_tokens=60,
                 number_text_tokens=40, number_mel_codes=50, start_mel_token=48,
                 stop_mel_token=49, condition_module=_COND, emo_condition_module=_COND)
DIMS = jgpt2.GPT2Dims(TINY.layers, TINY.model_dim, TINY.heads)
SAMPLING = dict(num_beams=1, temperature=1.0, top_k=0, top_p=1.0, repetition_penalty=1.3)
ATOL, RTOL = 2e-4, 1e-3


@pytest.fixture(scope="module")
def case():
    """The JAX tree and prefix of tests/test_speculative.py, and the port's
    copies (f32)."""
    params = init_unified_voice(InitRng(1), TINY)
    text = jnp.asarray([[5, 6, 7, 8]], jnp.int32)
    conds = jnp.zeros((1, 3, TINY.model_dim), jnp.float32)
    emb, mask = prepare_prefix_embeds(params, TINY, conds, text, jnp.asarray([4]), 9)
    return {"params": params, "emb": emb, "mask": mask,
            "tp": to_torch(params, "cpu", torch.float32),
            "temb": torch.as_tensor(np.asarray(emb)), "tmask": torch.as_tensor(np.asarray(mask))}


def _tdims():
    return tgpt2.GPT2Dims(TINY.layers, TINY.model_dim, TINY.heads)


def _port(case, fn, max_new=24, seed=0, **kw):
    """A port decode of the tiny prefix in f32, from a generator seeded
    ``seed``; returns (codes numpy, lengths, *rest)."""
    sampling = tdec.SamplingConfig(**{**SAMPLING, **kw.pop("sampling", {})})
    out = fn(case["tp"], TINY, _tdims(), case["temb"], case["tmask"],
             torch.Generator().manual_seed(seed), max_new, sampling, torch.float32, **kw)
    return (out[0].numpy(),) + tuple(out[1:])


# ---------------------------------------------------------------------------
# the draft lookup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row,step,gamma,ngram", [
    ([7, 8, 1, 2, 9, 1, 2, 3, 4, 5, 1, 2, 0, 0, 0, 0], 12, 3, 2),   # two matches: the later
    ([1, 2, 3, 4, 5, 6, 0, 0], 6, 2, 2),                            # no match
    ([3, 3, 3, 3, 3, 3, 3, 3, 3, 3], 9, 4, 2),                      # a run of one code
    ([5, 5, 0, 0], 1, 2, 2),                                        # tail shorter than ngram
    ([4, 1, 2, 4, 1, 2, 4, 1, 9, 9, 9, 9], 8, 2, 3),
])
def test_lookup_draft_matches_jax(row, step, gamma, ngram):
    from indextts_tpu.engine.speculative import _lookup_draft as jlookup

    jd, jh = jlookup(jnp.asarray(row, jnp.int32), jnp.int32(step), gamma=gamma, ngram=ngram)
    td, th = tspec._lookup_draft(torch.tensor(row), step, gamma, ngram)
    assert th == bool(jh)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


# ---------------------------------------------------------------------------
# gpt2_chunk_step
# ---------------------------------------------------------------------------

FORMATS = {"float": (None, False), "int8": ("int8", False), "int8-int8cache": ("int8", True),
           "int4": ("int4", False)}
B, P, S, G = 2, 5, 24, 4


def _gpt_format(weights):
    params = init_unified_voice(InitRng(0), TINY)["gpt"]
    if weights == "int8":
        params = jgpt2.quantize_gpt2_int8(params)
    elif weights == "int4":
        params = jgpt2.quantize_gpt2_int4(params)
    return params


def _tt(a) -> torch.Tensor:
    """A JAX array (or a torch tensor) as a torch tensor (bf16 by its bits)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _chunk_inputs(weights, kvq):
    """Both sides' trees, a prefilled flat cache (int8 with ``kvq``), its
    validity and G chunk inputs (f32)."""
    params = _gpt_format(weights)
    r = np.random.default_rng(1)
    prefix = (r.standard_normal((B, P, DIMS.dim)) * 0.3).astype(np.float32)
    mask = np.array([[False] + [True] * (P - 1), [True] * P])
    xs = (r.standard_normal((B, G, DIMS.dim)) * 0.3).astype(np.float32)
    jkv = jgpt2.init_kv_cache(DIMS, B, S, dtype=jnp.float32, quantized=kvq, flat=True)
    _, jkv = jgpt2.gpt2_prefill(params, jnp.asarray(prefix), DIMS, jnp.asarray(mask), jkv)
    valid = np.zeros((B, S), bool)
    valid[:, :P] = mask
    tp = to_torch(params, "cpu", torch.float32)
    tkv = {k: _tt(v) for k, v in jkv.items()}
    return params, tp, jkv, tkv, valid, xs


def _dequant(kv, heads):
    """A flat cache's k and v as f32 numpy (the int8 one against its scale
    rows)."""
    k, v = (_tt(kv[n]).float().numpy() for n in "kv")
    if "kvs" not in kv:
        return k, v
    kvs = _tt(kv["kvs"]).float().numpy()
    L_, B_, S_, D_ = k.shape

    def one(q8, off):
        sc = kvs[..., off:off + heads]
        return (q8.reshape(L_, B_, S_, heads, -1) * sc[..., None]).reshape(L_, B_, S_, D_)

    return one(k, 0), one(v, tgpt2.SCALE_LANES // 2)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_chunk_step_matches_jax_and_single_steps(fmt):
    weights, kvq = FORMATS[fmt]
    params, tp, jkv, tkv, valid, xs = _chunk_inputs(weights, kvq)
    jh, jkv2 = jgpt2.gpt2_chunk_step(params, jnp.asarray(xs), DIMS, jnp.int32(P), jkv,
                                     jnp.asarray(valid))
    kv = {k: t.clone() for k, t in tkv.items()}
    calls = tgpt2.gpt2_chunk_step.calls
    th = tgpt2.gpt2_chunk_step(tp, torch.as_tensor(xs), _tdims(), P, kv, torch.as_tensor(valid))
    assert tgpt2.gpt2_chunk_step.calls == calls + 1
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=RTOL)
    for got, want in zip(_dequant(kv, DIMS.heads), _dequant(jkv2, DIMS.heads)):
        np.testing.assert_allclose(got[:, :, P:P + G], want[:, :, P:P + G], atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_array_equal(got[:, :, :P], want[:, :, :P])       # untouched

    # G single steps of the port, validity marked before each
    kv1, v1 = {k: t.clone() for k, t in tkv.items()}, torch.as_tensor(valid).clone()
    for g in range(G):
        v1[:, P + g] = True
        h1 = tgpt2.gpt2_decode_step(tp, torch.as_tensor(xs[:, g]), _tdims(), P + g, kv1, v1)
        np.testing.assert_allclose(h1.numpy(), th[:, g].numpy(), atol=ATOL, rtol=RTOL)
    for a, b in zip(_dequant(kv1, DIMS.heads), _dequant(kv, DIMS.heads)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# greedy: the port's engine against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drafts", ["lookup", "oracle", "adversarial"])
@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_greedy_spec_adaptive_token_and_stats_equal_jax(case, drafts, penalty):
    """Greedy, spans (8, 16): the lookup drafts, the JAX decode's own codes
    as drafts (chunks commit whole, the gate keeps speculating), and drafts
    that never match (the gate demotes at the first span end)."""
    from indextts_tpu.engine.decode import SamplingConfig as JSampling
    from indextts_tpu.engine.decode import generate as jgenerate
    from indextts_tpu.engine.speculative import generate_spec_adaptive as jspec

    sampling = dict(do_sample=False, repetition_penalty=penalty, min_new_tokens=20)
    kw = dict(gamma=4, spans=(8, 16))
    if drafts != "lookup":
        ref, _ = jgenerate(case["params"], TINY, DIMS, case["emb"], case["mask"],
                           jax.random.PRNGKey(0), 32, JSampling(**sampling), jnp.float32)
        src = np.asarray(ref)[0] if drafts == "oracle" else np.full(32, 47, np.int32)
        kw.update(forced=True, draft_source=jnp.asarray(src, jnp.int32))
    jc, jl, js = jspec(case["params"], TINY, DIMS, case["emb"], case["mask"],
                       jax.random.PRNGKey(0), max_new_tokens=32,
                       sampling=JSampling(**sampling), dtype=jnp.float32, **kw)
    if drafts != "lookup":
        kw["draft_source"] = np.asarray(kw["draft_source"])
    codes, lens, stats = _port(case, tspec.generate_spec_adaptive, 32, sampling=sampling, **kw)
    np.testing.assert_array_equal(codes, np.asarray(jc))
    np.testing.assert_array_equal(lens, np.asarray(jl))
    np.testing.assert_array_equal(stats, np.asarray(js))
    assert stats[0] > 0 or drafts == "lookup"


# ---------------------------------------------------------------------------
# sampling: the port's engine against the port's generate_adaptive
# ---------------------------------------------------------------------------

def _reference(case, seed, max_new=24, spans=(), **kw):
    return _port(case, tdec.generate_adaptive, max_new, seed, spans=spans, **kw)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_oracle_drafts_commit_whole_chunks(case, seed):
    ref_c, ref_l = _reference(case, seed)
    c, l_, stats = _port(case, tspec.generate_spec, 24, seed, gamma=4, forced=True,
                         draft_source=ref_c[0])
    np.testing.assert_array_equal(c, ref_c)
    np.testing.assert_array_equal(l_, ref_l)
    if int(ref_l[0]) == 24:
        # chunks at steps 1 / 6 / 11 / 16 commit 5 each; step + 5 > 24 then
        assert tuple(stats) == (4, 20, 3)
    else:
        assert stats[0] > 0 and stats[1] >= stats[0]


@pytest.mark.parametrize("seed", [0, 5])
def test_adversarial_drafts_reject_and_realign(case, seed):
    ref_c, ref_l = _reference(case, seed)
    bad = (ref_c[0] + 13) % (TINY.number_mel_codes - 2)
    c, l_, stats = _port(case, tspec.generate_spec, 24, seed, gamma=4, forced=True,
                         draft_source=bad)
    np.testing.assert_array_equal(c, ref_c)
    np.testing.assert_array_equal(l_, ref_l)
    assert stats[0] > 0 and stats[1] == stats[0]           # every chunk commits 1


@pytest.mark.parametrize("seed,gamma,ngram", [(0, 4, 2), (2, 6, 3), (9, 3, 2)])
def test_lookup_drafts_match_the_sequential_decode(case, seed, gamma, ngram):
    ref_c, ref_l = _reference(case, seed, sampling=dict(repetition_penalty=1.0))
    c, l_, _ = _port(case, tspec.generate_spec, 24, seed, gamma=gamma, ngram=ngram,
                     sampling=dict(repetition_penalty=1.0))
    np.testing.assert_array_equal(c, ref_c)
    np.testing.assert_array_equal(l_, ref_l)


@pytest.mark.parametrize("seed", [0, 5])
def test_adaptive_adversarial_demotes(case, seed):
    """Never-matching drafts commit one token a chunk: the gate demotes at
    the first span end, the stats freeze there, the codes stay equal."""
    ref_c, ref_l = _reference(case, seed, spans=(8, 16))
    assert not np.any(ref_c == 47)
    growths = tdec.span_growths
    c, l_, stats = _port(case, tspec.generate_spec_adaptive, 24, seed, gamma=4, spans=(8, 16),
                         forced=True, draft_source=np.full(24, 47))
    np.testing.assert_array_equal(c, ref_c)
    np.testing.assert_array_equal(l_, ref_l)
    if int(ref_l[0]) == 24:
        assert tuple(stats) == (3, 3, 4)                    # chunks at steps 1, 2, 3
        assert tdec.span_growths == growths + 2


@pytest.mark.parametrize("seed", [0, 5])
def test_adaptive_oracle_stays_speculative(case, seed):
    ref_c, ref_l = _reference(case, seed, spans=(8, 16))
    c, l_, stats = _port(case, tspec.generate_spec_adaptive, 24, seed, gamma=4, spans=(8, 16),
                         forced=True, draft_source=ref_c[0])
    np.testing.assert_array_equal(c, ref_c)
    np.testing.assert_array_equal(l_, ref_l)
    if int(ref_l[0]) == 24:
        assert stats[0] >= 3 and stats[1] > 8               # chunks past the probe span


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_adaptive_lookup_matches_across_span_ends(case, seed):
    ref_c, ref_l = _reference(case, seed, spans=(8, 16))
    c, l_, _ = _port(case, tspec.generate_spec_adaptive, 24, seed, gamma=4, spans=(8, 16))
    np.testing.assert_array_equal(c, ref_c)
    np.testing.assert_array_equal(l_, ref_l)
    # with the gate held open, the span-bounded decode equals one full-range span
    c2, l2, _ = _port(case, tspec.generate_spec_adaptive, 24, seed, gamma=4, spans=(8, 16),
                      commit_ratio=0.0)
    c3, l3, _ = _port(case, tspec.generate_spec, 24, seed, gamma=4)
    np.testing.assert_array_equal(c2, c3)
    np.testing.assert_array_equal(l2, l3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_no_verify_keeps_the_sequential_stream(case, dtype, seed):
    """Sampling with the repetition penalty of the shipped config (10), under
    which no 2-gram repeats and so no verify fires: every step is a single
    step of the decode route, and the tokens equal `generate_adaptive`'s
    for the same generator seed, across span ends, at f32 and at bf16 (the
    promise the smoke holds at full width on the card)."""
    tree = case["tp"] if dtype == torch.float32 else to_torch(case["params"], "cpu", dtype)
    sampling = tdec.SamplingConfig(num_beams=1, repetition_penalty=10.0, min_new_tokens=40)
    args = (tree, TINY, _tdims(), case["temb"].to(dtype), case["tmask"])
    ref, ref_l = tdec.generate_adaptive(*args, torch.Generator().manual_seed(seed), 48,
                                        sampling, dtype, spans=(16, 32))
    got, got_l, stats = tspec.generate_spec_adaptive(*args, torch.Generator().manual_seed(seed),
                                                     48, sampling, dtype, spans=(16, 32))
    assert stats[0] == 0 and stats[2] == 15             # no verify; single steps to the gate
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_array_equal(got_l, ref_l)


def test_min_new_tokens_respected(case):
    samp = dict(repetition_penalty=1.0, min_new_tokens=12)
    ref_c, ref_l = _reference(case, 7, 20, sampling=samp)
    c, l_, _ = _port(case, tspec.generate_spec_adaptive, 20, 7, gamma=4, spans=(8,),
                     sampling=samp)
    np.testing.assert_array_equal(c, ref_c)
    np.testing.assert_array_equal(l_, ref_l)
    assert (l_ >= 12).all()


def test_max_new_tokens_one(case):
    ref_c, ref_l = _reference(case, 0, 1)
    for fn in (tspec.generate_spec, tspec.generate_spec_adaptive):
        c, l_, stats = _port(case, fn, 1, 0, gamma=4)
        np.testing.assert_array_equal(c, ref_c)
        np.testing.assert_array_equal(l_, ref_l)
        np.testing.assert_array_equal(stats, [0, 0, 0])


@pytest.mark.parametrize("forced", [False, True], ids=["lookup", "oracle"])
def test_int8_cache_matches_the_sequential_decode(case, forced):
    samp = dict(kv_quant=True, repetition_penalty=1.0)
    ref_c, ref_l = _reference(case, 2, spans=(8, 16), sampling=samp)
    c, l_, stats = _port(case, tspec.generate_spec_adaptive, 24, 2, gamma=4, spans=(8, 16),
                         sampling=samp, forced=forced, draft_source=ref_c[0])
    assert tdec.last_route == "plain"
    np.testing.assert_array_equal(c, ref_c)
    np.testing.assert_array_equal(l_, ref_l)
    assert stats[0] > 0 or not forced


def test_int8_weights_through_k1s_twin(monkeypatch):
    """int8 weights (bf16): every single step takes K1 (its twin on the CPU)
    at group=1 without an ancestry map, every verify the stock-op chunk
    step, whose hidden stays within K1's layer tolerance (rel-L2 1e-2) of
    the twin's single steps on the same inputs. Codes are not held equal
    here: K1's bf16 rounding chain moves the hidden by ~4e-3 from the stock
    ops', which flips near-tied picks of this 50-code random model (at f32,
    where they are held equal, K1 does not run)."""
    from indextts_tpu_torch.ops import decode_step as tds
    from test_torch_int8 import _beam_cfg, _bf16, _t

    cfg = _beam_cfg()
    params = jax.tree_util.tree_map(_bf16, init_unified_voice(InitRng(0), cfg))
    params["gpt"] = jgpt2.quantize_gpt2_int8(params["gpt"])
    tp = to_torch(params, "cpu", torch.bfloat16)
    dims = tgpt2.GPT2Dims(cfg.layers, cfg.model_dim, cfg.heads)
    prefix = _t(_bf16(np.random.default_rng(4).normal(0, 0.3, (1, 7, cfg.model_dim))))
    mask = torch.ones((1, 7), dtype=torch.bool)
    samp = tdec.SamplingConfig(num_beams=1, min_new_tokens=16)
    groups = []
    real = tds.fused_decode_step

    def spy(*args, **kw):
        groups.append((kw.get("group", 1), kw.get("anc") is not None))
        return real(*args, **kw)

    monkeypatch.setattr(tdec, "fused_decode_step", spy)
    ref_c, _ = tdec.generate_adaptive(tp, cfg, dims, prefix, mask,
                                      torch.Generator().manual_seed(5), 16, samp,
                                      torch.bfloat16, spans=())
    chunks = tgpt2.gpt2_chunk_step.calls
    c, l_, stats = tspec.generate_spec(tp, cfg, dims, prefix, mask,
                                       torch.Generator().manual_seed(5), 16, samp,
                                       torch.bfloat16, gamma=3, forced=True,
                                       draft_source=ref_c[0])
    assert tdec.last_route == "fused" and stats[0] > 0
    assert tgpt2.gpt2_chunk_step.calls == chunks + stats[0]
    assert len(groups) == 15 + stats[2] and set(groups) == {(1, False)}
    assert l_[0] == 16 and c.shape == (1, 16)

    # the verify step against the twin's single steps on one cache
    kv = tgpt2.init_kv_cache(dims, 1, 24, dtype=torch.bfloat16)
    tgpt2.gpt2_prefill(tp["gpt"], prefix, dims, mask, kv)
    valid = torch.zeros((1, 24), dtype=torch.bool)
    valid[:, :7] = True
    xs = _t(_bf16(np.random.default_rng(6).normal(0, 0.3, (1, 4, cfg.model_dim))))
    kc = {k: t.clone() for k, t in kv.items()}
    hc = tgpt2.gpt2_chunk_step(tp["gpt"], xs, dims, 7, kc, valid)
    for j in range(4):
        valid[:, 7 + j] = True
        h1 = real(tp["gpt"], xs[:, j], dims, 7 + j, kv, valid)
        rel = float((hc[:, j].float() - h1.float()).norm() / h1.float().norm())
        assert rel <= 1e-2, (j, rel)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def test_pipeline_num_beams_1_takes_spec_and_the_switch_reverts(torch_tts, model_dir,
                                                               monkeypatch):
    from indextts_tpu_torch.pipeline import infer_v2

    kw = dict(spk_audio_prompt=os.path.join(model_dir, "prompt.wav"), text="hello world .",
              output_path=None, num_beams=1, max_mel_tokens=12, min_new_tokens=11)
    seen = []
    real = infer_v2.generate_adaptive
    monkeypatch.setattr(infer_v2, "generate_adaptive", lambda *a, **k: seen.append(1) or
                        real(*a, **k))
    monkeypatch.delenv("INDEXTTS_SPEC_DECODE", raising=False)
    torch_tts.last_spec_stats = None
    torch_tts.generator.manual_seed(0)
    _, wav_spec = torch_tts.infer(**kw)
    stats = torch_tts.last_spec_stats
    assert stats is not None and stats[0] == 8 and sum(stats[2:]) + stats[1] == 11
    assert not seen
    monkeypatch.setenv("INDEXTTS_SPEC_DECODE", "0")
    torch_tts.last_spec_stats = None
    torch_tts.generator.manual_seed(0)
    _, wav_plain = torch_tts.infer(**kw)
    assert torch_tts.last_spec_stats is None and len(seen) == 1
    np.testing.assert_array_equal(wav_spec, wav_plain)       # same tokens, same draws
    monkeypatch.setenv("INDEXTTS_SPEC_DECODE", "3")
    torch_tts.infer(**kw)
    assert torch_tts.last_spec_stats[0] == 3


def test_pipeline_greedy_spec_codes_equal_jax(jax_tts, torch_tts, model_dir, monkeypatch):
    """Greedy at num_beams=1 with no repetition penalty (codes that repeat,
    so chunks fire): the port's codes and spec stats equal the JAX
    pipeline's."""
    kw = dict(spk_audio_prompt=os.path.join(model_dir, "prompt.wav"), text="hello world .",
              output_path=None, num_beams=1, do_sample=False, repetition_penalty=1.0,
              max_mel_tokens=40, min_new_tokens=30)
    monkeypatch.delenv("INDEXTTS_SPEC_DECODE", raising=False)
    j = jax_tts
    j.capture, j._rng = [], jax.random.PRNGKey(0)
    try:
        j.infer(**kw)
        cap = j.capture
    finally:
        j.capture = None
    calls = []
    orig = torch_tts.codes_to_wav
    monkeypatch.setattr(torch_tts, "codes_to_wav",
                        lambda *a, **k: calls.append(a) or orig(*a, **k))
    torch_tts.infer(**kw)
    assert len(cap) == len(calls) == 1
    codes, clen = calls[0][5].numpy(), int(calls[0][6])
    assert clen == int(cap[0]["code_lens"][0])
    np.testing.assert_array_equal(codes[0, :clen], cap[0]["codes"][0, :clen])
    assert torch_tts.last_spec_stats == j.last_spec_stats
    assert torch_tts.last_spec_stats[1] > 0
