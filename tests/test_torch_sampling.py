"""PyTorch port, the num_beams=1 sampling decode: the warpers against the JAX
package's on identical logits, greedy `generate` / `generate_adaptive`
against the JAX engine, and the tiny pipeline at num_beams=1.

`torch.Generator` cannot reproduce `jax.random`'s numbers, so a sampled
token is no fault signal: the port is held to the warped logits the draw
samples from (f32, rtol 1e-6: the same operations in the same order) and to
greedy decoding, token for token. The int8 decode holds the port's K1 twin
at group=1 against the JAX package's mask-based XLA step
(INDEXTTS_FUSED_DECODE=0; the JAX fused kernel's window differs across the
decode's unwritten slot P + 1), on the tiny GPT of `tests/test_torch_int8.py`;
decodes stay at a dozen steps. Torch runs one intra-op thread.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, "tests")

from test_pipeline_e2e import tiny_config  # noqa: E402

from indextts_tpu_torch.ops import sampling as tsamp  # noqa: E402
from indextts_tpu_torch.utils.jax_params import to_torch  # noqa: E402

STEPS, SPANS, MIN_NEW = 12, (4, 8), 10      # MIN_NEW crosses both span ends


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("typical", [None, 0.9])
def test_warped_logits_match_jax(typical):
    """penalty -> temperature -> top-k -> typical -> top-p, on identical
    logits; the sampler's draws land inside the warped support."""
    from indextts_tpu.ops import sampling as jsamp

    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 200)) * 3).astype(np.float32)
    counts = (rng.random((3, 200)) < 0.1).astype(np.int32)
    kw = dict(temperature=0.8, top_k=60, top_p=0.8)
    jf = jsamp.apply_temperature(jsamp.apply_repetition_penalty(
        jnp.asarray(logits), jnp.asarray(counts), 10.0), kw["temperature"])
    jf = jsamp.apply_top_k(jf, kw["top_k"])
    if typical is not None:
        jf = jsamp.apply_typical(jf, typical)
    jf = np.asarray(jsamp.apply_top_p(jf, kw["top_p"]))
    out = tsamp.warp_logits(t(logits), t(counts), repetition_penalty=10.0,
                            typical_mass=typical, **kw)
    np.testing.assert_allclose(out.numpy(), jf, rtol=1e-6)
    assert (out > tsamp.NEG_INF).sum() < 60
    g = torch.Generator().manual_seed(0)
    for _ in range(4):
        tok = tsamp.sample_logits(g, t(logits), t(counts), repetition_penalty=10.0,
                                  typical_mass=typical, **kw)
        assert bool((out.gather(-1, tok[:, None]) > tsamp.NEG_INF).all())
    greedy = tsamp.sample_logits(g, t(logits), t(counts), do_sample=False)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jsamp.sample_logits(
        jax.random.PRNGKey(0), jnp.asarray(logits), jnp.asarray(counts), do_sample=False)))


def _gpt_case(quantized: bool):
    """The tiny GPT (2 x 640, 10 heads) with bf16 weights, or int8 ones, and
    two left-padded prefixes of different lengths."""
    from indextts_tpu.models.gpt import gpt2 as jgpt2
    from indextts_tpu.models.gpt.unified_voice import init_unified_voice
    from indextts_tpu.nn import InitRng
    from test_torch_int8 import _beam_cfg, _bf16

    cfg = _beam_cfg()
    params = jax.tree_util.tree_map(_bf16, init_unified_voice(InitRng(0), cfg))
    if quantized:
        params["gpt"] = jgpt2.quantize_gpt2_int8(params["gpt"])
    rng = np.random.default_rng(4)
    B, P = 2, 9
    pe = rng.normal(0, 0.3, (B, P, cfg.model_dim))
    pe[1, :4] = 0
    prefix = _bf16(pe)
    mask = np.ones((B, P), bool)
    mask[1, :4] = False
    return cfg, params, prefix, mask


def _first_flip_is_a_near_tie(toks, ref_toks, ref_logits, tol):
    """Greedy codes of two decodes that differ only by bf16 rounding: equal
    up to their first difference, if any, and there the reference's pick
    leads the other's by less than ``tol`` of the row's largest |logit| (a
    near tie the rounding may flip; after it the prefixes differ)."""
    diff = np.argwhere(toks != ref_toks)
    if not len(diff):
        return
    step = diff[:, 1].min()
    for b in diff[diff[:, 1] == step, 0]:
        lg = ref_logits[step][b]
        margin = lg[ref_toks[b, step]] - lg[toks[b, step]]
        assert 0 <= margin <= tol * np.abs(lg).max(), (b, step, margin)


@pytest.mark.parametrize("quantized", [False, True])
def test_greedy_generate_token_equal_jax(monkeypatch, quantized):
    """The JAX reference is its mask-based XLA step (bf16, or the int8 tree).
    The port's plain step is that step's math: token-equal. With int8
    weights the port's decode runs K1's twin at group=1, whose window is the
    same slots (the decode's unwritten slot P + 1 out, slot 0 in) but whose
    bf16 rounding chain is K1's: each step's hidden within rel-L2 2e-2 of
    the plain step on the same cache and token, and codes equal to the plain
    route's but for a near tie (2e-2 of the row's largest |logit|)."""
    from indextts_tpu.engine import decode as jdec
    from indextts_tpu.models.gpt.gpt2 import GPT2Dims as JDims
    from indextts_tpu_torch.engine import decode as tdec
    from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims, gpt2_decode_step
    from test_torch_int8 import _t

    cfg, params, prefix, mask = _gpt_case(quantized)
    monkeypatch.setenv("INDEXTTS_FUSED_DECODE", "0")
    samp = dict(do_sample=False, num_beams=1, min_new_tokens=MIN_NEW)
    # JAX's one-span `generate` (token-identical to its `generate_adaptive`
    # by the JAX package's own tests) compiles once, not once per span
    ref_toks, ref_lens = jdec.generate(
        params, cfg, JDims(cfg.layers, cfg.model_dim, cfg.heads), jnp.asarray(prefix),
        jnp.asarray(mask), jax.random.PRNGKey(0), STEPS, jdec.SamplingConfig(**samp))
    ref_toks, ref_lens = np.asarray(ref_toks), np.asarray(ref_lens)
    assert ref_lens.min() >= MIN_NEW

    tp = to_torch(params, "cpu", torch.bfloat16)
    dims = GPT2Dims(cfg.layers, cfg.model_dim, cfg.heads)
    sampling = tdec.SamplingConfig(**samp)
    args = (tp, cfg, dims, _t(prefix), torch.tensor(mask), torch.Generator().manual_seed(0),
            STEPS, sampling)
    logits = {}
    real_sample, real_route = tdec._sample, tdec.decode_route

    def record(generator, lg, counts, sampling):
        logits.setdefault(route, []).append(tsamp.apply_repetition_penalty(
            lg.float(), counts, sampling.repetition_penalty).numpy())
        return real_sample(generator, lg, counts, sampling)

    monkeypatch.setattr(tdec, "_sample", record)
    if quantized:           # the plain step on the int8 tree first: JAX's math
        route = "plain"
        monkeypatch.setattr(tdec, "decode_route", lambda *a, **k: "plain")
        plain_toks, plain_lens = tdec.generate_adaptive(*args, spans=SPANS)
        np.testing.assert_array_equal(plain_toks.numpy(), ref_toks)
        np.testing.assert_array_equal(plain_lens, ref_lens)
        monkeypatch.setattr(tdec, "decode_route", real_route)
    route = "port"
    rels = []

    def against_plain(a, h):
        kv = {k: t.clone() for k, t in a["kv_cache"].items()}
        h_plain = gpt2_decode_step(a["params"], a["x"], dims, a["pos"], kv, a["kv_valid"])
        rels.append(float((h.float() - h_plain.float()).norm() / h_plain.float().norm()))

    calls, growths = gpt2_decode_step.calls, tdec.span_growths
    toks, lens = tdec.generate_adaptive(*args, spans=SPANS,
                                        step_check=against_plain if quantized else None)
    assert tdec.span_growths == growths + 2                # 4 -> 8 -> 12
    assert tdec.last_route == ("fused" if quantized else "plain")
    # the bf16 step runs once a step (11 after the prefill); under K1 only
    # the check's reference steps call it
    assert gpt2_decode_step.calls == calls + STEPS - 1
    if quantized:
        assert len(rels) == STEPS - 1 and max(rels) <= 2e-2, rels
        _first_flip_is_a_near_tie(toks.numpy(), ref_toks, logits["plain"], 2e-2)
    else:
        np.testing.assert_array_equal(toks.numpy(), ref_toks)
        np.testing.assert_array_equal(lens, ref_lens)
    toks1, lens1 = tdec.generate(*args)
    assert torch.equal(toks1, toks)
    np.testing.assert_array_equal(lens1, lens)


def test_generate_stops_early_when_every_row_is_done():
    """A stop-biased head ends both rows within the first span: the loop
    stops at the next poll of the done flag, the cache never grows, and
    codes past each length are stop_mel."""
    from indextts_tpu_torch.engine import decode as tdec
    from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims
    from test_torch_int8 import _t

    cfg, params, prefix, mask = _gpt_case(False)
    params["mel_head"]["bias"] = np.array(params["mel_head"]["bias"], np.float32)
    params["mel_head"]["bias"][cfg.stop_mel_token] += 50.0
    tp = to_torch(params, "cpu", torch.bfloat16)
    growths = tdec.span_growths
    toks, lens = tdec.generate_adaptive(
        tp, cfg, GPT2Dims(cfg.layers, cfg.model_dim, cfg.heads), _t(prefix),
        torch.tensor(mask), torch.Generator().manual_seed(0), 40,
        tdec.SamplingConfig(do_sample=False, num_beams=1, min_new_tokens=2), spans=(16,))
    np.testing.assert_array_equal(lens, [2, 2])
    assert bool((toks[:, 2:] == cfg.stop_mel_token).all())
    assert tdec.span_growths == growths


def test_grow_pads_every_cache_entry_along_s():
    """Between spans the cache grows along S with every entry, the int8
    cache's scale rows too: the old slots kept, the new ones zero and not
    valid."""
    from indextts_tpu_torch.engine import decode as tdec
    from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims, init_kv_cache

    kv = init_kv_cache(GPT2Dims(2, 128, 2), 3, 10, quantized=True)
    g = torch.Generator().manual_seed(0)
    for buf in kv.values():
        buf.copy_(torch.randint(1, 100, buf.shape, generator=g).to(buf.dtype))
    valid = torch.rand((3, 10), generator=g) < 0.5
    st = tdec.DecodeState(1, None, None, {k: v.clone() for k, v in kv.items()}, valid.clone(),
                          None, None, "fused")
    tdec._grow(st, 16)
    assert set(st.kv) == {"k", "v", "kvs"}
    for name, buf in kv.items():
        assert st.kv[name].shape == buf.shape[:2] + (16,) + buf.shape[3:]
        assert torch.equal(st.kv[name][:, :, :10], buf) and not st.kv[name][:, :, 10:].any()
    assert torch.equal(st.kv_valid[:, :10], valid) and not st.kv_valid[:, 10:].any()


@pytest.mark.parametrize("quantization", [None, "int8"])
def test_pipeline_num_beams_1_answers_a_request(tmp_path, quantization):
    """The tiny pipeline at num_beams=1 writes a wav of int(codes * 1.72) *
    256 samples; with int8 weights every step takes K1 (route "fused", the
    bf16 step never runs), with bf16 weights the bf16 step; the beam engine
    never runs."""
    from indextts_tpu.text.spm import build_model_file
    from indextts_tpu.utils.wav_io import read_wav, write_wav
    from indextts_tpu_torch.engine import beam as tbeam
    from indextts_tpu_torch.engine import decode as tdec
    from indextts_tpu_torch.models.gpt.gpt2 import gpt2_decode_step
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    vocab = [w[:i] for w in ["▁HELLO", "▁WORLD", "▁."] for i in range(2, len(w) + 1)]
    for i, w in enumerate(vocab + ["▁", ".", "▁,", "E", "L", "O"]):
        pieces.append((w, -1.0 - i, 1))
    build_model_file(pieces, str(tmp_path / "bpe.model"))
    tt = np.arange(int(0.8 * 16000)) / 16000
    write_wav(str(tmp_path / "prompt.wav"),
              (0.3 * np.sin(2 * np.pi * 220 * tt)).astype(np.float32), 16000)
    tts = IndexTTS2(cfg_path=None, model_dir=str(tmp_path), device="cpu", cfg=tiny_config(),
                    quantization=quantization)
    calls, gathers = gpt2_decode_step.calls, tbeam.kv_gathers
    tbeam.last_use_anc = None
    out = str(tmp_path / "gen.wav")
    assert tts.infer(spk_audio_prompt=str(tmp_path / "prompt.wav"), text="hello world .",
                     output_path=out, num_beams=1, typical_sampling=quantization is None,
                     max_mel_tokens=12, min_new_tokens=11) == out
    clen = tts.last_stage_times["codes"]
    wav, sr = read_wav(out)
    assert clen == 12 and sr == 22050
    assert wav.shape[1] == int(np.float32(clen) * np.float32(1.72)) * 256
    assert np.all(np.isfinite(wav))
    assert tdec.last_route == ("fused" if quantization else "plain")
    assert gpt2_decode_step.calls == calls + (0 if quantization else clen - 1)
    assert (tbeam.last_use_anc, tbeam.kv_gathers) == (None, gathers)
