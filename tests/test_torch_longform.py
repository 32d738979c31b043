"""PyTorch port, long-form and streaming synthesis and ``emo_vector``: the JAX
`IndexTTS2` and the port's on the tiny pipeline config (f32, CPU), with the
JAX pipeline's weights and emotion matrices carried across
(`tests/test_torch_pipeline.py`'s fixtures).

- a greedy multi-segment request decodes the segments as one batch
  token-equal to the JAX pipeline's batch codes (num_beams=2 and 1), the
  batched synthesis given the JAX noise gives JAX's per-row wavs (rel-L2 <=
  1e-3 a row) and the whole `infer` output JAX's int16 output within 2 LSB;
- row chunks (the decode in one chunk or in two) change no output,
  the sequential path (batch_segments=False) gives the batched one's shape,
  and a segment past the bucket table is not truncated on the batched path;
- streaming yields JAX's chunks (count and shapes) over JAX's segments, with
  `more_segment_before` reaching the segmenter as in the JAX pipeline;
- `normalize_emo_vec` / `find_most_similar_cosine` equal JAX's, and an
  ``emo_vector`` request (nearest and random rows) gives JAX's emovec (atol
  2e-4, rtol 1e-3) and greedy codes;
- an empty text gives the JAX pipeline's empty results on all three return
  paths.
"""

import os
import random
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, "tests")

from test_torch_pipeline import _one_torch_thread, jax_tts, model_dir, torch_tts  # noqa: E402,F401

TEXT4 = "hello world . the cat . hello world . the cat ."   # 4 segments at 4 tokens
GREEDY = dict(do_sample=False, max_mel_tokens=8, min_new_tokens=3,
              max_text_tokens_per_segment=4)


def _prompt(model_dir):
    return os.path.join(model_dir, "prompt.wav")


def _jax_noise(rng, shape):
    return torch.as_tensor(np.asarray(jax.random.normal(rng, tuple(shape), jnp.float32)))


def _jax_request(j, seed, **kw):
    """One JAX `infer` with its synthesis inputs captured; returns (result,
    the captured dicts)."""
    j.capture = []
    j._rng = jax.random.PRNGKey(seed)
    try:
        out = j.infer(**kw)
        return out, j.capture
    finally:
        j.capture = None


def _port_request(tts, noise=None, **kw):
    """One port `infer` with every `codes_to_wav` call's arguments recorded;
    ``noise(shape)`` replaces the CFM noise draw when given."""
    calls = []
    orig = tts.codes_to_wav

    def record(*args, **kwargs):
        calls.append(args)
        return orig(*args, **kwargs)

    tts.codes_to_wav = record
    if noise is not None:
        tts.cfm_noise = noise
    tts.generator.manual_seed(0)
    try:
        return tts.infer(**kw), calls
    finally:
        del tts.codes_to_wav
        tts.__dict__.pop("cfm_noise", None)


def _batch(calls):
    """The codes (B, width) and lengths of the one batched synthesis."""
    assert len(calls) == 1, len(calls)
    _, _, _, _, _, codes, clens = calls[0]
    return codes.numpy(), np.asarray(clens)


@pytest.fixture(scope="module")
def beams2(jax_tts, torch_tts, model_dir):
    """The greedy 4-segment request at num_beams=2 on both sides; the port
    is handed the JAX pipeline's CFM noise."""
    kw = dict(spk_audio_prompt=_prompt(model_dir), text=TEXT4, output_path=None, num_beams=2,
              **GREEDY)
    out_j, cap = _jax_request(jax_tts, 0, **kw)
    assert len(cap) == 1 and cap[0]["codes"].shape[0] == 4, [c["codes"].shape for c in cap]
    c = cap[0]
    out_t, calls = _port_request(torch_tts, noise=lambda shape: _jax_noise(c["rng"], shape),
                                 **kw)
    return {"jax": out_j, "cap": c, "port": out_t, "calls": calls}


def _assert_codes_equal(c, calls):
    codes, clens = _batch(calls)
    np.testing.assert_array_equal(clens, np.maximum(c["code_lens"], 1))
    for b, n in enumerate(clens):
        np.testing.assert_array_equal(codes[b, :n], c["codes"][b, :n])


def test_batched_beam_codes_token_equal(beams2):
    _assert_codes_equal(beams2["cap"], beams2["calls"])


def test_batched_synthesis_matches_jax_rows(beams2, jax_tts, torch_tts, model_dir):
    """The JAX batch codes, cut to a different length a row, through the
    port's batched synthesis with the JAX noise, against the JAX programs
    on the same rows."""
    j, tts, c = jax_tts, torch_tts, dict(beams2["cap"])
    c["code_lens"] = np.minimum(c["code_lens"], [8, 5, 7, 3]).astype(np.int32)
    spk = j.cache_spk
    s_infer = j._jit_latent(j.gpt_params, j.s2mel_params, j.codec_params, c["cond_latents"],
                            c["emovec"], jnp.asarray(c["text_ids"]),
                            jnp.asarray(c["text_lens"]), jnp.asarray(c["codes"]),
                            jnp.asarray(c["code_lens"]), code_bucket=c["code_bucket"])
    vc, tlen = j._jit_synth(j.s2mel_params, s_infer, jnp.asarray(c["code_lens"]),
                            spk["prompt_cond"], jnp.asarray([spk["ref_len"]]), spk["ref_mel"],
                            spk["style"], c["rng"], mel_bucket=c["mel_bucket"],
                            prompt_bucket=c["prompt_bucket"])
    ref = np.asarray(j._jit_vocoder(j.bigvgan_params, vc, tlen))

    pspk = tts._prepare_spk_prompt(_prompt(model_dir))
    cond_latents, emovec = tts.conditioning(pspk, tts._prepare_emo_cond(_prompt(model_dir)), 1.0)
    B, T = c["codes"].shape[0], c["prompt_bucket"] + c["mel_bucket"]
    with torch.inference_mode():
        wav = tts.codes_to_wav(pspk, cond_latents, emovec, c["text_ids"], c["text_lens"],
                               torch.as_tensor(c["codes"]).long(),
                               c["code_lens"], z=_jax_noise(c["rng"], (B, T, 80)))
    assert wav.shape[0] == B and len(set(c["code_lens"])) == B
    for b, clen in enumerate(c["code_lens"]):
        n = int(np.float32(clen) * np.float32(1.72)) * 256
        rel = np.linalg.norm(wav[b, :n] - ref[b, :n]) / np.linalg.norm(ref[b, :n])
        assert rel <= 1e-3, (b, rel)
        assert not wav[b, n:].any()


def test_batched_infer_output_matches_jax(beams2):
    (sr_j, wav_j), (sr_t, wav_t) = beams2["jax"], beams2["port"]
    assert sr_j == sr_t == 22050 and wav_t.dtype == np.int16
    assert wav_t.shape == wav_j.shape, (wav_t.shape, wav_j.shape)
    diff = np.abs(wav_t.astype(np.int32) - wav_j.astype(np.int32)).max()
    assert diff <= 2, diff


def test_batched_sampling_decode_codes_token_equal(jax_tts, torch_tts, model_dir):
    kw = dict(spk_audio_prompt=_prompt(model_dir), text=TEXT4, output_path=None, num_beams=1,
              **GREEDY)
    _, cap = _jax_request(jax_tts, 0, **kw)
    _, calls = _port_request(torch_tts, **kw)
    assert len(cap) == 1
    _assert_codes_equal(cap[0], calls)


@pytest.mark.parametrize("rows,engine,num_beams", [
    (4, "generate_beam", 2),         # 4 // 2 = 2 segments a chunk, 4 decode rows
    (2, "generate_adaptive", 1),
], ids=["beams", "sampling"])
def test_row_chunks_change_nothing(torch_tts, model_dir, monkeypatch, rows, engine, num_beams):
    """The 4 segments in one decode chunk (MAX_ROWS = 24) and in two (a
    smaller MAX_ROWS) give the same output."""
    from indextts_tpu_torch.pipeline import infer_v2 as iv2

    kw = dict(spk_audio_prompt=_prompt(model_dir), text=TEXT4, output_path=None,
              num_beams=num_beams, **GREEDY)
    orig, chunks = getattr(iv2, engine), []

    def counted(params, cfg, dims, embeds, *args, **kwargs):
        chunks.append(embeds.shape[0])
        return orig(params, cfg, dims, embeds, *args, **kwargs)

    monkeypatch.setattr(iv2, engine, counted)
    outs = []
    for max_rows in (iv2.MAX_ROWS, rows):
        monkeypatch.setattr(iv2, "MAX_ROWS", max_rows)
        chunks.clear()
        (sr, wav), calls = _port_request(torch_tts, **kw)
        outs.append((sr, wav, len(calls), list(chunks)))
    assert outs[0][3] == [4] and outs[1][3] == [2, 2], (outs[0][3], outs[1][3])
    assert outs[0][2] == outs[1][2] == 1           # one batched synthesis either way
    assert outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_sequential_path_gives_the_batched_shape(torch_tts, model_dir, monkeypatch):
    kw = dict(spk_audio_prompt=_prompt(model_dir), text=TEXT4, output_path=None, num_beams=1,
              **GREEDY)
    (sr_b, wav_b), calls_b = _port_request(torch_tts, **kw)
    monkeypatch.setitem(torch_tts.cfg.engine.__dict__, "batch_segments", False)
    (sr_s, wav_s), calls_s = _port_request(torch_tts, **kw)
    assert len(calls_b) == 1 and len(calls_s) == 4
    assert sr_b == sr_s and wav_b.shape == wav_s.shape
    assert torch_tts.last_stage_times["segment_codes"] == list(_batch(calls_b)[1])


def _recorded_segments(tokenizer, seen):
    orig = tokenizer.split_segments

    def split(*args, **kwargs):
        seen.append(orig(*args, **kwargs))
        return seen[-1]
    return split


@pytest.mark.parametrize("text,max_tokens,more_segment_before", [
    ("hello world . the cat . hello .", 4, 0),
    ("hello world . cat", 4, 4),          # more_segment_before splits where 0 does not
])
def test_streaming_yields_jax_chunks(jax_tts, torch_tts, model_dir, monkeypatch, text,
                                     max_tokens, more_segment_before):
    monkeypatch.setenv("INDEXTTS_SPEC_DECODE", "0")   # token-identical; fewer JAX compiles
    kw = dict(spk_audio_prompt=_prompt(model_dir), text=text, output_path=None, num_beams=1,
              do_sample=False, max_mel_tokens=8, min_new_tokens=3,
              max_text_tokens_per_segment=max_tokens, stream_return=True,
              more_segment_before=more_segment_before)
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jax_tts.tokenizer, "split_segments",
                        _recorded_segments(jax_tts.tokenizer, seen["jax"]))
    monkeypatch.setattr(torch_tts.tokenizer, "split_segments",
                        _recorded_segments(torch_tts.tokenizer, seen["port"]))
    jax_tts._rng = jax.random.PRNGKey(0)
    ref = list(jax_tts.infer(**kw))
    gen, _ = _port_request(torch_tts, **kw)
    assert not isinstance(gen, (tuple, list))       # infer returned the generator
    got = list(gen)
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 1
    nseg = len(seen["port"][0])
    assert nseg == (2 if more_segment_before else 3)
    assert len(got) == len(ref) == 2 * nseg
    assert [c.shape for c in got] == [c.shape for c in ref]
    assert all(isinstance(c, np.ndarray) and c.dtype == np.float32 for c in got)
    assert all(not c.any() for c in got[1::2])        # the silences


def test_batched_segments_past_the_bucket_table_are_not_truncated(torch_tts, model_dir,
                                                                  monkeypatch):
    from indextts_tpu_torch.pipeline import infer_v2 as iv2

    monkeypatch.setitem(torch_tts.cfg.engine.__dict__, "mel_len_buckets", (64, 128))
    clen, stop = 100, torch_tts.cfg.gpt.stop_mel_token

    def fake_decode(params, cfg, dims, pe, pm, generator, max_new_tokens, sampling, dtype,
                    step_check=None):
        codes = torch.full((pe.shape[0], clen + 4), stop, dtype=torch.long)
        codes[:, :clen] = 1
        return codes, np.full(pe.shape[0], clen)

    monkeypatch.setattr(iv2, "generate_adaptive", fake_decode)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (sr, wav), calls = _port_request(
            torch_tts, spk_audio_prompt=_prompt(model_dir), text="hello world . the cat . hello .",
            output_path=None, max_mel_tokens=8, num_beams=1, max_text_tokens_per_segment=4,
            interval_silence=0)
    assert sr == 22050 and len(calls) == 1
    assert wav.shape[0] == 3 * int(np.float32(clen) * np.float32(1.72)) * 256, wav.shape


def test_normalize_emo_vec_and_cosine_match_jax():
    from indextts_tpu.pipeline.emotion import normalize_emo_vec as jax_norm
    from indextts_tpu.pipeline.infer_v2 import find_most_similar_cosine as jax_cos

    from indextts_tpu_torch.pipeline.infer_v2 import find_most_similar_cosine, normalize_emo_vec

    rng = np.random.default_rng(5)
    for vec in ([0.5, 0, 0, 0, 0, 0, 0, 0.3], list(rng.uniform(0, 0.4, 8)), [0.05] * 8):
        for bias in (True, False):
            np.testing.assert_allclose(normalize_emo_vec(vec, bias), jax_norm(vec, bias),
                                       rtol=0, atol=1e-12)
    for _ in range(5):
        q, m = rng.standard_normal(192), rng.standard_normal((9, 192))
        assert find_most_similar_cosine(torch.as_tensor(q), torch.as_tensor(m)) \
            == jax_cos(jnp.asarray(q), jnp.asarray(m))
    assert find_most_similar_cosine(torch.zeros(4), torch.eye(4)) == jax_cos(jnp.zeros(4),
                                                                             jnp.eye(4))


@pytest.mark.parametrize("use_random", [False, True], ids=["nearest", "random"])
def test_emo_vector_request_matches_jax(jax_tts, torch_tts, model_dir, use_random):
    """Greedy, one segment, num_beams=2; emo_alpha 0.7 scales the vector."""
    kw = dict(spk_audio_prompt=_prompt(model_dir), text="hello world .", output_path=None,
              emo_vector=[0.5, 0, 0.1, 0, 0, 0, 0, 0.3], emo_alpha=0.7, use_random=use_random,
              num_beams=2, do_sample=False, max_mel_tokens=8, min_new_tokens=3)
    random.seed(11)
    _, cap = _jax_request(jax_tts, 0, **kw)
    random.seed(11)
    _, calls = _port_request(torch_tts, **kw)
    assert len(cap) == len(calls) == 1
    c, (_, _, emovec, _, _, codes, clen) = cap[0], calls[0]
    np.testing.assert_allclose(emovec.float().numpy(), c["emovec"], atol=2e-4, rtol=1e-3)
    n = int(c["code_lens"][0])
    assert clen == max(n, 1)
    np.testing.assert_array_equal(codes.numpy()[0, :n], c["codes"][0, :n])


@pytest.mark.parametrize("path", ["file", "tuple", "stream"])
def test_empty_text_gives_empty_audio(torch_tts, model_dir, tmp_path, path):
    from indextts_tpu_torch.utils.wav_io import read_wav_mono

    out = str(tmp_path / "empty.wav") if path == "file" else None
    res = torch_tts.infer(spk_audio_prompt=_prompt(model_dir), text="", output_path=out,
                          stream_return=path == "stream", max_mel_tokens=8)
    if path == "file":
        assert res == out
        audio, sr = read_wav_mono(out)
        assert sr == 22050 and audio.shape == (1, 0)
    elif path == "tuple":
        sr, wav = res
        assert sr == 22050 and wav.dtype == np.int16 and wav.shape == (0, 1)
    else:
        assert list(res) == []
    st = torch_tts.last_stage_times
    assert st["codes"] == 0 and st["segment_codes"] == [] and st["audio_s"] == 0
