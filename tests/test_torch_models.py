"""PyTorch port, model layer: every slice module against its JAX counterpart
at the tiny pipeline config, f32, with the JAX package's own random weights
carried across by the weight bridge (`indextts_tpu_torch/utils/jax_params.py`)
and inputs from a seeded numpy generator. Tolerance: the JAX parity suite's
f32 convention, atol 2e-4 / rtol 1e-3.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, "tests")

from test_pipeline_e2e import tiny_config  # noqa: E402

from indextts_tpu.nn import InitRng  # noqa: E402
from indextts_tpu_torch.utils.jax_params import to_torch  # noqa: E402

ATOL, RTOL = 2e-4, 1e-3


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


def close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def cfg():
    return tiny_config()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_w2vbert(cfg, rng):
    from indextts_tpu.models.codec.w2vbert import init_w2vbert, w2vbert_forward
    from indextts_tpu_torch.models.codec import w2vbert as tw

    p = init_w2vbert(InitRng(0), cfg.w2v_bert)
    x = rng.standard_normal((1, 40, 160)).astype(np.float32)
    lens = np.array([33])
    ref = jax.jit(lambda p, x, n: w2vbert_forward(p, cfg.w2v_bert, x, n))(
        p, jnp.asarray(x), jnp.asarray(lens))
    out = tw.w2vbert_forward(to_torch(p), cfg.w2v_bert, t(x), t(lens))
    close(out[:, :33], np.asarray(ref)[:, :33])


def test_repcodec(cfg, rng):
    from indextts_tpu.models.codec.repcodec import (init_repcodec, repcodec_quantize,
                                                    repcodec_vq2emb)
    from indextts_tpu_torch.models.codec import repcodec as tr

    c = cfg.semantic_codec
    p = init_repcodec(InitRng(1), c)
    x = rng.standard_normal((1, 30, c.hidden_size)).astype(np.float32)
    codes, q = repcodec_quantize(p, c, jnp.asarray(x))
    tcodes, tq = tr.repcodec_quantize(to_torch(p), c, t(x))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))
    close(tq, q)
    close(tr.repcodec_vq2emb(to_torch(p), tcodes), repcodec_vq2emb(p, codes))


def test_campplus(rng):
    from indextts_tpu.models.s2mel.campplus import campplus_forward, init_campplus
    from indextts_tpu_torch.models.s2mel import campplus as tc

    p = init_campplus(InitRng(2))
    x = rng.standard_normal((1, 120, 80)).astype(np.float32)
    n = np.array([100])
    close(tc.campplus_forward(to_torch(p), t(x), t(n)),
          jax.jit(campplus_forward)(p, jnp.asarray(x), jnp.asarray(n)))


def test_length_regulator_and_gpt_layer(cfg, rng):
    from indextts_tpu.models.s2mel.length_regulator import length_regulate
    from indextts_tpu.models.s2mel.s2mel import gpt_layer_forward, init_s2mel
    from indextts_tpu_torch.models.s2mel import length_regulator as tl
    from indextts_tpu_torch.models.s2mel import s2mel as ts

    s2 = cfg.s2mel
    p = init_s2mel(InitRng(3), s2)
    tp = to_torch(p)
    feats = rng.standard_normal((2, 20, s2.length_regulator.in_channels)).astype(np.float32)
    clen, ylen = np.array([20, 13]), np.array([34, 22])
    ref = length_regulate(p["length_regulator"], s2.length_regulator,
                          jnp.zeros((2, 20), jnp.int32), jnp.asarray(clen),
                          jnp.asarray(ylen), out_size=40, features=jnp.asarray(feats))
    out = tl.length_regulate(tp["length_regulator"], s2.length_regulator, t(clen), t(ylen),
                             out_size=40, features=t(feats))
    close(out, ref)
    lat = rng.standard_normal((1, 7, s2.gpt_dim)).astype(np.float32)
    close(ts.gpt_layer_forward(tp, t(lat)), gpt_layer_forward(p, jnp.asarray(lat)))


@pytest.fixture(scope="module")
def uv_params(cfg):
    from indextts_tpu.models.gpt.unified_voice import init_unified_voice

    p = init_unified_voice(InitRng(4), cfg.gpt)
    return p, to_torch(p)


def test_conditioning_and_emovec(cfg, uv_params, rng):
    from indextts_tpu.models.gpt import unified_voice as juv
    from indextts_tpu_torch.models.gpt import unified_voice as tuv

    p, tp = uv_params
    spk = rng.standard_normal((1, 40, cfg.gpt.cond_input_dim)).astype(np.float32)
    emo = rng.standard_normal((1, 30, cfg.gpt.cond_input_dim)).astype(np.float32)
    sl, el = np.array([37]), np.array([30])
    jcond = jax.jit(lambda p, x, n: juv.get_conditioning(p, cfg.gpt, x, n))
    jemo = jax.jit(lambda p, a, b, n, m: juv.merge_emovec(p, cfg.gpt, a, b, n, m, 0.6))
    close(tuv.get_conditioning(tp, cfg.gpt, t(spk), t(sl)),
          jcond(p, jnp.asarray(spk), jnp.asarray(sl)))
    close(tuv.merge_emovec(tp, cfg.gpt, t(spk), t(emo), t(sl), t(el), 0.6),
          jemo(p, jnp.asarray(spk), jnp.asarray(emo), jnp.asarray(sl), jnp.asarray(el)))


def test_prefix_and_latents(cfg, uv_params, rng):
    from indextts_tpu.models.gpt import unified_voice as juv
    from indextts_tpu_torch.models.gpt import unified_voice as tuv

    p, tp = uv_params
    g = cfg.gpt
    D = g.model_dim
    cond = rng.standard_normal((2, g.condition_num_latent, D)).astype(np.float32)
    emo = rng.standard_normal((2, D)).astype(np.float32)
    text = rng.integers(2, g.number_text_tokens, (2, 16))
    tl = np.array([16, 9])
    conds = juv.build_conds_latent(p, jnp.asarray(cond), jnp.asarray(emo))
    tconds = tuv.build_conds_latent(tp, t(cond), t(emo))
    close(tconds, conds)
    prefix_len = g.condition_num_latent + 2 + 16 + 2
    e, m = juv.prepare_prefix_embeds(p, g, conds, jnp.asarray(text), jnp.asarray(tl), prefix_len)
    te, tm = tuv.prepare_prefix_embeds(tp, g, tconds, t(text), t(tl), prefix_len)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(m))
    close(te, e)
    codes = rng.integers(0, g.number_mel_codes - 2, (2, 12))
    ml = np.array([12, 7])
    ref = jax.jit(lambda p, *a: juv.forward_latents(p, g, *a))(
        p, jnp.asarray(cond), jnp.asarray(emo), jnp.asarray(text), jnp.asarray(tl),
        jnp.asarray(codes), jnp.asarray(ml))
    out = tuv.forward_latents(tp, g, t(cond), t(emo), t(text), t(tl), t(codes), t(ml))
    close(out, ref)
    close(tuv.mel_logits_from_hidden(tp, out), juv.mel_logits_from_hidden(p, ref))


def test_gpt2_prefill_and_decode_step(cfg, uv_params, rng):
    from indextts_tpu.models.gpt import gpt2 as jg
    from indextts_tpu_torch.models.gpt import gpt2 as tg

    p, tp = uv_params
    dims = jg.GPT2Dims(cfg.gpt.layers, cfg.gpt.model_dim, cfg.gpt.heads)
    tdims = tg.GPT2Dims(dims.layers, dims.dim, dims.heads)
    B, T, S = 2, 9, 16
    x = rng.standard_normal((B, T, dims.dim)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, :3] = False                                  # left padding
    close(tg.gpt2_forward(tp["gpt"], t(x), tdims, t(mask)),
          jg.gpt2_forward(p["gpt"], jnp.asarray(x), dims, jnp.asarray(mask)))
    kv = jg.init_kv_cache(dims, B, S, dtype=jnp.float32)
    h, kv = jg.gpt2_prefill(p["gpt"], jnp.asarray(x), dims, jnp.asarray(mask), kv)
    tkv = tg.init_kv_cache(tdims, B, S, dtype=torch.float32)
    th = tg.gpt2_prefill(tp["gpt"], t(x), tdims, t(mask), tkv)
    close(th[1, 3:], np.asarray(h)[1, 3:])
    close(th[0], np.asarray(h)[0])
    valid = np.zeros((B, S), bool)
    valid[:, :T] = mask
    valid[:, T] = True
    x1 = rng.standard_normal((B, dims.dim)).astype(np.float32)
    h1, _ = jg.gpt2_decode_step(p["gpt"], jnp.asarray(x1), dims, jnp.int32(T), kv,
                                jnp.asarray(valid))
    th1 = tg.gpt2_decode_step(tp["gpt"], t(x1), tdims, T, tkv, t(valid))
    close(th1, h1)


def test_beam_warped_scores_match_jax(cfg, rng):
    """Sampled beam decode cannot match across frameworks (different random
    streams); the scores the candidates are drawn from must."""
    from indextts_tpu.engine.beam import _min_new_mask
    from indextts_tpu.ops.sampling import (apply_repetition_penalty, apply_temperature,
                                           apply_top_k, apply_top_p)
    from indextts_tpu_torch.engine.beam import beam_step_scores
    from indextts_tpu_torch.engine.decode import SamplingConfig

    B, K, V = 2, 3, cfg.gpt.number_mel_codes
    stop = cfg.gpt.stop_mel_token
    logits = (3 * rng.standard_normal((B, K, V))).astype(np.float32)
    counts = (rng.random((B, K, V)) < 0.1).astype(np.int32)
    scores = np.array([[0.0, -1.5, -2.0], [0.0, -1e9, -1e9]], np.float32)
    s = SamplingConfig(min_new_tokens=2)
    for step in (0, 5):
        lf = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
        lf = apply_repetition_penalty(lf, jnp.asarray(counts), s.repetition_penalty)
        lf = _min_new_mask(lf, stop, jnp.int32(step), s.min_new_tokens)
        comb = lf + jnp.asarray(scores)[..., None]
        comb = apply_top_p(apply_top_k(apply_temperature(comb, s.temperature), s.top_k),
                           s.top_p)
        out = beam_step_scores(t(logits), t(counts), t(scores), step, stop, s)
        close(out, comb, atol=1e-4, rtol=1e-5)


def test_greedy_beam_token_equal(cfg, uv_params, rng):
    from indextts_tpu.engine.beam import generate_beam as jbeam
    from indextts_tpu.engine.decode import SamplingConfig as JS
    from indextts_tpu.models.gpt.gpt2 import GPT2Dims as JD
    from indextts_tpu_torch.engine.beam import generate_beam as tbeam
    from indextts_tpu_torch.engine.decode import SamplingConfig as TS
    from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims as TD

    p, tp = uv_params
    g = cfg.gpt
    pe = rng.standard_normal((2, 20, g.model_dim)).astype(np.float32)
    pm = np.ones((2, 20), bool)
    pm[1, :6] = False
    pe[1, :6] = 0
    kw = dict(do_sample=False, num_beams=3, min_new_tokens=3)
    codes, lens = jbeam(p, g, JD(g.layers, g.model_dim, g.heads), jnp.asarray(pe),
                        jnp.asarray(pm), jax.random.PRNGKey(0), max_new_tokens=10,
                        sampling=JS(**kw), dtype=jnp.float32)
    tcodes, tlens = tbeam(tp, g, TD(g.layers, g.model_dim, g.heads), t(pe), t(pm),
                          torch.Generator().manual_seed(0), 10, TS(**kw), torch.float32)
    np.testing.assert_array_equal(tlens, np.asarray(lens))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))


@pytest.mark.parametrize("seed,stop_bias,want_lens", [(2, -0.05, [16, 2]), (3, 0.0, [2, 10])])
def test_beam_scorer_rows_finishing_apart_token_equal(cfg, uv_params, seed, stop_bias,
                                                      want_lens):
    """The device-side scorer against JAX where hypotheses close early and
    the two rows finish at different steps (one row frozen while the other
    decodes, length penalty 1): a stop-logit bias picks such cases."""
    from indextts_tpu.engine.beam import generate_beam as jbeam
    from indextts_tpu.engine.decode import SamplingConfig as JS
    from indextts_tpu.models.gpt.gpt2 import GPT2Dims as JD
    from indextts_tpu_torch.engine.beam import generate_beam as tbeam
    from indextts_tpu_torch.engine.decode import SamplingConfig as TS
    from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims as TD

    g = cfg.gpt
    p = jax.tree_util.tree_map(np.array, uv_params[0])
    p["mel_head"]["bias"][g.stop_mel_token] += stop_bias
    rng = np.random.default_rng(seed)
    pe = rng.standard_normal((2, 20, g.model_dim)).astype(np.float32)
    pm = np.ones((2, 20), bool)
    pm[1, :6] = False
    pe[1, :6] = 0
    kw = dict(do_sample=False, num_beams=3, min_new_tokens=2, length_penalty=1.0)
    codes, lens = jbeam(p, g, JD(g.layers, g.model_dim, g.heads), jnp.asarray(pe),
                        jnp.asarray(pm), jax.random.PRNGKey(0), max_new_tokens=24,
                        sampling=JS(**kw), dtype=jnp.float32)
    tcodes, tlens = tbeam(to_torch(p), g, TD(g.layers, g.model_dim, g.heads), t(pe), t(pm),
                          torch.Generator().manual_seed(0), 24, TS(**kw), torch.float32)
    np.testing.assert_array_equal(np.asarray(lens), want_lens)
    np.testing.assert_array_equal(tlens, np.asarray(lens))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))


@pytest.fixture(scope="module")
def s2_params(cfg):
    from indextts_tpu.models.s2mel.s2mel import init_s2mel

    p = init_s2mel(InitRng(5), cfg.s2mel)
    return p, to_torch(p)


def _dit_inputs(cfg, rng, B=2, T=48):
    s2 = cfg.s2mel
    return dict(
        x=rng.standard_normal((B, T, 80)).astype(np.float32),
        prompt=rng.standard_normal((B, T, 80)).astype(np.float32),
        lens=np.array([T, 35]),
        style=rng.standard_normal((B, s2.style_encoder.dim)).astype(np.float32),
        cond=rng.standard_normal((B, T, s2.DiT.content_dim)).astype(np.float32))


def test_dit_forward(cfg, s2_params, rng):
    from indextts_tpu.models.s2mel.dit import dit_forward
    from indextts_tpu.ops.rope import precompute_freqs_cis
    from indextts_tpu_torch.models.s2mel import dit as td

    p, tp = s2_params
    s2 = cfg.s2mel
    a = _dit_inputs(cfg, rng)
    T = a["x"].shape[1]
    tt = np.array([0.25, 0.25], np.float32)
    fc = precompute_freqs_cis(T, s2.DiT.head_dim, s2.DiT.rope_base)
    ref = jax.jit(lambda p, *b: dit_forward(p, s2, *b[:-1], freqs_cis=b[-1]))(
        p["cfm"], *(jnp.asarray(a[k]) for k in ("x", "prompt", "lens")), jnp.asarray(tt),
        jnp.asarray(a["style"]), jnp.asarray(a["cond"]), jnp.asarray(fc))
    out = td.dit_forward(tp["cfm"], s2, t(a["x"]), t(a["prompt"]), t(a["lens"]), t(tt),
                         t(a["style"]), t(a["cond"]), t(fc))
    for b, L in enumerate(a["lens"]):
        close(out[b, :L], np.asarray(ref)[b, :L])


def test_cfm_inference_with_injected_noise(cfg, s2_params, rng):
    from indextts_tpu.models.s2mel.cfm import cfm_inference
    from indextts_tpu_torch.models.s2mel import cfm as tcfm

    p, tp = s2_params
    s2 = cfg.s2mel
    a = _dit_inputs(cfg, rng, B=1)
    T = a["x"].shape[1]
    plen = np.array([10])
    key = jax.random.PRNGKey(3)
    z = np.asarray(jax.random.normal(key, (1, T, 80), dtype=jnp.float32))
    ref = jax.jit(lambda p, *b: cfm_inference(p, s2, *b[:-1], n_timesteps=6,
                                              prompt_len=b[-1]))(
        p["cfm"], jnp.asarray(a["cond"]), jnp.asarray([40]), jnp.asarray(a["prompt"]),
        jnp.asarray(a["style"]), key, jnp.asarray(plen))
    out = tcfm.cfm_inference(tp["cfm"], s2, t(a["cond"]), t([40]), t(a["prompt"]),
                             t(a["style"]), n_timesteps=6, prompt_len=t(plen), z=t(z))
    close(out[:, :40], np.asarray(ref)[:, :40], atol=5e-4, rtol=2e-3)


def test_cfm_inference_bf16_pipeline_dtype(cfg, s2_params, rng):
    """The main path's dtypes: bf16 weights, cond, prompt mel and style with
    the f32 noise, as the pipelines pass them. JAX promotes the DiT stream
    to f32 and attends in f32; the port keeps the f32 stream and attends
    in bf16 (K2's input type). The gap is that rounding of q, k, v and the
    probabilities, carried through 25 Euler steps: rel-L2 <= 5e-5 over the
    generated rows (1.9e-6 measured on CPU; a DiT whose whole stream runs
    in bf16 measures 5.4e-4 here and fails)."""
    from indextts_tpu.models.s2mel.cfm import cfm_inference
    from indextts_tpu_torch.models.s2mel import cfm as tcfm

    s2 = cfg.s2mel
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), s2_params[0])
    a = _dit_inputs(cfg, rng, B=1, T=64)
    T, plen, L = 64, np.array([12]), 56
    key = jax.random.PRNGKey(4)
    z = np.asarray(jax.random.normal(key, (1, T, 80), dtype=jnp.float32))
    bf = {k: jnp.asarray(a[k], jnp.bfloat16) for k in ("cond", "prompt", "style")}
    ref = jax.jit(lambda p, *b: cfm_inference(p, s2, *b[:-1], n_timesteps=25,
                                              prompt_len=b[-1]))(
        p["cfm"], bf["cond"], jnp.asarray([L]), bf["prompt"], bf["style"], key,
        jnp.asarray(plen))
    tb = {k: t(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16) for k, v in bf.items()}
    out = tcfm.cfm_inference(to_torch(p["cfm"], dtype=torch.bfloat16), s2, tb["cond"],
                             t([L]), tb["prompt"], tb["style"], n_timesteps=25,
                             prompt_len=t(plen), z=t(z))
    assert out.dtype == torch.float32
    ref = np.asarray(ref)[0, 12:L]
    err = np.linalg.norm(out[0, 12:L].numpy() - ref) / np.linalg.norm(ref)
    assert err <= 5e-5, err


def test_bigvgan(cfg, rng):
    from indextts_tpu.models.vocoder.bigvgan import bigvgan_forward, init_bigvgan
    from indextts_tpu_torch.models.vocoder import bigvgan as tb

    p = init_bigvgan(InitRng(6), cfg.bigvgan)
    mel = rng.standard_normal((2, 12, 80)).astype(np.float32)
    lens = np.array([12, 9])
    ref = jax.jit(lambda p, m, n: bigvgan_forward(p, cfg.bigvgan, m, n))(
        p, jnp.asarray(mel), jnp.asarray(lens))
    out = tb.bigvgan_forward(to_torch(p), cfg.bigvgan, t(mel), t(lens))
    close(out, ref, atol=1e-4)
    assert tb.activation1d_calls(cfg.bigvgan) == 4 * 4 + 1
