"""PyTorch port, the IndexTTS-1 / 1.5 family: every v1 module and the v1
pipeline against the JAX package, on the tiny v1 config of
`tests/test_pipeline_v1.py` (f32, CPU), with the JAX package's random
weights carried across by the weight bridge and inputs from seeded numpy
generators. Tolerance: atol 2e-4 / rtol 1e-3 (`tests/test_parity_gpt.py`)
unless a test states another.

- the 24 kHz v1 mel (and its htk filterbank); ECAPA at ragged lengths;
  BigVGAN v1 at ragged lengths through K3's plain twin (snakebeta, snake,
  and linear-scale snake parameters); the v2 BigVGAN at
  ``snake_logscale=False``; K3's twin at fp16 against the JAX activation at
  float16 (within 1 fp16 ulp);
- `get_conditioning_v1` for both condition types and `forward_latents_v1`;
- the five v1 converters on random state dicts written by inverting them
  (`tools/torch_reference_ckpt.py`): the port's trees equal the JAX
  package's and the tree they were written from;
- `remove_long_silence` and `bucket_segments` on seeded cases;
- the tiny pipeline, greedy (do_sample=False) at num_beams 1 and 3: codes
  token-equal and the int16 wav within rel-L2 1e-3, for `infer` and for
  `infer_fast` over two buckets;
- a tiny model directory in the reference layout loaded by both packages to
  the same trees; the `{'generator': ...}` wrapper the JAX loader drops;
- the port's CLI (a ``tts_factory``, the error codes, ``download``), and
  the constructor raising without CUDA when no device is named.
"""

import dataclasses
import os
import shutil
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
from test_pipeline_v1 import tiny_v1_config  # noqa: E402

from indextts_tpu.config import BigVGANV1Config  # noqa: E402
from indextts_tpu.nn import InitRng  # noqa: E402
from indextts_tpu.text.spm import build_model_file  # noqa: E402
from indextts_tpu.utils.wav_io import read_wav, write_wav  # noqa: E402
from indextts_tpu_torch.utils.jax_params import to_torch  # noqa: E402

ATOL, RTOL = 2e-4, 1e-3
TINY_BV1 = BigVGANV1Config(
    gpt_dim=16, num_mels=24, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
    upsample_initial_channel=16, resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3, 5),), speaker_embedding_dim=32, feat_upsample=True)
# five segments at 3 tokens a segment: two buckets, of 4 rows and 1
FIVE_SEGMENTS = "hello world . world hello . hello world . world hello . hello ."


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


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def randomized(tree, rng, positive_snake=False):
    """``tree`` with every BatchNorm statistic, snake parameter and
    zero-initialized conv kernel drawn at random (their inits are constants,
    which would hide a fault in the layer reading them)."""
    if isinstance(tree, list):
        return [randomized(v, rng, positive_snake) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out[k] = randomized(v, rng, positive_snake)
            continue
        a = np.asarray(v, np.float32)
        if k == "running_mean":
            a = rng.uniform(-0.1, 0.1, a.shape)
        elif k == "running_var":
            a = rng.uniform(0.5, 1.5, a.shape)
        elif k in ("alpha", "beta"):
            a = rng.uniform(0.2, 1.0, a.shape) if positive_snake else rng.uniform(-0.5, 0.5,
                                                                                 a.shape)
        elif k == "kernel" and not a.any():
            a = 0.05 * rng.standard_normal(a.shape)
        out[k] = np.asarray(a, np.float32)
    return out


def assert_same_tree(a, b, path="", exact=True):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in b:
            assert_same_tree(a[k], b[k], f"{path}.{k}", exact)
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{path}[{i}]", exact)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape, (path, x.shape, y.shape)
        if exact:
            assert np.array_equal(x, y), path
        else:
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7, err_msg=path)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_mel_24k_v1_matches_jax():
    from indextts_tpu.ops import mel as jmel
    from indextts_tpu_torch.ops import mel as tmel

    assert np.array_equal(tmel.mel_filterbank(24000, 1024, 100, scale="htk", norm=None),
                          jmel.mel_filterbank(24000, 1024, 100, scale="htk", norm=None))
    assert np.array_equal(tmel.mel_filterbank(22050, 1024, 80),
                          jmel.mel_filterbank(22050, 1024, 80))
    rng = np.random.default_rng(1)
    y = (0.1 * rng.standard_normal((2, 6000))).astype(np.float32)
    ref = np.asarray(jmel.mel_spectrogram_24k_v1(jnp.asarray(y)))
    out = tmel.mel_spectrogram_24k_v1(t(y))
    assert out.shape == ref.shape == (2, 100, 6000 // 256 + 1)
    close(out, ref)


def test_ecapa_ragged_matches_jax():
    from indextts_tpu.models.vocoder.ecapa import ecapa_forward, init_ecapa
    from indextts_tpu_torch.models.vocoder import ecapa as te

    rng = np.random.default_rng(2)
    p = randomized(init_ecapa(InitRng(1), 24, 32), rng)
    x = rng.standard_normal((2, 60, 24)).astype(np.float32)
    lens = np.array([60, 41])
    ref = jax.jit(ecapa_forward)(p, jnp.asarray(x), jnp.asarray(lens))
    out = te.ecapa_forward(to_torch(p), t(x), t(lens))
    assert out.shape == (2, 1, 32)
    close(out, ref)
    # the padded tail changes nothing: row 1 alone at its exact length
    alone = te.ecapa_forward(to_torch(p), t(x[1:, :41]))
    close(alone, out[1:], atol=1e-4)


@pytest.mark.parametrize("activation,logscale", [("snakebeta", True), ("snake", True),
                                                 ("snake", False)])
def test_bigvgan_v1_ragged_matches_jax(activation, logscale):
    from indextts_tpu.models.vocoder.bigvgan_v1 import bigvgan_v1_forward, init_bigvgan_v1
    from indextts_tpu_torch.models.vocoder import bigvgan_v1 as tb

    h = dataclasses.replace(TINY_BV1, activation=activation, snake_logscale=logscale)
    rng = np.random.default_rng(3)
    p = randomized(init_bigvgan_v1(InitRng(2), h), rng, positive_snake=not logscale)
    latent = rng.standard_normal((2, 10, 16)).astype(np.float32)
    mel = rng.standard_normal((2, 40, 24)).astype(np.float32)
    lens, mel_lens = np.array([10, 7]), np.array([40, 29])
    ref = jax.jit(lambda p, a, m, n, k: bigvgan_v1_forward(p, h, a, m, n, k))(
        p, jnp.asarray(latent), jnp.asarray(mel), jnp.asarray(lens), jnp.asarray(mel_lens))
    out = tb.bigvgan_v1_forward(to_torch(p), h, t(latent), t(mel), t(lens), t(mel_lens))
    assert out.shape == (2, 10 * h.total_upsample)
    close(out, ref)
    assert not out[1, 7 * h.total_upsample:].any()


def test_linear_upsample4_is_torch_interpolate():
    from indextts_tpu_torch.models.vocoder.bigvgan_v1 import _linear_upsample4

    x = torch.randn(2, 9, 5, generator=torch.Generator().manual_seed(0))
    want = torch.nn.functional.interpolate(x.transpose(1, 2), scale_factor=4, mode="linear",
                                           align_corners=False).transpose(1, 2)
    got = _linear_upsample4(x)
    assert got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_bigvgan_v2_linear_scale_snake_matches_jax():
    """The v2 vocoder with ``snake_logscale=False`` (it raised before): the
    parameters reach K3 as they are."""
    from indextts_tpu.models.vocoder.bigvgan import bigvgan_forward, init_bigvgan
    from indextts_tpu_torch.models.vocoder import bigvgan as tb

    h = dataclasses.replace(tiny_config().bigvgan, snake_logscale=False)
    rng = np.random.default_rng(4)
    p = randomized(init_bigvgan(InitRng(6), h), rng, positive_snake=True)
    mel = rng.standard_normal((2, 12, 80)).astype(np.float32)
    lens = np.array([12, 9])
    ref = jax.jit(lambda p, m, n: bigvgan_forward(p, h, m, n))(p, jnp.asarray(mel),
                                                               jnp.asarray(lens))
    out = tb.bigvgan_forward(to_torch(p), h, t(mel), t(lens))
    close(out, ref, atol=1e-4)
    h_log = dataclasses.replace(h, snake_logscale=True)
    assert rel_l2(tb.bigvgan_forward(to_torch(p), h_log, t(mel), t(lens)), out) > 1e-2


def fp16_ulps(out: np.ndarray, ref: np.ndarray) -> float:
    """Largest |out - ref| in fp16 ulps of |ref| (the ulp taken at no less
    than 1e-3 of ref's largest magnitude)."""
    o, r = out.astype(np.float64), ref.astype(np.float64)
    mag = np.maximum(np.abs(r), 1e-3 * np.abs(r).max())
    return float((np.abs(o - r) / 2.0 ** (np.floor(np.log2(mag)) - 10)).max())


@pytest.mark.parametrize("logscale", [True, False])
def test_k3_twin_fp16_matches_jax_float16(logscale):
    """K3's plain twin (what the kernel is held to on the card) at fp16
    against the JAX package's activation at float16 on the CPU: both
    compute in f32 and round once, so they agree within 1 fp16 ulp."""
    from indextts_tpu.ops.snake import antialias_activation
    from indextts_tpu_torch.ops.snake import antialias_snake, antialias_snake_plain

    rng = np.random.default_rng(5)
    x = (2 * rng.standard_normal((2, 96, 16))).astype(np.float16)
    lo, hi = (0.2, 1.0) if not logscale else (-0.5, 0.5)
    alpha, beta = (rng.uniform(lo, hi, 16).astype(np.float32) for _ in range(2))
    lens = np.array([96, 45])
    ref = np.asarray(antialias_activation(jnp.asarray(x), jnp.asarray(alpha),
                                          jnp.asarray(beta), jnp.asarray(lens), logscale))
    assert ref.dtype == np.float16
    out = antialias_snake_plain(t(x), t(alpha), t(beta), t(lens), logscale)
    assert out.dtype == torch.float16
    for b, n in enumerate(lens):
        assert fp16_ulps(out[b, :n].numpy(), ref[b, :n]) <= 1.0
    assert torch.equal(antialias_snake(t(x), t(alpha), t(beta), t(lens), logscale), out)


@pytest.fixture(scope="module")
def v1cfg():
    return tiny_v1_config()


@pytest.fixture(scope="module", params=["conformer_perceiver", "perceiver"])
def gpt_case(request, v1cfg):
    from indextts_tpu.models.gpt.unified_voice_v1 import init_unified_voice_v1

    g = dataclasses.replace(v1cfg.gpt, condition_type=request.param)
    p = randomized(init_unified_voice_v1(InitRng(3), g), np.random.default_rng(6))
    return g, p


def test_get_conditioning_v1_matches_jax(gpt_case):
    from indextts_tpu.models.gpt import unified_voice_v1 as juv1
    from indextts_tpu_torch.models.gpt import unified_voice_v1 as tuv1

    g, p = gpt_case
    rng = np.random.default_rng(7)
    mel = rng.standard_normal((2, 40, 100)).astype(np.float32)
    lens = np.array([40, 31])
    ref = jax.jit(lambda p, m, n: juv1.get_conditioning_v1(p, g, m, n))(
        p, jnp.asarray(mel), jnp.asarray(lens))
    out = tuv1.get_conditioning_v1(to_torch(p), g, t(mel), t(lens))
    assert out.shape == (2, g.condition_num_latent, g.model_dim)
    close(out, ref)


def test_forward_latents_v1_matches_jax(gpt_case):
    from indextts_tpu.models.gpt import unified_voice_v1 as juv1
    from indextts_tpu_torch.models.gpt import unified_voice_v1 as tuv1

    g, p = gpt_case
    rng = np.random.default_rng(8)
    cond = rng.standard_normal((2, g.condition_num_latent, g.model_dim)).astype(np.float32)
    text = rng.integers(0, g.number_text_tokens, (2, 8))
    codes = rng.integers(0, g.number_mel_codes - 2, (2, 12))
    tlens, clens = np.array([8, 5]), np.array([12, 7])
    ref = jax.jit(lambda p, *a: juv1.forward_latents_v1(p, g, *a))(
        p, jnp.asarray(cond), jnp.asarray(text), jnp.asarray(tlens), jnp.asarray(codes),
        jnp.asarray(clens))
    out = tuv1.forward_latents_v1(to_torch(p), g, t(cond), t(text), t(tlens), t(codes),
                                  t(clens))
    assert out.shape == (2, 12, g.model_dim)
    close(out, ref)


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------

def _np_sd(sd):
    return {k: v.detach().float().numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def v1_state_dicts(v1cfg):
    """Random v1 trees (JAX layouts) and the reference state dicts written
    from them by the tool's inverses: gpt of each condition type, BigVGAN
    v1 (with ECAPA)."""
    from indextts_tpu.models.gpt.unified_voice_v1 import init_unified_voice_v1
    from indextts_tpu.models.vocoder.bigvgan_v1 import init_bigvgan_v1

    rng = np.random.default_rng(9)
    out = {}
    for ct in ("conformer_perceiver", "perceiver"):
        g = dataclasses.replace(v1cfg.gpt, condition_type=ct)
        tree = randomized(init_unified_voice_v1(InitRng(4), g), rng)
        out[ct] = (g, tree, _np_sd(refckpt.unified_voice_v1_state_dict(tree, g)))
    tree = randomized(init_bigvgan_v1(InitRng(5), TINY_BV1), rng)
    out["bigvgan"] = (TINY_BV1, tree, _np_sd(refckpt.bigvgan_v1_state_dict(tree)))
    return out


@pytest.mark.parametrize("name", ["convert_attention_block", "convert_unified_voice_v1",
                                  "_convert_tdnn", "convert_ecapa", "convert_bigvgan_v1"])
def test_v1_converters_match_jax(name, v1_state_dicts):
    from indextts_tpu.utils import convert as jconv
    from indextts_tpu_torch.utils import convert as tconv

    g, gtree, gsd = v1_state_dicts["perceiver"]
    h, btree, bsd = v1_state_dicts["bigvgan"]
    cases = {
        "convert_attention_block": [((gsd, "conditioning_encoder.attn.2"),
                                     gtree["conditioning_encoder"]["attn"][2])],
        "convert_unified_voice_v1": [((sd, gc), tree) for gc, tree, sd in
                                     (v1_state_dicts[k] for k in ("conformer_perceiver",
                                                                  "perceiver"))],
        "_convert_tdnn": [((bsd, "speaker_encoder.blocks.2.tdnn1"),
                           btree["speaker_encoder"]["blocks"][1]["tdnn1"])],
        "convert_ecapa": [((bsd, "speaker_encoder."), btree["speaker_encoder"])],
        "convert_bigvgan_v1": [((bsd, h), btree)],
    }[name]
    for args, tree in cases:
        ours, theirs = getattr(tconv, name)(*args), getattr(jconv, name)(*args)
        assert_same_tree(ours, jax.device_get(theirs))
        # the converters invert the writer (weight-normed leaves within the
        # fold's rounding)
        assert_same_tree(ours, tree, exact=name not in ("convert_bigvgan_v1",))


def test_v1_trees_cross_the_weight_bridge(v1_state_dicts):
    """The bridge's existing rules carry the v1 trees: conv and conv-transpose
    kernels to torch's layouts, GroupNorm / BatchNorm leaves unchanged."""
    g, tree, _ = v1_state_dicts["perceiver"]
    pt = to_torch(tree)
    blk = pt["conditioning_encoder"]["attn"][0]
    assert blk["qkv"]["weight"].shape == (3 * g.model_dim, g.model_dim, 1)
    assert torch.equal(blk["norm"]["weight"],
                       t(tree["conditioning_encoder"]["attn"][0]["norm"]["weight"]))
    h, btree, _ = v1_state_dicts["bigvgan"]
    bt = to_torch(btree)
    k = btree["ups"][0]["kernel"]                                # (W, in, out), flipped
    assert bt["ups"][0]["weight"].shape == (k.shape[1], k.shape[2], k.shape[0])
    assert bt["conds"][1]["weight"].shape == (h.upsample_initial_channel // 4,
                                              h.speaker_embedding_dim, 1)
    bn = btree["speaker_encoder"]["asp_bn"]
    assert torch.equal(bt["speaker_encoder"]["asp_bn"]["running_var"], t(bn["running_var"]))


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

def test_remove_long_silence_matches_jax():
    from indextts_tpu.pipeline.infer_v1 import remove_long_silence as jrls
    from indextts_tpu_torch.pipeline.infer_v1 import remove_long_silence as trls

    rng = np.random.default_rng(10)
    for _ in range(20):
        B, n = int(rng.integers(1, 5)), int(rng.integers(1, 120))
        codes = np.where(rng.random((B, n)) < rng.uniform(0.1, 0.9), 52,
                         rng.integers(0, 60, (B, n))).astype(np.int64)
        lens = rng.integers(1, n + 1, B)
        (oc, ol), (jc, jl) = trls(codes, lens, 65), jrls(codes, lens, 65)
        assert np.array_equal(oc, jc) and np.array_equal(ol, jl) and ol.dtype == jl.dtype
    codes = np.full((1, 60), 52)
    codes[0, :5] = 7
    out, lens = trls(codes, np.array([60]), 65)
    assert lens[0] == 15 and (out[0, 5:15] == 52).all()


def test_bucket_segments_matches_jax():
    from indextts_tpu.pipeline.infer_v1 import IndexTTS as J
    from indextts_tpu_torch.pipeline.infer_v1 import IndexTTS as P

    rng = np.random.default_rng(11)
    for _ in range(30):
        segs = [["a"] * int(n) for n in rng.integers(1, 40, int(rng.integers(1, 14)))]
        size = int(rng.integers(1, 6))
        ours = P.bucket_segments(None, segs, bucket_max_size=size)
        theirs = J.bucket_segments(None, segs, bucket_max_size=size)
        assert [[i["idx"] for i in b] for b in ours] == [[i["idx"] for i in b] for b in theirs]


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_v1_port")
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    vocab = [w[:i] for w in ["▁HELLO", "▁WORLD", "▁."] for i in range(2, len(w) + 1)]
    seen, score = set(), -1.0
    for w in vocab + ["▁", "."]:
        if w not in seen:
            seen.add(w)
            pieces.append((w, score, 1))
            score -= 1.0
    build_model_file(pieces, str(d / "bpe.model"))
    sr = 24000
    tt = np.arange(sr) / sr
    wav = 0.3 * np.sin(2 * np.pi * 200 * tt) + 0.02 * np.random.default_rng(0).standard_normal(sr)
    write_wav(str(d / "prompt.wav"), wav.astype(np.float32), sr)
    return str(d)


@pytest.fixture(scope="module")
def jax_v1(model_dir, v1cfg):
    from indextts_tpu.pipeline.infer_v1 import IndexTTS

    return IndexTTS(cfg_path=None, model_dir=model_dir, cfg=v1cfg, use_fp16=False,
                    dtype=jnp.float32)


@pytest.fixture(scope="module")
def port_v1(model_dir, v1cfg, jax_v1):
    from indextts_tpu_torch.pipeline.infer_v1 import IndexTTS

    tts = IndexTTS(cfg_path=None, model_dir=model_dir, cfg=v1cfg, use_fp16=False,
                   dtype=torch.float32, device="cpu")
    tts.load_params(jax.device_get({"gpt": jax_v1.gpt_params,
                                    "bigvgan": jax_v1.bigvgan_params}))
    return tts


def _pinned(tts, min_new_tokens: int):
    """Pin the decode length the way the tests of the JAX package cannot
    ask `infer` to: the sampling config ``_sampling_from_kwargs`` builds,
    with ``min_new_tokens`` set, on this instance; records each decoded
    batch's codes."""
    orig = type(tts)._sampling_from_kwargs
    decode = type(tts)._decode_batch
    tts.decoded = []

    def sampling(kw):
        s, n = orig(tts, kw)
        return dataclasses.replace(s, min_new_tokens=min_new_tokens), n

    def record(*args):
        out = decode(tts, *args)
        tts.decoded.append((out[2], out[3]))
        return out

    tts._sampling_from_kwargs = sampling
    tts._decode_batch = record
    return tts


def _unpin(tts):
    for name in ("_sampling_from_kwargs", "_decode_batch", "decoded"):
        tts.__dict__.pop(name, None)


@pytest.mark.parametrize("fast,num_beams", [(False, 1), (False, 3), (True, 1), (True, 3)])
def test_greedy_request_matches_jax(jax_v1, port_v1, model_dir, fast, num_beams):
    kw = dict(audio_prompt=os.path.join(model_dir, "prompt.wav"), output_path=None,
              do_sample=False, num_beams=num_beams, max_mel_tokens=12)
    if fast:
        kw.update(text=FIVE_SEGMENTS, max_text_tokens_per_segment=3)
        segs = port_v1.tokenizer.split_segments(port_v1.tokenizer.tokenize(FIVE_SEGMENTS), 3)
        assert [len(b) for b in port_v1.bucket_segments(segs)] == [4, 1], segs
    else:
        kw.update(text="hello world .")
    outs = {}
    for name, tts in (("jax", jax_v1), ("port", port_v1)):
        _pinned(tts, 8)
        try:
            fn = tts.infer_fast if fast else tts.infer
            outs[name] = (fn(**kw), tts.decoded)
        finally:
            _unpin(tts)
    (sr_j, wav_j), dec_j = outs["jax"]
    (sr_p, wav_p), dec_p = outs["port"]
    assert sr_j == sr_p == 24000 and len(dec_j) == len(dec_p) == (2 if fast else 1)
    for (cj, lj), (cp, lp) in zip(dec_j, dec_p):
        assert np.array_equal(lj, lp) and (lp >= 8).all()
        for b, n in enumerate(lp):
            assert np.array_equal(cp[b, :n], cj[b, :n])
    assert wav_p.dtype == np.int16 and wav_p.shape == wav_j.shape
    up = port_v1.cfg.bigvgan.total_upsample
    assert wav_p.shape[0] == sum(int(lp.sum()) for _, lp in dec_p) * up
    assert rel_l2(wav_p, wav_j) <= 1e-3
    st = port_v1.last_stage_times
    assert st["codes"] * up == wav_p.shape[0] and st["total"] > 0
    assert set(st) >= {"prompt", "gpt", "gpt_forward", "bigvgan", "total", "rtf"}


def test_infer_writes_the_wav_and_caches_the_prompt(port_v1, model_dir, tmp_path):
    out = str(tmp_path / "v1.wav")
    prompt = os.path.join(model_dir, "prompt.wav")
    assert port_v1.infer(audio_prompt=prompt, text="hello world .", output_path=out,
                         max_mel_tokens=6, num_beams=1) == out
    cached = port_v1.cache_cond_mel
    wav, sr = read_wav(out)
    assert sr == 24000 and wav.shape[1] > 0
    port_v1.infer(audio_prompt=prompt, text="hello .", output_path=out, max_mel_tokens=6,
                  num_beams=1)
    assert port_v1.cache_cond_mel is cached
    sr, empty = port_v1.infer_fast(audio_prompt=prompt, text="", output_path=None)
    assert empty.shape == (0, 1)


def test_model_directory_loads_to_the_jax_trees(model_dir, v1cfg, tmp_path):
    """gpt.pth, bigvgan_generator.pth (raw, then under 'generator'),
    config.yaml and bpe.model in the reference layout: both packages load
    the same trees; the JAX loader drops the wrapper and fails."""
    from indextts_tpu.models.gpt.unified_voice_v1 import init_unified_voice_v1
    from indextts_tpu.models.vocoder.bigvgan_v1 import init_bigvgan_v1
    from indextts_tpu.pipeline.infer_v1 import IndexTTS as J
    from indextts_tpu_torch.pipeline.infer_v1 import IndexTTS as P

    rng = np.random.default_rng(12)
    trees = {"gpt": randomized(init_unified_voice_v1(InitRng(7), v1cfg.gpt), rng),
             "bigvgan": randomized(init_bigvgan_v1(InitRng(8), v1cfg.bigvgan), rng)}
    d = str(tmp_path / "ckpt")
    written = refckpt.write_model_dir_v1(d, trees, v1cfg)
    assert set(written) == {"config.yaml", "gpt.pth", "bigvgan_generator.pth"}
    shutil.copy(os.path.join(model_dir, "bpe.model"), d)
    cfg_path = os.path.join(d, "config.yaml")
    port = P(cfg_path=cfg_path, model_dir=d, use_fp16=False, dtype=torch.float32,
             device="cpu")
    ref = J(cfg_path=cfg_path, model_dir=d, use_fp16=False, dtype=jnp.float32)
    for part in ("gpt", "bigvgan"):
        want = dataclasses.asdict(getattr(v1cfg, part))
        assert dataclasses.asdict(getattr(port.cfg, part)) == want
        assert dataclasses.asdict(getattr(ref.cfg, part)) == want
    assert port.tokenizer is not None
    for attr in ("gpt_params", "bigvgan_params"):
        assert_same_tree(getattr(port, attr),
                         to_torch(jax.device_get(getattr(ref, attr)), "cpu", torch.float32),
                         attr)
    refckpt.write_model_dir_v1(d, {"bigvgan": trees["bigvgan"]}, v1cfg, wrapped=True)
    wrapped = P(cfg_path=cfg_path, model_dir=d, use_fp16=False, dtype=torch.float32,
                device="cpu")
    assert_same_tree(wrapped.bigvgan_params, port.bigvgan_params, "wrapped")
    # the JAX loader reads no key from {'generator': sd} (ROADMAP queue 3 item 5)
    from indextts_tpu.utils import convert as jconv

    assert jconv.load_torch_state_dict(os.path.join(d, v1cfg.bigvgan_checkpoint)) == {}
    with pytest.raises(KeyError):
        J(cfg_path=cfg_path, model_dir=d, use_fp16=False, dtype=jnp.float32)


def test_fp16_default_and_no_cuda_raises(model_dir, v1cfg, monkeypatch):
    from indextts_tpu_torch.pipeline.infer_v1 import IndexTTS

    tts = IndexTTS(cfg_path=None, model_dir=model_dir, cfg=v1cfg, device="cpu")
    assert tts.dtype == torch.float16
    assert tts.gpt_params["mel_head"]["weight"].dtype == torch.float16
    assert IndexTTS(cfg_path=None, model_dir=model_dir, cfg=v1cfg, device="cpu",
                    use_fp16=False).dtype == torch.bfloat16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        IndexTTS(cfg_path=None, model_dir=model_dir, cfg=v1cfg)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli(model_dir, tmp_path, monkeypatch, capsys):
    from indextts_tpu_torch import cli

    calls = {}

    class Fake:
        def __init__(self, **kw):
            calls.update(kw)

        def _write(self, output_path, fn):
            calls["fn"] = fn
            write_wav(output_path, np.zeros(100, np.float32), 24000)
            return output_path

        def infer(self, audio_prompt, text, output_path):
            return self._write(output_path, "infer")

        def infer_fast(self, audio_prompt, text, output_path):
            return self._write(output_path, "infer_fast")

    prompt = os.path.join(model_dir, "prompt.wav")
    out = str(tmp_path / "cli.wav")
    assert cli.main(["infer", "hello", "-v", prompt, "-o", out, "--model_dir", model_dir],
                    tts_factory=Fake) == 0
    assert os.path.exists(out) and calls["fn"] == "infer"
    assert calls == {"cfg_path": os.path.join(model_dir, "config.yaml"),
                     "model_dir": model_dir, "use_fp16": False, "device": None, "fn": "infer"}
    assert cli.main(["infer", "hello", "-v", prompt, "-o", out], tts_factory=Fake) == 1
    assert cli.main(["infer", "hello", "-v", prompt, "-o", out, "--force", "--fast",
                     "--fp16", "--device", "cpu", "--model_dir", model_dir],
                    tts_factory=Fake) == 0
    assert calls["fn"] == "infer_fast" and calls["use_fp16"] and calls["device"] == "cpu"
    assert cli.main(["infer", "hello", "-v", "missing.wav", "-o", out], tts_factory=Fake) == 1
    assert cli.main(["infer", "  ", "-v", prompt, "-o", out], tts_factory=Fake) == 1
    # no factory: the model directory must hold the four files
    assert cli.main(["infer", "hello", "-v", prompt, "-o", str(tmp_path / "x.wav"),
                     "--model_dir", model_dir]) == 1
    assert "missing model files" in capsys.readouterr().err
    assert cli.main(["download", "--model_dir", str(tmp_path / "dl")]) == 1
    assert "queue 1 item 8" in capsys.readouterr().err
    assert cli.main([]) == 1
    # the default device is the card: with the four files and no CUDA the
    # constructor raises rather than falling back to the CPU
    d = tmp_path / "files"
    d.mkdir()
    for name in cli.REQUIRED_FILES:
        (d / name).write_bytes(b"")
    shutil.copy(os.path.join(model_dir, "bpe.model"), d / "bpe.model")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["infer", "hello", "-v", prompt, "-o", str(tmp_path / "y.wav"),
                  "--model_dir", str(d)])
