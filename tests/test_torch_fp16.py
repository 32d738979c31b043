"""PyTorch port, the float16 IndexTTS2 pipeline (`IndexTTS2(use_fp16=True)`)
against the JAX package's at float16, on the CPU.

- the plain twins of K2 (`attention_rope`), K2' (`packed_pair_attention`)
  and K4 (`single_block_attention`) at fp16 against the JAX Pallas kernels
  in interpret mode at fp16: rel-L2 <= 5e-3 over valid query rows (the
  probabilities are rounded to fp16 on both sides, 2^-11 relative, and a
  value near a rounding boundary can go either way after f32 sums in
  another order); K2's rope pass bit-identical to the JAX rope at fp16;
- the DiT backbone at fp16 on its packed and flash tiers against the JAX
  DiT at fp16 (the dense `nn.mha` off the TPU): rel-L2 <= 1e-2 over valid
  rows (fp16 activations through two blocks);
- the constructor: ``use_fp16=True`` gives float16 everywhere but CAMPPlus
  (f32), as the JAX pipeline casts; with each quantization it builds, routes
  the decode to K1 ("fused", its fp16 twin here) and answers a 12-code
  request with a finite wav;
- the slice: greedy (do_sample=False) num_beams=3 codes token-equal with
  the JAX fp16 pipeline's; from those codes and the JAX side's CFM noise,
  the wav within rel-L2 2e-2 of JAX's fp16 wav, with the DiT on its packed
  tier and on its flash tier (INDEXTTS_PACKED_ATTN=0).

Where PyTorch's CPU lacks a Half kernel, nothing is upcast for it: every op
the slice reaches has one. Inputs come from seeded numpy generators; torch
runs one intra-op thread.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, "tests")

from test_pipeline_e2e import tiny_config  # noqa: E402
from test_torch_pipeline import TEXT, _jax_float_wav, model_dir  # noqa: E402,F401

from indextts_tpu_torch.ops import attn as tattn  # noqa: E402
from indextts_tpu_torch.utils.jax_params import to_torch  # noqa: E402

F16_ATTN_REL = 5e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f16(a) -> np.ndarray:
    return np.asarray(a, np.float32).astype(np.float16)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _rel_l2_valid(out, ref, lengths, time_axis):
    worst = 0.0
    for b, L in enumerate(lengths):
        o = np.take(np.asarray(out, np.float32)[b], np.arange(L), axis=time_axis - 1)
        r = np.take(np.asarray(ref, np.float32)[b], np.arange(L), axis=time_axis - 1)
        worst = max(worst, float(np.linalg.norm(o - r) / np.linalg.norm(r)))
    return worst


# ------------------------------------------------------- the kernels' twins

@pytest.mark.parametrize("D", [32, 64])
def test_k4_twin_at_fp16_matches_pallas(D):
    from indextts_tpu.ops.pallas.attn import single_block_attention

    rng = np.random.default_rng(D + 1)
    B, H, T = 2, 3, 256
    lens = np.array([256, 131], np.int32)
    q, k, v = (_f16(rng.standard_normal((B, H, T, D))) for _ in range(3))
    ref = single_block_attention(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(lens),
                                 interpret=True)
    out = tattn.single_block_attention(_t(q), _t(k), _t(v), _t(lens))
    assert ref.dtype == jnp.float16 and out.dtype == torch.float16
    assert _rel_l2_valid(out.float(), np.asarray(ref, np.float32), lens, 2) <= F16_ATTN_REL


def test_k2_prime_twin_at_fp16_matches_pallas():
    from indextts_tpu.ops.pallas.attn import packed_pair_attention

    rng = np.random.default_rng(17)
    B, H, D, T = 2, 4, 64, 384
    lens = np.array([384, 131], np.int32)
    q, k, v = (_f16(rng.standard_normal((B, T, H * D))) for _ in range(3))
    ref = packed_pair_attention(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(lens),
                                heads=H, interpret=True)
    out = tattn.packed_pair_attention(_t(q), _t(k), _t(v), _t(lens), H)
    assert ref.dtype == jnp.float16 and out.dtype == torch.float16
    assert _rel_l2_valid(out.float(), np.asarray(ref, np.float32), lens, 1) <= F16_ATTN_REL


def test_k2_twin_at_fp16_matches_pallas():
    from indextts_tpu.ops.pallas.attn import packed_pair_attention_rope
    from indextts_tpu.ops.rope import apply_rotary_emb_half, precompute_freqs_cis

    rng = np.random.default_rng(19)
    B, H, D, T = 2, 8, 64, 384
    lens = np.array([384, 203], np.int32)
    q, k, v = (_f16(rng.standard_normal((B, T, H * D))) for _ in range(3))
    fc = np.asarray(precompute_freqs_cis(T, D))
    ref = packed_pair_attention_rope(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(lens),
                                     jnp.asarray(fc), heads=H, interpret=True)
    out = tattn.attention_rope(_t(q), _t(k), _t(v), _t(lens), _t(fc), H)
    assert ref.dtype == jnp.float16 and out.dtype == torch.float16
    assert _rel_l2_valid(out.float(), np.asarray(ref, np.float32), lens, 1) <= F16_ATTN_REL
    qr, kr = tattn.rope_qk(_t(q), _t(k), _t(fc), H)
    for got, x in ((qr, q), (kr, k)):
        want = apply_rotary_emb_half(jnp.asarray(x).reshape(B, T, H, D), jnp.asarray(fc))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(B, T, H * D))


@pytest.mark.parametrize("tier,env", [("packed", {}), ("flash", {"INDEXTTS_PACKED_ATTN": "0"})])
def test_dit_backbone_at_fp16_matches_jax(monkeypatch, tier, env):
    from indextts_tpu.config import DiTConfig as JCfg
    from indextts_tpu.models.s2mel.dit import dit_backbone_forward as jforward
    from indextts_tpu.models.s2mel.dit import init_dit_backbone
    from indextts_tpu.nn import InitRng, cast_tree
    from indextts_tpu.ops.rope import precompute_freqs_cis
    from indextts_tpu_torch.config import DiTConfig as TCfg
    from indextts_tpu_torch.models.s2mel import dit as tdit

    for name in ("INDEXTTS_PACKED_ATTN", "INDEXTTS_FLASH_DIT"):
        monkeypatch.delenv(name, raising=False)
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    kw = dict(hidden_dim=128, num_heads=2, depth=2, content_dim=32)
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    p = cast_tree(init_dit_backbone(InitRng(5), jcfg), jnp.float16)
    rng = np.random.default_rng(5)
    B, T, D = 2, 48, jcfg.hidden_dim
    x, c = _f16(rng.standard_normal((B, T, D))), _f16(rng.standard_normal((B, 1, D)))
    lens = np.array([T, 29], np.int32)
    fc = np.asarray(precompute_freqs_cis(T, 64))
    mask = np.arange(T)[None, :] < lens[:, None]
    ref = jforward(p, jcfg, jnp.asarray(x), jnp.asarray(c), jnp.asarray(fc), jnp.asarray(mask),
                   jnp.asarray(lens))
    assert ref.dtype == jnp.float16
    assert tdit.attention_tier(tcfg, _t(lens)) == tier
    out = tdit.dit_backbone_forward(to_torch(jax.device_get(p), "cpu", torch.float16), tcfg,
                                    _t(x), _t(c), _t(fc), _t(lens), torch.float16)
    assert out.dtype == torch.float16
    assert _rel_l2_valid(out.float(), np.asarray(ref, np.float32), lens, 1) <= 1e-2


# ------------------------------------------------------- the pipeline

@pytest.fixture(scope="module")
def jax_tts16(model_dir):  # noqa: F811
    from indextts_tpu.pipeline.infer_v2 import IndexTTS2

    return IndexTTS2(cfg_path=None, model_dir=model_dir, cfg=tiny_config(), use_fp16=True)


@pytest.fixture(scope="module")
def torch_tts16(model_dir, jax_tts16):  # noqa: F811
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    tts = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cpu", cfg=tiny_config(),
                    use_fp16=True)
    j = jax_tts16
    tts.load_params(jax.device_get({
        "gpt": j.gpt_params, "s2mel": j.s2mel_params, "codec": j.codec_params,
        "campplus": j.campplus_params, "bigvgan": j.bigvgan_params, "w2v": j.w2v_params,
        "w2v_mean": j.w2v_mean, "w2v_std": j.w2v_std,
        "emo_matrix": np.concatenate(j.emo_matrix), "spk_matrix": np.concatenate(j.spk_matrix)}))
    return tts


def _dtypes(tree) -> set:
    if isinstance(tree, dict):
        return set().union(*(_dtypes(v) for v in tree.values()))
    if isinstance(tree, (list, tuple)):
        return set().union(*(_dtypes(v) for v in tree))
    return {tree.dtype} if isinstance(tree, torch.Tensor) else set()


def test_use_fp16_casts_every_tree_but_campplus(model_dir):  # noqa: F811
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    tts = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cpu", cfg=tiny_config(),
                    use_fp16=True, dtype=torch.float32)
    assert tts.dtype == torch.float16
    for name in ("gpt_params", "s2mel_params", "codec_params", "bigvgan_params", "w2v_params"):
        assert _dtypes(getattr(tts, name)) == {torch.float16}, name
    assert _dtypes(tts.campplus_params) == {torch.float32}


@pytest.mark.parametrize("quantization", ["int8", "int8kv", "int4", "int4kv"])
def test_use_fp16_with_a_quantization_raises(model_dir, quantization):  # noqa: F811
    """Once a refusal (K1 took bf16 only); now the fp16 pipeline with each
    quantization builds and decodes on K1 at fp16 (the twin on the CPU):
    the plain step is never called."""
    from indextts_tpu_torch.engine.decode import decode_route
    from indextts_tpu_torch.models.gpt.gpt2 import gpt2_decode_step
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    tts = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cpu", cfg=tiny_config(),
                    use_fp16=True, quantization=quantization)
    gpt = tts.gpt_params["gpt"]
    w = "q4" if quantization.startswith("int4") else "q"
    assert gpt["h"][0]["mlp"]["c_fc"][w].dtype == torch.int8
    assert gpt["h"][0]["mlp"]["c_fc"]["bias"].dtype == torch.float16
    assert decode_route(tts.gpt_params, 3, quantization.endswith("kv")) == "fused"
    calls = gpt2_decode_step.calls
    sr, wav = tts.infer(spk_audio_prompt=os.path.join(model_dir, "prompt.wav"), text=TEXT,
                        output_path=None, max_mel_tokens=12, min_new_tokens=11)
    assert tts.last_stage_times["codes"] == 12 and sr == 22050
    assert wav.shape == (int(np.float32(12) * np.float32(1.72)) * 256, 1)
    assert np.all(np.isfinite(wav))
    assert gpt2_decode_step.calls == calls


def test_fp16_slice_codes_token_equal_and_wav_matches_jax(  # noqa: F811
        jax_tts16, torch_tts16, model_dir, monkeypatch):
    from indextts_tpu_torch.engine.beam import generate_beam

    prompt = os.path.join(model_dir, "prompt.wav")
    j = jax_tts16
    j.capture = []
    j._rng = jax.random.PRNGKey(0)
    kw = dict(do_sample=False, num_beams=3, max_mel_tokens=16, min_new_tokens=4)
    j.infer(spk_audio_prompt=prompt, text=TEXT, output_path=None, **kw)
    c = j.capture.pop()
    j.capture = None
    clen = int(c["code_lens"][0])

    tts = torch_tts16
    spk = tts._prepare_spk_prompt(prompt)
    emo = tts._prepare_emo_cond(prompt)
    text_ids, tlen = c["text_ids"], int(c["text_lens"][0])
    cond_latents, emovec, embeds, mask = tts.prefix(spk, emo, 1.0, text_ids, tlen)
    assert embeds.dtype == torch.float16
    codes, lens = generate_beam(tts.gpt_params, tts.cfg.gpt, tts.gpt_dims, embeds, mask,
                                tts.generator, 16, tts._sampling(kw), torch.float16)
    assert int(lens[0]) == clen
    np.testing.assert_array_equal(codes.numpy()[0, :clen], c["codes"][0, :clen])

    T = c["prompt_bucket"] + c["mel_bucket"]
    z = np.asarray(jax.random.normal(c["rng"], (1, T, 80), dtype=jnp.float32))
    ref = _jax_float_wav(j, c)
    for env in (None, "0"):                 # the DiT's packed tier, then its flash tier
        if env is None:
            monkeypatch.delenv("INDEXTTS_PACKED_ATTN", raising=False)
        else:
            monkeypatch.setenv("INDEXTTS_PACKED_ATTN", env)
        wav = tts.codes_to_wav(spk, cond_latents, emovec, text_ids, tlen, codes, clen,
                               z=torch.as_tensor(z))
        assert wav.shape == ref.shape == (1, int(np.float32(clen) * np.float32(1.72)) * 256)
        assert np.all(np.isfinite(wav))
        rel = np.linalg.norm(wav - ref) / np.linalg.norm(ref)
        assert rel <= 2e-2, (env, rel)


def test_fp16_infer_end_to_end(torch_tts16, model_dir):  # noqa: F811
    sr, data = torch_tts16.infer(spk_audio_prompt=os.path.join(model_dir, "prompt.wav"),
                                 text=TEXT, output_path=None, max_mel_tokens=10)
    clen = torch_tts16.last_stage_times["codes"]
    assert sr == 22050 and data.dtype == np.int16
    assert data.shape == (int(np.float32(clen) * np.float32(1.72)) * 256, 1)
