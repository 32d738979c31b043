"""PyTorch port, the slice as a whole: the JAX `IndexTTS2` and the port's, on
the tiny pipeline config (f32, CPU) with the JAX pipeline's weights carried
across by the weight bridge and one prompt wav.

- greedy (do_sample=False) beam decode at num_beams=3 gives token-equal codes;
- from those codes, latents -> CFM -> BigVGAN give the same wav (rel-L2 <=
  1e-3) when the port is handed the CFM noise the JAX side draws from its key;
- the port's `infer` runs end to end, caches the prompt, writes the wav;
- the aux generation kwargs reach their engines (diverse beam, DoLa; the
  speculative decoder for sampling with penalty_alpha); emotion from text
  reaches the Qwen classifier (`tests/test_torch_emotion.py` holds it
  against the JAX pipeline); the port imports no jax. The aux engines
  are held against the JAX package in `tests/test_torch_modes.py`, the
  speculative decoder in `tests/test_torch_speculative.py`. Long-form,
  streaming and emo_vector requests are held against the JAX pipeline in
  `tests/test_torch_longform.py`.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, "tests")

from test_pipeline_e2e import tiny_config  # noqa: E402

from indextts_tpu.text.spm import build_model_file  # noqa: E402
from indextts_tpu.utils.wav_io import read_wav, write_wav  # noqa: E402

TEXT = "hello world ."


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes: one intra-op thread keeps this file from oversubscribing
    the cores the other test workers share; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_torch_model")
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    vocab = [w[:i] for w in ["▁HELLO", "▁WORLD", "▁THE", "▁CAT", "▁."]
             for i in range(2, len(w) + 1)] + ["▁", ".", "▁,", "E", "L", "O"]
    seen, score = set(), -1.0
    for w in vocab:
        if w not in seen:
            seen.add(w)
            pieces.append((w, score, 1))
            score -= 1.0
    build_model_file(pieces, str(d / "bpe.model"))
    sr = 16000
    tt = np.arange(int(0.8 * sr)) / sr
    wav = 0.3 * np.sin(2 * np.pi * 220 * tt) + 0.02 * np.random.default_rng(0).standard_normal(tt.size)
    write_wav(str(d / "prompt.wav"), wav.astype(np.float32), sr)
    return str(d)


@pytest.fixture(scope="module")
def jax_tts(model_dir):
    from indextts_tpu.pipeline.infer_v2 import IndexTTS2

    return IndexTTS2(cfg_path=None, model_dir=model_dir, cfg=tiny_config(),
                     dtype=jnp.float32)


@pytest.fixture(scope="module")
def torch_tts(model_dir, jax_tts):
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    tts = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cpu",
                    dtype=torch.float32, cfg=tiny_config())
    j = jax_tts
    tts.load_params(jax.device_get({
        "gpt": j.gpt_params, "s2mel": j.s2mel_params, "codec": j.codec_params,
        "campplus": j.campplus_params, "bigvgan": j.bigvgan_params, "w2v": j.w2v_params,
        "w2v_mean": j.w2v_mean, "w2v_std": j.w2v_std,
        "emo_matrix": np.concatenate(j.emo_matrix), "spk_matrix": np.concatenate(j.spk_matrix)}))
    return tts


def _jax_float_wav(j, c):
    """The JAX pipeline's float wav for one captured request (the calls
    `infer` makes after decode)."""
    spk = j.cache_spk
    s_infer = j._jit_latent(j.gpt_params, j.s2mel_params, j.codec_params,
                            c["cond_latents"], c["emovec"], jnp.asarray(c["text_ids"]),
                            jnp.asarray(c["text_lens"]), jnp.asarray(c["codes"]),
                            jnp.asarray(c["code_lens"]), code_bucket=c["code_bucket"])
    vc, tlen = j._jit_synth(j.s2mel_params, s_infer, jnp.asarray(c["code_lens"]),
                            spk["prompt_cond"], jnp.asarray([spk["ref_len"]]),
                            spk["ref_mel"], spk["style"], c["rng"],
                            mel_bucket=c["mel_bucket"], prompt_bucket=c["prompt_bucket"])
    n = int(np.float32(c["code_lens"][0]) * np.float32(1.72)) * 256
    return np.asarray(j._jit_vocoder(j.bigvgan_params, vc, tlen))[:, :n]


def test_greedy_beam_codes_token_equal_and_wav_matches(jax_tts, torch_tts, model_dir):
    prompt = os.path.join(model_dir, "prompt.wav")
    j = jax_tts
    j.capture = []
    j._rng = jax.random.PRNGKey(0)
    kw = dict(do_sample=False, num_beams=3, max_mel_tokens=16, min_new_tokens=4)
    j.infer(spk_audio_prompt=prompt, text=TEXT, output_path=None, **kw)
    c = j.capture.pop()
    j.capture = None
    clen = int(c["code_lens"][0])

    tts = torch_tts
    spk = tts._prepare_spk_prompt(prompt)
    emo = tts._prepare_emo_cond(prompt)
    text_ids, tlen = c["text_ids"], int(c["text_lens"][0])
    np.testing.assert_array_equal(
        text_ids[0, :tlen],
        tts.tokenizer.convert_tokens_to_ids(tts.tokenizer.tokenize(TEXT)))
    cond_latents, emovec, embeds, mask = tts.prefix(spk, emo, 1.0, text_ids, tlen)
    from indextts_tpu_torch.engine.beam import generate_beam

    codes, lens = generate_beam(tts.gpt_params, tts.cfg.gpt, tts.gpt_dims, embeds, mask,
                                tts.generator, 16, tts._sampling(kw), torch.float32)
    assert int(lens[0]) == clen
    np.testing.assert_array_equal(codes.numpy()[0, :clen], c["codes"][0, :clen])

    T = c["prompt_bucket"] + c["mel_bucket"]
    z = np.asarray(jax.random.normal(c["rng"], (1, T, 80), dtype=jnp.float32))
    wav = tts.codes_to_wav(spk, cond_latents, emovec, text_ids, tlen, codes, clen,
                           z=torch.as_tensor(z))
    ref = _jax_float_wav(j, c)
    assert wav.shape == ref.shape == (1, int(np.float32(clen) * np.float32(1.72)) * 256)
    rel = np.linalg.norm(wav - ref) / np.linalg.norm(ref)
    assert rel <= 1e-3, rel


def test_port_infer_end_to_end(torch_tts, model_dir, tmp_path):
    prompt = os.path.join(model_dir, "prompt.wav")
    out = str(tmp_path / "gen.wav")
    assert torch_tts.infer(spk_audio_prompt=prompt, text=TEXT, output_path=out,
                           max_mel_tokens=10) == out
    first = torch_tts.cache_spk
    wav, sr = read_wav(out)
    clen = torch_tts.last_stage_times["codes"]
    assert sr == 22050 and wav.shape[1] == int(np.float32(clen) * np.float32(1.72)) * 256
    sr, data = torch_tts.infer(spk_audio_prompt=prompt, text="the cat .", output_path=None,
                               max_mel_tokens=10)
    assert torch_tts.cache_spk is first          # prompt cache reused
    assert sr == 22050 and data.dtype == np.int16 and data.shape[1] == 1
    assert np.all(np.isfinite(data))


@pytest.mark.parametrize("kwargs,what", [
    # sampling with penalty_alpha is not contrastive search (HF's mode rule):
    # the one-row speculative decoder
    ({"num_beams": 1, "penalty_alpha": 0.6}, "generate_spec_adaptive"),
    ({"use_emo_text": True}, "Qwen"),
    ({"num_beams": 4, "num_beam_groups": 2, "do_sample": False}, "generate_group_beam"),
    ({"num_beams": 1, "dola_layers": "low"}, "generate_dola"),
])
def test_aux_kwargs_take_their_engines_and_emotion_text_raises(torch_tts, model_dir,
                                                               monkeypatch, kwargs, what):
    """The aux generation kwargs run the engine the JAX pipeline picks for
    them; emotion from text runs the Qwen classifier (`QwenEmotion.
    inference`, once a request; here on the keyword fallback: the model
    directory has no Qwen folder). It raised NotImplementedError until the
    classifier was ported; `tests/test_torch_emotion.py` holds it against
    the JAX pipeline."""
    from indextts_tpu_torch.pipeline import infer_v2

    kw = dict(spk_audio_prompt=os.path.join(model_dir, "prompt.wav"), text=TEXT,
              output_path=None, max_mel_tokens=4)
    kw.update(kwargs)
    ran = []
    target = torch_tts.qwen_emo if what == "Qwen" else infer_v2
    name = "inference" if what == "Qwen" else what
    real = getattr(target, name)
    monkeypatch.setattr(target, name, lambda *a, **k: ran.append(1) or real(*a, **k))
    sr, data = torch_tts.infer(**kw)
    clen = torch_tts.last_stage_times["codes"]
    assert ran == [1] and sr == 22050
    assert data.shape == (int(np.float32(clen) * np.float32(1.72)) * 256, 1)


@pytest.mark.parametrize("kwargs,what", [({"quantization": "int3"}, "K1"),
                                         ({"mesh": 2}, "mesh")])
def test_unported_constructor_options_raise(model_dir, kwargs, what):
    """An unknown quantization name is refused (ValueError: K1 has no such
    format); an unported option raises NotImplementedError."""
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    exc = ValueError if "quantization" in kwargs else NotImplementedError
    with pytest.raises(exc, match=what):
        IndexTTS2(cfg_path=None, model_dir=model_dir, device="cpu", cfg=tiny_config(),
                  **kwargs)


def test_cuda_device_requires_cuda(model_dir):
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IndexTTS2(cfg_path=None, model_dir=model_dir, device="cuda", cfg=tiny_config())


def test_default_device_is_the_card(model_dir):
    """With no ``device`` the pipeline takes the card: without one it raises,
    it does not fall back to the CPU."""
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IndexTTS2(cfg_path=None, model_dir=model_dir, cfg=tiny_config())


def test_port_imports_no_jax():
    code = ("import sys, importlib, pkgutil\n"
            "sys.modules['jax'] = None\n"
            "import indextts_tpu_torch\n"
            "for m in pkgutil.walk_packages(indextts_tpu_torch.__path__, 'indextts_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules\n"
            "               if sys.modules[k] is not None)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr
