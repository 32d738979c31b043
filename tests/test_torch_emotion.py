"""Emotion from text: the port's `QwenEmotion` (`indextts_tpu_torch/
pipeline/emotion.py`) and ``IndexTTS2.infer(use_emo_text=True)`` against
the JAX package's.

- keyword fallback (no Qwen directory): the same dicts and the same
  printed lines on texts that hit each lexicon entry, the melancholic/sad
  swap and the calm default;
- a tiny Qwen directory (config.json, an f32 model.safetensors, the
  synthetic tokenizer.json, and a tokenizer_config.json whose small Jinja
  chat template renders the Qwen3 string for the JAX side's
  `AutoTokenizer`): the same prompt ids, the same greedy tokens and the
  same dict, both sides at f32;
- `_model_inference`'s parse on stubbed generations (JSON, the regex
  fallback, a `</think>` prefix, nothing found) with the full-width
  tokenizer: the same dicts;
- a present but broken directory: the JAX package falls back to the
  keywords, the port raises (and raises again on the next call);
- the tiny pipeline of `tests/test_torch_pipeline.py` on both sides with
  ``use_emo_text=True``: without a Qwen folder (a keyword text) and with
  the tiny one (``emo_text`` given, and None taking ``text``): the same
  emovec, token-equal greedy codes and the int16 wav within rel-L2 1e-3
  given the JAX pipeline's CFM noise.
"""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, "tests")

from test_torch_longform import _jax_noise, _jax_request, _port_request  # noqa: E402
from test_torch_pipeline import _one_torch_thread, jax_tts, model_dir, torch_tts  # noqa: E402,F401

from indextts_tpu.models import qwen as jq  # noqa: E402
from indextts_tpu.pipeline import emotion as je  # noqa: E402
from indextts_tpu_torch.pipeline import emotion as te  # noqa: E402
from indextts_tpu_torch.text import qwen_tokenizer as qt  # noqa: E402

CORPUS = ('{"高兴": 0.5, "愤怒": 0.0, "悲伤": 0.1, "恐惧": 0.0, "反感": 0.0, "低落": 0.0, '
          '"惊讶": 0.2, "自然": 0.3}\n文本情感分类 今天我很开心，可是他很难过。 I am so happy today! '
          ) * 4
TINY_VOCAB, TINY_FIRST_ADDED = 400, 360
CHAT_TEMPLATE = (
    "{%- for m in messages %}{{ '<|im_start|>' + m['role'] + '\\n' + m['content'] + "
    "'<|im_end|>\\n' }}{%- endfor %}{%- if add_generation_prompt %}"
    "{{ '<|im_start|>assistant\\n' }}{%- if enable_thinking is defined and "
    "enable_thinking is false %}{{ '<think>\\n\\n</think>\\n\\n' }}{%- endif %}{%- endif %}")

KEYWORD_TEXTS = ["今天真开心，好快乐", "He was furious and mad with rage", "我很难过，一直在哭 tears",
                 "I am scared, terrified", "恶心又反感", "so gloomy, melancholic and depressed",
                 "wow, I am shocked!", "nothing to see here", "sad but glad, a joy"]


def _write_tokenizer(d, vocab, first_added):
    tj = qt.build_tokenizer_json(CORPUS, vocab, first_added_id=first_added)
    (d / "tokenizer.json").write_text(json.dumps(tj, ensure_ascii=False), encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "Qwen2Tokenizer", "chat_template": CHAT_TEMPLATE,
        "clean_up_tokenization_spaces": False, "model_max_length": 32768,
        "eos_token": "<|im_end|>", "pad_token": "<|endoftext|>", "bos_token": None,
        "unk_token": None}), encoding="utf-8")


def _tiny_qwen_dir(d):
    """config.json, model.safetensors (f32, HF Qwen3 keys, seed 0, std 0.3
    so that greedy picks are not near-ties) and the tokenizer files."""
    from safetensors.numpy import save_file

    D, H, KV, Dh, I, L, V = 32, 4, 2, 8, 64, 2, TINY_VOCAB
    cfg = {"architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3", "vocab_size": V,
           "hidden_size": D, "num_hidden_layers": L, "num_attention_heads": H,
           "num_key_value_heads": KV, "head_dim": Dh, "intermediate_size": I,
           "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "tie_word_embeddings": True,
           "eos_token_id": TINY_FIRST_ADDED + 2, "torch_dtype": "float32"}
    (d / "config.json").write_text(json.dumps(cfg), encoding="utf-8")
    g = np.random.default_rng(0)
    shapes = {"self_attn.q_proj": (H * Dh, D), "self_attn.k_proj": (KV * Dh, D),
              "self_attn.v_proj": (KV * Dh, D), "self_attn.o_proj": (D, H * Dh),
              "mlp.gate_proj": (I, D), "mlp.up_proj": (I, D), "mlp.down_proj": (D, I)}
    sd = {"model.embed_tokens.weight": g.normal(0, 0.3, (V, D)),
          "model.norm.weight": np.ones(D)}
    for i in range(L):
        for k, s in shapes.items():
            sd[f"model.layers.{i}.{k}.weight"] = g.normal(0, 0.3, s)
        for k, n in (("input_layernorm", D), ("post_attention_layernorm", D),
                     ("self_attn.q_norm", Dh), ("self_attn.k_norm", Dh)):
            sd[f"model.layers.{i}.{k}.weight"] = 1 + 0.1 * g.normal(size=n)
    save_file({k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()},
              str(d / "model.safetensors"))
    _write_tokenizer(d, TINY_VOCAB, TINY_FIRST_ADDED)
    return d


@pytest.fixture(scope="module")
def qwen_dir(tmp_path_factory):
    return _tiny_qwen_dir(tmp_path_factory.mktemp("qwen_emo"))


def _jax_f32(monkeypatch):
    """The JAX classifier's decode at f32 (its call passes no dtype: bf16)."""
    real = jq.qwen_generate_greedy
    monkeypatch.setattr(jq, "qwen_generate_greedy",
                        lambda *a, **k: real(*a, **{**k, "dtype": jnp.float32}))


def _run(qe, text):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = qe.inference(text)
    return out, buf.getvalue()


@pytest.mark.parametrize("text", KEYWORD_TEXTS, ids=[f"text{i}" for i in range(len(KEYWORD_TEXTS))])
def test_keyword_fallback_matches_jax(tmp_path, text):
    missing = str(tmp_path / "qwen0.6bemo4-merge")
    j, t = _run(je.QwenEmotion(missing), text), _run(te.QwenEmotion(missing, "cpu"), text)
    assert list(t[0]) == te.EMOTION_KEYS
    assert t == j


def test_tiny_qwen_directory_matches_jax(qwen_dir, monkeypatch):
    """Both loaders read the directory; the prompt ids, the greedy tokens
    (recorded on both sides) and the dicts are equal."""
    _jax_f32(monkeypatch)
    seen = {"jax": [], "port": []}
    real_j, real_t = jq.qwen_generate_greedy, te.qwen_generate_greedy

    def rec_j(*a, **k):
        out = real_j(*a, **k)
        seen["jax"].append((np.asarray(a[2]), np.asarray(out[0]), np.asarray(out[1])))
        return out

    def rec_t(*a, **k):
        out = real_t(*a, **k)
        seen["port"].append((a[2].numpy(), out[0].numpy(), out[1].numpy()))
        return out

    monkeypatch.setattr(jq, "qwen_generate_greedy", rec_j)
    monkeypatch.setattr(te, "qwen_generate_greedy", rec_t)
    jqe = je.QwenEmotion(str(qwen_dir))
    tqe = te.QwenEmotion(str(qwen_dir), "cpu", torch.float32)
    for text in ("今天我很开心", "so gloomy today", "I am so happy today!"):
        assert _run(tqe, text) == _run(jqe, text), text
    assert jqe.model is not None and tqe.model is not None
    assert len(seen["jax"]) == len(seen["port"]) == 3
    for (jids, jtok, jlen), (tids, ttok, tlen) in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_array_equal(tlen, jlen)
        np.testing.assert_array_equal(ttok[0, :tlen[0]], jtok[0, :jlen[0]])


@pytest.fixture(scope="module")
def full_tokenizers(tmp_path_factory):
    """The full-width synthetic tokenizer (ids [0, 151936), the Qwen3 added
    tokens at their published ids), loaded by transformers and the port."""
    from transformers import AutoTokenizer

    d = tmp_path_factory.mktemp("qwen_full_tok")
    _write_tokenizer(d, 151936, qt.QWEN3_FIRST_ADDED_ID)
    return AutoTokenizer.from_pretrained(str(d)), qt.load_qwen_tokenizer(str(d))


GENERATIONS = ['{"高兴": 0.7, "悲伤": 0.1}',
               '高兴: 0.9, 愤怒:0.2 and "恐惧" : 1.5 junk',
               '<think>\n嗯，想一想\n</think>\n\n{"惊讶": 0.4, "自然": 2.0}',
               'no scores at all',
               '{"悲伤": 0.3, "低落": 0.05}']


@pytest.mark.parametrize("gen", GENERATIONS, ids=["json", "regex", "think", "none", "swap"])
def test_model_inference_parse_matches_jax(full_tokenizers, monkeypatch, gen):
    """The generation stubbed as the ids of ``gen`` then eos: the same
    prompt ids, the same parsed and converted dicts (the last with a
    melancholic word in the input: the swap)."""
    hf, me = full_tokenizers
    text = "so gloomy today" if "低落" in gen else "今天我很开心"
    toks = me.encode(gen) + [151645] * 3
    n = len(toks) - 2
    assert hf(gen).input_ids == toks[:n - 1]
    prompts = {}

    def stub_j(p, c, ids, mask, max_new_tokens, dtype=None):
        prompts["jax"] = np.asarray(ids)
        return jnp.asarray([toks], jnp.int32), jnp.asarray([n], jnp.int32)

    def stub_t(p, c, ids, mask, max_new_tokens, dtype=None):
        prompts["port"] = ids.numpy()
        assert max_new_tokens == 256
        return torch.tensor([toks]), torch.tensor([n])

    monkeypatch.setattr(jq, "qwen_generate_greedy", stub_j)
    monkeypatch.setattr(te, "qwen_generate_greedy", stub_t)
    jqe, tqe = je.QwenEmotion("unused"), te.QwenEmotion("unused", "cpu")
    for qe, tok in ((jqe, hf), (tqe, me)):
        qe._tried_load, qe.tokenizer, qe.model = True, tok, object()
        qe.qwen_cfg = jq.QwenConfig()
    out_t, out_j = _run(tqe, text), _run(jqe, text)
    assert out_t == out_j
    np.testing.assert_array_equal(prompts["port"], prompts["jax"])
    if gen.startswith("<think>"):
        assert out_t[0]["surprised"] == 0.4 and out_t[0]["calm"] == 1.2


@pytest.mark.parametrize("broken", ["no checkpoint", "bad safetensors"])
def test_broken_directory_jax_falls_back_port_raises(qwen_dir, tmp_path, broken):
    """The JAX loader's fault, not copied: a present directory that does not
    load gives the JAX package's keyword scores (with its printed note) and
    raises in the port, on every call."""
    d = tmp_path / "qwen0.6bemo4-merge"
    d.mkdir()
    for f in ("config.json", "tokenizer.json", "tokenizer_config.json"):
        (d / f).write_bytes((qwen_dir / f).read_bytes())
    if broken == "bad safetensors":
        (d / "model.safetensors").write_bytes(b"\x10\x00\x00\x00\x00\x00\x00\x00{not json}")
    text = "今天真开心"
    out, printed = _run(je.QwenEmotion(str(d)), text)
    assert out == _run(je.QwenEmotion(str(tmp_path / "absent")), text)[0]
    assert "QwenEmotion unavailable" in printed and out["happy"] == 0.6
    tqe = te.QwenEmotion(str(d), "cpu")
    for _ in range(2):
        with pytest.raises((FileNotFoundError, ValueError)):
            tqe.inference(text)
    assert tqe.model is None


def _emo_text_request(jax_tts, torch_tts, model_dir, **kw):
    """One greedy use_emo_text request on both pipelines (the port given the
    JAX CFM noise): returns (JAX result, its capture, port result, its
    codes_to_wav calls)."""
    kw = dict(spk_audio_prompt=os.path.join(model_dir, "prompt.wav"), text="hello world .",
              output_path=None, use_emo_text=True, emo_alpha=0.8, num_beams=2,
              do_sample=False, max_mel_tokens=8, min_new_tokens=3, **kw)
    out_j, cap = _jax_request(jax_tts, 0, **kw)
    assert len(cap) == 1
    out_t, calls = _port_request(torch_tts, noise=lambda shape: _jax_noise(cap[0]["rng"], shape),
                                 **kw)
    return out_j, cap[0], out_t, calls


def _assert_request_matches(out_j, c, out_t, calls):
    (_, _, emovec, _, _, codes, clen), = calls
    np.testing.assert_allclose(emovec.float().numpy(), c["emovec"], atol=2e-4, rtol=1e-3)
    n = int(c["code_lens"][0])
    assert clen == max(n, 1)
    np.testing.assert_array_equal(codes.numpy()[0, :n], c["codes"][0, :n])
    (sr_j, wav_j), (sr_t, wav_t) = out_j, out_t
    assert sr_j == sr_t == 22050 and wav_t.shape == wav_j.shape
    a, b = wav_t.astype(np.float64), wav_j.astype(np.float64)
    rel = np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel <= 1e-3, rel


def test_emo_text_request_without_qwen_folder_matches_jax(jax_tts, torch_tts, model_dir):
    """No Qwen folder under the model directory: both take the keyword
    vector of the emotion text."""
    assert not os.path.exists(os.path.join(model_dir, "qwen0.6bemo4-merge"))
    _assert_request_matches(*_emo_text_request(jax_tts, torch_tts, model_dir,
                                               emo_text="我很难过 and so sad"))


@pytest.mark.parametrize("emo_text", ["今天我很开心", None], ids=["emo_text", "text"])
def test_emo_text_request_with_tiny_qwen_matches_jax(jax_tts, torch_tts, model_dir, qwen_dir,
                                                     monkeypatch, emo_text):
    """The tiny Qwen folder on both sides (f32); ``emo_text=None`` sends
    ``text`` to the classifier."""
    _jax_f32(monkeypatch)
    sent = []
    jqe = je.QwenEmotion(str(qwen_dir))
    tqe = te.QwenEmotion(str(qwen_dir), "cpu", torch.float32)
    real = tqe.inference
    monkeypatch.setattr(tqe, "inference", lambda t: sent.append(t) or real(t))
    monkeypatch.setattr(jax_tts, "qwen_emo", jqe)
    monkeypatch.setattr(torch_tts, "qwen_emo", tqe)
    _assert_request_matches(*_emo_text_request(jax_tts, torch_tts, model_dir,
                                               emo_text=emo_text))
    assert sent == [emo_text or "hello world ."] and tqe.model is not None
