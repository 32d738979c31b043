"""PyTorch port, the web UI (`python -m indextts_tpu_torch.webui`) and what it
imports (`utils/presets.py`, `utils/i18n.py` with its locale files,
`utils/examples_downloader.py`), against the JAX webui (the root `webui.py`)
on the same inputs, as `tests/test_presets_webui.py` holds the JAX one.

- the preset store: CRUD, `safe_preset_name`, and a preset saved by either
  package loading in the other (the same layout and names);
- `I18n` / `I18nAuto` in both languages equal to the JAX webui's, the
  locale files byte for byte the JAX package's;
- every gradio-free handler of both webuis with equal results on the same
  inputs;
- the example downloader without a network (every socket connection
  refused, no hub package importable): each file's fetch fails, is
  reported and skipped, nothing hangs, both packages alike;
- `main()` returns 3 with gradio blocked, before it loads anything.

gradio is on neither machine, so the Blocks layout is not built here.
"""

import filecmp
import os
import socket
import sys

import numpy as np
import pytest

sys.path.insert(0, os.getcwd())

import webui as jweb  # noqa: E402

from indextts_tpu.utils import presets as jpresets  # noqa: E402
from indextts_tpu.utils.wav_io import write_wav  # noqa: E402
from indextts_tpu_torch import webui as tweb  # noqa: E402
from indextts_tpu_torch.utils import presets as tpresets  # noqa: E402

ADV = dict(do_sample=True, top_p=0.75, top_k=25, temperature=0.9, length_penalty=0.0,
           num_beams=3, repetition_penalty=10.0, max_mel_tokens=800)


@pytest.fixture(autouse=True)
def preset_root(tmp_path):
    root = str(tmp_path / "presets")
    for mod in (jpresets, tpresets):
        mod.set_presets_root(root)
    yield root
    for mod in (jpresets, tpresets):
        mod.set_presets_root(None)


def test_port_preset_crud(tmp_path):
    wav = str(tmp_path / "v.wav")
    write_wav(wav, np.zeros(100, np.float32), 22050)
    tpresets.save_preset("My Voice!", {"emo_mode": 2, "emo_weight": 0.5,
                                       "emo_vec": [0.1] * 8}, prompt_audio=wav)
    assert tpresets.list_presets() == ["My_Voice!"]
    data = tpresets.load_preset("My Voice!")
    assert data["emo_mode"] == 2 and os.path.exists(data["prompt_audio"])
    assert data["emo_audio"] == ""
    assert tpresets.preset_exists("My Voice!")
    assert tpresets.delete_preset("My Voice!")
    assert tpresets.list_presets() == [] and tpresets.load_preset("My Voice!") is None


@pytest.mark.parametrize("name", ["  a/b\\c:d  ", "...", "ok name", "My Voice!", "声音 1"])
def test_safe_preset_name_equals_jax(name):
    assert tpresets.safe_preset_name(name) == jpresets.safe_preset_name(name)


@pytest.mark.parametrize("save,load", [(tpresets, jpresets), (jpresets, tpresets)],
                         ids=["port-to-jax", "jax-to-port"])
def test_a_preset_saved_by_one_package_loads_in_the_other(tmp_path, save, load):
    wav = str(tmp_path / "p.wav")
    write_wav(wav, np.zeros(200, np.float32), 22050)
    payload = tweb.preset_payload(2, 0.6, [0.2] * 8, "calm", False, ADV)
    save.save_preset("shared voice", payload, prompt_audio=wav, emo_audio=wav)
    assert load.list_presets() == save.list_presets() == ["shared_voice"]
    got, want = load.load_preset("shared voice"), save.load_preset("shared voice")
    assert got == want
    assert tweb.preset_to_ui(got) == jweb.preset_to_ui(want)
    assert load.delete_preset("shared voice") and save.list_presets() == []


def test_locale_files_are_the_jax_packages():
    import indextts_tpu
    import indextts_tpu_torch

    for lang in ("en_US", "zh_CN"):
        assert filecmp.cmp(os.path.join(os.path.dirname(indextts_tpu.__file__), "locale",
                                        f"{lang}.json"),
                           os.path.join(os.path.dirname(indextts_tpu_torch.__file__), "locale",
                                        f"{lang}.json"), shallow=False)


@pytest.mark.parametrize("lang", ["en", "zh", "en_US", "zh_CN", "xx_YY"])
def test_i18n_equals_jax(lang):
    from indextts_tpu.utils import i18n as ji18n
    from indextts_tpu_torch.utils import i18n as ti18n

    ours, theirs = tweb.I18n(lang), jweb.I18n(lang)
    assert (ours.zh, ours.map) == (theirs.zh, theirs.map)
    for zh, en in (*tweb.EMO_CHOICES_ALL, *tweb.EMO_VEC_LABELS, ("生成语音", "Generate"),
                   ("未翻译", "untranslated")):
        assert ours.t(zh, en) == theirs.t(zh, en)
    assert ti18n.scan_language_list() == ji18n.scan_language_list()
    full = {"en": "en_US", "zh": "zh_CN"}.get(lang, lang)
    a, b = ti18n.I18nAuto(full), ji18n.I18nAuto(full)
    assert (a.language, a.language_map, repr(a)) == (b.language, b.language_map, repr(b))


class _Tok:
    def tokenize(self, text):
        return text.split()

    def split_segments(self, toks, max_text_tokens_per_segment):
        n = int(max_text_tokens_per_segment)
        return [toks[i:i + n] for i in range(0, len(toks), n)]


class _Normalizer:
    def __init__(self):
        self.term_glossary = {}
        self.enable_glossary = False
        self.saved_to = None

    def save_glossary_to_yaml(self, path):
        self.saved_to = path


def _both(name, *args, **kwargs):
    return getattr(tweb, name)(*args, **kwargs), getattr(jweb, name)(*args, **kwargs)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("rand", [False, True])
def test_build_infer_kwargs_equals_jax(mode, rand):
    kw = dict(normalize_emo_vec=lambda v: [x * 2 for x in v]) if mode == 2 else {}
    ours, theirs = _both("build_infer_kwargs", mode, "emo.wav", 0.7, [0.1] * 8, "angry", rand,
                         200, 120, ADV, **kw)
    assert ours == theirs


def test_preset_handlers_equal_jax():
    for args in ((3, 0.6, [0.2] * 8, "joyful", True, ADV), (1, 0.8, [0.0] * 8, "", False, ADV)):
        ours, theirs = _both("preset_payload", *args)
        assert ours == theirs
        assert tweb.preset_to_ui(ours) == jweb.preset_to_ui(theirs)
    for legacy in ({"emo_mode": 2, "emo_vec": [0.3] * 8}, None, {}):
        assert tweb.preset_to_ui(legacy) == jweb.preset_to_ui(legacy)
    payload = tweb.preset_payload(3, 0.6, [0.2] * 8, "joyful", True, ADV)
    tpresets.save_preset("demo", payload)
    for lang in ("en", "zh"):
        ti, ji = tweb.I18n(lang), jweb.I18n(lang)
        for name in ("demo", "", "missing"):
            assert tweb.format_preset_details(name, ti) == jweb.format_preset_details(name, ji)
        for name in ("demo", "fresh"):
            assert tweb.format_preset_preview(name, payload, "v.wav", None, ti) \
                == jweb.format_preset_preview(name, payload, "v.wav", None, ji)
    ours, theirs = _both("refresh_preset_choices")
    assert ours == theirs and ours[0][0] == "" and "demo" in ours[0]


def test_mode_and_example_handlers_equal_jax():
    cases = [["p", 0, "a"], ["p", 3, "b"], ["p", 2, "c"]]
    for exp in (False, True):
        assert tweb.filter_example_cases(cases, exp) == jweb.filter_example_cases(cases, exp)
        for lang in ("en", "zh"):
            assert tweb.experimental_choices(exp, tweb.I18n(lang)) \
                == jweb.experimental_choices(exp, jweb.I18n(lang))
        for idx in (-1, 0, 2, 3, 4):
            assert tweb.clamp_mode_index(idx, exp) == jweb.clamp_mode_index(idx, exp)


def test_load_example_cases_equals_jax(tmp_path):
    ours, theirs = _both("load_example_cases", "examples/cases.jsonl")
    assert ours == theirs and len(ours) > 0
    p = tmp_path / "cases.jsonl"
    p.write_text('{"prompt_audio":"a.wav","text":"hi","emo_mode":2,"emo_vec_1":0.5}\n'
                 'not json\n\n', encoding="utf-8")
    ours, theirs = _both("load_example_cases", str(p))
    assert ours == theirs and len(ours) == 1
    assert _both("load_example_cases", str(tmp_path / "none.jsonl")) == ([], [])


def test_text_handlers_equal_jax():
    for text, n in (("a b c d e", 2), ("", 2), ("x y", 5)):
        ours, theirs = _both("preview_segments", _Tok(), text, n)
        assert ours == theirs
    assert _both("preview_segments", None, "x", 2) == ([], [])
    glossary = {"GPU": {"zh": "显卡", "en": "graphics"}, "TPU": "张量处理器"}
    for lang in ("en", "zh"):
        assert tweb.format_glossary_markdown(glossary, tweb.I18n(lang)) \
            == jweb.format_glossary_markdown(glossary, jweb.I18n(lang))
        assert tweb.format_glossary_markdown({}, tweb.I18n(lang)) \
            == jweb.format_glossary_markdown({}, jweb.I18n(lang))
    calls = (("", "zh", "", None), ("GPU", "", "", None),
             ("GPU ", "显卡 ", "graphics ", "g.yaml"), ("TPU", "张量处理器", "", None),
             ("XLA", "", "accelerated", None))
    nt, nj = _Normalizer(), _Normalizer()
    for term, zh, en, path in calls:
        ours = tweb.add_glossary_term(nt, term, zh, en, glossary_path=path, i18n=tweb.I18n("en"))
        theirs = jweb.add_glossary_term(nj, term, zh, en, glossary_path=path,
                                        i18n=jweb.I18n("en"))
        assert ours == theirs
        assert (nt.term_glossary, nt.enable_glossary, nt.saved_to) \
            == (nj.term_glossary, nj.enable_glossary, nj.saved_to)
    assert nt.term_glossary["GPU"] == {"zh": "显卡", "en": "graphics"}


@pytest.fixture
def offline(monkeypatch):
    """No network and no hub package: every socket connection is refused."""
    def refuse(*args, **kwargs):
        raise OSError("network access is refused in this test")

    monkeypatch.setattr(socket, "create_connection", refuse)
    for name in ("huggingface_hub", "modelscope", "modelscope.hub",
                 "modelscope.hub.file_download"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.parametrize("source", ["auto", "hf", "modelscope"])
def test_examples_downloader_fails_cleanly_offline(tmp_path, offline, capsys, source):
    from indextts_tpu.utils import examples_downloader as jdl
    from indextts_tpu_torch.utils import examples_downloader as tdl

    got = tdl.download_examples(str(tmp_path / "port"), source=source)
    out = capsys.readouterr().out
    want = jdl.download_examples(str(tmp_path / "jax"), source=source)
    assert got == want == []
    assert out.count("failed to fetch example") == len(tdl.EXAMPLE_FILES)
    assert tdl.EXAMPLE_FILES == jdl.EXAMPLE_FILES
    assert not tdl.examples_present(str(tmp_path / "port"))
    assert os.listdir(str(tmp_path / "port")) == []


def test_main_returns_3_without_gradio(monkeypatch, capsys):
    from indextts_tpu_torch.pipeline import infer_v2

    def never(*args, **kwargs):
        raise AssertionError("main loaded the pipeline without gradio")

    monkeypatch.setitem(sys.modules, "gradio", None)
    monkeypatch.setattr(infer_v2, "IndexTTS2", never)
    for argv in (["webui"], ["webui", "--fp16", "--model_dir", "nowhere", "--lang", "zh"]):
        monkeypatch.setattr(sys, "argv", argv)
        assert tweb.main() == 3
        assert "gradio is not installed" in capsys.readouterr().err
        assert jweb.main() == 3
