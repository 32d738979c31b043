"""The port stands alone.

- Importing every module of `indextts_tpu_torch` (the tensor-parallel
  `parallel/mesh.py` and `ops/decode_step_tp.py`, the IndexTTS-1
  family's `pipeline/infer_v1.py`, `cli.py`, `unified_voice_v1.py`,
  `bigvgan_v1.py` and `ecapa.py`, and the emotion-text path's
  `models/qwen.py`, `text/qwen_tokenizer.py`, `pipeline/emotion.py`,
  `cli_v2.py` and `utils/download.py` among them),
  `chip_smoke.py` and `tools/torch_reference_ckpt.py` as modules, loads
  neither jax nor any module of the JAX package (`indextts_tpu`), nor
  transformers, tokenizers, regex, jinja2, yaml or safetensors (none of
  which the card's machine has): the port keeps its own copies of the host
  modules it needs (config, text front end, buckets, resampling, wav I/O,
  the checkpoint converters, the CLI, the Qwen tokenizer).
- With those packages blocked, the port's `QwenEmotion` loads a tiny Qwen
  directory (config.json, model.safetensors, tokenizer.json) and gives its
  dict (`tests/test_torch_emotion.py` holds that dict against the JAX
  package's).
- With ``yaml`` and ``safetensors`` blocked (as on the card's machine, which
  has neither), the port builds `IndexTTS2` from a tiny model directory in
  the reference's layout: its config.yaml, its safetensors files and its
  torch pickles, every family read, each loaded tree equal to the one the
  directory was written from (weight-normed leaves within 1 f32 ulp of
  the fold). The import check above cannot see this: the config reader's
  and the loader's imports sit inside functions.
- The copied text front end gives the JAX package's normalized text, token
  ids and segments on English and Chinese sentences.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SENTENCES = [
    "Hello world, the cat sat on 3 mats at 10:30.",
    "It costs $12.50 -- that's 25% off!",
    "你好，世界。今天是2024年5月1日。",
    "我爱 TTS 和 deep learning 模型。",
]


def test_port_and_smoke_import_nothing_of_jax_or_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import indextts_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(indextts_tpu_torch.__path__,\n"
        "                                                'indextts_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'tools')\n"
        "import torch_reference_ckpt\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'indextts_tpu', 'transformers', 'tokenizers',\n"
        "              'regex', 'jinja2', 'yaml', 'safetensors'))\n"
        "assert not bad, bad\n"
        "assert len(names) > 30, names\n"
        "assert {'indextts_tpu_torch.parallel.mesh', 'indextts_tpu_torch.ops.decode_step_tp',\n"
        "        'indextts_tpu_torch.cli', 'indextts_tpu_torch.pipeline.infer_v1',\n"
        "        'indextts_tpu_torch.models.gpt.unified_voice_v1',\n"
        "        'indextts_tpu_torch.models.vocoder.bigvgan_v1',\n"
        "        'indextts_tpu_torch.models.vocoder.ecapa', 'indextts_tpu_torch.models.qwen',\n"
        "        'indextts_tpu_torch.text.qwen_tokenizer', 'indextts_tpu_torch.pipeline.emotion',\n"
        "        'indextts_tpu_torch.cli_v2', 'indextts_tpu_torch.utils.download',\n"
        "        'indextts_tpu_torch.webui', 'indextts_tpu_torch.utils.presets',\n"
        "        'indextts_tpu_torch.utils.i18n',\n"
        "        'indextts_tpu_torch.utils.examples_downloader',\n"
        "        'indextts_tpu_torch.parallel.train', 'indextts_tpu_torch.train',\n"
        "        'indextts_tpu_torch.models.codec.dvae'} <= set(names), \\\n"
        "    names\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO)
    assert res.returncode == 0, res.stderr


BLOCKED_LOAD = """
import sys
for name in ("yaml", "safetensors", "jax", "indextts_tpu"):
    sys.modules[name] = None
import torch
from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2
d = sys.argv[1]
tts = IndexTTS2(cfg_path=d + "/config.yaml", model_dir=d, device="cpu",
                dtype=torch.float32, allow_random_init=False)
assert [r["family"] for r in tts.load_report] == [
    "gpt", "s2mel", "codec", "campplus", "bigvgan", "w2v", "w2v_stat", "matrices"]
torch.save({"gpt": tts.gpt_params, "s2mel": tts.s2mel_params, "codec": tts.codec_params,
            "campplus": tts.campplus_params, "bigvgan": tts.bigvgan_params,
            "w2v": tts.w2v_params, "emo_matrix": torch.cat(tts.emo_matrix),
            "spk_matrix": torch.cat(tts.spk_matrix), "cfg": repr(tts.cfg)}, d + "/loaded.pt")
assert float(tts.w2v_mean[0]) == 0.5 and float(tts.w2v_std[0]) == 3.0
assert not [k for k in sys.modules if sys.modules[k] is not None
            and k.split(".")[0] in ("yaml", "safetensors", "jax", "indextts_tpu")]
"""


BLOCKED_QWEN = """
import sys
for name in ("transformers", "tokenizers", "regex", "jinja2", "yaml", "safetensors", "jax",
             "indextts_tpu"):
    sys.modules[name] = None
import torch
from indextts_tpu_torch.pipeline.emotion import QwenEmotion
qe = QwenEmotion(sys.argv[1], "cpu", torch.float32)
out = qe.inference("今天我很开心")
assert qe.model is not None and list(out) == ["happy", "angry", "sad", "afraid", "disgusted",
                                              "melancholic", "surprised", "calm"], out
"""


def test_qwen_emotion_loads_without_the_hub_packages(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_emotion import _tiny_qwen_dir

    _tiny_qwen_dir(tmp_path)
    res = subprocess.run([sys.executable, "-c", BLOCKED_QWEN, str(tmp_path)],
                         capture_output=True, text=True, cwd=REPO)
    assert res.returncode == 0, res.stderr


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_port_loads_a_model_directory_without_yaml_or_safetensors(tmp_path):
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_reference_ckpt as refckpt
    from test_pipeline_e2e import tiny_config

    from indextts_tpu_torch.pipeline.infer_v2 import random_trees
    from indextts_tpu_torch.utils.jax_params import to_torch

    cfg = tiny_config()
    trees = random_trees(cfg, 2, "cpu")
    H = cfg.w2v_bert.hidden_size
    trees["w2v_mean"], trees["w2v_std"] = torch.full((H,), 0.5), torch.full((H,), 3.0)
    written = refckpt.write_model_dir(str(tmp_path), trees, cfg)
    assert {"config.yaml", "hf_cache/semantic_codec_model.safetensors",
            "hf_cache/w2v-bert-2.0/model.safetensors"} <= set(written)
    res = subprocess.run([sys.executable, "-c", BLOCKED_LOAD, str(tmp_path)],
                         capture_output=True, text=True, cwd=REPO)
    assert res.returncode == 0, res.stderr
    loaded = torch.load(str(tmp_path / "loaded.pt"), weights_only=False)
    for key in ("gpt", "s2mel", "codec", "campplus", "bigvgan", "w2v"):
        got = dict(_leaves(loaded[key]))
        want = dict(_leaves(to_torch(trees[key], "cpu", torch.float32)))
        assert got.keys() == want.keys(), key
        for path, w in want.items():
            assert got[path].shape == w.shape, (key, path)
            assert torch.allclose(got[path], w, rtol=2 ** -23, atol=0), (key, path)
    assert torch.equal(loaded["emo_matrix"], trees["emo_matrix"])
    assert torch.equal(loaded["spk_matrix"], trees["spk_matrix"])


@pytest.fixture(scope="module")
def bpe_model(tmp_path_factory):
    from indextts_tpu.text.spm import build_model_file

    words = ["▁HELLO", "▁WORLD", "▁THE", "▁CAT", "▁SAT", "▁ON", "▁MATS", "▁AT", "▁IT",
             "▁COSTS", "▁THAT", "▁OFF", "▁TTS", "▁DEEP", "▁LEARNING", "▁TWELVE", "▁TEN"]
    han = "你好世界今天是年月日我爱和模型二零四五一"
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    vocab = [w[:i] for w in words for i in range(2, len(w) + 1)]
    vocab += ["▁" + c for c in han] + list(han)
    vocab += ["▁", ".", ",", "!", "?", "'", "-", "▁,", "▁.", "S", "E", "T", "A", "O", "N"]
    seen, score = set(), -1.0
    for w in vocab:
        if w not in seen:
            seen.add(w)
            pieces.append((w, score, 1))
            score -= 1.0
    path = str(tmp_path_factory.mktemp("bpe") / "bpe.model")
    build_model_file(pieces, path)
    return path


@pytest.mark.parametrize("text", SENTENCES)
def test_copied_text_front_end_matches_jax_package(bpe_model, text):
    from indextts_tpu.text import front as jfront
    from indextts_tpu_torch.text import front as tfront

    jn, tn = jfront.TextNormalizer(enable_glossary=True), tfront.TextNormalizer(
        enable_glossary=True)
    jn.load()
    tn.load()
    assert tn.normalize(text) == jn.normalize(text)
    jt, tt = jfront.TextTokenizer(bpe_model, jn), tfront.TextTokenizer(bpe_model, tn)
    jtok, ttok = jt.tokenize(text), tt.tokenize(text)
    assert ttok == jtok
    ids = tt.convert_tokens_to_ids(ttok)
    assert ids == jt.convert_tokens_to_ids(jtok)
    assert len(set(ids)) > 2
    assert tt.split_segments(ttok, 12) == jt.split_segments(jtok, 12)
