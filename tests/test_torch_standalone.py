"""The port stands alone.

- Importing every module of `indextts_tpu_torch` (the tensor-parallel
  `parallel/mesh.py` and `ops/decode_step_tp.py` among them), and
  `chip_smoke.py` as a module, loads neither jax nor any module of the JAX
  package
  (`indextts_tpu`): the port keeps its own copies of the host modules it
  needs (config, text front end, buckets, resampling, wav I/O).
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
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'indextts_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) > 30, names\n"
        "assert {'indextts_tpu_torch.parallel.mesh', 'indextts_tpu_torch.ops.decode_step_tp'}"
        " <= set(names), names\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO)
    assert res.returncode == 0, res.stderr


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
