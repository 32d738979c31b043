"""PyTorch port: the pipeline's constructor and `infer` behave as the JAX
`IndexTTS2` does where the port differed, and K2's rope pass composes into
K2's attention.

- the JAX constructor's keyword set is accepted (the CUDA-era knobs are
  ignored; ``use_fp16=True`` is held against the JAX fp16 pipeline in
  `tests/test_torch_fp16.py`); ``allow_random_init=False`` without a GPT
  checkpoint raises FileNotFoundError, as the JAX pipeline does;
- each of the 13 files the JAX pipeline's loader reads, present with valid
  content (written in the reference's layout by
  `tools/torch_reference_ckpt.py`), changes exactly the part of the state
  its JAX counterpart changes, and that part equals the file's tree; each of
  the four ``aux_paths`` entries loads from the path it names; an empty file
  raises (never random weights in its place); gpt.pth present with
  ``allow_random_init=False`` loads;
- a decode that stops at ``max_mel_tokens`` warns with the JAX pipeline's
  RuntimeWarning;
- `rope_qk_plain` composed with `packed_pair_attention_plain` is
  `attention_rope_plain` exactly, and matches the JAX
  `packed_pair_attention_rope` (the Pallas kernel in interpret mode) within
  `tests/test_torch_tiers.py`'s bf16 attention tolerance (rel-L2 1e-2).
"""

import dataclasses
import json
import os
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

from indextts_tpu.ops.pallas import attn as jattn  # noqa: E402
from indextts_tpu.text.spm import build_model_file  # noqa: E402
from indextts_tpu.utils.wav_io import write_wav  # noqa: E402
from indextts_tpu_torch.ops import attn  # noqa: E402
from indextts_tpu_torch.ops.rope import precompute_freqs_cis  # noqa: E402
from indextts_tpu_torch.pipeline.infer_v2 import (IndexTTS2, checkpoint_files,  # noqa: E402
                                                  random_trees)
from indextts_tpu_torch.utils.jax_params import to_torch  # noqa: E402

TEXT = "hello world ."
# CUDA-era knobs of the reference constructor, accepted and ignored
REFERENCE_KWARGS = {"use_cuda_kernel": True, "use_deepspeed": True, "use_accel": True,
                    "use_torch_compile": True, "use_fp16": False, "allow_random_init": True,
                    "aux_paths": {}}
AUX_FILES = ["gpt.pth", "s2mel.pth", "hf_cache/semantic_codec_model.safetensors",
             "hf_cache/campplus_cn_common.bin", "hf_cache/bigvgan/config.json",
             "hf_cache/bigvgan/bigvgan_generator.pt", "hf_cache/bigvgan/pytorch_model.bin",
             "hf_cache/bigvgan/model.safetensors", "hf_cache/w2v-bert-2.0/model.safetensors",
             "hf_cache/w2v-bert-2.0/pytorch_model.bin", "wav2vec2bert_stats.pt", "feat1.pt",
             "feat2.pt"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_faults_model")
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    vocab = [w[:i] for w in ["▁HELLO", "▁WORLD", "▁."] for i in range(2, len(w) + 1)]
    for i, w in enumerate(vocab + ["▁", "."]):
        pieces.append((w, -1.0 - i, 1))
    build_model_file(pieces, str(d / "bpe.model"))
    sr = 16000
    tt = np.arange(int(0.5 * sr)) / sr
    write_wav(str(d / "prompt.wav"), (0.3 * np.sin(2 * np.pi * 220 * tt)).astype(np.float32), sr)
    return str(d)


def _tts(model_dir, **kwargs):
    return IndexTTS2(cfg_path=None, model_dir=model_dir, device="cpu", dtype=torch.float32,
                     cfg=tiny_config(), **kwargs)


def test_reference_constructor_kwargs_are_accepted(model_dir):
    tts = _tts(model_dir, **REFERENCE_KWARGS)
    assert tts.dtype == torch.float32 and tts.device == torch.device("cpu")


def test_no_random_init_without_checkpoint_raises(model_dir):
    with pytest.raises(FileNotFoundError, match="gpt.pth"):
        _tts(model_dir, allow_random_init=False)


def _dir_with(tmp_path, files) -> str:
    """A model directory holding ``files`` ({relative path: writer(path)})."""
    for rel, write in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        write(str(path))
    return str(tmp_path)


def _state(tts) -> dict:
    return {"gpt": tts.gpt_params, "s2mel": tts.s2mel_params, "codec": tts.codec_params,
            "campplus": tts.campplus_params, "bigvgan": tts.bigvgan_params,
            "w2v": tts.w2v_params, "w2v_mean": tts.w2v_mean, "w2v_std": tts.w2v_std,
            "emo_matrix": tts.emo_matrix, "spk_matrix": tts.spk_matrix,
            "cfg.bigvgan": dataclasses.asdict(tts.cfg.bigvgan)}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a, b))
    return a == b


def _changed(tts, base) -> set:
    now, was = _state(tts), _state(base)
    return {k for k in now if not _equal(now[k], was[k])}


@pytest.fixture(scope="module")
def files():
    """Valid content for every file the loader reads, at the tiny config, from
    seed 1's random weights (the constructor draws seed 0's): {name: (writer,
    the tree the file holds, in the port's layout)}."""
    cfg = tiny_config()
    trees = random_trees(cfg, 1, "cpu")
    sds = refckpt.state_dicts(trees, cfg)
    host = {fam: {k: v.contiguous().clone() for k, v in sd.items()} for fam, sd in sds.items()}
    H = cfg.w2v_bert.hidden_size
    mean, std = torch.full((H,), 0.25), torch.full((H,), 2.0)
    smaller = dataclasses.replace(cfg.bigvgan, upsample_initial_channel=16)

    def put(obj):
        return lambda path: torch.save(obj, path)

    def st(sd):
        return lambda path: refckpt.save_safetensors(sd, path)

    def config_json(path):
        with open(path, "w", encoding="utf-8") as f:
            json.dump(refckpt._lists(dataclasses.asdict(smaller)), f)

    out = {"gpt.pth": (put(host["gpt"]), "gpt", trees["gpt"]),
           "s2mel.pth": (put({**refckpt.net_wrapped(host["s2mel"]), "optimizer": {}}), "s2mel",
                         trees["s2mel"]),
           "hf_cache/semantic_codec_model.safetensors": (st(host["codec"]), "codec",
                                                         trees["codec"]),
           "hf_cache/campplus_cn_common.bin": (put(host["campplus"]), "campplus",
                                               trees["campplus"]),
           "hf_cache/bigvgan/config.json": (config_json, "cfg.bigvgan", None),
           "hf_cache/bigvgan/bigvgan_generator.pt": (put({"generator": host["bigvgan"]}),
                                                     "bigvgan", trees["bigvgan"]),
           "hf_cache/bigvgan/pytorch_model.bin": (put(host["bigvgan"]), "bigvgan",
                                                  trees["bigvgan"]),
           "hf_cache/bigvgan/model.safetensors": (st(host["bigvgan"]), "bigvgan",
                                                  trees["bigvgan"]),
           "hf_cache/w2v-bert-2.0/model.safetensors": (st(host["w2v"]), "w2v", trees["w2v"]),
           "hf_cache/w2v-bert-2.0/pytorch_model.bin": (put(host["w2v"]), "w2v", trees["w2v"]),
           "wav2vec2bert_stats.pt": (put({"mean": mean, "std": std}), "w2v_stat",
                                     {"w2v_mean": mean, "w2v_std": std}),
           "feat1.pt": (put(trees["emo_matrix"]), "emo_matrix", trees["emo_matrix"]),
           "feat2.pt": (put(trees["spk_matrix"]), "spk_matrix", trees["spk_matrix"])}
    assert sorted(out) == sorted(AUX_FILES)
    return out


@pytest.fixture(scope="module")
def base(model_dir):
    """The model with no file: every family drawn from seed 0."""
    return _tts(model_dir)


def _close(got, tree) -> bool:
    """``got`` (port layout) against a JAX-layout tree read back through the
    bridge: equal, weight-normed leaves within 1 f32 ulp of the fold."""
    want = to_torch(tree, "cpu", torch.float32)
    a, b = dict(_leaves(got)), dict(_leaves(want))
    if a.keys() != b.keys():
        return False
    for k, x in a.items():
        y = b[k]
        if x.shape != y.shape or not torch.allclose(x, y, rtol=2 ** -23, atol=0):
            return False
    return True


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


# the part of the state each file changes, as in the JAX loader
# (`indextts_tpu/pipeline/infer_v2.py::_load_models`): BigVGAN's config.json
# sets the vocoder's config, so the random vocoder is drawn at it; the
# speaker matrix is read only with the emotion matrix (below)
CHANGES = {"hf_cache/bigvgan/config.json": {"cfg.bigvgan", "bigvgan"},
           "wav2vec2bert_stats.pt": {"w2v_mean", "w2v_std"},
           "feat2.pt": set()}


@pytest.mark.parametrize("name", AUX_FILES)
def test_present_checkpoint_file_is_loaded(tmp_path, files, base, name):
    write, part, tree = files[name]
    assert str(tmp_path / name) in checkpoint_files(tiny_config(), str(tmp_path))
    if name == "feat1.pt":
        # the emotion matrix brings the speaker matrix's file with it: alone
        # it raises, as the JAX loader's torch.load of the missing file does
        _dir_with(tmp_path, {name: write})
        with pytest.raises(FileNotFoundError, match="feat2.pt"):
            _tts(str(tmp_path))
        _dir_with(tmp_path, {"feat2.pt": files["feat2.pt"][0]})
        tts = _tts(str(tmp_path))
        assert _changed(tts, base) == {"emo_matrix", "spk_matrix"}
        assert torch.equal(torch.cat(tts.emo_matrix), tree)
        assert torch.equal(torch.cat(tts.spk_matrix), files["feat2.pt"][2])
        return
    tts = _tts(_dir_with(tmp_path, {name: write}))
    assert _changed(tts, base) == CHANGES.get(name, {part}), name
    if name == "hf_cache/bigvgan/config.json":
        assert tts.cfg.bigvgan.upsample_initial_channel == 16
        assert tts.bigvgan_params["conv_pre"]["weight"].shape[0] == 16
    elif name == "wav2vec2bert_stats.pt":
        assert torch.equal(tts.w2v_mean, tree["w2v_mean"]) and torch.equal(tts.w2v_std,
                                                                           tree["w2v_std"])
    elif part != "spk_matrix":
        assert _close(_state(tts)[part], tree), name
    read = [] if name in ("hf_cache/bigvgan/config.json", "feat2.pt") else [str(tmp_path / name)]
    assert [r["path"] for r in tts.load_report] == read


@pytest.mark.parametrize("key,name", [("semantic_codec", "codec.safetensors"),
                                      ("campplus", "campplus.bin"),
                                      ("bigvgan", "bigvgan_dir/pytorch_model.bin"),
                                      ("w2v_bert", "w2v_dir/model.safetensors")])
def test_checkpoint_named_in_aux_paths_is_loaded(model_dir, files, base, tmp_path, key, name):
    default = {"semantic_codec": "hf_cache/semantic_codec_model.safetensors",
               "campplus": "hf_cache/campplus_cn_common.bin",
               "bigvgan": "hf_cache/bigvgan/pytorch_model.bin",
               "w2v_bert": "hf_cache/w2v-bert-2.0/model.safetensors"}[key]
    write, part, tree = files[default]
    _dir_with(tmp_path, {name: write})
    path = tmp_path / name
    where = str(path.parent) if key in ("bigvgan", "w2v_bert") else str(path)
    tts = _tts(model_dir, aux_paths={key: where})
    assert _changed(tts, base) == {part}
    assert _close(_state(tts)[part], tree)
    assert [r["path"] for r in tts.load_report] == [str(path)]


@pytest.mark.parametrize("name", ["gpt.pth", "hf_cache/semantic_codec_model.safetensors",
                                  "hf_cache/bigvgan/config.json"])
def test_empty_checkpoint_file_raises(tmp_path, name):
    """A file that exists but cannot be read raises; no random weights
    stand in for it."""
    _dir_with(tmp_path, {name: lambda path: open(path, "wb").close()})
    with pytest.raises((EOFError, RuntimeError, ValueError)):
        _tts(str(tmp_path))


def test_no_random_init_with_gpt_checkpoint_loads(tmp_path, files, base):
    write, part, tree = files["gpt.pth"]
    tts = _tts(_dir_with(tmp_path, {"gpt.pth": write}), allow_random_init=False)
    assert _changed(tts, base) == {"gpt"} and _close(tts.gpt_params, tree)


def test_decode_at_max_mel_tokens_warns(model_dir):
    tts = _tts(model_dir)
    with pytest.warns(RuntimeWarning, match="max_mel_tokens"):
        tts.infer(spk_audio_prompt=os.path.join(model_dir, "prompt.wav"), text=TEXT,
                  output_path=None, max_mel_tokens=6, min_new_tokens=6, num_beams=2)
    assert tts.last_stage_times["codes"] == 6


def _rope_args(T=80, H=2, D=64, lengths=(80, 37), seed=3):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((len(lengths), T, H * D)).astype(np.float32)
               for _ in range(3))
    return q, k, v, np.asarray(lengths, np.int32), precompute_freqs_cis(T, D), H


def test_rope_pass_composes_into_k2_plain():
    q, k, v, lens, fc, H = _rope_args()
    q, k, v, lens, fc = (torch.as_tensor(a) for a in (q, k, v, lens, fc))
    qr, kr = attn.rope_qk_plain(q, k, fc, H)
    assert qr.shape == q.shape and qr.dtype == q.dtype
    composed = attn.packed_pair_attention_plain(qr, kr, v, lens, H)
    assert torch.equal(composed, attn.attention_rope_plain(q, k, v, lens, fc, H))


def test_rope_pass_then_k2_plain_matches_jax_kernel():
    """Against the JAX kernel in interpret mode, in bf16 (the kernel's
    type): rel-L2 <= 1e-2 over valid query rows, `tests/test_torch_tiers.py`'s
    bound for bf16 attention."""
    q, k, v, lens, fc, H = _rope_args(T=128, H=2, lengths=(128, 53))
    bf = jnp.bfloat16
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(jattn.packed_pair_attention_rope(
            jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf), jnp.asarray(lens),
            jnp.asarray(fc), heads=H, interpret=True).astype(jnp.float32))
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    qr, kr = attn.rope_qk_plain(tq, tk, torch.as_tensor(fc), H)
    out = attn.packed_pair_attention_plain(qr, kr, tv, torch.as_tensor(lens), H).float().numpy()
    for b, L in enumerate(lens):
        rel = np.linalg.norm(out[b, :L] - ref[b, :L]) / np.linalg.norm(ref[b, :L])
        assert rel <= 1e-2, (b, rel)
