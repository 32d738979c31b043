"""PyTorch port: checkpoint loading against the JAX package.

- (a) the port's converters (`indextts_tpu_torch/utils/convert.py`) and the
  JAX package's give identical trees on the six v2 families at the shipped
  scale, fed the manifest's exact keys and shapes as zero-memory tagged
  arrays (`tests/test_convert_manifest.py`'s harness), and the port consumes
  every key that is not on that file's allowlist;
- (b) each primitive mapper and `fold_weight_norm` (both weight-norm layouts)
  equals the JAX one on random values, and so does the whole CAMPPlus
  family (random values, positive running_var);
- (c) the safetensors reader matches the `safetensors` package for every
  dtype (BF16 against `safetensors.torch`), empty tensors and
  ``__metadata__``; a truncated file, an unknown dtype and overlapping
  offsets raise;
- (d) `load_torch_state_dict` on the raw, ``model``, ``state_dict``,
  ``generator`` and ``net`` + optimizer layouts: the JAX loader returns no
  key for the last two, the port the flattened ones;
- (e) `load_config` equals ``yaml.safe_load`` and the JAX `load_config` on
  the config.yaml `tools/torch_reference_ckpt.py` writes (shipped and tiny),
  on the reference's own layout with comments and YAML 1.1 scalars, and
  raises with the line number outside its subset;
- (f) the npz store round-trips between the port and the JAX package;
- (g) `tools/torch_reference_ckpt.py` is the converters' inverse: the JAX
  converters give its input tree back from its state dicts at the tiny
  config (weight-normed leaves within 1 f32 ulp, the rest bit-equal), with
  ``match_dtype=bf16`` the port loads the tree's bf16 bits exactly, and at
  the shipped config (drawn on the meta device) its keys and shapes are
  the manifest's, apart from the allowlisted buffers;
- (h) a tiny model directory in the reference's file layout: the JAX
  `IndexTTS2` and the port load the same trees (compared through the weight
  bridge) and serve a greedy num_beams=3 request with token-equal codes and
  the wav within rel-L2 1e-3 (the CFM noise handed over, as in
  `tests/test_torch_pipeline.py`); the wrapped s2mel / BigVGAN files load to
  the same trees in the port; a BigVGAN config.json that changes the
  architecture loads in the port (converted at the config it runs), while
  the JAX loader, which converts at the config before the override, raises.
"""

import dataclasses
import json
import os
import re
import struct
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

sys.path.insert(0, "tests")
sys.path.insert(0, "tools")

import torch_reference_ckpt as refckpt  # noqa: E402
from test_convert_manifest import ALLOW_UNCONSUMED, _prefold, _walk  # noqa: E402
from test_pipeline_e2e import tiny_config  # noqa: E402

from indextts_tpu import config as jconfig  # noqa: E402
from indextts_tpu.text.spm import build_model_file  # noqa: E402
from indextts_tpu.utils import checkpoint as jckpt  # noqa: E402
from indextts_tpu.utils import convert as jconv  # noqa: E402
from indextts_tpu.utils.wav_io import write_wav  # noqa: E402
from indextts_tpu_torch import config as tconfig  # noqa: E402
from indextts_tpu_torch import nn as tnn  # noqa: E402
from indextts_tpu_torch.pipeline import infer_v2  # noqa: E402
from indextts_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from indextts_tpu_torch.utils import convert as tconv  # noqa: E402
from indextts_tpu_torch.utils import safetensors as tst  # noqa: E402
from indextts_tpu_torch.utils import yaml_subset  # noqa: E402
from indextts_tpu_torch.utils.jax_params import to_torch  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ckpt_manifests.json")
SHIPPED = tconfig.IndexTTS2Config()
TEXT = "hello world ."
# manifest family -> (its key in the trees, converter(module, sd))
FAMILIES = {
    "gpt": ("gpt", lambda m, sd: m.convert_unified_voice(sd, SHIPPED.gpt)),
    "s2mel": ("s2mel", lambda m, sd: m.convert_s2mel(sd, SHIPPED.s2mel)),
    "semantic_codec": ("codec", lambda m, sd: m.convert_repcodec(sd, SHIPPED.semantic_codec)),
    "campplus": ("campplus", lambda m, sd: m.convert_campplus(sd)),
    "bigvgan": ("bigvgan", lambda m, sd: m.convert_bigvgan(sd, SHIPPED.bigvgan)),
    "w2vbert": ("w2v", lambda m, sd: m.convert_w2vbert(sd, SHIPPED.w2v_bert)),
}


def _manifest(name):
    with open(FIXTURE) as f:
        return json.load(f)[name]["keys"]


def assert_same_tree(a, b, path="", exact=True):
    """Same nesting, and every leaf of the same shape and dtype and equal."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            assert_same_tree(a[k], b[k], f"{path}/{k}", exact)
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{path}/{i}", exact)
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape)
        assert np.array_equal(a, b), path


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


# -- (a) the converters at the shipped scale -----------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_converter_equals_jax_converter_at_manifest_scale(family):
    """Identical trees from the same tagged state dict; every manifest key
    not on the allowlist reaches the port's tree."""
    _, entry = FAMILIES[family]
    manifest = _manifest(family)
    keys, pair_map = _prefold(manifest)
    sd, tag_of = {}, {}
    for i, (k, shape) in enumerate(sorted(keys.items())):
        sd[k] = np.broadcast_to(np.float32(i + 1), tuple(shape))
        tag_of[float(i + 1)] = k
    ours = entry(tconv, dict(sd))
    tags = set()
    _walk(ours, tags)
    theirs = entry(jconv, dict(sd))
    assert_same_tree(ours, theirs)
    del theirs
    consumed = set()
    for t in tags:
        consumed.update(pair_map.get(tag_of[t], (tag_of[t],)))
    allowed = [re.compile(p) for p in ALLOW_UNCONSUMED[family]]
    left = sorted(k for k in manifest
                  if k not in consumed and not any(p.search(k) for p in allowed))
    assert not left, left[:20]


# -- (b) the primitive mappers and CAMPPlus on random values -------------------------

def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name,shapes", [
    ("linear", {"w.weight": (6, 4), "w.bias": (6,)}),
    ("hf_conv1d", {"w.weight": (4, 6), "w.bias": (6,)}),
    ("conv1d", {"w.weight": (6, 4, 3), "w.bias": (6,)}),
    ("conv1d_as_dense", {"w.weight": (6, 4, 1), "w.bias": (6,)}),
    ("conv2d", {"w.weight": (6, 4, 3, 2)}),
    ("conv_transpose1d", {"w.weight": (4, 6, 5), "w.bias": (6,)}),
    ("layer_norm", {"w.weight": (5,), "w.bias": (5,)}),
    ("rms_norm", {"w.weight": (5,)}),
    ("embedding", {"w.weight": (9, 5)}),
    ("batch_norm", {"w.running_mean": (5,), "w.running_var": (5,), "w.weight": (5,),
                    "w.bias": (5,)}),
])
def test_primitive_mapper_equals_jax(name, shapes):
    rng = np.random.default_rng(0)
    sd = {k: _rand(rng, *s) for k, s in shapes.items()}
    assert_same_tree(getattr(tconv, name)(sd, "w"), getattr(jconv, name)(sd, "w"))


@pytest.mark.parametrize("layout", ["weight_g", "parametrizations"])
def test_fold_weight_norm_equals_jax(layout):
    rng = np.random.default_rng(1)
    g, v = np.abs(_rand(rng, 6, 1, 1)) + 0.1, _rand(rng, 6, 4, 3)
    sd = {"a.bias": _rand(rng, 6)}
    if layout == "weight_g":
        sd.update({"a.weight_g": g, "a.weight_v": v})
    else:
        sd.update({"a.parametrizations.weight.original0": g,
                   "a.parametrizations.weight.original1": v})
    ours = tconv.fold_weight_norm(sd)
    assert set(ours) == {"a.bias", "a.weight"}
    assert_same_tree(ours, jconv.fold_weight_norm(sd))


def test_campplus_on_random_values_equals_jax():
    rng = np.random.default_rng(2)
    sd = {}
    for k, shape in _manifest("campplus").items():
        a = _rand(rng, *shape)
        sd[k] = np.abs(a) + 0.5 if k.endswith("running_var") else a
    assert_same_tree(tconv.convert_campplus(sd), jconv.convert_campplus(sd))


# -- (c) the safetensors reader ---------------------------------------------------------

def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.numpy import load_file as np_load, save_file as np_save
    from safetensors.torch import load_file as pt_load, save_file as pt_save

    rng = np.random.default_rng(3)
    arrays = {"f64": rng.standard_normal((2, 3)), "f32": _rand(rng, 4, 5),
              "f16": _rand(rng, 7).astype(np.float16),
              "i64": rng.integers(-9, 9, (3, 2)).astype(np.int64),
              "i32": rng.integers(-9, 9, 5).astype(np.int32),
              "i16": rng.integers(-9, 9, 5).astype(np.int16),
              "i8": rng.integers(-9, 9, 6).astype(np.int8),
              "u8": rng.integers(0, 255, 6).astype(np.uint8),
              "bool": rng.standard_normal(5) > 0, "empty": np.zeros((0, 3), np.float32),
              "scalar": np.array(2.5, np.float32)}
    path = str(tmp_path / "a.safetensors")
    np_save(arrays, path, metadata={"format": "np", "note": "x"})
    ours, ref = tst.load_file(path), np_load(path)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].numpy().dtype == ref[k].dtype and np.array_equal(ours[k].numpy(), ref[k]), k
    assert tst.read_metadata(path) == {"format": "np", "note": "x"}
    bpath = str(tmp_path / "b.safetensors")
    pt_save({"bf16": torch.randn(4, 3, generator=torch.Generator().manual_seed(0)).bfloat16(),
             "f32": torch.ones(2)}, bpath)
    ours, ref = tst.load_file(bpath), pt_load(bpath)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and torch.equal(ours[k], ref[k]), k
    assert tst.read_metadata(bpath) == {}


def _raw_safetensors(path, header: dict, data: bytes) -> str:
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + data)
    return str(path)


@pytest.mark.parametrize("case,match", [
    ("truncated", "truncated"), ("unknown dtype", "unknown dtype"),
    ("overlap", "overlapping"), ("span", "spans"), ("header", "past the end")])
def test_safetensors_reader_refuses_a_bad_file(tmp_path, case, match):
    ok = {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
          "b": {"dtype": "F32", "shape": [1], "data_offsets": [8, 12]}}
    data = bytes(12)
    path = tmp_path / "x.safetensors"
    if case == "truncated":
        _raw_safetensors(path, ok, data[:-2])
    elif case == "unknown dtype":
        _raw_safetensors(path, {**ok, "b": {**ok["b"], "dtype": "X9"}}, data)
    elif case == "overlap":
        _raw_safetensors(path, {**ok, "b": {**ok["b"], "data_offsets": [4, 8]}}, bytes(12))
    elif case == "span":
        _raw_safetensors(path, {**ok, "b": {**ok["b"], "shape": [2]}}, data)
    else:
        path.write_bytes(struct.pack("<Q", 1 << 20) + b"{}")
    with pytest.raises(ValueError, match=match):
        tst.load_file(str(path))


def test_stdlib_writer_reads_back_in_the_package(tmp_path):
    from safetensors.torch import load_file as pt_load

    g = torch.Generator().manual_seed(4)
    tensors = {"w": torch.randn(3, 4, generator=g), "h": torch.randn(5, generator=g).half(),
               "bf": torch.randn(2, 2, generator=g).bfloat16(), "i": torch.arange(3),
               "e": torch.zeros(0)}
    path = str(tmp_path / "w.safetensors")
    n = refckpt.save_safetensors(tensors, path, metadata={"format": "pt"})
    assert n == os.path.getsize(path)
    for loaded in (pt_load(path), tst.load_file(path)):
        assert_same_tree(loaded, tensors)


# -- (d) the state-dict loader's wrappers ------------------------------------------------

def _sd(seed=5):
    g = torch.Generator().manual_seed(seed)
    return {"conv_pre.weight": torch.randn(4, 3, 2, generator=g),
            "conv_pre.bias": torch.randn(4, generator=g).bfloat16(),
            "steps": torch.tensor(7)}


@pytest.mark.parametrize("layout", ["raw", "model", "state_dict", "generator", "net"])
def test_load_torch_state_dict_unwraps(tmp_path, layout):
    sd = _sd()
    obj = {"raw": sd, "model": {"model": sd, "epoch": 3}, "state_dict": {"state_dict": sd},
           "generator": {"generator": sd},
           "net": {"net": {"cfm": sd, "length_regulator": {"w": torch.ones(2)}},
                   "optimizer": {"state": {}, "param_groups": [{"lr": 1e-4}]}, "iters": 9}}[layout]
    path = str(tmp_path / "ckpt.pth")
    torch.save(obj, path)
    ours = tconv.load_torch_state_dict(path)
    if layout == "net":
        want = {f"cfm.{k}": v for k, v in sd.items()} | {"length_regulator.w": torch.ones(2)}
    else:
        want = sd
    assert set(ours) == set(want)
    for k, v in want.items():
        assert ours[k].dtype == np.float32 and np.array_equal(ours[k], v.float().numpy()), k
    theirs = jconv.load_torch_state_dict(path)
    if layout in ("generator", "net"):
        # the JAX loader unwraps only 'model' and 'state_dict': the released
        # bigvgan_generator.pt and s2mel.pth layouts load as no key at all
        assert theirs == {}
    else:
        assert_same_tree(ours, theirs)


def test_load_torch_state_dict_reads_safetensors(tmp_path):
    sd = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2).half()}
    path = str(tmp_path / "m.safetensors")
    refckpt.save_safetensors(sd, path)
    ours, theirs = tconv.load_torch_state_dict(path), jconv.load_torch_state_dict(path)
    assert set(ours) == set(theirs) == {"a", "b"}
    # the port casts every tensor to f32, as the JAX loader does for torch
    # files (its safetensors branch keeps the stored type)
    for k in ours:
        assert ours[k].dtype == np.float32 and np.array_equal(ours[k], theirs[k].astype(np.float32))


# -- (e) config.yaml without PyYAML --------------------------------------------------------

REFERENCE_YAML = """\
dataset:
    bpe_model: bpe.model
    sample_rate: 24000
    squeeze: false
    mel:
        n_fft: 1024
        mel_fmin: 0
        normalize: false

gpt:
    model_dim: 1280
    max_mel_tokens: 1815
    max_text_tokens: 600
    heads: 20
    use_mel_codes_as_input: true
    mel_length_compression: 1024
    layers: 24
    number_text_tokens: 12000
    number_mel_codes: 8194
    start_mel_token: 8192
    stop_mel_token: 8193
    start_text_token: 0
    stop_text_token: 1
    train_solo_embeddings: false
    condition_type: "conformer_perceiver"
    condition_module:
        output_size: 512
        linear_units: 2048
        attention_heads: 8
        num_blocks: 6
        input_layer: "conv2d2"
        perceiver_mult: 2
    emo_condition_module:   # the emotion encoder
        output_size: 512
        linear_units: 1024
        attention_heads: 4
        num_blocks: 4
        input_layer: 'conv2d2'
        perceiver_mult: 2

semantic_codec:
    codebook_size: 8192
    hidden_size: 1024
    codebook_dim: 8
    vocos_dim: 384
    vocos_intermediate_dim: 2048
    vocos_num_layers: 12

s2mel:
    preprocess_params:
        sr: 22050
        spect_params:
            n_fft: 1024
            win_length: 1024
            hop_length: 256
            n_mels: 80
            fmin: 0
            fmax: "None"
    dit_type: "DiT"
    reg_loss_type: "l1"
    style_encoder:
        dim: 192
    length_regulator:
        channels: 512
        is_discrete: false
        in_channels: 1024
        content_codebook_size: 2048
        sampling_ratios: [1, 1, 1, 1]
        vector_quantize: false
        n_codebooks: 1
        quantizer_dropout: 0.0
        f0_condition: false
        n_f0_bins: 512
    DiT:
        hidden_dim: 512
        num_heads: 8
        depth: 13
        class_dropout_prob: 0.1
        block_size: 8192
        in_channels: 80
        style_condition: true
        final_layer_type: 'wavenet'
        target: 'mel'
        content_dim: 512
        content_codebook_size: 1024
        content_type: 'discrete'
        is_causal: false
        long_skip_connection: true
        zero_prompt_speech_token: false
        time_as_token: false
        style_as_token: false
        uvit_skip_connection: true
        add_resblock_in_transformer: false
    wavenet:
        hidden_dim: 512
        num_layers: 8
        kernel_size: 5
        dilation_rate: 1
        p_dropout: 0.2
        style_condition: true

gpt_checkpoint: gpt.pth
w2v_stat: wav2vec2bert_stats.pt
s2mel_checkpoint: s2mel.pth
emo_matrix: feat2.pt
spk_matrix: feat1.pt
emo_num: [3, 17, 2, 8, 4, 5, 10, 24]
qwen_emo_path: qwen0.6bemo4-merge/
vocoder:
    type: "bigvgan"
    name: "nvidia/bigvgan_v2_22khz_80band_256x"
version: 2.0
"""

HAND_YAML = """\
# YAML 1.1 scalars as PyYAML resolves them
plain: 1e-5          # no dot: a string
dotted: 1.0e-5       # a float
no_sign: 1.0e5       # no exponent sign: a string
hex: 0x10
under: 1_000
octal: 012
sexagesimal: 1:20
answers: [yes, no, on, Off, ~, null, 'yes', "no"]
nested: [[1, 2], [3.5, -.inf], []]
quoted: 'it''s # not a comment'
escaped: "tab\\there \\u00e9"
path: qwen0.6bemo4-merge/
url: http://host:8080/x
empty:
tilde: ~
list:
- a
- 2
-   key: value
    other: [x]
-
  - deep
"""


@pytest.fixture(scope="module")
def written_configs(tmp_path_factory):
    d = tmp_path_factory.mktemp("configs")
    out = {}
    for name, cfg in (("shipped", SHIPPED), ("tiny", tiny_config())):
        p = d / f"{name}.yaml"
        p.write_text(refckpt.to_yaml(refckpt.config_tree(cfg)), encoding="utf-8")
        out[name] = (str(p), cfg)
    for name, text in (("reference", REFERENCE_YAML), ("hand", HAND_YAML)):
        p = d / f"{name}.yaml"
        p.write_text(text, encoding="utf-8")
        out[name] = (str(p), None)
    return out


def _same_value(a, b):
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        return np.isnan(b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_value(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same_value(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", ["shipped", "tiny", "reference", "hand"])
def test_config_reader_equals_pyyaml_and_jax_load_config(written_configs, name):
    path, cfg = written_configs[name]
    with open(path, encoding="utf-8") as f:
        ref = yaml.safe_load(f)
    assert _same_value(yaml_subset.load(path), ref)
    if name == "hand":
        assert ref["plain"] == "1e-5" and ref["dotted"] == 1e-5 and ref["no_sign"] == "1.0e5"
        return
    ours, theirs = tconfig.load_config(path), jconfig.load_config(path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    if cfg is not None:   # the writer's file gives its config back (s2mel's
        # gpt_dim / gpt_proj_dims and the engine knobs are not config.yaml keys)
        want = dataclasses.asdict(cfg)
        got = dataclasses.asdict(ours)
        for d in (want, got):
            for k in ("gpt_dim", "gpt_proj_dims"):
                d["s2mel"].pop(k)
            d.pop("engine")
        assert got == want
    if name == "reference":
        assert ours.qwen_emo_path == "qwen0.6bemo4-merge/" and ours.version == "2.0"
        assert ours.s2mel.preprocess_params.spect_params.fmax is None


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &anchor 2\n", 2), ("a:\n  b: *alias\n", 2), ("a: !!str 1\n", 1),
    ("a: {b: 1}\n", 1), ("a: |\n  text\n", 1), ("a: one\n  two\n", 2), ("? a\n: 1\n", 1),
    ("--- \na: 1\n", 1), ("a: 2024-01-02\n", 1), ("a:\n\tb: 1\n", 2),
    ("a: [1,\n  2]\n", 1), ("a: 'open\n  quote'\n", 1)])
def test_config_reader_refuses_outside_its_subset(tmp_path, text, line):
    p = tmp_path / "c.yaml"
    p.write_text(text, encoding="utf-8")
    with pytest.raises(yaml_subset.YAMLSubsetError, match=f"line {line}:"):
        tconfig.load_config(str(p))


# -- (f) the npz store -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_trees():
    """The port's seeded random weights at the tiny config (JAX layouts)."""
    cfg = tiny_config()
    trees = _np(infer_v2.random_trees(cfg, 3, "cpu"))
    rng = np.random.default_rng(6)
    H = cfg.w2v_bert.hidden_size
    trees["w2v_mean"] = (0.1 * rng.standard_normal(H)).astype(np.float32)
    trees["w2v_std"] = (1.0 + 0.1 * np.abs(rng.standard_normal(H))).astype(np.float32)
    return trees


def test_npz_store_round_trips_between_the_packages(tmp_path, tiny_trees):
    tree = {k: tiny_trees[k] for k in ("gpt", "s2mel", "bigvgan")}
    tree["tuple"] = (np.arange(3), {"x": np.ones(2, np.float32)})
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tckpt.save_params_npz(ours, tree)
    jckpt.save_params_npz(theirs, tree)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files) and "gpt/gpt/h/attn/c_attn/kernel" in a.files
    for path in (ours, theirs):
        assert_same_tree(_np(jckpt.load_params_npz(path, tree)), tree)
        assert_same_tree(tckpt.load_params_npz(path, tree), tree)


def test_convert_model_dir_matches_jax(tmp_path, tiny_trees):
    cfg = tiny_config()
    d = tmp_path / "ref"
    refckpt.write_model_dir(str(d), tiny_trees, cfg, wrapped=False)
    ours = tckpt.convert_model_dir(str(d), str(tmp_path / "port"), cfg=cfg)
    theirs = jckpt.convert_model_dir(str(d), str(tmp_path / "jax"), cfg=cfg)
    assert sorted(ours) == sorted(theirs) == sorted(
        ["gpt", "s2mel", "semantic_codec", "campplus", "bigvgan", "w2vbert"])
    for name in ours:
        with np.load(ours[name]) as a, np.load(theirs[name]) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert np.array_equal(a[k], b[k]), (name, k)


# -- (g) the reference-layout writer -------------------------------------------------------

def _leaf_paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{path}/{i}")
    else:
        yield path, tree


# the weight-normed leaves of the released files, whose fold is not exact
WEIGHT_NORMED = re.compile(r"^/(conv_pre|ups/\d+|resblocks/\d+/convs[12]/\d+|conv_post|"
                           r"cfm/(x_embedder|final_layer/linear|wavenet/layers/\d+/"
                           r"(in_layer|res_skip)|wavenet/cond_layer)|"
                           r"quantizer/\d+/(in_project|out_project))/kernel$")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_writer_round_trips_through_the_jax_converters(tiny_trees, family):
    cfg = tiny_config()
    key, _ = FAMILIES[family]
    convert = {"gpt": lambda sd: jconv.convert_unified_voice(sd, cfg.gpt),
               "s2mel": lambda sd: jconv.convert_s2mel(sd, cfg.s2mel),
               "codec": lambda sd: jconv.convert_repcodec(sd, cfg.semantic_codec),
               "campplus": jconv.convert_campplus,
               "bigvgan": lambda sd: jconv.convert_bigvgan(sd, cfg.bigvgan),
               "w2v": lambda sd: jconv.convert_w2vbert(sd, cfg.w2v_bert)}[key]
    (sd,) = refckpt.state_dicts({key: tiny_trees[key]}, cfg).values()
    back = convert({k: v.numpy() for k, v in sd.items()})
    tree = tiny_trees[key]
    a, b = dict(_leaf_paths(tree)), dict(_leaf_paths(back))
    assert set(a) == set(b)
    folded = 0
    for path, x in a.items():
        y = np.asarray(b[path])
        assert x.shape == y.shape and x.dtype == y.dtype, path
        if WEIGHT_NORMED.match(path):
            folded += 1
            np.testing.assert_array_max_ulp(y, x, maxulp=1)
        else:
            assert np.array_equal(x, y), path
    assert folded > 0 or key in ("gpt", "campplus", "w2v")


def test_writer_match_fold_gives_the_trees_bf16_bits(tmp_path, tiny_trees):
    """With ``match_dtype`` the weight-norm pairs are nudged so that the
    loaded bf16 weights are the tree's own bf16 cast bit for bit."""
    cfg = tiny_config()
    trees = {k: tiny_trees[k] for k in ("s2mel", "codec", "bigvgan")}
    written = refckpt.write_model_dir(str(tmp_path), trees, cfg, match_dtype=torch.bfloat16)
    assert written["nudged"] >= 0
    tts = infer_v2.IndexTTS2(cfg_path=None, model_dir=str(tmp_path), device="cpu",
                             dtype=torch.bfloat16, cfg=cfg)
    for key, attr in (("s2mel", "s2mel_params"), ("codec", "codec_params"),
                      ("bigvgan", "bigvgan_params")):
        assert_same_tree(getattr(tts, attr), to_torch(trees[key], "cpu", torch.bfloat16), key)


class _MetaRng(tnn.InitRng):
    """Shapes only: every draw is a tensor on the meta device."""

    def __init__(self, seed=0, device="meta"):
        self.device = torch.device("meta")

    def normal(self, shape, std=0.02):
        return torch.empty(tuple(shape), device="meta")

    def uniform(self, shape, a, b):
        return torch.empty(tuple(shape), device="meta")


def test_writer_matches_the_manifest_at_the_shipped_config(monkeypatch):
    monkeypatch.setattr(infer_v2.nn, "InitRng", _MetaRng)
    trees = infer_v2.random_trees(SHIPPED, 0, "meta")
    sds = refckpt.state_dicts(trees, SHIPPED)
    for family, (key, _) in FAMILIES.items():
        manifest = _manifest(family)
        allowed = [re.compile(p) for p in ALLOW_UNCONSUMED[family]]

        def kept(keys):
            return {k for k in keys if not any(p.search(k) for p in allowed)}

        sd = sds[key]
        assert kept(sd) == kept(manifest), (family, sorted(kept(sd) ^ kept(manifest))[:10])
        bad = [k for k in kept(sd) if list(sd[k].shape) != manifest[k]]
        assert not bad, (family, bad[:10])


# -- (h) a tiny model directory, the JAX pipeline and the port ------------------------------

def _assets(d):
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    vocab = [w[:i] for w in ["▁HELLO", "▁WORLD", "▁THE", "▁CAT", "▁."]
             for i in range(2, len(w) + 1)] + ["▁", ".", "▁,", "E", "L", "O"]
    seen, score = set(), -1.0
    for w in vocab:
        if w not in seen:
            seen.add(w)
            pieces.append((w, score, 1))
            score -= 1.0
    build_model_file(pieces, os.path.join(d, "bpe.model"))
    sr = 16000
    tt = np.arange(int(0.8 * sr)) / sr
    wav = 0.3 * np.sin(2 * np.pi * 220 * tt) + 0.02 * np.random.default_rng(0).standard_normal(
        tt.size)
    write_wav(os.path.join(d, "prompt.wav"), wav.astype(np.float32), sr)


@pytest.fixture(scope="module")
def flat_dir(tmp_path_factory, tiny_trees):
    d = str(tmp_path_factory.mktemp("tiny_ref_flat"))
    _assets(d)
    refckpt.write_model_dir(d, tiny_trees, tiny_config(), wrapped=False)
    return d


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_tts(flat_dir):
    from indextts_tpu.pipeline.infer_v2 import IndexTTS2

    return IndexTTS2(cfg_path=None, model_dir=flat_dir, cfg=tiny_config(), dtype=jnp.float32,
                     allow_random_init=False)


def _port(model_dir, **kw):
    return infer_v2.IndexTTS2(cfg_path=None, model_dir=model_dir, device="cpu",
                              dtype=torch.float32, cfg=tiny_config(),
                              allow_random_init=False, **kw)


def _port_state(tts) -> dict:
    return {"gpt": tts.gpt_params, "s2mel": tts.s2mel_params, "codec": tts.codec_params,
            "campplus": tts.campplus_params, "bigvgan": tts.bigvgan_params,
            "w2v": tts.w2v_params, "w2v_mean": tts.w2v_mean, "w2v_std": tts.w2v_std,
            "emo_matrix": tts.emo_matrix, "spk_matrix": tts.spk_matrix}


def test_jax_and_port_load_the_same_trees(jax_tts, flat_dir, tiny_trees, one_thread):
    j = jax_tts
    jtrees = jax.device_get({
        "gpt": j.gpt_params, "s2mel": j.s2mel_params, "codec": j.codec_params,
        "campplus": j.campplus_params, "bigvgan": j.bigvgan_params, "w2v": j.w2v_params,
        "w2v_mean": j.w2v_mean, "w2v_std": j.w2v_std})
    tts = _port(flat_dir)
    assert [r["family"] for r in tts.load_report] == [
        "gpt", "s2mel", "codec", "campplus", "bigvgan", "w2v", "w2v_stat", "matrices"]
    state = _port_state(tts)
    for key, tree in jtrees.items():
        assert_same_tree(state[key], to_torch(tree, "cpu", torch.float32), key)
    for key in ("emo_matrix", "spk_matrix"):
        assert_same_tree(state[key], [torch.tensor(np.asarray(m)) for m in getattr(j, key)])
    # and the trees the directory was written from, but for the weight fold
    assert_same_tree(state["gpt"], to_torch(tiny_trees["gpt"], "cpu", torch.float32))


def test_wrapped_files_load_to_the_same_trees(tmp_path, flat_dir, tiny_trees, one_thread):
    d = str(tmp_path / "wrapped")
    refckpt.write_model_dir(d, tiny_trees, tiny_config(), wrapped=True)
    assert set(torch.load(os.path.join(d, "s2mel.pth"), weights_only=False)) == {"net"}
    assert set(torch.load(os.path.join(d, "hf_cache/bigvgan/bigvgan_generator.pt"),
                          weights_only=False)) == {"generator"}
    wrapped, flat = _port_state(_port(d)), _port_state(_port(flat_dir))
    assert_same_tree(wrapped, flat)


def test_greedy_request_from_loaded_weights_matches_jax(jax_tts, flat_dir, one_thread):
    prompt = os.path.join(flat_dir, "prompt.wav")
    j = jax_tts
    j.capture = []
    j._rng = jax.random.PRNGKey(0)
    kw = dict(do_sample=False, num_beams=3, max_mel_tokens=16, min_new_tokens=4)
    j.infer(spk_audio_prompt=prompt, text=TEXT, output_path=None, **kw)
    c = j.capture.pop()
    j.capture = None
    clen = int(c["code_lens"][0])

    from test_torch_pipeline import _jax_float_wav

    from indextts_tpu_torch.engine.beam import generate_beam

    tts = _port(flat_dir)
    spk = tts._prepare_spk_prompt(prompt)
    emo = tts._prepare_emo_cond(prompt)
    text_ids, tlen = c["text_ids"], int(c["text_lens"][0])
    cond_latents, emovec, embeds, mask = tts.prefix(spk, emo, 1.0, text_ids, tlen)
    codes, lens = generate_beam(tts.gpt_params, tts.cfg.gpt, tts.gpt_dims, embeds, mask,
                                tts.generator, 16, tts._sampling(kw), torch.float32)
    assert int(lens[0]) == clen
    np.testing.assert_array_equal(codes.numpy()[0, :clen], c["codes"][0, :clen])
    T = c["prompt_bucket"] + c["mel_bucket"]
    z = np.array(jax.random.normal(c["rng"], (1, T, 80), dtype=jnp.float32))
    wav = tts.codes_to_wav(spk, cond_latents, emovec, text_ids, tlen, codes, clen,
                           z=torch.as_tensor(z))
    ref = _jax_float_wav(j, c)
    assert wav.shape == ref.shape
    rel = np.linalg.norm(wav - ref) / np.linalg.norm(ref)
    assert rel <= 1e-3, rel


def test_bigvgan_config_json_sets_the_architecture_it_is_read_at(tmp_path, tiny_trees):
    """config.json gives one resblock kernel (3,) where the passed config has
    (3, 7): the port converts the weights at config.json's architecture and
    runs at it; the JAX loader converts at the passed config and raises."""
    base = tiny_config()
    two = dataclasses.replace(base, bigvgan=dataclasses.replace(
        base.bigvgan, resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3), (1, 3))))
    d = str(tmp_path)
    _assets(d)
    refckpt.write_model_dir(d, tiny_trees, base, wrapped=False)    # config.json: (3,)
    tts = infer_v2.IndexTTS2(cfg_path=None, model_dir=d, device="cpu", dtype=torch.float32,
                             cfg=two, allow_random_init=False)
    assert tts.cfg.bigvgan.resblock_kernel_sizes == (3,)
    want = dict(_leaf_paths(to_torch(tiny_trees["bigvgan"], "cpu", torch.float32)))
    got = dict(_leaf_paths(tts.bigvgan_params))
    assert set(got) == set(want)
    for path, w in want.items():       # the weight fold: within 1 f32 ulp
        np.testing.assert_array_max_ulp(got[path].numpy(), w.numpy(), maxulp=1)
    mel = torch.randn(1, 8, 80, generator=torch.Generator().manual_seed(0))
    from indextts_tpu_torch.models.vocoder.bigvgan import bigvgan_forward

    with torch.inference_mode():
        wav = bigvgan_forward(tts.bigvgan_params, tts.cfg.bigvgan, mel, torch.tensor([8]))
    assert wav.shape[-1] == 8 * 256 and bool(torch.isfinite(wav).all())
    from indextts_tpu.pipeline.infer_v2 import IndexTTS2 as JaxIndexTTS2

    with pytest.raises(KeyError, match="resblocks"):
        JaxIndexTTS2(cfg_path=None, model_dir=d, cfg=two, dtype=jnp.float32)
