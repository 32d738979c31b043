"""PyTorch port: the pipeline's constructor and `infer` behave as the JAX
`IndexTTS2` does where the port differed, and K2's rope pass composes into
K2's attention.

- the JAX constructor's keyword set is accepted (the CUDA-era knobs are
  ignored); ``use_fp16=True`` raises NotImplementedError (the port's
  kernels take bf16); ``allow_random_init=False`` without a GPT checkpoint
  raises FileNotFoundError, as the JAX pipeline does;
- every checkpoint file the JAX pipeline would read, present in the model
  directory or named through ``aux_paths``, is refused (the port does not
  load checkpoints yet and must not serve random weights in their place);
- a decode that stops at ``max_mel_tokens`` warns with the JAX pipeline's
  RuntimeWarning;
- `rope_qk_plain` composed with `packed_pair_attention_plain` is
  `attention_rope_plain` exactly, and matches the JAX
  `packed_pair_attention_rope` (the Pallas kernel in interpret mode) within
  `tests/test_torch_tiers.py`'s bf16 attention tolerance (rel-L2 1e-2).
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

from indextts_tpu.ops.pallas import attn as jattn  # noqa: E402
from indextts_tpu.text.spm import build_model_file  # noqa: E402
from indextts_tpu.utils.wav_io import write_wav  # noqa: E402
from indextts_tpu_torch.ops import attn  # noqa: E402
from indextts_tpu_torch.ops.rope import precompute_freqs_cis  # noqa: E402
from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2, checkpoint_files  # noqa: E402

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


def test_use_fp16_raises(model_dir):
    with pytest.raises(NotImplementedError, match="use_fp16"):
        _tts(model_dir, use_fp16=True)


def test_no_random_init_without_checkpoint_raises(model_dir):
    with pytest.raises(FileNotFoundError, match="gpt.pth"):
        _tts(model_dir, allow_random_init=False)


@pytest.mark.parametrize("name", AUX_FILES)
def test_present_checkpoint_file_is_refused(tmp_path, name):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"")
    assert str(path) in checkpoint_files(tiny_config(), str(tmp_path))
    with pytest.raises(NotImplementedError, match="loading checkpoint"):
        _tts(str(tmp_path))


@pytest.mark.parametrize("key,name", [("semantic_codec", "codec.safetensors"),
                                      ("campplus", "campplus.bin"),
                                      ("bigvgan", "bigvgan_dir/pytorch_model.bin"),
                                      ("w2v_bert", "w2v_dir/model.safetensors")])
def test_checkpoint_named_in_aux_paths_is_refused(model_dir, tmp_path, key, name):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"")
    where = str(path.parent) if key in ("bigvgan", "w2v_bert") else str(path)
    with pytest.raises(NotImplementedError, match="loading checkpoint"):
        _tts(model_dir, aux_paths={key: where})


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
