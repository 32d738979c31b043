"""PyTorch port, the int8 serving decode: the JAX package's int8 path and the
port's on the same inputs (CPU; the JAX kernels in interpret mode, the
port's kernels through their plain twins).

Inputs come from seeded numpy generators; torch runs one intra-op thread.
Tolerances, each with its reason:
- quantization: the same bytes (both compute max|w|/127 and round half to
  even in f32 on the same bf16 weights);
- int8 `dense`: within 1 bf16 ulp (the f32 sums run in another order); an
  ulp is taken at |value|, but at no less than 1e-3 of the output's largest
  magnitude: a value that the bias cancels to near zero keeps the absolute
  error of the f32 sum it came from;
- K7a / K7b twins: rel-L2 <= 1e-5 (f32 results; the products are exact,
  only the order of the f32 sums differs);
- K1 twin: hidden state within atol = rtol = 2e-2 (bf16 probabilities taken
  against per-chunk maxima here, per-block running maxima on the TPU); the
  k/v rows of layer 0, whose inputs are the same on both sides, within 1
  bf16 ulp; those of every layer within the hidden-state tolerance;
- ancestry: bit-identical to the physically gathered cache;
- greedy int8 beams: token-equal with the JAX engine on its mask-based XLA
  step (K1 attends exactly the kv_valid slots, as that step does; the JAX
  fused kernel's window, pos + 1 - popcount(kv_valid), differs across the
  decode's unwritten slot P + 1: `tests/test_torch_window.py`).
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, "tests")

from test_pipeline_e2e import tiny_config  # noqa: E402

from indextts_tpu.config import ConditionModuleConfig, GPTConfig  # noqa: E402
from indextts_tpu.models.gpt import gpt2 as jgpt2  # noqa: E402
from indextts_tpu.nn import InitRng  # noqa: E402
from indextts_tpu_torch.utils.jax_params import to_torch  # noqa: E402

DIMS = jgpt2.GPT2Dims(2, 640, 10)
B, S, POS = 3, 128, 70


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a) -> np.ndarray:
    """Values rounded to bf16, as a JAX-side numpy bf16 array."""
    return np.asarray(jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16))


def _t(a) -> torch.Tensor:
    """A bf16 numpy array as a torch bf16 tensor (same values)."""
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def _within_ulp(got: torch.Tensor, ref: np.ndarray, ulps: float = 1.0) -> None:
    g = got.float().numpy()
    r = np.asarray(ref, np.float32)
    mag = np.maximum(np.abs(r), 1e-3 * np.abs(r).max())
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(g - r) <= ulps * ulp), np.max(np.abs(g - r) / ulp)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _gpt2_bf16(dims, seed=0):
    """JAX GPT-2 tree cast to bf16 (the JAX pipeline's order: cast, then
    quantize), with random LayerNorm and bias values so every term counts."""
    rng = np.random.default_rng(seed + 1)
    p = jax.tree_util.tree_map(_bf16, jgpt2.init_gpt2(InitRng(seed), dims))
    h = p["h"]
    for ln in ("ln_1", "ln_2"):
        h[ln]["weight"] = _bf16(rng.normal(1, 0.1, h[ln]["weight"].shape))
        h[ln]["bias"] = _bf16(rng.normal(0, 0.1, h[ln]["bias"].shape))
    for grp in ("attn", "mlp"):
        for layer in h[grp].values():
            layer["bias"] = _bf16(rng.normal(0, 0.1, layer["bias"].shape))
    return p


def test_quantize_gpt2_int8_bytes_equal_jax_and_bridge_round_trip():
    from indextts_tpu_torch.models.gpt.gpt2 import quantize_gpt2_int8

    p = _gpt2_bf16(jgpt2.GPT2Dims(2, 64, 4))
    via_jax = to_torch(jgpt2.quantize_gpt2_int8(p), "cpu", torch.bfloat16)
    via_port = quantize_gpt2_int8(to_torch(p, "cpu", torch.bfloat16))
    for lj, lt in zip(via_jax["h"], via_port["h"]):
        for grp in ("attn", "mlp"):
            for name, dj in lj[grp].items():
                dt = lt[grp][name]
                assert dj["q"].dtype == torch.int8 and dj["scale"].dtype == torch.float32
                assert dj["q"].shape == dt["q"].shape and dj["scale"].shape == dt["scale"].shape
                assert torch.equal(dj["q"], dt["q"])
                assert torch.equal(dj["scale"], dt["scale"])
                assert torch.equal(dj["bias"], dt["bias"])
    jq = jgpt2.quantize_gpt2_int8(p)["h"]["attn"]["c_attn"]
    np.testing.assert_array_equal(via_port["h"][1]["attn"]["c_attn"]["q"].numpy(),
                                  np.asarray(jq["q"][1]).T)


def test_int8_dense_within_one_ulp_of_jax():
    from indextts_tpu import nn as jnn
    from indextts_tpu_torch import nn as tnn

    rng = np.random.default_rng(2)
    layer = {"kernel": _bf16(rng.normal(0, 0.05, (640, 1920))),
             "bias": _bf16(rng.normal(0, 0.1, 1920))}
    x = _bf16(rng.normal(0, 1, (5, 640)))
    ref = np.asarray(jnn.dense(jnn.quantize_dense_int8(layer), jnp.asarray(x)), np.float32)
    got = tnn.dense(tnn.quantize_dense_int8(to_torch(layer, "cpu", torch.bfloat16)), _t(x))
    assert got.dtype == torch.bfloat16
    _within_ulp(got, ref)


def _int8_operands(M=3, K=640, N=1280, seed=3):
    rng = np.random.default_rng(seed)
    return (_bf16(rng.normal(0, 1, (M, K))), rng.integers(-127, 128, (K, N)).astype(np.int8),
            rng.integers(-127, 128, (N, K)).astype(np.int8),
            (rng.uniform(0.5, 1.5, N) / 127 / 30).astype(np.float32),
            _bf16(rng.normal(0, 0.5, N)))


def test_k7a_int8_matvec_twin_matches_jax_kernel():
    from indextts_tpu.ops.pallas.int8_matmul import int8_matvec as jax_matvec
    from indextts_tpu_torch.ops.int8 import int8_matvec

    x, w1, _, _, _ = _int8_operands()
    ref = np.asarray(jax_matvec(jnp.asarray(x), jnp.asarray(w1), block_n=640, interpret=True))
    got = int8_matvec(_t(x), torch.tensor(w1.T.copy()))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel_l2(got.numpy(), ref) <= 1e-5


def test_k7b_int8_mlp_twin_matches_jax_kernel():
    from indextts_tpu.ops.pallas.int8_matmul import int8_mlp as jax_mlp
    from indextts_tpu_torch.ops.int8 import int8_mlp

    x, w1, w2, s1, b1 = _int8_operands()
    ref = np.asarray(jax_mlp(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(s1[None]),
                             jnp.asarray(np.asarray(b1, np.float32)[None]), jnp.asarray(w2),
                             block_k2=640, interpret=True))
    got = int8_mlp(_t(x), torch.tensor(w1.T.copy()), torch.tensor(s1), _t(b1),
                   torch.tensor(w2.T.copy()))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel_l2(got.numpy(), ref) <= 1e-5


@pytest.fixture(scope="module")
def k1_case():
    """Int8 GPT-2 (2 x 640, 10 heads), B=3 rows with staggered starts 0, 1, 2
    over a 128-slot cache at pos 70, a random in-group ancestry map."""
    rng = np.random.default_rng(4)
    params = jgpt2.quantize_gpt2_int8(_gpt2_bf16(DIMS))
    kv = rng.normal(0, 1, (2, DIMS.layers, B, S, DIMS.dim))
    kv[:, :, :, POS:] = 0.0
    mask = np.zeros((B, S), bool)
    for b in range(B):
        mask[b, b:POS + 1] = True
    return dict(params=params, kv=_bf16(kv), mask=mask, x=_bf16(rng.normal(0, 1, (B, DIMS.dim))),
                anc=rng.integers(0, B, (B, S)).astype(np.int32))


def _port_step(case, kv, anc=None, group=1, mask=None):
    from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims
    from indextts_tpu_torch.ops.decode_step import fused_decode_step

    cache = {"k": _t(kv[0]), "v": _t(kv[1])}
    h = fused_decode_step(to_torch(case["params"], "cpu", torch.bfloat16), _t(case["x"]),
                          GPT2Dims(DIMS.layers, DIMS.dim, DIMS.heads), POS, cache,
                          torch.tensor(case["mask"] if mask is None else mask),
                          None if anc is None else torch.tensor(anc), group)
    return h, cache


@pytest.mark.parametrize("group", [1, 3])
def test_k1_fused_decode_step_twin_matches_jax_kernel(k1_case, group):
    from indextts_tpu.engine.beam import _anc_bs, _anc_flat
    from indextts_tpu.ops.pallas.decode_step import fused_decode_step as jax_step

    c = k1_case
    anc = c["anc"] if group > 1 else None
    ref_h, ref_cache = jax_step(
        c["params"], jnp.asarray(c["x"]), DIMS, jnp.asarray(POS, jnp.int32),
        {"k": jnp.asarray(c["kv"][0]), "v": jnp.asarray(c["kv"][1])}, jnp.asarray(c["mask"]),
        interpret=True, group=group,
        anc=None if anc is None else _anc_flat(jnp.asarray(anc), S, _anc_bs(B)))
    h, cache = _port_step(c, c["kv"], anc, group)
    np.testing.assert_allclose(h.float().numpy(), np.asarray(ref_h, np.float32),
                               atol=2e-2, rtol=2e-2)
    for key in ("k", "v"):
        ref_rows = np.asarray(ref_cache[key][:, :, POS], np.float32)
        _within_ulp(cache[key][0, :, POS], ref_rows[0])
        np.testing.assert_allclose(cache[key][:, :, POS].float().numpy(), ref_rows,
                                   atol=2e-2, rtol=2e-2)
        # nothing else of the cache moved
        assert torch.equal(cache[key][:, :, :POS], _t(c["kv"][0 if key == "k" else 1])[:, :, :POS])


def test_k1_twin_with_ancestry_bit_identical_to_gathered_cache(k1_case):
    """The gather route gathers kv_valid with the cache (`engine/beam.py`):
    the ancestry map reads both from the physical row."""
    c = k1_case
    idx = (np.arange(B)[:, None] // B) * B + c["anc"]
    gathered = c["kv"][:, :, idx, np.arange(S), :]
    h_anc, cache_anc = _port_step(c, c["kv"], c["anc"], group=B)
    h_gat, cache_gat = _port_step(c, gathered, mask=c["mask"][idx, np.arange(S)])
    assert torch.equal(h_anc, h_gat)
    for key in ("k", "v"):
        assert torch.equal(cache_anc[key][:, :, POS], cache_gat[key][:, :, POS])


def _beam_cfg():
    """The tiny GPT of tests/test_decode_kernel.py's beam tests."""
    cond = ConditionModuleConfig(output_size=32, linear_units=48, attention_heads=2,
                                 num_blocks=1, input_layer="linear", perceiver_mult=2)
    return GPTConfig(layers=2, model_dim=640, heads=10, max_text_tokens=30, max_mel_tokens=60,
                     number_text_tokens=40, number_mel_codes=50, start_mel_token=48,
                     stop_mel_token=49, condition_module=cond, emo_condition_module=cond)


def test_generate_beam_int8_greedy_token_equal_jax_and_anc_equals_gather(monkeypatch):
    from indextts_tpu.engine import beam as jbeam
    from indextts_tpu.engine.decode import SamplingConfig as JSampling
    from indextts_tpu.models.gpt.unified_voice import init_unified_voice
    from indextts_tpu_torch.engine import beam as tbeam
    from indextts_tpu_torch.engine.decode import SamplingConfig
    from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims, gpt2_decode_step

    cfg = _beam_cfg()
    dims = jgpt2.GPT2Dims(cfg.layers, cfg.model_dim, cfg.heads)
    params = jax.tree_util.tree_map(_bf16, init_unified_voice(InitRng(0), cfg))
    params["gpt"] = jgpt2.quantize_gpt2_int8(params["gpt"])
    rng = np.random.default_rng(3)
    nb, P, steps = 2, 7, 8
    prefix = _bf16(rng.normal(0, 0.3, (nb, P, cfg.model_dim)))
    mask = np.ones((nb, P), bool)
    mask[0, 0] = False
    # the reference is JAX's mask-based XLA step on the int8 tree (its fused
    # kernel's window differs across the decode's unwritten slot P + 1)
    monkeypatch.setenv("INDEXTTS_FUSED_DECODE", "0")
    jbeam.generate_beam.clear_cache()
    ref_toks, ref_lens = jbeam.generate_beam(
        params, cfg, dims, jnp.asarray(prefix), jnp.asarray(mask), jax.random.PRNGKey(5),
        max_new_tokens=steps, sampling=JSampling(do_sample=False, num_beams=3))
    jbeam.generate_beam.clear_cache()
    assert jbeam.last_use_anc is False

    tp = to_torch(params, "cpu", torch.bfloat16)
    tdims = GPT2Dims(cfg.layers, cfg.model_dim, cfg.heads)
    samp = SamplingConfig(do_sample=False, num_beams=3)
    calls, gathers = gpt2_decode_step.calls, tbeam.kv_gathers
    runs = {}
    for gather in (False, True):
        runs[gather] = tbeam.generate_beam(tp, cfg, tdims, _t(prefix), torch.tensor(mask),
                                           torch.Generator().manual_seed(0), steps, samp,
                                           cache_gather=gather)
        assert tbeam.last_use_anc is (not gather)
    assert gpt2_decode_step.calls == calls                 # int8 never takes the bf16 step
    assert tbeam.kv_gathers == gathers + steps             # only the gather route gathers
    toks, lens = runs[False]
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_array_equal(lens, np.asarray(ref_lens))
    assert torch.equal(runs[True][0], toks)
    np.testing.assert_array_equal(runs[True][1], lens)


def test_int8_pipeline_answers_a_request(tmp_path):
    from indextts_tpu.text.spm import build_model_file
    from indextts_tpu.utils.wav_io import write_wav
    from indextts_tpu_torch.engine import beam as tbeam
    from indextts_tpu_torch.models.gpt.gpt2 import gpt2_decode_step
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    vocab = [w[:i] for w in ["▁HELLO", "▁WORLD", "▁."] for i in range(2, len(w) + 1)]
    for i, w in enumerate(vocab + ["▁", ".", "▁,", "E", "L", "O"]):
        pieces.append((w, -1.0 - i, 1))
    build_model_file(pieces, str(tmp_path / "bpe.model"))
    tt = np.arange(int(0.8 * 16000)) / 16000
    write_wav(str(tmp_path / "prompt.wav"), (0.3 * np.sin(2 * np.pi * 220 * tt)).astype(np.float32),
              16000)
    tts = IndexTTS2(cfg_path=None, model_dir=str(tmp_path), device="cpu", cfg=tiny_config(),
                    quantization="int8")
    assert tts.gpt_params["gpt"]["h"][0]["mlp"]["c_fc"]["q"].dtype == torch.int8
    calls, gathers = gpt2_decode_step.calls, tbeam.kv_gathers
    sr, wav = tts.infer(spk_audio_prompt=str(tmp_path / "prompt.wav"), text="hello world .",
                        output_path=None, max_mel_tokens=12, min_new_tokens=11)
    clen = tts.last_stage_times["codes"]
    assert clen == 12 and sr == 22050
    assert wav.shape == (int(np.float32(clen) * np.float32(1.72)) * 256, 1)
    assert np.all(np.isfinite(wav))
    assert tbeam.last_use_anc is True
    assert (gpt2_decode_step.calls, tbeam.kv_gathers) == (calls, gathers)


def test_int8_pipeline_refuses_other_dtypes_and_quantizations(tmp_path):
    """Once a refusal of every quantization at float32; now the documented
    f32 route: the tree is cast to f32, then quantized (as the JAX pipeline
    does), and every decode step takes the plain step ("plain": K1 stages
    2-byte elements), answering a request with a finite wav."""
    from indextts_tpu.text.spm import build_model_file
    from indextts_tpu.utils.wav_io import write_wav
    from indextts_tpu_torch.engine.decode import decode_route
    from indextts_tpu_torch.models.gpt.gpt2 import gpt2_decode_step
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    vocab = [w[:i] for w in ["▁HELLO", "▁WORLD", "▁."] for i in range(2, len(w) + 1)]
    for i, w in enumerate(vocab + ["▁", ".", "▁,", "E", "L", "O"]):
        pieces.append((w, -1.0 - i, 1))
    build_model_file(pieces, str(tmp_path / "bpe.model"))
    tt = np.arange(int(0.8 * 16000)) / 16000
    write_wav(str(tmp_path / "prompt.wav"), (0.3 * np.sin(2 * np.pi * 220 * tt)).astype(np.float32),
              16000)
    for quantization in ("int8", "int8kv", "int4", "int4kv"):
        tts = IndexTTS2(cfg_path=None, model_dir=str(tmp_path), device="cpu", cfg=tiny_config(),
                        quantization=quantization, dtype=torch.float32)
        gpt = tts.gpt_params["gpt"]
        assert gpt["h"][0]["mlp"]["c_fc"]["bias"].dtype == torch.float32
        assert decode_route(tts.gpt_params, 3, quantization.endswith("kv")) == "plain"
        calls = gpt2_decode_step.calls
        sr, wav = tts.infer(spk_audio_prompt=str(tmp_path / "prompt.wav"), text="hello world .",
                            output_path=None, max_mel_tokens=6, min_new_tokens=5)
        assert tts.last_stage_times["codes"] == 6 and sr == 22050
        assert np.all(np.isfinite(wav)) and wav.shape[0] > 0
        assert gpt2_decode_step.calls > calls, quantization


def test_int8_decode_route_takes_the_plain_step_past_k1(k1_case):
    """Up to 24 rows K1; past them the plain step on the int8 weights, as
    the JAX gate routes them (`tests/test_torch_modes.py` holds a 27-row
    decode there against JAX)."""
    from indextts_tpu_torch.engine.decode import decode_route

    params = {"gpt": to_torch(k1_case["params"], "cpu", torch.bfloat16)}
    assert decode_route(params, 24) == "fused"
    assert decode_route(params, 25) == decode_route(params, 25, kv_quant=True) == "plain"
    assert decode_route({"gpt": to_torch(_gpt2_bf16(jgpt2.GPT2Dims(1, 64, 4)), "cpu")},
                        99) == "plain"
