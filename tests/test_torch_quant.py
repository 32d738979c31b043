"""PyTorch port, the memory-knob quantizations (int8kv, int4, int4kv): the JAX
package's int4 weights, flat int8 KV cache and fused decode step against the
port's on the same inputs (CPU; the JAX kernel K1 in interpret mode, the
port's kernels through their plain twins).

Inputs come from seeded numpy generators; torch runs one intra-op thread.
Tolerances, each with its reason:
- int4 quantization and `kv_quantize_flat`: the same bytes (both take
  max|x| in f32, divide in f32 and round half to even; the int8 cache's
  scale is rounded to bf16 before the division on both sides);
- int4 `dense`: within 1 bf16 ulp (the f32 sums run in another order), the
  ulp floored at 1e-3 of the output's largest magnitude as in
  `test_torch_int8.py`;
- the int8 prefill cache: in layer 0, the same bytes where the bf16 k/v
  both sides quantize are equal, and within 1 int8 count and 1 bf16 ulp of
  scale where an f32 summation order moved a k/v value by an ulp; every
  layer, dequantized, within atol = rtol = 2e-2 (the bf16 activations drift
  apart over the layers);
- K1 twin with the int8 cache and / or int4 weights: hidden state within
  atol = rtol = 2e-2 (bf16 probabilities taken against per-chunk maxima
  here, per-block running maxima on the TPU); layer 0's written rows, whose
  bf16 k/v differ by at most 1 ulp between the sides, within 1 int8 count
  and their scale rows within 1 bf16 ulp (bf16 rows within 1 ulp); every
  layer's rows, dequantized, within the hidden-state tolerance;
- int4 against int8 on the unpacked values, and the int8 cache under
  ancestry against the gathered cache: bit-identical;
- greedy beams: token-equal with the JAX engine on its mask-based XLA step
  (see `tests/test_torch_window.py` for the fused kernel's window), and the
  ancestry route's
  hidden states bit-identical to the gather route's at every step.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, "tests")

from test_pipeline_e2e import tiny_config  # noqa: E402
from test_torch_int8 import (DIMS, POS, B, S, _beam_cfg, _bf16, _gpt2_bf16, _t,  # noqa: E402
                             _within_ulp)

from indextts_tpu import nn as jnn  # noqa: E402
from indextts_tpu.models.gpt import gpt2 as jgpt2  # noqa: E402
from indextts_tpu.nn import InitRng  # noqa: E402
from indextts_tpu_torch import nn as tnn  # noqa: E402
from indextts_tpu_torch.models.gpt import gpt2 as tgpt2  # noqa: E402
from indextts_tpu_torch.utils.jax_params import to_torch  # noqa: E402

TDIMS = tgpt2.GPT2Dims(DIMS.layers, DIMS.dim, DIMS.heads)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _within_counts(got: torch.Tensor, ref, counts: int = 1) -> None:
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(ref).astype(np.int32))
    assert diff.max() <= counts, diff.max()


# ---------------------------------------------------------------------------
# int4 weights: bytes, unpacking, dense
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [DIMS, jgpt2.GPT2Dims(1, 64, 4)], ids=["h320", "one-group"])
def test_quantize_gpt2_int4_bytes_equal_jax(dims):
    p = _gpt2_bf16(dims)
    jq = jgpt2.quantize_gpt2_int4(p)
    via_jax = to_torch(jq, "cpu", torch.bfloat16)
    via_port = tgpt2.quantize_gpt2_int4(to_torch(p, "cpu", torch.bfloat16))
    assert tgpt2.is_quantized(via_port) and tgpt2.is_quantized(via_jax)
    for lj, lt in zip(via_jax["h"], via_port["h"]):
        for grp in ("attn", "mlp"):
            for name, dj in lj[grp].items():
                dt = lt[grp][name]
                assert dj["q4"].dtype == torch.int8 and dj["scale"].dtype == torch.float32
                assert dt["q4"].shape == (dt["scale"].shape[0], dj["q4"].shape[1])
                assert torch.equal(dj["q4"], dt["q4"])
                assert torch.equal(dj["scale"], dt["scale"])
                assert torch.equal(dj["bias"], dt["bias"])
    np.testing.assert_array_equal(via_port["h"][0]["mlp"]["c_proj"]["q4"].numpy(),
                                  np.asarray(jq["h"]["mlp"]["c_proj"]["q4"][0]).T)
    # both nibbles carry negative values
    v = via_port["h"][0]["attn"]["c_attn"]["q4"]
    assert bool(((v << 4) >> 4).lt(0).any()) and bool((v >> 4).lt(0).any())


@pytest.mark.parametrize("N,K", [(48, 1280), (40, 2560), (24, 64), (16, 1000)],
                         ids=["h320", "h320-4groups", "one-group", "one-group-ragged"])
def test_unpack_int4_round_trips(N, K):
    rng = np.random.default_rng(K)
    w = rng.normal(0, 0.5, (N, K)).astype(np.float32)
    p4 = tnn.quantize_dense_int4({"weight": torch.tensor(w)})
    assert p4["q4"].shape == (N, K // 2) and p4["q4"].dtype == torch.int8
    vals = tnn.unpack_int4(p4["q4"])
    scale = np.maximum(np.abs(w).max(1, keepdims=True), 1e-8) / 7.0
    np.testing.assert_array_equal(vals.numpy(), np.clip(np.round(w / scale), -7, 7))
    # the JAX package's unpacking of its own bytes, transposed
    j4 = jnn.quantize_dense_int4({"kernel": w.T})
    np.testing.assert_array_equal(p4["q4"].numpy(), np.asarray(j4["q4"]).T)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jnn.unpack_int4(j4["q4"])).T)


def test_int4_dense_within_one_ulp_of_jax():
    rng = np.random.default_rng(5)
    layer = {"kernel": _bf16(rng.normal(0, 0.05, (640, 1920))),
             "bias": _bf16(rng.normal(0, 0.1, 1920))}
    x = _bf16(rng.normal(0, 1, (5, 640)))
    ref = np.asarray(jnn.dense(jnn.quantize_dense_int4(layer), jnp.asarray(x)), np.float32)
    got = tnn.dense(tnn.quantize_dense_int4(to_torch(layer, "cpu", torch.bfloat16)), _t(x))
    assert got.dtype == torch.bfloat16
    _within_ulp(got, ref)


# ---------------------------------------------------------------------------
# the flat int8 KV cache
# ---------------------------------------------------------------------------

def test_kv_quantize_flat_bytes_equal_jax_and_dequant_round_trip():
    rng = np.random.default_rng(6)
    k, v = (rng.normal(0, s, (3, 7, 640)) for s in (1.0, 3.0))
    k[1, 2, 64:128] = 0                          # an all-zero head: scale 0
    k, v = _bf16(k), _bf16(v)
    jk, jv, js = jgpt2.kv_quantize_flat(jnp.asarray(k), jnp.asarray(v), 10)
    tk, tv, ts = tgpt2.kv_quantize_flat(_t(k), _t(v), 10)
    assert (tk.dtype, tv.dtype, ts.dtype) == (torch.int8, torch.int8, torch.bfloat16)
    assert ts.shape == (3, 7, 256)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(_np(ts), np.asarray(js, np.float32))
    for q8, off, ref in ((tk, 0, jk), (tv, 128, jv)):
        got = tgpt2._kv_dequant_flat(q8, ts, 10, off, torch.float32)
        want = jgpt2._kv_dequant_flat(ref, js, 10, off, jnp.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_int8_cache_equals_jax():
    rng = np.random.default_rng(7)
    p = _gpt2_bf16(DIMS)
    Bp, T, Sp = 2, 9, 16
    x = _bf16(rng.normal(0, 1, (Bp, T, DIMS.dim)))
    mask = np.ones((Bp, T), bool)
    mask[1, :2] = False
    jcache = jgpt2.init_kv_cache(DIMS, Bp, Sp, quantized=True, flat=True)
    jh, jcache = jgpt2.gpt2_prefill(p, jnp.asarray(x), DIMS, jnp.asarray(mask), jcache)
    tcache = tgpt2.init_kv_cache(TDIMS, Bp, Sp, quantized=True)
    th = tgpt2.gpt2_prefill(to_torch(p, "cpu", torch.bfloat16), _t(x), TDIMS,
                            torch.tensor(mask), tcache)
    np.testing.assert_allclose(_np(th), np.asarray(jh, np.float32), atol=2e-2, rtol=2e-2)
    for li in range(DIMS.layers):                # every layer, dequantized
        for key in ("k", "v"):
            ref = {"k": torch.tensor(np.asarray(jcache["k"])),
                   "v": torch.tensor(np.asarray(jcache["v"])),
                   "kvs": _t(np.asarray(jcache["kvs"], np.float32))}
            np.testing.assert_allclose(_dequant(tcache, li, key), _dequant(ref, li, key),
                                       atol=2e-2, rtol=2e-2)
    # layer 0, whose bf16 k/v differ by at most 1 ulp: within 1 count and 1 ulp
    _within_counts(tcache["k"][0], np.asarray(jcache["k"][0]))
    _within_counts(tcache["v"][0], np.asarray(jcache["v"][0]))
    _within_ulp(tcache["kvs"][0], np.asarray(jcache["kvs"][0], np.float32))
    # layer 0: the same bytes for every (row, position, head) whose bf16 k/v
    # (the layer's LayerNorm + qkv projection on both sides) are equal
    p0 = jax.tree_util.tree_map(lambda a: a[0], p["h"])
    jqkv = np.asarray(jnn.dense(p0["attn"]["c_attn"],
                                jnn.layer_norm(p0["ln_1"], jnp.asarray(x))), np.float32)
    tp0 = to_torch(p, "cpu", torch.bfloat16)["h"][0]
    tqkv = _np(tnn.dense(tp0["attn"]["c_attn"], tnn.layer_norm(tp0["ln_1"], _t(x))))
    H, Dh = DIMS.heads, DIMS.dim // DIMS.heads
    for i, key in enumerate(("k", "v")):
        cols = slice((i + 1) * DIMS.dim, (i + 2) * DIMS.dim)
        same = (jqkv[..., cols] == tqkv[..., cols]).reshape(Bp, T, H, Dh).all(-1)
        assert same.mean() > 0.5
        got = tcache[key][0, :, :T].numpy().reshape(Bp, T, H, Dh)
        ref = np.asarray(jcache[key][0, :, :T]).reshape(Bp, T, H, Dh)
        np.testing.assert_array_equal(got[same], ref[same])
        lanes = np.arange(H) + 128 * i
        np.testing.assert_array_equal(_np(tcache["kvs"][0, :, :T])[..., lanes][same],
                                      np.asarray(jcache["kvs"][0, :, :T], np.float32)
                                      [..., lanes][same])
    assert not tcache["k"][:, :, T:].any() and not tcache["kvs"][:, :, T:].any()


# ---------------------------------------------------------------------------
# K1's KVQ and W4 variants: the twin against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------

VARIANTS = {"kvq": (False, True), "w4": (True, False), "w4-kvq": (True, True)}


@pytest.fixture(scope="module")
def quant_case():
    """GPT-2 (2 x 640, 10 heads) in int8 and int4, B=3 rows with staggered
    starts 0, 1, 2 over a 128-slot cache at pos 70 (bf16 and its int8
    quantization, zeros from pos on), a random in-group ancestry map."""
    rng = np.random.default_rng(8)
    p = _gpt2_bf16(DIMS, seed=3)
    kv = rng.normal(0, 1, (2, DIMS.layers, B, S, DIMS.dim))
    kv[:, :, :, POS:] = 0.0
    kv = _bf16(kv)
    kq, vq, kvs = jgpt2.kv_quantize_flat(jnp.asarray(kv[0]), jnp.asarray(kv[1]), DIMS.heads)
    mask = np.zeros((B, S), bool)
    for b in range(B):
        mask[b, b:POS + 1] = True
    return dict(params={False: jgpt2.quantize_gpt2_int8(p), True: jgpt2.quantize_gpt2_int4(p)},
                kv=kv, qcache=dict(k=np.asarray(kq), v=np.asarray(vq),
                                   kvs=np.asarray(kvs, np.float32)),
                mask=mask, x=_bf16(rng.normal(0, 1, (B, DIMS.dim))),
                anc=rng.integers(0, B, (B, S)).astype(np.int32))


def _jax_cache(c, kvq: bool) -> dict:
    if kvq:
        q = c["qcache"]
        return {"k": jnp.asarray(q["k"]), "v": jnp.asarray(q["v"]),
                "kvs": jnp.asarray(q["kvs"], jnp.bfloat16)}
    return {"k": jnp.asarray(c["kv"][0]), "v": jnp.asarray(c["kv"][1])}


def _port_cache(c, kvq: bool, rows=None) -> dict:
    """The case's cache as torch tensors; ``rows`` (B, S) gathers each
    (row, position) from the given physical row."""
    src = ({"k": c["qcache"]["k"], "v": c["qcache"]["v"], "kvs": c["qcache"]["kvs"]} if kvq
           else {"k": c["kv"][0], "v": c["kv"][1]})
    out = {}
    for key, a in src.items():
        if rows is not None:
            a = a[:, rows, np.arange(S), :]
        out[key] = torch.tensor(a.copy()) if a.dtype == np.int8 else _t(a)
    return out


def _port_step(c, w4: bool, cache: dict, anc=None, group: int = 1, mask=None):
    from indextts_tpu_torch.ops.decode_step import fused_decode_step

    return fused_decode_step(to_torch(c["params"][w4], "cpu", torch.bfloat16), _t(c["x"]),
                             TDIMS, POS, cache, torch.tensor(c["mask"] if mask is None else mask),
                             None if anc is None else torch.tensor(anc), group)


def _dequant(cache: dict, li: int, key: str) -> np.ndarray:
    off = 0 if key == "k" else 128
    q8, kvs = cache[key][li], cache["kvs"][li]
    return tgpt2._kv_dequant_flat(q8, kvs, DIMS.heads, off, torch.float32).numpy()


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_k1_variant_twin_matches_jax_kernel(quant_case, variant, group):
    from indextts_tpu.engine.beam import _anc_bs, _anc_flat
    from indextts_tpu.ops.pallas.decode_step import fused_decode_step as jax_step

    c = quant_case
    w4, kvq = VARIANTS[variant]
    anc = c["anc"] if group > 1 else None
    ref_h, ref_cache = jax_step(
        c["params"][w4], jnp.asarray(c["x"]), DIMS, jnp.asarray(POS, jnp.int32),
        _jax_cache(c, kvq), jnp.asarray(c["mask"]), interpret=True, group=group,
        anc=None if anc is None else _anc_flat(jnp.asarray(anc), S, _anc_bs(B)))
    cache = _port_cache(c, kvq)
    before = {key: t.clone() for key, t in cache.items()}
    h = _port_step(c, w4, cache, anc, group)
    np.testing.assert_allclose(_np(h), np.asarray(ref_h, np.float32), atol=2e-2, rtol=2e-2)
    ref = {key: np.asarray(t) for key, t in ref_cache.items()}
    if kvq:
        _within_counts(cache["k"][0, :, POS], ref["k"][0, :, POS])
        _within_counts(cache["v"][0, :, POS], ref["v"][0, :, POS])
        _within_ulp(cache["kvs"][0, :, POS], ref["kvs"][0, :, POS].astype(np.float32))
        ref_port = {key: torch.tensor(np.asarray(ref_cache[key])) if key != "kvs"
                    else _t(np.asarray(ref_cache[key], np.float32)) for key in ref}
        for li in range(DIMS.layers):
            for key in ("k", "v"):
                np.testing.assert_allclose(_dequant(cache, li, key)[:, POS],
                                           _dequant(ref_port, li, key)[:, POS],
                                           atol=2e-2, rtol=2e-2)
    else:
        for key in ("k", "v"):
            _within_ulp(cache[key][0, :, POS], ref[key][0, :, POS].astype(np.float32))
            np.testing.assert_allclose(_np(cache[key][:, :, POS]),
                                       ref[key][:, :, POS].astype(np.float32),
                                       atol=2e-2, rtol=2e-2)
    for key, t in cache.items():              # nothing else of the cache moved
        assert torch.equal(t[:, :, :POS], before[key][:, :, :POS])
        assert torch.equal(t[:, :, POS + 1:], before[key][:, :, POS + 1:])


@pytest.mark.parametrize("kvq", [False, True], ids=["bf16-cache", "int8-cache"])
def test_int4_twin_bit_identical_to_int8_twin_on_unpacked_values(quant_case, kvq):
    from indextts_tpu_torch.ops.decode_step import fused_decode_step

    c = quant_case
    params8 = to_torch(c["params"][True], "cpu", torch.bfloat16)
    for lp in params8["h"]:
        for grp in ("attn", "mlp"):
            for d in lp[grp].values():
                d["q"] = tnn.unpack_int4(d.pop("q4"))
    caches = [_port_cache(c, kvq) for _ in range(2)]
    h4 = _port_step(c, True, caches[0], c["anc"], B)
    h8 = fused_decode_step(params8, _t(c["x"]), TDIMS, POS, caches[1], torch.tensor(c["mask"]),
                           torch.tensor(c["anc"]), B)
    assert torch.equal(h4, h8)
    for key in caches[0]:
        assert torch.equal(caches[0][key], caches[1][key])


@pytest.mark.parametrize("w4", [False, True], ids=["int8", "int4"])
def test_kvq_twin_with_ancestry_bit_identical_to_gathered_cache(quant_case, w4):
    """The gather route gathers kv_valid with the cache (`engine/beam.py`):
    the ancestry map reads both from the physical row."""
    c = quant_case
    rows = (np.arange(B)[:, None] // B) * B + c["anc"]
    cache_anc, cache_gat = _port_cache(c, True), _port_cache(c, True, rows)
    h_anc = _port_step(c, w4, cache_anc, c["anc"], B)
    h_gat = _port_step(c, w4, cache_gat, mask=c["mask"][rows, np.arange(S)])
    assert torch.equal(h_anc, h_gat)
    for key in ("k", "v", "kvs"):
        assert torch.equal(cache_anc[key][:, :, POS], cache_gat[key][:, :, POS])


def test_k1_refuses_other_cache_layouts(quant_case):
    from indextts_tpu_torch.ops.decode_step import fused_decode_step

    c = quant_case
    params = to_torch(c["params"][False], "cpu", torch.bfloat16)
    q = _port_cache(c, True)
    for cache in ({"k": q["k"], "v": q["v"]},                             # no scale rows
                  {"k": q["k"].to(torch.bfloat16), "v": q["v"].to(torch.bfloat16),
                   "kvs": q["kvs"]}):                                    # bf16 with scales
        with pytest.raises(ValueError, match="cache"):
            fused_decode_step(params, _t(c["x"]), TDIMS, POS, cache, torch.tensor(c["mask"]))


# ---------------------------------------------------------------------------
# the engine and the pipeline
# ---------------------------------------------------------------------------

QUANTIZATIONS = {"int8kv": ("int8", True), "int4": ("int4", False), "int4kv": ("int4", True)}


@pytest.mark.parametrize("quantization", list(QUANTIZATIONS))
def test_generate_beam_greedy_token_equal_jax_and_anc_equals_gather(monkeypatch, quantization):
    from indextts_tpu.engine import beam as jbeam
    from indextts_tpu.engine.decode import SamplingConfig as JSampling
    from indextts_tpu.models.gpt.unified_voice import init_unified_voice
    from indextts_tpu_torch.engine import beam as tbeam
    from indextts_tpu_torch.engine.decode import SamplingConfig
    from indextts_tpu_torch.models.gpt.gpt2 import gpt2_decode_step

    weights, kv_quant = QUANTIZATIONS[quantization]
    cfg = _beam_cfg()
    dims = jgpt2.GPT2Dims(cfg.layers, cfg.model_dim, cfg.heads)
    params = jax.tree_util.tree_map(_bf16, init_unified_voice(InitRng(0), cfg))
    quantize = jgpt2.quantize_gpt2_int8 if weights == "int8" else jgpt2.quantize_gpt2_int4
    params["gpt"] = quantize(params["gpt"])
    rng = np.random.default_rng(3)
    nb, P, steps = 2, 7, 8
    prefix = _bf16(rng.normal(0, 0.3, (nb, P, cfg.model_dim)))
    mask = np.ones((nb, P), bool)
    mask[0, 0] = False
    # the reference is JAX's mask-based XLA step on the quantized tree (its
    # fused kernel's window differs across the decode's unwritten slot P + 1)
    monkeypatch.setenv("INDEXTTS_FUSED_DECODE", "0")
    jbeam.generate_beam.clear_cache()
    ref_toks, ref_lens = jbeam.generate_beam(
        params, cfg, dims, jnp.asarray(prefix), jnp.asarray(mask), jax.random.PRNGKey(5),
        max_new_tokens=steps, sampling=JSampling(do_sample=False, num_beams=3,
                                                 kv_quant=kv_quant))
    jbeam.generate_beam.clear_cache()
    assert jbeam.last_use_anc is False

    tp = to_torch(params, "cpu", torch.bfloat16)
    tdims = tgpt2.GPT2Dims(cfg.layers, cfg.model_dim, cfg.heads)
    samp = SamplingConfig(do_sample=False, num_beams=3, kv_quant=kv_quant)
    calls, gathers = gpt2_decode_step.calls, tbeam.kv_gathers
    runs, hidden = {}, {False: [], True: []}
    for gather in (False, True):
        def record(args, h, seen=hidden[gather]):
            assert ("kvs" in args["kv_cache"]) is kv_quant
            seen.append(h.clone())
        runs[gather] = tbeam.generate_beam(tp, cfg, tdims, _t(prefix), torch.tensor(mask),
                                           torch.Generator().manual_seed(0), steps, samp,
                                           step_check=record, cache_gather=gather)
        assert tbeam.last_use_anc is (not gather)
    assert gpt2_decode_step.calls == calls                 # never the bf16 step
    assert tbeam.kv_gathers == gathers + steps             # only the gather route gathers
    toks, lens = runs[False]
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_array_equal(lens, np.asarray(ref_lens))
    assert torch.equal(runs[True][0], toks)
    np.testing.assert_array_equal(runs[True][1], lens)
    # the gather route reorders every cache tensor, the scale rows included:
    # each step's hidden state equals the ancestry route's bit for bit
    assert len(hidden[False]) == len(hidden[True]) == steps - 1
    for a, g in zip(hidden[False], hidden[True]):
        assert torch.equal(a, g)


def test_decode_route_takes_int4_and_the_plain_step_for_the_int8_cache_at_float_weights():
    """int4 up to 24 rows on K1, past them and for the int8 cache at float
    weights the plain step (the JAX package's XLA step)."""
    from indextts_tpu_torch.engine.decode import decode_route

    p = _gpt2_bf16(jgpt2.GPT2Dims(1, 64, 4))
    int4 = {"gpt": tgpt2.quantize_gpt2_int4(to_torch(p, "cpu", torch.bfloat16))}
    assert decode_route(int4, 24) == decode_route(int4, 24, kv_quant=True) == "fused"
    assert decode_route(int4, 25, kv_quant=True) == "plain"
    assert decode_route({"gpt": to_torch(p, "cpu")}, 3, kv_quant=True) == "plain"


@pytest.fixture(scope="module")
def tiny_assets(tmp_path_factory):
    from indextts_tpu.text.spm import build_model_file
    from indextts_tpu.utils.wav_io import write_wav

    d = tmp_path_factory.mktemp("quant_pipeline")
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    vocab = [w[:i] for w in ["▁HELLO", "▁WORLD", "▁."] for i in range(2, len(w) + 1)]
    for i, w in enumerate(vocab + ["▁", ".", "▁,", "E", "L", "O"]):
        pieces.append((w, -1.0 - i, 1))
    build_model_file(pieces, str(d / "bpe.model"))
    tt = np.arange(int(0.8 * 16000)) / 16000
    write_wav(str(d / "prompt.wav"), (0.3 * np.sin(2 * np.pi * 220 * tt)).astype(np.float32),
              16000)
    return d


@pytest.mark.parametrize("quantization", list(QUANTIZATIONS))
def test_quantized_pipeline_answers_a_request(tiny_assets, quantization):
    from indextts_tpu_torch.engine import beam as tbeam
    from indextts_tpu_torch.models.gpt.gpt2 import gpt2_decode_step
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    weights, kv_quant = QUANTIZATIONS[quantization]
    tts = IndexTTS2(cfg_path=None, model_dir=str(tiny_assets), device="cpu",
                    cfg=tiny_config(), quantization=quantization)
    c_fc = tts.gpt_params["gpt"]["h"][0]["mlp"]["c_fc"]
    assert ("q4" if weights == "int4" else "q") in c_fc
    seen = []
    tts.decode_check = lambda args, h: seen.append("kvs" in args["kv_cache"])
    calls, gathers = gpt2_decode_step.calls, tbeam.kv_gathers
    sr, wav = tts.infer(spk_audio_prompt=str(tiny_assets / "prompt.wav"),
                        text="hello world .", output_path=None, max_mel_tokens=12,
                        min_new_tokens=11)
    clen = tts.last_stage_times["codes"]
    assert clen == 12 and sr == 22050
    assert wav.shape == (int(np.float32(clen) * np.float32(1.72)) * 256, 1)
    assert np.all(np.isfinite(wav))
    assert tbeam.last_use_anc is True
    assert (gpt2_decode_step.calls, tbeam.kv_gathers) == (calls, gathers)
    assert seen == [kv_quant] * (clen - 1)
