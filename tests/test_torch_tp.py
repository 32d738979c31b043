"""PyTorch port, the tp=2 int8 serving decode (kernel K6): the JAX package's
int8 path and the port's tensor-parallel one on the same inputs (CPU; the
port's kernels through their plain twins, both shards on the CPU).

The port is held against the JAX package's single-chip `fused_decode_step`
(interpret mode), the parity target of the JAX package's own tp test
(`tests/test_decode_tp.py`): the tp split moves only where the two
row-parallel contractions are cut, f32 partials summed lo + hi. This file
never calls the JAX `tp_decode_step` or any shard_map: its remote copies,
emulated by the Pallas interpreter on the CPU, take minutes a case.

Inputs come from seeded numpy generators at `GPT2Dims(2, 640, 10)` (5 heads
a shard); torch runs one intra-op thread. Tolerances, each with its reason:
- the shard split: the same bytes as numpy slices of the JAX tree in its
  tp-kernel layout (`gpt_tp_layout(quantize_gpt2_int8(...))`);
- the K6 twin against JAX: the hidden state after ln_f within atol = rtol =
  2e-2, the port's K1 tolerance (the JAX package's tp test allows 5e-2
  against the same target); layer 0's written k/v rows bit-identical to the
  port's K1 twin (the same contraction per head slice); every cache slot but
  pos unchanged in both shards;
- ancestry: bit-identical to the physically gathered cache;
- the reduce twin: lo + hi, the scale after the sum, both shards' outputs
  identical bit for bit;
- the tp prefill against JAX `gpt2_prefill`: hidden states and the cache
  within atol = rtol = 2e-2 (the int8 prefill tolerance of
  `tests/test_torch_quant.py`);
- greedy decodes on the tp route: token-equal with the port's unsharded int8
  route; 27 rows (past K6's 24) on the plain step of the shards, token-equal
  with the unsharded int8 pipeline's plain step;
- the mesh combinations the port used to refuse (dp and sp meshes, the
  pipeline on a tp mesh for int4, int8kv, bf16 and int8 without the switch,
  tp trees of float and int4 weights, the int8 cache, 25 rows) now build and
  take the plain step (the JAX package's GSPMD decode); naming a card the
  machine lacks still raises (tests/test_torch_mesh.py holds these routes
  against the JAX package).
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, "tests")

from test_pipeline_e2e import tiny_config  # noqa: E402
from test_torch_int8 import _beam_cfg, _bf16, _gpt2_bf16, _t  # noqa: E402

from indextts_tpu.models.gpt import gpt2 as jgpt2  # noqa: E402
from indextts_tpu.nn import InitRng  # noqa: E402
from indextts_tpu_torch.models.gpt import gpt2 as tgpt2  # noqa: E402
from indextts_tpu_torch.parallel.mesh import make_mesh, shard_gpt2_tp  # noqa: E402
from indextts_tpu_torch.utils.jax_params import to_torch  # noqa: E402

DIMS = jgpt2.GPT2Dims(2, 640, 10)
TDIMS = tgpt2.GPT2Dims(2, 640, 10)
S = 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu", "cpu"])


@pytest.fixture(scope="module")
def int8_tree():
    """The JAX int8 GPT-2 tree (cast to bf16, then quantized) and the port's."""
    p = jgpt2.quantize_gpt2_int8(_gpt2_bf16(DIMS))
    return p, to_torch(p, "cpu", torch.bfloat16)


def _shard_cache(kv: np.ndarray) -> dict:
    """A (2, L, B, S, D) bf16 numpy cache -> the port's per-shard cache."""
    Dl = DIMS.dim // 2
    return {"shards": [{k: _t(kv[i][..., t * Dl:(t + 1) * Dl]).contiguous()
                        for i, k in enumerate("kv")} for t in range(2)]}


def _case(B: int, pos: int, seed: int = 5):
    """B rows with staggered starts b over a 128-slot cache filled below pos
    (the JAX package's `tests/test_decode_kernel.py::_setup` layout)."""
    rng = np.random.default_rng(seed)
    kv = rng.normal(0, 1, (2, DIMS.layers, B, S, DIMS.dim))
    kv[:, :, :, pos:] = 0.0
    mask = np.zeros((B, S), bool)
    for b in range(B):
        mask[b, b:pos] = True
        mask[b, pos] = True
    return _bf16(kv), mask, _bf16(rng.normal(0, 1, (B, DIMS.dim)))


def test_shard_split_equals_slices_of_the_jax_tp_layout(int8_tree, mesh):
    from indextts_tpu.ops.pallas.decode_step_tp import gpt_tp_layout

    jtree, ttree = int8_tree
    jtp = jax.tree_util.tree_map(np.asarray, gpt_tp_layout(jtree))
    # the bridge takes the tp-kernel layout back to the canonical tree
    via_tp = to_torch(jtp, "cpu", torch.bfloat16)
    for lt, lc in zip(via_tp["h"], ttree["h"]):
        for grp in ("attn", "mlp"):
            for name, d in lt[grp].items():
                assert all(torch.equal(d[k], lc[grp][name][k]) for k in d)
    sharded = shard_gpt2_tp(via_tp, mesh)
    assert sharded["mesh"] is mesh and len(sharded["shards"]) == 2
    D, Dl, Fl = DIMS.dim, DIMS.dim // 2, 2 * DIMS.dim
    h = jtp["h"]
    for t in range(2):
        ds, fs = slice(t * Dl, (t + 1) * Dl), slice(t * Fl, (t + 1) * Fl)
        for li, lp in enumerate(sharded["shards"][t]):
            ca, cp = lp["attn"]["c_attn"], lp["attn"]["c_proj"]
            fc, mp = lp["mlp"]["c_fc"], lp["mlp"]["c_proj"]
            a = h["attn"]
            np.testing.assert_array_equal(ca["q"].numpy(),
                                          a["c_attn"]["q"][li][:, :, ds].reshape(D, 3 * Dl).T)
            for k in ("scale", "bias"):
                np.testing.assert_array_equal(ca[k].float().numpy(),
                                              np.asarray(a["c_attn"][k][li][:, ds], np.float32)
                                              .reshape(-1))
            np.testing.assert_array_equal(cp["q"].numpy(), a["c_proj"]["q"][li][ds].T)
            np.testing.assert_array_equal(fc["q"].numpy(), h["mlp"]["c_fc"]["q"][li][:, fs].T)
            np.testing.assert_array_equal(mp["q"].numpy(), h["mlp"]["c_proj"]["q"][li][fs].T)
            for got, grp, name, cut in ((fc, "mlp", "c_fc", fs), (cp, "attn", "c_proj", None),
                                        (mp, "mlp", "c_proj", None)):
                for k in ("scale", "bias"):
                    ref = np.asarray(h[grp][name][k][li], np.float32).reshape(-1)
                    np.testing.assert_array_equal(got[k].float().numpy(),
                                                  ref if cut is None else ref[cut])
            for ln in ("ln_1", "ln_2"):
                for k in ("weight", "bias"):
                    np.testing.assert_array_equal(lp[ln][k].float().numpy(),
                                                  np.asarray(h[ln][k][li], np.float32))


@pytest.mark.parametrize("B,pos", [(2, 70), (4, 0)])
def test_k6_twin_matches_the_jax_single_chip_kernel(int8_tree, mesh, B, pos):
    from indextts_tpu.ops.pallas.decode_step import fused_decode_step as jax_step
    from indextts_tpu_torch import nn
    from indextts_tpu_torch.ops.decode_step import fused_decode_step
    from indextts_tpu_torch.ops.decode_step_tp import fused_decode_step_tp

    jtree, ttree = int8_tree
    kv, mask, x = _case(B, pos)
    ref_h, _ = jax_step(jtree, jnp.asarray(x), DIMS, jnp.asarray(pos, jnp.int32),
                        {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1])}, jnp.asarray(mask),
                        interpret=True)
    tp = shard_gpt2_tp(ttree, mesh)
    cache = _shard_cache(kv)
    h = nn.layer_norm(tp["ln_f"], fused_decode_step_tp(tp, _t(x), TDIMS, pos, cache,
                                                       torch.tensor(mask)))
    np.testing.assert_allclose(h.float().numpy(), np.asarray(ref_h, np.float32),
                               atol=2e-2, rtol=2e-2)
    k1 = {"k": _t(kv[0]), "v": _t(kv[1])}
    fused_decode_step(ttree, _t(x), TDIMS, pos, k1, torch.tensor(mask))
    keep = np.arange(S) != pos
    for i, key in enumerate("kv"):
        rows = torch.cat([c[key][0, :, pos] for c in cache["shards"]], -1)
        assert torch.equal(rows, k1[key][0, :, pos])      # layer 0, the same contraction
        for t, c in enumerate(cache["shards"]):
            Dl = DIMS.dim // 2
            assert torch.equal(c[key][:, :, keep], _t(kv[i][..., t * Dl:(t + 1) * Dl])[:, :, keep])


def test_k6_twin_with_ancestry_bit_identical_to_gathered_cache(int8_tree, mesh):
    from indextts_tpu_torch.ops.decode_step_tp import fused_decode_step_tp

    K, B, pos = 3, 12, 70
    kv, mask, x = _case(B, pos, seed=6)
    mask[:] = mask[np.arange(B) // K * K]            # a group shares its prefix
    anc = np.random.default_rng(7).integers(0, K, (B, S)).astype(np.int32)
    idx = (np.arange(B)[:, None] // K) * K + anc
    gathered = kv[:, :, idx, np.arange(S), :]
    tp = shard_gpt2_tp(int8_tree[1], mesh)
    caches = [_shard_cache(kv), _shard_cache(gathered)]
    h_anc = fused_decode_step_tp(tp, _t(x), TDIMS, pos, caches[0], torch.tensor(mask),
                                 torch.tensor(anc), K)
    h_gat = fused_decode_step_tp(tp, _t(x), TDIMS, pos, caches[1], torch.tensor(mask))
    assert torch.equal(h_anc, h_gat)
    for a, g in zip(*(c["shards"] for c in caches)):
        for key in "kv":
            assert torch.equal(a[key][:, :, pos], g[key][:, :, pos])


def test_tp_allreduce_twin_sums_lo_hi_then_scales_and_both_shards_agree():
    from indextts_tpu_torch.ops.decode_step_tp import tp_allreduce, tp_allreduce_plain

    rng = np.random.default_rng(8)
    M, N = 3, 1280
    # partials that nearly cancel: rounding each one's scaled value first
    # loses what their sum keeps
    p0 = torch.tensor(rng.normal(0, 1e9, (M, N)), dtype=torch.float32)
    p1 = -p0 + torch.tensor(rng.normal(0, 3e3, (M, N)), dtype=torch.float32)
    scale = torch.tensor(rng.uniform(0.5, 1.5, N) / 127 / 30, dtype=torch.float32)
    bias, res = _t(_bf16(rng.normal(0, 0.5, N))), _t(_bf16(rng.normal(0, 1, (M, N))))
    before = tp_allreduce.launches
    out0 = tp_allreduce(p0, p1, scale, bias, res, 0)
    out1 = tp_allreduce(p1, p0, scale, bias, res, 1)
    assert tp_allreduce.launches == before                # CPU tensors run the twin
    assert out0.dtype == torch.bfloat16 and torch.equal(out0, out1)
    want = res + ((p0 + p1) * scale + bias.float()).to(torch.bfloat16)
    assert torch.equal(out0, want) and torch.equal(tp_allreduce_plain(p0, p1, scale, bias, res, 0),
                                                   want)
    # the scale applies after the reduce: scaling each partial first differs
    scaled_first = res + (p0 * scale + p1 * scale + bias.float()).to(torch.bfloat16)
    assert not torch.equal(out0, scaled_first)


def test_replicated_inputs_keep_a_copy_a_device_and_the_step_copies_none():
    """`Replicated` (the engines' kv_valid and ancestry map on the tp route)
    keeps one copy a distinct device, co-located ranks sharing it, and
    applies indexing and assignment to every copy; `per_rank` hands each
    rank its copy and refuses a tensor on another rank's device. A second
    device is stood in for by "meta", which carries shapes only."""
    from indextts_tpu_torch.ops.decode_step_tp import per_rank
    from indextts_tpu_torch.parallel.mesh import Mesh, Replicated

    cpu, meta = torch.device("cpu"), torch.device("meta")
    t = torch.arange(12).reshape(3, 4)
    one = Replicated.of(t, Mesh((cpu, cpu)))
    assert list(one.copies) == [cpu] and one.on(cpu) is t
    assert all(r is t for r in per_rank(one, (cpu, cpu)) + per_rank(t, (cpu, cpu)))
    two = Replicated.of(t.clone(), Mesh((cpu, meta)))
    assert set(two.copies) == {cpu, meta} and two.on(meta).device == meta
    two[:, 1] = torch.tensor([7, 8, 9])
    g = two[torch.tensor([2, 0, 1])]
    g[:, 3] = Replicated.of(torch.tensor([-1, -2, -3]), Mesh((cpu, meta)))
    g = g.map(lambda b: b * 10)
    assert torch.equal(g.on(cpu), 10 * torch.tensor([[8, 9, 10, -1], [0, 7, 2, -2],
                                                     [4, 8, 6, -3]]))
    assert g.on(meta).shape == (3, 4) and g.on(meta).device == meta
    assert per_rank(None, (cpu, meta)) == [None, None]
    assert [r.device for r in per_rank(g, (cpu, meta))] == [cpu, meta]
    with pytest.raises(ValueError, match="Replicated"):
        per_rank(t, (cpu, meta))


def test_tp_prefill_and_forward_match_jax(int8_tree, mesh):
    jtree, ttree = int8_tree
    rng = np.random.default_rng(9)
    Bp, T, Sp = 2, 9, 16
    x = _bf16(rng.normal(0, 1, (Bp, T, DIMS.dim)))
    mask = np.ones((Bp, T), bool)
    mask[1, :2] = False
    jcache = jgpt2.init_kv_cache(DIMS, Bp, Sp, jnp.bfloat16, flat=True)
    jh, jcache = jgpt2.gpt2_prefill(jtree, jnp.asarray(x), DIMS, jnp.asarray(mask), jcache)
    tp = shard_gpt2_tp(ttree, mesh)
    cache = tgpt2.init_kv_cache(TDIMS, Bp, Sp, mesh=mesh)
    assert [tuple(c["k"].shape) for c in cache["shards"]] == [(2, Bp, Sp, 320)] * 2
    th = tgpt2.gpt2_prefill(tp, _t(x), TDIMS, torch.tensor(mask), cache)
    np.testing.assert_allclose(th.float().numpy(), np.asarray(jh, np.float32),
                               atol=2e-2, rtol=2e-2)
    for key in "kv":
        got = torch.cat([c[key] for c in cache["shards"]], -1).float().numpy()
        np.testing.assert_allclose(got, np.asarray(jcache[key], np.float32), atol=2e-2,
                                   rtol=2e-2)
    # the teacher-forced pass is the same forward
    assert torch.equal(tgpt2.gpt2_forward(tp, _t(x), TDIMS, torch.tensor(mask)), th)


@pytest.fixture(scope="module")
def uv_int8():
    """The tiny UnifiedVoice of the int8 beam tests, int8 GPT-2, bridged."""
    from indextts_tpu.models.gpt.unified_voice import init_unified_voice

    cfg = _beam_cfg()
    params = jax.tree_util.tree_map(_bf16, init_unified_voice(InitRng(0), cfg))
    params["gpt"] = jgpt2.quantize_gpt2_int8(params["gpt"])
    rng = np.random.default_rng(3)
    prefix = _bf16(rng.normal(0, 0.3, (2, 7, cfg.model_dim)))
    mask = np.ones((2, 7), bool)
    mask[0, 0] = False
    return cfg, to_torch(params, "cpu", torch.bfloat16), _t(prefix), torch.tensor(mask)


def test_greedy_beams_on_the_tp_route_token_equal_the_unsharded_route(uv_int8, mesh):
    from indextts_tpu_torch.engine import beam
    from indextts_tpu_torch.engine.decode import SamplingConfig

    cfg, params, prefix, mask = uv_int8
    tp = {**params, "gpt": shard_gpt2_tp(params["gpt"], mesh)}
    samp = SamplingConfig(do_sample=False, num_beams=3)
    runs, gathers = {}, beam.kv_gathers
    for name, p, gather in (("int8", params, False), ("tp", tp, False), ("tp gather", tp, True)):
        runs[name] = beam.generate_beam(p, cfg, TDIMS, prefix, mask,
                                        torch.Generator().manual_seed(0), 8, samp,
                                        cache_gather=gather)
        assert beam.last_use_anc is (not gather)
    assert beam.kv_gathers == gathers + 8               # only the gather route gathers
    for name in ("tp", "tp gather"):
        assert torch.equal(runs[name][0], runs["int8"][0])
        np.testing.assert_array_equal(runs[name][1], runs["int8"][1])


def test_greedy_adaptive_decode_on_the_tp_route_token_equal_the_unsharded_route(uv_int8, mesh):
    from indextts_tpu_torch.engine import decode

    cfg, params, prefix, mask = uv_int8
    tp = {**params, "gpt": shard_gpt2_tp(params["gpt"], mesh)}
    samp = decode.SamplingConfig(do_sample=False, num_beams=1, min_new_tokens=11)
    runs = {}
    for name, p in (("int8", params), ("tp", tp)):
        growths = decode.span_growths
        runs[name] = decode.generate_adaptive(p, cfg, TDIMS, prefix, mask,
                                              torch.Generator().manual_seed(0), 12, samp,
                                              spans=(4, 8))
        assert decode.span_growths == growths + 2 and decode.last_route == (
            "fused" if name == "int8" else "tp")
    assert torch.equal(runs["tp"][0], runs["int8"][0])
    np.testing.assert_array_equal(runs["tp"][1], runs["int8"][1])


@pytest.fixture(scope="module")
def tiny_assets(tmp_path_factory):
    from indextts_tpu.text.spm import build_model_file
    from indextts_tpu.utils.wav_io import write_wav

    d = tmp_path_factory.mktemp("tp_assets")
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    vocab = [w[:i] for w in ["▁HELLO", "▁WORLD", "▁."] for i in range(2, len(w) + 1)]
    for i, w in enumerate(vocab + ["▁", ".", "▁,", "E", "L", "O"]):
        pieces.append((w, -1.0 - i, 1))
    build_model_file(pieces, str(d / "bpe.model"))
    tt = np.arange(int(0.8 * 16000)) / 16000
    write_wav(str(d / "prompt.wav"), (0.3 * np.sin(2 * np.pi * 220 * tt)).astype(np.float32),
              16000)
    return d


@pytest.fixture(scope="module")
def tp_tts(tiny_assets, mesh):
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("INDEXTTS_TP_DECODE", "kernel")
        return IndexTTS2(cfg_path=None, model_dir=str(tiny_assets), cfg=tiny_config(),
                         quantization="int8", mesh=mesh)


@pytest.mark.parametrize("num_beams", [3, 1])
def test_tiny_pipeline_on_a_cpu_mesh_answers_a_request(tp_tts, tiny_assets, num_beams):
    from indextts_tpu_torch.engine import beam, decode
    from indextts_tpu_torch.models.gpt.gpt2 import gpt2_decode_step

    assert tp_tts.device == torch.device("cpu") and "shards" in tp_tts.gpt_params["gpt"]
    calls = gpt2_decode_step.calls
    beam.last_use_anc = decode.last_route = None
    sr, wav = tp_tts.infer(spk_audio_prompt=str(tiny_assets / "prompt.wav"),
                           text="hello world .", output_path=None, num_beams=num_beams,
                           max_mel_tokens=12, min_new_tokens=11)
    clen = tp_tts.last_stage_times["codes"]
    assert clen == 12 and sr == 22050
    assert wav.shape == (int(np.float32(clen) * np.float32(1.72)) * 256, 1)
    assert np.all(np.isfinite(wav))
    assert gpt2_decode_step.calls == calls
    if num_beams > 1:
        assert beam.last_use_anc is True and decode.last_route is None
    else:
        assert beam.last_use_anc is None and decode.last_route == "tp"


@pytest.fixture(scope="module")
def int8_tts(tiny_assets):
    """The unsharded int8 pipeline with `tp_tts`'s weights (the same seed)."""
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    return IndexTTS2(cfg_path=None, model_dir=str(tiny_assets), cfg=tiny_config(),
                     device="cpu", quantization="int8")


def _recorded_request(tts, monkeypatch, **kw):
    """One greedy request; returns (its output, the prefix rows of each
    `generate_beam` call, the codes and lengths of each `codes_to_wav`)."""
    from indextts_tpu_torch.pipeline import infer_v2 as iv2

    chunks, synth = [], []
    orig_beam, orig_synth = iv2.generate_beam, tts.codes_to_wav

    def beam_rows(params, cfg, dims, embeds, *args, **kwargs):
        chunks.append(embeds.shape[0])
        return orig_beam(params, cfg, dims, embeds, *args, **kwargs)

    def record(*args, **kwargs):
        synth.append((args[5].clone(), np.asarray(args[6])))
        return orig_synth(*args, **kwargs)

    monkeypatch.setattr(iv2, "generate_beam", beam_rows)
    monkeypatch.setattr(tts, "codes_to_wav", record)
    tts.generator.manual_seed(0)
    try:
        return tts.infer(**kw), chunks, synth
    finally:
        monkeypatch.undo()


def test_long_form_request_on_a_cpu_mesh_equals_the_unsharded_route(tp_tts, int8_tts,
                                                                     tiny_assets, monkeypatch):
    """A greedy 4-segment request (3, 4, 3 and 3 text tokens) at num_beams=2
    on the tp mesh: the segments decode as one batch of 8 rows (no row chunks
    on a tp mesh), token-equal
    with the unsharded int8 port, and the batched synthesis gives its wav's
    shape."""
    from indextts_tpu_torch.engine import beam

    kw = dict(spk_audio_prompt=str(tiny_assets / "prompt.wav"),
              text="hello world . hello . world . hello world . hello world .", output_path=None,
              num_beams=2, do_sample=False, max_mel_tokens=8, min_new_tokens=3,
              max_text_tokens_per_segment=4)
    runs = {name: _recorded_request(tts, monkeypatch, **kw)
            for name, tts in (("tp", tp_tts), ("int8", int8_tts))}
    assert "shards" in tp_tts.gpt_params["gpt"] and beam.last_use_anc is True
    for name, ((sr, wav), chunks, synth) in runs.items():
        assert chunks == [4] and len(synth) == 1, (name, chunks, len(synth))
        assert sr == 22050 and np.all(np.isfinite(wav))
    (_, wav_tp), _, ((codes_tp, clens_tp),) = runs["tp"]
    (_, wav_1), _, ((codes_1, clens_1),) = runs["int8"]
    np.testing.assert_array_equal(clens_tp, clens_1)
    for b, n in enumerate(clens_1):
        assert torch.equal(codes_tp[b, :n], codes_1[b, :n]), b
    assert wav_tp.shape == wav_1.shape


def test_tp_long_form_of_more_than_24_rows_raises(tp_tts, int8_tts, tiny_assets, monkeypatch):
    """9 segments at num_beams=3 are 27 decode rows: one batch under the
    mesh, which kernel K6 does not take, so every step is the plain one on
    the shards (the JAX package's GSPMD decode; it used to raise). Token-equal
    with the unsharded int8 port decoding the 27 rows at once on its plain
    step (MAX_ROWS raised to 27, so one chunk)."""
    from indextts_tpu_torch.engine import decode
    from indextts_tpu_torch.models.gpt.gpt2 import gpt2_decode_step
    from indextts_tpu_torch.pipeline import infer_v2 as iv2

    kw = dict(spk_audio_prompt=str(tiny_assets / "prompt.wav"), text="hello world . " * 9,
              output_path=None, num_beams=3, do_sample=False, max_mel_tokens=8,
              min_new_tokens=3, max_text_tokens_per_segment=4)
    assert decode.decode_route(tp_tts.gpt_params, 27) == "plain"
    calls = gpt2_decode_step.calls
    tp_run = _recorded_request(tp_tts, monkeypatch, **kw)
    assert gpt2_decode_step.calls > calls
    monkeypatch.setattr(iv2, "MAX_ROWS", 27)
    one_run = _recorded_request(int8_tts, monkeypatch, **kw)
    ((_, wav_tp), chunks_tp, ((codes_tp, clens_tp),)) = tp_run
    ((_, wav_1), chunks_1, ((codes_1, clens_1),)) = one_run
    assert chunks_tp == chunks_1 == [9]
    np.testing.assert_array_equal(clens_tp, clens_1)
    for b, n in enumerate(clens_1):
        assert torch.equal(codes_tp[b, :n], codes_1[b, :n]), b
    assert wav_tp.shape == wav_1.shape and np.all(np.isfinite(wav_tp))


def _raises_mesh_with_more_ranks_than_devices(_):
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="CUDA device"):
        make_mesh([f"cuda:{n}", f"cuda:{n}"])


def _dp(_):
    mesh = make_mesh(["cpu"] * 4, dp=2)
    assert (mesh.dp, mesh.sp, mesh.tp) == (2, 1, 2)
    assert mesh.tp_mesh(1).devices == (torch.device("cpu"),) * 2


def _sp(_):
    mesh = make_mesh(["cpu"] * 4, sp=2)
    assert (mesh.dp, mesh.sp, mesh.tp) == (1, 2, 2)


def _pipeline(quantization, switch=True):
    """The tiny pipeline on a tp=2 CPU mesh: it builds, and its decode route
    is K6's only for int8 weights under the switch."""
    def run(tiny_assets):
        from indextts_tpu_torch.engine.decode import decode_route
        from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

        with pytest.MonkeyPatch.context() as mp:
            if switch:
                mp.setenv("INDEXTTS_TP_DECODE", "kernel")
            else:
                mp.delenv("INDEXTTS_TP_DECODE", raising=False)
            tts = IndexTTS2(cfg_path=None, model_dir=str(tiny_assets), cfg=tiny_config(),
                            quantization=quantization, mesh=make_mesh(["cpu", "cpu"]))
        assert "shards" in tts.gpt_params["gpt"]
        kernel = quantization == "int8" and switch
        assert tts.tp_kernel is kernel
        kv_quant = tts._sampling({}).kv_quant
        assert decode_route(tts.gpt_params, 3, kv_quant) == ("tp" if kernel else "plain")
    return run


def _route(kind):
    def run(_):
        from indextts_tpu_torch.engine.decode import decode_route
        from indextts_tpu_torch.nn import InitRng as TInitRng

        mesh = make_mesh(["cpu", "cpu"])
        tree = to_torch(tgpt2.init_gpt2(TInitRng(0), tgpt2.GPT2Dims(1, 128, 4)), "cpu",
                        torch.bfloat16)
        if kind == "int4":
            tree = tgpt2.quantize_gpt2_int4(tree)
        elif kind != "float":
            tree = tgpt2.quantize_gpt2_int8(tree)
        tp = shard_gpt2_tp(tree, mesh)
        assert kind != "float" or tgpt2.is_quantized(tp) is False
        assert decode_route({"gpt": tp}, 25 if kind == "rows" else 3,
                            kv_quant=kind == "int8kv") == "plain"
        assert decode_route({"gpt": tp}, 24, kv_quant=False) == (
            "tp" if kind in ("int8kv", "rows") else "plain")
    return run


@pytest.mark.parametrize("case", [
    _raises_mesh_with_more_ranks_than_devices, _dp, _sp, _pipeline("int4"),
    _pipeline("int8kv"), _pipeline(None), _pipeline("int8", switch=False), _route("int4"),
    _route("float"), _route("int8kv"), _route("rows"),
], ids=["ranks", "dp", "sp", "int4", "int8kv", "float", "switch", "shard-int4", "route-float",
        "route-int8kv", "route-rows"])
def test_unported_mesh_combinations_raise(tiny_assets, case):
    """The mesh combinations this port used to refuse: a rank on a card the
    machine lacks still raises; dp and sp meshes build; the pipeline builds
    on a tp mesh for every quantization, taking K6 only for int8 under
    INDEXTTS_TP_DECODE=kernel (the JAX gate), the plain step on the shards
    otherwise; a tp tree of int4, float, the int8 cache or 25 rows takes the
    plain step (the JAX package's GSPMD decode)."""
    case(tiny_assets)
