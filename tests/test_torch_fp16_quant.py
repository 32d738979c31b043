"""PyTorch port, K1 and K6 at fp16 (`IndexTTS2(use_fp16=True)` with a
quantization) against the JAX package on the CPU: the kernels' fp16 twins
(the body the CUDA kernels' E = fp16 instantiations compute) and the fp16
decode routes.

The JAX fused kernel cannot take an fp16 cache: its scratch is bf16 and it
copies the cache into it (`lax.dynamic_update_slice` refuses the mix). Its
body is bf16 throughout: x.astype(bf16) at entry, its k / v blocks cast to
bf16, its f32 scale, bias and LayerNorm rows cast exactly from the tree
(`row3`). So the JAX side is its `fused_decode_step` in interpret mode on
the fp16 tree, fp16 x and bf16(cache), and the port's side the twin on the
fp16 tree, fp16 x and the fp16 cache. The tree's biases and LayerNorm
vectors are fp16 values that bf16 cannot hold. The comparison with JAX is
too coarse to see a read of them through bf16 (rounding a N(0, 0.1) bias
to bf16 moves it by at most ~2e-4), so a test of its own holds the twins'
outputs on that tree apart from their outputs on the same tree with one
kind of those vectors rounded to bf16: a read of it through bf16 would make
the two the same bits.

Inputs come from seeded numpy generators; torch runs one intra-op thread.
Tolerances, each with its reason:
- K1 and K6 against JAX: the hidden state after ln_f within atol = rtol =
  2e-2 (the bf16 K1 twin's tolerance, `tests/test_torch_int8.py`: bf16
  probabilities taken against per-chunk maxima here, per-block running
  maxima on the TPU); every layer's written k / v rows (bf16 values, written
  to the fp16 cache exactly) within the hidden-state tolerance: a
  LayerNorm value that rounds the other way after f32 sums in another order
  moves a near-zero k / v value by several of its bf16 ulps; the int8
  cache's layer 0 within 1 count and its scales within 1 bf16 ulp; every
  other slot of the cache unchanged;
- the fp16 twin against the bf16 twin on bf16 copies of its inputs (and a
  tree of bf16 values): the same bits, every layer;
- the fp16 twins on the tree against the twins on the tree with one kind
  of its biases and LayerNorm vectors rounded to bf16: not the same bits
  (exactness, no tolerance);
- greedy beams on the plain route at fp16 (int8 and int4): token-equal with
  the JAX engine's mask-based XLA step at fp16 with the same quantization;
- the K1-twin route's hidden states against the plain route's on the same
  inputs, the first steps of a greedy decode: rel-L2 <= 2e-2 (the plain step
  keeps fp16 activations, K1's body bf16: 2^-8 against 2^-11 relative a
  rounding, over two layers).
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, "tests")

from test_torch_int8 import DIMS, POS, S, _beam_cfg, _within_ulp  # noqa: E402

from indextts_tpu.models.gpt import gpt2 as jgpt2  # noqa: E402
from indextts_tpu.nn import InitRng  # noqa: E402
from indextts_tpu_torch.models.gpt import gpt2 as tgpt2  # noqa: E402
from indextts_tpu_torch.utils.jax_params import to_torch  # noqa: E402

TDIMS = tgpt2.GPT2Dims(DIMS.layers, DIMS.dim, DIMS.heads)
VARIANTS = {"int8": (False, False), "kvq": (False, True), "w4": (True, False),
            "w4-kvq": (True, True)}
ROWS = 15                   # a row count over 12 (the JAX kernel's 32-slot blocks)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f16(a) -> np.ndarray:
    return np.asarray(a, np.float32).astype(np.float16)


def _bf16_of(a) -> np.ndarray:
    """fp16 (or f32) values rounded to bf16, as a numpy bf16 array."""
    return np.asarray(jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _gpt2_fp16(dims, seed=0):
    """The JAX GPT-2 tree cast to fp16 (the pipeline's order: cast, then
    quantize), its LayerNorm vectors and biases random fp16 values."""
    rng = np.random.default_rng(seed + 11)
    p = jax.tree_util.tree_map(_f16, jgpt2.init_gpt2(InitRng(seed), dims))
    h = p["h"]
    for ln in ("ln_1", "ln_2"):
        h[ln]["weight"] = _f16(rng.normal(1, 0.1, h[ln]["weight"].shape))
        h[ln]["bias"] = _f16(rng.normal(0, 0.1, h[ln]["bias"].shape))
    for grp in ("attn", "mlp"):
        for layer in h[grp].values():
            layer["bias"] = _f16(rng.normal(0, 0.1, layer["bias"].shape))
    return p


@pytest.fixture(scope="module")
def case():
    """fp16 GPT-2 (2 x 640, 10 heads) in int8 and int4; ROWS rows in groups
    of 3 with staggered starts over a 128-slot fp16 cache at pos 70 (and its int8
    quantization), fp16 x, a random in-group ancestry map (groups of 3)."""
    rng = np.random.default_rng(21)
    p = _gpt2_fp16(DIMS, seed=4)
    bias = np.asarray(p["h"]["attn"]["c_attn"]["bias"], np.float32)
    assert not np.array_equal(bias, np.asarray(_bf16_of(bias), np.float32))
    kv = rng.normal(0, 1, (2, DIMS.layers, ROWS, S, DIMS.dim))
    kv[:, :, :, POS:] = 0.0
    kv = _f16(kv)
    kq, vq, kvs = jgpt2.kv_quantize_flat(jnp.asarray(_bf16_of(kv[0])),
                                         jnp.asarray(_bf16_of(kv[1])), DIMS.heads)
    mask = np.zeros((ROWS, S), bool)
    for b in range(ROWS):                 # a beam group shares its prefix
        mask[b, (7 * (b // 3)) % 20:POS + 1] = True
    return dict(params={False: jgpt2.quantize_gpt2_int8(p), True: jgpt2.quantize_gpt2_int4(p)},
                kv=kv, qcache=dict(k=np.asarray(kq), v=np.asarray(vq),
                                   kvs=np.asarray(kvs, np.float32)),
                mask=mask, x=_f16(rng.normal(0, 1, (ROWS, DIMS.dim))),
                anc=rng.integers(0, 3, (ROWS, S)).astype(np.int32))


def _caches(c, kvq: bool, rows: int):
    """(the JAX side's cache: bf16(fp16 cache) or the int8 cache, the
    port's: the fp16 cache or the same int8 cache), the first ``rows``."""
    if kvq:
        q = c["qcache"]
        jax_c = {"k": jnp.asarray(q["k"][:, :rows]), "v": jnp.asarray(q["v"][:, :rows]),
                 "kvs": jnp.asarray(q["kvs"][:, :rows], jnp.bfloat16)}
        port = {k: torch.tensor(np.ascontiguousarray(q[k][:, :rows])) for k in "kv"}
        port["kvs"] = torch.tensor(np.ascontiguousarray(q["kvs"][:, :rows])).to(torch.bfloat16)
        return jax_c, port
    jax_c = {k: jnp.asarray(_bf16_of(c["kv"][i][:, :rows])) for i, k in enumerate("kv")}
    port = {k: torch.tensor(np.ascontiguousarray(c["kv"][i][:, :rows]))
            for i, k in enumerate("kv")}
    return jax_c, port


def _jax_step(c, w4: bool, cache: dict, rows: int, group: int):
    from indextts_tpu.engine.beam import _anc_bs, _anc_flat
    from indextts_tpu.ops.pallas.decode_step import fused_decode_step as jax_step

    anc = None if group == 1 else _anc_flat(jnp.asarray(c["anc"][:rows]), S, _anc_bs(rows))
    return jax_step(c["params"][w4], jnp.asarray(c["x"][:rows]), DIMS,
                    jnp.asarray(POS, jnp.int32), cache, jnp.asarray(c["mask"][:rows]),
                    interpret=True, group=group, anc=anc)


# every variant at group 1 (one row) and group 3 (three rows), and int8 at
# ROWS rows in groups of 3
K1_CASES = [(v, 1, 1) for v in VARIANTS] + [(v, 3, 3) for v in VARIANTS] + [("int8", ROWS, 3)]


@pytest.mark.parametrize("variant,rows,group", K1_CASES,
                         ids=[f"{v}-{r}rows-group{g}" for v, r, g in K1_CASES])
def test_k1_fp16_twin_matches_the_jax_kernel_on_bf16_inputs(case, variant, rows, group):
    from indextts_tpu_torch.ops.decode_step import fused_decode_step

    c = case
    w4, kvq = VARIANTS[variant]
    jax_cache, cache = _caches(c, kvq, rows)
    ref_h, ref_cache = _jax_step(c, w4, jax_cache, rows, group)
    before = {k: t.clone() for k, t in cache.items()}
    h = fused_decode_step(to_torch(c["params"][w4], "cpu", torch.float16),
                          torch.tensor(c["x"][:rows]), TDIMS, POS, cache,
                          torch.tensor(c["mask"][:rows]),
                          None if group == 1 else torch.tensor(c["anc"][:rows]), group)
    assert h.dtype == torch.float16
    np.testing.assert_allclose(_np(h), np.asarray(ref_h, np.float32), atol=2e-2, rtol=2e-2)
    ref = {k: np.asarray(t) for k, t in ref_cache.items()}
    for key in ("k", "v"):
        if kvq:
            got, want = cache[key][0, :, POS].int().numpy(), ref[key][0, :, POS].astype(np.int32)
            assert np.abs(got - want).max() <= 1, key
        else:
            assert cache[key].dtype == torch.float16
            np.testing.assert_allclose(_np(cache[key][:, :, POS]),
                                       ref[key][:, :, POS].astype(np.float32),
                                       atol=2e-2, rtol=2e-2)
    if kvq:
        _within_ulp(cache["kvs"][0, :, POS], ref["kvs"][0, :, POS].astype(np.float32))
    for key, t in cache.items():                  # nothing else of the cache moved
        assert torch.equal(t[:, :, :POS], before[key][:, :, :POS])
        assert torch.equal(t[:, :, POS + 1:], before[key][:, :, POS + 1:])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_k1_fp16_twin_is_the_bf16_body_on_bf16_copies(case, variant):
    """A tree of bf16 values at fp16 and at bf16, fp16 x and cache against
    their bf16 copies: every layer's output and the hidden state before the
    last cast are the same bits, and the written rows the same values."""
    from indextts_tpu_torch.ops.decode_step import fused_decode_step

    c = case
    w4, kvq = VARIANTS[variant]
    tree_bf16 = to_torch(c["params"][w4], "cpu", torch.bfloat16)

    def half(tree):
        if isinstance(tree, dict):
            return {k: half(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [half(v) for v in tree]
        return tree.half() if tree.dtype == torch.bfloat16 else tree

    tree_f16 = half(tree_bf16)
    _, cache16 = _caches(c, kvq, 3)
    cache_b = {k: t.to(torch.bfloat16) if t.dtype == torch.float16 else t.clone()
               for k, t in cache16.items()}
    x16 = torch.tensor(c["x"][:3])
    anc, mask = torch.tensor(c["anc"][:3]), torch.tensor(c["mask"][:3])
    l16, lb = [], []
    h16 = fused_decode_step(tree_f16, x16, TDIMS, POS, cache16, mask, anc, 3, layer_inputs=l16)
    hb = fused_decode_step(tree_bf16, x16.to(torch.bfloat16), TDIMS, POS, cache_b, mask, anc, 3,
                           layer_inputs=lb)
    assert h16.dtype == torch.float16 and hb.dtype == torch.bfloat16
    assert l16[0].dtype == torch.float16 and len(l16) == len(lb)
    assert all(torch.equal(a, b) for a, b in zip(l16[1:], lb[1:]))
    for key in cache16:
        assert torch.equal(cache16[key][:, :, POS], cache_b[key][:, :, POS].to(cache16[key].dtype))


# each per-layer vector of the step: the LayerNorms' and the GEMVs' biases
VECTORS = [("ln_1", "weight"), ("ln_1", "bias"), ("ln_2", "weight"), ("ln_2", "bias"),
           ("attn", "c_attn", "bias"), ("attn", "c_proj", "bias"), ("mlp", "c_fc", "bias"),
           ("mlp", "c_proj", "bias")]


def _through_bf16(tree, path):
    """The torch tree with the fp16 vector at ``path`` of every layer
    rounded to bf16 and stored at fp16 again: what a read of it through
    bf16 would see."""
    def at(node, keys):
        if not keys:
            return node.to(torch.bfloat16).half()
        return {**node, keys[0]: at(node[keys[0]], keys[1:])}

    return {**tree, "h": [at(lp, path) for lp in tree["h"]]}


@pytest.mark.parametrize("variant", list(VARIANTS) + ["tp"])
def test_fp16_twins_read_biases_and_layernorm_vectors_exactly(case, variant):
    """K1's fp16 twin (every variant, group 3 with the ancestry map) and
    K6's on the case's tree, whose biases and LayerNorm vectors bf16 cannot
    hold, against the same twin on the tree with one kind of vector rounded
    to bf16 (each of the eight in turn): the hidden states differ. A twin
    that read that vector through bf16 would give both trees the same
    bits."""
    from indextts_tpu_torch.ops.decode_step import fused_decode_step
    from indextts_tpu_torch.ops.decode_step_tp import fused_decode_step_tp
    from indextts_tpu_torch.parallel.mesh import Replicated, make_mesh, shard_gpt2_tp

    c = case
    w4, kvq = VARIANTS.get(variant, (False, False))
    tree = to_torch(c["params"][w4], "cpu", torch.float16)
    x, mask, anc = (torch.tensor(c[k][:3]) for k in ("x", "mask", "anc"))
    mesh = make_mesh(["cpu", "cpu"])

    def step(t):
        _, cache = _caches(c, kvq, 3)
        if variant != "tp":
            return fused_decode_step(t, x, TDIMS, POS, cache, mask, anc, 3)
        Dl = DIMS.dim // 2
        cache = {"shards": [{k: v[..., s * Dl:(s + 1) * Dl].contiguous()
                             for k, v in cache.items()} for s in range(2)]}
        return fused_decode_step_tp(shard_gpt2_tp(t, mesh), x, TDIMS, POS, cache,
                                    Replicated.of(mask, mesh), Replicated.of(anc, mesh), 3)

    h = step(tree)
    assert h.dtype == torch.float16
    for path in VECTORS:
        rounded = _through_bf16(tree, path)
        vec = [lp[path[0]] for lp in (tree["h"][0], rounded["h"][0])]
        for key in path[1:]:
            vec = [v[key] for v in vec]
        assert not torch.equal(*vec), path          # bf16 cannot hold the vector
        assert not torch.equal(h, step(rounded)), path


@pytest.mark.parametrize("group", [1, 3])
def test_k6_fp16_twin_matches_the_jax_single_chip_kernel(case, group):
    from indextts_tpu_torch import nn
    from indextts_tpu_torch.ops.decode_step_tp import fused_decode_step_tp
    from indextts_tpu_torch.parallel.mesh import Replicated, make_mesh, shard_gpt2_tp

    c = case
    rows = 1 if group == 1 else 3
    jax_cache, cache = _caches(c, False, rows)
    ref_h, _ = _jax_step(c, False, jax_cache, rows, group)
    mesh = make_mesh(["cpu", "cpu"])
    tp = shard_gpt2_tp(to_torch(c["params"][False], "cpu", torch.float16), mesh)
    Dl = DIMS.dim // 2
    shards = {"shards": [{k: t[..., s * Dl:(s + 1) * Dl].contiguous() for k, t in cache.items()}
                         for s in range(2)]}
    anc = None if group == 1 else Replicated.of(torch.tensor(c["anc"][:rows]), mesh)
    h = nn.layer_norm(tp["ln_f"], fused_decode_step_tp(
        tp, torch.tensor(c["x"][:rows]), TDIMS, POS, shards,
        Replicated.of(torch.tensor(c["mask"][:rows]), mesh), anc, group))
    assert h.dtype == torch.float16
    np.testing.assert_allclose(_np(h), np.asarray(ref_h, np.float32), atol=2e-2, rtol=2e-2)
    # the shards' rows are K1's twin's (the same contraction per head slice)
    from indextts_tpu_torch.ops.decode_step import fused_decode_step

    k1 = {k: t.clone() for k, t in cache.items()}
    fused_decode_step(to_torch(c["params"][False], "cpu", torch.float16),
                      torch.tensor(c["x"][:rows]), TDIMS, POS, k1, torch.tensor(c["mask"][:rows]),
                      None if group == 1 else torch.tensor(c["anc"][:rows]), group)
    for key in "kv":
        rows_tp = torch.cat([sh[key][0, :, POS] for sh in shards["shards"]], -1)
        assert torch.equal(rows_tp, k1[key][0, :, POS])


def _uv_fp16(quantize):
    from indextts_tpu.models.gpt.unified_voice import init_unified_voice

    cfg = _beam_cfg()
    params = jax.tree_util.tree_map(_f16, init_unified_voice(InitRng(0), cfg))
    params["gpt"] = quantize(params["gpt"])
    return cfg, params


def _prefix(cfg, nb=2, P=7, seed=3):
    rng = np.random.default_rng(seed)
    prefix = _f16(rng.normal(0, 0.3, (nb, P, cfg.model_dim)))
    mask = np.ones((nb, P), bool)
    mask[0, 0] = False
    return prefix, mask


@pytest.mark.parametrize("quantization", ["int8", "int4"])
def test_fp16_plain_route_greedy_beams_token_equal_jax(monkeypatch, quantization):
    """The port's plain step at fp16 on the quantized tree (the decode
    route pinned to "plain": the route of more than 24 rows, and of an f32
    tree) against the JAX engine's XLA step at fp16 on the same tree."""
    from indextts_tpu.engine import beam as jbeam
    from indextts_tpu.engine.decode import SamplingConfig as JSampling
    from indextts_tpu_torch.engine import beam as tbeam
    from indextts_tpu_torch.engine.decode import SamplingConfig
    from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims, gpt2_decode_step

    quantize = jgpt2.quantize_gpt2_int8 if quantization == "int8" else jgpt2.quantize_gpt2_int4
    cfg, params = _uv_fp16(quantize)
    dims = jgpt2.GPT2Dims(cfg.layers, cfg.model_dim, cfg.heads)
    prefix, mask = _prefix(cfg)
    steps = 8
    monkeypatch.setenv("INDEXTTS_FUSED_DECODE", "0")
    jbeam.generate_beam.clear_cache()
    ref_toks, ref_lens = jbeam.generate_beam(
        params, cfg, dims, jnp.asarray(prefix), jnp.asarray(mask), jax.random.PRNGKey(5),
        max_new_tokens=steps, sampling=JSampling(do_sample=False, num_beams=3))
    jbeam.generate_beam.clear_cache()

    monkeypatch.setattr(tbeam, "decode_route", lambda *a, **k: "plain")
    tp = to_torch(params, "cpu", torch.float16)
    calls = gpt2_decode_step.calls
    toks, lens = tbeam.generate_beam(tp, cfg, GPT2Dims(cfg.layers, cfg.model_dim, cfg.heads),
                                     torch.tensor(prefix), torch.tensor(mask),
                                     torch.Generator().manual_seed(0), steps,
                                     SamplingConfig(do_sample=False, num_beams=3),
                                     dtype=torch.float16)
    assert gpt2_decode_step.calls == calls + steps - 1
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_array_equal(lens, np.asarray(ref_lens))


def test_fp16_k1_route_hidden_states_follow_the_plain_route():
    """A greedy num_beams=1 decode at fp16 on the int8 tree takes the K1
    route ("fused", the twin here); at each of its first steps the plain
    step on the same inputs (the token, the cache before the step, kv_valid)
    gives hidden states within rel-L2 2e-2."""
    from indextts_tpu_torch.engine import decode as tdecode
    from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims, gpt2_decode_step

    cfg, params = _uv_fp16(jgpt2.quantize_gpt2_int8)
    tp = to_torch(params, "cpu", torch.float16)
    dims = GPT2Dims(cfg.layers, cfg.model_dim, cfg.heads)
    prefix, mask = _prefix(cfg, nb=1)
    worst, seen = [], []

    def check(args, h):
        if len(seen) >= 4:
            return
        kv = {k: t.clone() for k, t in args["kv_cache"].items()}
        plain = gpt2_decode_step(tp["gpt"], args["x"], dims, args["pos"], kv, args["kv_valid"])
        seen.append(args["pos"])
        assert h.dtype == plain.dtype == torch.float16
        worst.append(float((h.float() - plain.float()).norm() / plain.float().norm()))

    tdecode.generate(tp, cfg, dims, torch.tensor(prefix), torch.tensor(mask),
                     torch.Generator().manual_seed(0), 8,
                     tdecode.SamplingConfig(do_sample=False, num_beams=1), dtype=torch.float16,
                     step_check=check)
    assert tdecode.last_route == "fused" and len(seen) == 4, (tdecode.last_route, seen)
    assert max(worst) <= 2e-2, worst


def test_float32_gates_of_the_dit_and_bigvgan(monkeypatch):
    """A float32 pipeline on the card: K2, K4 and K3 are instantiated for
    bf16 and fp16 only, so `attention_tier` gives "dense" for a float32
    attention on a CUDA device and BigVGAN's activation runs K3's plain
    version; on the CPU the twins take float32 and the tiers stay. The gate
    on a CUDA device is read through `kernel_takes` (no card here)."""
    from indextts_tpu_torch.config import DiTConfig
    from indextts_tpu_torch.models.s2mel import dit as tdit
    from indextts_tpu_torch.models.vocoder import bigvgan as tbv
    from indextts_tpu_torch.ops import attn as tattn
    from indextts_tpu_torch.ops import snake as tsnake

    for takes in (tattn.kernel_takes, tsnake.kernel_takes):
        assert not takes(torch.float32, torch.device("cuda"))
        assert takes(torch.bfloat16, "cuda") and takes(torch.float16, "cuda:0")
        assert takes(torch.float32, "cpu")
    for name in ("INDEXTTS_PACKED_ATTN", "INDEXTTS_FLASH_DIT"):
        monkeypatch.delenv(name, raising=False)
    cfg, lens = DiTConfig(), torch.tensor([40, 31])
    for dtype in (None, torch.float32, torch.bfloat16, torch.float16):
        assert tdit.attention_tier(cfg, lens, dtype) == "packed"
    seen = []
    monkeypatch.setattr(tdit, "kernel_takes",
                        lambda dtype, device: seen.append((dtype, device)) or dtype != torch.float32)
    assert tdit.attention_tier(cfg, lens, torch.float32) == "dense"
    assert tdit.attention_tier(cfg, lens, torch.float16) == "packed"
    assert seen == [(torch.float32, lens.device), (torch.float16, lens.device)]

    rng = np.random.default_rng(8)
    x = torch.tensor(rng.standard_normal((2, 40, 8)), dtype=torch.float32)
    a = {"alpha": torch.tensor(rng.normal(0, 0.3, 8), dtype=torch.float32),
         "beta": torch.tensor(rng.normal(0, 0.3, 8), dtype=torch.float32)}
    ref = tsnake.antialias_snake_plain(x, a["alpha"], a["beta"], lens[:2] - 10, True)
    monkeypatch.setattr(tbv, "kernel_takes", lambda dtype, device: False)
    monkeypatch.setattr(tbv, "antialias_snake", lambda *args: pytest.fail("K3 called"))
    assert torch.equal(tbv._act(a, x, lens[:2] - 10, True), ref)
