"""PyTorch port, the window of K1 and K6 (the fused int8 / int4 decode step)
across the decode's unwritten slot.

The engines prefill [prefix][start_mel] into slots [0, P] and write decode
step s (s >= 1) at slot P + 1 + s, so slot P + 1 is never written. K1, K6
and their plain twins attend exactly the slots kv_valid marks (below pos,
and pos itself), the rule of the mask-based `gpt2_decode_step`. The JAX
package's fused kernel takes the window [pos + 1 - popcount(kv_valid), pos)
instead, which drops slot 0 and takes the zero slot P + 1; the port departs
from it on purpose, and `test_jax_fused_kernel_takes_the_popcount_window`
records both behaviours.

Tolerances, each with its reason:
- the twins against the mask-based step (the port's, and JAX's where it
  reads the cache layout): hidden within atol = rtol = 2e-2, the K1 twin
  tolerance of `tests/test_torch_int8.py` (K1's bf16 rounding chain: bf16
  products, bf16 probabilities against per-chunk maxima, against the stock
  ops' f32 softmax);
- an invalid 64-slot chunk inserted at a chunk boundary inside the valid
  run (any content, pos moved by 64): bit-identical (the chunks keep their
  contents, and the empty chunk merges in as exact zeros);
- one invalid slot inserted inside the run: within the same 2e-2 (the
  positions after it move to other chunks, so other per-chunk maxima).

Inputs come from seeded numpy generators; torch runs one intra-op thread.
"""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, "tests")

from test_torch_int8 import _bf16, _gpt2_bf16, _t  # noqa: E402

from indextts_tpu.models.gpt import gpt2 as jgpt2  # noqa: E402
from indextts_tpu_torch import nn as tnn  # noqa: E402
from indextts_tpu_torch.models.gpt import gpt2 as tgpt2  # noqa: E402
from indextts_tpu_torch.ops import decode_step as tds  # noqa: E402
from indextts_tpu_torch.utils.jax_params import to_torch  # noqa: E402

DIMS = jgpt2.GPT2Dims(2, 640, 10)
TDIMS = tgpt2.GPT2Dims(2, 640, 10)
B, S, P, POS = 3, 256, 40, 150      # slot P + 1 = 41 unwritten; pos in chunk 2
TOL = dict(atol=2e-2, rtol=2e-2)
# (weights, int8 cache)
VARIANTS = {"int8": ("int8", False), "kvq": ("int8", True), "w4": ("int4", False),
            "w4kvq": ("int4", True)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    p = _gpt2_bf16(DIMS, seed=11)
    j = {"int8": jgpt2.quantize_gpt2_int8(p), "int4": jgpt2.quantize_gpt2_int4(p)}
    return j, {k: to_torch(v, "cpu", torch.bfloat16) for k, v in j.items()}


@pytest.fixture(scope="module")
def case():
    """The engines' layout: row 1 left-padded by 6 slots, slots [0, P]
    prefilled, P + 1 unwritten (zero), P + 2 .. POS - 1 decoded, POS the
    current token; random in-group ancestry (group = B)."""
    rng = np.random.default_rng(21)
    kv = rng.normal(0, 1, (2, DIMS.layers, B, S, DIMS.dim))
    kv[:, :, :, P + 1] = 0.0
    kv[:, :, :, POS:] = 0.0
    mask = np.zeros((B, S), bool)
    mask[:, :P + 1] = True
    mask[1, :6] = False
    mask[:, P + 2:POS + 1] = True
    return dict(kv=_bf16(kv), mask=mask, x=_bf16(rng.normal(0, 1, (B, DIMS.dim))),
                anc=rng.integers(0, B, (B, S)).astype(np.int32))


def _cache(kv: np.ndarray, kvq: bool) -> dict:
    k, v = _t(kv[0]), _t(kv[1])
    if not kvq:
        return {"k": k, "v": v}
    kq, vq, kvs = tgpt2.kv_quantize_flat(k, v, DIMS.heads)
    return {"k": kq, "v": vq, "kvs": kvs}


def _gathered(c: dict, group: int) -> tuple:
    """The cache and mask a gather route would hold for the ancestry map."""
    if group == 1:
        return c["kv"], c["mask"]
    idx = (np.arange(B)[:, None] // group) * group + c["anc"]
    return c["kv"][:, :, idx, np.arange(S), :], c["mask"][idx, np.arange(S)]


def _jax_cache(kv: np.ndarray) -> dict:
    """The (L, B, S, H, Dh) cache of JAX's `gpt2_decode_step`."""
    shape = kv.shape[1:4] + (DIMS.heads, DIMS.dim // DIMS.heads)
    return {"k": jnp.asarray(kv[0].reshape(shape)), "v": jnp.asarray(kv[1].reshape(shape))}


def _k1(tree, c, kv, mask, pos, kvq, group=1, anc=None):
    cache = _cache(kv, kvq)
    h = tds.fused_decode_step(tree, _t(c["x"]), TDIMS, pos, cache, torch.tensor(mask),
                              None if anc is None else torch.tensor(anc), group)
    return h.float().numpy()


def _plain(tree, c, kv, mask, pos, kvq):
    cache = _cache(kv, kvq)
    return tgpt2.gpt2_decode_step(tree, _t(c["x"]), TDIMS, pos, cache,
                                  torch.tensor(mask)).float().numpy()


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_k1_twin_attends_the_kv_valid_slots(trees, case, variant, group):
    """K1's twin (group 1, and 3 with the ancestry map) against the
    port's mask-based step on the cache a gather route holds, and (bf16
    cache) JAX's `gpt2_decode_step` on the same int8 / int4 tree."""
    weights, kvq = VARIANTS[variant]
    jtree, ttree = trees
    c = case
    got = _k1(ttree[weights], c, c["kv"], c["mask"], POS, kvq, group,
              c["anc"] if group > 1 else None)
    kv, mask = _gathered(c, group)
    ref = _plain(ttree[weights], c, kv, mask, POS, kvq)
    np.testing.assert_allclose(got, ref, **TOL)
    if not kvq:
        jh, _ = jgpt2.gpt2_decode_step(
            jtree[weights], jnp.asarray(c["x"]), DIMS, jnp.asarray(POS, jnp.int32),
            _jax_cache(kv), jnp.asarray(mask))
        np.testing.assert_allclose(got, np.asarray(jh, np.float32), **TOL)


def _insert(c: dict, at: int, n: int, seed: int = 3) -> tuple:
    """The case with n invalid slots of random content inserted at slot
    ``at`` (the ancestry map, too); the current token moves to POS + n."""
    rng = np.random.default_rng(seed)
    junk = _bf16(rng.normal(0, 30, (2, DIMS.layers, B, n, DIMS.dim)))
    kv = np.concatenate([c["kv"][:, :, :, :at], junk, c["kv"][:, :, :, at:S - n]], axis=3)
    mask = np.concatenate([c["mask"][:, :at], np.zeros((B, n), bool), c["mask"][:, at:S - n]], 1)
    anc = np.concatenate([c["anc"][:, :at], rng.integers(0, B, (B, n)).astype(np.int32),
                          c["anc"][:, at:S - n]], 1)
    return kv, mask, anc


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_k1_twin_ignores_an_inserted_invalid_slot(trees, case, variant, group):
    weights, kvq = VARIANTS[variant]
    tree, c = trees[1][weights], case
    anc = c["anc"] if group > 1 else None
    base = _k1(tree, c, c["kv"], c["mask"], POS, kvq, group, anc)
    kv, mask, anc2 = _insert(c, 64, 64)
    same = _k1(tree, c, kv, mask, POS + 64, kvq, group, anc2 if group > 1 else None)
    np.testing.assert_array_equal(same, base)
    kv, mask, anc2 = _insert(c, 90, 1)
    near = _k1(tree, c, kv, mask, POS + 1, kvq, group, anc2 if group > 1 else None)
    np.testing.assert_allclose(near, base, **TOL)


@pytest.fixture(scope="module")
def mesh():
    from indextts_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(["cpu", "cpu"])


def _k6(tree, c, kv, mask, pos, group=1, anc=None):
    from indextts_tpu_torch.ops.decode_step_tp import fused_decode_step_tp

    Dl = DIMS.dim // 2
    cache = {"shards": [{k: _t(kv[i][..., t * Dl:(t + 1) * Dl]).contiguous()
                         for i, k in enumerate("kv")} for t in range(2)]}
    h = fused_decode_step_tp(tree, _t(c["x"]), TDIMS, pos, cache, torch.tensor(mask),
                             None if anc is None else torch.tensor(anc), group)
    return tnn.layer_norm(tree["ln_f"], h).float().numpy()


@pytest.mark.parametrize("group", [1, 3])
def test_k6_twin_attends_the_kv_valid_slots(trees, case, mesh, group):
    from indextts_tpu_torch.parallel.mesh import shard_gpt2_tp

    jtree, ttree = trees
    c = case
    tp = shard_gpt2_tp(ttree["int8"], mesh)
    anc = c["anc"] if group > 1 else None
    got = _k6(tp, c, c["kv"], c["mask"], POS, group, anc)
    kv, mask = _gathered(c, group)
    np.testing.assert_allclose(got, _plain(ttree["int8"], c, kv, mask, POS, False), **TOL)
    jh, _ = jgpt2.gpt2_decode_step(
        jtree["int8"], jnp.asarray(c["x"]), DIMS, jnp.asarray(POS, jnp.int32),
        _jax_cache(kv), jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(jh, np.float32), **TOL)
    kv, mask, anc2 = _insert(c, 64, 64)
    same = _k6(tp, c, kv, mask, POS + 64, group, anc2 if group > 1 else None)
    np.testing.assert_array_equal(same, got)


def test_jax_fused_kernel_takes_the_popcount_window(trees, case):
    """A departure kept on purpose. On the engines' layout the JAX fused
    kernel (interpret mode) attends [pos + 1 - popcount(kv_valid), pos):
    it equals the port's twin given that contiguous window as kv_valid,
    and both differ from the mask-based step, which the port's twin equals.
    Each row loses its first valid slot (here given v rows 20 times the
    others', so that it weighs in) and gains the zero slot P + 1."""
    from indextts_tpu.ops.pallas.decode_step import fused_decode_step as jax_step

    jtree, ttree = trees
    c = dict(case)
    kv = c["kv"].copy()
    first = c["mask"].argmax(1)
    kv[1, :, np.arange(B), first] *= 20
    c["kv"] = kv = _bf16(kv)
    ref_h, _ = jax_step(jtree["int8"], jnp.asarray(c["x"]), DIMS, jnp.asarray(POS, jnp.int32),
                        {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1])},
                        jnp.asarray(c["mask"]), interpret=True)
    jax_fused = np.asarray(ref_h, np.float32)
    starts = POS + 1 - c["mask"].sum(1)
    slots = np.arange(S)[None, :]
    window = (slots >= starts[:, None]) & (slots <= POS)
    assert not window[np.arange(B), first].any() and window[:, P + 1].all()
    as_jax = _k1(ttree["int8"], c, kv, window, POS, False)
    np.testing.assert_allclose(as_jax, jax_fused, **TOL)
    port = _k1(ttree["int8"], c, kv, c["mask"], POS, False)
    masked = _plain(ttree["int8"], c, kv, c["mask"], POS, False)
    np.testing.assert_allclose(port, masked, **TOL)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for r in range(B):
        assert rel(jax_fused[r], masked[r]) > 5 * rel(port[r], masked[r]), r
