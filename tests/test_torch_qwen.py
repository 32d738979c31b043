"""The port's Qwen3 (`indextts_tpu_torch/models/qwen.py`) against the JAX
package's (`indextts_tpu/models/qwen.py`) at the tiny config of
`tests/test_parity_qwen.py`, with the same numpy weights (through the weight
bridge) and f32 on both sides: prefill logits and the cache within atol 2e-4
/ rtol 1e-3 (the f32 lane), greedy tokens and lengths equal (an eos that
comes early, a left-padded batch of two), `convert_qwen` trees equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from indextts_tpu import nn as jnn
from indextts_tpu.models import qwen as jq
from indextts_tpu_torch.models import qwen as tq
from indextts_tpu_torch.utils.jax_params import to_torch

C = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
         num_key_value_heads=2, head_dim=8, intermediate_size=64, rope_theta=10000.0,
         tie_word_embeddings=True)
ATOL, RTOL = 2e-4, 1e-3


def _cfgs(eos=2, **kw):
    kw = {**C, "eos_token_id": eos, **kw}
    return jq.QwenConfig(**kw), tq.QwenConfig(**kw)


@pytest.fixture(scope="module")
def params():
    jc, _ = _cfgs()
    # std 0.3: the 0.02 init gives near-uniform logits, where greedy picks
    # would rest on rounding
    rng = jnn.InitRng(0)
    p = jq.init_qwen(rng, jc)
    g = np.random.default_rng(0)
    p = {"embed": g.normal(0, 0.3, p["embed"].shape).astype(np.float32),
         "layers": {k: (v if k.endswith("_ln") or k.endswith("_norm")
                        else g.normal(0, 0.3, v.shape).astype(np.float32))
                    for k, v in p["layers"].items()},
         "final_ln": p["final_ln"]}
    return p, to_torch(p, "cpu", torch.float32)


def _batch(rows, pad=0):
    """Left-padded ids and mask from lists of ids."""
    P = max(len(r) for r in rows)
    ids = np.full((len(rows), P), pad, np.int64)
    mask = np.zeros((len(rows), P), np.int64)
    for i, r in enumerate(rows):
        ids[i, P - len(r):] = r
        mask[i, P - len(r):] = 1
    return ids, mask


@pytest.mark.parametrize("rows", [[list(range(3, 14))], [list(range(5, 14)), [7, 9, 11, 3]]],
                         ids=["one-row", "left-padded"])
def test_prefill_logits_and_cache(params, rows):
    jp, tp = params
    jc, tc = _cfgs()
    ids, mask = _batch(rows)
    jl, jkv = jq.qwen_prefill(jp, jc, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32),
                              max_len=16, dtype=jnp.float32)
    tl, tkv = tq.qwen_prefill(tp, tc, torch.from_numpy(ids), torch.from_numpy(mask), 16,
                              dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)
    for n in ("k", "v"):
        assert tuple(tkv[n].shape) == jkv[n].shape
        np.testing.assert_allclose(tkv[n].numpy(), np.asarray(jkv[n]), atol=ATOL, rtol=RTOL)


def _greedy_pair(params, rows, n, eos):
    jp, tp = params
    jc, tc = _cfgs(eos)
    ids, mask = _batch(rows)
    jt, jlen = jq.qwen_generate_greedy(jp, jc, jnp.asarray(ids, jnp.int32),
                                       jnp.asarray(mask, jnp.int32), max_new_tokens=n,
                                       dtype=jnp.float32)
    tt, tlen = tq.qwen_generate_greedy(tp, tc, torch.from_numpy(ids), torch.from_numpy(mask),
                                       max_new_tokens=n, dtype=torch.float32)
    return (np.asarray(jt), np.asarray(jlen)), (tt.numpy(), tlen.numpy())


@pytest.mark.parametrize("rows", [[list(range(3, 12))], [list(range(5, 14)), [7, 9, 11, 3]]],
                         ids=["one-row", "left-padded"])
def test_greedy_tokens_and_lengths(params, rows):
    (jt, jlen), (tt, tlen) = _greedy_pair(params, rows, 12, eos=2)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tlen, jlen)


@pytest.mark.parametrize("at", [0, 3], ids=["first-token", "step-3"])
def test_greedy_early_eos(params, at):
    """eos chosen as the token the model emits at step ``at`` of the
    decode without an eos: the rows stop there, eos-padded, with the JAX
    lengths (1 for a first-token eos, the step + 1 otherwise); the second
    row of the batch runs on (or stops) as JAX's does."""
    rows = [list(range(3, 12)), [7, 9, 11, 3]]
    (_, _), (free, _) = _greedy_pair(params, rows, 12, eos=127)
    eos = int(free[0, at])
    (jt, jlen), (tt, tlen) = _greedy_pair(params, rows, 12, eos=eos)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tlen, jlen)
    assert tlen[0] == at + 1 and np.all(tt[0, at:] == eos)


def test_convert_qwen_trees_equal():
    """An HF-layout state dict (tied and untied) -> the same tree in both
    packages."""
    g = np.random.default_rng(1)
    for tied in (True, False):
        jc, tc = _cfgs(tie_word_embeddings=False) if not tied else _cfgs()
        D, H, KV, Dh, I, L = 32, 4, 2, 8, 64, 2
        sd = {"model.embed_tokens.weight": g.normal(size=(128, D)),
              "model.norm.weight": g.normal(size=(D,))}
        shapes = {"input_layernorm": (D,), "post_attention_layernorm": (D,),
                  "self_attn.q_proj": (H * Dh, D), "self_attn.k_proj": (KV * Dh, D),
                  "self_attn.v_proj": (KV * Dh, D), "self_attn.o_proj": (D, H * Dh),
                  "self_attn.q_norm": (Dh,), "self_attn.k_norm": (Dh,),
                  "mlp.gate_proj": (I, D), "mlp.up_proj": (I, D), "mlp.down_proj": (D, I)}
        for i in range(L):
            for k, s in shapes.items():
                sd[f"model.layers.{i}.{k}.weight"] = g.normal(size=s).astype(np.float32)
        if not tied:
            sd["lm_head.weight"] = g.normal(size=(128, D))
        jt, tt = jq.convert_qwen(sd, jc), tq.convert_qwen(sd, tc)
        flat_j = {f"{k}/{kk}": vv for k, v in jt.items()
                  for kk, vv in (v.items() if isinstance(v, dict) else [("", v)])}
        flat_t = {f"{k}/{kk}": vv for k, v in tt.items()
                  for kk, vv in (v.items() if isinstance(v, dict) else [("", v)])}
        assert flat_j.keys() == flat_t.keys() and ("lm_head/" in flat_t) != tied
        for k in flat_j:
            np.testing.assert_array_equal(flat_t[k], flat_j[k])
            assert flat_t[k].dtype == flat_j[k].dtype


def test_from_hf_and_init_shapes():
    """`QwenConfig.from_hf` as the JAX package reads an HF config.json (an eos
    list keeps its first), and `init_qwen`'s tree has the JAX tree's keys and
    shapes."""
    d = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=8, intermediate_size=64, rope_theta=10000.0,
             tie_word_embeddings=False, eos_token_id=[5, 7])
    jc, tc = jq.QwenConfig.from_hf(d), tq.QwenConfig.from_hf(d)
    assert {f: getattr(tc, f) for f in tc.__dataclass_fields__} == \
        {f: getattr(jc, f) for f in jc.__dataclass_fields__}
    assert tc.eos_token_id == 5
    jt = jq.init_qwen(jnn.InitRng(0), jc)
    tt = tq.init_qwen(tq.InitRng(0), tc)
    assert set(tt) == set(jt) and set(tt["layers"]) == set(jt["layers"])
    for k, v in jt["layers"].items():
        assert tuple(tt["layers"][k].shape) == v.shape
    assert tuple(tt["lm_head"].shape) == jt["lm_head"].shape
    assert torch.equal(tt["layers"]["q_norm"], torch.ones(2, 8))
