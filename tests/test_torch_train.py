"""PyTorch port, training: `indextts_tpu_torch/parallel/train.py` (the GPT
cross-entropy + CFM loss, AdamW) and the trainer `indextts_tpu_torch/train.py`
against the JAX package's `parallel/train.py` and `tools/train.py` on the CPU.

Configs: the tiny trainer config of `__graft_entry__._dryrun_impl` (and of
`tools/train.py`), and the same with the shipped conformer input
(``input_layer="conv2d2"``). Both packages start from one JAX-initialised
tree (`to_torch`), take the JAX tool's synthetic batches, and the port's
CFM takes the JAX step's draws of (t, z) (`jax.random.split(fold_in(key,
step))`, as `cfm_loss` splits them).

Tolerances: loss parts and every gradient leaf at the JAX parity suite's
f32 atol 2e-4 / rtol 1e-3 (sums in another order); after 3 AdamW steps the
losses at the same tolerance and the parameters within atol 1e-3 (where a
gradient entry is ~0 its sign is noise, and one Adam step then moves the
entry by up to 2 * lr = 2e-4 either way). Checkpoints are held exactly;
the port's resume against its uninterrupted run at atol 1e-6 / rtol 1e-5,
`tests/test_train_loop.py`'s. The dp x tp step: `test_torch_train_mesh.py`.
"""

import argparse
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu_torch import train as ttrain
from indextts_tpu_torch.parallel import train as tpt
from indextts_tpu_torch.utils.jax_params import to_jax, to_torch

ATOL, RTOL = 2e-4, 1e-3
STEPS, B = 3, 2


def _configs(C, input_layer: str):
    cond = C.ConditionModuleConfig(output_size=32, linear_units=48, attention_heads=2,
                                   num_blocks=1, input_layer=input_layer, perceiver_mult=2)
    gpt = C.GPTConfig(layers=2, model_dim=64, heads=4, max_text_tokens=32, max_mel_tokens=64,
                      number_text_tokens=40, number_mel_codes=50, start_mel_token=48,
                      stop_mel_token=49, cond_input_dim=32, condition_module=cond,
                      emo_condition_module=cond)
    s2 = C.S2MelConfig(
        DiT=C.DiTConfig(hidden_dim=32, num_heads=2, depth=1, in_channels=8, content_dim=16,
                        final_layer_type="wavenet"),
        wavenet=C.WaveNetConfig(hidden_dim=32, num_layers=2, kernel_size=5),
        style_encoder=C.StyleEncoderConfig(dim=12),
        length_regulator=C.LengthRegulatorConfig(channels=16, in_channels=16))
    return gpt, s2


def _jax_tree(gpt, s2):
    from indextts_tpu.models.gpt import unified_voice as juv
    from indextts_tpu.models.s2mel.dit import init_dit
    from indextts_tpu.nn import InitRng

    rng = InitRng(0)
    tree = {"gpt": juv.init_unified_voice(rng, gpt), "s2mel": {"cfm": init_dit(rng, s2)}}
    return jax.tree_util.tree_map(np.asarray, tree)


def _key(step: int):
    return jax.random.fold_in(jax.random.PRNGKey(0), step)


def _draws(key, x1_shape):
    """`cfm_loss`'s (t, z) for ``key``, as numpy."""
    r_t, r_z = jax.random.split(key)
    t = jax.random.uniform(r_t, (x1_shape[0], 1, 1))
    z = jax.random.normal(r_z, x1_shape, dtype=jnp.float32)
    return np.asarray(t), np.asarray(z)


@functools.lru_cache(maxsize=None)
def _jax_run(input_layer: str):
    """The JAX side, once per config: the step's gradient at step 0 (the
    train step's own loss function) and STEPS steps of
    `make_train_step(make_mesh(1), ...)`, in one jitted program."""
    import indextts_tpu.config as jc
    from indextts_tpu.models.s2mel.cfm import cfm_loss
    from indextts_tpu.parallel.mesh import make_mesh
    from indextts_tpu.parallel.train import gpt_loss, make_train_state, make_train_step

    from tools.train import synthetic_batch

    gpt, s2 = _configs(jc, input_layer)
    tree = _jax_tree(gpt, s2)
    tx, opt_state = make_train_state(tree)
    step, _, _ = make_train_step(make_mesh(1), gpt, s2, tx)

    def loss_fn(trainable, batch, rng):
        l_gpt = gpt_loss(trainable["gpt"], gpt, batch)
        l_cfm = cfm_loss(trainable["s2mel"]["cfm"], s2, batch["mel_target"],
                         batch["mel_frames"], batch["prompt_frames"], batch["cfm_cond"],
                         batch["style"], rng)
        return l_gpt + l_cfm, {"gpt": l_gpt, "cfm": l_cfm}

    @jax.jit
    def both(trainable, opt_state, batch, rng):
        grads = jax.grad(lambda p: loss_fn(p, batch, rng)[0])(trainable)
        return grads, step(trainable, opt_state, batch, rng)

    trainable, losses, grads = tree, [], None
    for i in range(STEPS):
        g, (trainable, opt_state, loss, parts) = both(
            trainable, opt_state, synthetic_batch(i, B, gpt, s2), _key(i))
        grads = g if grads is None else grads
        losses.append((float(loss), float(parts["gpt"]), float(parts["cfm"])))
    host = functools.partial(jax.tree_util.tree_map, np.asarray)
    return {"tree": tree, "grads": host(grads), "losses": losses,
            "trained": host(trainable), "opt_state": host(opt_state)}


def _port_configs(input_layer: str):
    import indextts_tpu_torch.config as tc

    return _configs(tc, input_layer)


def _batch(step: int, gpt, s2):
    return ttrain.to_device(ttrain.synthetic_batch(step, B, gpt, s2), "cpu")


def _noise(step: int, batch):
    return tuple(torch.tensor(a) for a in _draws(_key(step), batch["mel_target"].shape))


def _assert_trees(got, want, **tol):
    fg, tg = jax.tree_util.tree_flatten_with_path(got)
    fw, tw = jax.tree_util.tree_flatten_with_path(want)
    assert tg == tw
    for (path, a), (_, b) in zip(fg, fw):
        err = f"{jax.tree_util.keystr(path)}"
        assert a.shape == b.shape and a.dtype == b.dtype, err
        if tol:
            np.testing.assert_allclose(a, b, err_msg=err, **tol)
        else:
            np.testing.assert_array_equal(a, b, err_msg=err)


def test_synthetic_batch_is_the_jax_tools():
    import indextts_tpu.config as jc

    from tools.train import synthetic_batch

    want = synthetic_batch(3, 4, *_configs(jc, "linear"))
    got = ttrain.synthetic_batch(3, 4, *_port_configs("linear"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == np.asarray(v).dtype and np.array_equal(got[k], v), k


def _dvae_tree():
    from indextts_tpu.models.codec.dvae import init_dvae
    from indextts_tpu.nn import InitRng

    return jax.tree_util.tree_map(np.asarray, init_dvae(InitRng(0), num_tokens=32,
                                                        codebook_dim=16, hidden_dim=16))


@pytest.mark.parametrize("which", ["gpt linear", "gpt conv2d2", "dit", "dvae"])
def test_to_jax_inverts_to_torch(which):
    """Every leaf kind: dense, conv1d, conv2d, conv-transpose (the DVAE's
    decoder), the scanned stacks (GPT-2 ``h``, the DiT's ``layers``) beside
    per-layer lists (the perceiver's and the WaveNet's ``layers``), and 2-D
    weights that are not kernels (embeddings)."""
    import indextts_tpu.config as jc

    if which == "dvae":
        tree = _dvae_tree()
    else:
        part, _, layer = which.partition(" ")
        tree = _jax_tree(*_configs(jc, layer or "linear"))["s2mel" if part == "dit" else "gpt"]
        if part == "dit":
            tree = tree["cfm"]
    _assert_trees(to_jax(to_torch(tree)), tree)


def _no_kernel_tier(monkeypatch):
    """Make the DiT's kernel tiers raise if a step reached them."""
    from indextts_tpu_torch import nn as tnn
    from indextts_tpu_torch.models.s2mel import dit as tdit

    def refuse(*args, **kwargs):
        raise AssertionError("a training step reached a kernel tier")

    monkeypatch.setattr(tdit, "attention_rope", refuse)
    monkeypatch.setattr(tnn, "mha_flash", refuse)


@pytest.mark.parametrize("input_layer", ["linear", "conv2d2"])
def test_train_step_loss_and_every_gradient_match_jax(input_layer, monkeypatch):
    _no_kernel_tier(monkeypatch)
    ref = _jax_run(input_layer)
    gpt, s2 = _port_configs(input_layer)
    trainable = to_torch(ref["tree"])
    tpt.make_train_state(trainable)
    batch = _batch(0, gpt, s2)
    loss, parts = tpt.train_loss(trainable, gpt, s2, batch, *_noise(0, batch))
    loss.backward()
    got = tuple(float(v.detach()) for v in (loss, parts["gpt"], parts["cfm"]))
    np.testing.assert_allclose(got, ref["losses"][0], atol=ATOL, rtol=RTOL)
    grads = to_jax(tpt.tree_map(
        lambda p: torch.zeros_like(p) if p.grad is None else p.grad, trainable))
    _assert_trees(grads, ref["grads"], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("input_layer", ["linear", "conv2d2"])
def test_adamw_steps_match_jax(input_layer, monkeypatch):
    _no_kernel_tier(monkeypatch)
    ref = _jax_run(input_layer)
    gpt, s2 = _port_configs(input_layer)
    trainable = to_torch(ref["tree"])
    optimizer = tpt.make_train_state(trainable)
    step = tpt.make_train_step(gpt, s2)
    losses = []
    for i in range(STEPS):
        batch = _batch(i, gpt, s2)
        loss, parts = step(trainable, optimizer, batch, *_noise(i, batch))
        losses.append((float(loss), float(parts["gpt"]), float(parts["cfm"])))
    np.testing.assert_allclose(losses, ref["losses"], atol=ATOL, rtol=RTOL)
    _assert_trees(to_jax(trainable), ref["trained"], atol=1e-3, rtol=0)


def _args(tmp_path, steps, resume=False):
    return argparse.Namespace(steps=steps, batch=4, dp=1, tp=1, seed=0,
                              ckpt_dir=str(tmp_path / "ckpt"), save_every=3, log_every=1,
                              data_dir=None, resume=resume, device="cpu")


def _jax_like():
    """The JAX tool's trainable tree and optimizer state at its default
    config (the structure its `load_state` fills)."""
    import indextts_tpu.config as jc
    from indextts_tpu.parallel.train import make_train_state

    tree = _jax_tree(*_configs(jc, "linear"))
    tx, opt_state = make_train_state(tree)
    return tree, opt_state


def test_port_state_loads_in_the_jax_tool(tmp_path):
    from tools.train import latest_state_dir, load_state

    trainable, optimizer, _, _ = ttrain.run(_args(tmp_path, STEPS))
    tree, opt_state = jax.tree_util.tree_map(np.asarray, _jax_like())
    sd = latest_state_dir(str(tmp_path / "ckpt"))
    got_tree, got_opt, step = load_state(sd, tree, opt_state)
    assert step == STEPS
    _assert_trees(jax.tree_util.tree_map(np.asarray, got_tree), to_jax(trainable))
    count, mu, nu = ttrain.adam_moments(trainable, optimizer)
    assert int(got_opt[0].count) == count == STEPS
    _assert_trees(jax.tree_util.tree_map(np.asarray, got_opt[0].mu), to_jax(mu))
    _assert_trees(jax.tree_util.tree_map(np.asarray, got_opt[0].nu), to_jax(nu))


def test_jax_tool_state_resumes_in_the_port(tmp_path):
    from tools.train import latest_state_dir, load_state, save_state

    ref = _jax_run("linear")
    ckpt = str(tmp_path / "ckpt")
    save_state(ckpt, STEPS, ref["trained"], ref["opt_state"])
    trainable = ttrain.init_trainable(*_port_configs("linear"), seed=1, device="cpu")
    optimizer = tpt.make_train_state(trainable)
    assert ttrain.load_state(latest_state_dir(ckpt), trainable, optimizer) == STEPS
    _assert_trees(to_jax(trainable), ref["trained"])
    count, mu, nu = ttrain.adam_moments(trainable, optimizer)
    assert count == STEPS
    _assert_trees(to_jax(mu), ref["opt_state"][0].mu)
    _assert_trees(to_jax(nu), ref["opt_state"][0].nu)
    # the port trains on from it, and the JAX tool reads the result back
    _, _, losses, _ = ttrain.run(_args(tmp_path, STEPS + 2, resume=True))
    assert len(losses) == 2 and np.isfinite(losses).all()
    _, _, step = load_state(latest_state_dir(ckpt), *_jax_like())
    assert step == STEPS + 2


def test_port_resume_matches_uninterrupted(tmp_path):
    t5, _, l5, _ = ttrain.run(_args(tmp_path / "a", 5))
    ttrain.run(_args(tmp_path / "b", 3))
    t_resumed, _, l_resumed, _ = ttrain.run(_args(tmp_path / "b", 5, resume=True))
    np.testing.assert_allclose(l_resumed, l5[3:], atol=1e-6, rtol=1e-5)
    for a, b in zip(tpt.leaves(t5), tpt.leaves(t_resumed)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, rtol=1e-5)


def test_trainer_defaults_to_the_card_and_refuses_dp_tp():
    """The bare ``cuda`` default raises without a card (no CPU fallback);
    dp x tp on CPU ranks trains; a device list that is not dp x tp ranks,
    and a tp that does not divide the heads, are refused."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device trains")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--steps", "1", "--dp", "2", "--tp", "2"])
    assert ttrain.main(["--steps", "1", "--device", "cpu", "--dp", "2", "--tp", "2"]) == 0
    with pytest.raises(ValueError, match="make_mesh"):
        ttrain.main(["--steps", "1", "--device", "cpu,cpu", "--dp", "2", "--tp", "2"])
    with pytest.raises(ValueError, match="heads"):
        ttrain.main(["--steps", "1", "--device", "cpu", "--tp", "8"])


# -- the kernels refuse gradients ---------------------------------------------

def _bf(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


def _attn_args(layout):
    from indextts_tpu_torch.ops.rope import precompute_freqs_cis

    B, T, H = 1, 16, 2
    fc = torch.as_tensor(precompute_freqs_cis(T, 64, 10000.0))
    lens = torch.tensor([12])
    if layout == "heads":
        return [_bf(B, H, T, 64, seed=i) for i in range(3)] + [lens]
    qkv = [_bf(B, T, H * 64, seed=i) for i in range(3)]
    return {"rope": qkv[:2] + [fc, H], "rope attention": qkv + [lens, fc, H],
            "packed": qkv + [lens, H]}[layout]


def _snake_args(folded=False):
    x = _bf(1, 32, 8)
    a, b = torch.zeros(8), torch.zeros(8)
    return [x.view(1, 16, 16), a, b, 2, 8] if folded else [x, a, b]


def _gemv_args(mlp=False, w4=False):
    g = torch.Generator().manual_seed(0)
    K, N = 64, 32

    def q(n, k):
        w = torch.randint(-7, 8, (n, k), generator=g, dtype=torch.int8)
        if not w4:
            return w
        v = w.reshape(n, 1, 2, k // 2)
        return ((v[:, :, 1] << 4) | (v[:, :, 0] & 0xF)).reshape(n, k // 2)

    x = _bf(3, K)
    if mlp:
        return [x, q(N, K), torch.ones(N), _bf(N), q(K, N)]
    return [x, q(N, K)]


def _decode_args(kind):
    from indextts_tpu_torch.models.gpt.gpt2 import (GPT2Dims, init_gpt2, init_kv_cache,
                                                    quantize_gpt2_int8)
    from indextts_tpu_torch.nn import InitRng

    dims = GPT2Dims(1, 128, 2)
    M, S, pos = 2, 64, 5
    valid = torch.zeros((M, S), dtype=torch.bool)
    valid[:, :pos + 1] = True
    if kind == "attention":
        return [_bf(M, 3 * 128), _bf(M, S, 128, seed=1), _bf(M, S, 128, seed=2), valid, pos, 2]
    params = quantize_gpt2_int8(to_torch(init_gpt2(InitRng(0), dims), "cpu", torch.bfloat16))
    if kind == "step":
        cache = init_kv_cache(dims, M, S)
        return [params, _bf(M, 128), dims, pos, cache, valid]
    from indextts_tpu_torch.parallel.mesh import make_mesh, shard_gpt2_tp

    mesh = make_mesh(["cpu", "cpu"])
    return [shard_gpt2_tp(params, mesh), _bf(M, 128), dims, pos,
            init_kv_cache(dims, M, S, mesh=mesh), valid]


def _allreduce_args():
    g = torch.Generator().manual_seed(0)
    own, peer = torch.randn((2, 16), generator=g), torch.randn((2, 16), generator=g)
    return [own, peer, torch.ones(16), _bf(16), _bf(2, 16, seed=3), 0]


WRAPPERS = {
    "rope_qk": ("attn", lambda: _attn_args("rope")),
    "attention_rope": ("attn", lambda: _attn_args("rope attention")),
    "packed_pair_attention": ("attn", lambda: _attn_args("packed")),
    "single_block_attention": ("attn", lambda: _attn_args("heads")),
    "antialias_snake": ("snake", _snake_args),
    "fused_antialias_activation": ("snake", _snake_args),
    "antialias_activation_prefolded": ("snake", lambda: _snake_args(folded=True)),
    "int8_matvec": ("int8", _gemv_args),
    "int8_mlp": ("int8", lambda: _gemv_args(mlp=True)),
    "int4_matvec": ("int8", lambda: _gemv_args(w4=True)),
    "int4_mlp": ("int8", lambda: _gemv_args(mlp=True, w4=True)),
    "decode_attention": ("decode_step", lambda: _decode_args("attention")),
    "fused_decode_step": ("decode_step", lambda: _decode_args("step")),
    "fused_decode_step_tp": ("decode_step_tp", lambda: _decode_args("tp")),
    "tp_allreduce": ("decode_step_tp", _allreduce_args),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_kernel_wrapper_refuses_inputs_that_require_gradients(name):
    """Each wrapper of a hand-written kernel raises, before its CPU / CUDA
    dispatch, while autograd records and an input requires a gradient; under
    torch.no_grad() the same call runs (here: the plain twin)."""
    import importlib

    module, make = WRAPPERS[name]
    fn = getattr(importlib.import_module(f"indextts_tpu_torch.ops.{module}"), name)
    args = make()
    x = args[1] if name.startswith("fused_decode_step") else args[0]
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="has no backward"):
        fn(*args)
    with torch.no_grad():
        out = fn(*args)
    out = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(out.float()).all()
