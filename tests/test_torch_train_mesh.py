"""PyTorch port, training over a dp x tp mesh on CPU ranks
(`make_mesh(["cpu"] * n, tp=...)`): `indextts_tpu_torch/parallel/train.py`'s
mesh step, `parallel/mesh.py::shard_train` / `gather_train` and the
trainer's --dp / --tp, against the JAX package's train step
(`indextts_tpu/parallel/train.py`) and `tools/train.py`.

The tiny trainer config of `tests/test_torch_train.py` (`tools/train.py`'s),
one JAX-initialised tree for both packages, and batches of B = 4 whose rows
differ in length: the two dp ranks hold different numbers of valid CFM
frames and prompt frames (a step that averaged per-rank means would be
wrong on them; `test_unequal_batch_separates_per_rank_means` shows it), and
different text, mel, conditioning and emotion lengths, and rank 1's target
mels are louder. The port's CFM takes the JAX step's draws of (t, z), as
`tests/test_torch_train.py` takes them. Torch runs one intra-op thread.

The JAX references are computed once (module fixtures): the loss and
gradient of the train step's loss function on one device, one step of the
JAX SPMD program at dp=2 x tp=2 on four of the eight CPU devices of
`tests/conftest.py`, in this process, and the loss at tp=8.

Tolerances, `tests/test_torch_train.py`'s: the loss parts and every
gradient leaf at atol 2e-4 / rtol 1e-3; parameters after AdamW steps within
atol 1e-3 (where a gradient entry is ~0 its sign is noise, and a step moves
the entry by up to 2 * lr either way); checkpoints exactly; a resume
against its uninterrupted run at atol 1e-6 / rtol 1e-5. The AdamW moments
are held in gradient units (bias-corrected mu, the root of bias-corrected
nu) at the gradients' tolerance, and a first step's update at atol 1e-5
(a tenth of lr) on every entry whose gradient is beyond 2 * atol, where the
gradients' tolerance fixes its sign.
"""

import argparse
import functools

import numpy as np
import pytest
import torch

import jax

from test_torch_pipeline import _one_torch_thread  # noqa: F401
from test_torch_train import (ATOL, RTOL, _assert_trees, _configs, _draws, _jax_tree,
                              _key, _no_kernel_tier, _port_configs)

from indextts_tpu_torch import train as ttrain
from indextts_tpu_torch.parallel import train as tpt
from indextts_tpu_torch.parallel.mesh import (TRAIN_TP_LEAVES, TrainShards, gather_train,
                                              make_mesh, shard_train)
from indextts_tpu_torch.utils.jax_params import to_jax, to_torch

B, STEPS = 4, 2
B1, B2 = 0.9, 0.999     # optax.adamw's betas, the port's AdamW's
MESHES = [(2, 1), (1, 2), (2, 2)]
# per row: (cond, emo, text, mel, mel frames, prompt frames); rows 0-1 are dp
# rank 0's, rows 2-3 rank 1's (35 valid CFM frames against 26 at step 0)
LENGTHS = ((16, 16, 8, 12, 24, 6), (11, 16, 5, 9, 20, 3),
           (16, 9, 7, 12, 17, 8), (13, 14, 3, 6, 22, 5))
LEN_KEYS = ("cond_lens", "emo_lens", "text_lens", "mel_lens", "mel_frames", "prompt_frames")
# the rows' target mel scales: rank 1's rows louder, so the ranks' mean
# errors differ too
MEL_SCALE = (1.0, 1.0, 4.0, 4.0)


def _np_batch(step: int) -> dict:
    """The JAX tool's synthetic batch for ``step`` with the rows' lengths of
    LENGTHS and mel targets scaled by MEL_SCALE, rotated by ``step`` rows."""
    b = ttrain.synthetic_batch(step, B, *_port_configs("linear"))
    lengths = np.roll(np.asarray(LENGTHS, np.int32), step, axis=0)
    for i, k in enumerate(LEN_KEYS):
        b[k] = np.ascontiguousarray(lengths[:, i])
    scale = np.roll(np.asarray(MEL_SCALE, np.float32), step)
    b["mel_target"] = b["mel_target"] * scale[:, None, None]
    return b


def _batch(step: int) -> dict:
    return ttrain.to_device(_np_batch(step), "cpu")


def _noise(step: int):
    return tuple(torch.tensor(a) for a in _draws(_key(step), _np_batch(step)["mel_target"].shape))


def _jax_loss_fn(gpt, s2):
    """The loss function of `indextts_tpu/parallel/train.py::make_train_step`."""
    from indextts_tpu.models.s2mel.cfm import cfm_loss
    from indextts_tpu.parallel.train import gpt_loss

    def loss_fn(trainable, batch, rng):
        l_gpt = gpt_loss(trainable["gpt"], gpt, batch)
        l_cfm = cfm_loss(trainable["s2mel"]["cfm"], s2, batch["mel_target"],
                         batch["mel_frames"], batch["prompt_frames"], batch["cfm_cond"],
                         batch["style"], rng)
        return l_gpt + l_cfm, {"gpt": l_gpt, "cfm": l_cfm}

    return loss_fn


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX step's loss parts and gradient at step 0, on one device."""
    import indextts_tpu.config as jc

    gpt, s2 = _configs(jc, "linear")
    tree = _jax_tree(gpt, s2)
    (loss, parts), grads = jax.jit(jax.value_and_grad(_jax_loss_fn(gpt, s2), has_aux=True))(
        tree, _np_batch(0), _key(0))
    return {"tree": tree, "losses": (float(loss), float(parts["gpt"]), float(parts["cfm"])),
            "grads": jax.tree_util.tree_map(np.asarray, grads)}


@pytest.fixture(scope="module")
def jax_spmd(jax_ref):
    """One step of the JAX SPMD program at dp=2 x tp=2 (`tools/train.py`'s
    jit_train_step) on four CPU devices: (loss, params, opt_state)."""
    import indextts_tpu.config as jc
    from indextts_tpu.parallel.mesh import make_mesh as jmake_mesh
    from indextts_tpu.parallel.mesh import shard_tree
    from indextts_tpu.parallel.train import jit_train_step, make_train_state, make_train_step

    gpt, s2 = _configs(jc, "linear")
    mesh = jmake_mesh(4, tp=2)
    assert mesh.devices.shape == (2, 2)
    tx, _ = make_train_state(jax_ref["tree"])
    step, param_sh_fn, batch_sh_fn = make_train_step(mesh, gpt, s2, tx)
    param_sh = param_sh_fn(jax_ref["tree"])
    trainable = shard_tree(mesh, jax_ref["tree"], param_sh)
    opt_state = tx.init(trainable)
    batch = _np_batch(0)
    batch = shard_tree(mesh, batch, batch_sh_fn(batch))
    fn = jit_train_step(mesh, step, trainable, opt_state, batch, param_sh, batch_sh_fn(batch))
    trainable, opt_state, loss, _ = fn(trainable, opt_state, batch, _key(0))
    host = functools.partial(jax.tree_util.tree_map, np.asarray)
    return float(loss), host(trainable), host(opt_state)


def _mesh(dp: int, tp: int):
    return None if dp * tp == 1 else make_mesh(["cpu"] * (dp * tp), tp=tp, dp=dp)


def _port_steps(tree, dp: int, tp: int):
    """STEPS port steps at dp x tp from the JAX tree: (losses, the gradient
    of step 0, and the parameters and the AdamW moments (mu, nu) after each
    step, gathered, JAX layouts)."""
    gpt, s2 = _port_configs("linear")
    mesh = _mesh(dp, tp)
    trainable = to_torch(tree)
    if mesh is not None:
        trainable = shard_train(trainable, mesh)
    optimizer = tpt.make_train_state(trainable, mesh=mesh)
    step = tpt.make_train_step(gpt, s2, mesh=mesh)
    losses, params, moments, grads = [], [], [], None
    with pytest.MonkeyPatch.context() as mp:
        _no_kernel_tier(mp)
        for i in range(STEPS):
            loss, parts = step(trainable, optimizer, _batch(i), *_noise(i))
            losses.append((float(loss), float(parts["gpt"]), float(parts["cfm"])))
            if grads is None:
                grads = to_jax(gather_train(tpt.tree_map(lambda p: p.grad, trainable)))
            params.append(to_jax(gather_train(trainable)))
            count, mu, nu = ttrain.adam_moments(trainable, optimizer)
            assert count == i + 1
            moments.append((to_jax(mu), to_jax(nu)))
    return losses, grads, params, moments


@pytest.fixture(scope="module")
def port_run(jax_ref):
    """`_port_steps` at (dp, tp), once per mesh."""
    runs = {}

    def run(dp: int, tp: int):
        if (dp, tp) not in runs:
            runs[dp, tp] = _port_steps(jax_ref["tree"], dp, tp)
        return runs[dp, tp]

    return run


@pytest.mark.parametrize("dp,tp", MESHES, ids=[f"dp{d}-tp{t}" for d, t in MESHES])
def test_mesh_step_loss_and_every_gradient_match_jax(jax_ref, port_run, dp, tp):
    losses, grads, _, _ = port_run(dp, tp)
    np.testing.assert_allclose(losses[0], jax_ref["losses"], atol=ATOL, rtol=RTOL)
    _assert_trees(grads, jax_ref["grads"], atol=ATOL, rtol=RTOL)


def test_unequal_batch_separates_per_rank_means(jax_ref):
    """Averaging the two dp ranks' own CFM means misses the whole batch's
    CFM loss on this batch by far more than the tolerance."""
    from indextts_tpu_torch.models.s2mel.cfm import cfm_loss

    _, s2 = _port_configs("linear")
    dit = to_torch(jax_ref["tree"])["s2mel"]["cfm"]
    b, (t, z) = _batch(0), _noise(0)

    def cfm(rows):
        return float(cfm_loss(dit, s2, b["mel_target"][rows], b["mel_frames"][rows],
                              b["prompt_frames"][rows], b["cfm_cond"][rows], b["style"][rows],
                              t[rows], z[rows]))

    with torch.no_grad():
        whole, halves = cfm(slice(0, 4)), (cfm(slice(0, 2)), cfm(slice(2, 4)))
    np.testing.assert_allclose(whole, jax_ref["losses"][2], atol=ATOL, rtol=RTOL)
    assert abs(np.mean(halves) - whole) > 10 * (ATOL + RTOL * whole), (halves, whole)


def _in_gradient_units(moments, count):
    """(mu, nu) after ``count`` steps as the bias-corrected mu, a weighted
    mean of the steps' gradients, and the root of the bias-corrected nu,
    their weighted RMS: each within the gradients' tolerance where the
    gradients are."""
    mu, nu = moments
    tmap = jax.tree_util.tree_map
    return (tmap(lambda m: m / (1 - B1 ** count), mu),
            tmap(lambda v: np.sqrt(v / (1 - B2 ** count)), nu))


def _assert_moments(got, want, count):
    for a, b in zip(_in_gradient_units(got, count), _in_gradient_units(want, count)):
        _assert_trees(a, b, atol=ATOL, rtol=RTOL)


def _assert_first_update(got, want, p0, grads):
    """One AdamW step from ``p0`` moves an entry by about -lr * sign(g): the
    two updates agree to atol 1e-5 wherever |g| > 2 * ATOL, and the rest,
    whose sign is noise, move by at most 2 * lr apart."""
    leaves = [jax.tree_util.tree_leaves(t) for t in (got, want, p0, grads)]
    checked = 0
    for a, b, p, g in zip(*leaves):
        sure = np.abs(g) > 2 * ATOL
        np.testing.assert_allclose((a - p)[sure], (b - p)[sure], atol=1e-5, rtol=0)
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)
        checked += int(sure.sum())
    return checked


def _keyed(tree):
    return {jax.tree_util.keystr(kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_jax_spmd_step_matches_port_mesh_step(jax_ref, jax_spmd, port_run):
    """One step of the JAX SPMD program at dp=2 x tp=2: its loss is the JAX
    single-device loss, and the port's dp=2 x tp=2 step gives its loss,
    its AdamW moments and, gathered, its update.

    One departure is the JAX program's: its gradient of the conformers'
    depthwise convolution kernels (the only such leaves) is twice its own
    single-device gradient on this mesh, which its moments show and its
    first update, scale-free, does not. The port's is the single-device
    gradient (`test_mesh_step_loss_and_every_gradient_match_jax`), so those
    leaves' JAX moments are held at half that gradient's scale."""
    loss, params, opt_state = jax_spmd
    np.testing.assert_allclose(loss, jax_ref["losses"][0], atol=ATOL, rtol=RTOL)
    losses, _, port_params, moments = port_run(2, 2)
    np.testing.assert_allclose(losses[0][0], loss, atol=ATOL, rtol=RTOL)

    assert int(opt_state[0].count) == 1
    mu, nu = _keyed(opt_state[0].mu), _keyed(opt_state[0].nu)
    grads = _keyed(jax_ref["grads"])
    doubled = sorted(k for k in mu if not np.allclose(mu[k] / (1 - B1), grads[k],
                                                      atol=ATOL, rtol=RTOL))
    assert doubled == sorted(k for k in mu if k.endswith("['depthwise_conv']['kernel']"))
    assert len(doubled) == 2
    for k in doubled:
        np.testing.assert_allclose(mu[k] / (1 - B1), 2 * grads[k], atol=ATOL, rtol=RTOL)
        mu[k], nu[k] = mu[k] / 2, nu[k] / 4
    got = tuple(_keyed(m) for m in moments[0])
    _assert_moments(got, (mu, nu), 1)

    checked = _assert_first_update(port_params[0], params, jax_ref["tree"], jax_ref["grads"])
    sure = [g[np.abs(g) > 2 * ATOL] for g in grads.values()]
    assert checked == sum(g.size for g in sure)
    # the entries held tight carry all but 1e-3 of the gradient's squared norm
    assert sum((g ** 2).sum() for g in sure) >= 0.999 * sum((g ** 2).sum()
                                                            for g in grads.values())


def test_shard_gather_round_trip_is_bit_identical(jax_ref):
    trainable = to_torch(jax_ref["tree"])
    for dp, tp in MESHES + [(1, 4)]:
        _assert_trees(to_jax(gather_train(shard_train(trainable, _mesh(dp, tp)))),
                      jax_ref["tree"])


def _names(tree, path=()):
    if isinstance(tree, dict):
        return {n: v for k, sub in tree.items() for n, v in _names(sub, path + (k,)).items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, TrainShards):
        return {n: v for i, sub in enumerate(tree) for n, v in _names(sub, path + (i,)).items()}
    return {path: tree}


def test_train_layout_shards_what_jax_shards(jax_ref):
    """The leaves `shard_train` cuts are those the JAX step's `_spec_for_path`
    shards over tp (6 kinds), each cut along the spec's axis on the tp
    ranks; every leaf JAX replicates is one tensor, so no copy of it can
    drift from another after a step."""
    from indextts_tpu.parallel.mesh import _spec_for_path

    def jax_name(kp):
        return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)

    flat = jax.tree_util.tree_flatten_with_path(jax_ref["tree"]["gpt"])[0]
    specs = {jax_name(kp): _spec_for_path(jax_name(kp), leaf) for kp, leaf in flat}
    sharded = {n for n, s in specs.items() if any(a is not None for a in s)}
    assert len(specs) == 137 and sorted(sharded) == sorted(
        f"gpt.h.{a}.{b}.{'kernel' if c == 'weight' else c}" for a, b, c in TRAIN_TP_LEAVES)

    mesh = _mesh(2, 2)
    layout = _names(shard_train(to_torch(jax_ref["tree"]), mesh))
    cut = {n: v for n, v in layout.items() if isinstance(v, TrainShards)}
    L = _port_configs("linear")[0].layers
    assert len(cut) == 6 * L and all(n[:3] == ("gpt", "gpt", "h") for n in cut)
    for n, v in cut.items():
        spec = specs[f"gpt.h.{n[4]}.{n[5]}.{'kernel' if n[6] == 'weight' else n[6]}"]
        axis = TRAIN_TP_LEAVES[n[4:]][0]
        # the spec's tp axis past the layer axis; the JAX (in, out) kernel's
        # is the port's (out, in) weight's other one, a bias has one axis
        jax_axis = list(spec).index("tp") - 1
        assert axis == (jax_axis if v[0].ndim == 1 else 1 - jax_axis), n
        assert [p.device for p in v] == list(mesh.devices[:2])
        assert sum(p.shape[axis] for p in v) == 2 * v[0].shape[axis]
    assert all(isinstance(v, torch.Tensor) for n, v in layout.items() if n not in cut)
    assert layout.keys() == _names(to_torch(jax_ref["tree"])).keys()
    # the state refuses a tree not cut for its mesh
    for tree in (to_torch(jax_ref["tree"]), shard_train(to_torch(jax_ref["tree"]), _mesh(1, 4))):
        with pytest.raises(ValueError, match="not where shard_train"):
            tpt.make_train_state(tree, mesh=mesh)


def test_two_mesh_steps_match_two_single_device_steps(jax_ref, port_run):
    single_losses, single_grads, single_params, single_moments = port_run(1, 1)
    losses, _, params, moments = port_run(2, 2)
    np.testing.assert_allclose(losses, single_losses, atol=ATOL, rtol=RTOL)
    _assert_first_update(params[0], single_params[0], jax_ref["tree"], single_grads)
    for i in range(STEPS):
        _assert_moments(moments[i], single_moments[i], i + 1)
    _assert_trees(params[-1], single_params[-1], atol=1e-3, rtol=0)


def _args(tmp_path, steps, dp=2, tp=2, resume=False):
    return argparse.Namespace(steps=steps, batch=B, dp=dp, tp=tp, seed=0,
                              ckpt_dir=tmp_path and str(tmp_path / "ckpt"), save_every=2,
                              log_every=1, data_dir=None, resume=resume, device="cpu")


def test_trainer_at_dp_tp_gives_the_single_device_losses():
    """`python -m indextts_tpu_torch.train --steps 2 --batch 4 --dp 2 --tp 2
    --device cpu` against the same at dp = tp = 1: losses within rel 1e-5."""
    _, _, mesh_losses, _ = ttrain.run(_args(None, STEPS))
    _, _, losses, _ = ttrain.run(_args(None, STEPS, dp=1, tp=1))
    assert len(losses) == STEPS
    np.testing.assert_allclose(mesh_losses, losses, atol=0, rtol=1e-5)


def _jax_like():
    import indextts_tpu.config as jc
    from indextts_tpu.parallel.train import make_train_state

    tree = _jax_tree(*_configs(jc, "linear"))
    return tree, make_train_state(tree)[1]


def test_mesh_state_loads_in_the_jax_tool(tmp_path):
    from tools.train import latest_state_dir, load_state

    trainable, optimizer, _, _ = ttrain.run(_args(tmp_path, STEPS))
    assert isinstance(trainable["gpt"]["gpt"]["h"][0]["mlp"]["c_fc"]["weight"], TrainShards)
    tree, opt_state = jax.tree_util.tree_map(np.asarray, _jax_like())
    got_tree, got_opt, step = load_state(latest_state_dir(str(tmp_path / "ckpt")), tree,
                                         opt_state)
    assert step == STEPS
    _assert_trees(jax.tree_util.tree_map(np.asarray, got_tree), to_jax(gather_train(trainable)))
    count, mu, nu = ttrain.adam_moments(trainable, optimizer)
    assert int(got_opt[0].count) == count == STEPS
    _assert_trees(jax.tree_util.tree_map(np.asarray, got_opt[0].mu), to_jax(mu))
    _assert_trees(jax.tree_util.tree_map(np.asarray, got_opt[0].nu), to_jax(nu))


def test_jax_tool_state_resumes_at_a_mesh(tmp_path, jax_spmd):
    """The JAX SPMD step's state, saved by `tools/train.py`, loads into the
    port at dp=2 x tp=2 exactly, trains on, and the JAX tool reads the
    result back."""
    from tools.train import latest_state_dir, load_state, save_state

    _, params, opt_state = jax_spmd
    ckpt = str(tmp_path / "ckpt")
    save_state(ckpt, 1, params, opt_state)
    gpt, s2 = _port_configs("linear")
    mesh = _mesh(2, 2)
    trainable = shard_train(ttrain.init_trainable(gpt, s2, seed=1, device="cpu"), mesh)
    optimizer = tpt.make_train_state(trainable, mesh=mesh)
    assert ttrain.load_state(latest_state_dir(ckpt), trainable, optimizer) == 1
    _assert_trees(to_jax(gather_train(trainable)), params)
    count, mu, nu = ttrain.adam_moments(trainable, optimizer)
    assert count == 1
    _assert_trees(to_jax(mu), opt_state[0].mu)
    _assert_trees(to_jax(nu), opt_state[0].nu)
    _, _, losses, _ = ttrain.run(_args(tmp_path, 3, resume=True))
    assert len(losses) == 2 and np.isfinite(losses).all()
    _, _, step = load_state(latest_state_dir(ckpt), *_jax_like())
    assert step == 3


def test_mesh_resume_matches_uninterrupted(tmp_path):
    """2 steps + save + resume + 2 steps at dp=2 x tp=2 against 4 straight;
    the saved state loads at other meshes to the same gathered tree and
    moments, bit for bit."""
    straight, _, l4, _ = ttrain.run(_args(tmp_path / "a", 4))
    ttrain.run(_args(tmp_path / "b", 2))
    resumed, _, l_resumed, _ = ttrain.run(_args(tmp_path / "b", 4, resume=True))
    np.testing.assert_allclose(l_resumed, l4[2:], atol=1e-6, rtol=1e-5)
    _assert_trees(to_jax(gather_train(resumed)), to_jax(gather_train(straight)),
                  atol=1e-6, rtol=1e-5)

    saved = str(tmp_path / "b" / "ckpt" / "state-4")
    gpt, s2 = _port_configs("linear")
    loaded = []
    for dp, tp in ((2, 2), (1, 2), (1, 1)):
        mesh = _mesh(dp, tp)
        tree = ttrain.init_trainable(gpt, s2, seed=1, device="cpu")
        tree = tree if mesh is None else shard_train(tree, mesh)
        optimizer = tpt.make_train_state(tree, mesh=mesh)
        assert ttrain.load_state(saved, tree, optimizer) == 4
        count, mu, nu = ttrain.adam_moments(tree, optimizer)
        loaded.append((to_jax(gather_train(tree)), to_jax(mu), to_jax(nu), count))
    for got in loaded[1:]:
        assert got[3] == loaded[0][3] == 4
        for a, b in zip(got[:3], loaded[0][:3]):
            _assert_trees(a, b)


def test_batch_that_does_not_split_over_dp_raises(jax_ref):
    """B = 3 at dp = 2: JAX's ``device_put`` of the batch raises ValueError,
    and so does the port's step (nothing is padded)."""
    import indextts_tpu.config as jc
    from indextts_tpu.parallel.mesh import make_mesh as jmake_mesh
    from indextts_tpu.parallel.mesh import shard_tree
    from indextts_tpu.parallel.train import make_train_state, make_train_step

    batch = {k: v[:3] for k, v in _np_batch(0).items()}
    mesh = jmake_mesh(4, tp=2)
    tx, _ = make_train_state(jax_ref["tree"])
    _, _, batch_sh_fn = make_train_step(mesh, *_configs(jc, "linear"), tx)
    with pytest.raises(ValueError):
        shard_tree(mesh, batch, batch_sh_fn(batch))

    gpt, s2 = _port_configs("linear")
    mesh = _mesh(2, 2)
    trainable = shard_train(to_torch(jax_ref["tree"]), mesh)
    optimizer = tpt.make_train_state(trainable, mesh=mesh)
    t, z = (a[:3] for a in _noise(0))
    with pytest.raises(ValueError, match="does not split over dp=2"):
        tpt.make_train_step(gpt, s2, mesh=mesh)(
            trainable, optimizer, ttrain.to_device(batch, "cpu"), t, z)


def test_tp_that_cuts_a_head_runs_in_jax_and_raises_in_the_port(jax_ref):
    """A kept departure: the JAX GSPMD step takes tp = 8 on the tiny
    config's 4 heads (each head cut in two) and gives the single-device
    loss; the port's step takes only a tp that divides the heads, as its
    serving mesh does."""
    import indextts_tpu.config as jc
    from indextts_tpu.parallel.mesh import make_mesh as jmake_mesh
    from indextts_tpu.parallel.mesh import shard_tree
    from indextts_tpu.parallel.train import make_train_state, make_train_step

    gpt, s2 = _configs(jc, "linear")
    assert gpt.heads == 4
    mesh = jmake_mesh(8, tp=8)
    tx, _ = make_train_state(jax_ref["tree"])
    _, param_sh_fn, batch_sh_fn = make_train_step(mesh, gpt, s2, tx)
    tree = shard_tree(mesh, jax_ref["tree"], param_sh_fn(jax_ref["tree"]))
    batch = _np_batch(0)
    loss, _ = jax.jit(_jax_loss_fn(gpt, s2))(tree, shard_tree(mesh, batch, batch_sh_fn(batch)),
                                             _key(0))
    np.testing.assert_allclose(float(loss), jax_ref["losses"][0], atol=ATOL, rtol=RTOL)

    with pytest.raises(ValueError, match="does not divide the GPT's 4 heads"):
        tpt.make_train_step(*_port_configs("linear"), mesh=_mesh(1, 8))
