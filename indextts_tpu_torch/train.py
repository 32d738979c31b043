"""The training loop with checkpoint/resume, on the port (a copy of the JAX
package's `tools/train.py`).

    python -m indextts_tpu_torch.train --steps 1000 --ckpt-dir runs/exp0 \
        --save-every 100 [--resume] [--data-dir DIR] [--dp 2 --tp 2] [--device cuda]

One step is `parallel/train.py`'s: GPT cross-entropy + the CFM
flow-matching loss, AdamW, in f32, on one device or, with ``--dp`` /
``--tp`` above 1, over a dp x tp mesh (`parallel/mesh.py::make_mesh`; the
tree in `shard_train`'s layout). Data comes from the JAX tool's synthetic
generator (the same numpy draws) or from a directory of ``.npz`` batches,
each file one batch with the step's input keys.

``--device`` names one device, which then holds every rank (``cpu``: dp x
tp CPU ranks; ``cuda:0``: the ranks co-located on the card), or a comma
list of dp x tp devices, one a rank in the mesh's row-major order. Its
default is ``cuda``, which raises without a card: there is no CPU
fallback; the tests pass ``cpu``.

Differences from `tools/train.py`, and only these: ``--device``; the DiT
trains on its dense attention tier; each step's CFM draws come from a
`torch.Generator` on the host seeded from (seed, step), where the JAX tool
folds the step into its key. So save and resume at any step reproduce the
uninterrupted run, as there; the draws do not depend on the mesh.

Checkpoint layout, the JAX tool's: ``<ckpt-dir>/state-<step>/params.npz``
(the unsharded trainable tree in the JAX layouts, `utils/jax_params.py::
to_jax`), ``opt_state.npz`` (optax's entry names: ``0/count``,
``0/mu/<param path>``, ``0/nu/<param path>``) and ``STEP``. Resume picks
the newest state dir. Either package resumes the other's state, at any
mesh.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np
import torch

from indextts_tpu_torch.config import (ConditionModuleConfig, DiTConfig, GPTConfig,
                                       LengthRegulatorConfig, S2MelConfig, StyleEncoderConfig,
                                       WaveNetConfig)
from indextts_tpu_torch.models.gpt import unified_voice as uv
from indextts_tpu_torch.models.s2mel.cfm import cfm_noise
from indextts_tpu_torch.models.s2mel.dit import init_dit
from indextts_tpu_torch.nn import InitRng
from indextts_tpu_torch.parallel.mesh import gather_train, make_mesh, shard_like, shard_train
from indextts_tpu_torch.parallel.train import (leaves, make_train_state, make_train_step,
                                               tree_map)
from indextts_tpu_torch.utils.checkpoint import load_params_npz, save_params_npz
from indextts_tpu_torch.utils.jax_params import to_jax, to_torch


def synthetic_batch(step: int, B: int, gpt_cfg, s2_cfg) -> dict:
    """The JAX tool's synthetic batch for ``step``, as numpy arrays."""
    r = np.random.default_rng(1234 + step)
    T_cond, Lt, Lm = 16, 8, 12
    T_mel = 24
    cd = gpt_cfg.cond_input_dim
    f32, i32 = np.float32, np.int32
    return {
        "cond_emb": r.standard_normal((B, T_cond, cd)).astype(f32),
        "cond_lens": np.full((B,), T_cond, i32),
        "emo_emb": r.standard_normal((B, T_cond, cd)).astype(f32),
        "emo_lens": np.full((B,), T_cond, i32),
        "text_ids": r.integers(2, gpt_cfg.number_text_tokens, (B, Lt)).astype(i32),
        "text_lens": np.full((B,), Lt, i32),
        "mel_codes": r.integers(0, gpt_cfg.start_mel_token, (B, Lm)).astype(i32),
        "mel_lens": np.full((B,), Lm, i32),
        "mel_target": r.standard_normal((B, T_mel, s2_cfg.DiT.in_channels)).astype(f32),
        "mel_frames": np.full((B,), T_mel, i32),
        "prompt_frames": np.full((B,), 6, i32),
        "cfm_cond": r.standard_normal(
            (B, T_mel, s2_cfg.length_regulator.channels)).astype(f32),
        "style": r.standard_normal((B, s2_cfg.style_encoder.dim)).astype(f32),
    }


def npz_batch(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device`` (floats f32, integers int64)."""
    return {k: torch.as_tensor(v, dtype=torch.float32 if np.issubdtype(v.dtype, np.floating)
                               else torch.long, device=device) for k, v in batch.items()}


def step_generator(seed: int, step: int) -> torch.Generator:
    """The host generator of a step's CFM draws, seeded from (seed, step)."""
    s = np.random.SeedSequence([seed % 2 ** 32, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(s))


def latest_state_dir(ckpt_dir: str):
    dirs = sorted(glob.glob(os.path.join(ckpt_dir, "state-*")),
                  key=lambda p: int(p.rsplit("-", 1)[1]))
    return dirs[-1] if dirs else None


def adam_moments(trainable, optimizer):
    """(count, mu, nu): the AdamW state as unsharded trees shaped like
    ``gather_train(trainable)`` (zeros before the first step, as
    optax.adamw's init)."""
    def moment(name):
        def get(p):
            st = optimizer.state.get(p)
            return st[name] if st else torch.zeros_like(p)
        return gather_train(tree_map(get, trainable))

    states = [optimizer.state.get(p) for g in optimizer.param_groups for p in g["params"]]
    count = int(states[0]["step"]) if states[0] else 0
    return count, moment("exp_avg"), moment("exp_avg_sq")


def save_state(ckpt_dir: str, step: int, trainable, optimizer) -> str:
    d = os.path.join(ckpt_dir, f"state-{step}")
    os.makedirs(d, exist_ok=True)
    save_params_npz(os.path.join(d, "params.npz"), to_jax(gather_train(trainable)))
    count, mu, nu = adam_moments(trainable, optimizer)
    save_params_npz(os.path.join(d, "opt_state.npz"),
                    {"0": {"count": np.asarray(count, np.int32), "mu": to_jax(mu),
                           "nu": to_jax(nu)}})
    with open(os.path.join(d, "STEP"), "w", encoding="utf-8") as f:
        f.write(str(step))
    return d


def load_state(state_dir: str, trainable, optimizer) -> int:
    """Read a state dir (either package's, saved at any mesh) into
    ``trainable`` and ``optimizer`` in place, cut to ``trainable``'s layout;
    returns its step."""
    # the entry names in the JAX layouts: one element a leaf, nothing copied
    # off the device
    like = to_jax(tree_map(lambda p: p.detach()[(slice(0, 1),) * p.ndim],
                           gather_train(trainable)))
    params = leaves(trainable)

    def cut(tree):
        # converted on the trainable's device (on the card: no host copies or
        # transposes), then cut as the trainable is
        return leaves(shard_like(to_torch(tree, params[0].device), trainable))

    loaded = cut(load_params_npz(os.path.join(state_dir, "params.npz"), like))
    opt = load_params_npz(os.path.join(state_dir, "opt_state.npz"),
                          {"0": {"count": 0, "mu": like, "nu": like}})["0"]
    count = int(opt["count"])
    with torch.no_grad():
        for p, v in zip(params, loaded):
            p.copy_(v)
    optimizer.state.clear()
    if count:
        for p, m, v in zip(params, cut(opt["mu"]), cut(opt["nu"])):
            optimizer.state[p] = {"step": torch.tensor(float(count)),
                                  "exp_avg": m.to(p.device).contiguous(),
                                  "exp_avg_sq": v.to(p.device).contiguous()}
    with open(os.path.join(state_dir, "STEP"), encoding="utf-8") as f:
        return int(f.read().strip())


def tiny_configs():
    """The JAX tool's bring-up configs (pass the full GPTConfig() and
    S2MelConfig() for the real model)."""
    cond = ConditionModuleConfig(output_size=32, linear_units=48, attention_heads=2,
                                 num_blocks=1, input_layer="linear", perceiver_mult=2)
    gpt_cfg = GPTConfig(layers=2, model_dim=64, heads=4, max_text_tokens=32, max_mel_tokens=64,
                        number_text_tokens=40, number_mel_codes=50, start_mel_token=48,
                        stop_mel_token=49, cond_input_dim=32, condition_module=cond,
                        emo_condition_module=cond)
    s2_cfg = S2MelConfig(
        DiT=DiTConfig(hidden_dim=32, num_heads=2, depth=1, in_channels=8, content_dim=16,
                      final_layer_type="wavenet"),
        wavenet=WaveNetConfig(hidden_dim=32, num_layers=2, kernel_size=5),
        style_encoder=StyleEncoderConfig(dim=12),
        length_regulator=LengthRegulatorConfig(channels=16, in_channels=16))
    return gpt_cfg, s2_cfg


def init_trainable(gpt_cfg, s2_cfg, seed: int, device) -> dict:
    """The trainable tree from ``seed``, drawn on ``device``, in the port's
    layouts."""
    rng = InitRng(seed, device)
    return to_torch({"gpt": uv.init_unified_voice(rng, gpt_cfg),
                     "s2mel": {"cfm": init_dit(rng, s2_cfg)}})


def train_mesh(device: str, dp: int, tp: int):
    """(the first device, the mesh or None): ``device`` is one device for
    every rank or a comma list of dp * tp devices (`make_mesh` raises
    ValueError where the count is not dp * tp); None at dp = tp = 1 on one
    device, the single-device step. A CUDA device without a card raises
    RuntimeError."""
    names = [n.strip() for n in device.split(",")]
    devices = [torch.device(n) for n in names]
    if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: CUDA is not available (the trainer has no "
                           "CPU fallback; pass --device cpu to train on the host)")
    if len(names) == 1 and dp * tp == 1:
        return devices[0], None
    mesh = make_mesh(names * (dp * tp) if len(names) == 1 else names, tp=tp, dp=dp)
    return mesh.devices[0], mesh


def run(args, gpt_cfg=None, s2_cfg=None):
    """The loop. Returns (trainable, optimizer, losses, step_seconds):
    ``trainable`` in the mesh's layout (`gather_train` gives the unsharded
    tree), ``losses`` (loss, gpt, cfm) at every ``log_every``-th step,
    ``step_seconds`` each step's wall time (synchronized on the card)."""
    device, mesh = train_mesh(args.device, args.dp, args.tp)
    if gpt_cfg is None:
        gpt_cfg, s2_cfg = tiny_configs()
    train_step = make_train_step(gpt_cfg, s2_cfg, mesh=mesh)
    trainable = init_trainable(gpt_cfg, s2_cfg, args.seed, device)
    if mesh is not None:
        trainable = shard_train(trainable, mesh)
    optimizer = make_train_state(trainable, mesh=mesh)

    start_step = 0
    if args.resume:
        sd = latest_state_dir(args.ckpt_dir)
        if sd is not None:
            start_step = load_state(sd, trainable, optimizer)
            print(f">> resumed from {sd} (step {start_step})")

    data_files = (sorted(glob.glob(os.path.join(args.data_dir, "*.npz")))
                  if args.data_dir else None)
    losses, seconds = [], []
    saved = None
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        ts = time.perf_counter()
        if data_files:
            batch = npz_batch(data_files[step % len(data_files)])
        else:
            batch = synthetic_batch(step, args.batch, gpt_cfg, s2_cfg)
        batch = to_device(batch, device)
        t, z = cfm_noise(batch["mel_target"], step_generator(args.seed, step))
        loss, parts = train_step(trainable, optimizer, batch, t, z)
        if device.type == "cuda":
            for d in dict.fromkeys(mesh.devices if mesh is not None else [device]):
                torch.cuda.synchronize(d)
        seconds.append(time.perf_counter() - ts)
        if (step + 1) % args.log_every == 0:
            row = (float(loss), float(parts["gpt"]), float(parts["cfm"]))
            losses.append(row)
            print(f"step {step + 1}: loss={row[0]:.4f} gpt={row[1]:.4f} cfm={row[2]:.4f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.save_every == 0:
            saved = save_state(args.ckpt_dir, step + 1, trainable, optimizer)
            print(f">> saved {saved}", flush=True)
    if args.ckpt_dir and saved != os.path.join(args.ckpt_dir, f"state-{args.steps}"):
        save_state(args.ckpt_dir, args.steps, trainable, optimizer)
    return trainable, optimizer, losses, seconds


def main(argv=None):
    ap = argparse.ArgumentParser(description="IndexTTS2 training loop on the PyTorch port")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data-dir", default=None,
                    help="Directory of .npz batches (default: synthetic)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="Torch device of every rank, or a comma list of dp x tp devices "
                         "(default: the card; no CPU fallback)")
    args = ap.parse_args(argv)
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
