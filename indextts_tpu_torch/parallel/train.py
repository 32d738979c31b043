"""The training step of the port (counterpart of `indextts_tpu/parallel/train.py`).

One step over both model families, in f32 with TF32 off:
- GPT (UnifiedVoice): teacher-forced cross-entropy on the text and mel
  streams, 0.01 * text + mel;
- CFM: the OT flow-matching loss of the s2mel DiT (`models/s2mel/cfm.py::
  cfm_loss`), on the DiT's dense attention tier;
- AdamW over every leaf (biases, norms and embeddings included):
  `torch.optim.AdamW(lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
  weight_decay=0.01)`, which is `optax.adamw(1e-4, weight_decay=0.01)`'s
  update (the decay decoupled, p <- p - lr*wd*p - lr*m_hat/(sqrt(v_hat) +
  eps)); its exp_avg / exp_avg_sq / step are optax's mu / nu / count.

The trainable tree is ``{"gpt": <UnifiedVoice>, "s2mel": {"cfm": <DiT>}}``
in the port's layouts (`utils/jax_params.py::to_torch`).

The JAX step is one SPMD program over a (dp, tp) mesh. Here a mesh
(`parallel/mesh.py::make_mesh`, sp 1) trains the tree of `shard_train`:
the batch's rows cut into dp equal blocks (a batch that does not divide
raises ValueError, as JAX's ``device_put`` does), the CFM draws taken once
for the whole batch and cut alike; each dp rank runs the loss on its rows
on its devices, the GPT-2 stack shard by shard over tp
(`models/gpt/gpt2.py::_layer_tp`), each rank's sums over the whole
batch's counts (cross-entropy: the masked NLL over the batch's mask
count; CFM: the error over the batch's valid frames times channels), so
the ranks' losses add up to the single-device loss. The ranks run one
after another; each one's backward adds its gradient into the leaves in
rank order (a replicated leaf is one tensor that every rank reads through
a differentiable copy), then one AdamW update runs over the sharded
leaves: elementwise, so a shard's update is its slice of the unsharded
one. tp must divide the GPT's heads (ValueError otherwise); the JAX step
also takes a tp that cuts through a head, which the port does not.

No hand-written kernel runs in a step: they have no backward, and each
refuses inputs that require a gradient (`ops/cuda.py::refuse_grad`).

A step runs under PyTorch's deterministic algorithms (and cuDNN's), so that
it gives the same bits every time on one card, as the JAX step does: on the
card the library's default backward of a gather and some convolutions sum
with atomics, and a save-and-resume then strays from the uninterrupted run
(the key bias's gradient, zero in exact arithmetic, is rounding noise that
Adam's normalisation turns into a full-size step).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from indextts_tpu_torch.config import GPTConfig, S2MelConfig
from indextts_tpu_torch.models.gpt import unified_voice as uv
from indextts_tpu_torch.models.s2mel.cfm import cfm_loss, cfm_loss_sums
from indextts_tpu_torch.parallel.mesh import Mesh, TrainShards, check_train_layout

Batch = Dict[str, torch.Tensor]


Sums = Tuple[torch.Tensor, torch.Tensor]


def cross_entropy_sums(logits: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor) -> Sums:
    """(the summed negative log-likelihood over the masked positions, from
    an f32 log-softmax; the mask's count)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return (nll * mask).sum(), mask.float().sum()


def _mean(sums: Sums) -> torch.Tensor:
    return sums[0] / torch.clamp(sums[1], min=1.0)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the masked positions."""
    return _mean(cross_entropy_sums(logits, targets, mask))


def gpt_loss_sums(params, cfg: GPTConfig, batch: Batch) -> Dict[str, Sums]:
    """The text and mel cross-entropies of the teacher-forced pass as
    `cross_entropy_sums`: {"text", "mel"}."""
    cond_latents = uv.get_conditioning(params, cfg, batch["cond_emb"], batch["cond_lens"])
    emo_vec = uv.get_emovec(params, cfg, batch["emo_emb"], batch["emo_lens"])
    text_logits, mel_logits, tgt = uv.forward_logits(
        params, cfg, cond_latents, emo_vec, batch["text_ids"], batch["text_lens"],
        batch["mel_codes"], batch["mel_lens"])
    t_mask = torch.ones(tgt["text_targets"].shape, device=text_logits.device)
    m_mask = torch.ones(tgt["mel_targets"].shape, device=mel_logits.device)
    return {"text": cross_entropy_sums(text_logits, tgt["text_targets"], t_mask),
            "mel": cross_entropy_sums(mel_logits, tgt["mel_targets"], m_mask)}


def gpt_loss(params, cfg: GPTConfig, batch: Batch) -> torch.Tensor:
    """Teacher-forced text + mel cross-entropy, 0.01 * text + mel."""
    sums = gpt_loss_sums(params, cfg, batch)
    return 0.01 * _mean(sums["text"]) + _mean(sums["mel"])


def train_loss(trainable, gpt_cfg: GPTConfig, s2_cfg: S2MelConfig, batch: Batch,
               t: torch.Tensor, z: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(GPT loss + CFM loss, {"gpt", "cfm"}), the CFM at the draws (t, z)
    (`models/s2mel/cfm.py::cfm_noise`)."""
    l_gpt = gpt_loss(trainable["gpt"], gpt_cfg, batch)
    l_cfm = cfm_loss(trainable["s2mel"]["cfm"], s2_cfg, batch["mel_target"],
                     batch["mel_frames"], batch["prompt_frames"], batch["cfm_cond"],
                     batch["style"], t, z)
    return l_gpt + l_cfm, {"gpt": l_gpt, "cfm": l_cfm}


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree, depth first in dict and list order (the
    optimizer's parameter order)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every tensor of ``tree``, keeping its container types
    (`utils/jax_params.py`'s `Kernel` and `LayerStack` marks, and
    `parallel/mesh.py`'s `TrainShards` with its cut, included)."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, TrainShards):
        return tree.like(fn(v) for v in tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def make_train_state(trainable, lr: float = 1e-4,
                     mesh: Optional[Mesh] = None) -> torch.optim.AdamW:
    """Mark every leaf of ``trainable`` as requiring a gradient and return
    the AdamW over them (optax.adamw(lr, weight_decay=0.01)'s update). With
    a ``mesh``, ``trainable`` is `shard_train`'s tree over it
    (`check_train_layout`)."""
    if mesh is not None:
        check_train_layout(trainable, mesh)
    params = leaves(trainable)
    for p in params:
        p.requires_grad_(True)
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms and cuDNN's deterministic
    convolutions for the block, the earlier settings restored after it."""
    cudnn = torch.backends.cudnn
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(), cudnn.deterministic,
              cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        cudnn.deterministic, cudnn.benchmark = before[2:]


def make_train_step(gpt_cfg: GPTConfig, s2_cfg: S2MelConfig, mesh: Optional[Mesh] = None):
    """The step ``train_step(trainable, optimizer, batch, t, z) -> (loss,
    {"gpt", "cfm"})``: the loss at the draws (t, z) (the whole batch's), its
    gradient, one AdamW update of ``trainable`` in place; the returned
    losses are detached. Without a mesh, one device; with one, the tree of
    `shard_train` over it (the module docstring). Matmuls and convolutions
    run in full f32 (TF32 off, as `IndexTTS2` sets it), under
    `deterministic` (cuBLAS then needs a fixed workspace,
    CUBLAS_WORKSPACE_CONFIG, set here unless the caller set it)."""
    if mesh is not None:
        if mesh.sp != 1:
            raise ValueError(f"the train step has no sp axis, got {mesh}")
        if gpt_cfg.heads % mesh.tp:
            raise ValueError(f"tp={mesh.tp} does not divide the GPT's {gpt_cfg.heads} heads")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    def train_step(trainable, optimizer: torch.optim.Optimizer, batch: Batch,
                   t: torch.Tensor, z: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        with deterministic():
            if mesh is None:
                with torch.enable_grad():
                    loss, parts = train_loss(trainable, gpt_cfg, s2_cfg, batch, t, z)
                loss.backward()
            else:
                loss, parts = _mesh_loss_backward(trainable, gpt_cfg, s2_cfg, mesh, batch, t, z)
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is None:  # an unused leaf: optax's zero gradient (and decay)
                        p.grad = torch.zeros_like(p)
            optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    return train_step


def rank_view(trainable, mesh: Mesh, d: int):
    """What dp rank ``d`` computes with: every replicated leaf read on the
    rank's device (rank (d, 0)'s) through a differentiable copy (the leaf
    itself where it lies there), and at tp > 1 the GPT-2 stack as the
    tensor-parallel tree `models/gpt/gpt2.py` runs shard by shard: tp rank
    t's layers on rank (d, t)'s device, its cut of each `TrainShards`, the
    LayerNorms read by every shard, each c_proj bias by shard 0 alone (it
    applies after the reduce, `nn.dense_reduce`)."""
    dev = mesh.device(d)

    def read(tree, device):
        return tree_map(lambda p: p.to(device), tree)

    view = {k: read(v, dev) for k, v in trainable.items() if k != "gpt"}
    gpt = {k: read(v, dev) for k, v in trainable["gpt"].items() if k != "gpt"}
    gpt2 = trainable["gpt"]["gpt"]
    if mesh.tp == 1:
        gpt["gpt"] = read(gpt2, dev)
    else:
        def dense(p, t: int, dt):
            return {k: (v[t] if isinstance(v, TrainShards) else v).to(dt)
                    for k, v in p.items() if t == 0 or isinstance(v, TrainShards)}

        shards = []
        for t in range(mesh.tp):
            dt = mesh.device(d, 0, t)
            shards.append([{"ln_1": read(lp["ln_1"], dt), "ln_2": read(lp["ln_2"], dt),
                            "attn": {k: dense(v, t, dt) for k, v in lp["attn"].items()},
                            "mlp": {k: dense(v, t, dt) for k, v in lp["mlp"].items()}}
                           for lp in gpt2["h"]])
        gpt["gpt"] = {"shards": shards, "ln_f": read(gpt2["ln_f"], dev),
                      "mesh": mesh.tp_mesh(d), "kernel": False}
    view["gpt"] = gpt
    return view


def _mesh_loss_backward(trainable, gpt_cfg: GPTConfig, s2_cfg: S2MelConfig, mesh: Mesh,
                        batch: Batch, t: torch.Tensor, z: torch.Tensor):
    """The loss over dp ranks (the module docstring), with its gradient
    added into the leaves rank by rank; returns (loss, {"gpt", "cfm"}) on
    rank 0's device."""
    B = batch["mel_target"].shape[0]
    if B % mesh.dp:
        raise ValueError(f"a batch of {B} rows does not split over dp={mesh.dp}")
    per = B // mesh.dp
    sums = []
    with torch.enable_grad():
        for d in range(mesh.dp):
            dev, rows = mesh.device(d), slice(d * per, (d + 1) * per)
            b = {k: v[rows].to(dev) for k, v in batch.items()}
            view = rank_view(trainable, mesh, d)
            s = gpt_loss_sums(view["gpt"], gpt_cfg, b)
            s["cfm"] = cfm_loss_sums(view["s2mel"]["cfm"], s2_cfg, b["mel_target"],
                                     b["mel_frames"], b["prompt_frames"], b["cfm_cond"],
                                     b["style"], t[rows].to(dev), z[rows].to(dev))
            sums.append(s)
    dev0 = mesh.devices[0]
    counts = {k: torch.clamp(sum(s[k][1].to(dev0) for s in sums), min=1.0) for k in sums[0]}
    total = {"gpt": 0.0, "cfm": 0.0}
    for d, s in enumerate(sums):
        dev = mesh.device(d)
        mean = {k: s[k][0] / counts[k].to(dev) for k in s}
        gpt, cfm = 0.01 * mean["text"] + mean["mel"], mean["cfm"]
        (gpt + cfm).backward()
        total = {"gpt": total["gpt"] + gpt.detach().to(dev0),
                 "cfm": total["cfm"] + cfm.detach().to(dev0)}
    return total["gpt"] + total["cfm"], total
