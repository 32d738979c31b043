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
in the port's layouts (`utils/jax_params.py::to_torch`). The JAX step is one
SPMD program over a (dp, tp) mesh; here dp = tp = 1, and more raises.

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
from typing import Any, Callable, Dict, List, Tuple

import torch

from indextts_tpu_torch.config import GPTConfig, S2MelConfig
from indextts_tpu_torch.models.gpt import unified_voice as uv
from indextts_tpu_torch.models.s2mel.cfm import cfm_loss

Batch = Dict[str, torch.Tensor]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the masked positions, from an f32
    log-softmax."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    denom = torch.clamp(mask.float().sum(), min=1.0)
    return (nll * mask).sum() / denom


def gpt_loss(params, cfg: GPTConfig, batch: Batch) -> torch.Tensor:
    """Teacher-forced text + mel cross-entropy, 0.01 * text + mel."""
    cond_latents = uv.get_conditioning(params, cfg, batch["cond_emb"], batch["cond_lens"])
    emo_vec = uv.get_emovec(params, cfg, batch["emo_emb"], batch["emo_lens"])
    text_logits, mel_logits, tgt = uv.forward_logits(
        params, cfg, cond_latents, emo_vec, batch["text_ids"], batch["text_lens"],
        batch["mel_codes"], batch["mel_lens"])
    t_mask = torch.ones(tgt["text_targets"].shape, device=text_logits.device)
    m_mask = torch.ones(tgt["mel_targets"].shape, device=mel_logits.device)
    return (0.01 * cross_entropy(text_logits, tgt["text_targets"], t_mask)
            + cross_entropy(mel_logits, tgt["mel_targets"], m_mask))


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
    (`utils/jax_params.py`'s `Kernel` and `LayerStack` marks included)."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _check_mesh(dp: int, tp: int) -> None:
    if dp != 1 or tp != 1:
        raise NotImplementedError(f"training at dp={dp}, tp={tp}: the port trains on one card "
                                  "(dp and tp training is ROADMAP.md, queue 1 item 5)")


def make_train_state(trainable, lr: float = 1e-4, dp: int = 1,
                     tp: int = 1) -> torch.optim.AdamW:
    """Mark every leaf of ``trainable`` as requiring a gradient and return
    the AdamW over them (optax.adamw(lr, weight_decay=0.01)'s update)."""
    _check_mesh(dp, tp)
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


def make_train_step(gpt_cfg: GPTConfig, s2_cfg: S2MelConfig, dp: int = 1, tp: int = 1):
    """The step ``train_step(trainable, optimizer, batch, t, z) -> (loss,
    {"gpt", "cfm"})``: the loss at the draws (t, z), its gradient, one AdamW
    update of ``trainable`` in place; the returned losses are detached.
    Matmuls and convolutions run in full f32 (TF32 off, as `IndexTTS2`
    sets it), under `deterministic` (cuBLAS then needs a fixed workspace,
    CUBLAS_WORKSPACE_CONFIG, set here unless the caller set it)."""
    _check_mesh(dp, tp)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    def train_step(trainable, optimizer: torch.optim.Optimizer, batch: Batch,
                   t: torch.Tensor, z: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        with deterministic():
            with torch.enable_grad():
                loss, parts = train_loss(trainable, gpt_cfg, s2_cfg, batch, t, z)
            loss.backward()
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is None:  # an unused leaf: optax's zero gradient (and decay)
                        p.grad = torch.zeros_like(p)
            optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    return train_step
