"""The npz parameter store of the JAX package (`indextts_tpu/utils/checkpoint.py`)
without jax, and the one-shot conversion of a reference model directory
into it.

A tree (nested dicts, lists and tuples of arrays) is stored as one ``.npz``
file whose entries are named by their "/"-joined tree paths: dict keys as
``str(key)``, list and tuple positions as their index (``gpt/h/attn/c_attn/
kernel``, ``s2mel/cfm/wavenet/layers/0/in_layer/kernel``). The JAX package
names its leaves the same way (`jax.tree_util.tree_flatten_with_path`), so a
file written by either package loads in the other. Leaves may be numpy
arrays or torch tensors (saved from the host, f32 and integer types as they
are); ``None`` is an empty subtree, as in JAX.

The JAX package's Orbax pair (``save_params_orbax`` / ``load_params_orbax``)
is not ported: Orbax is a JAX library and the card's machine has none
(ROADMAP queue 1).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from indextts_tpu_torch.config import IndexTTS2Config, load_config
from indextts_tpu_torch.utils import convert


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield "/".join(path), tree


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("bf16 torch leaves have no numpy type to store; cast them first")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_params_npz(path: str, params: Dict[str, Any]) -> None:
    """Write ``params`` to ``path`` (np.savez; ``.npz`` appended if missing)."""
    arrays = {name: _host(v) for name, v in _leaves(params)}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez(path, **arrays)


def load_params_npz(path: str, like: Dict[str, Any]) -> Dict[str, Any]:
    """Read ``path`` into the structure of ``like`` (its leaves only name the
    entries; the values come from the file, as numpy arrays)."""
    with np.load(path) as data:
        def build(tree, p):
            if isinstance(tree, dict):
                return {k: build(v, p + (str(k),)) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(build(v, p + (str(i),)) for i, v in enumerate(tree))
            if tree is None:
                return None
            return data["/".join(p)]

        return build(like, ())


def convert_model_dir(model_dir: str, out_dir: str,
                      cfg: Optional[IndexTTS2Config] = None) -> Dict[str, str]:
    """Convert the reference checkpoints of ``model_dir`` (the six v2
    families, where present) into one npz file each under ``out_dir``, as
    the JAX package's ``convert_model_dir`` does; returns {family: path}."""
    cfg_path = os.path.join(model_dir, "config.yaml")
    if cfg is None:
        cfg = load_config(cfg_path) if os.path.exists(cfg_path) else IndexTTS2Config()
    os.makedirs(out_dir, exist_ok=True)
    written = {}

    def maybe(name, src, fn):
        p = os.path.join(model_dir, src)
        if os.path.exists(p):
            out = os.path.join(out_dir, f"{name}.npz")
            save_params_npz(out, fn(convert.load_torch_state_dict(p)))
            written[name] = out

    maybe("gpt", cfg.gpt_checkpoint, lambda sd: convert.convert_unified_voice(sd, cfg.gpt))
    maybe("s2mel", cfg.s2mel_checkpoint, lambda sd: convert.convert_s2mel(sd, cfg.s2mel))
    maybe("semantic_codec", "hf_cache/semantic_codec_model.safetensors",
          lambda sd: convert.convert_repcodec(sd, cfg.semantic_codec))
    maybe("campplus", "hf_cache/campplus_cn_common.bin", convert.convert_campplus)
    maybe("bigvgan", "hf_cache/bigvgan/bigvgan_generator.pt",
          lambda sd: convert.convert_bigvgan(sd, cfg.bigvgan))
    maybe("w2vbert", "hf_cache/w2v-bert-2.0/model.safetensors",
          lambda sd: convert.convert_w2vbert(sd, cfg.w2v_bert))
    return written
