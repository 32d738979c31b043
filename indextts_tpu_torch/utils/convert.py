"""Reference checkpoints -> parameter trees in the JAX package's layouts
(a numpy-only copy of the v2 converters of `indextts_tpu/utils/convert.py`,
kept in the port so that it imports nothing of that package).

One converter per model family maps the reference's state-dict keys onto the
JAX-layout tree, which `utils/jax_params.py::to_torch` then takes to the
port's layouts. Conventions:

- nn.Linear.weight (out, in)        -> kernel (in, out)       [transpose]
- HF Conv1D.weight (in, out)        -> kernel (in, out)       [as-is]
- nn.Conv1d.weight (out, in/g, w)   -> kernel (w, in/g, out)  [transpose 2,1,0]
- nn.Conv2d.weight (out, in, kh, kw)-> kernel (kh, kw, in, out)
- nn.ConvTranspose1d.weight (in, out/g, w) -> kernel (w, in/g, out) flipped
- weight-norm (weight_g, weight_v)  -> folded weight (the reference's
  remove_weight_norm at load)
- BatchNorm running stats kept as-is (eval mode).

The converters work on numpy arrays and return views where they can
(transposes, flips), so a leaf may be a strided view of the state dict.
`load_torch_state_dict` reads a ``.pth`` / ``.pt`` / ``.bin`` file through
`torch.load` (memory-mapped when the file is a zip archive) and a
``.safetensors`` file through `utils/safetensors.py`, unwraps the layouts the
released files use (``model``, ``state_dict``, ``generator``, and ``net``'s
per-module dicts) and casts every tensor to f32 numpy, as the JAX loader does.

The v1 family's converters (attention blocks, the v1 UnifiedVoice, ECAPA,
BigVGAN v1) are copies of the JAX package's too; the Qwen converter
(`convert_qwen`) lives beside its model in `models/qwen.py`, as in the JAX
package's; `convert_dvae` is the DVAE's (`models/codec/dvae.py`).
"""

from __future__ import annotations

import zipfile
from typing import Any, Dict, List

import numpy as np
import torch

from indextts_tpu_torch.utils import safetensors

Array = np.ndarray
SD = Dict[str, Array]
# dict wrappers around a state dict, unwrapped in this order
WRAPPERS = ("model", "state_dict", "generator")


def _flatten_net(net: dict) -> dict:
    """``{'net': {module: state_dict}}`` (the s2mel checkpoint, read by the
    reference's ``load_checkpoint2`` into ``model.models[module]``) ->
    ``module.param`` keys."""
    return {f"{module}.{k}": v for module, sd in net.items() if isinstance(sd, dict)
            for k, v in sd.items()}


def load_torch_state_dict(path: str) -> SD:
    """A reference checkpoint file -> {key: f32 numpy array}. Entries that are
    not tensors (optimizer state, step counters) are dropped."""
    if path.endswith(".safetensors"):
        obj = safetensors.load_file(path)
    else:
        # the released files are the reference's own pickles (weights_only
        # as the JAX loader has it); a zip archive is mapped, not read
        obj = torch.load(path, map_location="cpu", weights_only=False,
                         mmap=zipfile.is_zipfile(path))
    for key in WRAPPERS:
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    if isinstance(obj, dict) and isinstance(obj.get("net"), dict):
        obj = _flatten_net(obj["net"])
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: holds a {type(obj).__name__}, not a state dict")
    return {k: v.detach().to("cpu").float().numpy() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def strip_prefix(sd: SD, prefix: str) -> SD:
    """Select + strip a key prefix (also strips DDP 'module.')."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith(prefix):
            out[k[len(prefix):]] = v
    return out


def fold_weight_norm(sd: SD) -> SD:
    """Fold every (weight_g, weight_v) pair into a plain weight.

    torch weight_norm: w = g * v / ||v||, norm over all dims except dim 0.
    Also handles the new parametrizations layout (parametrizations.weight.original0/1).
    """
    out = dict(sd)
    for k in list(out.keys()):
        if k.endswith("weight_g"):
            base = k[: -len("weight_g")]
            g, v = out.pop(base + "weight_g"), out.pop(base + "weight_v")
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
            out[base + "weight"] = (g * (v / np.maximum(norm, 1e-12))).astype(v.dtype)
        elif k.endswith("parametrizations.weight.original0"):
            base = k[: -len("parametrizations.weight.original0")]
            g = out.pop(base + "parametrizations.weight.original0")
            v = out.pop(base + "parametrizations.weight.original1")
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
            out[base + "weight"] = (g * (v / np.maximum(norm, 1e-12))).astype(v.dtype)
    return out


# -- primitive mappers --------------------------------------------------------

def linear(sd: SD, key: str) -> dict:
    p = {"kernel": sd[f"{key}.weight"].T}
    if f"{key}.bias" in sd:
        p["bias"] = sd[f"{key}.bias"]
    return p


def hf_conv1d(sd: SD, key: str) -> dict:
    """HF GPT-2 Conv1D: weight already (in, out)."""
    p = {"kernel": sd[f"{key}.weight"]}
    if f"{key}.bias" in sd:
        p["bias"] = sd[f"{key}.bias"]
    return p


def conv1d(sd: SD, key: str) -> dict:
    p = {"kernel": sd[f"{key}.weight"].transpose(2, 1, 0)}
    if f"{key}.bias" in sd:
        p["bias"] = sd[f"{key}.bias"]
    return p


def conv1d_as_dense(sd: SD, key: str) -> dict:
    """1x1 Conv1d used as a linear layer -> dense kernel (in, out)."""
    w = sd[f"{key}.weight"]  # (out, in, 1)
    p = {"kernel": w[:, :, 0].T}
    if f"{key}.bias" in sd:
        p["bias"] = sd[f"{key}.bias"]
    return p


def conv2d(sd: SD, key: str) -> dict:
    p = {"kernel": sd[f"{key}.weight"].transpose(2, 3, 1, 0)}
    if f"{key}.bias" in sd:
        p["bias"] = sd[f"{key}.bias"]
    return p


def conv_transpose1d(sd: SD, key: str) -> dict:
    w = sd[f"{key}.weight"]  # (in, out/g, w)
    p = {"kernel": np.flip(w, axis=-1).transpose(2, 0, 1)}  # (w, in, out/g)
    if f"{key}.bias" in sd:
        p["bias"] = sd[f"{key}.bias"]
    return p


def layer_norm(sd: SD, key: str) -> dict:
    return {"weight": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def rms_norm(sd: SD, key: str) -> dict:
    return {"weight": sd[f"{key}.weight"]}


def embedding(sd: SD, key: str) -> dict:
    return {"weight": sd[f"{key}.weight"]}


def batch_norm(sd: SD, key: str) -> dict:
    p = {"running_mean": sd[f"{key}.running_mean"],
         "running_var": sd[f"{key}.running_var"]}
    if f"{key}.weight" in sd:
        p["weight"] = sd[f"{key}.weight"]
        p["bias"] = sd[f"{key}.bias"]
    return p


# -- GPT-2 backbone -----------------------------------------------------------

def convert_gpt2(sd: SD, layers: int, prefix: str = "") -> dict:
    def lay(i):
        p = f"{prefix}h.{i}."
        return {
            "ln_1": layer_norm(sd, p + "ln_1"),
            "attn": {"c_attn": hf_conv1d(sd, p + "attn.c_attn"),
                     "c_proj": hf_conv1d(sd, p + "attn.c_proj")},
            "ln_2": layer_norm(sd, p + "ln_2"),
            "mlp": {"c_fc": hf_conv1d(sd, p + "mlp.c_fc"),
                    "c_proj": hf_conv1d(sd, p + "mlp.c_proj")},
        }

    stacked = _stack_layers([lay(i) for i in range(layers)])
    return {"h": stacked, "ln_f": layer_norm(sd, f"{prefix}ln_f")}


def _stack_layers(layer_list: List[Any]) -> Any:
    """Per-layer trees of one structure -> one tree of leading-axis stacks."""
    first = layer_list[0]
    if isinstance(first, dict):
        return {k: _stack_layers([t[k] for t in layer_list]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_layers([t[i] for t in layer_list])
                           for i in range(len(first)))
    return np.stack([np.asarray(x) for x in layer_list])


# -- conformer ---------------------------------------------------------------

def convert_conformer(sd: SD, num_blocks: int, input_layer: str, prefix: str = "") -> dict:
    p: dict = {}
    if input_layer == "linear":
        p["embed"] = {
            "linear": linear(sd, prefix + "embed.out.0"),
            "norm": layer_norm(sd, prefix + "embed.out.1"),
        }
    elif input_layer == "conv2d2":
        p["embed"] = {
            "conv": conv2d(sd, prefix + "embed.conv.0"),
            "out": linear(sd, prefix + "embed.out.0"),
        }
    elif input_layer == "conv2d":     # Conv2dSubsampling4
        p["embed"] = {
            "conv": conv2d(sd, prefix + "embed.conv.0"),
            "conv2": conv2d(sd, prefix + "embed.conv.2"),
            "out": linear(sd, prefix + "embed.out.0"),
        }
    elif input_layer == "conv2d6":
        p["embed"] = {
            "conv": conv2d(sd, prefix + "embed.conv.0"),
            "conv2": conv2d(sd, prefix + "embed.conv.2"),
            "out": linear(sd, prefix + "embed.linear"),
        }
    elif input_layer == "conv2d8":
        p["embed"] = {
            "conv": conv2d(sd, prefix + "embed.conv.0"),
            "conv2": conv2d(sd, prefix + "embed.conv.2"),
            "conv3": conv2d(sd, prefix + "embed.conv.4"),
            "out": linear(sd, prefix + "embed.linear"),
        }
    else:
        raise ValueError(f"unsupported conformer input_layer {input_layer!r}")
    blocks = []
    for i in range(num_blocks):
        b = f"{prefix}encoders.{i}."
        blocks.append({
            "norm_mha": layer_norm(sd, b + "norm_mha"),
            "attn": {
                "linear_q": linear(sd, b + "self_attn.linear_q"),
                "linear_k": linear(sd, b + "self_attn.linear_k"),
                "linear_v": linear(sd, b + "self_attn.linear_v"),
                "linear_out": linear(sd, b + "self_attn.linear_out"),
                "linear_pos": linear(sd, b + "self_attn.linear_pos"),
                "pos_bias_u": sd[b + "self_attn.pos_bias_u"],
                "pos_bias_v": sd[b + "self_attn.pos_bias_v"],
            },
            "norm_conv": layer_norm(sd, b + "norm_conv"),
            "conv": {
                "pointwise_conv1": conv1d(sd, b + "conv_module.pointwise_conv1"),
                "depthwise_conv": conv1d(sd, b + "conv_module.depthwise_conv"),
                "norm": layer_norm(sd, b + "conv_module.norm"),
                "pointwise_conv2": conv1d(sd, b + "conv_module.pointwise_conv2"),
            },
            "norm_ff": layer_norm(sd, b + "norm_ff"),
            "ff": {"w_1": linear(sd, b + "feed_forward.w_1"),
                   "w_2": linear(sd, b + "feed_forward.w_2")},
            "norm_final": layer_norm(sd, b + "norm_final"),
        })
    p["encoders"] = blocks
    p["after_norm"] = layer_norm(sd, prefix + "after_norm")
    return p


# -- perceiver ----------------------------------------------------------------

def convert_perceiver(sd: SD, depth: int = 2, prefix: str = "") -> dict:
    p: dict = {"latents": sd[prefix + "latents"]}
    if prefix + "proj_context.weight" in sd:
        p["proj_context"] = linear(sd, prefix + "proj_context")
    layers = []
    for i in range(depth):
        layers.append({
            "attn": {
                "to_q": linear(sd, f"{prefix}layers.{i}.0.to_q"),
                "to_kv": linear(sd, f"{prefix}layers.{i}.0.to_kv"),
                "to_out": linear(sd, f"{prefix}layers.{i}.0.to_out"),
            },
            "ff": {
                "w_in": linear(sd, f"{prefix}layers.{i}.1.0"),
                "w_out": linear(sd, f"{prefix}layers.{i}.1.2"),
            },
        })
    p["layers"] = layers
    p["norm"] = {"gamma": sd[prefix + "norm.gamma"]}
    return p


# -- UnifiedVoice v2 ----------------------------------------------------------

def convert_unified_voice(sd: SD, cfg) -> dict:
    """cfg: GPTConfig. Expects the raw gpt.pth state_dict."""
    sd = fold_weight_norm(sd)
    cm, em = cfg.condition_module, cfg.emo_condition_module
    return {
        "conditioning_encoder": convert_conformer(
            sd, cm.num_blocks, cm.input_layer, "conditioning_encoder."),
        "perceiver_encoder": convert_perceiver(sd, 2, "perceiver_encoder."),
        "emo_conditioning_encoder": convert_conformer(
            sd, em.num_blocks, em.input_layer, "emo_conditioning_encoder."),
        "emo_perceiver_encoder": convert_perceiver(sd, 2, "emo_perceiver_encoder."),
        "text_embedding": embedding(sd, "text_embedding"),
        "mel_embedding": embedding(sd, "mel_embedding"),
        "text_pos_embedding": embedding(sd, "text_pos_embedding.emb"),
        "mel_pos_embedding": embedding(sd, "mel_pos_embedding.emb"),
        "emo_layer": linear(sd, "emo_layer"),
        "emovec_layer": linear(sd, "emovec_layer"),
        "speed_emb": embedding(sd, "speed_emb"),
        "gpt": convert_gpt2(sd, cfg.layers, "gpt."),
        "final_norm": layer_norm(sd, "final_norm"),
        "mel_head": linear(sd, "mel_head"),
        "text_head": linear(sd, "text_head"),
    }


def deinterleave_rope_columns(lin: dict, heads: int, head_dim: int,
                              n_parts: int = 3, rotary_parts: int = 2) -> dict:
    """Host-side wqkv column permutation: for the q and k output blocks,
    reorder each head's columns from interleaved (0,1,2,...) to
    (evens..., odds...) so `apply_rotary_emb_half` sees its layout. The v
    block (and anything past `rotary_parts`) is untouched. Works on numpy
    params {"kernel": (in, n_parts*H*D), "bias"?}.
    """
    HD = heads * head_dim

    def perm(mat, axis):
        m = np.moveaxis(np.asarray(mat), axis, -1)
        parts = []
        for p in range(n_parts):
            blk = m[..., p * HD:(p + 1) * HD]
            if p < rotary_parts:
                b = blk.reshape(*blk.shape[:-1], heads, head_dim)
                blk = np.concatenate([b[..., 0::2], b[..., 1::2]],
                                     axis=-1).reshape(*blk.shape)
            parts.append(blk)
        return np.moveaxis(np.concatenate(parts, axis=-1), -1, axis)

    out = dict(lin)
    out["kernel"] = perm(lin["kernel"], -1)
    if lin.get("bias") is not None:
        out["bias"] = perm(lin["bias"], -1)
    return out


# -- DiT / s2mel ---------------------------------------------------------------

def _ada_ln(sd: SD, key: str) -> dict:
    return {"project": linear(sd, key + ".project_layer"),
            "norm": rms_norm(sd, key + ".norm")}


def convert_dit(sd: SD, s2, prefix: str = "") -> dict:
    """s2: S2MelConfig; expects keys under `prefix` (e.g. 'cfm.estimator.')."""
    sd = fold_weight_norm(sd)
    cfg = s2.DiT
    layers = []
    for i in range(cfg.depth):
        b = f"{prefix}transformer.layers.{i}."
        # gpt_fast wqkv is one fused linear; permute q/k columns to the
        # half-split rope layout (q.k^T is invariant)
        wqkv = deinterleave_rope_columns(linear(sd, b + "attention.wqkv"),
                                         cfg.num_heads, cfg.head_dim)
        layers.append({
            "attention_norm": _ada_ln(sd, b + "attention_norm"),
            "attn": {"wqkv": wqkv,
                     "wo": linear(sd, b + "attention.wo")},
            "ffn_norm": _ada_ln(sd, b + "ffn_norm"),
            "ff": {"w1": linear(sd, b + "feed_forward.w1"),
                   "w3": linear(sd, b + "feed_forward.w3"),
                   "w2": linear(sd, b + "feed_forward.w2")},
        })
    p: dict = {
        "x_embedder": linear(sd, prefix + "x_embedder"),
        "cond_projection": linear(sd, prefix + "cond_projection"),
        "t_embedder": {"mlp0": linear(sd, prefix + "t_embedder.mlp.0"),
                       "mlp2": linear(sd, prefix + "t_embedder.mlp.2")},
        "cond_x_merge_linear": linear(sd, prefix + "cond_x_merge_linear"),
        "skip_linear": linear(sd, prefix + "skip_linear"),
        "transformer": {"layers": _stack_layers(layers),
                        "norm": _ada_ln(sd, prefix + "transformer.norm")},
    }
    if cfg.final_layer_type == "wavenet":
        w = s2.wavenet
        wn_layers = []
        for i in range(w.num_layers):
            wn_layers.append({
                "in_layer": conv1d(sd, f"{prefix}wavenet.in_layers.{i}.conv.conv"),
                "res_skip": conv1d(sd, f"{prefix}wavenet.res_skip_layers.{i}.conv.conv"),
            })
        p.update({
            "t_embedder2": {"mlp0": linear(sd, prefix + "t_embedder2.mlp.0"),
                            "mlp2": linear(sd, prefix + "t_embedder2.mlp.2")},
            "conv1": linear(sd, prefix + "conv1"),
            "wavenet": {"layers": wn_layers,
                        "cond_layer": conv1d(sd, prefix + "wavenet.cond_layer.conv.conv")},
            "res_projection": linear(sd, prefix + "res_projection"),
            "final_layer": {"linear": linear(sd, prefix + "final_layer.linear"),
                            "adaLN": linear(sd, prefix + "final_layer.adaLN_modulation.1")},
            "conv2": conv1d(sd, prefix + "conv2"),
        })
    else:
        p["final_mlp0"] = linear(sd, prefix + "final_mlp.0")
        p["final_mlp2"] = linear(sd, prefix + "final_mlp.2")
    return p


def convert_length_regulator(sd: SD, cfg, prefix: str = "") -> dict:
    p: dict = {"embedding": embedding(sd, prefix + "embedding")}
    if not cfg.is_discrete:
        p["content_in_proj"] = linear(sd, prefix + "content_in_proj")
    convs = []
    n = len(cfg.sampling_ratios)
    for i in range(n):
        convs.append({
            "conv": conv1d(sd, f"{prefix}model.{3 * i}"),
            "norm": layer_norm(sd, f"{prefix}model.{3 * i + 1}"),
        })
    p["convs"] = convs
    p["out_conv"] = conv1d(sd, f"{prefix}model.{3 * n}")
    return p


def convert_s2mel(sd: SD, s2) -> dict:
    """Full MyModel checkpoint (keys like 'models.cfm.estimator...')."""
    sd = fold_weight_norm(strip_prefix(sd, ""))
    # accommodate both 'models.' and bare layouts
    if any(k.startswith("models.") for k in sd):
        sd = {k[len("models."):] if k.startswith("models.") else k: v for k, v in sd.items()}
    p = {
        "cfm": convert_dit(sd, s2, "cfm.estimator."),
        "length_regulator": convert_length_regulator(sd, s2.length_regulator,
                                                     "length_regulator."),
    }
    if "gpt_layer.0.weight" in sd:
        n = 0
        gl = []
        while f"gpt_layer.{n}.weight" in sd:
            gl.append(linear(sd, f"gpt_layer.{n}"))
            n += 1
        p["gpt_layer"] = gl
    return p


# -- campplus -------------------------------------------------------------------

def convert_campplus(sd: SD) -> dict:
    sd = strip_prefix(sd, "")

    def res_block(key, in_planes, planes, stride):
        p = {
            "conv1": conv2d(sd, key + ".conv1"),
            "bn1": batch_norm(sd, key + ".bn1"),
            "conv2": conv2d(sd, key + ".conv2"),
            "bn2": batch_norm(sd, key + ".bn2"),
        }
        if stride != 1 or in_planes != planes:
            p["shortcut_conv"] = conv2d(sd, key + ".shortcut.0")
            p["shortcut_bn"] = batch_norm(sd, key + ".shortcut.1")
        return p

    p: dict = {"fcm": {
        "conv1": conv2d(sd, "head.conv1"),
        "bn1": batch_norm(sd, "head.bn1"),
        "layer1": [res_block("head.layer1.0", 32, 32, 2), res_block("head.layer1.1", 32, 32, 1)],
        "layer2": [res_block("head.layer2.0", 32, 32, 2), res_block("head.layer2.1", 32, 32, 1)],
        "conv2": conv2d(sd, "head.conv2"),
        "bn2": batch_norm(sd, "head.bn2"),
    }}
    p["tdnn"] = {"conv": conv1d(sd, "xvector.tdnn.linear"),
                 "bn": batch_norm(sd, "xvector.tdnn.nonlinear.batchnorm")}
    blocks = []
    channels = 128
    for bi, (num_layers, ksz, dil) in enumerate(zip((12, 24, 16), (3, 3, 3), (1, 2, 2))):
        layers = []
        for i in range(num_layers):
            k = f"xvector.block{bi + 1}.tdnnd{i + 1}."
            layers.append({
                "bn1": batch_norm(sd, k + "nonlinear1.batchnorm"),
                "linear1": conv1d(sd, k + "linear1"),
                "bn2": batch_norm(sd, k + "nonlinear2.batchnorm"),
                "cam": {
                    "linear_local": conv1d(sd, k + "cam_layer.linear_local"),
                    "linear1": conv1d_as_dense_keep_conv(sd, k + "cam_layer.linear1"),
                    "linear2": conv1d_as_dense_keep_conv(sd, k + "cam_layer.linear2"),
                },
            })
        channels += num_layers * 32
        transit = {"bn": batch_norm(sd, f"xvector.transit{bi + 1}.nonlinear.batchnorm"),
                   "linear": conv1d(sd, f"xvector.transit{bi + 1}.linear")}
        channels //= 2
        blocks.append({"layers": layers, "transit": transit})
    p["blocks"] = blocks
    p["out_bn"] = batch_norm(sd, "xvector.out_nonlinear.batchnorm")
    p["dense"] = {"linear": conv1d(sd, "xvector.dense.linear"),
                  "bn": batch_norm(sd, "xvector.dense.nonlinear.batchnorm")}
    return p


def conv1d_as_dense_keep_conv(sd: SD, key: str) -> dict:
    # cam linear1/linear2 are 1x1 convs; we apply them with conv1d
    return conv1d(sd, key)


# -- w2v-bert -------------------------------------------------------------------

def convert_w2vbert(sd: SD, cfg) -> dict:
    """HF Wav2Vec2BertModel state_dict -> our encoder params (cfg: W2VBertConfig)."""
    sd = strip_prefix(sd, "")
    pfx = "encoder.layers."

    def ffn(key):
        return {"intermediate_dense": linear(sd, key + ".intermediate_dense"),
                "output_dense": linear(sd, key + ".output_dense")}

    layers = []
    for i in range(cfg.num_hidden_layers):
        b = f"{pfx}{i}."
        layers.append({
            "ffn1_layer_norm": layer_norm(sd, b + "ffn1_layer_norm"),
            "ffn1": ffn(b + "ffn1"),
            "self_attn_layer_norm": layer_norm(sd, b + "self_attn_layer_norm"),
            "attn": {
                "linear_q": linear(sd, b + "self_attn.linear_q"),
                "linear_k": linear(sd, b + "self_attn.linear_k"),
                "linear_v": linear(sd, b + "self_attn.linear_v"),
                "linear_out": linear(sd, b + "self_attn.linear_out"),
                "distance_embedding": embedding(sd, b + "self_attn.distance_embedding"),
            },
            "conv": {
                "layer_norm": layer_norm(sd, b + "conv_module.layer_norm"),
                "pointwise_conv1": conv1d(sd, b + "conv_module.pointwise_conv1"),
                "depthwise_conv": conv1d(sd, b + "conv_module.depthwise_conv"),
                "depthwise_layer_norm": layer_norm(sd, b + "conv_module.depthwise_layer_norm"),
                "pointwise_conv2": conv1d(sd, b + "conv_module.pointwise_conv2"),
            },
            "ffn2_layer_norm": layer_norm(sd, b + "ffn2_layer_norm"),
            "ffn2": ffn(b + "ffn2"),
            "final_layer_norm": layer_norm(sd, b + "final_layer_norm"),
        })
    return {
        "feature_projection": {
            "layer_norm": layer_norm(sd, "feature_projection.layer_norm"),
            "projection": linear(sd, "feature_projection.projection"),
        },
        "layers": layers,
    }


# -- BigVGAN-v2 -----------------------------------------------------------------

def convert_bigvgan(sd: SD, h) -> dict:
    """h: BigVGANConfig. Handles both weight-normed and folded checkpoints."""
    sd = fold_weight_norm(sd)
    p: dict = {"conv_pre": conv1d(sd, "conv_pre")}
    ups = []
    resblocks = []
    num_kernels = len(h.resblock_kernel_sizes)
    for i in range(len(h.upsample_rates)):
        ups.append(conv_transpose1d(sd, f"ups.{i}.0"))
        for j, (ks, dils) in enumerate(zip(h.resblock_kernel_sizes,
                                           h.resblock_dilation_sizes)):
            n = i * num_kernels + j
            convs1 = [conv1d(sd, f"resblocks.{n}.convs1.{m}") for m in range(len(dils))]
            convs2 = [conv1d(sd, f"resblocks.{n}.convs2.{m}") for m in range(len(dils))]
            acts = []
            for m in range(2 * len(dils)):
                a = {"alpha": sd[f"resblocks.{n}.activations.{m}.act.alpha"]}
                bk = f"resblocks.{n}.activations.{m}.act.beta"
                if bk in sd:
                    a["beta"] = sd[bk]
                acts.append(a)
            resblocks.append({"convs1": convs1, "convs2": convs2, "acts": acts})
    p["ups"] = ups
    p["resblocks"] = resblocks
    ap = {"alpha": sd["activation_post.act.alpha"]}
    if "activation_post.act.beta" in sd:
        ap["beta"] = sd["activation_post.act.beta"]
    p["activation_post"] = ap
    p["conv_post"] = conv1d(sd, "conv_post")
    return p


# -- v1 family -------------------------------------------------------------------

def convert_attention_block(sd: SD, key: str) -> dict:
    return {
        "norm": {"weight": sd[key + ".norm.weight"], "bias": sd[key + ".norm.bias"]},
        "qkv": conv1d(sd, key + ".qkv"),
        "proj_out": conv1d(sd, key + ".proj_out"),
    }


def convert_unified_voice_v1(sd: SD, cfg) -> dict:
    """cfg: GPTConfig (v1 flavor). Handles both condition types."""
    sd = fold_weight_norm(sd)
    p: dict = {}
    if cfg.condition_type == "conformer_perceiver":
        cm = cfg.condition_module
        p["conditioning_encoder"] = convert_conformer(
            sd, cm.num_blocks, cm.input_layer, "conditioning_encoder.")
    else:
        n_blocks = 0
        while f"conditioning_encoder.attn.{n_blocks}.qkv.weight" in sd:
            n_blocks += 1
        p["conditioning_encoder"] = {
            "init": conv1d(sd, "conditioning_encoder.init"),
            "attn": [convert_attention_block(sd, f"conditioning_encoder.attn.{i}")
                     for i in range(n_blocks)],
        }
    p["perceiver_encoder"] = convert_perceiver(sd, 2, "perceiver_encoder.")
    p.update({
        "text_embedding": embedding(sd, "text_embedding"),
        "mel_embedding": embedding(sd, "mel_embedding"),
        "text_pos_embedding": embedding(sd, "text_pos_embedding.emb"),
        "mel_pos_embedding": embedding(sd, "mel_pos_embedding.emb"),
        "gpt": convert_gpt2(sd, cfg.layers, "gpt."),
        "final_norm": layer_norm(sd, "final_norm"),
        "mel_head": linear(sd, "mel_head"),
        "text_head": linear(sd, "text_head"),
    })
    return p


def _convert_tdnn(sd: SD, key: str) -> dict:
    return {"conv": conv1d(sd, key + ".conv.conv"),
            "bn": batch_norm(sd, key + ".norm.norm")}


def convert_ecapa(sd: SD, prefix: str, n_se_blocks: int = 3,
                  res2net_scale: int = 8) -> dict:
    p: dict = {"block0": _convert_tdnn(sd, prefix + "blocks.0")}
    blocks = []
    for i in range(1, n_se_blocks + 1):
        b = f"{prefix}blocks.{i}."
        blocks.append({
            "tdnn1": _convert_tdnn(sd, b + "tdnn1"),
            "res2net": [_convert_tdnn(sd, b + f"res2net_block.blocks.{j}")
                        for j in range(res2net_scale - 1)],
            "tdnn2": _convert_tdnn(sd, b + "tdnn2"),
            "se": {"conv1": conv1d(sd, b + "se_block.conv1.conv"),
                   "conv2": conv1d(sd, b + "se_block.conv2.conv")},
        })
    p["blocks"] = blocks
    p["mfa"] = _convert_tdnn(sd, prefix + "mfa")
    p["asp"] = {"tdnn": _convert_tdnn(sd, prefix + "asp.tdnn"),
                "conv": conv1d(sd, prefix + "asp.conv.conv")}
    p["asp_bn"] = batch_norm(sd, prefix + "asp_bn.norm")
    p["fc"] = conv1d(sd, prefix + "fc.conv")
    return p


def convert_bigvgan_v1(sd: SD, h) -> dict:
    """h: BigVGANV1Config; expects the generator state_dict."""
    sd = fold_weight_norm(sd)
    p: dict = {"conv_pre": conv1d(sd, "conv_pre")}
    ups, resblocks, conds = [], [], []
    num_kernels = len(h.resblock_kernel_sizes)
    for i in range(len(h.upsample_rates)):
        ups.append(conv_transpose1d(sd, f"ups.{i}.0"))
        if f"conds.{i}.weight" in sd:
            conds.append(conv1d(sd, f"conds.{i}"))
        for j, dils in enumerate(h.resblock_dilation_sizes):
            n = i * num_kernels + j
            convs1 = [conv1d(sd, f"resblocks.{n}.convs1.{m}") for m in range(len(dils))]
            convs2 = [conv1d(sd, f"resblocks.{n}.convs2.{m}") for m in range(len(dils))]
            acts = []
            for m in range(2 * len(dils)):
                a = {"alpha": sd[f"resblocks.{n}.activations.{m}.act.alpha"]}
                bk = f"resblocks.{n}.activations.{m}.act.beta"
                if bk in sd:
                    a["beta"] = sd[bk]
                acts.append(a)
            resblocks.append({"convs1": convs1, "convs2": convs2, "acts": acts})
    p["ups"] = ups
    p["resblocks"] = resblocks
    if conds:
        p["conds"] = conds
    ap = {"alpha": sd["activation_post.act.alpha"]}
    if "activation_post.act.beta" in sd:
        ap["beta"] = sd["activation_post.act.beta"]
    p["activation_post"] = ap
    p["conv_post"] = conv1d(sd, "conv_post")
    p["speaker_encoder"] = convert_ecapa(sd, "speaker_encoder.")
    p["cond_layer"] = conv1d(sd, "cond_layer")
    return p


# -- DVAE -------------------------------------------------------------------------

def convert_dvae(sd: SD, num_layers: int = 2, num_resnet_blocks: int = 3) -> dict:
    """DiscreteVAE (reference `vqvae/xtts_dvae.py`), 1-D variant. Encoder
    Sequential: [Sequential(conv, act)] * num_layers, [ResBlock] * n_res, a
    final 1x1 conv; decoder: a 1x1 conv (codebook -> inner), [ResBlock] *
    n_res, [Sequential(convT, act)] * num_layers, a final 1x1 conv."""
    def res(prefix, i):
        return {"c1": conv1d(sd, f"{prefix}.{i}.net.0"), "c2": conv1d(sd, f"{prefix}.{i}.net.2"),
                "c3": conv1d(sd, f"{prefix}.{i}.net.4")}

    n_res = num_resnet_blocks
    return {
        "enc_convs": [conv1d(sd, f"encoder.{i}.0") for i in range(num_layers)],
        "enc_res": [res("encoder", num_layers + i) for i in range(n_res)],
        "enc_out": conv1d(sd, f"encoder.{num_layers + n_res}"),
        "dec_in": conv1d(sd, "decoder.0"),
        "dec_res": [res("decoder", 1 + i) for i in range(n_res)],
        "dec_convs": [conv_transpose1d(sd, f"decoder.{1 + n_res + i}.0")
                      for i in range(num_layers)],
        "dec_out": conv1d(sd, f"decoder.{1 + n_res + num_layers}"),
        "codebook": {"embed": sd["codebook.embed"]},
    }


# -- repcodec -------------------------------------------------------------------

def convert_vocos_backbone(sd: SD, num_layers: int, prefix: str) -> dict:
    blocks = []
    for i in range(num_layers):
        b = f"{prefix}convnext.{i}."
        blocks.append({
            "dwconv": conv1d(sd, b + "dwconv"),
            "norm": layer_norm(sd, b + "norm"),
            "pwconv1": linear(sd, b + "pwconv1"),
            "pwconv2": linear(sd, b + "pwconv2"),
            "gamma": sd[b + "gamma"],
        })
    return {
        "embed": conv1d(sd, prefix + "embed"),
        "norm": layer_norm(sd, prefix + "norm"),
        "convnext": blocks,
        "final_layer_norm": layer_norm(sd, prefix + "final_layer_norm"),
    }


def convert_repcodec(sd: SD, cfg) -> dict:
    sd = fold_weight_norm(sd)
    p: dict = {
        "encoder": convert_vocos_backbone(sd, cfg.vocos_num_layers, "encoder.0."),
        "encoder_out": linear(sd, "encoder.1"),
        "decoder": convert_vocos_backbone(sd, cfg.vocos_num_layers, "decoder.0."),
        "decoder_out": linear(sd, "decoder.1"),
    }
    qs = []
    for i in range(cfg.num_quantizers):
        q = f"quantizer.quantizers.{i}."
        qp = {"codebook": embedding(sd, q + "codebook")}
        if q + "in_project.weight" in sd:
            qp["in_project"] = conv1d_as_dense(sd, q + "in_project")
            qp["out_project"] = conv1d_as_dense(sd, q + "out_project")
        qs.append(qp)
    p["quantizer"] = qs
    if "down.weight" in sd:
        p["down"] = conv1d(sd, "down")
        p["up"] = conv1d(sd, "up")
    return p
