#!/usr/bin/env python3
"""Write a parameter tree in the JAX package's layouts back into the released
IndexTTS2 model directory's file layout (numpy and torch only).

It inverts the conventions of `indextts_tpu_torch/utils/convert.py` family by
family, so that the converters read its files back into the tree:

- linear kernels transposed back to (out, in), HF Conv1D kept (in, out),
  conv kernels back to torch's (out, in/g, W) / (out, in, kh, kw), the
  conv-transpose kernel unflipped to (in, out/g, W); scanned layer stacks
  (GPT-2 ``h``, the DiT's ``layers``) split into per-layer keys; the DiT's
  wqkv columns put back into gpt_fast's interleaved rope order;
- the weight-normed modules of the released files (BigVGAN's convolutions,
  the DiT's x_embedder, final linear and WaveNet convolutions, RepCodec's
  quantizer projections) as ``weight_g`` / ``weight_v`` pairs with
  ``g = ||w||`` over every dim but the first (in float64) and ``v = w``,
  because the released files are not folded;
- the wrappers of the released files: ``{'net': {module: state_dict}}`` for
  s2mel.pth and ``{'generator': state_dict}`` for bigvgan_generator.pt
  (``wrapped=False`` writes both flat);
- the semantic codec and w2v-bert as safetensors files (a writer with the
  standard library), the rest with `torch.save`;
- ``config.yaml`` in the reference's key layout (plus the ``w2v_bert`` and
  ``bigvgan`` sections the port's and the JAX package's configs read), and
  BigVGAN's ``config.json``.

Buffers the converters leave unread (`tests/test_convert_manifest.py`'s
ALLOW_UNCONSUMED: positional tables, filter taps, BatchNorm counters,
discrete-path embeddings) are not written.

    python3 tools/torch_reference_ckpt.py OUT_DIR [--seed 0] [--device cpu]

writes the whole directory at the shipped widths from the port's seeded
random weights (`indextts_tpu_torch.pipeline.infer_v2.random_trees`), about
6.9 GB of f32 files. Used by the tests (tiny configs) and by chip_smoke.py's
checkpoint pass. `write_model_dir_v1` writes an IndexTTS-1 directory
(config.yaml, gpt.pth, bigvgan_generator.pth) the same way, for the tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from indextts_tpu_torch.utils.safetensors import DTYPES  # noqa: E402
from indextts_tpu_torch.utils.yaml_subset import resolve_plain  # noqa: E402

SD = Dict[str, torch.Tensor]
# the files of a model directory, by family (the JAX pipeline's defaults)
CODEC_FILE = "hf_cache/semantic_codec_model.safetensors"
CAMPPLUS_FILE = "hf_cache/campplus_cn_common.bin"
BIGVGAN_DIR = "hf_cache/bigvgan"
W2V_FILE = "hf_cache/w2v-bert-2.0/model.safetensors"


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


# -- primitive inverses ---------------------------------------------------------

def _weight_norm(sd: SD, key: str, w: torch.Tensor) -> None:
    """``key.weight`` as the (weight_g, weight_v) pair weight_norm stores."""
    g = torch.linalg.vector_norm(w.double(), dim=tuple(range(1, w.ndim)), keepdim=True)
    sd[key + ".weight_g"] = g.to(w.dtype)
    sd[key + ".weight_v"] = w


def _put(sd: SD, key: str, p: dict, weight: torch.Tensor, wn: bool) -> None:
    if wn:
        _weight_norm(sd, key, weight)
    else:
        sd[key + ".weight"] = weight
    if "bias" in p:
        sd[key + ".bias"] = _t(p["bias"])


def linear(sd: SD, key: str, p: dict, wn: bool = False) -> None:
    _put(sd, key, p, _t(p["kernel"]).T, wn)


def hf_conv1d(sd: SD, key: str, p: dict) -> None:
    _put(sd, key, p, _t(p["kernel"]), False)


def conv1d(sd: SD, key: str, p: dict, wn: bool = False) -> None:
    _put(sd, key, p, _t(p["kernel"]).permute(2, 1, 0), wn)


def conv1d_as_dense(sd: SD, key: str, p: dict, wn: bool = False) -> None:
    _put(sd, key, p, _t(p["kernel"]).T[:, :, None], wn)


def conv2d(sd: SD, key: str, p: dict) -> None:
    _put(sd, key, p, _t(p["kernel"]).permute(3, 2, 0, 1), False)


def conv_transpose1d(sd: SD, key: str, p: dict, wn: bool = False) -> None:
    _put(sd, key, p, torch.flip(_t(p["kernel"]).permute(1, 2, 0), dims=(-1,)), wn)


def layer_norm(sd: SD, key: str, p: dict) -> None:
    sd[key + ".weight"], sd[key + ".bias"] = _t(p["weight"]), _t(p["bias"])


def rms_norm(sd: SD, key: str, p: dict) -> None:
    sd[key + ".weight"] = _t(p["weight"])


def embedding(sd: SD, key: str, p: dict) -> None:
    sd[key + ".weight"] = _t(p["weight"])


def batch_norm(sd: SD, key: str, p: dict) -> None:
    sd[key + ".running_mean"], sd[key + ".running_var"] = (_t(p["running_mean"]),
                                                           _t(p["running_var"]))
    if "weight" in p:
        sd[key + ".weight"], sd[key + ".bias"] = _t(p["weight"]), _t(p["bias"])


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a leading-axis stack."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_layer(v, i) for v in tree]
    return _t(tree)[i]


def _depth(stack: dict) -> int:
    leaf = stack
    while isinstance(leaf, (dict, list)):
        leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
    return _t(leaf).shape[0]


# -- families -----------------------------------------------------------------------

def gpt2(sd: SD, p: dict, prefix: str) -> None:
    for i in range(_depth(p["h"])):
        lp, b = _layer(p["h"], i), f"{prefix}h.{i}."
        layer_norm(sd, b + "ln_1", lp["ln_1"])
        hf_conv1d(sd, b + "attn.c_attn", lp["attn"]["c_attn"])
        hf_conv1d(sd, b + "attn.c_proj", lp["attn"]["c_proj"])
        layer_norm(sd, b + "ln_2", lp["ln_2"])
        hf_conv1d(sd, b + "mlp.c_fc", lp["mlp"]["c_fc"])
        hf_conv1d(sd, b + "mlp.c_proj", lp["mlp"]["c_proj"])
    layer_norm(sd, prefix + "ln_f", p["ln_f"])


def conformer(sd: SD, p: dict, input_layer: str, prefix: str) -> None:
    e = p["embed"]
    if input_layer == "linear":
        linear(sd, prefix + "embed.out.0", e["linear"])
        layer_norm(sd, prefix + "embed.out.1", e["norm"])
    elif input_layer in ("conv2d2", "conv2d", "conv2d6", "conv2d8"):
        conv2d(sd, prefix + "embed.conv.0", e["conv"])
        if input_layer != "conv2d2":
            conv2d(sd, prefix + "embed.conv.2", e["conv2"])
        if input_layer == "conv2d8":
            conv2d(sd, prefix + "embed.conv.4", e["conv3"])
        out = "embed.out.0" if input_layer in ("conv2d2", "conv2d") else "embed.linear"
        linear(sd, prefix + out, e["out"])
    else:
        raise ValueError(f"unsupported conformer input_layer {input_layer!r}")
    for i, bp in enumerate(p["encoders"]):
        b = f"{prefix}encoders.{i}."
        layer_norm(sd, b + "norm_mha", bp["norm_mha"])
        for name in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_pos"):
            linear(sd, b + "self_attn." + name, bp["attn"][name])
        sd[b + "self_attn.pos_bias_u"] = _t(bp["attn"]["pos_bias_u"])
        sd[b + "self_attn.pos_bias_v"] = _t(bp["attn"]["pos_bias_v"])
        layer_norm(sd, b + "norm_conv", bp["norm_conv"])
        c = bp["conv"]
        conv1d(sd, b + "conv_module.pointwise_conv1", c["pointwise_conv1"])
        conv1d(sd, b + "conv_module.depthwise_conv", c["depthwise_conv"])
        layer_norm(sd, b + "conv_module.norm", c["norm"])
        conv1d(sd, b + "conv_module.pointwise_conv2", c["pointwise_conv2"])
        layer_norm(sd, b + "norm_ff", bp["norm_ff"])
        linear(sd, b + "feed_forward.w_1", bp["ff"]["w_1"])
        linear(sd, b + "feed_forward.w_2", bp["ff"]["w_2"])
        layer_norm(sd, b + "norm_final", bp["norm_final"])
    layer_norm(sd, prefix + "after_norm", p["after_norm"])


def perceiver(sd: SD, p: dict, prefix: str) -> None:
    sd[prefix + "latents"] = _t(p["latents"])
    if "proj_context" in p:
        linear(sd, prefix + "proj_context", p["proj_context"])
    for i, lp in enumerate(p["layers"]):
        for name in ("to_q", "to_kv", "to_out"):
            linear(sd, f"{prefix}layers.{i}.0.{name}", lp["attn"][name])
        linear(sd, f"{prefix}layers.{i}.1.0", lp["ff"]["w_in"])
        linear(sd, f"{prefix}layers.{i}.1.2", lp["ff"]["w_out"])
    sd[prefix + "norm.gamma"] = _t(p["norm"]["gamma"])


def unified_voice_state_dict(p: dict, cfg) -> SD:
    """gpt.pth (cfg: GPTConfig); a raw state dict."""
    sd: SD = {}
    cm, em = cfg.condition_module, cfg.emo_condition_module
    conformer(sd, p["conditioning_encoder"], cm.input_layer, "conditioning_encoder.")
    perceiver(sd, p["perceiver_encoder"], "perceiver_encoder.")
    conformer(sd, p["emo_conditioning_encoder"], em.input_layer, "emo_conditioning_encoder.")
    perceiver(sd, p["emo_perceiver_encoder"], "emo_perceiver_encoder.")
    embedding(sd, "text_embedding", p["text_embedding"])
    embedding(sd, "mel_embedding", p["mel_embedding"])
    embedding(sd, "text_pos_embedding.emb", p["text_pos_embedding"])
    embedding(sd, "mel_pos_embedding.emb", p["mel_pos_embedding"])
    linear(sd, "emo_layer", p["emo_layer"])
    linear(sd, "emovec_layer", p["emovec_layer"])
    embedding(sd, "speed_emb", p["speed_emb"])
    gpt2(sd, p["gpt"], "gpt.")
    layer_norm(sd, "final_norm", p["final_norm"])
    linear(sd, "mel_head", p["mel_head"])
    linear(sd, "text_head", p["text_head"])
    return sd


def interleave_rope_columns(kernel: torch.Tensor, heads: int, head_dim: int,
                            n_parts: int = 3, rotary_parts: int = 2) -> torch.Tensor:
    """The inverse of convert.py's `deinterleave_rope_columns` on the last
    axis: each head's (evens..., odds...) columns of the q and k blocks back
    to gpt_fast's interleaved order."""
    HD, half = heads * head_dim, head_dim // 2
    parts = []
    for i in range(n_parts):
        blk = kernel[..., i * HD:(i + 1) * HD]
        if i < rotary_parts:
            b = blk.reshape(*blk.shape[:-1], heads, head_dim)
            blk = torch.stack([b[..., :half], b[..., half:]], dim=-1).reshape(blk.shape)
        parts.append(blk)
    return torch.cat(parts, dim=-1)


def _ada_ln(sd: SD, key: str, p: dict) -> None:
    linear(sd, key + ".project_layer", p["project"])
    rms_norm(sd, key + ".norm", p["norm"])


def dit(sd: SD, p: dict, s2, prefix: str) -> None:
    cfg = s2.DiT
    layers = p["transformer"]["layers"]
    for i in range(_depth(layers)):
        lp, b = _layer(layers, i), f"{prefix}transformer.layers.{i}."
        _ada_ln(sd, b + "attention_norm", lp["attention_norm"])
        wqkv = dict(lp["attn"]["wqkv"])
        wqkv["kernel"] = interleave_rope_columns(_t(wqkv["kernel"]), cfg.num_heads, cfg.head_dim)
        if "bias" in wqkv:
            wqkv["bias"] = interleave_rope_columns(_t(wqkv["bias"]), cfg.num_heads, cfg.head_dim)
        linear(sd, b + "attention.wqkv", wqkv)
        linear(sd, b + "attention.wo", lp["attn"]["wo"])
        _ada_ln(sd, b + "ffn_norm", lp["ffn_norm"])
        for name in ("w1", "w3", "w2"):
            linear(sd, b + "feed_forward." + name, lp["ff"][name])
    linear(sd, prefix + "x_embedder", p["x_embedder"], wn=True)
    linear(sd, prefix + "cond_projection", p["cond_projection"])
    linear(sd, prefix + "t_embedder.mlp.0", p["t_embedder"]["mlp0"])
    linear(sd, prefix + "t_embedder.mlp.2", p["t_embedder"]["mlp2"])
    linear(sd, prefix + "cond_x_merge_linear", p["cond_x_merge_linear"])
    linear(sd, prefix + "skip_linear", p["skip_linear"])
    _ada_ln(sd, prefix + "transformer.norm", p["transformer"]["norm"])
    if cfg.final_layer_type == "wavenet":
        linear(sd, prefix + "t_embedder2.mlp.0", p["t_embedder2"]["mlp0"])
        linear(sd, prefix + "t_embedder2.mlp.2", p["t_embedder2"]["mlp2"])
        linear(sd, prefix + "conv1", p["conv1"])
        for i, wl in enumerate(p["wavenet"]["layers"]):
            conv1d(sd, f"{prefix}wavenet.in_layers.{i}.conv.conv", wl["in_layer"], wn=True)
            conv1d(sd, f"{prefix}wavenet.res_skip_layers.{i}.conv.conv", wl["res_skip"],
                   wn=True)
        conv1d(sd, prefix + "wavenet.cond_layer.conv.conv", p["wavenet"]["cond_layer"], wn=True)
        linear(sd, prefix + "res_projection", p["res_projection"])
        linear(sd, prefix + "final_layer.linear", p["final_layer"]["linear"], wn=True)
        linear(sd, prefix + "final_layer.adaLN_modulation.1", p["final_layer"]["adaLN"])
        conv1d(sd, prefix + "conv2", p["conv2"])
    else:
        linear(sd, prefix + "final_mlp.0", p["final_mlp0"])
        linear(sd, prefix + "final_mlp.2", p["final_mlp2"])


def length_regulator(sd: SD, p: dict, cfg, prefix: str) -> None:
    embedding(sd, prefix + "embedding", p["embedding"])
    if not cfg.is_discrete:
        linear(sd, prefix + "content_in_proj", p["content_in_proj"])
    for i, cp in enumerate(p["convs"]):
        conv1d(sd, f"{prefix}model.{3 * i}", cp["conv"])
        layer_norm(sd, f"{prefix}model.{3 * i + 1}", cp["norm"])
    conv1d(sd, f"{prefix}model.{3 * len(p['convs'])}", p["out_conv"])


def s2mel_state_dict(p: dict, s2) -> SD:
    """s2mel.pth's modules (s2: S2MelConfig), flattened as ``module.param``."""
    sd: SD = {}
    dit(sd, p["cfm"], s2, "cfm.estimator.")
    length_regulator(sd, p["length_regulator"], s2.length_regulator, "length_regulator.")
    for n, lp in enumerate(p.get("gpt_layer", [])):
        linear(sd, f"gpt_layer.{n}", lp)
    return sd


def campplus_state_dict(p: dict) -> SD:
    sd: SD = {}

    def res_block(key, bp):
        conv2d(sd, key + ".conv1", bp["conv1"])
        batch_norm(sd, key + ".bn1", bp["bn1"])
        conv2d(sd, key + ".conv2", bp["conv2"])
        batch_norm(sd, key + ".bn2", bp["bn2"])
        if "shortcut_conv" in bp:
            conv2d(sd, key + ".shortcut.0", bp["shortcut_conv"])
            batch_norm(sd, key + ".shortcut.1", bp["shortcut_bn"])

    f = p["fcm"]
    conv2d(sd, "head.conv1", f["conv1"])
    batch_norm(sd, "head.bn1", f["bn1"])
    for name in ("layer1", "layer2"):
        for i, bp in enumerate(f[name]):
            res_block(f"head.{name}.{i}", bp)
    conv2d(sd, "head.conv2", f["conv2"])
    batch_norm(sd, "head.bn2", f["bn2"])
    conv1d(sd, "xvector.tdnn.linear", p["tdnn"]["conv"])
    batch_norm(sd, "xvector.tdnn.nonlinear.batchnorm", p["tdnn"]["bn"])
    for bi, blk in enumerate(p["blocks"]):
        for i, lp in enumerate(blk["layers"]):
            k = f"xvector.block{bi + 1}.tdnnd{i + 1}."
            batch_norm(sd, k + "nonlinear1.batchnorm", lp["bn1"])
            conv1d(sd, k + "linear1", lp["linear1"])
            batch_norm(sd, k + "nonlinear2.batchnorm", lp["bn2"])
            for name in ("linear_local", "linear1", "linear2"):
                conv1d(sd, k + "cam_layer." + name, lp["cam"][name])
        batch_norm(sd, f"xvector.transit{bi + 1}.nonlinear.batchnorm", blk["transit"]["bn"])
        conv1d(sd, f"xvector.transit{bi + 1}.linear", blk["transit"]["linear"])
    batch_norm(sd, "xvector.out_nonlinear.batchnorm", p["out_bn"])
    conv1d(sd, "xvector.dense.linear", p["dense"]["linear"])
    batch_norm(sd, "xvector.dense.nonlinear.batchnorm", p["dense"]["bn"])
    return sd


def w2vbert_state_dict(p: dict) -> SD:
    """HF Wav2Vec2BertModel's state dict."""
    sd: SD = {}
    for i, lp in enumerate(p["layers"]):
        b = f"encoder.layers.{i}."
        for ffn in ("ffn1", "ffn2"):
            layer_norm(sd, b + ffn + "_layer_norm", lp[ffn + "_layer_norm"])
            linear(sd, b + ffn + ".intermediate_dense", lp[ffn]["intermediate_dense"])
            linear(sd, b + ffn + ".output_dense", lp[ffn]["output_dense"])
        layer_norm(sd, b + "self_attn_layer_norm", lp["self_attn_layer_norm"])
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            linear(sd, b + "self_attn." + name, lp["attn"][name])
        embedding(sd, b + "self_attn.distance_embedding", lp["attn"]["distance_embedding"])
        c = lp["conv"]
        layer_norm(sd, b + "conv_module.layer_norm", c["layer_norm"])
        conv1d(sd, b + "conv_module.pointwise_conv1", c["pointwise_conv1"])
        conv1d(sd, b + "conv_module.depthwise_conv", c["depthwise_conv"])
        layer_norm(sd, b + "conv_module.depthwise_layer_norm", c["depthwise_layer_norm"])
        conv1d(sd, b + "conv_module.pointwise_conv2", c["pointwise_conv2"])
        layer_norm(sd, b + "final_layer_norm", lp["final_layer_norm"])
    layer_norm(sd, "feature_projection.layer_norm", p["feature_projection"]["layer_norm"])
    linear(sd, "feature_projection.projection", p["feature_projection"]["projection"])
    return sd


def bigvgan_state_dict(p: dict) -> SD:
    """BigVGAN-v2's generator, weight norm not folded (as released)."""
    sd: SD = {}
    conv1d(sd, "conv_pre", p["conv_pre"], wn=True)
    for i, up in enumerate(p["ups"]):
        conv_transpose1d(sd, f"ups.{i}.0", up, wn=True)
    for n, rb in enumerate(p["resblocks"]):
        for m, cp in enumerate(rb["convs1"]):
            conv1d(sd, f"resblocks.{n}.convs1.{m}", cp, wn=True)
        for m, cp in enumerate(rb["convs2"]):
            conv1d(sd, f"resblocks.{n}.convs2.{m}", cp, wn=True)
        for m, a in enumerate(rb["acts"]):
            for name, v in a.items():
                sd[f"resblocks.{n}.activations.{m}.act.{name}"] = _t(v)
    for name, v in p["activation_post"].items():
        sd[f"activation_post.act.{name}"] = _t(v)
    conv1d(sd, "conv_post", p["conv_post"], wn=True)
    return sd


def _vocos(sd: SD, p: dict, prefix: str) -> None:
    conv1d(sd, prefix + "embed", p["embed"])
    layer_norm(sd, prefix + "norm", p["norm"])
    for i, bp in enumerate(p["convnext"]):
        b = f"{prefix}convnext.{i}."
        conv1d(sd, b + "dwconv", bp["dwconv"])
        layer_norm(sd, b + "norm", bp["norm"])
        linear(sd, b + "pwconv1", bp["pwconv1"])
        linear(sd, b + "pwconv2", bp["pwconv2"])
        sd[b + "gamma"] = _t(bp["gamma"])
    layer_norm(sd, prefix + "final_layer_norm", p["final_layer_norm"])


def repcodec_state_dict(p: dict) -> SD:
    sd: SD = {}
    _vocos(sd, p["encoder"], "encoder.0.")
    linear(sd, "encoder.1", p["encoder_out"])
    _vocos(sd, p["decoder"], "decoder.0.")
    linear(sd, "decoder.1", p["decoder_out"])
    for i, qp in enumerate(p["quantizer"]):
        q = f"quantizer.quantizers.{i}."
        embedding(sd, q + "codebook", qp["codebook"])
        if "in_project" in qp:
            conv1d_as_dense(sd, q + "in_project", qp["in_project"], wn=True)
            conv1d_as_dense(sd, q + "out_project", qp["out_project"], wn=True)
    if "down" in p:
        conv1d(sd, "down", p["down"])
        conv1d(sd, "up", p["up"])
    return sd


# -- the IndexTTS-1 family ------------------------------------------------------------

def attention_block(sd: SD, key: str, p: dict) -> None:
    layer_norm(sd, key + ".norm", p["norm"])
    conv1d(sd, key + ".qkv", p["qkv"])
    conv1d(sd, key + ".proj_out", p["proj_out"])


def unified_voice_v1_state_dict(p: dict, cfg) -> SD:
    """The v1 gpt.pth (cfg: GPTConfig of either condition type); a raw
    state dict."""
    sd: SD = {}
    enc = p["conditioning_encoder"]
    if cfg.condition_type == "conformer_perceiver":
        conformer(sd, enc, cfg.condition_module.input_layer, "conditioning_encoder.")
    else:
        conv1d(sd, "conditioning_encoder.init", enc["init"])
        for i, bp in enumerate(enc["attn"]):
            attention_block(sd, f"conditioning_encoder.attn.{i}", bp)
    perceiver(sd, p["perceiver_encoder"], "perceiver_encoder.")
    embedding(sd, "text_embedding", p["text_embedding"])
    embedding(sd, "mel_embedding", p["mel_embedding"])
    embedding(sd, "text_pos_embedding.emb", p["text_pos_embedding"])
    embedding(sd, "mel_pos_embedding.emb", p["mel_pos_embedding"])
    gpt2(sd, p["gpt"], "gpt.")
    layer_norm(sd, "final_norm", p["final_norm"])
    linear(sd, "mel_head", p["mel_head"])
    linear(sd, "text_head", p["text_head"])
    return sd


def tdnn(sd: SD, key: str, p: dict) -> None:
    conv1d(sd, key + ".conv.conv", p["conv"])
    batch_norm(sd, key + ".norm.norm", p["bn"])


def ecapa(sd: SD, p: dict, prefix: str) -> None:
    tdnn(sd, prefix + "blocks.0", p["block0"])
    for i, bp in enumerate(p["blocks"], start=1):
        b = f"{prefix}blocks.{i}."
        tdnn(sd, b + "tdnn1", bp["tdnn1"])
        for j, rp in enumerate(bp["res2net"]):
            tdnn(sd, b + f"res2net_block.blocks.{j}", rp)
        tdnn(sd, b + "tdnn2", bp["tdnn2"])
        conv1d(sd, b + "se_block.conv1.conv", bp["se"]["conv1"])
        conv1d(sd, b + "se_block.conv2.conv", bp["se"]["conv2"])
    tdnn(sd, prefix + "mfa", p["mfa"])
    tdnn(sd, prefix + "asp.tdnn", p["asp"]["tdnn"])
    conv1d(sd, prefix + "asp.conv.conv", p["asp"]["conv"])
    batch_norm(sd, prefix + "asp_bn.norm", p["asp_bn"])
    conv1d(sd, prefix + "fc.conv", p["fc"])


def bigvgan_v1_state_dict(p: dict) -> SD:
    """BigVGAN v1's generator: BigVGAN-v2's weight-normed layout, plus the
    per-stage ``conds``, ``cond_layer`` and the ECAPA ``speaker_encoder``
    (plain convolutions)."""
    sd = bigvgan_state_dict({k: p[k] for k in ("conv_pre", "ups", "resblocks",
                                               "activation_post", "conv_post")})
    for i, cp in enumerate(p.get("conds", [])):
        conv1d(sd, f"conds.{i}", cp)
    conv1d(sd, "cond_layer", p["cond_layer"])
    ecapa(sd, p["speaker_encoder"], "speaker_encoder.")
    return sd


def config_tree_v1(cfg) -> dict:
    """The v1 config.yaml's tree for ``cfg`` (IndexTTS1Config)."""
    asdict = dataclasses.asdict
    return {"dataset": dict(cfg.dataset), "gpt": asdict(cfg.gpt),
            "bigvgan": asdict(cfg.bigvgan), "gpt_checkpoint": cfg.gpt_checkpoint,
            "bigvgan_checkpoint": cfg.bigvgan_checkpoint, "version": cfg.version}


def write_model_dir_v1(out_dir: str, trees: dict, cfg, wrapped: bool = False) -> Dict[str, int]:
    """The IndexTTS-1 model directory for ``trees`` (keys gpt, bigvgan, as
    `IndexTTS.load_params` takes them) at ``cfg``: config.yaml, gpt.pth and
    bigvgan_generator.pth (``{'generator': state_dict}`` when ``wrapped``).
    Returns {file: bytes}."""
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    path = os.path.join(out_dir, "config.yaml")
    with open(path, "w", encoding="utf-8") as f:
        f.write(to_yaml(config_tree_v1(cfg)))
    written["config.yaml"] = os.path.getsize(path)
    if "gpt" in trees:
        sd = {k: _host(v) for k, v in unified_voice_v1_state_dict(trees["gpt"], cfg.gpt).items()}
        written[cfg.gpt_checkpoint] = _save_torch(sd, os.path.join(out_dir, cfg.gpt_checkpoint))
    if "bigvgan" in trees:
        sd = {k: _host(v) for k, v in bigvgan_v1_state_dict(trees["bigvgan"]).items()}
        written[cfg.bigvgan_checkpoint] = _save_torch({"generator": sd} if wrapped else sd,
                                                      os.path.join(out_dir,
                                                                   cfg.bigvgan_checkpoint))
    return written


def state_dicts(trees: dict, cfg) -> Dict[str, SD]:
    """{family: flat state dict} for the families in ``trees`` (keys gpt,
    s2mel, codec, campplus, bigvgan, w2v, as `IndexTTS2.load_params` takes
    them). Leaves stay views of the tree's (any device, ``meta`` too)."""
    makers = {"gpt": lambda t: unified_voice_state_dict(t, cfg.gpt),
              "s2mel": lambda t: s2mel_state_dict(t, cfg.s2mel),
              "codec": repcodec_state_dict, "campplus": campplus_state_dict,
              "bigvgan": bigvgan_state_dict, "w2v": w2vbert_state_dict}
    return {k: makers[k](trees[k]) for k in makers if k in trees}


# -- files ----------------------------------------------------------------------------

def match_fold(sd: SD, dtype: torch.dtype, iters: int = 8) -> int:
    """Nudge the ``weight_v`` halves of ``sd``'s weight-norm pairs (host
    tensors, written with v = w) by single f32 ulps, element by element,
    until the converters' fold (`convert.fold_weight_norm`, the arithmetic
    the loaders run) cast to ``dtype`` gives w's own cast bit for bit; ``g``
    is recomputed as ||v|| each round. The f32 fold of ``g * v / ||v||``
    cannot return every w exactly (g is rounded to f32), but its cast to a
    narrower type can: only elements within an f32 ulp of a rounding
    boundary of ``dtype`` need a nudge. Returns the number of elements
    changed."""
    from indextts_tpu_torch.utils.convert import fold_weight_norm

    changed = 0
    for gk in [k for k in sd if k.endswith(".weight_g")]:
        vk = gk[:-1] + "v"
        w = sd[vk]
        want, v = w.to(dtype), w.clone()
        axes = tuple(range(1, w.ndim))
        for _ in range(iters):
            g = torch.linalg.vector_norm(v.double(), dim=axes, keepdim=True).float()
            out = torch.from_numpy(fold_weight_norm({"x.weight_g": g.numpy(),
                                                     "x.weight_v": v.numpy()})["x.weight"])
            bad = out.to(dtype) != want
            if not bool(bad.any()):
                break
            toward = torch.where(out < w, torch.tensor(float("inf")), torch.tensor(float("-inf")))
            v[bad] = torch.nextafter(v[bad], toward[bad])
        else:
            raise RuntimeError(f"{vk}: the fold's {dtype} cast still differs after {iters} rounds")
        changed += int((v != w).sum())
        sd[gk], sd[vk] = g, v
    return changed


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host tensor that owns exactly its own bytes (torch.save writes a
    view's whole storage: a layer of a stack would write the stack)."""
    return t.detach().to("cpu").contiguous().clone()


def save_safetensors(tensors: SD, path: str, metadata: Optional[dict] = None) -> int:
    """Write ``tensors`` as a safetensors file; returns its bytes."""
    names = {v: k for k, v in DTYPES.items()}
    header, offset, host = {}, 0, {}
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        host[name], offset = t, offset + n
    if metadata:
        header["__metadata__"] = dict(metadata)
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name in sorted(tensors):
            t = host[name]
            if t.numel():
                f.write(memoryview(t.view(torch.uint8).numpy()))
    return 8 + len(raw) + offset


def net_wrapped(sd: SD) -> dict:
    """s2mel.pth's layout, ``{'net': {module: state_dict}}`` (the reference's
    ``load_checkpoint2`` fills ``model.models[module]`` from it)."""
    net: Dict[str, SD] = {}
    for k, v in sd.items():
        module, param = k.split(".", 1)
        net.setdefault(module, {})[param] = v
    return {"net": net}


def _save_torch(obj, path: str) -> int:
    torch.save(obj, path)
    return os.path.getsize(path)


def _yaml_scalar(v) -> str:
    if v is None:
        return "~"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r and "." not in r.split("e")[0]:
            m, e = r.split("e")
            r = f"{m}.0e{e}"
        return r
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_scalar(x) for x in v) + "]"
    s = str(v)
    if re.fullmatch(r"[A-Za-z_./][A-Za-z0-9_./-]*", s) and resolve_plain(s, 0) == s:
        return s
    return json.dumps(s, ensure_ascii=False)


def to_yaml(tree: dict, indent: int = 0) -> str:
    """Block mappings, flow lists, plain or double-quoted scalars: the
    subset `utils/yaml_subset.py` reads."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.append(" " * indent + f"{k}:")
            out.append(to_yaml(v, indent + 4).rstrip("\n"))
        else:
            out.append(" " * indent + f"{k}: {_yaml_scalar(v)}")
    return "\n".join(out) + "\n"


def config_tree(cfg) -> dict:
    """config.yaml's tree in the reference's key layout for ``cfg``
    (IndexTTS2Config), with the ``w2v_bert`` and ``bigvgan`` sections."""
    asdict = dataclasses.asdict
    s2 = asdict(cfg.s2mel)
    for k in ("gpt_dim", "gpt_proj_dims"):         # not config.yaml keys
        s2.pop(k)
    return {"dataset": dict(cfg.dataset), "gpt": asdict(cfg.gpt),
            "semantic_codec": asdict(cfg.semantic_codec), "s2mel": s2,
            "w2v_bert": asdict(cfg.w2v_bert), "bigvgan": asdict(cfg.bigvgan),
            "gpt_checkpoint": cfg.gpt_checkpoint, "w2v_stat": cfg.w2v_stat,
            "s2mel_checkpoint": cfg.s2mel_checkpoint, "emo_matrix": cfg.emo_matrix,
            "spk_matrix": cfg.spk_matrix, "emo_num": list(cfg.emo_num),
            "qwen_emo_path": cfg.qwen_emo_path, "version": cfg.version}


def _lists(x):
    """Tuples -> lists, for JSON."""
    if isinstance(x, dict):
        return {k: _lists(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_lists(v) for v in x]
    return x


def write_model_dir(out_dir: str, trees: dict, cfg, wrapped: bool = True,
                    log=None, match_dtype: Optional[torch.dtype] = None) -> Dict[str, int]:
    """Write the model directory for ``trees`` (JAX layouts, numpy or torch
    leaves on any device; the keys of `IndexTTS2.load_params`: gpt, s2mel,
    codec, campplus, bigvgan, w2v, and optional w2v_mean / w2v_std and
    emo_matrix / spk_matrix) at ``cfg``. Families absent from ``trees`` are
    not written. With ``match_dtype`` the weight-norm pairs are nudged
    (`match_fold`) so that the loaded weights cast to that type are the
    tree's own cast bit for bit; the number of nudged elements is then under
    the key ``"nudged"`` of the result. Returns {relative path: bytes};
    ``log(path, bytes, seconds)`` is called after each file."""
    written: Dict[str, int] = {}
    nudged = [0]

    def emit(rel, write):
        t0 = time.perf_counter()
        path = os.path.join(out_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        written[rel] = write(path)
        if log is not None:
            log(rel, written[rel], time.perf_counter() - t0)

    def text(s):
        def write(path):
            with open(path, "w", encoding="utf-8") as f:
                f.write(s)
            return os.path.getsize(path)
        return write

    def family(name):
        (sd,) = state_dicts({name: trees[name]}, cfg).values()
        sd = {k: _host(v) for k, v in sd.items()}
        if match_dtype is not None:
            nudged[0] += match_fold(sd, match_dtype)
        return sd

    emit("config.yaml", text(to_yaml(config_tree(cfg))))
    if "gpt" in trees:
        emit(cfg.gpt_checkpoint, lambda p: _save_torch(family("gpt"), p))
    if "s2mel" in trees:
        def s2mel(path):
            sd = family("s2mel")
            return _save_torch(net_wrapped(sd) if wrapped else sd, path)
        emit(cfg.s2mel_checkpoint, s2mel)
    if "codec" in trees:
        emit(CODEC_FILE, lambda p: save_safetensors(family("codec"), p))
    if "campplus" in trees:
        emit(CAMPPLUS_FILE, lambda p: _save_torch(family("campplus"), p))
    if "bigvgan" in trees:
        emit(BIGVGAN_DIR + "/config.json",
             text(json.dumps(_lists(dataclasses.asdict(cfg.bigvgan)), indent=2)))
        emit(BIGVGAN_DIR + "/bigvgan_generator.pt", lambda p: _save_torch(
            {"generator": family("bigvgan")} if wrapped else family("bigvgan"), p))
    if "w2v" in trees:
        emit(W2V_FILE, lambda p: save_safetensors(family("w2v"), p,
                                                  metadata={"format": "pt"}))
    if "w2v_mean" in trees or "w2v_std" in trees:
        H = cfg.w2v_bert.hidden_size
        emit(cfg.w2v_stat, lambda p: _save_torch(
            {"mean": _host(_t(trees.get("w2v_mean", np.zeros(H, np.float32)))),
             "std": _host(_t(trees.get("w2v_std", np.ones(H, np.float32))))}, p))
    if "emo_matrix" in trees:
        emit(cfg.emo_matrix, lambda p: _save_torch(_host(_t(trees["emo_matrix"])), p))
    if "spk_matrix" in trees:
        emit(cfg.spk_matrix, lambda p: _save_torch(_host(_t(trees["spk_matrix"])), p))
    if match_dtype is not None:
        written["nudged"] = nudged[0]
    return written


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu", help="where the random weights are drawn")
    ap.add_argument("--flat", action="store_true",
                    help="write s2mel.pth and bigvgan_generator.pt without their wrappers")
    args = ap.parse_args()
    from indextts_tpu_torch.config import IndexTTS2Config
    from indextts_tpu_torch.pipeline.infer_v2 import random_trees

    cfg = IndexTTS2Config()
    trees = random_trees(cfg, args.seed, args.device)
    trees["w2v_mean"] = np.zeros(cfg.w2v_bert.hidden_size, np.float32)
    trees["w2v_std"] = np.ones(cfg.w2v_bert.hidden_size, np.float32)
    total = write_model_dir(args.out_dir, trees, cfg, wrapped=not args.flat,
                            log=lambda p, n, s: print(f"{p}: {n} bytes, {s:.2f} s",
                                                      flush=True))
    print(f"{sum(total.values())} bytes in {len(total)} files under {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
