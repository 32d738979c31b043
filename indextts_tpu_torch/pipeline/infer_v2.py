"""IndexTTS2 pipeline on PyTorch (counterpart of `indextts_tpu/pipeline/infer_v2.py`).

    tts = IndexTTS2(cfg_path="checkpoints/config.yaml", model_dir="checkpoints")
    tts.infer(spk_audio_prompt=..., text=..., output_path=...)

    # a mesh, as in the JAX package: dp=2 over cuda:0 and cuda:1 (the
    # long-form batch's rows), tp=2 with both shards on one card (the GPT
    # and the DiT; INDEXTTS_TP_DECODE=kernel puts int8 decode steps on K6),
    # or sp=2 (the DiT's frames)
    tts = IndexTTS2(cfg_path=None, mesh=2)
    tts = IndexTTS2(cfg_path=None, quantization="int8",
                    mesh=make_mesh(["cuda:0", "cuda:0"]))
    tts = IndexTTS2(cfg_path=None, mesh=make_mesh(["cuda:0", "cuda:1"], tp=1, sp=2))

One request runs, on ``device``:
  [P] speaker prompt (cached per prompt path): SeamlessM4T features (host)
      -> w2v-bert hidden[17], standardized -> RepCodec quantize; 22 kHz mel;
      Kaldi fbank -> CAMPPlus style; the prompt through the length regulator
  [T] the text, tokenized and split into segments of at most
      ``max_text_tokens_per_segment`` tokens (the JAX segmenter's quirks kept)
  [E] conformer + perceiver speaker latents and the merged emotion vector
      (the emotion prompt defaults to the speaker prompt, alpha 1; with
      ``emo_vector``, or ``use_emo_text`` through the Qwen3 classifier, the
      emotion-matrix mix of `IndexTTS2.emotion_mix` is merged in), then
      left-padded prefix embeddings
  [G] GPT-2 prefill + decode: beam search / sampling for num_beams > 1
      (`engine/beam.py`, K = num_beams; diverse group beam with
      ``num_beam_groups``), at num_beams=1 the self-gating speculative
      decoder for a segment decoded alone (`engine/speculative.py`), the
      sampling decode for a batch (`engine/decode.py::generate_adaptive`),
      contrastive search or DoLa with their kwargs (`engine/modes.py`);
      with a ``quantization`` every single-token step up to 24 rows runs
      kernel K1 (with the in-kernel beam ancestry map under beams, at
      group=1 when sampling), on a tp mesh under INDEXTTS_TP_DECODE=kernel
      kernel K6 (int8, the cache at the pipeline's type, up to 24 rows),
      else the plain step on the shards; at float32 the plain step
  [S1] teacher-forced GPT latents -> gpt_layer + vq2emb
  [S2] length regulator -> 25-step CFM Euler solve under CFG (DiT: kernel
      K2, or K4 on its flash tier; at float32 the dense tier)
  [V] BigVGAN-v2 (kernel K3; at float32 its plain version) -> 22.05 kHz wav

Long-form text, as in the JAX pipeline (`infer_generator`): with more than
one segment and ``cfg.engine.batch_segments`` (the default), all segments
run as one batch: one speaker's conditioning broadcast over B left-padded
text rows at one text bucket, one decode over the B rows in row chunks that
keep every quantized chunk on K1 (beams: ``max(1, 24 // num_beams)``
segments; sampling: 24 rows; no chunks on a tp mesh, as the JAX pipeline
decodes under a mesh), one teacher-forced pass and one CFM over the B
rows (a DiT batch of 2B rows) and one BigVGAN call; each segment's wav is
then sliced out on the host. On a dp mesh the rows, padded to a multiple
of dp with copies of row 0, are split over the dp ranks (`batch_sharding`):
each decodes (in the chunks above) and synthesizes its rows on its device
and stream, and the padded rows are dropped on the host. One segment, ``batch_segments=False`` and
streaming run the segments one by one. ``stream_return=True`` makes
`infer` return a generator that yields each segment's wav and then the
silence after it; the segments are joined with ``interval_silence`` ms of
silence. An empty text gives no segment and a 0-sample wav.

Decodes run beam search (num_beams > 1) or the sampling decode (num_beams=1,
typical sampling accepted), with float weights at the pipeline's type
(bf16, fp16 with ``use_fp16=True``, or float32)
or with one of the JAX pipeline's quantizations at any of those types:
``"int8"`` (the serving configuration: weight-only int8 for the four dense
layers of every GPT-2 block, quantized after the cast to the pipeline's
type as the JAX pipeline does), ``"int4"`` (the same layers nibble-packed int4), and the
memory knobs ``"int8kv"`` / ``"int4kv"`` (those weights with the flat int8
KV cache). With ``mesh`` (`parallel/mesh.py::make_mesh`: dp x sp x tp
ranks over named devices, the same device named twice co-locating two
ranks; an int N is the JAX pipeline's dp=N mesh, ``make_mesh(N, tp=1)``,
over cuda:0 .. cuda:N-1, or N CPU ranks with ``device="cpu"``) the trees
are placed as the JAX pipeline places them (`_place_ranks`): every dp rank
holds the model on its devices, the GPT-2 stack is split over the tp ranks
(`shard_gpt2_tp`; prefill, the teacher-forced pass and the plain decode
step run shard by shard, the JAX package's GSPMD passes) and the DiT over
the sp x tp ranks (`shard_dit`: each tp rank its heads, K2 or K4 once a
shard; each sp rank its frames, dense attention against the gathered k and
v); conditioning runs on rank 0's device, the synthesis's other stages on
each dp rank's first device. With ``quantization="int8"``, tp=2 and
``INDEXTTS_TP_DECODE=kernel`` (the JAX pipeline's own switch) decode steps
of up to 24 rows on the bf16 or fp16 cache run kernel K6 (`ops/decode_step_tp.py`);
every other tp decode (float, int4, the int8 cache, more rows, no switch)
is the plain step on the shards. At num_beams=1 a segment decoded alone
takes the JAX pipeline's default, the self-gating speculative decoder (gamma 8;
INDEXTTS_SPEC_DECODE=0 turns it off, as in the JAX pipeline; off under a
mesh and for the aux modes); the aux generation kwargs (``num_beam_groups``
/ ``diversity_penalty``, ``penalty_alpha``, ``dola_layers``) select their
engines as in the JAX pipeline, with its ValueErrors. With
``use_emo_text`` the emotion vector comes from the text (``emo_text``, by
default ``text``) through `pipeline/emotion.py::QwenEmotion`: the Qwen3
classifier of ``model_dir/<cfg.qwen_emo_path>`` on the device in bf16,
loaded at the first such request, or the JAX package's keyword lexicon when
that directory is absent; the vector then takes the ``emo_vector`` route.

Weights: the constructor reads the released IndexTTS2 model directory as
the JAX pipeline does (`IndexTTS2._load_models`; the files in
`checkpoint_files`): ``config.yaml`` (read without PyYAML), gpt.pth, s2mel.pth,
hf_cache/semantic_codec_model.safetensors, hf_cache/campplus_cn_common.bin,
hf_cache/bigvgan/ (config.json, then the weights), hf_cache/w2v-bert-2.0/,
wav2vec2bert_stats.pt and the emotion and speaker matrices, ``aux_paths``
first where it names a family. Each file is converted to the JAX package's
layouts (`utils/convert.py`) and placed through the weight bridge one
family at a time. A family without a file is drawn at random on the device
from ``seed`` (`random_trees`); `load_params` also takes trees handed over
from the JAX package.

Precision: weights and activations in ``dtype`` (bf16 by default) except
CAMPPlus and the mel / fbank front-ends (f32), as on the TPU. TF32 is off
for both matmuls and cuDNN convolutions
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`): the f32 paths stay full f32.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from indextts_tpu_torch import nn
from indextts_tpu_torch.config import BigVGANConfig, IndexTTS2Config, load_config
from indextts_tpu_torch.engine.beam import generate_beam, generate_group_beam
from indextts_tpu_torch.engine.decode import SamplingConfig, generate_adaptive
from indextts_tpu_torch.engine.modes import generate_contrastive, generate_dola
from indextts_tpu_torch.engine.speculative import generate_spec_adaptive, spec_commit_ratio
from indextts_tpu_torch.models.codec.repcodec import (init_repcodec, repcodec_quantize,
                                                      repcodec_vq2emb)
from indextts_tpu_torch.models.codec.w2vbert import init_w2vbert, w2vbert_forward
from indextts_tpu_torch.models.gpt import unified_voice as uv
from indextts_tpu_torch.models.gpt.gpt2 import (GPT2Dims, is_quantized, quantize_gpt2_int4,
                                                quantize_gpt2_int8)
from indextts_tpu_torch.models.s2mel.campplus import campplus_forward, init_campplus
from indextts_tpu_torch.models.s2mel.cfm import cfm_inference
from indextts_tpu_torch.models.s2mel.length_regulator import length_regulate
from indextts_tpu_torch.models.s2mel.s2mel import gpt_layer_forward, init_s2mel
from indextts_tpu_torch.models.vocoder.bigvgan import bigvgan_forward, init_bigvgan
from indextts_tpu_torch.ops.int8 import MAX_ROWS
from indextts_tpu_torch.ops.mel import kaldi_fbank, mel_spectrogram, seamless_m4t_features
from indextts_tpu_torch.parallel.mesh import (TP, Mesh, batch_sharding, is_tp, make_mesh, place,
                                              shard_dit, shard_gpt2_tp, torch_device)
from indextts_tpu_torch.pipeline.buckets import pad_to, pick_bucket
from indextts_tpu_torch.pipeline.emotion import QwenEmotion
from indextts_tpu_torch.text import TextNormalizer, TextTokenizer
from indextts_tpu_torch.utils import convert
from indextts_tpu_torch.utils.jax_params import to_torch
from indextts_tpu_torch.utils.resample import resample_audio
from indextts_tpu_torch.utils.wav_io import read_wav_mono, write_wav

# quantization -> (GPT-2 weight quantizer, int8 KV cache), as in the JAX pipeline
QUANTIZATIONS = {"int8": (quantize_gpt2_int8, False), "int8kv": (quantize_gpt2_int8, True),
                 "int4": (quantize_gpt2_int4, False), "int4kv": (quantize_gpt2_int4, True)}


def _spec_decode_gamma() -> int:
    """gamma of the one-row speculative decoder, read from the JAX
    pipeline's switch as it reads it: INDEXTTS_SPEC_DECODE unset (or on /
    true / default) gives 8, 0 / off / false / no turns it off, another
    integer sets gamma (an unreadable value gives 8)."""
    raw = os.environ.get("INDEXTTS_SPEC_DECODE", "").strip().lower()
    if raw in ("", "on", "true", "default"):
        return 8
    if raw in ("0", "off", "false", "no"):
        return 0
    try:
        return max(0, int(raw))
    except ValueError:
        return 8


def _aux_decode_fn(sampling: SamplingConfig):
    """HF's generation-mode rule for the aux modes at num_beams=1, as the
    JAX pipeline applies it: DoLa when ``dola_layers`` is set, contrastive
    search when penalty_alpha > 0 with top_k > 1 and greedy (sampling
    falls through to the sampling decode, as in HF); else None."""
    if sampling.num_beams > 1:
        return None
    if sampling.dola_layers is not None:
        return generate_dola
    if sampling.penalty_alpha > 0 and sampling.top_k > 1 and not sampling.do_sample:
        return generate_contrastive
    return None


def normalize_emo_vec(emo_vector, apply_bias: bool = True):
    """Per-emotion bias + sum<=0.8 rescale (a copy of the JAX package's
    `pipeline/emotion.py::normalize_emo_vec`)."""
    if apply_bias:
        emo_bias = [0.9375, 0.875, 1.0, 1.0, 0.9375, 0.9375, 0.6875, 0.5625]
        emo_vector = [v * b for v, b in zip(emo_vector, emo_bias)]
    s = sum(emo_vector)
    if s > 0.8:
        emo_vector = [v * (0.8 / s) for v in emo_vector]
    return emo_vector


def find_most_similar_cosine(query: torch.Tensor, matrix: torch.Tensor) -> int:
    """The row of ``matrix`` with the largest cosine similarity to ``query``
    (norms floored at 1e-8), in f32."""
    q, m = query.float(), matrix.float()
    qn = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-8)
    mn = m / torch.clamp(torch.linalg.norm(m, dim=-1, keepdim=True), min=1e-8)
    return int(torch.argmax(mn @ qn.reshape(-1)))


def checkpoint_files(cfg: IndexTTS2Config, model_dir: str,
                     aux_paths: Optional[dict] = None) -> list:
    """Every file the loader (`IndexTTS2._load_models`, as the JAX pipeline's
    `_load_models`) reads when it exists, resolved as it resolves them: the
    GPT and s2mel checkpoints, the ``aux_paths`` entries (semantic_codec,
    campplus, bigvgan, w2v_bert) or their ``hf_cache`` defaults (BigVGAN's
    config.json and its weight candidates, the w2v-bert candidates, in the
    order they are tried), the w2v-bert statistics and the emotion and
    speaker matrices."""
    aux = aux_paths or {}

    def path(p):
        return os.path.join(model_dir, p) if p else None

    bigvgan = aux.get("bigvgan", path("hf_cache/bigvgan"))
    w2v = aux.get("w2v_bert", path("hf_cache/w2v-bert-2.0"))
    files = [path(cfg.gpt_checkpoint), path(cfg.s2mel_checkpoint),
             aux.get("semantic_codec", path("hf_cache/semantic_codec_model.safetensors")),
             aux.get("campplus", path("hf_cache/campplus_cn_common.bin"))]
    if bigvgan:
        files += [os.path.join(bigvgan, f) for f in ("config.json",) + BIGVGAN_FILES]
    if w2v:
        files += [os.path.join(w2v, f) for f in W2V_FILES]
    files += [path(cfg.w2v_stat), path(cfg.emo_matrix), path(cfg.spk_matrix)]
    return [f for f in files if f]


# the weight files tried in a BigVGAN and a w2v-bert directory, in order
BIGVGAN_FILES = ("bigvgan_generator.pt", "pytorch_model.bin", "model.safetensors")
W2V_FILES = ("model.safetensors", "pytorch_model.bin")
# the random families, each drawn from its own generator (seed * 7 + its
# index) so that loading one family from a file leaves the others' draws as
# they were
FAMILIES = ("gpt", "s2mel", "codec", "campplus", "bigvgan", "w2v", "matrices")


def random_trees(cfg: IndexTTS2Config, seed: int, device,
                 families: Sequence[str] = FAMILIES) -> dict:
    """Seeded random weights at ``cfg``'s widths, in the JAX package's
    layouts, drawn on ``device``, for ``families`` (keys as `IndexTTS2.
    load_params` takes them; "matrices" gives emo_matrix and spk_matrix:
    sum(emo_num) rows of gpt.model_dim and of 192, standard normal, as the
    JAX pipeline draws them without their files)."""
    inits = {"gpt": lambda r: uv.init_unified_voice(r, cfg.gpt),
             "s2mel": lambda r: init_s2mel(r, cfg.s2mel),
             "codec": lambda r: init_repcodec(r, cfg.semantic_codec),
             "campplus": init_campplus,
             "bigvgan": lambda r: init_bigvgan(r, cfg.bigvgan),
             "w2v": lambda r: init_w2vbert(r, cfg.w2v_bert)}
    out = {}
    for name in families:
        rng = nn.InitRng(seed * len(FAMILIES) + FAMILIES.index(name), device)
        if name == "matrices":
            n_rows = sum(cfg.emo_num)
            out["emo_matrix"] = rng.normal((n_rows, cfg.gpt.model_dim), std=1.0)
            out["spk_matrix"] = rng.normal((n_rows, 192), std=1.0)
        else:
            out[name] = inits[name](rng)
    return out


def _load_matrix(path: str) -> np.ndarray:
    """An emotion or speaker matrix file: a safetensors file's first tensor
    (the JAX pipeline's branch for the emotion matrix), else a pickled
    tensor (`_load_plain_tensor`)."""
    if path.endswith(".safetensors"):
        return next(iter(convert.load_torch_state_dict(path).values()))
    t = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _resolve_mesh(mesh, device) -> Mesh:
    """The constructor's ``mesh``: a `Mesh` as it is; an int N the JAX
    pipeline's dp=N mesh (``make_mesh(N, tp=1)``: cuda:0 .. cuda:N-1, or N
    CPU ranks under ``device="cpu"``)."""
    if isinstance(mesh, bool) or not isinstance(mesh, (int, Mesh)):
        raise TypeError(f"mesh={mesh!r}: takes an int or "
                        "indextts_tpu_torch.parallel.make_mesh(...)")
    if isinstance(mesh, int):
        on_cpu = device is not None and torch.device(device).type == "cpu"
        mesh = make_mesh(["cpu"] * mesh if on_cpu else mesh, tp=1)
    return mesh


class IndexTTS2:
    """Zero-shot TTS, v2 model family, single-segment beam and sampling paths."""

    MEL_PER_CODE = 1.72  # 25 Hz codes -> ~86 Hz mel
    SAMPLING_RATE = 22050

    def __init__(self, cfg_path: Optional[str] = "checkpoints/config.yaml",
                 model_dir: str = "checkpoints", use_fp16: bool = False,
                 device: Optional[str] = None, use_cuda_kernel: Optional[bool] = None,
                 use_deepspeed: bool = False, use_accel: bool = False,
                 use_torch_compile: bool = False, aux_paths: Optional[dict] = None,
                 seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                 allow_random_init: bool = True, quantization: Optional[str] = None,
                 cfg: Optional[IndexTTS2Config] = None, mesh=None):
        """Takes the JAX pipeline's keyword set. The CUDA-era knobs
        (use_cuda_kernel, use_deepspeed, use_accel, use_torch_compile) are
        accepted and ignored, as there. ``use_fp16=True`` runs the pipeline at
        float16 in place of ``dtype``, as the JAX pipeline does: every tree but
        CAMPPlus's is cast to it, and the DiT's attention (K2, K4) and BigVGAN's
        activation (K3) run their fp16 instantiations. A ``quantization``
        takes any ``dtype``, as in the JAX pipeline (the tree is cast, then
        quantized): at bf16 and at fp16 every decode step up to 24 rows runs
        K1 (with tp=2 ``int8`` under INDEXTTS_TP_DECODE=kernel and both shards
        on one card, K6) at that type, its body bf16 as on the TPU. K1, K2,
        K4 and K3 are 16-bit only, so a float32 pipeline, with or without a
        quantization, runs on the card by explicit dtype gates, as the JAX
        pipeline does on every backend but the TPU: the plain decode step
        (`engine/decode.py::decode_route` names the types K1 takes), the
        DiT's dense tier (`attention_tier`) and K3's plain version
        (`models/vocoder/bigvgan.py::_act`). The weights are read
        from ``model_dir`` (and ``aux_paths``) as the JAX pipeline reads them
        (`_load_models`); a
        family without a file is drawn at random from ``seed``; with
        ``allow_random_init=False`` a missing GPT checkpoint raises
        FileNotFoundError, as in the JAX pipeline, and a file that exists but
        cannot be read raises."""
        del use_cuda_kernel, use_deepspeed, use_accel, use_torch_compile
        dtype = torch.float16 if use_fp16 else dtype
        if quantization is not None and quantization not in QUANTIZATIONS:
            raise ValueError(f"quantization={quantization!r}: takes None or one of "
                             f"{sorted(QUANTIZATIONS)} (the weight and cache formats of "
                             "the decode kernel K1)")
        self.quantization = quantization
        # ``device`` defaults to the card, or under a mesh to rank 0's device
        if mesh is not None:
            mesh = _resolve_mesh(mesh, device)
            if device is not None and mesh.devices[0] != torch_device(device):
                raise ValueError(f"device={device!r}: under {mesh} the pipeline runs on rank 0's "
                                 f"device {mesh.devices[0]}")
            device = mesh.devices[0]
        self.mesh = mesh
        # the tp=2 int8 decode kernel K6, under the JAX pipeline's switches
        self.tp_kernel = (mesh is not None and mesh.tp == TP and quantization == "int8"
                          and os.environ.get("INDEXTTS_TP_DECODE", "") == "kernel"
                          and os.environ.get("INDEXTTS_FUSED_DECODE", "1") != "0")
        # each dp rank's trees (rank 0's are the attributes), `_place_ranks`
        self._rank_trees: List[dict] = [{} for _ in range(mesh.dp if mesh else 1)]
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("IndexTTS2(device='cuda'): CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if cfg is not None:
            self.cfg = cfg
        elif cfg_path and os.path.exists(cfg_path):
            self.cfg = load_config(cfg_path)
        else:
            self.cfg = IndexTTS2Config()
        self.model_dir = model_dir
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.gpt_dims = GPT2Dims(self.cfg.gpt.layers, self.cfg.gpt.model_dim, self.cfg.gpt.heads)
        if mesh is not None:
            for what, heads in (("GPT", self.cfg.gpt.heads),
                                ("DiT", self.cfg.s2mel.DiT.num_heads)):
                if heads % mesh.tp:
                    raise ValueError(f"{mesh}: the {what}'s {heads} heads do not split over "
                                     f"tp={mesh.tp}")
        self._load_models(aux_paths, allow_random_init, seed)
        self._load_frontend()
        # the emotion-text classifier, loaded at its first request
        self.qwen_emo = QwenEmotion(os.path.join(model_dir, self.cfg.qwen_emo_path), self.device)
        self.cache_spk_audio_prompt = self.cache_spk = None
        self.cache_emo_audio_prompt = self.cache_emo_cond = None
        self.last_stage_times: Dict[str, float] = {}
        # (gamma, chunk verifies, tokens committed by chunks, single steps)
        # of the last speculative decode
        self.last_spec_stats = None
        # optional check(args, hidden) after every fused decode step
        # (`engine/decode.py::decode_step`)
        self.decode_check = None

    # ------------------------------------------------------------------ params
    def random_params(self, seed: int) -> dict:
        """Seeded random weights at the configured widths, in the JAX
        package's layouts, drawn on the device (`random_trees`): what the
        constructor draws for every family that has no file."""
        return random_trees(self.cfg, seed, self.device)

    def _load_models(self, aux_paths: Optional[dict], allow_random_init: bool,
                     seed: int) -> None:
        """The JAX pipeline's `_load_models`: the same files, tried in the
        same order and resolved the same way (``aux_paths`` first, then the
        ``hf_cache`` defaults; `checkpoint_files`), each family read,
        converted to the JAX layouts (`utils/convert.py`) and placed
        (`load_params`: the cast, the quantization, the tp split) before the
        next is read. A family without a file is drawn at random
        (`random_trees`). Two things differ from the JAX loader: BigVGAN is
        converted (or drawn) at the config its ``config.json`` gives, the one
        it then runs at; and the emotion and speaker matrices are read alike
        (a safetensors file's first tensor, else a pickled tensor). Each
        loaded family's file bytes and read / convert / place seconds go to
        ``self.load_report``."""
        cfg, aux = self.cfg, aux_paths or {}
        self.load_report: List[dict] = []

        def path(p):
            return os.path.join(self.model_dir, p) if p else None

        def first(d, names):
            if d and os.path.isdir(d):
                for name in names:
                    if os.path.exists(os.path.join(d, name)):
                        return os.path.join(d, name)
            return None

        def load(family, file, to_tree, read=convert.load_torch_state_dict, also=()):
            t0 = time.perf_counter()
            sd = read(file)
            t1 = time.perf_counter()
            trees = to_tree(sd)
            del sd
            t2 = time.perf_counter()
            self.load_params(trees)
            del trees
            self._sync()
            self.load_report.append({
                "family": family, "path": file,
                "bytes": sum(os.path.getsize(f) for f in (file,) + tuple(also)),
                "read_s": t1 - t0, "convert_s": t2 - t1, "place_s": time.perf_counter() - t2})

        def random(family):
            self.load_params(random_trees(self.cfg, seed, self.device, (family,)))

        gpt_path = path(cfg.gpt_checkpoint)
        if gpt_path and os.path.exists(gpt_path):
            load("gpt", gpt_path, lambda sd: {"gpt": convert.convert_unified_voice(sd, cfg.gpt)})
        elif allow_random_init:
            random("gpt")
        else:
            raise FileNotFoundError(gpt_path)

        s2_path = path(cfg.s2mel_checkpoint)
        if s2_path and os.path.exists(s2_path):
            load("s2mel", s2_path, lambda sd: {"s2mel": convert.convert_s2mel(sd, cfg.s2mel)})
        else:
            random("s2mel")

        codec_path = aux.get("semantic_codec",
                             path("hf_cache/semantic_codec_model.safetensors"))
        if codec_path and os.path.exists(codec_path):
            load("codec", codec_path,
                 lambda sd: {"codec": convert.convert_repcodec(sd, cfg.semantic_codec)})
        else:
            random("codec")

        camp_path = aux.get("campplus", path("hf_cache/campplus_cn_common.bin"))
        if camp_path and os.path.exists(camp_path):
            load("campplus", camp_path, lambda sd: {"campplus": convert.convert_campplus(sd)})
        else:
            random("campplus")

        # BigVGAN's own config.json (the reference's AttrDict) overrides the
        # vocoder's config, and the weights are read at it
        bv_dir = aux.get("bigvgan", path("hf_cache/bigvgan"))
        if bv_dir and os.path.isfile(os.path.join(bv_dir, "config.json")):
            with open(os.path.join(bv_dir, "config.json"), "r", encoding="utf-8") as f:
                self.cfg = dataclasses.replace(self.cfg,
                                               bigvgan=BigVGANConfig.from_dict(json.load(f)))
        bv_ckpt = first(bv_dir, BIGVGAN_FILES)
        if bv_ckpt:
            load("bigvgan", bv_ckpt,
                 lambda sd: {"bigvgan": convert.convert_bigvgan(sd, self.cfg.bigvgan)})
        else:
            random("bigvgan")

        w2v_ckpt = first(aux.get("w2v_bert", path("hf_cache/w2v-bert-2.0")), W2V_FILES)
        if w2v_ckpt:
            load("w2v", w2v_ckpt, lambda sd: {"w2v": convert.convert_w2vbert(sd, cfg.w2v_bert)})
        else:
            random("w2v")

        H = cfg.w2v_bert.hidden_size
        stat_path = path(cfg.w2v_stat)
        if stat_path and os.path.exists(stat_path):
            load("w2v_stat", stat_path, lambda sd: {
                "w2v_mean": sd.get("mean", np.zeros(H, np.float32)),
                "w2v_std": sd.get("std", np.ones(H, np.float32))})
        else:
            self.load_params({"w2v_mean": np.zeros(H, np.float32),
                              "w2v_std": np.ones(H, np.float32)})

        # the emotion file decides, as in the JAX pipeline: with it both
        # matrices are read (a missing speaker file raises), without it both
        # are drawn
        emo_path, spk_path = path(cfg.emo_matrix), path(cfg.spk_matrix)
        if emo_path and os.path.exists(emo_path):
            load("matrices", emo_path, lambda sd: sd, also=(spk_path,),
                 read=lambda f: {"emo_matrix": _load_matrix(f),
                                 "spk_matrix": _load_matrix(spk_path)})
        else:
            random("matrices")

    def load_params(self, trees: dict) -> None:
        """Take JAX-layout parameter trees through the weight bridge, for the
        families present (keys gpt, s2mel, codec, campplus, bigvgan, w2v;
        w2v_mean / w2v_std; and emo_matrix / spk_matrix, (sum(emo_num), D)
        arrays split by ``cfg.emo_num`` into the per-emotion matrices, kept
        f32); the others stay as they are.
        CAMPPlus stays f32; everything else is cast to the pipeline dtype.
        Under a ``quantization`` the GPT-2 backbone is then quantized (int8
        or int4), unless the tree handed over already is; under a mesh the
        trees are then placed on every dp rank (`_place_ranks`)."""
        dev, dt = self.device, self.dtype
        placed = {}
        if "gpt" in trees:
            gpt_params = to_torch(trees["gpt"], dev, dt)
            if self.quantization and not is_quantized(gpt_params["gpt"]):
                gpt_params["gpt"] = QUANTIZATIONS[self.quantization][0](gpt_params["gpt"])
            placed["gpt_params"] = gpt_params
        for key, attr, dtype in (("s2mel", "s2mel_params", dt), ("codec", "codec_params", dt),
                                 ("bigvgan", "bigvgan_params", dt)):
            if key in trees:
                placed[attr] = to_torch(trees[key], dev, dtype)
        for attr, tree in self._place_ranks(placed).items():
            setattr(self, attr, tree)
        for key, attr, dtype in (("w2v", "w2v_params", dt),
                                 ("campplus", "campplus_params", torch.float32),
                                 ("w2v_mean", "w2v_mean", torch.float32),
                                 ("w2v_std", "w2v_std", torch.float32)):
            if key in trees:
                setattr(self, attr, to_torch(trees[key], dev, dtype))
        for key in ("emo_matrix", "spk_matrix"):
            if key in trees:
                rows = to_torch(trees[key], dev, torch.float32)
                setattr(self, key, list(torch.split(rows, list(self.cfg.emo_num))))

    def _place_ranks(self, trees: dict) -> dict:
        """The mesh placement of the JAX pipeline (`_load_models`' ``put``),
        for the trees the dp ranks run (gpt_params, s2mel_params,
        codec_params, bigvgan_params; on rank 0's device): each dp rank d
        gets them on its device (`Mesh.device`), the GPT-2 stack split over
        its tp ranks (`shard_gpt2_tp` on `Mesh.tp_mesh`, with K6 under
        `tp_kernel`) and the DiT over its sp x tp ranks (`shard_dit` on
        `Mesh.dp_mesh`); ranks on the same devices share one copy. Returns
        rank 0's trees; the others go to ``_rank_trees``."""
        mesh = self.mesh
        if mesh is None:
            return trees
        made: Dict[tuple, dict] = {}
        for d in range(mesh.dp):
            for attr, tree in trees.items():
                key = (attr, mesh.dp_mesh(d).devices)
                if key not in made:
                    t = place(tree, mesh.device(d))
                    if attr == "gpt_params" and mesh.tp > 1:
                        t = {**t, "gpt": shard_gpt2_tp(t["gpt"], mesh.tp_mesh(d),
                                                       kernel=self.tp_kernel)}
                    elif attr == "s2mel_params" and mesh.tp * mesh.sp > 1:
                        t = {**t, "cfm": shard_dit(t["cfm"], mesh.dp_mesh(d))}
                    made[key] = t
                self._rank_trees[d][attr] = made[key]
        return self._rank_trees[0]

    def _rank(self, d: int) -> dict:
        """Dp rank ``d``'s trees (rank 0's are the pipeline's attributes)."""
        if d == 0:
            return {"gpt_params": self.gpt_params, "s2mel_params": self.s2mel_params,
                    "codec_params": self.codec_params, "bigvgan_params": self.bigvgan_params}
        return self._rank_trees[d]

    def _on_ranks(self, fn):
        """``fn(d)`` for every dp rank d, on the rank's device and its
        stream (`Mesh.streams`). Returns (the results in rank order, whether
        the ranks ran at once). Ranks on distinct cards run at once, one host
        thread each (the decode loops read the device every few steps, so
        one thread interleaving them would idle each card at every read);
        co-located ranks, and CPU ranks, run one after another, each on its
        own stream synchronized before the next starts (the decode kernel
        K1's grid takes the whole card and its barrier words are the
        card's, so two K1 launches on one card must not overlap)."""
        mesh = self.mesh
        devs = [mesh.device(d) for d in range(mesh.dp)]
        if devs[0].type != "cuda":
            return [fn(d) for d in range(mesh.dp)], False
        streams = [mesh.streams()[d * mesh.sp * mesh.tp] for d in range(mesh.dp)]

        def call(d):
            with torch.inference_mode(), torch.cuda.device(devs[d]), \
                    torch.cuda.stream(streams[d]):
                out = fn(d)
            streams[d].synchronize()
            return out

        if len(set(devs)) == len(devs):
            torch.cuda.synchronize(self.device)
            with ThreadPoolExecutor(len(devs)) as ex:
                return list(ex.map(call, range(len(devs)))), True
        out = []
        for d, dev in enumerate(devs):
            streams[d].wait_stream(torch.cuda.current_stream(dev))
            out.append(call(d))
        return out, False

    def _load_frontend(self):
        bpe_path = os.path.join(self.model_dir, self.cfg.dataset.get("bpe_model", "bpe.model"))
        self.normalizer = TextNormalizer(enable_glossary=True)
        self.normalizer.load()
        self.tokenizer = (TextTokenizer(bpe_path, self.normalizer)
                          if os.path.exists(bpe_path) else None)

    def _sync(self, device: Optional[torch.device] = None):
        device = self.device if device is None else device
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # ---------------------------------------------------------------- prompt
    def _cond_emb(self, audio16k: np.ndarray):
        """[P1] SeamlessM4T features -> standardized w2v-bert hidden state."""
        feats, mask = seamless_m4t_features(audio16k)
        flen = int(mask.sum())
        feats = pad_to(feats, pick_bucket(feats.shape[1], self.cfg.engine.cond_len_buckets),
                       axis=1)
        h = w2vbert_forward(self.w2v_params, self.cfg.w2v_bert,
                            torch.as_tensor(feats, device=self.device).to(self.dtype),
                            torch.tensor([flen], device=self.device))
        return (h.float() - self.w2v_mean) / self.w2v_std, flen

    def _prepare_spk_prompt(self, path: str) -> dict:
        """[P] speaker prompt tensors, cached per prompt path."""
        if self.cache_spk is not None and self.cache_spk_audio_prompt == path:
            return self.cache_spk
        cfg, dev = self.cfg, self.device
        sp = cfg.s2mel.preprocess_params.spect_params
        hop = sp.hop_length
        audio, sr = read_wav_mono(path)
        audio = audio[:, :int(15 * sr)]
        audio_22k = resample_audio(audio, sr, 22050)
        audio_16k = resample_audio(audio, sr, 16000)
        spk_cond_emb, flen = self._cond_emb(audio_16k)

        mel_bucket = pick_bucket(audio_22k.shape[1] // hop + 1, cfg.engine.mel_len_buckets)
        a22 = torch.as_tensor(pad_to(audio_22k, mel_bucket * hop, axis=1), device=dev)
        fblen = max(1 + (audio_16k.shape[1] - 400) // 160, 1)
        fb_bucket = pick_bucket(fblen, cfg.engine.mel_len_buckets)
        a16 = torch.as_tensor(pad_to(audio_16k, 160 * fb_bucket + 240, axis=1), device=dev)

        _, s_ref = repcodec_quantize(self.codec_params, cfg.semantic_codec,
                                     spk_cond_emb.to(self.dtype))
        ref_mel = mel_spectrogram(a22, n_fft=sp.n_fft, num_mels=sp.n_mels,
                                  sampling_rate=cfg.s2mel.preprocess_params.sr,
                                  hop_size=hop, win_size=sp.win_length, fmin=sp.fmin,
                                  fmax=sp.fmax).transpose(1, 2)
        ref_len = audio_22k.shape[1] // hop
        fb = kaldi_fbank(a16)
        fb_mask = nn.sequence_mask(torch.tensor([fblen], device=dev), fb.shape[1])[:, :, None]
        fb_mean = (fb * fb_mask).sum(1, keepdim=True) / max(fblen, 1)
        fb = torch.where(fb_mask, fb - fb_mean, torch.zeros_like(fb))
        style = campplus_forward(self.campplus_params, fb, torch.tensor([fblen], device=dev))
        prompt_cond = length_regulate(
            self.s2mel_params["length_regulator"], cfg.s2mel.length_regulator,
            torch.tensor([flen], device=dev), torch.tensor([ref_len], device=dev),
            out_size=ref_mel.shape[1], features=s_ref)
        self.cache_spk = {"spk_cond_emb": spk_cond_emb, "spk_len": flen, "ref_mel": ref_mel,
                          "ref_len": ref_len, "style": style, "prompt_cond": prompt_cond}
        self.cache_spk_audio_prompt = path
        return self.cache_spk

    def _prepare_emo_cond(self, path: str):
        if self.cache_emo_cond is not None and self.cache_emo_audio_prompt == path:
            return self.cache_emo_cond
        audio, _ = read_wav_mono(path, target_sr=16000)
        self.cache_emo_cond = self._cond_emb(audio[:, :15 * 16000])
        self.cache_emo_audio_prompt = path
        return self.cache_emo_cond

    # ----------------------------------------------------------------- stages
    def conditioning(self, spk: dict, emo_cond, emo_alpha: float):
        """[E] (cond_latents (1, 32, D), merged emovec (1, D)) of a speaker
        prompt and an emotion prompt's features, computed once a request."""
        dev, dt, g = self.device, self.dtype, self.cfg.gpt
        emo_emb, emo_len = emo_cond
        spk_emb = spk["spk_cond_emb"].to(dt)
        spk_len = torch.tensor([spk["spk_len"]], device=dev)
        cond_latents = uv.get_conditioning(self.gpt_params, g, spk_emb, spk_len)
        emovec = uv.merge_emovec(self.gpt_params, g, spk_emb, emo_emb.to(dt), spk_len,
                                 torch.tensor([emo_len], device=dev), float(emo_alpha))
        return cond_latents, emovec

    def prefix_embeds(self, cond_latents, emovec, text_ids: np.ndarray, tlens):
        """[E] left-padded prefix embeddings and mask of B text rows (B, tb)
        with lengths ``tlens``: one speaker's conds broadcast over the rows,
        at prefix length 34 + tb + 2."""
        dev, g = self.device, self.cfg.gpt
        B = text_ids.shape[0]
        conds = uv.build_conds_latent(self.gpt_params, cond_latents, emovec)
        prefix_len = g.condition_num_latent + 2 + text_ids.shape[1] + 2
        return uv.prepare_prefix_embeds(
            self.gpt_params, g, conds.expand(B, -1, -1), torch.as_tensor(text_ids, device=dev),
            torch.as_tensor(np.asarray(tlens).reshape(B), device=dev), prefix_len,
            dtype=self.dtype)

    def prefix(self, spk: dict, emo_cond, emo_alpha: float, text_ids: np.ndarray,
               tlen: int):
        """[E] (cond_latents, emovec, prefix embeds, prefix mask) of one text
        row."""
        cond_latents, emovec = self.conditioning(spk, emo_cond, emo_alpha)
        embeds, mask = self.prefix_embeds(cond_latents, emovec, text_ids, [tlen])
        return cond_latents, emovec, embeds, mask

    def emotion_mix(self, spk: dict, emo_vector, use_random: bool):
        """The ``emo_vector`` branch: one row of each emotion's matrix (the
        one whose speaker row is closest in cosine to the prompt's style, or
        a random one with ``use_random``), mixed by the weights. Returns
        (emovec_mat (1, D) f32, the weights' sum); the request's emovec
        becomes ``emovec_mat + (1 - sum) * emovec``."""
        weights = torch.as_tensor(np.asarray(emo_vector, np.float32), device=self.device)
        if use_random:
            idxs = [random.randint(0, n - 1) for n in self.cfg.emo_num]
        else:
            idxs = [find_most_similar_cosine(spk["style"][0], m) for m in self.spk_matrix]
        emo_mat = torch.cat([m[i][None, :] for i, m in zip(idxs, self.emo_matrix)], dim=0)
        return (weights[:, None] * emo_mat).sum(0)[None, :], float(weights.sum())

    def decode(self, embeds: torch.Tensor, mask: torch.Tensor, sampling: SamplingConfig,
               max_mel_tokens: int, batched: bool = False, verbose: bool = False):
        """[G] codes (B, max_mel_tokens) on the device, stop-padded, and
        lengths (B,) numpy, of B prefix rows, routed as the JAX pipeline
        routes them. A segment decoded alone (``batched`` False: the single
        segment, the sequential loop, streaming) at num_beams=1 without an
        aux mode or a mesh takes the self-gating speculative decoder
        (`generate_spec_adaptive`, gamma from INDEXTTS_SPEC_DECODE, the
        n-gram from INDEXTTS_SPEC_NGRAM; its stats in `last_spec_stats`).
        Otherwise: beams (diverse with ``num_beam_groups`` > 1) in chunks of
        ``max(1, MAX_ROWS // num_beams)`` prefix rows, the aux modes over all
        rows at once, the sampling decode in chunks of MAX_ROWS rows, so that
        a quantized chunk stays on K1 (on a tensor-parallel GPT, one chunk,
        as the JAX pipeline decodes under a mesh). The pipeline's generator
        serves the chunks in order. A batch on a dp mesh is padded to a
        multiple of dp (padded rows repeat row 0 and are dropped), and each
        dp rank decodes its rows (`batch_sharding`) on its device
        (`_on_ranks`), in chunks as above, from a generator of its own (seeded
        from the pipeline's when sampling)."""
        B = embeds.shape[0]
        mesh = self.mesh
        if not (batched and mesh is not None and mesh.dp > 1 and B > 1):
            return self._decode_rows(self.gpt_params, embeds, mask, sampling, max_mel_tokens,
                                     self.generator, batched, verbose)
        cuts = batch_sharding(mesh, B)
        rows = torch.cat([torch.arange(B), torch.zeros(cuts[-1].stop - B, dtype=torch.long)])
        # a sampling decode draws the ranks' seeds from the pipeline's
        # generator; a greedy one leaves it as the single-device run does
        seeds = [int(torch.randint(0, 2 ** 62, (1,), generator=self.generator,
                                   device=self.generator.device)) if sampling.do_sample else d
                 for d in range(len(cuts))]

        def run(d):
            dev = mesh.device(d)
            gen = torch.Generator(device=dev)
            gen.manual_seed(seeds[d])
            idx = rows[cuts[d]].to(embeds.device)
            return self._decode_rows(self._rank(d)["gpt_params"], embeds[idx].to(dev),
                                     mask[idx].to(dev), sampling, max_mel_tokens, gen, True,
                                     verbose)

        parts, _ = self._on_ranks(run)
        return (torch.cat([p[0].to(self.device) for p in parts])[:B],
                np.concatenate([np.asarray(p[1]) for p in parts])[:B])

    def _decode_rows(self, gpt_params: dict, embeds: torch.Tensor, mask: torch.Tensor,
                     sampling: SamplingConfig, max_mel_tokens: int, generator: torch.Generator,
                     batched: bool, verbose: bool):
        """`decode` of rows on one set of GPT trees (rank 0's, or a dp
        rank's) with ``generator``."""
        B = embeds.shape[0]
        aux = _aux_decode_fn(sampling)
        gamma = 0 if (batched or sampling.num_beams > 1 or aux is not None
                      or self.mesh is not None) else _spec_decode_gamma()
        if gamma > 0:
            codes, lens, stats = generate_spec_adaptive(
                gpt_params, self.cfg.gpt, self.gpt_dims, embeds, mask, generator,
                max_mel_tokens, sampling, self.dtype, gamma=gamma,
                ngram=int(os.environ.get("INDEXTTS_SPEC_NGRAM", "2")),
                step_check=self.decode_check)
            self.last_spec_stats = (gamma, *(int(v) for v in stats))
            if verbose:
                _, ch, com, sg = self.last_spec_stats
                acc = (com - ch) / (ch * gamma) if ch else 0.0
                print(f">> spec decode: {ch} chunk verifies committed {com} tokens, {sg} single "
                      f"steps (per-draft acceptance {acc:.2f}; gate "
                      f"{spec_commit_ratio(gamma):.2f} commits/chunk, a TPU fit)")
            return codes, lens
        if sampling.num_beams > 1:
            fn = generate_group_beam if sampling.num_beam_groups > 1 else generate_beam
            chunk = max(1, MAX_ROWS // sampling.num_beams)
        elif aux is not None:
            fn, chunk = aux, B
        else:
            fn, chunk = generate_adaptive, MAX_ROWS
        if is_tp(gpt_params["gpt"]):
            chunk = B
        parts = [fn(gpt_params, self.cfg.gpt, self.gpt_dims, embeds[i:i + chunk],
                    mask[i:i + chunk], generator, max_mel_tokens, sampling, self.dtype,
                    step_check=self.decode_check) for i in range(0, B, chunk)]
        return (torch.cat([p[0] for p in parts]),
                np.concatenate([np.asarray(p[1]) for p in parts]))

    def cfm_noise(self, shape) -> torch.Tensor:
        """The CFM's initial noise (B, T, 80), a standard normal draw from
        the pipeline's generator."""
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)

    def codes_to_wav(self, spk: dict, cond_latents, emovec, text_ids: np.ndarray,
                     tlens, codes: torch.Tensor, clens, z: Optional[torch.Tensor] = None,
                     times: Optional[dict] = None) -> np.ndarray:
        """[S1] + [S2] + [V] of B rows at once: mel codes (B, >= max clen)
        of the text rows ``text_ids`` (B, tb) -> float wav (B, n) numpy, n =
        int(max clen * 1.72) * 256; row b is zero past int(clens[b] * 1.72)
        * 256. ``tlens`` / ``clens``: an int each, or B of them. One
        teacher-forced pass, one length-regulated CFM (a DiT batch of 2B
        rows) and one BigVGAN call. ``z`` is the CFM's initial noise (B,
        prompt_bucket + mel_bucket, 80); `cfm_noise` draws it when None.
        ``times`` accumulates per-stage seconds. On a dp mesh the B > 1 rows
        follow the decode's split (`decode`): the buckets and the noise are
        the whole batch's, each dp rank synthesizes its rows (`_synth`), and
        the padded rows are dropped on the host; a stage's seconds are the
        ranks' sum when they ran one after another, their maximum when they
        ran at once."""
        cfg = self.cfg
        times = {} if times is None else times
        B = codes.shape[0]
        tlens = np.broadcast_to(np.asarray(tlens, np.int64).reshape(-1), (B,)).copy()
        clens = np.broadcast_to(np.asarray(clens, np.int64).reshape(-1), (B,)).copy()
        cmax = int(clens.max())
        mel_bucket = pick_bucket(int(cmax * self.MEL_PER_CODE) + 1, cfg.engine.mel_len_buckets)
        total = spk["prompt_cond"].shape[1] + mel_bucket
        if z is None:
            z = self.cfm_noise((B, total, cfg.s2mel.DiT.in_channels))
        mesh = self.mesh
        args = (spk, cond_latents, emovec, cmax, mel_bucket)
        if mesh is None or mesh.dp == 1 or B == 1:
            return self._synth(0, *args, text_ids, tlens, codes, clens, z, times)
        cuts = batch_sharding(mesh, B)
        rows = np.concatenate([np.arange(B), np.zeros(cuts[-1].stop - B, np.int64)])
        rank_times = [{} for _ in cuts]

        def run(d):
            r = rows[cuts[d]]
            return self._synth(d, *args, text_ids[r], tlens[r],
                               codes[torch.as_tensor(r, device=codes.device)], clens[r],
                               z[torch.as_tensor(r, device=z.device)], rank_times[d])

        wavs, at_once = self._on_ranks(run)
        for key in rank_times[0]:
            vals = [t[key] for t in rank_times]
            times[key] = times.get(key, 0.0) + (max(vals) if at_once else sum(vals))
        return np.concatenate(wavs)[:B]

    def _synth(self, d: int, spk: dict, cond_latents, emovec, cmax: int, mel_bucket: int,
               text_ids: np.ndarray, tlens: np.ndarray, codes: torch.Tensor,
               clens: np.ndarray, z: torch.Tensor, times: dict) -> np.ndarray:
        """`codes_to_wav` of rows on dp rank ``d``'s trees and device (rank
        0: the pipeline's), at the batch's ``cmax`` and ``mel_bucket``."""
        cfg, dt = self.cfg, self.dtype
        trees = self._rank(d)
        dev = self.device if d == 0 else self.mesh.device(d)
        eng = cfg.engine
        t0 = time.perf_counter()
        B = codes.shape[0]
        cb = pick_bucket(cmax, eng.mel_len_buckets)
        codes = codes.to(dev)[:, :cb]
        if codes.shape[1] < cb:
            codes = torch.nn.functional.pad(codes, (0, cb - codes.shape[1]),
                                            value=cfg.gpt.stop_mel_token)
        clen_t = torch.as_tensor(clens, device=dev)
        gpt_params, s2mel = trees["gpt_params"], trees["s2mel_params"]
        latent = uv.forward_latents(gpt_params, cfg.gpt, cond_latents.to(dev).expand(B, -1, -1),
                                    emovec.to(dev).expand(B, -1),
                                    torch.as_tensor(text_ids, device=dev),
                                    torch.as_tensor(tlens, device=dev), codes, clen_t,
                                    dtype=dt)[:, :cb]
        s_infer = repcodec_vq2emb(trees["codec_params"], codes) \
            + gpt_layer_forward(s2mel, latent)
        self._sync(dev)
        t1 = time.perf_counter()
        times["gpt_forward"] = times.get("gpt_forward", 0.0) + t1 - t0

        prompt_cond = spk["prompt_cond"].to(dev)
        prompt_bucket = prompt_cond.shape[1]
        total = prompt_bucket + mel_bucket
        target_len = (clen_t.float() * self.MEL_PER_CODE).int()
        prompt_len = torch.full((B,), spk["ref_len"], device=dev)
        cond = length_regulate(s2mel["length_regulator"], cfg.s2mel.length_regulator, clen_t,
                               target_len, out_size=mel_bucket, features=s_infer)
        pos = torch.arange(total, device=dev)[None, :]
        idx = pos - prompt_len[:, None]
        in_tgt = (idx >= 0) & (idx < mel_bucket)
        gathered = torch.gather(cond, 1, idx.clamp(0, mel_bucket - 1)[:, :, None]
                                .expand(-1, -1, cond.shape[-1]))
        buf = torch.zeros((B, total, cond.shape[-1]), dtype=cond.dtype, device=dev)
        buf[:, :prompt_bucket] = prompt_cond[:, :prompt_bucket].to(cond.dtype)
        cat_cond = torch.where((in_tgt & (pos >= prompt_len[:, None]))[:, :, None],
                               gathered, buf)
        C = cfg.s2mel.DiT.in_channels
        prompt_mel = torch.zeros((B, total, C), device=dev)
        prompt_mel[:, :prompt_bucket] = spk["ref_mel"][:, :prompt_bucket].to(dev).float()
        vc = cfm_inference(s2mel["cfm"], cfg.s2mel, cat_cond.to(dt),
                           prompt_len + target_len, prompt_mel.to(dt),
                           spk["style"].to(dev).expand(B, -1).to(dt), n_timesteps=25,
                           inference_cfg_rate=0.7, prompt_len=prompt_len, z=z.to(dev))
        idx2 = torch.clamp(torch.arange(mel_bucket, device=dev)[None, :]
                           + prompt_len[:, None], max=total - 1)
        vc_tgt = torch.gather(vc, 1, idx2[:, :, None].expand(-1, -1, vc.shape[-1]))
        self._sync(dev)
        t2 = time.perf_counter()
        times["s2mel"] = times.get("s2mel", 0.0) + t2 - t1

        wav = bigvgan_forward(trees["bigvgan_params"], cfg.bigvgan, vc_tgt.to(dt), target_len)
        wav_np = wav[:, :self._n_samples(cmax)].float().cpu().numpy()
        times["bigvgan"] = times.get("bigvgan", 0.0) + time.perf_counter() - t2
        return wav_np

    def _n_samples(self, clen: int) -> int:
        """Samples of a segment of ``clen`` codes: int(float32(clen) *
        float32(1.72)) * 256, as the JAX pipeline slices them."""
        return int(np.float32(clen) * np.float32(self.MEL_PER_CODE)) * 256

    def interval_silence(self, wavs, sampling_rate=22050, interval_silence=200):
        """The silence streamed after each segment (``wavs`` itself when
        there is nothing before it or ``interval_silence`` <= 0, as in the
        JAX pipeline)."""
        if not wavs or interval_silence <= 0:
            return wavs
        ch = wavs[0].shape[0]
        return np.zeros((ch, int(sampling_rate * interval_silence / 1000.0)), np.float32)

    def insert_interval_silence(self, wavs, sampling_rate=22050, interval_silence=200):
        """``wavs`` with the silence between every two of them."""
        if not wavs or interval_silence <= 0:
            return wavs
        ch = wavs[0].shape[0]
        sil = np.zeros((ch, int(sampling_rate * interval_silence / 1000.0)), np.float32)
        out = []
        for i, w in enumerate(wavs):
            out.append(w)
            if i < len(wavs) - 1:
                out.append(sil)
        return out

    def normalize_emo_vec(self, emo_vector, apply_bias=True):
        return normalize_emo_vec(emo_vector, apply_bias)

    # ------------------------------------------------------------------ infer
    def infer(self, spk_audio_prompt, text, output_path, emo_audio_prompt=None,
              emo_alpha=1.0, emo_vector=None, use_emo_text=False, emo_text=None,
              use_random=False, interval_silence=200, verbose=False,
              max_text_tokens_per_segment=120, stream_return=False,
              more_segment_before=0, **generation_kwargs):
        """Synthesize ``text`` in the voice of ``spk_audio_prompt``. Returns
        ``output_path`` after writing the wav there, or (22050, int16 (T, 1))
        when output_path is None; with ``stream_return`` the generator of
        `infer_generator`. As in the JAX pipeline, ``more_segment_before``
        reaches the generator as its ``quick_streaming_tokens``."""
        args = (spk_audio_prompt, text, output_path, emo_audio_prompt, emo_alpha, emo_vector,
                use_emo_text, emo_text, use_random, interval_silence, verbose,
                max_text_tokens_per_segment, stream_return, more_segment_before)
        if stream_return:
            return self.infer_generator(*args, **generation_kwargs)
        try:
            return list(self.infer_generator(*args, **generation_kwargs))[0]
        except IndexError:
            return None

    @torch.inference_mode()
    def infer_generator(self, spk_audio_prompt, text, output_path, emo_audio_prompt=None,
                        emo_alpha=1.0, emo_vector=None, use_emo_text=False, emo_text=None,
                        use_random=False, interval_silence=200, verbose=False,
                        max_text_tokens_per_segment=120, stream_return=False,
                        quick_streaming_tokens=0, **generation_kwargs):
        """The request, segment by segment (`infer`). Under
        ``stream_return`` it yields each segment's clipped float wav (1, n)
        and then the silence after it, and nothing at the end; otherwise it
        yields the result once."""
        start = time.perf_counter()
        if use_emo_text or emo_vector is not None:
            emo_audio_prompt = None
        if use_emo_text:
            if emo_text is None:
                emo_text = text
            emo_dict = self.qwen_emo.inference(emo_text)
            print(f"detected emotion vectors from text: {emo_dict}")
            emo_vector = list(emo_dict.values())
        if emo_vector is not None:
            scale = max(0.0, min(1.0, emo_alpha))
            if scale != 1.0:
                emo_vector = [int(x * scale * 10000) / 10000 for x in emo_vector]
        if emo_audio_prompt is None:
            emo_audio_prompt, emo_alpha = spk_audio_prompt, 1.0
        sampling = self._sampling(generation_kwargs)
        max_mel_tokens = int(generation_kwargs.get("max_mel_tokens", 1500))

        spk = self._prepare_spk_prompt(spk_audio_prompt)
        emo_cond = self._prepare_emo_cond(emo_audio_prompt)
        emo_mix = None if emo_vector is None else self.emotion_mix(spk, emo_vector, use_random)
        if self.tokenizer is None:
            raise RuntimeError("no tokenizer loaded (missing bpe.model)")
        segments = self.tokenizer.split_segments(
            self.tokenizer.tokenize(text), max_text_tokens_per_segment,
            quick_streaming_tokens=quick_streaming_tokens)
        seg_ids = [self.tokenizer.convert_tokens_to_ids(s) for s in segments]
        if verbose:
            print("segments count:", len(segments))
        self._sync()
        times = {"prompt": time.perf_counter() - start, "gpt": 0.0}
        wavs: List[np.ndarray] = []
        clens: List[int] = []
        warned = False
        if segments:
            t0 = time.perf_counter()
            cond_latents, emovec = self.conditioning(spk, emo_cond, emo_alpha)
            if emo_mix is not None:
                emovec = emo_mix[0] + (1.0 - emo_mix[1]) * emovec
            times["gpt"] += time.perf_counter() - t0
        if self.cfg.engine.batch_segments and len(segments) > 1 and not stream_return:
            # every segment in one left-padded batch: one prefix, one decode
            # (in row chunks), one synthesis; the rows sliced out on the host
            t0 = time.perf_counter()
            tlens = [len(ids) for ids in seg_ids]
            text_ids = self._text_rows(seg_ids)
            embeds, mask = self.prefix_embeds(cond_latents, emovec, text_ids, tlens)
            codes, code_lens = self.decode(embeds, mask, sampling, max_mel_tokens, batched=True)
            times["gpt"] += time.perf_counter() - t0
            clens = [max(int(n), 1) for n in code_lens]
            batch_wav = self.codes_to_wav(spk, cond_latents, emovec, text_ids, tlens, codes,
                                          clens, times=times)
            for i, clen in enumerate(clens):
                warned = warned or self._warn_max_mel(int(code_lens[i]), max_mel_tokens,
                                                      max_text_tokens_per_segment)
                if verbose:
                    print(f"segment {i}: text_tokens={tlens[i]}, codes={clen}")
                wavs.append(np.clip(32767 * batch_wav[i:i + 1, :self._n_samples(clen)],
                                    -32767.0, 32767.0))
        else:
            silence = None
            for i, ids in enumerate(seg_ids):
                t0 = time.perf_counter()
                text_ids = self._text_rows([ids])
                embeds, mask = self.prefix_embeds(cond_latents, emovec, text_ids, [len(ids)])
                codes, code_lens = self.decode(embeds, mask, sampling, max_mel_tokens,
                                               verbose=verbose)
                times["gpt"] += time.perf_counter() - t0
                warned = warned or self._warn_max_mel(int(code_lens[0]), max_mel_tokens,
                                                      max_text_tokens_per_segment)
                clens.append(max(int(code_lens[0]), 1))
                if verbose:
                    print(f"segment {i}: text_tokens={len(ids)}, codes={clens[-1]}")
                wav = self.codes_to_wav(spk, cond_latents, emovec, text_ids, len(ids), codes,
                                        clens[-1], times=times)
                wavs.append(np.clip(32767 * wav, -32767.0, 32767.0))
                if stream_return:
                    yield wavs[-1]
                    if silence is None:
                        silence = self.interval_silence(wavs, self.SAMPLING_RATE,
                                                        interval_silence)
                    yield silence

        wavs = self.insert_interval_silence(wavs, self.SAMPLING_RATE, interval_silence)
        wav = np.concatenate(wavs, axis=1) if wavs else np.zeros((1, 0), np.float32)
        end = time.perf_counter()
        audio_s = wav.shape[-1] / self.SAMPLING_RATE
        times.update(total=end - start, audio_s=audio_s, codes=sum(clens), segment_codes=clens,
                     rtf=(end - start) / audio_s if audio_s > 0 else float("nan"))
        self.last_stage_times = times
        print(">> " + ", ".join(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                                for k, v in times.items()))
        if output_path:
            if os.path.isfile(output_path):
                os.remove(output_path)
            write_wav(output_path, wav.astype(np.int16), self.SAMPLING_RATE)
            if stream_return:
                return
            yield output_path
        else:
            if stream_return:
                return
            yield self.SAMPLING_RATE, wav.astype(np.int16).T

    @staticmethod
    def _warn_max_mel(clen: int, max_mel_tokens: int, max_text_tokens_per_segment: int) -> bool:
        """Warn, as the JAX pipeline does, when a segment's decode stopped at
        ``max_mel_tokens``; returns whether it warned."""
        if clen < max_mel_tokens:
            return False
        warnings.warn(
            f"WARN: generation stopped due to exceeding `max_mel_tokens` "
            f"({max_mel_tokens}). Consider reducing "
            f"`max_text_tokens_per_segment`({max_text_tokens_per_segment}) "
            f"or increasing `max_mel_tokens`.", RuntimeWarning)
        return True

    def _text_rows(self, seg_ids: Sequence[Sequence[int]]) -> np.ndarray:
        """The segments' token ids as (B, text bucket of the longest) int64
        rows, zero-padded on the right."""
        rows = np.zeros((len(seg_ids), pick_bucket(max(len(ids) for ids in seg_ids),
                                                   self.cfg.engine.text_buckets)), np.int64)
        for i, ids in enumerate(seg_ids):
            rows[i, :len(ids)] = ids
        return rows

    def _sampling(self, kw: dict) -> SamplingConfig:
        """The generation kwargs of the reference's `infer` (same defaults),
        the aux modes' included, with the KV-cache format of the
        quantization; the JAX pipeline's ValueErrors for the combinations it
        refuses."""
        num_beams = int(kw.get("num_beams", 3))
        do_sample = bool(kw.get("do_sample", True))
        num_beam_groups = int(kw.get("num_beam_groups", 1))
        dola_layers = kw.get("dola_layers")
        if isinstance(dola_layers, list):
            dola_layers = tuple(dola_layers)
        if num_beam_groups > 1:
            if num_beams % num_beam_groups:
                raise ValueError("num_beams must be divisible by num_beam_groups")
            if do_sample:
                raise ValueError("diverse beam search requires do_sample=False")
        if dola_layers is not None and num_beams > 1:
            raise ValueError("dola_layers requires num_beams=1")
        return SamplingConfig(
            do_sample=do_sample,
            temperature=float(kw.get("temperature", 0.8)),
            top_k=int(kw.get("top_k", 30)), top_p=float(kw.get("top_p", 0.8)),
            repetition_penalty=float(kw.get("repetition_penalty", 10.0)),
            typical_sampling=bool(kw.get("typical_sampling", False)),
            typical_mass=float(kw.get("typical_mass", 0.9)),
            num_beams=num_beams,
            length_penalty=float(kw.get("length_penalty", 0.0)),
            min_new_tokens=int(kw.get("min_new_tokens", 0)),
            num_beam_groups=num_beam_groups,
            diversity_penalty=float(kw.get("diversity_penalty", 0.0)),
            penalty_alpha=float(kw.get("penalty_alpha", 0.0)), dola_layers=dola_layers,
            kv_quant=bool(self.quantization and QUANTIZATIONS[self.quantization][1]))
