"""IndexTTS-1 / 1.5 pipeline on PyTorch (counterpart of
`indextts_tpu/pipeline/infer_v1.py`): the mel-conditioned GPT, then
BigVGAN v1, 24 kHz output.

    tts = IndexTTS(cfg_path="checkpoints/config.yaml", model_dir="checkpoints")
    tts.infer(audio_prompt=..., text=..., output_path=...)
    tts.infer_fast(audio_prompt=..., text=..., output_path=...)

One request runs, on ``device``:
  [P] the prompt (cached per path): 24 kHz mono, at most 50 s, padded to
      (mel bucket - 1) * 256 samples -> the 100-bin v1 mel
      (`ops/mel.py::mel_spectrogram_24k_v1`)
  [T] the text, tokenized and split into segments of at most
      ``max_text_tokens_per_segment`` tokens
  [G] conditioning latents (`unified_voice_v1.get_conditioning_v1`), the
      left-padded prefix (`unified_voice.prepare_prefix_embeds`), then beam
      search (`engine/beam.py`) for num_beams > 1 or the sampling decode
      (`engine/decode.py::generate_adaptive`); runs of the silence token
      shortened (`remove_long_silence`)
  [L] teacher-forced latents (`forward_latents_v1`)
  [V] BigVGAN v1 (`models/vocoder/bigvgan_v1.py`; every anti-aliased
      activation is kernel K3) -> the wav
`infer` runs the segments one by one; `infer_fast` groups them into
length buckets of at most ``segments_bucket_max_size`` (the reference's
factor-1.5 bucketing, `bucket_segments`) and decodes and synthesizes each
bucket as one left-padded batch.

Precision: ``use_fp16=True`` (the default, as in the JAX pipeline) runs
weights and activations in float16, otherwise in ``dtype`` (bf16 by
default); the mel front end is f32. Float GPT weights take the plain decode
route (`engine/decode.py::decode_route`), so kernel K1 is not on this path;
K3 is, at both element types. TF32 is off, as in `infer_v2.py`.

Weights: ``model_dir`` / ``cfg.gpt_checkpoint`` (gpt.pth) and
``cfg.bigvgan_checkpoint`` (bigvgan_generator.pth), read by
`utils/convert.py::load_torch_state_dict` (which also unwraps the
reference's ``{'generator': state_dict}``; the JAX loader does not) and
converted by the v1 converters; a family without a file is drawn at random
from ``seed`` (`random_trees_v1`). `load_params` also takes trees handed
over from the JAX package.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from indextts_tpu_torch import nn
from indextts_tpu_torch.config import IndexTTS1Config, load_config_v1
from indextts_tpu_torch.engine.beam import generate_beam
from indextts_tpu_torch.engine.decode import SamplingConfig, generate_adaptive
from indextts_tpu_torch.models.gpt import unified_voice as uv
from indextts_tpu_torch.models.gpt import unified_voice_v1 as uv1
from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims
from indextts_tpu_torch.models.vocoder.bigvgan_v1 import bigvgan_v1_forward, init_bigvgan_v1
from indextts_tpu_torch.ops.mel import mel_spectrogram_24k_v1
from indextts_tpu_torch.pipeline.buckets import pad_to, pick_bucket
from indextts_tpu_torch.text import TextNormalizer, TextTokenizer
from indextts_tpu_torch.utils import convert
from indextts_tpu_torch.utils.jax_params import to_torch
from indextts_tpu_torch.utils.wav_io import read_wav_mono, write_wav

MAX_PROMPT_S = 50          # the reference's cap on the prompt (infer.py:309)
FAMILIES = ("gpt", "bigvgan")


def remove_long_silence(codes: np.ndarray, code_lens: np.ndarray, stop_mel_token: int,
                        silent_token: int = 52, max_consecutive: int = 30):
    """Shrink runs of the silence token to at most 10 in a row, in the rows
    where it occurs more than ``max_consecutive`` times in all (the
    reference's trigger is the total count). Returns (codes (B, max new
    length) stop-padded, new lengths (B,) int32)."""
    rows: List[np.ndarray] = []
    for b in range(codes.shape[0]):
        row = codes[b, :int(code_lens[b])]
        if int(np.sum(row == silent_token)) > max_consecutive:
            keep, n = [], 0
            for tok in row.tolist():
                if tok != silent_token:
                    keep.append(tok)
                    n = 0
                elif n < 10:
                    keep.append(tok)
                    n += 1
            row = np.asarray(keep, codes.dtype)
        rows.append(row)
    lens = [len(r) for r in rows]
    out = np.full((codes.shape[0], max(max(lens, default=0), 1)), stop_mel_token, codes.dtype)
    for b, row in enumerate(rows):
        out[b, :len(row)] = row
    return out, np.asarray(lens, np.int32)


def random_trees_v1(cfg: IndexTTS1Config, seed: int, device,
                    families: Sequence[str] = FAMILIES) -> dict:
    """Seeded random weights at ``cfg``'s widths in the JAX package's
    layouts, drawn on ``device``, for ``families`` ("gpt", "bigvgan"), each
    from its own generator (seed * 2 + its index)."""
    inits = {"gpt": lambda r: uv1.init_unified_voice_v1(r, cfg.gpt),
             "bigvgan": lambda r: init_bigvgan_v1(r, cfg.bigvgan)}
    return {name: inits[name](nn.InitRng(seed * len(FAMILIES) + FAMILIES.index(name), device))
            for name in families}


class IndexTTS:
    """Zero-shot TTS, IndexTTS-1 / 1.5 family."""

    SAMPLING_RATE = 24000

    def __init__(self, cfg_path: Optional[str] = "checkpoints/config.yaml",
                 model_dir: str = "checkpoints", use_fp16: bool = True,
                 device: Optional[str] = None, use_cuda_kernel: Optional[bool] = None,
                 seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                 cfg: Optional[IndexTTS1Config] = None):
        """The JAX pipeline's keywords. ``use_fp16=True`` runs in float16,
        otherwise in ``dtype``; ``device`` None is the card (raises without
        CUDA); ``use_cuda_kernel`` is accepted and ignored, as there."""
        del use_cuda_kernel
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("IndexTTS(device='cuda'): CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model_dir = model_dir
        if cfg is not None:
            self.cfg = cfg
        elif cfg_path and os.path.exists(cfg_path):
            self.cfg = load_config_v1(cfg_path)
        else:
            self.cfg = IndexTTS1Config()
        self.dtype = torch.float16 if use_fp16 else dtype
        self.stop_mel_token = self.cfg.gpt.stop_mel_token
        try:
            self.model_version = float(self.cfg.version)
        except (TypeError, ValueError):
            self.model_version = 1.0
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        g = self.cfg.gpt
        self.gpt_dims = GPT2Dims(g.layers, g.model_dim, g.heads)
        self._load_models(seed)
        self._load_frontend()
        self.cache_audio_prompt = None
        self.cache_cond_mel = None
        self.gr_progress = None
        self.last_stage_times: Dict[str, float] = {}

    # ------------------------------------------------------------------ params
    def _load_models(self, seed: int) -> None:
        """gpt.pth and bigvgan_generator.pth under ``model_dir``, converted
        by the v1 converters, as the JAX pipeline's `_load_models` reads
        them (with its log lines); a missing file's family is random."""
        cfg = self.cfg
        gpt_path = os.path.join(self.model_dir, cfg.gpt_checkpoint)
        if os.path.exists(gpt_path):
            sd = convert.load_torch_state_dict(gpt_path)
            self.load_params({"gpt": convert.convert_unified_voice_v1(sd, cfg.gpt)})
            print(">> GPT weights restored from:", gpt_path)
        else:
            self.load_params(random_trees_v1(cfg, seed, self.device, ("gpt",)))
            print(">> GPT randomly initialized (no checkpoint found)")
        bv_path = os.path.join(self.model_dir, cfg.bigvgan_checkpoint)
        if os.path.exists(bv_path):
            sd = convert.load_torch_state_dict(bv_path)
            self.load_params({"bigvgan": convert.convert_bigvgan_v1(sd, cfg.bigvgan)})
            print(">> bigvgan weights restored from:", bv_path)
        else:
            self.load_params(random_trees_v1(cfg, seed, self.device, ("bigvgan",)))
            print(">> bigvgan randomly initialized")

    def load_params(self, trees: dict) -> None:
        """JAX-layout trees ("gpt", "bigvgan") through the weight bridge,
        every float leaf cast to the pipeline dtype (the JAX pipeline's
        `cast_tree`)."""
        for key, attr in (("gpt", "gpt_params"), ("bigvgan", "bigvgan_params")):
            if key in trees:
                setattr(self, attr, to_torch(trees[key], self.device, self.dtype))

    def _load_frontend(self):
        bpe_path = os.path.join(self.model_dir, self.cfg.dataset.get("bpe_model", "bpe.model"))
        self.normalizer = TextNormalizer()
        self.normalizer.load()
        if os.path.exists(bpe_path):
            self.tokenizer = TextTokenizer(bpe_path, self.normalizer)
            print(">> bpe model loaded from:", bpe_path)
        else:
            self.tokenizer = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _set_gr_progress(self, value, desc):
        if self.gr_progress is not None:
            self.gr_progress(value, desc=desc)

    # ----------------------------------------------------------------- prompt
    def _prepare_cond_mel(self, audio_prompt: str, verbose: bool) -> dict:
        """[P] {"mel": (1, mel bucket, 100) f32 on the device, "frames": the
        prompt's valid frames}, cached per prompt path."""
        if self.cache_cond_mel is not None and self.cache_audio_prompt == audio_prompt:
            return self.cache_cond_mel
        audio, _ = read_wav_mono(audio_prompt, target_sr=24000)
        audio = audio[:, :MAX_PROMPT_S * 24000]
        frames = audio.shape[1] // 256 + 1
        fb = pick_bucket(frames, self.cfg.engine.mel_len_buckets)
        a = torch.as_tensor(pad_to(audio, (fb - 1) * 256, axis=1), device=self.device)
        mel = mel_spectrogram_24k_v1(a).transpose(1, 2).contiguous()     # (1, F, 100)
        self.cache_cond_mel = {"mel": mel, "frames": frames}
        self.cache_audio_prompt = audio_prompt
        if verbose:
            print(f"cond_mel frames: {frames} (bucket {mel.shape[1]})")
        return self.cache_cond_mel

    def bucket_segments(self, segments, bucket_max_size: int = 4):
        """Length-bucketed batching (the reference's `infer.py:191-247`):
        segments sorted by length join a bucket while shorter than 1.5x its
        median and it holds fewer than ``bucket_max_size``; single-segment
        buckets are merged into the others."""
        outputs = [{"idx": i, "sent": s, "len": len(s)} for i, s in enumerate(segments)]
        if len(outputs) <= bucket_max_size:
            return [outputs]
        buckets: List[List[dict]] = []
        factor = 1.5
        last_bucket = None
        last_median = 0
        for sent in sorted(outputs, key=lambda x: x["len"]):
            if sent["len"] == 0:
                continue
            if (last_bucket is None or sent["len"] >= int(last_median * factor)
                    or len(last_bucket) >= bucket_max_size):
                buckets.append([sent])
                last_bucket = buckets[-1]
                last_median = sent["len"]
            else:
                last_bucket.append(sent)
                last_median = last_bucket[len(last_bucket) // 2]["len"]
        out_buckets, only_ones = [], []
        for b in buckets:
            (out_buckets if len(b) > 1 else only_ones).append(b if len(b) > 1 else b[0])
        if only_ones:
            for b in out_buckets:
                if len(b) < bucket_max_size:
                    b.append(only_ones.pop(0))
                    if not only_ones:
                        break
            if only_ones:
                out_buckets.extend(only_ones[i:i + bucket_max_size]
                                   for i in range(0, len(only_ones), bucket_max_size))
        return out_buckets

    # ----------------------------------------------------------------- stages
    def _decode_batch(self, cond: dict, sents, sampling: SamplingConfig,
                      max_mel_tokens: int, verbose: bool):
        """[G] B segments' codes: (text_ids (B, tb) int64, tlens (B,), codes
        (B, n) numpy, lens (B,) numpy, cond_latents (B, 32, D), cond_mel (B,
        F, 100), cond_len (B,)). The conditioning is computed once and
        broadcast over the rows (they share the prompt)."""
        cfg, dev = self.cfg, self.device
        B = len(sents)
        ids_list = [self.tokenizer.convert_tokens_to_ids(s) for s in sents]
        tb = pick_bucket(max(len(i) for i in ids_list), cfg.engine.text_buckets)
        text_ids = np.full((B, tb), cfg.gpt.stop_text_token, np.int64)
        tlens = np.zeros((B,), np.int64)
        for b, ids in enumerate(ids_list):
            text_ids[b, :len(ids)] = ids
            tlens[b] = len(ids)
        prefix_len = cfg.gpt.condition_num_latent + tb + 2
        cond_mel = cond["mel"].expand(B, -1, -1)
        cond_len = torch.full((B,), cond["frames"], device=dev)
        cond_latents = uv1.get_conditioning_v1(self.gpt_params, cfg.gpt,
                                               cond["mel"].to(self.dtype), cond_len[:1])
        cond_latents = cond_latents.expand(B, -1, -1)
        embeds, mask = uv.prepare_prefix_embeds(
            self.gpt_params, cfg.gpt, cond_latents, torch.as_tensor(text_ids, device=dev),
            torch.as_tensor(tlens, device=dev), prefix_len, dtype=self.dtype)
        fn = generate_beam if sampling.num_beams > 1 else generate_adaptive
        codes, code_lens = fn(self.gpt_params, cfg.gpt, self.gpt_dims, embeds, mask,
                              self.generator, max_mel_tokens, sampling, self.dtype)
        codes_np = codes.cpu().numpy()
        lens_np = np.maximum(np.asarray(code_lens), 1)
        codes_np, lens_np = remove_long_silence(codes_np, lens_np, self.stop_mel_token)
        if verbose:
            print(f"decoded {B} segment(s): codes {lens_np.tolist()}")
        return text_ids, tlens, codes_np, lens_np, cond_latents, cond_mel, cond_len

    def _synthesize_batch(self, cond_latents, cond_mel, cond_len, text_ids, tlens,
                          codes_np, lens_np, times: Optional[dict] = None) -> list:
        """[L] + [V] of B rows: one teacher-forced pass and one BigVGAN call
        at the code bucket; returns each row's float wav (1, lens[b] *
        total_upsample) numpy. ``times`` accumulates gpt_forward and bigvgan
        seconds."""
        cfg, dev, dt = self.cfg, self.device, self.dtype
        times = {} if times is None else times
        t0 = time.perf_counter()
        cb = pick_bucket(int(lens_np.max()), cfg.engine.mel_len_buckets)
        codes_b = torch.as_tensor(pad_to(codes_np, cb, axis=1, value=self.stop_mel_token),
                                  device=dev)
        code_len = torch.as_tensor(np.asarray(lens_np, np.int64), device=dev)
        latent = uv1.forward_latents_v1(
            self.gpt_params, cfg.gpt, cond_latents, torch.as_tensor(text_ids, device=dev),
            torch.as_tensor(tlens, device=dev), codes_b, code_len, dtype=dt)[:, :cb]
        self._sync()
        t1 = time.perf_counter()
        times["gpt_forward"] = times.get("gpt_forward", 0.0) + t1 - t0
        wav = bigvgan_v1_forward(self.bigvgan_params, cfg.bigvgan, latent.to(dt),
                                 cond_mel.to(dt), latent_lens=code_len, mel_ref_lens=cond_len)
        wav = wav.float().cpu().numpy()
        times["bigvgan"] = times.get("bigvgan", 0.0) + time.perf_counter() - t1
        up = cfg.bigvgan.total_upsample
        return [wav[b:b + 1, :int(lens_np[b]) * up] for b in range(wav.shape[0])]

    # ------------------------------------------------------------------ infer
    def _start(self, audio_prompt, text, max_text_tokens_per_segment, generation_kwargs,
               verbose):
        """The request's prompt, sampling, segments and stage clock."""
        start = time.perf_counter()
        if self.tokenizer is None:
            raise RuntimeError("no tokenizer loaded (missing bpe.model)")
        cond = self._prepare_cond_mel(audio_prompt, verbose)
        sampling, max_mel_tokens = self._sampling_from_kwargs(generation_kwargs)
        segments = self.tokenizer.split_segments(self.tokenizer.tokenize(text),
                                                 max_text_tokens_per_segment)
        self._sync()
        times = {"prompt": time.perf_counter() - start, "gpt": 0.0, "gpt_forward": 0.0,
                 "bigvgan": 0.0, "codes": 0}
        return start, cond, sampling, max_mel_tokens, segments, times

    def _segments(self, times: dict, cond: dict, sents, sampling: SamplingConfig,
                  max_mel_tokens: int, verbose: bool) -> list:
        """[G] + [L] + [V] of one batch of segments: their float wavs;
        ``times`` accumulates the stage seconds and the codes."""
        t0 = time.perf_counter()
        (text_ids, tlens, codes_np, lens_np, cond_latents, cond_mel,
         cond_len) = self._decode_batch(cond, sents, sampling, max_mel_tokens, verbose)
        times["gpt"] += time.perf_counter() - t0
        times["codes"] += int(lens_np.sum())
        return self._synthesize_batch(cond_latents, cond_mel, cond_len, text_ids, tlens,
                                      codes_np, lens_np, times=times)

    @torch.inference_mode()
    def infer(self, audio_prompt, text, output_path, verbose=False,
              max_text_tokens_per_segment=120, **generation_kwargs):
        """Synthesize ``text`` segment by segment in the voice of
        ``audio_prompt``. Returns ``output_path`` after writing the wav
        there, or (24000, int16 (T, 1)) when output_path is None."""
        print(">> start inference...")
        self._set_gr_progress(0, "start inference...")
        start, cond, sampling, max_mel_tokens, segments, times = self._start(
            audio_prompt, text, max_text_tokens_per_segment, generation_kwargs, verbose)
        wavs = []
        for i, sent in enumerate(segments):
            self._set_gr_progress(0.2 + 0.6 * i / max(len(segments), 1),
                                  f"inference {i + 1}/{len(segments)}...")
            wavs.extend(self._segments(times, cond, [sent], sampling, max_mel_tokens,
                                       verbose))
        return self._finalize(wavs, output_path, start, times)

    @torch.inference_mode()
    def infer_fast(self, audio_prompt, text, output_path, verbose=False,
                   max_text_tokens_per_segment=100, segments_bucket_max_size=4,
                   **generation_kwargs):
        """The segments in length buckets (`bucket_segments`), each bucket
        decoded and synthesized as one batch; the wav joins them in text
        order."""
        print(">> starting fast inference...")
        start, cond, sampling, max_mel_tokens, segments, times = self._start(
            audio_prompt, text, max_text_tokens_per_segment, generation_kwargs, verbose)
        results = {}
        for bucket in self.bucket_segments(segments, bucket_max_size=segments_bucket_max_size):
            if not bucket:          # an empty text: no segment to decode
                continue
            wavs = self._segments(times, cond, [item["sent"] for item in bucket], sampling,
                                  max_mel_tokens, verbose)
            for item, w in zip(bucket, wavs):
                results[item["idx"]] = w
        return self._finalize([results[i] for i in sorted(results)], output_path, start,
                              times)

    def _sampling_from_kwargs(self, kw: dict):
        """(SamplingConfig, max_mel_tokens) from the generation kwargs: the
        JAX pipeline's keys and defaults, no others."""
        sampling = SamplingConfig(
            do_sample=bool(kw.pop("do_sample", True)),
            temperature=float(kw.pop("temperature", 1.0)),
            top_k=int(kw.pop("top_k", 30)),
            top_p=float(kw.pop("top_p", 0.8)),
            repetition_penalty=float(kw.pop("repetition_penalty", 10.0)),
            num_beams=int(kw.pop("num_beams", 3)),
            length_penalty=float(kw.pop("length_penalty", 0.0)),
            typical_sampling=bool(kw.pop("typical_sampling", False)),
            typical_mass=float(kw.pop("typical_mass", 0.9)))
        return sampling, int(kw.pop("max_mel_tokens", 600))

    def _finalize(self, wavs, output_path, start_time, times: dict):
        """int16 output at 24 kHz: the path after writing it, or (24000,
        (T, 1) int16). Records `last_stage_times` (prompt, gpt, gpt_forward,
        bigvgan and total seconds, synchronized; audio seconds, codes, RTF)."""
        wav = np.concatenate(wavs, axis=1) if wavs else np.zeros((1, 0), np.float32)
        wav = np.clip(32767 * wav, -32767.0, 32767.0)
        end_time = time.perf_counter()
        wav_length = wav.shape[-1] / self.SAMPLING_RATE
        times.update(total=end_time - start_time, audio_s=wav_length,
                     rtf=(end_time - start_time) / wav_length if wav_length > 0
                     else float("nan"))
        self.last_stage_times = times
        print(f">> Total inference time: {end_time - start_time:.2f} seconds")
        print(f">> Generated audio length: {wav_length:.2f} seconds")
        if wav_length > 0:
            print(f">> RTF: {(end_time - start_time) / wav_length:.4f}")
        if output_path:
            if os.path.isfile(output_path):
                os.remove(output_path)
            write_wav(output_path, wav.astype(np.int16), self.SAMPLING_RATE)
            print(">> wav file saved to:", output_path)
            return output_path
        return (self.SAMPLING_RATE, wav.astype(np.int16).T)
