"""IndexTTS2 pipeline on PyTorch (counterpart of `indextts_tpu/pipeline/infer_v2.py`).

    tts = IndexTTS2(cfg_path=None, model_dir=..., device="cuda")
    tts.infer(spk_audio_prompt=..., text=..., output_path=...)

One request runs, on ``device``:
  [P] speaker prompt (cached per prompt path): SeamlessM4T features (host)
      -> w2v-bert hidden[17], standardized -> RepCodec quantize; 22 kHz mel;
      Kaldi fbank -> CAMPPlus style; the prompt through the length regulator
  [E] conformer + perceiver speaker latents, merged emotion vector (the
      emotion prompt defaults to the speaker prompt, alpha 1), left-padded
      prefix embeddings
  [G] GPT-2 prefill + beam decode (`engine/beam.py`, K = num_beams)
  [S1] teacher-forced GPT latents -> gpt_layer + vq2emb
  [S2] length regulator -> 25-step CFM Euler solve under CFG (DiT, kernel K2)
  [V] BigVGAN-v2 (kernel K3) -> 22.05 kHz wav

This slice covers one text segment with beam decode (num_beams > 1). Paths
of the JAX pipeline that are not ported yet raise NotImplementedError naming
their ROADMAP item. Weights are random at the configured architecture (drawn
on the device from ``seed``) or handed over from the JAX package through
`load_params`; checkpoint files are not read yet.

Precision: weights and activations in ``dtype`` (bf16 by default) except
CAMPPlus and the mel / fbank front-ends (f32), as on the TPU. TF32 is off
for both matmuls and cuDNN convolutions
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`): the f32 paths stay full f32.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from indextts_tpu.config import IndexTTS2Config, load_config
from indextts_tpu.pipeline.buckets import pad_to, pick_bucket
from indextts_tpu.utils.resample import resample_audio
from indextts_tpu.utils.wav_io import read_wav_mono, write_wav
from indextts_tpu_torch import nn
from indextts_tpu_torch.engine.beam import generate_beam
from indextts_tpu_torch.engine.decode import SamplingConfig
from indextts_tpu_torch.models.codec.repcodec import (init_repcodec, repcodec_quantize,
                                                      repcodec_vq2emb)
from indextts_tpu_torch.models.codec.w2vbert import init_w2vbert, w2vbert_forward
from indextts_tpu_torch.models.gpt import unified_voice as uv
from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims
from indextts_tpu_torch.models.s2mel.campplus import campplus_forward, init_campplus
from indextts_tpu_torch.models.s2mel.cfm import cfm_inference
from indextts_tpu_torch.models.s2mel.length_regulator import length_regulate
from indextts_tpu_torch.models.s2mel.s2mel import gpt_layer_forward, init_s2mel
from indextts_tpu_torch.models.vocoder.bigvgan import bigvgan_forward, init_bigvgan
from indextts_tpu_torch.ops.mel import kaldi_fbank, mel_spectrogram, seamless_m4t_features
from indextts_tpu_torch.text import TextNormalizer, TextTokenizer
from indextts_tpu_torch.utils.jax_params import to_torch

_ROADMAP = "see ROADMAP.md, queue 1 (modules still to port)"


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to the PyTorch pipeline yet ({_ROADMAP})")


class IndexTTS2:
    """Zero-shot TTS, v2 model family, single-segment beam path."""

    MEL_PER_CODE = 1.72  # 25 Hz codes -> ~86 Hz mel
    SAMPLING_RATE = 22050

    def __init__(self, cfg_path: Optional[str] = "checkpoints/config.yaml",
                 model_dir: str = "checkpoints", device: str = "cuda",
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 cfg: Optional[IndexTTS2Config] = None,
                 quantization: Optional[str] = None, mesh=None):
        if quantization is not None:
            _not_ported(f"quantization={quantization!r} (int8 serving config, kernel K1)")
        if mesh is not None:
            _not_ported("multi-device (mesh)")
        self.device = torch.device(device)
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
        for name in (self.cfg.gpt_checkpoint, self.cfg.s2mel_checkpoint):
            if os.path.exists(os.path.join(model_dir, name)):
                _not_ported(f"loading checkpoint {name}")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.gpt_dims = GPT2Dims(self.cfg.gpt.layers, self.cfg.gpt.model_dim, self.cfg.gpt.heads)
        self.load_params(self.random_params(seed))
        self._load_frontend()
        self.cache_spk_audio_prompt = self.cache_spk = None
        self.cache_emo_audio_prompt = self.cache_emo_cond = None
        self.last_stage_times: Dict[str, float] = {}

    # ------------------------------------------------------------------ params
    def random_params(self, seed: int) -> dict:
        """Seeded random weights at the configured widths, in the JAX
        package's layouts, drawn on the device."""
        rng = nn.InitRng(seed, self.device)
        cfg = self.cfg
        return {"gpt": uv.init_unified_voice(rng, cfg.gpt),
                "s2mel": init_s2mel(rng, cfg.s2mel),
                "codec": init_repcodec(rng, cfg.semantic_codec),
                "campplus": init_campplus(rng),
                "bigvgan": init_bigvgan(rng, cfg.bigvgan),
                "w2v": init_w2vbert(rng, cfg.w2v_bert)}

    def load_params(self, trees: dict) -> None:
        """Take JAX-layout parameter trees (keys gpt, s2mel, codec, campplus,
        bigvgan, w2v; optional w2v_mean / w2v_std) through the weight bridge.
        CAMPPlus stays f32; everything else is cast to the pipeline dtype."""
        dev, dt = self.device, self.dtype
        self.gpt_params = to_torch(trees["gpt"], dev, dt)
        self.s2mel_params = to_torch(trees["s2mel"], dev, dt)
        self.codec_params = to_torch(trees["codec"], dev, dt)
        self.bigvgan_params = to_torch(trees["bigvgan"], dev, dt)
        self.w2v_params = to_torch(trees["w2v"], dev, dt)
        self.campplus_params = to_torch(trees["campplus"], dev, torch.float32)
        H = self.cfg.w2v_bert.hidden_size
        self.w2v_mean = to_torch(trees.get("w2v_mean", np.zeros(H, np.float32)), dev,
                                 torch.float32)
        self.w2v_std = to_torch(trees.get("w2v_std", np.ones(H, np.float32)), dev,
                                torch.float32)

    def _load_frontend(self):
        bpe_path = os.path.join(self.model_dir, self.cfg.dataset.get("bpe_model", "bpe.model"))
        self.normalizer = TextNormalizer(enable_glossary=True)
        self.normalizer.load()
        self.tokenizer = (TextTokenizer(bpe_path, self.normalizer)
                          if os.path.exists(bpe_path) else None)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
    def prefix(self, spk: dict, emo_cond, emo_alpha: float, text_ids: np.ndarray,
               tlen: int):
        """[E] (cond_latents, emovec, prefix embeds, prefix mask)."""
        dev, dt, g = self.device, self.dtype, self.cfg.gpt
        emo_emb, emo_len = emo_cond
        spk_emb = spk["spk_cond_emb"].to(dt)
        spk_len = torch.tensor([spk["spk_len"]], device=dev)
        cond_latents = uv.get_conditioning(self.gpt_params, g, spk_emb, spk_len)
        emovec = uv.merge_emovec(self.gpt_params, g, spk_emb, emo_emb.to(dt), spk_len,
                                 torch.tensor([emo_len], device=dev), float(emo_alpha))
        conds = uv.build_conds_latent(self.gpt_params, cond_latents, emovec)
        prefix_len = g.condition_num_latent + 2 + text_ids.shape[1] + 2
        embeds, mask = uv.prepare_prefix_embeds(
            self.gpt_params, g, conds, torch.as_tensor(text_ids, device=dev),
            torch.tensor([tlen], device=dev), prefix_len, dtype=dt)
        return cond_latents, emovec, embeds, mask

    def codes_to_wav(self, spk: dict, cond_latents, emovec, text_ids: np.ndarray,
                     tlen: int, codes: torch.Tensor, clen: int,
                     z: Optional[torch.Tensor] = None, times: Optional[dict] = None):
        """[S1] + [S2] + [V]: mel codes (1, >= clen) -> float wav (1, n) numpy,
        n = int(clen * 1.72) * 256. ``z`` is the CFM's initial noise
        (1, prompt_bucket + mel_bucket, 80); drawn from the pipeline's
        generator when None. ``times`` accumulates per-stage seconds."""
        cfg, dev, dt = self.cfg, self.device, self.dtype
        times = {} if times is None else times
        eng = cfg.engine
        t0 = time.perf_counter()
        cb = pick_bucket(clen, eng.mel_len_buckets)
        codes = codes[:, :cb]
        if codes.shape[1] < cb:
            codes = torch.nn.functional.pad(codes, (0, cb - codes.shape[1]),
                                            value=cfg.gpt.stop_mel_token)
        clen_t = torch.tensor([clen], device=dev)
        latent = uv.forward_latents(self.gpt_params, cfg.gpt, cond_latents, emovec,
                                    torch.as_tensor(text_ids, device=dev),
                                    torch.tensor([tlen], device=dev), codes, clen_t,
                                    dtype=dt)[:, :cb]
        s_infer = repcodec_vq2emb(self.codec_params, codes) \
            + gpt_layer_forward(self.s2mel_params, latent)
        self._sync()
        t1 = time.perf_counter()
        times["gpt_forward"] = times.get("gpt_forward", 0.0) + t1 - t0

        mel_bucket = pick_bucket(int(clen * self.MEL_PER_CODE) + 1, eng.mel_len_buckets)
        prompt_bucket = spk["prompt_cond"].shape[1]
        total = prompt_bucket + mel_bucket
        target_len = (clen_t.float() * self.MEL_PER_CODE).int()
        prompt_len = torch.tensor([spk["ref_len"]], device=dev)
        cond = length_regulate(self.s2mel_params["length_regulator"],
                               cfg.s2mel.length_regulator, clen_t, target_len,
                               out_size=mel_bucket, features=s_infer)
        pos = torch.arange(total, device=dev)[None, :]
        idx = pos - prompt_len[:, None]
        in_tgt = (idx >= 0) & (idx < mel_bucket)
        gathered = torch.gather(cond, 1, idx.clamp(0, mel_bucket - 1)[:, :, None]
                                .expand(-1, -1, cond.shape[-1]))
        buf = torch.zeros((1, total, cond.shape[-1]), dtype=cond.dtype, device=dev)
        buf[:, :prompt_bucket] = spk["prompt_cond"][:, :prompt_bucket].to(cond.dtype)
        cat_cond = torch.where((in_tgt & (pos >= prompt_len[:, None]))[:, :, None],
                               gathered, buf)
        prompt_mel = torch.zeros((1, total, cfg.s2mel.DiT.in_channels), device=dev)
        prompt_mel[:, :prompt_bucket] = spk["ref_mel"][:, :prompt_bucket].float()
        vc = cfm_inference(self.s2mel_params["cfm"], cfg.s2mel, cat_cond.to(dt),
                           prompt_len + target_len, prompt_mel.to(dt),
                           spk["style"].to(dt), n_timesteps=25, inference_cfg_rate=0.7,
                           prompt_len=prompt_len, z=z, generator=self.generator)
        idx2 = torch.clamp(torch.arange(mel_bucket, device=dev)[None, :]
                           + prompt_len[:, None], max=total - 1)
        vc_tgt = torch.gather(vc, 1, idx2[:, :, None].expand(-1, -1, vc.shape[-1]))
        self._sync()
        t2 = time.perf_counter()
        times["s2mel"] = times.get("s2mel", 0.0) + t2 - t1

        wav = bigvgan_forward(self.bigvgan_params, cfg.bigvgan, vc_tgt.to(dt), target_len)
        n_samples = int(np.float32(clen) * np.float32(self.MEL_PER_CODE)) * 256
        wav_np = wav[:, :n_samples].float().cpu().numpy()
        times["bigvgan"] = times.get("bigvgan", 0.0) + time.perf_counter() - t2
        return wav_np

    # ------------------------------------------------------------------ infer
    @torch.inference_mode()
    def infer(self, spk_audio_prompt, text, output_path, emo_audio_prompt=None,
              emo_alpha=1.0, emo_vector=None, use_emo_text=False, emo_text=None,
              use_random=False, interval_silence=200, verbose=False,
              max_text_tokens_per_segment=120, stream_return=False,
              more_segment_before=0, **generation_kwargs):
        """Synthesize ``text`` in the voice of ``spk_audio_prompt``. Returns
        ``output_path`` after writing the wav there, or (22050, int16 (T, 1))
        when output_path is None."""
        del use_random, emo_text, more_segment_before
        if stream_return:
            _not_ported("streaming (stream_return=True)")
        if use_emo_text or emo_vector is not None:
            _not_ported("emotion from text (Qwen) / emo_vector")
        start = time.perf_counter()
        if emo_audio_prompt is None:
            emo_audio_prompt, emo_alpha = spk_audio_prompt, 1.0
        sampling = self._sampling(generation_kwargs)
        max_mel_tokens = int(generation_kwargs.get("max_mel_tokens", 1500))

        spk = self._prepare_spk_prompt(spk_audio_prompt)
        emo_cond = self._prepare_emo_cond(emo_audio_prompt)
        if self.tokenizer is None:
            raise RuntimeError("no tokenizer loaded (missing bpe.model)")
        segments = self.tokenizer.split_segments(self.tokenizer.tokenize(text),
                                                 max_text_tokens_per_segment)
        if len(segments) != 1:
            _not_ported(f"multi-segment synthesis ({len(segments)} segments)")
        ids = self.tokenizer.convert_tokens_to_ids(segments[0])
        tlen = len(ids)
        text_ids = np.zeros((1, pick_bucket(tlen, self.cfg.engine.text_buckets)), np.int64)
        text_ids[0, :tlen] = ids
        self._sync()
        times = {"prompt": time.perf_counter() - start}

        t0 = time.perf_counter()
        cond_latents, emovec, embeds, mask = self.prefix(spk, emo_cond, emo_alpha,
                                                         text_ids, tlen)
        codes, code_lens = generate_beam(self.gpt_params, self.cfg.gpt, self.gpt_dims,
                                         embeds, mask, self.generator, max_mel_tokens,
                                         sampling, self.dtype)
        clen = max(int(code_lens[0]), 1)
        times["gpt"] = time.perf_counter() - t0
        if verbose:
            print(f"text_tokens={tlen}, codes={clen}")
        wav = self.codes_to_wav(spk, cond_latents, emovec, text_ids, tlen, codes, clen,
                                times=times)
        wav = np.clip(32767 * wav, -32767.0, 32767.0)
        end = time.perf_counter()
        audio_s = wav.shape[-1] / self.SAMPLING_RATE
        times.update(total=end - start, audio_s=audio_s, codes=clen,
                     rtf=(end - start) / audio_s if audio_s > 0 else float("nan"))
        self.last_stage_times = times
        print(">> " + ", ".join(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                                for k, v in times.items()))
        if output_path:
            if os.path.isfile(output_path):
                os.remove(output_path)
            write_wav(output_path, wav.astype(np.int16), self.SAMPLING_RATE)
            return output_path
        return self.SAMPLING_RATE, wav.astype(np.int16).T

    @staticmethod
    def _sampling(kw: dict) -> SamplingConfig:
        """The generation kwargs of the reference's `infer` (same defaults);
        the ones whose paths are not ported raise."""
        if int(kw.get("num_beams", 3)) <= 1:
            _not_ported("num_beams=1 decode (speculative / adaptive sampling)")
        if kw.get("typical_sampling", False):
            _not_ported("typical sampling")
        if int(kw.get("num_beam_groups", 1)) > 1 or float(kw.get("penalty_alpha", 0.0)) > 0 \
                or kw.get("dola_layers") is not None:
            _not_ported("diverse beam / contrastive / DoLa decode")
        return SamplingConfig(
            do_sample=bool(kw.get("do_sample", True)),
            temperature=float(kw.get("temperature", 0.8)),
            top_k=int(kw.get("top_k", 30)), top_p=float(kw.get("top_p", 0.8)),
            repetition_penalty=float(kw.get("repetition_penalty", 10.0)),
            num_beams=int(kw.get("num_beams", 3)),
            length_penalty=float(kw.get("length_penalty", 0.0)),
            min_new_tokens=int(kw.get("min_new_tokens", 0)))
