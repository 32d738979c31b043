"""Mel front-ends (PyTorch counterpart of `indextts_tpu/ops/mel.py`).

- `mel_spectrogram`: HiFiGAN-style 80-mel / 22.05 kHz log-mel feeding the
  s2mel DiT prompt and BigVGAN-v2.
- `kaldi_fbank`: Kaldi-compatible 80-bin log fbank at 16 kHz feeding CAMPPlus.
- `seamless_m4t_features`: host-side (numpy) replacement for transformers'
  `SeamlessM4TFeatureExtractor` as the pipeline calls it for w2v-bert: 80-bin
  kaldi fbank of the int16-scaled wave, per-bin normalisation, stride-2
  stacking to 160 dims, and the attention mask. It needs no `transformers`.

Filterbanks are built in numpy (float64) and cached.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from indextts_tpu_torch.ops.stft import (frame_signal, hann_window,
                                         povey_window, stft_magnitude)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_mel = 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= 1000.0,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep,
                    f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_mel = 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, 1000.0 * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def _hz_to_mel_kaldi(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangles (librosa defaults),
    (n_mels, n_fft//2 + 1) float32."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz_pts = _mel_to_hz_slaney(np.linspace(_hz_to_mel_slaney(fmin),
                                           _hz_to_mel_slaney(fmax), n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def kaldi_mel_filterbank(sr: int, n_fft: int, n_mels: int, low_freq: float = 20.0,
                         high_freq: float = 0.0) -> np.ndarray:
    """Kaldi mel bins triangularized in mel space (torchaudio
    `compliance.kaldi.get_mel_banks`), (n_mels, n_fft//2 + 1) float64."""
    if high_freq <= 0.0:
        high_freq = sr / 2.0 + high_freq
    mel_low, mel_high = _hz_to_mel_kaldi(low_freq), _hz_to_mel_kaldi(high_freq)
    delta = (mel_high - mel_low) / (n_mels + 1)
    bin_mels = _hz_to_mel_kaldi(sr / n_fft * np.arange(n_fft // 2 + 1))
    left = mel_low + delta * np.arange(n_mels)[:, None]
    up = (bin_mels[None, :] - left) / delta
    down = (left + 2 * delta - bin_mels[None, :]) / delta
    return np.maximum(0.0, np.minimum(up, down))


@functools.lru_cache(maxsize=8)
def _mel22k_consts(n_fft, num_mels, sr, fmin, fmax):
    return mel_filterbank(sr, n_fft, num_mels, fmin, fmax), hann_window(n_fft)


def mel_spectrogram(y: torch.Tensor, n_fft: int = 1024, num_mels: int = 80,
                    sampling_rate: int = 22050, hop_size: int = 256,
                    win_size: int = 1024, fmin: float = 0.0,
                    fmax: Optional[float] = None) -> torch.Tensor:
    """(B, T) -> (B, num_mels, frames) log-mel: reflect pad (n_fft-hop)/2,
    hann window, |stft| with +1e-9 under the sqrt, slaney mel,
    log(clamp(x, 1e-5))."""
    if win_size != n_fft:
        raise ValueError(f"mel_spectrogram takes win_size == n_fft, got {win_size}, {n_fft}")
    fb, win = _mel22k_consts(n_fft, num_mels, sampling_rate, float(fmin), fmax)
    pad = int((n_fft - hop_size) / 2)
    y = torch.nn.functional.pad(y.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    mag = stft_magnitude(y, torch.as_tensor(win, device=y.device), n_fft, hop_size)
    mel = torch.einsum("mf,bft->bmt", torch.as_tensor(fb, device=y.device), mag)
    return torch.log(torch.clamp(mel, min=1e-5))


@functools.lru_cache(maxsize=4)
def _kaldi_consts(sr, frame_length, num_mel_bins):
    n_fft = 1 << (frame_length - 1).bit_length()
    fb = kaldi_mel_filterbank(sr, n_fft, num_mel_bins).astype(np.float32)
    return n_fft, fb, povey_window(frame_length)


def kaldi_fbank(y: torch.Tensor, num_mel_bins: int = 80,
                sample_frequency: int = 16000, frame_length: int = 400,
                frame_shift: int = 160, preemphasis: float = 0.97) -> torch.Tensor:
    """(B, T) -> (B, frames, num_mel_bins) Kaldi log fbank, dither 0:
    snip-edges framing, per-frame DC removal, pre-emphasis with the first
    sample replicated, povey window, power spectrum, log with a float-eps
    floor."""
    n_fft, fb, win = _kaldi_consts(sample_frequency, frame_length, num_mel_bins)
    frames = frame_signal(y.float(), frame_length, frame_shift)
    frames = frames - frames.mean(-1, keepdim=True)
    shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = (frames - preemphasis * shifted) * torch.as_tensor(win, device=y.device)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = torch.einsum("mf,btf->btm", torch.as_tensor(fb, device=y.device), power)
    return torch.log(torch.clamp(mel, min=float(np.finfo(np.float32).eps)))


@functools.lru_cache(maxsize=1)
def _seamless_consts():
    # transformers `mel_filter_bank(257, 80, 20, 8000, 16000, norm=None,
    # mel_scale="kaldi", triangularize_in_mel_space=True)`: (257, 80) float64
    return kaldi_mel_filterbank(16000, 512, 80).T, povey_window(400, np.float64)


def seamless_m4t_features(audio16k: np.ndarray, stride: int = 2
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """One 16 kHz mono wave ((T,) or (1, T) float) -> (features
    (1, F, 80*stride) float32, attention mask (1, F) int32), as
    `SeamlessM4TFeatureExtractor()(audio, sampling_rate=16000,
    return_tensors="np")` returns them."""
    fb, win = _seamless_consts()
    wave = np.asarray(audio16k, np.float32).reshape(-1).astype(np.float64) * 32768.0
    n = 1 + (wave.size - 400) // 160
    idx = np.arange(400)[None, :] + 160 * np.arange(n)[:, None]
    frames = wave[idx]
    frames = frames - frames.mean(-1, keepdims=True)
    frames[:, 1:] -= 0.97 * frames[:, :-1].copy()
    frames[:, 0] *= 1 - 0.97
    frames = frames * win
    spec = np.fft.rfft(frames, n=512, axis=-1).astype(np.complex64)
    power = np.abs(spec.astype(np.complex128)) ** 2
    mel = np.maximum(1.192092955078125e-07, fb.T @ power.T)
    # (n, 80) view of an (80, n) array: numpy's f32 reductions below then sum
    # in the same order as transformers' (a few ulps otherwise, which the
    # division by small per-bin deviations magnifies)
    feats = np.log(mel).astype(np.float32).T
    feats = (feats - feats.mean(0, keepdims=True)) / np.sqrt(
        feats.var(0, ddof=1, keepdims=True) + 1e-7)
    mask = np.ones(n, np.int32)
    if n % stride:                      # pad_to_multiple_of=2 with zeros
        pad = stride - n % stride
        feats = np.concatenate([feats, np.zeros((pad, 80), np.float32)])
        mask = np.concatenate([mask, np.zeros(pad, np.int32)])
    m = feats.shape[0]
    out = feats.reshape(1, m // stride, 80 * stride)
    return out, mask[None, np.arange(m) % stride == 1]
