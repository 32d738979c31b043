"""Evaluation metrics: mel-cepstral distortion (MCD) with DTW alignment, the
quality gate's measure (counterpart of `indextts_tpu/utils/metrics.py`).

The log-mel is the port's 22.05 kHz `ops/mel.py::mel_spectrogram` (its
filterbank, STFT and log clamp) after numpy's reflect pad, run on the CPU;
the DCT is scipy's; the DTW is numpy. Nothing here needs a card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from indextts_tpu_torch.ops.mel import _mel22k_consts
from indextts_tpu_torch.ops.stft import stft_magnitude

N_FFT, HOP = 1024, 256          # mel_spectrogram's defaults
PAD = (N_FFT - HOP) // 2        # its reflect padding on each side


def _log_mel(wav: np.ndarray) -> np.ndarray:
    """`mel_spectrogram` of one wav, (80, frames), on the CPU. The wav is
    reflect-padded by numpy, as ``jnp.pad`` pads it in the JAX module:
    torch's reflect pad refuses a wav of at most PAD samples, and beyond
    that the two give the same values."""
    y = np.asarray(wav, np.float32)[None, :]
    if y.shape[1] + 2 * PAD < N_FFT:
        return np.zeros((80, 0), np.float32)
    fb, win = _mel22k_consts(N_FFT, 80, 22050, 0.0, None)
    with torch.no_grad():
        y = torch.as_tensor(np.pad(y, ((0, 0), (PAD, PAD)), mode="reflect"))
        mag = stft_magnitude(y, torch.as_tensor(win), N_FFT, HOP)
        mel = torch.einsum("mf,bft->bmt", torch.as_tensor(fb), mag)
        return torch.log(torch.clamp(mel, min=1e-5))[0].numpy()


def mfcc_from_wav(wav: np.ndarray, sr: int = 22050, n_mfcc: int = 13) -> np.ndarray:
    """Log-mel -> DCT-II cepstra, (frames, n_mfcc), c0 dropped. The mel is
    the 22.05 kHz one whatever ``sr`` says, as in the JAX module."""
    from scipy.fftpack import dct

    cep = dct(_log_mel(wav).T, type=2, axis=1, norm="ortho")  # (frames, n_mels)
    return cep[:, 1:n_mfcc + 1]


def dtw_path_cost(a: np.ndarray, b: np.ndarray) -> Tuple[float, int]:
    """DTW over frame-wise euclidean distance; returns (total cost, path len)."""
    na, nb = len(a), len(b)
    dist = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
    acc = np.full((na + 1, nb + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, na + 1):
        for j in range(1, nb + 1):
            acc[i, j] = dist[i - 1, j - 1] + min(acc[i - 1, j], acc[i, j - 1],
                                                 acc[i - 1, j - 1])
    # backtrack the path's length
    i, j, steps = na, nb, 0
    while i > 0 or j > 0:
        steps += 1
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            k = int(np.argmin([acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1]]))
            if k == 0:
                i, j = i - 1, j - 1
            elif k == 1:
                i -= 1
            else:
                j -= 1
    return float(acc[na, nb]), steps


def mcd(wav_a: np.ndarray, wav_b: np.ndarray, sr: int = 22050) -> float:
    """Mel-cepstral distortion (dB) with DTW alignment; standard 10√2/ln10 scale."""
    ca = mfcc_from_wav(wav_a, sr)
    cb = mfcc_from_wav(wav_b, sr)
    if len(ca) == 0 or len(cb) == 0:
        return float("inf")
    cost, steps = dtw_path_cost(ca, cb)
    k = 10.0 * np.sqrt(2.0) / np.log(10.0)
    return k * cost / max(steps, 1)
