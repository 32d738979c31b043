"""WAV read/write without external audio libraries.

The reference uses librosa/torchaudio for I/O (`infer_v2.py:334-346,705`);
here audio I/O is pure stdlib ``wave`` + numpy, keeping the host dependency
surface minimal. Supports PCM16/24/32 and float32 WAVs; output is int16 PCM
like ``torchaudio.save(..., wav.type(torch.int16))``.
"""

from __future__ import annotations

import os
import wave
from typing import Optional, Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono-or-multi (channels, T) in [-1, 1], sr)."""
    with open(path, "rb") as fh:
        header = fh.read(12)
        if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = None
        data = None
        while True:
            chunk_hdr = fh.read(8)
            if len(chunk_hdr) < 8:
                break
            cid = chunk_hdr[:4]
            size = int.from_bytes(chunk_hdr[4:8], "little")
            payload = fh.read(size)
            if size % 2 == 1:
                fh.read(1)
            if cid == b"fmt ":
                fmt = payload
            elif cid == b"data":
                data = payload
                if fmt is not None:
                    break
        if fmt is None or data is None:
            raise ValueError(f"malformed WAV (missing fmt/data chunk): {path}")
    audio_format = int.from_bytes(fmt[0:2], "little")
    n_channels = int.from_bytes(fmt[2:4], "little")
    sr = int.from_bytes(fmt[4:8], "little")
    bits = int.from_bytes(fmt[14:16], "little")
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = int.from_bytes(fmt[24:26], "little")

    if audio_format == 3 and bits == 32:  # IEEE float
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif audio_format == 1 and bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 32:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_format == 1 and bits == 24:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        x = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    elif audio_format == 1 and bits == 8:
        x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV format={audio_format} bits={bits}: {path}")
    if n_channels > 1:
        x = x.reshape(-1, n_channels).T  # (C, T)
    else:
        x = x.reshape(1, -1)
    return x, sr


def read_wav_mono(path: str, target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read WAV, average channels to mono (1, T), optionally resample."""
    x, sr = read_wav(path)
    if x.shape[0] > 1:
        x = x.mean(axis=0, keepdims=True)
    if target_sr is not None and target_sr != sr:
        from indextts_tpu_torch.utils.resample import resample_audio

        x = resample_audio(x, sr, target_sr)
        sr = target_sr
    return x.astype(np.float32), sr


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """Write int16 PCM WAV. Accepts float in [-1, 1] or int16-scaled float.

    Mirrors the reference output path (`infer_v2.py:672,705`): values already
    scaled to int16 range pass through; [-1, 1] floats are scaled.
    """
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[None, :]
    if wav.dtype in (np.float32, np.float64):
        if np.max(np.abs(wav), initial=0.0) <= 4.0:  # treat as [-1, 1] audio
            wav = np.clip(wav * 32767.0, -32767.0, 32767.0)
        wav = np.round(wav).astype(np.int16)
    elif wav.dtype != np.int16:
        wav = wav.astype(np.int16)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(wav.shape[0])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(wav.T.reshape(-1).tobytes())
