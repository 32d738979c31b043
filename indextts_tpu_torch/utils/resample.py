"""Audio resampling (host-side, numpy/scipy polyphase).

The reference resamples prompts with ``torchaudio.transforms.Resample``
(`infer_v2.py:444-445`). Here we use a kaiser-windowed-sinc polyphase
resampler (scipy), which is the same family of filter (torchaudio's default is
sinc_interp_hann with 6-zero lowpass; differences are inaudible and far below
the model's noise floor). Host-side is the right place: prompts are a few
seconds, resampled once and cached.
"""

from __future__ import annotations

from math import gcd

import numpy as np
from scipy.signal import resample_poly


def resample_audio(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Resample (..., T) float audio between integer sample rates."""
    if orig_sr == target_sr:
        return x
    g = gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    return resample_poly(x, up, down, axis=-1).astype(np.float32)
