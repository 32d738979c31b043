"""PyTorch port, `indextts_tpu_torch/utils/metrics.py` (MCD with DTW) and
`utils/profiling.py` (stage timers, the trace scope) against the JAX
package's `indextts_tpu/utils/metrics.py` and `utils/profiling.py` on the
CPU.

Tolerances: the cepstra within atol 1e-4 (f32 log-mels of two STFT
implementations; the DCT is scipy's on both sides), the DTW exactly (one
numpy algorithm on the same input), the MCD of a wav and a noisy copy within
1e-3 dB.
"""

import json
import time

import numpy as np
import pytest

from indextts_tpu.utils import metrics as jmetrics
from indextts_tpu.utils import profiling as jprofiling
from indextts_tpu_torch.utils import metrics, profiling

SR = 22050


def _wav(seed: int, seconds: float = 0.6) -> np.ndarray:
    r = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    f0 = 110.0 * (1 + seed)
    wav = 0.4 * np.sin(2 * np.pi * f0 * t) * np.sin(2 * np.pi * 3 * t) \
        + 0.05 * r.standard_normal(t.size)
    return wav.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_mfcc_matches_jax(seed):
    wav = _wav(seed)
    got, want = metrics.mfcc_from_wav(wav), jmetrics.mfcc_from_wav(wav)
    assert got.shape == want.shape == (len(wav) // 256, 13)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_dtw_path_cost_equals_jax():
    r = np.random.default_rng(3)
    a, b = r.standard_normal((23, 13)), r.standard_normal((31, 13))
    assert metrics.dtw_path_cost(a, b) == jmetrics.dtw_path_cost(a, b)
    assert metrics.dtw_path_cost(a, a) == (0.0, len(a))


@pytest.mark.parametrize("n", [100, 300, 385, 1023])
def test_mfcc_of_short_wavs_matches_jax(n):
    """0, 1, 2 and 3 frames; 300 samples are too few for torch's reflect
    padding, 385 the fewest it takes."""
    wav = _wav(0)[:n]
    got, want = metrics.mfcc_from_wav(wav), jmetrics.mfcc_from_wav(wav)
    assert got.shape == want.shape == (max(0, (n + 2 * 384 - 1024) // 256 + 1), 13)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if n > metrics.PAD:     # numpy's reflect pad gives mel_spectrogram's bits
        import torch

        from indextts_tpu_torch.ops.mel import mel_spectrogram

        np.testing.assert_array_equal(metrics._log_mel(wav),
                                      mel_spectrogram(torch.tensor(wav)[None])[0].numpy())


def test_mcd_of_a_wav_with_itself_is_zero():
    wav = _wav(0)
    assert metrics.mcd(wav, wav) == 0.0
    assert metrics.mcd(wav, wav[:100]) == jmetrics.mcd(wav, wav[:100]) == float("inf")


def test_mcd_with_a_noisy_copy_matches_jax():
    wav = _wav(1)
    noisy = wav + 0.02 * np.random.default_rng(7).standard_normal(wav.size).astype(np.float32)
    got, want = metrics.mcd(wav, noisy[:-700]), jmetrics.mcd(wav, noisy[:-700])
    assert got > 0.1
    assert abs(got - want) <= 1e-3, (got, want)


def test_stage_timers_accumulate():
    timers, jtimers = profiling.StageTimers(), jprofiling.StageTimers()
    for t in (timers, jtimers):
        for _ in range(2):
            with t.time("gpt"):
                time.sleep(0.01)
        with t.time("s2mel"):
            pass
    assert list(timers.totals) == list(jtimers.totals) == ["gpt", "s2mel"]
    assert timers.totals["gpt"] >= 0.02 and timers.totals["s2mel"] < timers.totals["gpt"]
    assert timers.report().splitlines()[0].startswith(">> gpt: 0.0")
    timers.reset()
    assert timers.totals == {} and timers.report() == ""


def test_trace_writes_a_chrome_trace_naming_the_annotated_range(tmp_path):
    import torch

    with profiling.trace(None):                 # traces nothing, as in JAX
        pass
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("tts_stage_gpt"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").iterdir())
    assert [f.name for f in files] == ["trace.json"]
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "tts_stage_gpt" for e in events)
