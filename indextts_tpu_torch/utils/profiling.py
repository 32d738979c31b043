"""Tracing and profiling (counterpart of `indextts_tpu/utils/profiling.py`):
accumulating wall-clock stage timers, a `torch.profiler` trace scope that
writes a Chrome / Perfetto trace, and named ranges inside it.

On the card a profiler window can drop records at either end (device and
host clocks disagree near its edges); `chip_smoke.py::_spin_pad` pads a
window with spin kernels where every launch must be recorded.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


class StageTimers:
    """Accumulating named wall-clock timers (the reference's gpt_gen_time /
    s2mel_time / bigvgan_time pattern, `infer_v2.py:538-541`)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return "\n".join(f">> {k}: {v:.2f} seconds" for k, v in self.totals.items())

    def reset(self):
        self.totals.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A `torch.profiler` scope over CPU and (where there is a card) CUDA
    activity; on exit it writes ``trace.json`` (Chrome / Perfetto) into
    ``log_dir``, made if missing. ``None`` traces nothing.

    Usage:
        with profiling.trace("runs/tts_trace"):
            tts.infer(...)
    """
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range inside a trace (a context manager; shows up in the
    profiler's timeline)."""
    return torch.profiler.record_function(name)
