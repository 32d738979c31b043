"""Length bucketing (a copy of the JAX package's
`indextts_tpu/pipeline/buckets.py`, so that the port imports nothing of that
package).

Variable-length inputs (prompts, text segments, generated code counts) are
padded up to the nearest bucket, so the port runs the same padded shapes as
the JAX package and its outputs compare position for position.
"""

from __future__ import annotations

import warnings
from typing import Sequence, Tuple

import numpy as np


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; past the table, ceil to the next multiple of 128.

    Never returns a bucket smaller than ``n``: the old behavior (silently
    returning the last bucket) truncated any request past the table — at the
    reference's default decode cap of 1500 codes
    (upstream `indextts/infer_v2.py:534`) that dropped 21% of the
    audio. Buckets compile lazily, so an off-table size costs one ad-hoc
    compile instead of lost output; a RuntimeWarning flags the config gap.
    """
    for b in buckets:
        if n <= b:
            return b
    up = -(-int(n) // 128) * 128
    warnings.warn(
        f"length {n} exceeds the largest configured bucket {buckets[-1]}; "
        f"compiling an ad-hoc {up}-frame bucket (extend the bucket table "
        f"to avoid recompiles)", RuntimeWarning)
    return up


def pad_to(x: np.ndarray, length: int, axis: int = -1, value=0) -> np.ndarray:
    axis = axis % x.ndim
    cur = x.shape[axis]
    if cur == length:
        return x
    if cur > length:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, length)
        return x[tuple(sl)]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, length - cur)
    return np.pad(x, pad, constant_values=value)
