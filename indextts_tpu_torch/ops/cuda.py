"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with `ctypes`. The build happens at
first use, from the package's own sources, into ``build/kernels/<hash>/``
beside the package (a directory git ignores); a change to any source gives a
new hash and so a rebuild. Nothing is built or loaded at import time.

Each C entry point launches on the caller's stream and returns
``cudaGetLastError()``; `check` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, lengths, cos, sin, out, B, T, H, D, scale, stream
    "attention_rope_launch": [_P] * 7 + [_I] * 4 + [_F, _P],
    # x, alpha, beta, lengths, taps, out, B, T, C, stream
    "antialias_snake_launch": [_P] * 6 + [_I] * 3 + [_P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build with the CUDA "
                       "toolkit's compiler (on PATH or /usr/local/cuda/bin)")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path. The compiler's report (registers, shared memory,
    spills per kernel) is kept beside it in ``build.log``."""
    out_dir = build_dir()
    lib = out_dir / "libindextts_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        msg = library().kernel_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def stream_ptr(t) -> int:
    """The raw cudaStream_t of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
