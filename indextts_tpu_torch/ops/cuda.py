"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

The sources compile with ``nvcc`` for Hopper (``sm_90a``), one compiler
process per source, all started together, and link into one shared library
with a plain C interface, loaded with `ctypes`. The build happens at
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
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_COUNT_LOCK = threading.Lock()


def count(wrapper, attr: str = "launches") -> None:
    """Add one to a kernel wrapper's launch counter (``wrapper.launches``,
    or ``attr``) under a lock: the dp ranks of a mesh over distinct cards
    launch from one host thread each."""
    with _COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # q, k, freqs_cis, q out, k out, B, T, H, D, half (fp16 q, k), stream
    "rope_qk_launch": [_P] * 5 + [_I] * 5 + [_P],
    # q, k, v, lengths, freqs_cis, q scratch, k scratch, out, B, T, H, D,
    # scale, half (fp16 operands), stream
    "attention_rope_launch": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
    # q, k, v, lengths, out, B, T, H, D, scale, half, stream
    "packed_attention_launch": [_P] * 5 + [_I] * 4 + [_F, _I, _P],
    # q, k, v, lengths, out, B, H, T, D, the (b, h, t) strides of q, k, v and
    # out, scale, half, stream
    "attention_block_launch": [_P] * 5 + [_I] * 4 + [_L] * 12 + [_F, _I, _P],
    # x, alpha, beta, lengths, taps, out, B, T, C, logscale, half (fp16 x), stream
    "antialias_snake_launch": [_P] * 6 + [_I] * 5 + [_P],
    # x, q, ln_w, ln_b, scale, bias, res, out, M, N, K, half_span, epilogue,
    # the launch plan (ops/int8.py::GemvPlan: rows, split, span, smem), stream
    "int8_gemv_launch": [_P] * 8 + [_I] * 9 + [_P],
    # qkv, ck, cv, kvs, kv_valid, anc, part_ml, part_o (not read), out, M, S,
    # D, H, pos, group, scale, the launch plan (ops/decode_step.py::
    # AttnPlan: heads, chunks, cluster, stages, smem), stream
    "decode_attention_launch": [_P] * 9 + [_I] * 6 + [_F] + [_I] * 5 + [_P],
    # own, peer, scale, bias, residual, out, M, N, rank, stream
    "tp_allreduce_launch": [_P] * 6 + [_I] * 3 + [_P],
    # device, peer
    "tp_enable_peer_access": [_I] * 2,
    # w4, kvq, fp16, n-tiles, cluster, smem, resident clusters (out)
    "decode_step_occupancy": [_I] * 6 + [_IP],
    # layers, x_in, xs, xslots, qkv, att, xb, h, ck, cv, kvs, kv_valid, anc,
    # bar, trace, L, M, D, H, F, S, pos, group, scale, half_d, half_f, fp16
    # (x, the bf16-cache variant's cache, biases and LayerNorm vectors in
    # fp16), the launch plan (ops/decode_step.py::StepPlan: cluster, blocks,
    # slots, split_d, span_d, split_f, span_f, heads, chunks, stages, smem),
    # stream
    "decode_step_launch": [_P] * 3 + [_I] + [_P] * 11 + [_I] * 8 + [_F] + [_I] * 14 + [_P],
    # fp16, n-tiles, cluster, smem, resident clusters (out)
    "decode_step_tp_occupancy": [_I] * 4 + [_IP],
    # layers, x_in, xs, xslots, qkv, att, xb, h, ck0, cv0, ck1, cv1, kv_valid,
    # anc, bar, trace, L, M, D, H, F, S, pos, group, scale, fp16, the launch
    # plan (ops/decode_step.py::step_tp_plan: a StepPlan), stream
    "decode_step_tp_launch": [_P] * 3 + [_I] + [_P] * 12 + [_I] * 8 + [_F] + [_I] * 12 + [_P],
    # cluster, smem, resident clusters (out)
    "step_barrier_occupancy": [_I, _I, _IP],
    # bar, barriers, blocks, cluster, smem, cooperative, stream
    "step_barrier_launch": [_P] + [_I] * 5 + [_P],
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
    nvcc = _nvcc()
    tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))
    srcs = [src for src in _sources() if src.suffix == ".cu"]
    objs = [tmp_dir / (src.stem + ".o") for src in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [(obj.stem, proc.returncode) for obj, proc in zip(objs, procs) if proc.returncode]
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_dir / lib.name),
                               *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode:
            failed.append(("link", link.returncode))
    (out_dir / "build.log").write_text("".join(logs))
    if failed:
        shutil.rmtree(tmp_dir)
        raise RuntimeError(f"nvcc failed {failed}:\n" + "".join(logs))
    os.replace(tmp_dir / lib.name, lib)
    shutil.rmtree(tmp_dir)
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


def refuse_grad(name: str, *inputs) -> None:
    """Raise while autograd records (`torch.is_grad_enabled()`) and one of
    ``inputs`` (tensors, or dict / list / tuple trees of them) requires a
    gradient. The kernels have no backward: each writes a fresh buffer
    through ctypes, so its output has no ``grad_fn``, and a loss through it
    would give everything before the kernel no gradient without a word. Each
    wrapper calls this before it picks its CPU or CUDA route, so the plain
    twins refuse too; the training step takes the differentiable plain
    paths by choice (the DiT's dense tier)."""
    if not torch.is_grad_enabled():
        return
    todo = list(inputs)
    while todo:
        t = todo.pop()
        if isinstance(t, torch.Tensor):
            if t.requires_grad:
                raise RuntimeError(f"{name}: a hand-written kernel has no backward, and an "
                                   "input requires a gradient; call it under "
                                   "torch.no_grad() or detach the input")
        elif isinstance(t, dict):
            todo.extend(t.values())
        elif isinstance(t, (list, tuple)):
            todo.extend(t)


def stream_ptr(t) -> int:
    """The raw cudaStream_t of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
