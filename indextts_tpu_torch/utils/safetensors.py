"""Read the safetensors format with the standard library and torch (the
`safetensors` package is not needed).

Layout: an 8-byte little-endian header length N, N bytes of JSON (utf-8)
mapping each tensor name to ``{"dtype", "shape", "data_offsets": [begin,
end]}`` plus an optional ``"__metadata__"`` map of strings, then the raw
little-endian data; the offsets count from the first byte after the header.
As the format's own loader does, the tensors must tile the data exactly:
sorted by their offsets, each begins where the one before ended, spans its
shape's bytes, and the last ends at the end of the file.

The file is mapped (`mmap`, copy-on-write), so a tensor read from it is a
view of the page cache, not a second copy of the file: a 2.3 GB checkpoint
costs its pages once. BF16 and the float8 types go through
`torch.frombuffer`, which numpy cannot represent.
"""

from __future__ import annotations

import json
import mmap
import struct
import sys
from typing import Dict, Tuple

import torch

DTYPES: Dict[str, torch.dtype] = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool, "U16": torch.uint16,
    "U32": torch.uint32, "U64": torch.uint64, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
# a header larger than this is refused as the format's loader refuses it
MAX_HEADER_BYTES = 100_000_000


def _read_header(buf, size: int, path: str) -> Tuple[dict, dict, int]:
    if size < 8:
        raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
    (n,) = struct.unpack("<Q", buf[:8])
    if n > MAX_HEADER_BYTES or 8 + n > size:
        raise ValueError(f"{path}: header length {n} runs past the end of the {size}-byte file")
    try:
        header = json.loads(bytes(buf[8:8 + n]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: the header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    meta = header.pop("__metadata__", None) or {}
    if not isinstance(meta, dict) or not all(isinstance(v, str) for v in meta.values()):
        raise ValueError(f"{path}: __metadata__ must map names to strings")
    return header, meta, 8 + n


def _check(header: dict, data_bytes: int, path: str) -> None:
    """Every dtype known, every span its shape's size, the spans tiling the
    data from its first byte to the end of the file."""
    spans = []
    for name, info in header.items():
        try:
            dtype, shape, (begin, end) = info["dtype"], info["shape"], info["data_offsets"]
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"{path}: tensor {name!r} has a malformed entry {info!r}") from None
        if dtype not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has an unknown dtype {dtype!r}")
        if not all(isinstance(d, int) and d >= 0 for d in shape):
            raise ValueError(f"{path}: tensor {name!r} has a bad shape {shape!r}")
        numel = 1
        for d in shape:
            numel *= d
        nbytes = numel * torch.empty((), dtype=DTYPES[dtype]).element_size()
        if not (isinstance(begin, int) and isinstance(end, int)) or end - begin != nbytes:
            raise ValueError(f"{path}: tensor {name!r} spans [{begin}, {end}) for "
                             f"{nbytes} bytes of {dtype} {shape}")
        spans.append((begin, end, name))
    at = 0
    for begin, end, name in sorted(spans):
        if begin != at:
            raise ValueError(f"{path}: tensor {name!r} begins at {begin}, the data before it "
                             f"ends at {at} (overlapping or gapped offsets)")
        at = end
    if at != data_bytes:
        raise ValueError(f"{path}: the tensors end at {at}, the file holds {data_bytes} bytes "
                         "of data (truncated or padded file)")


def read_metadata(path: str) -> dict:
    """The ``__metadata__`` map of a safetensors file (empty when absent)."""
    with open(path, "rb") as f:
        head = f.read(8)
        size = f.seek(0, 2)
        f.seek(0)
        n = struct.unpack("<Q", head)[0] if len(head) == 8 else 0
        buf = f.read(8 + min(n, MAX_HEADER_BYTES))
    return _read_header(buf, size, path)[1]


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, in its stored dtype and shape, as
    CPU tensors over a copy-on-write map of the file. Raises ValueError on
    an unknown dtype, malformed or overlapping offsets, or a file shorter or
    longer than its header says."""
    if sys.byteorder != "little":
        raise ValueError("safetensors data is little-endian; this host is not")
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        if size == 0:
            raise ValueError(f"{path}: empty file")
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    header, _, start = _read_header(buf, size, path)
    _check(header, size - start, path)
    out = {}
    for name, info in header.items():
        dtype, shape = DTYPES[info["dtype"]], tuple(info["shape"])
        begin, end = info["data_offsets"]
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin, offset=start + begin)
        out[name] = t.view(dtype).reshape(shape)
    return out
