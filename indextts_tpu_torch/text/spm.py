"""SentencePiece model support without the sentencepiece binary wheel (a copy
of the JAX package's `indextts_tpu/text/spm.py` without its native merge loop,
so that the port imports nothing of that package).

The reference tokenizes with sentencepiece BPE (`checkpoints/bpe.model`,
`utils/front.py:411`). This environment may not ship the sentencepiece wheel,
so we provide:

- ``load_sentencepiece(path)``: uses the real `sentencepiece` package when
  importable, else falls back to ``PureSentencePiece`` — a minimal protobuf
  wire-format reader of the .model file plus a greedy score-based BPE encoder
  (equivalent to sentencepiece BPE inference: repeatedly merge the adjacent
  pair whose concatenation is an in-vocab piece with the highest score).

Both expose the same surface: Encode/Decode/IdToPiece/PieceToId/GetPieceSize/
unk_id, matching what TextTokenizer uses (`utils/front.py:399-510`).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple, Union

WHITESPACE = "▁"  # '▁'


# ---------------------------------------------------------------------------
# minimal protobuf wire parsing for ModelProto
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def parse_sentencepiece_model(path: str) -> List[Tuple[str, float, int]]:
    """Parse a sentencepiece .model -> [(piece, score, type)].

    ModelProto field 1 = repeated SentencePiece{1: piece, 2: score, 3: type}.
    type: 1=NORMAL, 2=UNKNOWN, 3=CONTROL, 4=USER_DEFINED, 6=BYTE.
    """
    with open(path, "rb") as f:
        buf = f.read()
    pieces = []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:
            piece, score, ptype = "", 0.0, 1
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8", errors="replace")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append((piece, score, ptype))
    return pieces


# ---------------------------------------------------------------------------
# pure-python BPE
# ---------------------------------------------------------------------------

class PureSentencePiece:
    """Greedy score-based BPE over a parsed sentencepiece vocabulary.

    The port keeps only the pure-Python merge loop (`_encode_word`), which
    defines the semantics that the JAX package's native C loop reproduces.
    """

    def __init__(self, pieces: List[Tuple[str, float, int]]):
        self.pieces = pieces
        self.piece_to_id: Dict[str, int] = {p: i for i, (p, _, _) in enumerate(pieces)}
        self.scores = {p: s for (p, s, _) in pieces}
        self._unk_id = next((i for i, (_, _, t) in enumerate(pieces) if t == 2), 0)
        self._byte_ids = {p: i for i, (p, _, t) in enumerate(pieces) if t == 6}

    @classmethod
    def from_file(cls, path: str) -> "PureSentencePiece":
        return cls(parse_sentencepiece_model(path))

    # -- sentencepiece-compatible surface -----------------------------------
    def GetPieceSize(self) -> int:
        return len(self.pieces)

    def unk_id(self) -> int:
        return self._unk_id

    def IdToPiece(self, ids):
        if isinstance(ids, int):
            return self.pieces[ids][0]
        return [self.pieces[i][0] for i in ids]

    def PieceToId(self, piece: str) -> int:
        return self.piece_to_id.get(piece, self._unk_id)

    def _encode_word(self, word: str) -> List[str]:
        """BPE-merge a single pre-tokenized word (already ▁-prefixed)."""
        symbols = list(word)
        if not symbols:
            return []
        while len(symbols) > 1:
            best, best_score = -1, None
            for i in range(len(symbols) - 1):
                merged = symbols[i] + symbols[i + 1]
                s = self.scores.get(merged)
                if s is not None and (best_score is None or s > best_score):
                    best, best_score = i, s
            if best < 0:
                break
            symbols[best:best + 2] = [symbols[best] + symbols[best + 1]]
        # resolve leftovers: known pieces, byte fallback, or unk
        out = []
        for s in symbols:
            if s in self.piece_to_id:
                out.append(s)
            else:
                for byte in s.encode("utf-8"):
                    bp = f"<0x{byte:02X}>"
                    out.append(bp if bp in self.piece_to_id else "<unk>")
        return out

    def Encode(self, text: Union[str, List[str]], out_type=int, **kwargs):
        if isinstance(text, list):
            return [self.Encode(t, out_type=out_type) for t in text]
        # sentencepiece default normalization: treat whitespace as ▁,
        # prepend ▁ to the text start (add_dummy_prefix)
        text = text.strip()
        if not text:
            return []
        parts = text.split()
        tokens: List[str] = []
        for w in parts:
            tokens.extend(self._encode_word(WHITESPACE + w))
        if out_type is str:
            return tokens
        return [self.PieceToId(t) for t in tokens]

    def Decode(self, ids, out_type=str, **kwargs):
        if ids and isinstance(ids[0], list):
            return [self.Decode(i) for i in ids]
        toks = [self.pieces[i][0] for i in ids]
        text = "".join(toks).replace(WHITESPACE, " ").strip()
        return text


def load_sentencepiece(path: str):
    """Real sentencepiece if available, pure-python fallback otherwise."""
    try:
        from sentencepiece import SentencePieceProcessor  # type: ignore

        return SentencePieceProcessor(model_file=path)
    except ImportError:
        return PureSentencePiece.from_file(path)


def build_model_file(pieces: List[Tuple[str, float, int]], path: str) -> None:
    """Serialize [(piece, score, type)] into a sentencepiece-compatible .model
    (used by tests and by the fake-checkpoint tooling)."""

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b | 0x80])
            else:
                out += bytes([b])
                return out

    blob = b""
    for piece, score, ptype in pieces:
        pb = piece.encode("utf-8")
        inner = (bytes([0x0A]) + varint(len(pb)) + pb
                 + bytes([0x15]) + struct.pack("<f", score)
                 + bytes([0x18]) + varint(ptype))
        blob += bytes([0x0A]) + varint(len(inner)) + inner
    with open(path, "wb") as f:
        f.write(blob)
