"""The Qwen2 / Qwen3 byte-level BPE tokenizer in the standard library (the
port's counterpart of the Hugging Face tokenizer that the JAX package's
`pipeline/emotion.py::QwenEmotion` loads with `AutoTokenizer`; the card's
machine has neither `transformers`, `tokenizers` nor `regex`).

`load_qwen_tokenizer(model_dir)` reads ``tokenizer.json`` (``model.vocab``,
``model.merges`` in the ``"a b"`` or the ``["a", "b"]`` form, and
``added_tokens``), or else ``vocab.json`` + ``merges.txt`` with the added
tokens of ``tokenizer_config.json``'s ``added_tokens_decoder``. It
implements one pipeline, Qwen's, and files that ask for another
(normalizer, split pattern, BPE options, decoder, added-token options,
``clean_up_tokenization_spaces``) are refused:

- encode: the added tokens are split out of the raw text first (the
  longest at the leftmost place, as the library's matcher does); every
  other span is NFC-normalized, split by `pre_tokenize` (the Qwen split
  pattern `QWEN_SPLIT_PATTERN`, hand-written over `unicodedata`
  categories), mapped through the GPT-2 byte <-> unicode table, and merged
  by BPE rank (the library's merge order, with a per-word cache);
- decode: the tokens' bytes joined and decoded as UTF-8 with
  ``errors="replace"``; ``skip_special_tokens`` drops the added tokens
  marked special;
- `QwenTokenizer.apply_chat_template` renders the one message shape that
  `QwenEmotion` sends (a system and a user message, ``add_generation_prompt
  =True``, ``enable_thinking=False``) as the published Qwen3 template does;
  any other shape raises. The released model directory is not in the
  repository: a check of this rendering against its ``chat_template`` waits
  for those files.

`build_tokenizer_json` writes synthetic files in the same format (byte
alphabet, merges learned from a corpus and then generated, the Qwen3 added
tokens at their ids) for the tests and for random-weight model directories.
"""

from __future__ import annotations

import heapq
import json
import os
import re
import unicodedata
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

# the Qwen2 / Qwen3 pre-tokenizer split (tokenizer.json's Split pattern)
QWEN_SPLIT_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
                      r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

# the Qwen3 added tokens from id 151643 on, in id order, with their
# "special" flag (special ones are dropped by decode(skip_special_tokens))
QWEN3_ADDED_TOKENS = (
    ("<|endoftext|>", True), ("<|im_start|>", True), ("<|im_end|>", True),
    ("<|object_ref_start|>", True), ("<|object_ref_end|>", True), ("<|box_start|>", True),
    ("<|box_end|>", True), ("<|quad_start|>", True), ("<|quad_end|>", True),
    ("<|vision_start|>", True), ("<|vision_end|>", True), ("<|vision_pad|>", True),
    ("<|image_pad|>", True), ("<|video_pad|>", True), ("<tool_call>", False),
    ("</tool_call>", False), ("<|fim_prefix|>", False), ("<|fim_middle|>", False),
    ("<|fim_suffix|>", False), ("<|fim_pad|>", False), ("<|repo_name|>", False),
    ("<|file_sep|>", False), ("<tool_response>", False), ("</tool_response>", False),
    ("<think>", False), ("</think>", False))
QWEN3_FIRST_ADDED_ID = 151643

# \s: the Unicode White_Space property (what the library's regex engine
# takes for \s); str.isspace() also takes U+001C..U+001F
_SPACE = frozenset(map(chr, (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680,
                             *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F,
                             0x3000)))
# the contractions of the pattern's case-insensitive group, by the letters
# each of their characters matches under Unicode case folding
_FOLD = {"s": "sSſ", "t": "tT", "r": "rR", "e": "eE", "v": "vV", "m": "mM", "l": "lL",
         "d": "dD"}
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def _is_other(ch: str) -> bool:
    """[^\\s\\p{L}\\p{N}]"""
    return ch not in _SPACE and unicodedata.category(ch)[0] not in "LN"


def _match_at(t: str, i: int) -> int:
    """The end of `QWEN_SPLIT_PATTERN`'s match at ``t[i]``: its alternatives
    tried in order, each with the backtracking the regex engine would do."""
    n, c = len(t), t[i]
    if c == "'":                                   # (?i:'s|'t|'re|'ve|'m|'ll|'d)
        for tail in _CONTRACTIONS:
            e = i + 1 + len(tail)
            if e <= n and all(t[i + 1 + k] in _FOLD[ch] for k, ch in enumerate(tail)):
                return e
    start = -1                                     # [^\r\n\p{L}\p{N}]?\p{L}+
    if _is_letter(c):
        start = i
    elif c not in "\r\n" and not _is_number(c) and i + 1 < n and _is_letter(t[i + 1]):
        start = i + 1
    if start >= 0:
        e = start + 1
        while e < n and _is_letter(t[e]):
            e += 1
        return e
    if _is_number(c):                              # \p{N}
        return i + 1
    j = i + 1 if c == " " and i + 1 < n and _is_other(t[i + 1]) else i
    if _is_other(t[j]):                            # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
        e = j + 1
        while e < n and _is_other(t[e]):
            e += 1
        while e < n and t[e] in "\r\n":
            e += 1
        return e
    # c is whitespace here: every other character matched above
    j = i
    while j < n and t[j] in _SPACE:
        j += 1
    for k in range(j - 1, i - 1, -1):              # \s*[\r\n]+
        if t[k] in "\r\n":
            return k + 1
    if j == n:                                     # \s+(?!\S)
        return n
    return j - 1 if j - i >= 2 else j              # \s+(?!\S), else \s+


def pre_tokenize(text: str) -> List[str]:
    """``text`` split as the ``Split(QWEN_SPLIT_PATTERN, "isolated")``
    pre-tokenizer splits it: the pattern's matches, left to right (every
    character starts one, so there is no gap between them)."""
    out, i = [], 0
    while i < len(text):
        e = _match_at(text, i)
        out.append(text[i:e])
        i = e
    return out


def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte -> printable character table of the byte-level BPE."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


BYTE_ENCODER = bytes_to_unicode()
BYTE_DECODER = {c: b for b, c in BYTE_ENCODER.items()}


class QwenTokenizer:
    """Byte-level BPE over the Qwen split, with added tokens (see the module
    docstring). ``vocab`` maps the BPE tokens (byte-level strings) to ids,
    ``merges`` lists the merge pairs by rank, ``added`` holds (content, id,
    special) for each added token."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 added: Sequence[Tuple[str, int, bool]] = ()):
        self.vocab = dict(vocab)
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, (a, b) in enumerate(merges):
            try:
                pair, new = (self.vocab[a], self.vocab[b]), self.vocab[a + b]
            except KeyError as e:
                raise ValueError(f"merge {rank} ({a!r} {b!r}) uses a token outside the vocab: "
                                 f"{e}") from None
            self.merges.setdefault(pair, (rank, new))
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.added_ids = {content: i for content, i, _ in added}
        self.id_to_token.update({i: content for content, i, _ in added})
        self.special_ids = {i for _, i, special in added if special}
        # the longest first: an alternation then finds the longest token at
        # the leftmost place, as the library's leftmost-longest matcher
        contents = sorted(self.added_ids, key=len, reverse=True)
        self._added = re.compile("|".join(map(re.escape, contents))) if contents else None
        self._cache: Dict[str, List[int]] = {}

    def _split(self, text: str) -> List[Tuple[str, bool]]:
        """(span, is an added token) pieces of ``text``, in order."""
        if self._added is None:
            return [(text, False)] if text else []
        out, i = [], 0
        for m in self._added.finditer(text):
            if m.start() > i:
                out.append((text[i:m.start()], False))
            out.append((m.group(), True))
            i = m.end()
        if i < len(text):
            out.append((text[i:], False))
        return out

    def _bpe(self, word: str) -> List[int]:
        """One pre-tokenized word (byte-level characters) -> ids, merging
        the lowest-ranked adjacent pair first (the leftmost among equals),
        as the library's `Word::merge_all` does."""
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        c = [self.vocab[ch] for ch in word if ch in self.vocab]
        n = len(c)
        prv, nxt, alive = list(range(-1, n - 1)), list(range(1, n + 1)), [True] * n
        if n:
            nxt[-1] = -1
        heap = []
        for i in range(n - 1):
            m = self.merges.get((c[i], c[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, i, new = heapq.heappop(heap)
            if not alive[i] or nxt[i] == -1:
                continue
            j = nxt[i]
            m = self.merges.get((c[i], c[j]))
            if m is None or m[1] != new:               # an expired entry
                continue
            c[i], alive[j] = new, False
            nxt[i] = nxt[j]
            if nxt[j] != -1:
                prv[nxt[j]] = i
            if prv[i] != -1:
                m = self.merges.get((c[prv[i]], c[i]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[i], m[1]))
            if nxt[i] != -1:
                m = self.merges.get((c[i], c[nxt[i]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], i, m[1]))
        ids = [c[i] for i in range(n) if alive[i]]
        self._cache[word] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        """``text`` -> ids (no special token is added around it: Qwen's
        tokenizer adds none)."""
        ids: List[int] = []
        for span, is_added in self._split(text):
            if is_added:
                ids.append(self.added_ids[span])
                continue
            for word in pre_tokenize(unicodedata.normalize("NFC", span)):
                ids.extend(self._bpe("".join(BYTE_ENCODER[b] for b in word.encode())))
        return ids

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False) -> str:
        """ids -> text: unknown ids are dropped, the tokens' bytes joined and
        decoded as UTF-8 with ``errors="replace"`` (a token that is not all
        byte-level characters, as an added token may be, gives its own UTF-8
        bytes)."""
        buf = bytearray()
        for i in map(int, ids):
            tok = self.id_to_token.get(i)
            if tok is None or (skip_special_tokens and i in self.special_ids):
                continue
            try:
                buf += bytes(BYTE_DECODER[ch] for ch in tok)
            except KeyError:
                buf += tok.encode()
        return buf.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: Sequence[dict], tokenize: bool = False,
                            add_generation_prompt: bool = False,
                            enable_thinking: bool = True) -> str:
        """The published Qwen3 chat template for the one shape `QwenEmotion`
        sends: ``[{"role": "system", ...}, {"role": "user", ...}]`` with
        ``add_generation_prompt=True`` and ``enable_thinking=False``, rendered
        as ``<|im_start|>system\\n{sys}<|im_end|>\\n<|im_start|>user\\n{user}
        <|im_end|>\\n<|im_start|>assistant\\n<think>\\n\\n</think>\\n\\n``.
        Any other shape raises NotImplementedError."""
        roles = [m.get("role") for m in messages]
        if (roles != ["system", "user"] or tokenize or not add_generation_prompt
                or enable_thinking
                or not all(isinstance(m.get("content"), str) for m in messages)):
            raise NotImplementedError(
                f"apply_chat_template renders a system + user message with tokenize=False, "
                f"add_generation_prompt=True and enable_thinking=False only; got roles={roles}, "
                f"tokenize={tokenize}, add_generation_prompt={add_generation_prompt}, "
                f"enable_thinking={enable_thinking}")
        system, user = (m["content"] for m in messages)
        return (f"<|im_start|>system\n{system}<|im_end|>\n<|im_start|>user\n{user}<|im_end|>\n"
                f"<|im_start|>assistant\n<think>\n\n</think>\n\n")


def _check(what: str, got, want) -> None:
    if got != want:
        raise ValueError(f"tokenizer.json: {what} is {got!r}; this tokenizer implements "
                         f"{want!r} only (Qwen2 / Qwen3)")


def _check_pipeline(tj: dict) -> None:
    """Refuse a tokenizer.json whose pipeline is not the one implemented."""
    norm = tj.get("normalizer")
    if norm is not None and norm.get("type") == "Sequence" and len(norm["normalizers"]) == 1:
        norm = norm["normalizers"][0]
    _check("the normalizer", norm, {"type": "NFC"})
    pre = tj.get("pre_tokenizer") or {}
    steps = pre.get("pretokenizers", []) if pre.get("type") == "Sequence" else [pre]
    _check("the pre-tokenizer sequence", [s.get("type") for s in steps], ["Split", "ByteLevel"])
    split, byte = steps
    _check("the split pattern", split.get("pattern"), {"Regex": QWEN_SPLIT_PATTERN})
    _check("the split behaviour", (split.get("behavior"), split.get("invert")),
           ("Isolated", False))
    _check("the byte-level pre-tokenizer's add_prefix_space / use_regex",
           (byte.get("add_prefix_space"), byte.get("use_regex")), (False, False))
    _check("the decoder", (tj.get("decoder") or {}).get("type"), "ByteLevel")
    model = tj.get("model") or {}
    _check("the model", model.get("type"), "BPE")
    _check("the BPE options (dropout, unk_token, continuing_subword_prefix, "
           "end_of_word_suffix, byte_fallback, ignore_merges)",
           (model.get("dropout"), model.get("unk_token"),
            model.get("continuing_subword_prefix") or "", model.get("end_of_word_suffix") or "",
            bool(model.get("byte_fallback")), bool(model.get("ignore_merges"))),
           (None, None, "", "", False, False))


def _added_entry(content: str, i: int, d: dict) -> Tuple[str, int, bool]:
    if d.get("lstrip") or d.get("rstrip") or d.get("single_word") or d.get("normalized"):
        raise ValueError(f"added token {content!r}: lstrip / rstrip / single_word / normalized "
                         f"are not implemented (Qwen's added tokens set none of them)")
    return content, int(i), bool(d.get("special", False))


def load_qwen_tokenizer(model_dir: str) -> QwenTokenizer:
    """The tokenizer of a Qwen model directory: ``tokenizer.json``, else
    ``vocab.json`` + ``merges.txt`` (the added tokens then from
    ``tokenizer_config.json``'s ``added_tokens_decoder``). A
    ``tokenizer_config.json`` that asks for ``clean_up_tokenization_spaces``
    is refused (Qwen's does not)."""
    def path(name):
        return os.path.join(model_dir, name)

    config = {}
    if os.path.exists(path("tokenizer_config.json")):
        with open(path("tokenizer_config.json"), encoding="utf-8") as f:
            config = json.load(f)
    if config.get("clean_up_tokenization_spaces"):
        raise ValueError(f"{path('tokenizer_config.json')}: clean_up_tokenization_spaces is not "
                         f"implemented (Qwen's tokenizer does not set it)")
    if os.path.exists(path("tokenizer.json")):
        with open(path("tokenizer.json"), encoding="utf-8") as f:
            tj = json.load(f)
        _check_pipeline(tj)
        model = tj["model"]
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        added = [_added_entry(t["content"], t["id"], t) for t in tj.get("added_tokens", [])]
        return QwenTokenizer(model["vocab"], merges, added)
    if os.path.exists(path("vocab.json")) and os.path.exists(path("merges.txt")):
        with open(path("vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(path("merges.txt"), encoding="utf-8") as f:
            merges = [tuple(line.rstrip("\r\n").split(" ", 1)) for line in f
                      if line.strip() and not line.startswith("#version")]
        added = [_added_entry(d["content"], i, d)
                 for i, d in config.get("added_tokens_decoder", {}).items()]
        return QwenTokenizer(vocab, merges, added)
    raise FileNotFoundError(f"{model_dir}: no tokenizer.json, nor vocab.json + merges.txt")


def _learn_merges(corpus: str, n: int) -> List[Tuple[str, str]]:
    """Up to ``n`` BPE merges learned from ``corpus`` (the most frequent
    adjacent pair of its pre-tokenized byte-level words, ties to the pair
    seen first; pairs seen once are not merged)."""
    words = Counter("".join(BYTE_ENCODER[b] for b in w.encode()) for w in pre_tokenize(corpus))
    splits = {w: list(w) for w in words}
    merges: List[Tuple[str, str]] = []
    while len(merges) < n:
        counts: Dict[Tuple[str, str], int] = {}
        for w, k in words.items():
            s = splits[w]
            for pair in zip(s, s[1:]):
                counts[pair] = counts.get(pair, 0) + k
        if not counts:
            break
        best = max(counts, key=counts.get)             # the first of the most frequent
        if counts[best] < 2:
            break
        merges.append(best)
        a, b = best
        for w in words:
            s, out, i = splits[w], [], 0
            while i < len(s):
                if i + 1 < len(s) and s[i] == a and s[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            splits[w] = out
    return merges


def build_tokenizer_json(corpus: str, vocab_size: int,
                         first_added_id: int = QWEN3_FIRST_ADDED_ID,
                         added_tokens: Sequence[Tuple[str, bool]] = QWEN3_ADDED_TOKENS,
                         learned_merges: int = 400) -> dict:
    """A synthetic Qwen ``tokenizer.json`` (as a dict) whose ids cover
    [0, vocab_size): the 256 byte symbols, merges learned from ``corpus``,
    then generated merges (a token and a byte symbol, in id order) filling
    the ids below ``first_added_id``; the ``added_tokens`` at
    ``first_added_id`` on; generated merges again above them. The added
    tokens also sit in ``model.vocab`` at their ids, so that the
    `tokenizers` library, which numbers the added tokens it does not find
    there from the vocab's size, gives them the same ids."""
    symbols = list(BYTE_ENCODER.values())
    vocab = {s: i for i, s in enumerate(symbols)}
    merges: List[Tuple[str, str]] = []
    tokens = list(symbols)
    for a, b in _learn_merges(corpus, min(learned_merges, first_added_id - len(vocab))):
        merges.append((a, b))
        vocab[a + b] = len(vocab)
        tokens.append(a + b)
    added_ids = range(first_added_id, first_added_id + len(added_tokens))
    for (content, _), i in zip(added_tokens, added_ids):
        vocab[content] = i
    next_id, ai = len(tokens), 0
    while next_id < vocab_size:
        if next_id in added_ids:
            next_id = added_ids.stop
            continue
        for b in symbols:
            if next_id >= vocab_size or next_id in added_ids:
                break
            if tokens[ai] + b not in vocab:
                merges.append((tokens[ai], b))
                vocab[tokens[ai] + b] = next_id
                tokens.append(tokens[ai] + b)
                next_id += 1
        else:
            ai += 1
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                  "use_regex": False}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": c, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": s}
                         for (c, s), i in zip(added_tokens, added_ids)],
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN_SPLIT_PATTERN}, "behavior": "Isolated",
             "invert": False}, byte_level]},
        "post_processor": byte_level,
        "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "", "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": False, "vocab": vocab,
                  "merges": [[a, b] for a, b in merges]},
    }
