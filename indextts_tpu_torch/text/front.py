"""Text front-end: normalization, BPE tokenization, segment splitting (a copy
of the JAX package's `indextts_tpu/text/front.py`, so that the port imports
nothing of that package).

Behavioral reference: the upstream `indextts/utils/front.py` (718 LoC) +
`utils/common.py` (CJK pre-tokenization). Host-side pure Python — this is the
one part of the pipeline that correctly stays off-device.

Pieces:
- ``TextNormalizer``: zh/en normalization with protection passes for pinyin
  tone annotations, CJK names with interpuncts, hyphenated tech terms, and a
  user glossary. The heavy zh/en text normalizers (WeTextProcessing / wetext)
  are optional: when absent we fall back to a built-in lightweight English
  number/symbol normalizer and pass-through Chinese (the protection and
  char-replacement passes still run, so tokenization stays stable).
- ``TextTokenizer``: sentencepiece BPE with CJK-char pre-tokenization and the
  reference's punctuation-aware segment splitter with greedy re-merge and
  ``quick_streaming_tokens`` early-emit.
"""

from __future__ import annotations

import os
import re
import warnings
from functools import lru_cache
from typing import Dict, List, Optional, Union

from indextts_tpu_torch.text.spm import load_sentencepiece

# ---------------------------------------------------------------------------
# CJK pre-tokenization (reference `utils/common.py:29-60`)
# ---------------------------------------------------------------------------

_CJK_RANGE = (
    r"([ᄀ-ᇿ⺀-꓏ꡀ-힯豈-﫿︰-﹏"
    r"･-ￜ\U00020000-\U0002FFFF])"
)


def tokenize_by_cjk_char(line: str, do_upper_case: bool = True) -> str:
    chars = re.split(_CJK_RANGE, line.strip())
    out = [w.strip().upper() if do_upper_case else w.strip() for w in chars if w.strip()]
    return " ".join(out)


def de_tokenize_by_cjk_char(line: str, do_lower_case: bool = False) -> str:
    """Inverse of tokenize_by_cjk_char: glue CJK chars back together while
    keeping latin word spans intact (reference `utils/common.py:55-82`; we fix
    its placeholder-restoration bug — single-placeholder words were left
    unrestored there)."""
    english_word_pattern = re.compile(r"([A-Z]+(?:[\s'-][A-Z-]+)*)", re.IGNORECASE)
    english_sents = english_word_pattern.findall(line)
    for i, sent in enumerate(english_sents):
        line = line.replace(sent, f"<sent_{i}>")
    words = line.split()
    placeholder = re.compile(r"<sent_(\d+)>")
    out = []
    for w in words:
        def restore(m):
            s = english_sents[int(m.group(1))]
            return s.lower() if do_lower_case else s

        out.append(placeholder.sub(restore, w))
    return "".join(out)


# ---------------------------------------------------------------------------
# normalizer (reference `front.py:16-397`)
# ---------------------------------------------------------------------------

class TextNormalizer:
    CHAR_REP_MAP = {
        "：": ",", "；": ",", ";": ",", "，": ",", "。": ".", "！": "!",
        "？": "?", "\n": " ", "·": "-", "、": ",", "...": "…", ",,,": "…",
        "，，，": "…", "……": "…", "“": "'", "”": "'", '"': "'", "‘": "'",
        "’": "'", "（": "'", "）": "'", "(": "'", ")": "'", "《": "'",
        "》": "'", "【": "'", "】": "'", "[": "'", "]": "'", "—": "-",
        "～": "-", "~": "-", "「": "'", "」": "'", ":": ",",
    }

    PINYIN_TONE_PATTERN = (
        r"(?<![a-z])((?:[bpmfdtnlgkhjqxzcsryw]|[zcs]h)?"
        r"(?:[aeiouüv]|[ae]i|u[aio]|ao|ou|i[aue]|[uüv]e|[uvü]ang?|uai|"
        r"[aeiuv]n|[aeio]ng|ia[no]|i[ao]ng)|ng|er)([1-5])"
    )
    NAME_PATTERN = r"[一-鿿]+(?:[-·—][一-鿿]+){1,2}"
    TECH_TERM_PATTERN = r"[A-Za-z][A-Za-z0-9]*(?:-[A-Za-z0-9]+)+"
    ENGLISH_CONTRACTION_PATTERN = r"(what|where|who|which|how|t?here|it|s?he|that|this)'s"

    def __init__(self, enable_glossary: bool = False):
        self.zh_normalizer = None
        self.en_normalizer = None
        self.enable_glossary = enable_glossary
        self.term_glossary: Dict[str, Union[str, dict]] = {}
        self.zh_char_rep_map = {"$": ".", **self.CHAR_REP_MAP}

    # -- loading -------------------------------------------------------------
    def load(self):
        """The reference loads the pynini-backed WeTextProcessing
        normalizers here (`indextts/utils/front.py:115-138`); this build
        ships its own pure-Python ports (`normalize_zh.py`, `normalize_en.py`)
        with the same `.normalize()` surface — no native FST dependency."""
        if self.zh_normalizer is not None and self.en_normalizer is not None:
            return
        from indextts_tpu_torch.text.normalize_en import EnNormalizer
        from indextts_tpu_torch.text.normalize_zh import ZhNormalizer

        self.zh_normalizer = ZhNormalizer()
        self.en_normalizer = EnNormalizer()

    # -- language routing ----------------------------------------------------
    @staticmethod
    def _is_email(s: str) -> bool:
        return re.match(r"^[a-zA-Z0-9]+@[a-zA-Z0-9]+\.[a-zA-Z]+$", s) is not None

    def use_chinese(self, s: str) -> bool:
        has_chinese = bool(re.search(r"[一-鿿]", s))
        has_alpha = bool(re.search(r"[a-zA-Z]", s))
        if has_chinese or not has_alpha or self._is_email(s):
            return True
        return bool(re.search(self.PINYIN_TONE_PATTERN, s, re.IGNORECASE))

    # -- protection passes ----------------------------------------------------
    def _save_matches(self, text: str, pattern: str, placeholder: str):
        found = re.findall(pattern, text, re.IGNORECASE)
        if not found:
            return text, None
        items = list(dict.fromkeys("".join(f) if isinstance(f, tuple) else f
                                   for f in found))
        for i, item in enumerate(items):
            text = text.replace(item, placeholder.format(chr(ord("a") + i)))
        return text, items

    @staticmethod
    def _restore_matches(text: str, items, placeholder: str, transform=None):
        if not items:
            return text
        for i, item in enumerate(items):
            if transform:
                item = transform(item)
            text = text.replace(placeholder.format(chr(ord("a") + i)), item)
        return text

    def correct_pinyin(self, pinyin: str) -> str:
        """jqx + u/ü finals -> v (reference `front.py:185-196`)."""
        if pinyin[0] not in "jqxJQX":
            return pinyin
        pinyin = re.sub(r"([jqx])[uü](n|e|an)*(\d)", r"\g<1>v\g<2>\g<3>",
                        pinyin, flags=re.IGNORECASE)
        return pinyin.upper()

    def _save_tech_terms(self, text: str):
        found = sorted(set(re.findall(self.TECH_TERM_PATTERN, text)), key=len,
                       reverse=True)
        if not found:
            return text, None
        for term in found:
            text = text.replace(term, term.replace("-", "<H>"))
        return text, found

    @staticmethod
    def _restore_tech_terms(text: str, items):
        if not items:
            return text
        return re.sub(r"\s*<H>\s*", "-", text)

    # -- glossary -------------------------------------------------------------
    def apply_glossary_terms(self, text: str, lang: str = "zh") -> str:
        if not self.term_glossary:
            return text

        @lru_cache(maxsize=42)
        def term_pattern(term):
            return re.compile(re.escape(term), re.IGNORECASE)

        for term in sorted(self.term_glossary, key=len, reverse=True):
            val = self.term_glossary[term]
            repl = val.get(lang, term) if isinstance(val, dict) else val
            text = term_pattern(term).sub(repl, text)
        return text

    def load_glossary(self, glossary: dict):
        if glossary and isinstance(glossary, dict):
            self.term_glossary.update(glossary)

    def load_glossary_from_yaml(self, path: str) -> bool:
        if path and os.path.exists(path):
            import yaml

            with open(path, "r", encoding="utf-8") as f:
                g = yaml.safe_load(f)
            if g and isinstance(g, dict):
                self.term_glossary = g
                return True
        return False

    def save_glossary_to_yaml(self, path: str):
        import yaml

        with open(path, "w", encoding="utf-8") as f:
            yaml.dump(self.term_glossary, f, allow_unicode=True,
                      default_flow_style=False)

    # -- main entry ------------------------------------------------------------
    def normalize(self, text: str) -> str:
        if self.zh_normalizer is None or self.en_normalizer is None:
            self.load()
        text = re.sub(self.ENGLISH_CONTRACTION_PATTERN, r"\1 is", text,
                      flags=re.IGNORECASE)
        if self.use_chinese(text):
            if self.enable_glossary:
                text = self.apply_glossary_terms(text, lang="zh")
            text, tech = self._save_tech_terms(text.rstrip())
            text, pinyins = self._save_matches(text, self.PINYIN_TONE_PATTERN,
                                               "<pinyin_{}>")
            text, names = self._save_matches(text, self.NAME_PATTERN, "<n_{}>")
            try:
                result = self.zh_normalizer.normalize(text)
            except Exception:
                result = text
            result = self._restore_matches(result, names, "<n_{}>")
            result = self._restore_matches(result, pinyins, "<pinyin_{}>",
                                           transform=self.correct_pinyin)
            result = self._restore_tech_terms(result, tech)
            rep = self.zh_char_rep_map
        else:
            if self.enable_glossary:
                text = self.apply_glossary_terms(text, lang="en")
            text, tech = self._save_tech_terms(text)
            try:
                result = self.en_normalizer.normalize(text)
            except Exception:
                result = text
            result = self._restore_tech_terms(result, tech)
            rep = self.CHAR_REP_MAP
        pattern = re.compile("|".join(re.escape(p) for p in rep))
        return pattern.sub(lambda m: rep[m.group()], result)


# ---------------------------------------------------------------------------
# tokenizer + segmenter (reference `front.py:399-604`)
# ---------------------------------------------------------------------------

class TextTokenizer:
    PUNCTUATION_MARKS_TOKENS = [".", "!", "?", "▁.", "▁?", "▁..."]

    def __init__(self, vocab_file: str, normalizer: Optional[TextNormalizer] = None):
        if vocab_file is None:
            raise ValueError("vocab_file is None")
        if not os.path.exists(vocab_file):
            raise ValueError(f"vocab_file {vocab_file} does not exist")
        self.vocab_file = vocab_file
        self.normalizer = normalizer
        if self.normalizer:
            self.normalizer.load()
        self.sp_model = load_sentencepiece(vocab_file)
        self.pre_tokenizers = [tokenize_by_cjk_char]

    # -- vocab surface ---------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return self.sp_model.GetPieceSize()

    unk_token = "<unk>"
    pad_token = None
    bos_token = "<s>"
    eos_token = "</s>"
    pad_token_id = -1
    bos_token_id = 0
    eos_token_id = 1

    @property
    def unk_token_id(self) -> int:
        return self.sp_model.unk_id()

    def get_vocab(self):
        return {self.convert_ids_to_tokens(i): i for i in range(self.vocab_size)}

    def convert_ids_to_tokens(self, ids):
        return self.sp_model.IdToPiece(ids)

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        if isinstance(tokens, str):
            tokens = [tokens]
        return [self.sp_model.PieceToId(t) for t in tokens]

    # -- encode/decode ----------------------------------------------------------
    def tokenize(self, text: str) -> List[str]:
        return self.encode(text, out_type=str)

    def encode(self, text: str, **kwargs):
        if len(text) == 0:
            return []
        out_type = kwargs.pop("out_type", int)
        if len(text.strip()) == 1:
            return self.sp_model.Encode(text, out_type=out_type, **kwargs)
        if self.normalizer:
            text = self.normalizer.normalize(text)
        for pre in self.pre_tokenizers:
            text = pre(text)
        return self.sp_model.Encode(text, out_type=out_type, **kwargs)

    def batch_encode(self, texts: List[str], **kwargs):
        if self.normalizer:
            texts = [self.normalizer.normalize(t) for t in texts]
        for pre in self.pre_tokenizers:
            texts = [pre(t) for t in texts]
        return self.sp_model.Encode(texts, out_type=kwargs.pop("out_type", int), **kwargs)

    def decode(self, ids, do_lower_case: bool = False, **kwargs):
        if isinstance(ids, int):
            ids = [ids]
        decoded = self.sp_model.Decode(ids, out_type=kwargs.pop("out_type", str), **kwargs)
        return de_tokenize_by_cjk_char(decoded, do_lower_case=do_lower_case)

    # -- segmentation ------------------------------------------------------------
    @staticmethod
    def split_segments_by_token(tokens: List[str], split_tokens: List[str],
                                max_tokens: int,
                                quick_streaming_tokens: int = 0) -> List[List[str]]:
        """Punctuation-aware splitting with comma/hyphen/length fallbacks and a
        greedy re-merge pass (reference `front.py:512-604`)."""
        if not tokens:
            return []
        segments: List[List[str]] = []
        current: List[str] = []
        i = 0
        while i < len(tokens):
            tok = tokens[i]
            current.append(tok)
            split_now = None
            if (not ("," in split_tokens or "▁," in split_tokens)
                    and ("," in current or "▁," in current)):
                split_now = TextTokenizer.split_segments_by_token(
                    current, [",", "▁,"], max_tokens, quick_streaming_tokens)
            elif "-" not in split_tokens and "-" in current:
                split_now = TextTokenizer.split_segments_by_token(
                    current, ["-"], max_tokens, quick_streaming_tokens)
            elif len(current) <= max_tokens:
                if tok in split_tokens and len(current) > 2:
                    # keep a following apostrophe attached. NOTE: faithful to
                    # the reference, which appends tokens[i+1] but does NOT
                    # skip it (its `i += 1` inside a for-loop is a no-op,
                    # front.py:549-553), so the apostrophe token repeats at
                    # the start of the next segment.
                    if i < len(tokens) - 1 and tokens[i + 1] in ("'", "▁'"):
                        current.append(tokens[i + 1])
                    segments.append(current)
                    current = []
                i += 1
                continue
            else:
                split_now = [current[j: j + max_tokens]
                             for j in range(0, len(current), max_tokens)]
                warnings.warn(
                    f"The tokens length of segment exceeds limit: {max_tokens}, "
                    f"Tokens in segment: {current}. Maybe unexpected behavior",
                    RuntimeWarning)
            segments.extend(split_now)
            current = []
            i += 1
        if current:
            segments.append(current)

        # greedy merge under max_tokens; quick_streaming_tokens keeps the first
        # emitted segments short for low first-audio latency
        merged: List[List[str]] = []
        total = 0
        for seg in segments:
            total += len(seg)
            if not seg:
                continue
            if not merged:
                merged.append(seg)
            elif (len(merged[-1]) + len(seg) <= max_tokens
                  and total > quick_streaming_tokens):
                merged[-1] = merged[-1] + seg
            elif len(merged[-1]) + len(seg) <= max_tokens / 2:
                merged[-1] = merged[-1] + seg
            else:
                merged.append(seg)
        return merged

    def split_segments(self, tokenized: List[str],
                       max_text_tokens_per_segment: int = 120,
                       quick_streaming_tokens: int = 0) -> List[List[str]]:
        return self.split_segments_by_token(
            tokenized, self.PUNCTUATION_MARKS_TOKENS,
            max_tokens=max_text_tokens_per_segment,
            quick_streaming_tokens=quick_streaming_tokens)
