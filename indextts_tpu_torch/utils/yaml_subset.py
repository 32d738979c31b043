"""A reader for the YAML subset that the IndexTTS ``config.yaml`` files use,
with PyYAML's ``safe_load`` results and no PyYAML.

The subset:

- block mappings and block sequences, nested by indentation (spaces only); a
  sequence may sit at its parent key's indentation, and ``- key: value``
  starts a mapping inside a sequence;
- flow sequences on one line, ``[a, 'b', [1, 2]]``;
- plain, single-quoted and double-quoted scalars on one line;
- ``#`` comments, blank lines, and ``~`` / ``null`` / an empty value as None.

Plain scalars resolve as PyYAML (YAML 1.1) resolves them, with its regular
expressions: ``yes`` / ``no`` / ``on`` / ``off`` are booleans, ``0x10`` and
``1_000`` ints, ``1.0e-5`` a float, while ``1e-5`` (no dot) and ``1.0e5`` (no
exponent sign) stay strings. Anything outside the subset raises
`YAMLSubsetError` naming its line: anchors, aliases, tags, flow mappings,
block and multi-line scalars, complex keys, directives and document markers,
timestamps, the merge key and tabs in indentation. Nothing is guessed.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py), verbatim
_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"""^(?: ~
                    |null|Null|NULL
                    | )$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# the first characters each resolver is tried for (resolver.py's lists)
_FIRST = {"bool": "yYnNtTfFoO", "float": "-+0123456789.", "int": "-+0123456789",
          "null": "~nN"}

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class YAMLSubsetError(ValueError):
    """Text outside the supported subset, or malformed YAML."""

    def __init__(self, line: int, what: str):
        super().__init__(f"line {line}: {what}")
        self.line = line


def _int(value: str) -> int:
    """PyYAML's construct_yaml_int."""
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        out, base = 0, 1
        for digit in reversed([int(p) for p in value.split(":")]):
            out += digit * base
            base *= 60
        return sign * out
    return sign * int(value)


def _float(value: str) -> float:
    """PyYAML's construct_yaml_float."""
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        out, base = 0.0, 1
        for digit in reversed([float(p) for p in value.split(":")]):
            out += digit * base
            base *= 60
        return sign * out
    return sign * float(value)


def resolve_plain(text: str, line: int) -> Any:
    """A plain scalar's value, as PyYAML's SafeLoader resolves it."""
    first = text[:1]
    if text == "" or (first in _FIRST["null"] and _NULL.match(text)):
        return None
    if first in _FIRST["bool"] and _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if first in _FIRST["int"] and _INT.match(text):
        return _int(text)
    if first in _FIRST["float"] and _FLOAT.match(text):
        return _float(text)
    if first.isdigit() and _TIMESTAMP.match(text):
        raise YAMLSubsetError(line, f"timestamp {text!r} is outside the supported subset")
    if text in ("<<", "="):
        raise YAMLSubsetError(line, f"the {text!r} key / value is outside the supported subset")
    return text


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def _quoted(s: str, i: int, line: int) -> Tuple[str, int]:
    """The quoted scalar starting at s[i]; returns (value, index after it)."""
    q = s[i]
    out: List[str] = []
    j = i + 1
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == '"':
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = s[j + 1:j + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
                continue
            if e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                code = s[j + 2:j + 2 + n]
                if len(code) != n or not all(ch in "0123456789abcdefABCDEF" for ch in code):
                    raise YAMLSubsetError(line, f"bad escape \\{e}{code}")
                out.append(chr(int(code, 16)))
                j += 2 + n
                continue
            raise YAMLSubsetError(line, f"unknown escape \\{e}" if e else
                                  "a line break in a double-quoted scalar (multi-line "
                                  "scalars are outside the supported subset)")
        out.append(c)
        j += 1
    raise YAMLSubsetError(line, "unterminated quoted scalar (multi-line scalars are outside "
                                "the supported subset)")


def _rest_is_comment(s: str, j: int, line: int, what: str) -> None:
    rest = s[j:]
    if rest.strip() and not (rest[:1] in " \t" and rest.strip().startswith("#")):
        raise YAMLSubsetError(line, f"unexpected text after {what}: {rest.strip()!r}")


def _refuse_indicator(s: str, line: int) -> None:
    c = s[:1]
    names = {"&": "anchors", "*": "aliases", "!": "tags", "{": "flow mappings",
             "|": "block scalars", ">": "block scalars", "%": "directives",
             "@": "reserved indicators", "`": "reserved indicators"}
    if c in names:
        raise YAMLSubsetError(line, f"{names[c]} are outside the supported subset: {s!r}")
    if c == "?" and (len(s) == 1 or s[1] in " \t"):
        raise YAMLSubsetError(line, f"complex keys are outside the supported subset: {s!r}")


def _plain_end(s: str, j: int, flow: bool) -> int:
    """Where the plain scalar starting at s[j] ends: at ' #', at ': ' (or a
    ':' ending the text) and, in a flow sequence, at ',', '[', ']', '{', '}'."""
    k = j
    while k < len(s):
        c = s[k]
        if c == "#" and k > j and s[k - 1] in " \t":
            break
        if c == ":" and (k + 1 == len(s) or s[k + 1] in " \t" or (flow and s[k + 1] in ",[]{}")):
            break
        if flow and c in ",[]{}":
            break
        k += 1
    return k


def _flow_seq(s: str, i: int, line: int) -> Tuple[list, int]:
    """The flow sequence starting at s[i] == '['; returns (list, index after ']')."""
    out: list = []
    j = i + 1
    expect_item = True
    while True:
        while j < len(s) and s[j] in " \t":
            j += 1
        if j >= len(s):
            raise YAMLSubsetError(line, "unterminated flow sequence (flow collections over "
                                        "several lines are outside the supported subset)")
        c = s[j]
        if c == "]":
            return out, j + 1
        if c == ",":
            if expect_item:
                raise YAMLSubsetError(line, "empty entry in a flow sequence")
            expect_item = True
            j += 1
            continue
        if not expect_item:
            raise YAMLSubsetError(line, f"expected ',' or ']' in a flow sequence at {s[j:]!r}")
        if c == "#":
            raise YAMLSubsetError(line, "a comment inside a flow sequence")
        if c == "[":
            item, j = _flow_seq(s, j, line)
        elif c in "'\"":
            item, j = _quoted(s, j, line)
        else:
            _refuse_indicator(s[j:], line)
            if c in "]}," or (c in "-?:" and s[j + 1:j + 2] in ("", " ", "\t", ",", "]")):
                raise YAMLSubsetError(line, f"unexpected {c!r} in a flow sequence")
            k = _plain_end(s, j, flow=True)
            if k < len(s) and s[k] == ":":
                raise YAMLSubsetError(line, "flow mappings (key: value inside [...]) are "
                                            "outside the supported subset")
            if k < len(s) and s[k] in "{}":
                raise YAMLSubsetError(line, "flow mappings are outside the supported subset")
            item, j = resolve_plain(s[j:k].rstrip(), line), k
        out.append(item)
        expect_item = False


def _inline_value(s: str, line: int) -> Any:
    """The value written on the rest of a line (a scalar or a flow sequence)."""
    s = s.lstrip(" \t")
    if s == "" or s.startswith("#"):
        return None
    c = s[0]
    if c == "[":
        value, j = _flow_seq(s, 0, line)
        _rest_is_comment(s, j, line, "a flow sequence")
        return value
    if c in "'\"":
        value, j = _quoted(s, 0, line)
        _rest_is_comment(s, j, line, "a quoted scalar")
        return value
    _refuse_indicator(s, line)
    if c in "]},":
        raise YAMLSubsetError(line, f"unexpected {c!r}")
    if c == "-" and (len(s) == 1 or s[1] in " \t"):
        raise YAMLSubsetError(line, "a block sequence entry is not allowed here")
    k = _plain_end(s, 0, flow=False)
    if k < len(s) and s[k] == ":":
        raise YAMLSubsetError(line, "mapping values are not allowed here")
    return resolve_plain(s[:k].rstrip(), line)


def _split_key(s: str, line: int) -> Optional[Tuple[Any, str]]:
    """(key, rest of the line) when the line's text is a ``key: ...``
    mapping entry, else None."""
    if s[:1] in "'\"":
        key, j = _quoted(s, 0, line)
        rest = s[j:].lstrip(" ")
        if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
            return key, rest[1:]
        return None
    if s[:1] in "[{":
        return None
    _refuse_indicator(s, line)
    if s[:1] == "-" and (len(s) == 1 or s[1] in " \t"):
        return None
    k = _plain_end(s, 0, flow=False)
    if k < len(s) and s[k] == ":":
        if s[k + 1:k + 2] == "\t":
            raise YAMLSubsetError(line, "a tab after a mapping key's ':'")
        key = s[:k].rstrip()
        if not key:
            raise YAMLSubsetError(line, "an empty mapping key")
        return resolve_plain(key, line), s[k + 1:]
    return None


def _is_seq_entry(s: str) -> bool:
    return s[:1] == "-" and (len(s) == 1 or s[1] in " \t")


class _Parser:
    def __init__(self, lines: List[_Line]):
        self.lines = lines
        self.i = 0

    def peek(self) -> Optional[_Line]:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int) -> Any:
        """The node whose first line is the next one, at ``indent``."""
        ln = self.peek()
        if _is_seq_entry(ln.text):
            return self.sequence(indent)
        if _split_key(ln.text, ln.no) is not None:
            return self.mapping(indent)
        self.i += 1
        value = _inline_value(ln.text, ln.no)
        nxt = self.peek()
        if nxt is not None and nxt.indent >= indent:
            raise YAMLSubsetError(nxt.no, "multi-line scalars are outside the supported subset")
        return value

    def child(self, indent: int, line: int, in_seq: bool) -> Any:
        """The value of an entry whose line ends after ':' or '-'."""
        nxt = self.peek()
        if nxt is None:
            return None
        if nxt.indent > indent:
            return self.block(nxt.indent)
        if nxt.indent == indent and not in_seq and _is_seq_entry(nxt.text):
            return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            ln = self.peek()
            if ln is None or ln.indent < indent:
                return out
            if ln.indent > indent:
                raise YAMLSubsetError(ln.no, "bad indentation of a mapping entry")
            kv = _split_key(ln.text, ln.no)
            if kv is None:
                raise YAMLSubsetError(ln.no, f"expected a 'key: value' entry, got {ln.text!r}")
            key, rest = kv
            try:
                hash(key)
            except TypeError:
                raise YAMLSubsetError(ln.no, "an unhashable mapping key") from None
            self.i += 1
            if rest.strip() == "" or rest.strip().startswith("#"):
                out[key] = self.child(indent, ln.no, in_seq=False)
            else:
                out[key] = _inline_value(rest, ln.no)
                nxt = self.peek()
                if nxt is not None and nxt.indent > indent:
                    raise YAMLSubsetError(nxt.no, "multi-line scalars are outside the "
                                                  "supported subset")

    def sequence(self, indent: int) -> list:
        out: list = []
        while True:
            ln = self.peek()
            if ln is None or ln.indent < indent or not _is_seq_entry(ln.text):
                if ln is not None and ln.indent > indent:
                    raise YAMLSubsetError(ln.no, "bad indentation of a sequence entry")
                return out
            if ln.indent > indent:
                raise YAMLSubsetError(ln.no, "bad indentation of a sequence entry")
            rest = ln.text[1:]
            pad = len(rest) - len(rest.lstrip(" "))
            rest = rest.lstrip(" ")
            if rest == "" or rest.startswith("#"):
                self.i += 1
                out.append(self.child(indent, ln.no, in_seq=True))
            elif _is_seq_entry(rest) or _split_key(rest, ln.no) is not None:
                # a compact nested node: re-read the rest of the line at its column
                self.lines[self.i] = _Line(ln.no, indent + 1 + pad, rest)
                out.append(self.block(indent + 1 + pad))
            else:
                self.i += 1
                out.append(_inline_value(rest, ln.no))
                nxt = self.peek()
                if nxt is not None and nxt.indent > indent:
                    raise YAMLSubsetError(nxt.no, "multi-line scalars are outside the "
                                                  "supported subset")


def _strip_comment(text: str) -> str:
    """The line without a trailing comment that starts at a '#' after
    whitespace outside quotes (quotes count only where a scalar starts)."""
    i, n = 0, len(text)
    at_start = True                   # at a position where a scalar may start
    while i < n:
        c = text[i]
        if c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        if c in "'\"" and at_start:
            try:
                _, i = _quoted(text, i, 0)
            except YAMLSubsetError:
                return text.rstrip()   # reported with its line by the parser
            at_start = False
            continue
        at_start = c in " \t[,-" or (c == ":" and i + 1 < n and text[i + 1] in " \t")
        i += 1
    return text.rstrip()


def safe_load(text: str) -> Any:
    """``yaml.safe_load(text)`` for text inside the subset; raises
    `YAMLSubsetError` with the line number for anything outside it."""
    if text.startswith("\ufeff"):
        text = text[1:]
    lines: List[_Line] = []
    for no, raw in enumerate(text.splitlines(), start=1):
        body = raw.lstrip(" ")
        indent = len(raw) - len(body)
        if body.startswith("\t") and body.strip():
            raise YAMLSubsetError(no, "tabs in indentation")
        body = _strip_comment(body)
        if not body.strip():
            continue
        if indent == 0 and (body.startswith("---") or body.startswith("...")) \
                and (len(body) == 3 or body[3] in " \t"):
            raise YAMLSubsetError(no, "document markers are outside the supported subset")
        if indent == 0 and body.startswith("%"):
            raise YAMLSubsetError(no, "directives are outside the supported subset")
        lines.append(_Line(no, indent, body))
    if not lines:
        return None
    parser = _Parser(lines)
    first = lines[0]
    value = parser.block(first.indent)
    left = parser.peek()
    if left is not None:
        raise YAMLSubsetError(left.no, "text after the end of the document's top node "
                                       "(bad indentation?)")
    return value


def load(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return safe_load(f.read())
