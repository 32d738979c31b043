"""English text normalization (NSW -> spoken form), pure Python.

Host-side port of the rule families of WeTextProcessing's
`tn.english.normalizer.Normalizer` (loaded by the reference at
`indextts/utils/front.py:133-138`; the pynini build is unavailable in this
image). Ordered regex cascade, earlier families win:

  date (month-name / y-m-d) > time > money > percent > ordinal >
  fraction > telephone > measure > decimal > cardinal

Conventions follow the tn english verbalizers: cardinals without "and"
("123" -> one hundred twenty three), decimals digit-wise after "point",
years in two-digit pairs ("1999" -> nineteen ninety nine in date context),
money with major/minor units ("$3.25" -> three dollars twenty five cents).
"""

from __future__ import annotations

import re

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"),
          (10 ** 3, "thousand")]

_ORD_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def num_to_en(n: int) -> str:
    """Cardinal, tn style (no 'and', no hyphens)."""
    if n < 0:
        return "minus " + num_to_en(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        return _TENS[n // 10] + ("" if n % 10 == 0 else " " + _ONES[n % 10])
    if n < 1000:
        rest = n % 100
        return (_ONES[n // 100] + " hundred"
                + ("" if rest == 0 else " " + num_to_en(rest)))
    for div, name in _SCALE:
        if n >= div:
            rest = n % div
            return (num_to_en(n // div) + " " + name
                    + ("" if rest == 0 else " " + num_to_en(rest)))
    return str(n)


def ord_to_en(n: int) -> str:
    """Ordinal: 1 -> first, 23 -> twenty third, 100 -> one hundredth."""
    words = num_to_en(n).split()
    last = words[-1]
    if last in _ORD_SPECIAL:
        words[-1] = _ORD_SPECIAL[last]
    elif last.endswith("y"):
        words[-1] = last[:-1] + "ieth"
    elif last.endswith("t"):
        words[-1] = last + "h"
    else:
        words[-1] = last + "th"
    return " ".join(words)


def digits_to_en(s: str) -> str:
    """Digit-by-digit: '007' -> zero zero seven."""
    return " ".join(_ONES[int(c)] for c in s if c.isdigit())


def year_to_en(y: int) -> str:
    """Year reading: 1999 -> nineteen ninety nine, 2005 -> two thousand five,
    2024 -> twenty twenty four."""
    if y < 1000 or y > 9999:
        return num_to_en(y)
    hi, lo = divmod(y, 100)
    if lo == 0:
        if hi % 10 == 0:
            return num_to_en(y)            # 2000 -> two thousand
        return num_to_en(hi) + " hundred"  # 1900 -> nineteen hundred
    if hi % 10 == 0 and lo < 10:
        return num_to_en(y)                # 2005 -> two thousand five
    lo_s = ("o " if lo < 10 else "") + num_to_en(lo)  # 1905 -> nineteen o five
    return num_to_en(hi) + " " + lo_s


def number_token_to_en(tok: str) -> str:
    tok = tok.replace(",", "")
    if len(tok) > 1 and tok[0] == "0":
        return digits_to_en(tok)
    if len(tok) >= 13:
        return digits_to_en(tok)
    return num_to_en(int(tok))


def decimal_to_en(whole: str, frac: str, neg: bool = False) -> str:
    s = "minus " if neg else ""
    s += number_token_to_en(whole) if whole else "zero"
    if frac:
        s += " point " + digits_to_en(frac)
    return s


_MONTHS = {
    "jan": "january", "feb": "february", "mar": "march", "apr": "april",
    "may": "may", "jun": "june", "jul": "july", "aug": "august",
    "sep": "september", "sept": "september", "oct": "october",
    "nov": "november", "dec": "december",
}
_MONTH_FULL = ("january|february|march|april|may|june|july|august|september"
               "|october|november|december")
_MONTH_ABBR = "jan|feb|mar|apr|may|jun|jul|aug|sept|sep|oct|nov|dec"

_CURRENCY = {"$": ("dollar", "cent"), "€": ("euro", "cent"),
             "£": ("pound", "penny"), "¥": ("yen", "sen"),
             "￥": ("yuan", "fen")}

UNITS = [
    ("km/h", "kilometers per hour"), ("m/s", "meters per second"),
    ("kWh", "kilowatt hours"), ("kW", "kilowatts"),
    ("mg", "milligrams"), ("kg", "kilograms"), ("g", "grams"),
    ("mm", "millimeters"), ("cm", "centimeters"), ("km", "kilometers"),
    ("ml", "milliliters"), ("mL", "milliliters"), ("L", "liters"),
    ("GHz", "gigahertz"), ("MHz", "megahertz"), ("kHz", "kilohertz"),
    ("Hz", "hertz"), ("TB", "terabytes"), ("GB", "gigabytes"),
    ("MB", "megabytes"), ("KB", "kilobytes"), ("ms", "milliseconds"),
    ("lb", "pounds"), ("oz", "ounces"), ("ft", "feet"), ("mi", "miles"),
    ("°C", "degrees celsius"), ("℃", "degrees celsius"),
    ("°F", "degrees fahrenheit"), ("%", "percent"),
]
_UNIT_MAP = dict(UNITS)
_UNIT_SINGULAR = {
    "kilometers per hour": "kilometer per hour",
    "meters per second": "meter per second",
}
_UNIT_ALT = "|".join(re.escape(u) for u, _ in sorted(UNITS, key=lambda x: -len(x[0]))
                     if u not in ("%",))


def _unit_words(unit: str, singular: bool) -> str:
    words = _UNIT_MAP[unit]
    if not singular:
        return words
    if words in _UNIT_SINGULAR:
        return _UNIT_SINGULAR[words]
    if words.endswith("feet"):
        return "foot"
    if words.endswith("s") and not words.endswith("celsius") \
            and not words.endswith("fahrenheit"):
        return words[:-1]
    return words


def _verb_date_mn(m: re.Match) -> str:
    mon = m.group("mon").lower().rstrip(".")
    mon = _MONTHS.get(mon, mon)
    out = mon
    if m.group("day"):
        out += " " + ord_to_en(int(m.group("day")))
    if m.group("yr"):
        out += " " + year_to_en(int(m.group("yr")))
    return out


def _verb_date_dmn(m: re.Match) -> str:
    mon = m.group("mon2").lower().rstrip(".")
    mon = _MONTHS.get(mon, mon)
    out = "the " + ord_to_en(int(m.group("day2"))) + " of " + mon
    if m.group("yr2"):
        out += " " + year_to_en(int(m.group("yr2")))
    return out


def _verb_time(m: re.Match) -> str:
    h, mi = int(m.group("th")), m.group("tm")
    suffix = m.group("tsuf")
    out = num_to_en(h)
    if int(mi) == 0:
        out += " o'clock" if not suffix else ""
    elif mi[0] == "0":
        out += " o " + num_to_en(int(mi))
    else:
        out += " " + num_to_en(int(mi))
    if suffix:
        ampm = suffix.replace(".", "").lower()
        out += " " + (" ".join(ampm))  # am -> a m
    return out


def _verb_money(m: re.Match) -> str:
    major, minor = _CURRENCY[m.group("cur")]
    whole, frac = m.group("mw"), m.group("mf")
    scale = m.group("msc")
    if scale:  # $3.5 million -> three point five million dollars
        amt = decimal_to_en(whole, frac) if frac else number_token_to_en(whole)
        return f"{amt} {scale.lower()} {major}s"
    w = int(whole.replace(",", ""))
    cents = int(frac[:2].ljust(2, "0")) if frac else 0
    minor_w = minor if cents == 1 else (
        "pence" if minor == "penny" else minor + "s")
    if w == 0 and cents:  # $0.99 -> ninety nine cents
        return num_to_en(cents) + " " + minor_w
    out = number_token_to_en(whole) + " " + (major if w == 1 else major + "s")
    if cents:
        out += " " + num_to_en(cents) + " " + minor_w
    return out


def _verb_percent(m: re.Match) -> str:
    neg = m.group("pneg") is not None
    body = decimal_to_en(m.group("pw"), m.group("pf"))
    return ("minus " if neg else "") + body + " percent"


def _verb_ordinal(m: re.Match) -> str:
    return ord_to_en(int(m.group("on")))


def _verb_fraction(m: re.Match) -> str:
    num, den = int(m.group("fn")), int(m.group("fd"))
    if den == 2:
        return num_to_en(num) + (" half" if num == 1 else " halves")
    if den == 4:
        return num_to_en(num) + (" quarter" if num == 1 else " quarters")
    d = ord_to_en(den)
    return num_to_en(num) + " " + (d if num == 1 else d + "s")


def _verb_phone(m: re.Match) -> str:
    return digits_to_en(re.sub(r"\D", "", m.group("ph")))


def _verb_measure(m: re.Match) -> str:
    neg = m.group("uneg") is not None
    whole, frac, unit = m.group("uw"), m.group("uf"), m.group("unit")
    body = decimal_to_en(whole, frac) if frac else number_token_to_en(whole)
    singular = (whole.replace(",", "") == "1" and not frac)
    return ("minus " if neg else "") + body + " " + _unit_words(unit, singular)


def _pluralize_decade(words_str: str) -> str:
    words = words_str.split()
    last = words[-1]
    words[-1] = last[:-1] + "ies" if last.endswith("y") else last + "s"
    return " ".join(words)


def _verb_decade(m: re.Match) -> str:
    return _pluralize_decade(year_to_en(int(m.group("dec"))))


def _verb_decade2(m: re.Match) -> str:
    # two-digit decades: "the 90s" / "'90s" -> "the nineties" (r5
    # correction #2; was read as a pluralized cardinal "ninetys")
    return _pluralize_decade(num_to_en(int(m.group("dc2"))))


# 4-digit tokens read as years (1600-2099, the NeMo/tn heuristic window).
# Single source for BOTH the bare-year _MASTER branch and the range
# endpoints — widening one without the other would read "1492" as a year
# but "1492-1503" as thousand-scale cardinals.
_YEAR_PAT = r"1[6-9]\d{2}|20\d{2}"


def _verb_range(m: re.Match) -> str:
    # "50-60" -> "fifty to sixty" (r5 correction #1; the hyphen was read
    # as a glued "minus"). NeMo/tn range grammar family. Year ranges keep
    # the year reading: "1939-1945" -> "nineteen thirty nine to nineteen
    # forty five" (r5 review correction — the plain-cardinal form regressed
    # every date range to thousand-scale cardinals).
    a, b = m.group("ra"), m.group("rb")

    def one(tok):
        if re.fullmatch(_YEAR_PAT, tok):
            return year_to_en(int(tok))
        return number_token_to_en(tok)

    return one(a) + " to " + one(b)


def _verb_year(m: re.Match) -> str:
    return year_to_en(int(m.group("yrx")))


def _verb_decimal(m: re.Match) -> str:
    return decimal_to_en(m.group("cw"), m.group("cf"),
                         m.group("cneg") is not None)


def _verb_cardinal(m: re.Match) -> str:
    neg = m.group("nneg") is not None
    return ("minus " if neg else "") + number_token_to_en(m.group("num"))


_MASTER = re.compile(
    # month-name dates: January 5, 2024 / Jan. 5 / May 2024
    r"(?P<mon>(?:" + _MONTH_FULL + r")|(?:" + _MONTH_ABBR + r")\.?)"
    r"(?:\s+(?P<day>3[01]|[12]\d|0?[1-9])(?:st|nd|rd|th)?(?!\d))?"
    r"(?:,?\s+(?P<yr>[12]\d{3}))?(?![a-z])"
    # day-first: 5 January 2024
    r"|(?<!\d)(?P<day2>3[01]|[12]\d|0?[1-9])(?:st|nd|rd|th)?\s+"
    r"(?P<mon2>(?:" + _MONTH_FULL + r")|(?:" + _MONTH_ABBR + r")\.?)"
    r"(?:,?\s+(?P<yr2>[12]\d{3}))?(?![a-z])"
    # time: 12:30, 8:05 am
    r"|(?<!\d)(?P<th>2[0-3]|[01]?\d):(?P<tm>[0-5]\d)"
    r"(?:\s*(?P<tsuf>[ap]\.?m\.?))?(?!\d)"
    # money: $3.25, $3.5 million
    r"|(?P<cur>[$€£¥￥])(?P<mw>\d+(?:,\d{3})*)(?:\.(?P<mf>\d+))?"
    r"(?:\s+(?P<msc>million|billion|trillion))?"
    # percent
    r"|(?P<pneg>(?<![A-Za-z])-)?(?P<pw>\d+(?:,\d{3})*)(?:\.(?P<pf>\d+))?\s?%"
    # ordinal suffix: 1st, 23rd
    r"|(?<!\d)(?P<on>\d+)(?:st|nd|rd|th)(?![a-z])"
    # fraction: 3/4
    r"|(?<![\d/])(?P<fn>\d{1,4})/(?P<fd>\d{1,4})(?![\d/])"
    # phone: 555-123-4567, (555) 123-4567, 1-800-555-0199, 10+ digit strings
    r"|(?<!\d)(?P<ph>(?:1-)?(?:\(\d{3}\)\s?|\d{3}-)\d{3}-\d{4}|\d{10,15})(?!\d)"
    # measure: 5kg, 3.5 km
    r"|(?P<uneg>(?<![A-Za-z])-)?(?P<uw>\d+(?:,\d{3})*)(?:\.(?P<uf>\d+))?\s?"
    r"(?P<unit>" + _UNIT_ALT + r")(?![A-Za-z])"
    # integer ranges: 50-60, page 5-10 (before ordinal/cardinal so the
    # hyphen is "to", not a glued "minus")
    r"|(?<![\d,.\-])(?P<ra>\d{1,4})-(?P<rb>\d{1,4})(?![\d,.\-])"
    # decades: the 1980s / 2010s; two-digit '90s / 90s
    r"|(?<![\d,.])(?P<dec>(?:1[6-9]|20)\d0)s(?![a-z\d])"
    r"|(?<![\d,.])(?P<dc2>[2-9]0)s(?![a-z\d])"
    # bare year: 1999 (heuristic: 4-digit 1600-2099 standalone)
    r"|(?<![\d,.])(?P<yrx>" + _YEAR_PAT + r")(?![\d,.])(?!\s*(?:" + _UNIT_ALT + r"))"
    # decimal
    r"|(?P<cneg>(?<![A-Za-z])-)?(?P<cw>\d+(?:,\d{3})*)\.(?P<cf>\d+)"
    # cardinal
    r"|(?P<nneg>(?<![A-Za-z])-)?(?P<num>\d+(?:,\d{3})*)",
    re.IGNORECASE,
)

_VERBALIZERS = {
    "mon": _verb_date_mn,
    "day2": _verb_date_dmn,
    "th": _verb_time,
    "cur": _verb_money,
    "pw": _verb_percent,
    "on": _verb_ordinal,
    "fn": _verb_fraction,
    "ph": _verb_phone,
    "uw": _verb_measure,
    "ra": _verb_range,
    "dec": _verb_decade,
    "dc2": _verb_decade2,
    "yrx": _verb_year,
    "cw": _verb_decimal,
    "num": _verb_cardinal,
}

# ---------------------------------------------------------------------------
# roman numerals (tn english roman grammar family): "Chapter XIV" ->
# "Chapter fourteen" (structural-noun context), "Henry VIII" -> "Henry the
# eighth" (regnal-NAME context, a whitelist mirroring tn's names list --
# "any capitalized preceding word" fired on sentence-initial "The IV
# drip"; r5 review correction). Single letters and non-canonical roman
# strings (XXL, IIX) are never converted.
# ---------------------------------------------------------------------------
_ROMAN_VAL = {"I": 1, "V": 5, "X": 10, "L": 50, "C": 100, "D": 500, "M": 1000}
_ROMAN_CARDINAL_CTX = {"chapter", "part", "section", "act", "volume", "book",
                       "page", "war", "phase", "stage", "article", "grade",
                       "type", "class", "level"}
# regnal/papal given names (the tn english roman ordinal-context family)
_ROMAN_NAME_CTX = {
    "henry", "louis", "george", "edward", "elizabeth", "charles", "james",
    "william", "richard", "philip", "philippe", "frederick", "napoleon",
    "pius", "benedict", "paul", "john", "leo", "gregory", "urban",
    "alexander", "catherine", "peter", "ivan", "nicholas", "felipe",
    "carlos", "juan", "olaf", "olav", "gustav", "christian", "haakon",
    "rama", "mehmed", "selim", "ramses", "ptolemy", "constantine",
}
_ROMAN_RE = re.compile(
    r"(?P<pre>\b[A-Za-z]+)(?P<sp>[ \u00a0]+)"
    r"(?P<rom>[IVXL]{2,8})\b(?![a-z.])")


def roman_to_int(s: str) -> int:
    total = 0
    for i, c in enumerate(s):
        v = _ROMAN_VAL[c]
        total += -v if i + 1 < len(s) and _ROMAN_VAL[s[i + 1]] > v else v
    return total


def _int_to_roman(n: int) -> str:
    out = []
    for v, sym in ((50, "L"), (40, "XL"), (10, "X"), (9, "IX"), (5, "V"),
                   (4, "IV"), (1, "I")):
        while n >= v:
            out.append(sym)
            n -= v
    return "".join(out)


def _verb_roman(m: re.Match) -> str:
    rom = m.group("rom")
    n = roman_to_int(rom)
    # canonical form only: rejects XXL, IIX, VV, ... (sizes, acronyms)
    if n <= 0 or n > 89 or _int_to_roman(n) != rom:
        return m.group(0)
    pre = m.group("pre")
    if pre.lower() in _ROMAN_CARDINAL_CTX:
        return pre + m.group("sp") + num_to_en(n)
    if pre.lower() in _ROMAN_NAME_CTX and pre[0].isupper():
        return pre + m.group("sp") + "the " + ord_to_en(n)
    return m.group(0)

# whitelist abbreviations (tn english/data/whitelist.tsv subset)
_WHITELIST = [
    (re.compile(r"\bMr\.(?=\s[A-Z])|\bMr\.?(?=\s)"), "mister"),
    (re.compile(r"\bMrs\.?(?=\s)"), "misses"),
    (re.compile(r"\bMs\.?(?=\s)"), "miss"),
    (re.compile(r"\bDr\.(?=\s[A-Z])"), "doctor"),
    (re.compile(r"\betc\.?(?=[\s,.!?]|$)"), "et cetera"),
    (re.compile(r"\be\.g\.", re.I), "for example"),
    (re.compile(r"\bi\.e\.", re.I), "that is"),
    (re.compile(r"\bvs\.?(?=\s)", re.I), "versus"),
    (re.compile(r"\bNo\.(?=\s?\d)"), "number"),
    (re.compile(r"\b24/7\b"), "twenty four seven"),
    (re.compile(r"&"), " and "),
]

# serial/alphanumeric split (tn english serial family): "A4" -> "A four",
# "atan2" -> "atan two", "B2B" -> "B two B". Ordinal suffixes (1st/2nd/...),
# plural/decade 's', and am/pm survive unsplit so their own rules still see
# them (r5 correction #3; glued digits were verbalized with no space).
_SERIAL_SPLIT_DL = re.compile(
    r"(?<=\d)(?=(?!(?:st|nd|rd|th|s|am|pm)\b)[A-Za-z])")
_SERIAL_SPLIT_LD = re.compile(r"(?<=[A-Za-z])(?=\d)")


class EnNormalizer:
    """Drop-in for `tn.english.normalizer.Normalizer()`:
    exposes `.normalize(text) -> str`."""

    def normalize(self, text: str) -> str:
        for pat, repl in _WHITELIST:
            text = pat.sub(repl, text)
        text = _ROMAN_RE.sub(_verb_roman, text)
        text = _SERIAL_SPLIT_DL.sub(" ", text)
        text = _SERIAL_SPLIT_LD.sub(" ", text)

        def repl_fn(m: re.Match) -> str:
            for anchor, fn in _VERBALIZERS.items():
                if m.group(anchor) is not None:
                    return fn(m)
            return m.group(0)

        text = _MASTER.sub(repl_fn, text)
        return re.sub(r"\s{2,}", " ", text)
