"""Chinese text normalization (NSW -> spoken form), pure Python.

Host-side port of the rule families of WeTextProcessing's
`tn.chinese.normalizer.Normalizer` (the reference loads it at
`indextts/utils/front.py:115-138` with remove_interjections=False,
remove_erhua=False — so interjections and erhua are passed through
unchanged, and this module never strips them). The library itself is a
pynini/OpenFST build that is not available in this image, so the taggers and
verbalizers TTS text actually exercises are reimplemented as an ordered
regex cascade:

  date > time > money > percent > fraction > telephone > range >
  measure > decimal > cardinal

matched left-to-right in one alternation pass (earlier families win, like
FST tagger priorities). Coverage follows the WeTextProcessing README
examples: 2.5平方电线→二点五平方电线, 62%→百分之六十二, 8:00→八点,
2021/08/24→二零二一年八月二十四日, mobile numbers digit-wise with 幺, etc.
"""

from __future__ import annotations

import re

# ---------------------------------------------------------------------------
# number verbalization
# ---------------------------------------------------------------------------

_DIGITS = "零一二三四五六七八九"
_UNITS_IN_GROUP = ["", "十", "百", "千"]
_GROUP_UNITS = ["", "万", "亿", "万亿"]


def digits_reading(s: str, use_yao: bool = False) -> str:
    """Digit-by-digit reading: '2024' -> 二零二四 (幺 for 1 if use_yao)."""
    one = "幺" if use_yao else "一"
    return "".join(one if c == "1" else _DIGITS[int(c)] if c.isdigit() else c
                   for c in s)


def _group_to_zh(n: int) -> str:
    """0 < n < 10000 -> Chinese, no cross-group zero handling."""
    out = []
    zero_pending = False
    started = False
    for pos in (3, 2, 1, 0):
        d = (n // 10 ** pos) % 10
        if d == 0:
            if started:
                zero_pending = True
            continue
        if zero_pending:
            out.append("零")
            zero_pending = False
        out.append(_DIGITS[d] + _UNITS_IN_GROUP[pos])
        started = True
    return "".join(out)


def num_to_zh(n: int) -> str:
    """Cardinal reading with 万/亿 grouping: 100523 -> 十万零五百二十三."""
    if n < 0:
        return "负" + num_to_zh(-n)
    if n == 0:
        return "零"
    groups = []  # little-endian groups of 4 digits
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    parts = []
    for i in range(len(groups) - 1, -1, -1):
        g = groups[i]
        if g == 0:
            continue
        # a group with leading zeros (g < 1000) after a higher group needs 零
        if parts and g < 1000:
            parts.append("零")
        parts.append(_group_to_zh(g) + _GROUP_UNITS[i])
    s = "".join(parts)
    # 一十X -> 十X only at the very start (10..19, 十万, 十亿…)
    if s.startswith("一十"):
        s = s[1:]
    return s


def number_token_to_zh(tok: str) -> str:
    """A digit string, possibly with leading zeros / 16+ digits -> reading."""
    if len(tok) >= 16 or (len(tok) > 1 and tok[0] == "0"):
        return digits_reading(tok)
    return num_to_zh(int(tok))


def decimal_to_zh(whole: str, frac: str, neg: bool = False) -> str:
    s = "负" if neg else ""
    s += number_token_to_zh(whole) if whole else "零"
    if frac:
        s += "点" + digits_reading(frac)
    return s


def _maybe_liang(num: str, following: str) -> str:
    """tn reads a bare 2 before a measure word as 两 (2个 -> 两个)."""
    if num == "2" and following:
        return "两"
    return number_token_to_zh(num)


# ---------------------------------------------------------------------------
# unit table (measure verbalizer)
# ---------------------------------------------------------------------------

# longest-match-first; keys are the unit as written, values the reading
UNITS = [
    ("km/h", "千米每小时"), ("m/s", "米每秒"),
    ("kWh", "千瓦时"), ("kW", "千瓦"),
    ("mm²", "平方毫米"), ("cm²", "平方厘米"), ("m²", "平方米"), ("km²", "平方千米"),
    ("mm³", "立方毫米"), ("cm³", "立方厘米"), ("m³", "立方米"),
    ("mm2", "平方毫米"), ("cm2", "平方厘米"), ("m2", "平方米"), ("km2", "平方千米"),
    ("mg", "毫克"), ("kg", "千克"), ("g", "克"), ("t", "吨"),
    ("mm", "毫米"), ("cm", "厘米"), ("km", "千米"), ("dm", "分米"), ("m", "米"),
    ("mL", "毫升"), ("ml", "毫升"), ("L", "升"), ("l", "升"),
    ("GHz", "吉赫兹"), ("MHz", "兆赫兹"), ("kHz", "千赫兹"), ("Hz", "赫兹"),
    ("TB", "太字节"), ("GB", "吉字节"), ("MB", "兆字节"), ("KB", "千字节"),
    ("ms", "毫秒"), ("s", "秒"), ("h", "小时"), ("min", "分钟"),
    ("°C", "摄氏度"), ("℃", "摄氏度"), ("°", "度"),
]
_UNIT_ALT = "|".join(re.escape(u) for u, _ in sorted(UNITS, key=lambda x: -len(x[0])))
_UNIT_MAP = dict(UNITS)

# Chinese measure words that trigger the 两-for-2 reading
_MEASURE_WORDS = "个只条张本把件套位名次回天年月周块元角分斤米秒"

_CURRENCY = {"$": "美元", "￥": "元", "¥": "元", "€": "欧元", "£": "英镑"}


# ---------------------------------------------------------------------------
# per-family verbalizers (applied to match objects of the master pattern)
# ---------------------------------------------------------------------------

def _verb_date_slash(m: re.Match) -> str:
    y, mo, d = m.group("sy"), m.group("sm"), m.group("sd")
    return (digits_reading(y) + "年" + num_to_zh(int(mo)) + "月"
            + num_to_zh(int(d)) + "日")


def _verb_time(m: re.Match) -> str:
    h, mi, se = m.group("th"), m.group("tm"), m.group("ts")
    out = num_to_zh(int(h)) + "点"
    if int(mi) != 0:
        if len(mi) == 2 and mi[0] == "0":
            out += "零" + num_to_zh(int(mi)) + "分"
        else:
            out += num_to_zh(int(mi)) + "分"
    if se is not None:
        out += num_to_zh(int(se)) + "秒"
    return out


def _verb_money(m: re.Match) -> str:
    cur = _CURRENCY[m.group("cur")]
    whole, frac = m.group("mw"), m.group("mf")
    if frac:
        return decimal_to_zh(whole, frac) + cur
    return number_token_to_zh(whole) + cur


def _verb_percent_range(m: re.Match) -> str:
    fa, fb = m.group("qfa") or "", m.group("qfb") or ""
    left = decimal_to_zh(m.group("qa"), fa[1:]) if fa \
        else number_token_to_zh(m.group("qa"))
    right = decimal_to_zh(m.group("qb"), fb[1:]) if fb \
        else number_token_to_zh(m.group("qb"))
    return "百分之" + left + "到百分之" + right


def _verb_percent(m: re.Match) -> str:
    neg = m.group("pneg") is not None
    whole, frac = m.group("pw"), m.group("pf")
    body = decimal_to_zh(whole, frac) if frac else number_token_to_zh(whole)
    return ("负" if neg else "") + "百分之" + body


def _verb_fraction(m: re.Match) -> str:
    num, den = m.group("fn"), m.group("fd")
    return number_token_to_zh(den) + "分之" + number_token_to_zh(num)


def _verb_mobile(m: re.Match) -> str:
    return digits_reading(m.group("mob"), use_yao=True)


def _verb_landline(m: re.Match) -> str:
    return digits_reading(m.group("ll").replace("-", ""), use_yao=True)


def _verb_idn(m: re.Match) -> str:
    return digits_reading(m.group("idn"))


def _verb_ratio(m: re.Match) -> str:
    return (number_token_to_zh(m.group("rx")) + "比"
            + number_token_to_zh(m.group("ry")))


def _verb_range(m: re.Match) -> str:
    a, b = m.group("ra"), m.group("rb")
    fa = m.group("rfa") or ""
    fb = m.group("rfb") or ""
    left = decimal_to_zh(a, fa[1:]) if fa else number_token_to_zh(a)
    right = decimal_to_zh(b, fb[1:]) if fb else number_token_to_zh(b)
    return left + "到" + right


def _verb_measure(m: re.Match) -> str:
    neg = m.group("uneg") is not None
    whole, frac, unit = m.group("uw"), m.group("uf"), m.group("unit")
    if frac:
        body = decimal_to_zh(whole, frac)
    elif whole == "2":
        body = "两"
    else:
        body = number_token_to_zh(whole)
    return ("负" if neg else "") + body + _UNIT_MAP[unit]


def _verb_decimal(m: re.Match) -> str:
    return decimal_to_zh(m.group("cw"), m.group("cf"),
                         m.group("cneg") is not None)


def _verb_cardinal(m: re.Match) -> str:
    neg = m.group("nneg") is not None
    tok = m.group("num")
    nxt = m.group("nfol") or ""
    # 第2个 is the ordinal 第二个, not 第两个 (tn ordinal tagger outranks the
    # liang rule)
    prev = m.string[m.start("num") - 1] if m.start("num") > 0 else ""
    if nxt and tok == "2" and nxt in _MEASURE_WORDS and prev != "第":
        return ("负" if neg else "") + "两" + nxt
    return ("负" if neg else "") + number_token_to_zh(tok) + nxt


# business abbreviations read with English "to" (WeTextProcessing whitelist
# behavior, speechio cn_tn documented case 特殊:O2O或B2C -> O to O或B to C;
# a general [A-Z]2[A-Z] rule would corrupt chemical formulas like H2O)
_TO_ABBREV = re.compile(r"(?<![A-Za-z0-9])([OBCP])2([OBCP])(?![A-Za-z0-9])")
_PLUS_86 = re.compile(r"\+86[-\s]?(?=1[3-9]\d{9})")
# landline continuations: 0595-23865596或23880880 — the bare 7/8-digit
# number after 或/、 inherits the telephone reading (digit-wise), matching
# the cn_tn documented output 固话:零五九五... 或二三八八零八八零
_LL_GROUP = re.compile(r"(0\d{2,3}-\d{7,8})((?:[或、](?:0\d{2,3}-)?\d{7,8})+)"
                       r"(?!\d)")


def _pre_special(text: str) -> str:
    text = _TO_ABBREV.sub(r"\1 to \2", text)
    text = _PLUS_86.sub("加八六", text)

    def llg(m: re.Match) -> str:
        head = digits_reading(m.group(1).replace("-", ""), use_yao=True)
        tail = re.sub(r"\d+", lambda d: digits_reading(d.group(0),
                                                       use_yao=True),
                      m.group(2))
        return head + tail

    return _LL_GROUP.sub(llg, text)


# dates with CJK markers run as pre-passes (before the master alternation)
_DATE_YMD = re.compile(
    r"(\d{2,4})年(?:(1[0-2]|0?[1-9])月(?:(3[01]|[12]\d|0?[1-9])([日号]))?)?")
_DATE_MD = re.compile(r"(?<!\d)(1[0-2]|0?[1-9])月(?:(3[01]|[12]\d|0?[1-9])([日号]))?")
# date ranges: 5日-8日 / 3月5日~8日 read with 到; 2021年-2023年 likewise
_DATE_DRANGE = re.compile(
    r"(?<!\d)(3[01]|[12]\d|0?[1-9])([日号])\s*[-~～至]\s*"
    r"(3[01]|[12]\d|0?[1-9])([日号])")
_DATE_YRANGE = re.compile(r"(?<!\d)(\d{2,4})年\s*[-~～]\s*(\d{2,4})年")


def _pre_date_ranges(text: str) -> str:
    def dr(m: re.Match) -> str:
        return (num_to_zh(int(m.group(1))) + m.group(2) + "到"
                + num_to_zh(int(m.group(3))) + m.group(4))

    def yr(m: re.Match) -> str:
        return (digits_reading(m.group(1)) + "年到"
                + digits_reading(m.group(2)) + "年")

    return _DATE_DRANGE.sub(dr, _DATE_YRANGE.sub(yr, text))


def _pre_dates(text: str) -> str:
    def ymd(m: re.Match) -> str:
        out = digits_reading(m.group(1)) + "年"
        if m.group(2):
            out += num_to_zh(int(m.group(2))) + "月"
        if m.group(3):
            out += num_to_zh(int(m.group(3))) + m.group(4)
        return out

    def md(m: re.Match) -> str:
        out = num_to_zh(int(m.group(1))) + "月"
        if m.group(2):
            out += num_to_zh(int(m.group(2))) + m.group(3)
        return out

    return _DATE_MD.sub(md, _DATE_YMD.sub(ymd, text))


# master pattern: alternatives in tagger-priority order
_MASTER = re.compile(
    # slashed/dashed dates: 2021/08/24, 2021-08-24
    r"(?P<sy>\d{4})[/-](?P<sm>1[0-2]|0?[1-9])[/-](?P<sd>3[01]|[12]\d|0?[1-9])(?!\d)"
    # time: 8:30, 08:05:59
    r"|(?<!\d)(?P<th>2[0-3]|[01]?\d):(?P<tm>[0-5]\d)(?::(?P<ts>[0-5]\d))?(?!\d)"
    # money: $3.5 ￥88
    r"|(?P<cur>[$￥¥€£])(?P<mw>\d+)(?:\.(?P<mf>\d+))?"
    # percent range: 10-20% / 10~20%
    r"|(?<![\d.\-])(?P<qa>\d+)(?P<qfa>\.\d+)?[-~～](?P<qb>\d+)(?P<qfb>\.\d+)?%"
    # percent: 62%, -3.5%
    r"|(?P<pneg>-)?(?P<pw>\d+)(?:\.(?P<pf>\d+))?%"
    # mobile phone: 11 digits starting 1[3-9]
    r"|(?<!\d)(?P<mob>1[3-9]\d{9})(?!\d)"
    # landline: 0xx(x)-xxxxxxx(x)
    r"|(?<!\d)(?P<ll>0\d{2,3}-\d{7,8})(?!\d)"
    # long identifiers (>= 12 digits): digit-wise, the cn_tn 编号 behavior
    # (a 14-digit serial is an ID, not a 万亿-scale cardinal)
    r"|(?<!\d)(?P<idn>\d{12,})(?!\.?\d)"
    # ratio/score: 1:5 -> 一比五 (colon forms that are not valid H:MM times;
    # the time alternative above wins for those)
    r"|(?<!\d)(?P<rx>\d{1,4}):(?P<ry>\d{1,4})(?!\d)"
    # fraction: 3/4
    r"|(?<![\d/])(?P<fn>\d{1,6})/(?P<fd>\d{1,6})(?![\d/])"
    # numeric range: 3~5 or 3-5 (both sides short numbers; hyphen form ranks
    # below dates/phones so 2021-08-24 and 0595-23865596 never reach it)
    r"|(?<![\d.\-])(?P<ra>\d{1,6})(?P<rfa>\.\d+)?[-~～](?P<rb>\d{1,6})(?P<rfb>\.\d+)?(?!\d)"
    # measure: 2.5kg, -3°C
    r"|(?P<uneg>-)?(?P<uw>\d+)(?:\.(?P<uf>\d+))?(?P<unit>" + _UNIT_ALT + r")(?![A-Za-z])"
    # decimal: 3.14, -0.5
    r"|(?P<cneg>-)?(?P<cw>\d+)\.(?P<cf>\d+)"
    # cardinal (optionally followed by a measure word for the 两 rule)
    r"|(?P<nneg>-)?(?P<num>\d+)(?P<nfol>[" + _MEASURE_WORDS + r"])?",
)

_VERBALIZERS = {
    "sy": _verb_date_slash,
    "th": _verb_time,
    "cur": _verb_money,
    "qa": _verb_percent_range,
    "pw": _verb_percent,
    "mob": _verb_mobile,
    "ll": _verb_landline,
    "idn": _verb_idn,
    "rx": _verb_ratio,
    "fn": _verb_fraction,
    "ra": _verb_range,
    "uw": _verb_measure,
    "cw": _verb_decimal,
    "num": _verb_cardinal,
}

# full-width ASCII -> half-width
_FW = {chr(0xFF01 + i): chr(0x21 + i) for i in range(94)}
_FW["　"] = " "
_FW_TRANS = str.maketrans(_FW)


class ZhNormalizer:
    """Drop-in for `tn.chinese.normalizer.Normalizer(...)`:
    exposes `.normalize(text) -> str`."""

    def normalize(self, text: str) -> str:
        text = text.translate(_FW_TRANS)
        text = _pre_special(text)
        text = _pre_dates(_pre_date_ranges(text))

        def repl(m: re.Match) -> str:
            for anchor, fn in _VERBALIZERS.items():
                if m.group(anchor) is not None:
                    return fn(m)
            return m.group(0)

        return _MASTER.sub(repl, text)
