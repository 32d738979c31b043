"""The port's Qwen tokenizer (`indextts_tpu_torch/text/qwen_tokenizer.py`,
standard library only) against the `tokenizers` library on a synthetic
Qwen `tokenizer.json` (NFC; Split on the Qwen pattern, isolated, then
ByteLevel without its own regex; the byte-level decoder; the Qwen3 added
tokens), which the test writes with `build_tokenizer_json`:

- the same ids on fixed strings (Chinese, contractions in both cases,
  digit and punctuation runs, \\r\\n and whitespace runs, emoji, added
  tokens inside text), the same decode with and without the special
  tokens, and decode(encode(t)) == NFC(t);
- the same under a hypothesis property over Unicode text, and the hand
  split against `regex.findall` on the pattern;
- the vocab.json + merges.txt form and the "a b" merge form give the same
  ids; another split pattern (or normalizer) is refused; the chat template.
"""

import json
import unicodedata

import pytest
import regex
from hypothesis import given, settings
from hypothesis import strategies as st
from tokenizers import Tokenizer

from indextts_tpu_torch.text import qwen_tokenizer as qt

CORPUS = ("The quick brown fox jumps over the lazy dog. I'm happy, you're sad; we'll see! "
          "今天天气很好，我很高兴。他很生气！她非常难过…… 12345 67890 "
          '{"高兴": 0.5, "悲伤": 0.1, "自然": 0.0}\n文本情感分类 ') * 4
VOCAB, FIRST_ADDED = 1200, 1000

FIXED = [
    "今天天气很好，我很高兴。他说：“你好！”",
    "I'M HERE, YOU'RE THERE; it's 'S fine, they'll've 'LL 'D 'ſ 'Re'VE'M",
    "numbers 12345 and 3.14159, ١٢٣ ½ Ⅻ",
    "!!!??? ... --- ,,;;  ((brackets)) ** ~~",
    "line\r\nbreaks\n\n\r\n  and   spaces \t\ttabs  \n",
    "emoji 😀👍🏽 family 👨‍👩‍👧 flags 🇨🇳",
    "<|im_start|>system\n文本情感分类<|im_end|>\n<|im_start|>user\nhi<think>x</think>"
    "<|im_end|><|im_end|>",
    "café Å   　 trailing   ",
]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("qwen_tok")
    tj = qt.build_tokenizer_json(CORPUS, VOCAB, first_added_id=FIRST_ADDED)
    (d / "tokenizer.json").write_text(json.dumps(tj, ensure_ascii=False), encoding="utf-8")
    return d, tj


@pytest.fixture(scope="module")
def pair(files):
    d, _ = files
    return Tokenizer.from_file(str(d / "tokenizer.json")), qt.load_qwen_tokenizer(str(d))


def _same(hf, me, text):
    ids = hf.encode(text).ids
    assert me.encode(text) == ids, text
    for skip in (False, True):
        assert me.decode(ids, skip_special_tokens=skip) == \
            hf.decode(ids, skip_special_tokens=skip), (text, skip)
    assert me.decode(ids) == unicodedata.normalize("NFC", text)
    return ids


@pytest.mark.parametrize("text", FIXED, ids=[f"fixed{i}" for i in range(len(FIXED))])
def test_fixed_strings_match_the_library(pair, text):
    hf, me = pair
    ids = _same(hf, me, text)
    if "<|im_end|>" in text:
        assert ids.count(FIRST_ADDED + 2) == text.count("<|im_end|>")


@settings(max_examples=300, deadline=None, database=None)
@given(text=st.text(max_size=40))
def test_ids_and_round_trip_over_unicode_text(pair, text):
    hf, me = pair
    _same(hf, me, text)


# characters assigned in this Python's Unicode database: the `regex`
# module may carry a newer one, in which some of the rest are letters
@settings(max_examples=300, deadline=None, database=None)
@given(text=st.text(alphabet=st.characters(exclude_categories=("Cs", "Cn")), max_size=40))
def test_hand_split_matches_regex(text):
    assert qt.pre_tokenize(text) == regex.findall(qt.QWEN_SPLIT_PATTERN, text)


def test_split_on_fixed_strings_matches_regex():
    for text in FIXED + ["'s's'S 'T'Re'VE'M'Ll'D 'x", "a  \n b\n\n  c   ", " \r\n\t x"]:
        assert qt.pre_tokenize(text) == regex.findall(qt.QWEN_SPLIT_PATTERN, text), text


def test_the_other_file_forms_give_the_same_ids(files, pair, tmp_path):
    """vocab.json + merges.txt (with tokenizer_config.json's
    added_tokens_decoder), and tokenizer.json with "a b" merges."""
    _, tj = files
    hf, _ = pair
    vocab = {t: i for t, i in tj["model"]["vocab"].items()
             if not FIRST_ADDED <= i < FIRST_ADDED + len(qt.QWEN3_ADDED_TOKENS)}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in tj["model"]["merges"]),
        encoding="utf-8")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"added_tokens_decoder": {
        str(t["id"]): {k: t[k] for k in ("content", "lstrip", "rstrip", "single_word",
                                         "normalized", "special")}
        for t in tj["added_tokens"]}}), encoding="utf-8")
    slow = qt.load_qwen_tokenizer(str(tmp_path))
    joined = dict(tj, model=dict(tj["model"], merges=[f"{a} {b}" for a, b in
                                                      tj["model"]["merges"]]))
    (tmp_path / "tokenizer.json").write_text(json.dumps(joined, ensure_ascii=False),
                                             encoding="utf-8")
    strings = qt.load_qwen_tokenizer(str(tmp_path))
    for text in FIXED:
        ids = hf.encode(text).ids
        assert slow.encode(text) == ids and strings.encode(text) == ids, text
        assert slow.decode(ids, skip_special_tokens=True) == \
            hf.decode(ids, skip_special_tokens=True)


@pytest.mark.parametrize("change", ["pattern", "normalizer", "behavior", "dropout",
                                    "ignore_merges", "added"])
def test_another_pipeline_is_refused(files, tmp_path, change):
    _, tj = files
    tj = json.loads(json.dumps(tj))
    split = tj["pre_tokenizer"]["pretokenizers"][0]
    if change == "pattern":        # GPT-2's split
        split["pattern"] = {"Regex": r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                                     r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"}
    elif change == "normalizer":
        tj["normalizer"] = {"type": "NFKC"}
    elif change == "behavior":
        split["behavior"] = "Removed"
    elif change == "dropout":
        tj["model"]["dropout"] = 0.1
    elif change == "ignore_merges":
        tj["model"]["ignore_merges"] = True
    else:
        tj["added_tokens"][0]["normalized"] = True
    (tmp_path / "tokenizer.json").write_text(json.dumps(tj, ensure_ascii=False),
                                             encoding="utf-8")
    with pytest.raises(ValueError, match="implement"):
        qt.load_qwen_tokenizer(str(tmp_path))


def test_chat_template_renders_the_emotion_prompt_and_nothing_else(pair):
    _, me = pair
    msgs = [{"role": "system", "content": "文本情感分类"}, {"role": "user", "content": "好开心"}]
    out = me.apply_chat_template(msgs, tokenize=False, add_generation_prompt=True,
                                 enable_thinking=False)
    assert out == ("<|im_start|>system\n文本情感分类<|im_end|>\n<|im_start|>user\n好开心"
                   "<|im_end|>\n<|im_start|>assistant\n<think>\n\n</think>\n\n")
    for kw in ({"enable_thinking": True}, {"add_generation_prompt": False}, {"tokenize": True}):
        with pytest.raises(NotImplementedError):
            me.apply_chat_template(msgs, **{"tokenize": False, "add_generation_prompt": True,
                                            "enable_thinking": False, **kw})
    with pytest.raises(NotImplementedError):
        me.apply_chat_template(msgs[1:], add_generation_prompt=True, enable_thinking=False)


def test_full_width_file_covers_every_model_id():
    """The smoke's file: ids [0, 151936) all decodable, the Qwen3 added
    tokens at their published ids."""
    tj = qt.build_tokenizer_json(CORPUS, 151936)
    me = qt.QwenTokenizer(tj["model"]["vocab"], [tuple(m) for m in tj["model"]["merges"]],
                          [(t["content"], t["id"], t["special"]) for t in tj["added_tokens"]])
    assert sorted(me.id_to_token) == list(range(151936))
    assert [me.added_ids[t] for t in ("<|im_start|>", "<|im_end|>", "<think>", "</think>")] == \
        [151644, 151645, 151667, 151668]
    assert me.encode("<|im_start|>user\n高兴<|im_end|>")[0] == 151644
