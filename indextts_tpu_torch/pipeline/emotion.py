"""Text -> 8-dim emotion vector (PyTorch counterpart of
`indextts_tpu/pipeline/emotion.py`).

`QwenEmotion` has the JAX class's surface (``inference``, ``convert``,
``clamp_score``, ``_fallback_scores``, ``_model_inference``) and output
contract: the eight emotions in order, each clamped to [0, 1.2], the
melancholic/sad swap, calm 1.0 when nothing is detected. The fine-tuned
Qwen3 classifier (`models/qwen.py`) runs on the pipeline's device in bf16,
with the port's own tokenizer and chat template
(`text/qwen_tokenizer.py`); everything loads at the first ``inference``.

One JAX fault is not copied: the JAX loader catches every exception and
falls back to the keyword lexicon, so a model directory that is present but
broken silently gives keyword scores. Here only an absent directory gives
the fallback (silently, as in the JAX package); a present directory that
does not load raises.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict

import torch

from indextts_tpu_torch.models.qwen import QwenConfig, convert_qwen, qwen_generate_greedy
from indextts_tpu_torch.text.qwen_tokenizer import load_qwen_tokenizer
from indextts_tpu_torch.utils import convert
from indextts_tpu_torch.utils.jax_params import to_torch

EMOTION_KEYS = ["happy", "angry", "sad", "afraid", "disgusted", "melancholic",
                "surprised", "calm"]

CN_KEY_TO_EN = {
    "高兴": "happy", "愤怒": "angry", "悲伤": "sad", "恐惧": "afraid",
    "反感": "disgusted", "低落": "melancholic", "惊讶": "surprised", "自然": "calm",
}
DESIRED_VECTOR_ORDER = ["高兴", "愤怒", "悲伤", "恐惧", "反感", "低落", "惊讶", "自然"]
MELANCHOLIC_WORDS = {"低落", "melancholy", "melancholic", "depression",
                     "depressed", "gloomy"}

# keyword lexicon for the no-checkpoint fallback
_FALLBACK_LEXICON = {
    "高兴": ["开心", "高兴", "快乐", "喜悦", "happy", "joy", "glad", "delight", "excited"],
    "愤怒": ["生气", "愤怒", "恼火", "angry", "furious", "mad", "rage"],
    "悲伤": ["悲伤", "难过", "伤心", "sad", "sorrow", "grief", "cry", "tears"],
    "恐惧": ["害怕", "恐惧", "恐怖", "afraid", "fear", "scared", "terrified"],
    "反感": ["恶心", "反感", "厌恶", "disgust", "gross", "nasty"],
    "低落": ["低落", "melancholic", "melancholy", "depressed", "gloomy"],
    "惊讶": ["惊讶", "震惊", "吃惊", "surprise", "shocked", "amazed", "wow"],
    "自然": [],
}

# the classifier's generation budget and the id of "</think>" (the JAX
# package's constants)
MAX_NEW_TOKENS = 256
THINK_END_ID = 151668
CHECKPOINTS = ("model.safetensors", "pytorch_model.bin")


class QwenEmotion:
    """The emotion classifier of `IndexTTS2` (``use_emo_text``)."""

    max_score = 1.2
    min_score = 0.0

    def __init__(self, model_dir: str, device="cuda", dtype: torch.dtype = torch.bfloat16):
        self.model_dir = model_dir
        self.device = torch.device(device)
        self.dtype = dtype
        self.prompt = "文本情感分类"
        self.model = None
        self.tokenizer = None
        self._tried_load = False

    def _load(self):
        """Load the classifier once: ``config.json`` (`QwenConfig.from_hf`),
        the tokenizer, and the weights of ``model.safetensors`` (else
        ``pytorch_model.bin``) placed on ``device`` in ``dtype``. An absent
        directory leaves the model unset (the keyword fallback); a present
        one that fails to load raises, and the next call tries again."""
        if self._tried_load:
            return
        if os.path.isdir(self.model_dir):
            tokenizer = load_qwen_tokenizer(self.model_dir)
            with open(os.path.join(self.model_dir, "config.json"), encoding="utf-8") as f:
                cfg = QwenConfig.from_hf(json.load(f))
            ckpt = next((os.path.join(self.model_dir, c) for c in CHECKPOINTS
                         if os.path.exists(os.path.join(self.model_dir, c))), None)
            if ckpt is None:
                raise FileNotFoundError(f"{self.model_dir}: no Qwen checkpoint "
                                        f"({' or '.join(CHECKPOINTS)})")
            tree = convert_qwen(convert.load_torch_state_dict(ckpt), cfg)
            self.model = to_torch(tree, self.device, self.dtype)
            self.tokenizer, self.qwen_cfg = tokenizer, cfg
        self._tried_load = True

    def clamp_score(self, value) -> float:
        return max(self.min_score, min(self.max_score, float(value)))

    def convert(self, content: Dict[str, float]) -> Dict[str, float]:
        emotion_dict = {
            CN_KEY_TO_EN[cn]: self.clamp_score(content.get(cn, 0.0))
            for cn in DESIRED_VECTOR_ORDER
        }
        if all(v <= 0.0 for v in emotion_dict.values()):
            print(">> no emotions detected; using default calm/neutral voice")
            emotion_dict["calm"] = 1.0
        return emotion_dict

    def _fallback_scores(self, text: str) -> Dict[str, float]:
        tl = text.lower()
        scores = {}
        for cn, words in _FALLBACK_LEXICON.items():
            s = sum(1.0 for w in words if w in tl)
            if s > 0:
                scores[cn] = min(1.0, 0.6 + 0.2 * (s - 1))
        return scores

    def inference(self, text_input: str) -> Dict[str, float]:
        self._load()
        if self.model is None:
            content = self._fallback_scores(text_input)
        else:
            content = self._model_inference(text_input)
        # melancholic/sad swap workaround (the reference's `infer_v2.py:829-836`)
        tl = text_input.lower()
        if any(w in tl for w in MELANCHOLIC_WORDS):
            content["悲伤"], content["低落"] = (content.get("低落", 0.0),
                                              content.get("悲伤", 0.0))
        return self.convert(content)

    def prompt_ids(self, text_input: str) -> torch.Tensor:
        """The chat prompt of ``text_input`` as ids (1, P) on the device."""
        messages = [{"role": "system", "content": self.prompt},
                    {"role": "user", "content": text_input}]
        text = self.tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True, enable_thinking=False)
        return torch.tensor([self.tokenizer.encode(text)], dtype=torch.long, device=self.device)

    def _model_inference(self, text_input: str) -> Dict[str, float]:
        ids = self.prompt_ids(text_input)
        toks, lens = qwen_generate_greedy(self.model, self.qwen_cfg, ids, torch.ones_like(ids),
                                          max_new_tokens=MAX_NEW_TOKENS, dtype=self.dtype)
        out = toks[0, :int(lens[0])].tolist()
        try:  # strip the <think> section if present
            idx = len(out) - out[::-1].index(THINK_END_ID)
        except ValueError:
            idx = 0
        content = self.tokenizer.decode(out[idx:], skip_special_tokens=True)
        try:
            return json.loads(content)
        except json.JSONDecodeError:
            return {m.group(1): float(m.group(2))
                    for m in re.finditer(r'([^\s":.,]+?)"?\s*:\s*([\d.]+)', content)}
