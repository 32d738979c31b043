"""Gradio WebUI for IndexTTS2 on one NVIDIA H100 (the PyTorch + CUDA port).

A copy of the JAX package's root `webui.py` that drives the port: it
imports `indextts_tpu_torch`'s presets, i18n, downloaders and `IndexTTS2`,
and nothing of JAX. Run it as ``python -m indextts_tpu_torch.webui [--fp16]``
(``--fp16``: `IndexTTS2(use_fp16=True)`); without gradio `main` returns 3
before it loads anything. The handlers, the layout, the flags and the exits
are the JAX webui's.

Behavioral reference: the original IndexTTS `webui.py` (1 221 LoC): four emotion
control modes (mode 3, text description, gated behind an EXPERIMENTAL
checkbox), generation-parameter sliders bounded by the model config, a live
segments-preview table, examples table from ``examples/cases.jsonl``
(experimental rows filtered with the checkbox), a structured glossary
add-term editor with autosave, a preset manager (save modal with preview,
details table, delete) under ``outputs/presets``, live token-count check,
zh/en i18n.

All event-handler LOGIC lives in module-level pure functions (gradio-free,
unit-tested in `tests/test_torch_webui.py` — the `cli_v2` ``tts_factory``
pattern); the gradio closures only adapt them to component updates. Gradio
import is deferred so the module is importable without it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from indextts_tpu_torch.utils import presets as preset_store

EMO_CHOICES_ALL = [
    ("与音色参考音频相同", "Same as the voice reference"),
    ("使用情感参考音频", "Use emotion reference audio"),
    ("使用情感向量控制", "Use emotion vectors"),
    ("使用情感描述文本控制", "Use emotion description text"),
]
# mode 3 (emotion from text description) is the reference's EXPERIMENTAL
# feature (webui.py:92: EMO_CHOICES_OFFICIAL = EMO_CHOICES_ALL[:-1])
EMO_CHOICES_OFFICIAL = EMO_CHOICES_ALL[:-1]
EMO_VEC_LABELS = [
    ("喜", "Happy"), ("怒", "Angry"), ("哀", "Sad"), ("惧", "Afraid"),
    ("厌恶", "Disgusted"), ("低落", "Melancholic"), ("惊喜", "Surprised"),
    ("平静", "Calm"),
]
ADVANCED_PARAM_KEYS = ("do_sample", "top_p", "top_k", "temperature",
                       "length_penalty", "num_beams", "repetition_penalty",
                       "max_mel_tokens")


class I18n:
    """UI string lookup: JSON locale files (reference tools/i18n contract,
    `indextts_tpu_torch/locale/<lang>.json`, keys are the zh source strings) with
    the inline zh/en pair as fallback — so a user-dropped locale file can
    retranslate any string without code changes."""

    def __init__(self, lang: str = "en"):
        self.zh = lang.startswith("zh")
        self.map = {}
        try:
            from indextts_tpu_torch.utils.i18n import I18nAuto

            full = {"en": "en_US", "zh": "zh_CN"}.get(lang, lang)
            self.map = I18nAuto(full).language_map
        except Exception:
            pass

    def t(self, zh: str, en: str) -> str:
        default = zh if self.zh else en
        return self.map.get(zh, default)


def load_example_cases(path: str = "examples/cases.jsonl"):
    cases = []
    if os.path.exists(path):
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    c = json.loads(line)
                except json.JSONDecodeError:
                    continue
                vec = [c.get(f"emo_vec_{i}", 0.0) for i in range(1, 9)]
                cases.append([
                    os.path.join("examples", c.get("prompt_audio", "")),
                    c.get("emo_mode", 0), c.get("text", ""),
                    *vec, c.get("emo_ref_path", None), c.get("emo_weight", 0.8),
                ])
    return cases


# ---------------------------------------------------------------------------
# pure handler logic (gradio-free, unit-testable)
# ---------------------------------------------------------------------------

def filter_example_cases(cases: Sequence, include_experimental: bool) -> List:
    """Reference `get_example_cases` (webui.py:126-131): hide rows using the
    experimental mode 3 (emotion from text) unless the experimental toggle
    is on. Case rows carry the mode at index 1 (int or resolved label)."""
    if include_experimental:
        return list(cases)
    return [c for c in cases if int(c[1]) != 3]


def experimental_choices(is_experimental: bool,
                         i18n: Optional[I18n] = None) -> List[str]:
    """Mode choices for the current experimental state (webui.py:1024-1031);
    an existing selection keeps its index — the official list is a strict
    prefix, so indices mean the same thing in both."""
    pairs = EMO_CHOICES_ALL if is_experimental else EMO_CHOICES_OFFICIAL
    zh = bool(i18n and i18n.zh)
    return [p[0] if zh else p[1] for p in pairs]


def clamp_mode_index(idx: int, is_experimental: bool) -> int:
    """Reference `on_experimental_change`: if the current mode no longer
    exists after the toggle, reset to 0."""
    n = len(EMO_CHOICES_ALL if is_experimental else EMO_CHOICES_OFFICIAL)
    return idx if 0 <= idx < n else 0


def preview_segments(tokenizer, text: str,
                     max_tokens_per_segment: int) -> List[List]:
    """Rows for the segments-preview table (reference webui.py:924-941):
    [index, joined segment text, token count] per segment at the CURRENT
    slider value — the user sees exactly how the synthesis will split."""
    if tokenizer is None or not text:
        return []
    toks = tokenizer.tokenize(text)
    segments = tokenizer.split_segments(
        toks, max_text_tokens_per_segment=int(max_tokens_per_segment))
    return [[i, "".join(s), len(s)] for i, s in enumerate(segments)]


def format_glossary_markdown(glossary: Dict, i18n: I18n) -> str:
    """Markdown table of the term glossary (reference webui.py:133-149)."""
    if not glossary:
        return i18n.t("暂无术语", "No terms yet")
    lines = [f"| {i18n.t('术语', 'Term')} | {i18n.t('中文读法', 'zh reading')} "
             f"| {i18n.t('英文读法', 'en reading')} |", "|---|---|---|"]
    for term, reading in glossary.items():
        if isinstance(reading, dict):
            zh, en = reading.get("zh", ""), reading.get("en", "")
        else:
            zh = en = str(reading)
        lines.append(f"| {term} | {zh} | {en} |")
    return "\n".join(lines)


def add_glossary_term(normalizer, term: str, reading_zh: str, reading_en: str,
                      glossary_path: Optional[str] = None,
                      i18n: Optional[I18n] = None) -> Tuple[bool, str]:
    """Structured add-term flow (reference webui.py:944-985): strip trailing
    whitespace, require a term and at least one reading, store a per-language
    dict, autosave to YAML when a path is configured. Returns (ok, message —
    the refreshed markdown table on success, the validation error otherwise).
    """
    i18n = i18n or I18n("en")
    term = (term or "").rstrip()
    zh = (reading_zh or "").rstrip()
    en = (reading_en or "").rstrip()
    if not term:
        return False, i18n.t("请输入术语", "Please enter a term")
    if not zh and not en:
        return False, i18n.t("请至少输入一种读法",
                             "Please enter at least one reading")
    if zh and en:
        reading: Dict = {"zh": zh, "en": en}
    elif zh:
        reading = {"zh": zh}
    else:
        reading = {"en": en}
    normalizer.term_glossary[term] = reading
    if glossary_path:
        try:
            normalizer.save_glossary_to_yaml(glossary_path)
        except Exception as e:  # noqa: BLE001 — surfaced to the UI
            return False, i18n.t(f"保存词汇表时出错: {e}",
                                 f"Failed to save glossary: {e}")
    return True, format_glossary_markdown(normalizer.term_glossary, i18n)


def build_infer_kwargs(emo_mode_idx: int, emo_ref_path, emo_weight: float,
                       vec: Sequence[float], emo_text: str, emo_random: bool,
                       interval_silence: int,
                       max_text_tokens_per_segment: int,
                       advanced: Dict, normalize_emo_vec=None) -> Dict:
    """gen_single's argument mapping as a pure function: mode index ->
    (emo_audio_prompt | emo_vector | use_emo_text) + the advanced sampling
    params, mirroring the reference's `gen_single` (webui.py:153-240)."""
    vec_out = None
    emo_audio = None
    use_emo_text = False
    if emo_mode_idx == 1:
        emo_audio = emo_ref_path
    elif emo_mode_idx == 2:
        vec_out = list(vec)
        if normalize_emo_vec is not None:
            vec_out = normalize_emo_vec(vec_out)
    elif emo_mode_idx == 3:
        use_emo_text = True
    kw = dict(
        emo_audio_prompt=emo_audio, emo_alpha=float(emo_weight),
        emo_vector=vec_out, use_emo_text=use_emo_text,
        emo_text=(emo_text or None), use_random=bool(emo_random),
        interval_silence=int(interval_silence),
        max_text_tokens_per_segment=int(max_text_tokens_per_segment),
        do_sample=bool(advanced["do_sample"]),
        top_p=float(advanced["top_p"]), top_k=int(advanced["top_k"]),
        temperature=float(advanced["temperature"]),
        length_penalty=float(advanced["length_penalty"]),
        num_beams=int(advanced["num_beams"]),
        repetition_penalty=float(advanced["repetition_penalty"]),
        max_mel_tokens=int(advanced["max_mel_tokens"]))
    return kw


def preset_payload(emo_mode_idx: int, emo_weight: float, vec: Sequence[float],
                   emo_text: str, emo_random: bool,
                   advanced: Dict) -> Dict:
    """The persisted preset dict — reference-parity keys
    (the original webui.py's on_preset_save: emo_control_method,
    emo_weight, emo_vector, emo_text, emo_random, advanced_params)."""
    return {
        "emo_control_method": int(emo_mode_idx),
        "emo_weight": float(emo_weight),
        "emo_vector": [float(v) for v in vec],
        "emo_text": emo_text or "",
        "emo_random": bool(emo_random),
        "advanced_params": {k: advanced[k] for k in ADVANCED_PARAM_KEYS
                            if k in advanced},
    }


def preset_to_ui(data: Optional[Dict]) -> Dict:
    """Preset dict -> UI values; accepts both the reference-parity keys and
    this repo's earlier ones (emo_mode / emo_vec). Loading a mode-3 preset
    must also flip the experimental toggle on (reference webui.py:284-289),
    surfaced via the `experimental` key."""
    data = data or {}
    mode = int(data.get("emo_control_method", data.get("emo_mode", 0)))
    vec = data.get("emo_vector", data.get("emo_vec", [0.0] * 8))
    vec = (list(vec) + [0.0] * 8)[:8]
    adv = dict(data.get("advanced_params", {}))
    return {
        "emo_mode_idx": clamp_mode_index(mode, True),
        "emo_weight": float(data.get("emo_weight", 0.8)),
        "emo_vector": vec,
        "emo_text": data.get("emo_text", "") or "",
        "emo_random": bool(data.get("emo_random", False)),
        "advanced_params": adv,
        "prompt_audio": data.get("prompt_audio") or None,
        "emo_audio": data.get("emo_audio") or None,
        "experimental": mode == 3,
    }


def format_preset_details(name: str, i18n: I18n) -> str:
    """Markdown details table for the preset-management tab (reference
    webui.py:349-392: name, emotion mode, weight, random flag, audio paths,
    vector, text, and every persisted advanced param)."""
    if not name:
        return i18n.t("请选择要管理的预设", "Select a preset to manage")
    data = preset_store.load_preset(name)
    if data is None:
        return i18n.t("预设不存在", "Preset does not exist")
    ui = preset_to_ui(data)
    idx = ui["emo_mode_idx"]
    emo_label = (experimental_choices(True, i18n)[idx]
                 if 0 <= idx < len(EMO_CHOICES_ALL)
                 else i18n.t("未知", "unknown"))
    none = i18n.t("无", "none")
    lines = [
        f"### {i18n.t('预设详情', 'Preset details')}: {name}", "",
        f"| {i18n.t('属性', 'Field')} | {i18n.t('值', 'Value')} |", "|---|---|",
        f"| {i18n.t('名称', 'Name')} | {name} |",
        f"| {i18n.t('情感控制方式', 'Emotion mode')} | {emo_label} |",
        f"| {i18n.t('情感权重', 'Emotion weight')} | {ui['emo_weight']} |",
        f"| {i18n.t('情感随机采样', 'Randomize emotion')} | "
        f"{'On' if ui['emo_random'] else 'Off'} |",
        f"| {i18n.t('音色音频', 'Voice audio')} | "
        f"`{ui['prompt_audio'] or none}` |",
        f"| {i18n.t('情感音频', 'Emotion audio')} | "
        f"`{ui['emo_audio'] or none}` |",
        "",
        f"**{i18n.t('情感向量', 'Emotion vector')}**: "
        f"`[{', '.join(str(round(v, 2)) for v in ui['emo_vector'])}]`",
        "",
        f"**{i18n.t('情感描述文本', 'Emotion text')}**: "
        f"{ui['emo_text'] or none}",
        "",
        f"**{i18n.t('高级生成参数设置', 'Advanced params')}**:", "",
    ]
    for key, value in ui["advanced_params"].items():
        lines.append(f"- `{key}`: {value}")
    return "\n".join(lines)


def format_preset_preview(name: str, payload: Dict, prompt_audio,
                          emo_audio, i18n: I18n) -> str:
    """Markdown preview for the save-confirmation modal (reference
    webui.py:420-533 `_format_preset_preview` + `open_save_preset_modal`):
    everything about to be persisted, shown BEFORE the write happens."""
    idx = clamp_mode_index(int(payload.get("emo_control_method", 0)), True)
    emo_label = experimental_choices(True, i18n)[idx]
    none = i18n.t("无", "none")
    lines = [
        f"### {i18n.t('即将保存', 'About to save')}: "
        f"{name or i18n.t('（未命名）', '(unnamed)')}", "",
        f"- {i18n.t('情感控制方式', 'Emotion mode')}: {emo_label}",
        f"- {i18n.t('情感权重', 'Emotion weight')}: "
        f"{payload.get('emo_weight', 0.8)}",
        f"- {i18n.t('情感向量', 'Emotion vector')}: "
        f"`{payload.get('emo_vector', [0.0] * 8)}`",
        f"- {i18n.t('情感描述文本', 'Emotion text')}: "
        f"{payload.get('emo_text') or none}",
        f"- {i18n.t('音色音频', 'Voice audio')}: `{prompt_audio or none}`",
        f"- {i18n.t('情感音频', 'Emotion audio')}: `{emo_audio or none}`",
    ]
    for key, value in payload.get("advanced_params", {}).items():
        lines.append(f"- `{key}`: {value}")
    if preset_store.preset_exists(name or ""):
        lines.append("")
        lines.append(f"**{i18n.t('警告：将覆盖同名预设', 'Warning: overwrites the existing preset')}**")
    return "\n".join(lines)


def refresh_preset_choices() -> Tuple[List[str], bool]:
    """Fresh dropdown choices + interactive state (reference webui.py:395-402).
    The empty first entry is the 'nothing selected' state."""
    choices = [""] + preset_store.list_presets()
    return choices, len(choices) > 1


# ---------------------------------------------------------------------------
# gradio app
# ---------------------------------------------------------------------------

def build_app(tts, i18n: I18n, example_cases):
    import gradio as gr

    max_mel_tokens_limit = tts.cfg.gpt.max_mel_tokens
    emo_choices_all = experimental_choices(True, i18n)
    glossary_path = getattr(tts, "glossary_path", None)

    def gen_single(emo_mode, prompt_audio, text, emo_ref_path, emo_weight,
                   vec1, vec2, vec3, vec4, vec5, vec6, vec7, vec8,
                   emo_text, emo_random, interval_silence,
                   max_text_tokens_per_segment,
                   do_sample, top_p, top_k, temperature, length_penalty,
                   num_beams, repetition_penalty, max_mel_tokens,
                   progress=gr.Progress()):
        if not prompt_audio:
            raise gr.Error(i18n.t("请上传音色参考音频", "Please upload a voice reference"))
        output_path = os.path.join("outputs",
                                   f"spk_{int(time.time())}.wav")
        tts.gr_progress = progress
        emo_mode_idx = (emo_choices_all.index(emo_mode)
                        if isinstance(emo_mode, str) else int(emo_mode))
        kwargs = build_infer_kwargs(
            emo_mode_idx, emo_ref_path, emo_weight,
            [vec1, vec2, vec3, vec4, vec5, vec6, vec7, vec8], emo_text,
            emo_random, interval_silence, max_text_tokens_per_segment,
            dict(do_sample=do_sample, top_p=top_p, top_k=top_k,
                 temperature=temperature, length_penalty=length_penalty,
                 num_beams=num_beams, repetition_penalty=repetition_penalty,
                 max_mel_tokens=max_mel_tokens),
            normalize_emo_vec=tts.normalize_emo_vec)
        tts.infer(spk_audio_prompt=prompt_audio, text=text,
                  output_path=output_path, verbose=False, **kwargs)
        return gr.update(value=output_path, visible=True)

    def count_tokens(text, max_tokens):
        if tts.tokenizer is None or not text:
            return gr.update(value="")
        n = len(tts.tokenizer.tokenize(text))
        warn = "" if n <= int(max_tokens) else i18n.t(
            "（将分段合成）", " (will be split into segments)")
        return gr.update(value=f"tokens: {n}{warn}")

    with gr.Blocks(title="IndexTTS-2 (H100)") as demo:
        gr.Markdown("## IndexTTS-2 — zero-shot TTS on an NVIDIA H100 (PyTorch + CUDA)")
        with gr.Tab(i18n.t("语音生成", "Synthesis")):
            with gr.Row():
                prompt_audio = gr.Audio(
                    label=i18n.t("音色参考音频", "Voice reference"), type="filepath")
                with gr.Column():
                    text_input = gr.TextArea(
                        label=i18n.t("文本", "Text"),
                        placeholder=i18n.t("请输入目标文本", "Enter target text"))
                    token_info = gr.Markdown("")
                    gen_button = gr.Button(i18n.t("生成语音", "Generate"),
                                           variant="primary")
            experimental_checkbox = gr.Checkbox(
                value=False,
                label=i18n.t("启用实验功能", "Enable experimental features"))
            emo_mode = gr.Radio(choices=experimental_choices(False, i18n),
                                value=experimental_choices(False, i18n)[0],
                                label=i18n.t("情感控制方式", "Emotion control"))
            # per-mode groups; emo_mode toggles visibility (reference webui
            # behavior: only the active mode's controls show)
            with gr.Group(visible=False) as emo_audio_group:
                emo_ref_path = gr.Audio(
                    label=i18n.t("情感参考音频", "Emotion reference"),
                    type="filepath")
            with gr.Group(visible=False) as emo_vec_group:
                vec_sliders = [
                    gr.Slider(0.0, 1.2, value=0.0, step=0.05,
                              label=(zh if i18n.zh else en))
                    for zh, en in EMO_VEC_LABELS
                ]
            with gr.Group(visible=False) as emo_text_group:
                emo_text = gr.Textbox(
                    label=i18n.t("情感描述文本", "Emotion description text"))
            with gr.Group(visible=False) as emo_weight_group:
                emo_weight = gr.Slider(0.0, 1.0, value=0.8, step=0.01,
                                       label=i18n.t("情感权重", "Emotion weight"))
                emo_random = gr.Checkbox(
                    value=False,
                    label=i18n.t("情感随机采样", "Randomize emotion match"))

            def on_mode_change(mode):
                choices = emo_choices_all
                idx = choices.index(mode) if mode in choices else 0
                return (gr.update(visible=idx == 1),  # emotion reference audio
                        gr.update(visible=idx == 2),  # emotion vectors
                        gr.update(visible=idx == 3),  # emotion text
                        gr.update(visible=idx != 0))  # weight applies to 1/2/3

            emo_mode.change(on_mode_change, inputs=[emo_mode],
                            outputs=[emo_audio_group, emo_vec_group,
                                     emo_text_group, emo_weight_group])
            with gr.Accordion(i18n.t("高级生成参数设置", "Advanced settings"),
                              open=False):
                interval_silence = gr.Slider(
                    0, 1000, value=200, step=50,
                    label=i18n.t("分段间静音(ms)", "Inter-segment silence (ms)"))
                max_text_tokens_per_segment = gr.Slider(
                    20, tts.cfg.gpt.max_text_tokens, value=120, step=2,
                    label=i18n.t("分段最大Token数", "Max tokens per segment"))
                with gr.Accordion(i18n.t("预览分句结果", "Preview segments"),
                                  open=True):
                    segments_preview = gr.Dataframe(
                        headers=[i18n.t("序号", "#"),
                                 i18n.t("分句内容", "Segment"),
                                 i18n.t("Token数", "Tokens")],
                        wrap=True)
                do_sample = gr.Checkbox(value=True, label="do_sample")
                top_p = gr.Slider(0.0, 1.0, value=0.8, step=0.01, label="top_p")
                top_k = gr.Slider(0, 100, value=30, step=1, label="top_k")
                temperature = gr.Slider(0.1, 2.0, value=0.8, step=0.05,
                                        label="temperature")
                length_penalty = gr.Number(value=0.0, label="length_penalty")
                num_beams = gr.Slider(1, 10, value=3, step=1, label="num_beams")
                repetition_penalty = gr.Number(value=10.0,
                                               label="repetition_penalty")
                max_mel_tokens = gr.Slider(50, max_mel_tokens_limit, value=1500,
                                           step=10, label="max_mel_tokens")
            output_audio = gr.Audio(label=i18n.t("生成结果", "Output"),
                                    visible=True)

            if example_cases:
                # rows carry every case field: prompt, mode, text, 8 emo-vec
                # values, emotion reference, weight. gr.Dataset (not
                # gr.Examples) so the experimental toggle can rewrite rows
                # (reference webui.py:822-838)
                def case_rows(include_experimental):
                    return [[c[0],
                             emo_choices_all[c[1]]
                             if isinstance(c[1], int) else c[1],
                             c[2], *c[3:11], c[11], c[12]]
                            for c in filter_example_cases(
                                example_cases, include_experimental)]

                example_table = gr.Dataset(
                    label="Examples", samples=case_rows(False), type="values",
                    components=[prompt_audio, emo_mode, text_input,
                                *vec_sliders, emo_ref_path, emo_weight])

                def on_example_select(evt: gr.SelectData):
                    return evt.value

                example_table.select(
                    on_example_select, None,
                    [prompt_audio, emo_mode, text_input, *vec_sliders,
                     emo_ref_path, emo_weight])
            else:
                example_table = None

            def on_experimental_change(is_exp, current_mode):
                choices = experimental_choices(bool(is_exp), i18n)
                idx = (emo_choices_all.index(current_mode)
                       if current_mode in emo_choices_all else 0)
                idx = clamp_mode_index(idx, bool(is_exp))
                updates = [gr.update(choices=choices, value=choices[idx])]
                if example_table is not None:
                    updates.append(gr.update(samples=case_rows(bool(is_exp))))
                return updates if len(updates) > 1 else updates[0]

            exp_outputs = [emo_mode] + ([example_table] if example_cases else [])
            experimental_checkbox.change(on_experimental_change,
                                         inputs=[experimental_checkbox,
                                                 emo_mode],
                                         outputs=exp_outputs)

            def on_input_text_change(text, max_tokens):
                return gr.update(
                    value=preview_segments(tts.tokenizer, text, max_tokens))

            text_input.change(count_tokens,
                              inputs=[text_input, max_text_tokens_per_segment],
                              outputs=[token_info])
            text_input.change(on_input_text_change,
                              inputs=[text_input, max_text_tokens_per_segment],
                              outputs=[segments_preview])
            max_text_tokens_per_segment.change(
                on_input_text_change,
                inputs=[text_input, max_text_tokens_per_segment],
                outputs=[segments_preview])
            gen_button.click(
                gen_single,
                inputs=[emo_mode, prompt_audio, text_input, emo_ref_path,
                        emo_weight, *vec_sliders, emo_text, emo_random,
                        interval_silence, max_text_tokens_per_segment,
                        do_sample, top_p, top_k, temperature, length_penalty,
                        num_beams, repetition_penalty, max_mel_tokens],
                outputs=[output_audio])

            # glossary editor: structured add-term flow with autosave
            # (reference webui.py:944-985) + the raw JSON editor
            with gr.Accordion(i18n.t("术语词汇表", "Glossary"), open=False):
                glossary_md = gr.Markdown(
                    format_glossary_markdown(tts.normalizer.term_glossary,
                                             i18n))
                with gr.Row():
                    term_box = gr.Textbox(label=i18n.t("术语", "Term"))
                    zh_box = gr.Textbox(label=i18n.t("中文读法", "zh reading"))
                    en_box = gr.Textbox(label=i18n.t("英文读法", "en reading"))
                add_term_btn = gr.Button(i18n.t("添加术语", "Add term"))

                def do_add_term(term, zh, en):
                    ok, msg = add_glossary_term(tts.normalizer, term, zh, en,
                                                glossary_path=glossary_path,
                                                i18n=i18n)
                    if not ok:
                        raise gr.Error(msg)
                    return (gr.update(value=msg), gr.update(value=""),
                            gr.update(value=""), gr.update(value=""))

                add_term_btn.click(do_add_term,
                                   inputs=[term_box, zh_box, en_box],
                                   outputs=[glossary_md, term_box, zh_box,
                                            en_box])
                glossary_box = gr.TextArea(
                    value=json.dumps(tts.normalizer.term_glossary,
                                     ensure_ascii=False, indent=2),
                    label=i18n.t("术语 (JSON)", "Terms (JSON)"))
                apply_glossary = gr.Button(i18n.t("应用", "Apply"))

                def do_glossary(text):
                    try:
                        tts.normalizer.term_glossary = json.loads(text or "{}")
                        tts.normalizer.enable_glossary = True
                        return (gr.update(value=text),
                                gr.update(value=format_glossary_markdown(
                                    tts.normalizer.term_glossary, i18n)))
                    except json.JSONDecodeError as e:
                        raise gr.Error(f"invalid JSON: {e}")

                apply_glossary.click(do_glossary, inputs=[glossary_box],
                                     outputs=[glossary_box, glossary_md])

        # --- preset management tab (reference webui.py:979-1020 +
        # save-modal semantics :420-533) --------------------------------
        with gr.Tab(i18n.t("预设管理", "Presets")):
            gr.Markdown(f"## {i18n.t('预设管理', 'Preset management')}")
            choices0, has0 = refresh_preset_choices()
            with gr.Row():
                preset_name = gr.Textbox(label=i18n.t("预设名称", "Preset name"))
                save_btn = gr.Button(i18n.t("保存当前设置为预设",
                                            "Save current settings"))
            # save-confirmation modal: preview first, write on confirm
            with gr.Group(visible=False) as save_modal:
                save_preview = gr.Markdown("")
                with gr.Row():
                    confirm_save_btn = gr.Button(i18n.t("确认保存", "Confirm"),
                                                 variant="primary")
                    cancel_save_btn = gr.Button(i18n.t("取消", "Cancel"))
            with gr.Row():
                load_dropdown = gr.Dropdown(
                    choices=choices0, value="", interactive=has0,
                    label=i18n.t("加载预设", "Load preset"))
                manage_dropdown = gr.Dropdown(
                    choices=choices0, value="", interactive=has0,
                    label=i18n.t("管理预设", "Manage preset"))
            with gr.Row():
                load_btn = gr.Button(i18n.t("加载", "Load"))
                refresh_btn = gr.Button(i18n.t("刷新", "Refresh"))
                delete_btn = gr.Button(i18n.t("删除", "Delete"),
                                       variant="stop")
            preset_details = gr.Markdown(format_preset_details("", i18n))

            def current_payload(mode, weight, *vecs_text_rand_adv):
                vecs = list(vecs_text_rand_adv[:8])
                etext, erand = vecs_text_rand_adv[8], vecs_text_rand_adv[9]
                adv_vals = vecs_text_rand_adv[10:]
                adv = dict(zip(ADVANCED_PARAM_KEYS, adv_vals))
                idx = (emo_choices_all.index(mode)
                       if mode in emo_choices_all else 0)
                return preset_payload(idx, weight, vecs, etext, erand, adv)

            preset_state_inputs = [emo_mode, emo_weight, *vec_sliders,
                                   emo_text, emo_random, do_sample, top_p,
                                   top_k, temperature, length_penalty,
                                   num_beams, repetition_penalty,
                                   max_mel_tokens]

            def open_save_modal(name, prompt, emo_ref, mode, weight,
                                *vecs_text_rand_adv):
                if not (name or "").strip():
                    raise gr.Error(i18n.t("预设名称不能为空", "Name required"))
                payload = current_payload(mode, weight, *vecs_text_rand_adv)
                return (gr.update(visible=True),
                        gr.update(value=format_preset_preview(
                            name, payload, prompt, emo_ref, i18n)))

            def confirm_save(name, prompt, emo_ref, mode, weight,
                             *vecs_text_rand_adv):
                payload = current_payload(mode, weight, *vecs_text_rand_adv)
                preset_store.save_preset(name, payload, prompt_audio=prompt,
                                         emo_audio=emo_ref)
                choices, has = refresh_preset_choices()
                upd = gr.update(choices=choices, value="", interactive=has)
                return gr.update(visible=False), upd, upd

            def close_save_modal():
                return gr.update(visible=False)

            save_btn.click(open_save_modal,
                           inputs=[preset_name, prompt_audio, emo_ref_path,
                                   *preset_state_inputs],
                           outputs=[save_modal, save_preview])
            confirm_save_btn.click(confirm_save,
                                   inputs=[preset_name, prompt_audio,
                                           emo_ref_path,
                                           *preset_state_inputs],
                                   outputs=[save_modal, load_dropdown,
                                            manage_dropdown])
            cancel_save_btn.click(close_save_modal, outputs=[save_modal])

            def do_load(name):
                ui = preset_to_ui(preset_store.load_preset(name))
                choices = experimental_choices(ui["experimental"] or
                                               ui["emo_mode_idx"] == 3, i18n)
                adv = ui["advanced_params"]
                return [ui["prompt_audio"], ui["emo_audio"],
                        gr.update(choices=choices,
                                  value=emo_choices_all[ui["emo_mode_idx"]]),
                        gr.update(value=ui["experimental"]),
                        ui["emo_weight"], *ui["emo_vector"], ui["emo_text"],
                        ui["emo_random"],
                        adv.get("do_sample", True), adv.get("top_p", 0.8),
                        adv.get("top_k", 30), adv.get("temperature", 0.8),
                        adv.get("length_penalty", 0.0),
                        adv.get("num_beams", 3),
                        adv.get("repetition_penalty", 10.0),
                        adv.get("max_mel_tokens", 1500)]

            load_btn.click(do_load, inputs=[load_dropdown],
                           outputs=[prompt_audio, emo_ref_path, emo_mode,
                                    experimental_checkbox, emo_weight,
                                    *vec_sliders, emo_text, emo_random,
                                    do_sample, top_p, top_k, temperature,
                                    length_penalty, num_beams,
                                    repetition_penalty, max_mel_tokens])

            def do_refresh():
                choices, has = refresh_preset_choices()
                upd = gr.update(choices=choices, value="", interactive=has)
                return upd, upd

            refresh_btn.click(do_refresh,
                              outputs=[load_dropdown, manage_dropdown])

            def do_details(name):
                return gr.update(value=format_preset_details(name, i18n))

            manage_dropdown.change(do_details, inputs=[manage_dropdown],
                                   outputs=[preset_details])

            def do_delete(name):
                if name:
                    preset_store.delete_preset(name)
                choices, has = refresh_preset_choices()
                upd = gr.update(choices=choices, value="", interactive=has)
                return (upd, upd,
                        gr.update(value=format_preset_details("", i18n)))

            delete_btn.click(do_delete, inputs=[manage_dropdown],
                             outputs=[load_dropdown, manage_dropdown,
                                      preset_details])
    return demo


def main():
    parser = argparse.ArgumentParser(description="IndexTTS-2 WebUI (NVIDIA H100)")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--model_dir", type=str, default="checkpoints")
    parser.add_argument("--fp16", action="store_true")
    parser.add_argument("--lang", type=str, default="en", choices=("en", "zh"))
    parser.add_argument("--share", action="store_true")
    args = parser.parse_args()

    try:
        import gradio  # noqa: F401
    except ImportError:
        print("ERROR: gradio is not installed (pip install gradio)",
              file=sys.stderr)
        return 3

    # model auto-download on launch (reference webui.py:34-63): fetch any
    # missing checkpoints, then example assets for the examples table
    required = ("config.yaml", "bpe.model", "gpt.pth", "s2mel.pth")
    if any(not os.path.exists(os.path.join(args.model_dir, f))
           for f in required):
        print(f">> model files missing under {args.model_dir}; downloading...")
        try:
            from indextts_tpu_torch.utils.download import snapshot_download

            snapshot_download("IndexTeam/IndexTTS-2", local_dir=args.model_dir)
        except Exception as e:
            print(f">> model download failed: {e!r}", file=sys.stderr)
            print(f"Please download the model to {args.model_dir} manually "
                  f"(indextts2 download).", file=sys.stderr)
            return 2
    try:
        from indextts_tpu_torch.utils.examples_downloader import (download_examples,
                                                                  examples_present)

        if not examples_present():
            download_examples()
    except Exception as e:
        print(f">> example download skipped: {e!r}")

    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    tts = IndexTTS2(cfg_path=os.path.join(args.model_dir, "config.yaml"),
                    model_dir=args.model_dir, use_fp16=args.fp16)
    i18n = I18n(args.lang)
    demo = build_app(tts, i18n, load_example_cases())
    demo.queue(20)
    demo.launch(server_name=args.host, server_port=args.port, share=args.share)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
