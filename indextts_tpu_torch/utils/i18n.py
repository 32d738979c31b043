"""JSON-locale i18n (a copy of the JAX package's `indextts_tpu/utils/i18n.py`,
for the port's webui).

Locale files live in `indextts_tpu_torch/locale/<lang>.json` (byte-for-byte
copies of the JAX package's) and map SOURCE strings (zh, as in the original
IndexTTS webui) to translations. `I18nAuto(None)` / `I18nAuto("Auto")`
detect the system locale and fall back to en_US when no matching file
exists; unknown keys pass through unchanged. Users add a language by
dropping `<lang>.json` next to the shipped en_US/zh_CN files: no code
change.
"""

from __future__ import annotations

import json
import locale
import os
from typing import Dict, List

I18N_JSON_DIR: os.PathLike = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "locale")


def load_language_list(language: str) -> Dict[str, str]:
    with open(os.path.join(I18N_JSON_DIR, f"{language}.json"), "r",
              encoding="utf-8") as f:
        return json.load(f)


def scan_language_list() -> List[str]:
    return [name[:-5] for name in sorted(os.listdir(I18N_JSON_DIR))
            if name.endswith(".json")]


class I18nAuto:
    def __init__(self, language: str = None):
        if language in ("Auto", None):
            language = locale.getdefaultlocale()[0]
            # getdefaultlocale can return (None, None)
        if not language or not os.path.exists(
                os.path.join(I18N_JSON_DIR, f"{language}.json")):
            language = "en_US"
        self.language = language
        self.language_map = load_language_list(language)

    def __call__(self, key: str) -> str:
        return self.language_map.get(key, key)

    def __repr__(self) -> str:
        return "Use Language: " + self.language
