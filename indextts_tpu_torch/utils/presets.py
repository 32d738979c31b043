"""WebUI preset management (a copy of the JAX package's
`indextts_tpu/utils/presets.py`, for the port's webui).

Presets live under ``outputs/presets/<name>/preset.json`` with audio files
copied in, sanitized directory names, and relative->absolute audio path
resolution on load: the JAX package's store layout and names, so a preset
saved by either webui loads in the other. ``presets_root`` is injectable for
testing.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Dict, List, Optional

PRESET_VERSION = "1.0"
PRESETS_DIRNAME = "outputs/presets"
_presets_root_override: Optional[Path] = None


def set_presets_root(path: Optional[str]) -> None:
    global _presets_root_override
    _presets_root_override = Path(path) if path else None


def get_presets_dir() -> Path:
    if _presets_root_override is not None:
        path = _presets_root_override
    else:
        path = Path.cwd() / PRESETS_DIRNAME
    path.mkdir(parents=True, exist_ok=True)
    return path


def safe_preset_name(name: str) -> str:
    """Filesystem-safe preset directory name (format pinned by the preset
    dir layout: path separators / shell metacharacters / whitespace -> _)."""
    cleaned = re.sub(r"\s+", "_",
                     re.sub(r'[\\/:*?"<>|]+', "_", name.strip()))
    return cleaned.strip("._") or "untitled"


def list_presets() -> List[str]:
    d = get_presets_dir()
    if not d.exists():
        return []
    return sorted(p.name for p in d.iterdir()
                  if p.is_dir() and (p / "preset.json").is_file())


def _preset_dir(name: str) -> Path:
    base = get_presets_dir()
    return base / safe_preset_name(name)


def _copy_audio(src: Optional[str], dst_dir: Path, dst_name: str) -> Optional[str]:
    if not src:
        return None
    src_path = Path(src)
    if not src_path.exists():
        return None
    dst_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy2(src_path, dst_dir / dst_name)
    return dst_name


def save_preset(name: str, data: Dict, prompt_audio: Optional[str] = None,
                emo_audio: Optional[str] = None) -> None:
    name = safe_preset_name(name)
    d = _preset_dir(name)
    d.mkdir(parents=True, exist_ok=True)
    prompt_rel = _copy_audio(prompt_audio, d, "prompt.wav")
    emo_rel = _copy_audio(emo_audio, d, "emo_ref.wav")
    payload = {"version": PRESET_VERSION, **data,
               "prompt_audio": prompt_rel or "", "emo_audio": emo_rel or ""}
    with open(d / "preset.json", "w", encoding="utf-8") as f:
        json.dump(payload, f, ensure_ascii=False, indent=2)


def load_preset(name: str) -> Optional[Dict]:
    d = _preset_dir(name)
    pf = d / "preset.json"
    if not pf.exists():
        return None
    with open(pf, "r", encoding="utf-8") as f:
        data = json.load(f)
    if data.get("prompt_audio"):
        data["prompt_audio"] = str(d / data["prompt_audio"])
    if data.get("emo_audio"):
        data["emo_audio"] = str(d / data["emo_audio"])
    return data


def delete_preset(name: str) -> bool:
    d = _preset_dir(name)
    if not d.exists():
        return False
    shutil.rmtree(d)
    return True


def preset_exists(name: str) -> bool:
    return _preset_dir(name).exists()
