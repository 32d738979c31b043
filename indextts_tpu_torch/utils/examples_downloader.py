"""Example/test audio downloader (a copy of the JAX package's
`indextts_tpu/utils/examples_downloader.py`, for the port's webui).

Fetches example prompt wavs + cases.jsonl from the HF Space or the
ModelScope studio, skipping files already present. Without a network (or
without the hub packages) each file's fetch fails, is reported and skipped;
the webui catches whatever else is raised and goes on without examples.
"""

from __future__ import annotations

import os
from typing import List, Optional

HF_SPACE = "IndexTeam/IndexTTS-2-Demo"
MS_STUDIO = "IndexTeam/IndexTTS-2-Demo"

EXAMPLE_FILES = ["cases.jsonl"] + [f"voice_{i:02d}.wav" for i in range(1, 13)] \
    + [f"emo_{name}.wav" for name in ("sad", "hate")]


def examples_present(examples_dir: str = "examples") -> bool:
    return os.path.exists(os.path.join(examples_dir, "cases.jsonl"))


def download_examples(examples_dir: str = "examples",
                      source: str = "auto") -> List[str]:
    """Download example assets; returns the list of files fetched."""
    from indextts_tpu_torch.utils.download import need_proxy

    os.makedirs(examples_dir, exist_ok=True)
    fetched = []
    use_modelscope = source == "modelscope" or (source == "auto" and need_proxy())
    for fname in EXAMPLE_FILES:
        dst = os.path.join(examples_dir, fname)
        if os.path.exists(dst):
            continue
        try:
            if use_modelscope:
                from modelscope.hub.file_download import (  # type: ignore
                    model_file_download)

                p = model_file_download(MS_STUDIO, file_path=f"examples/{fname}")
            else:
                from huggingface_hub import hf_hub_download

                p = hf_hub_download(repo_id=HF_SPACE, repo_type="space",
                                    filename=f"examples/{fname}")
            import shutil

            shutil.copyfile(p, dst)
            fetched.append(fname)
        except Exception as e:  # degrade-and-continue, as the JAX package's
            print(f">> failed to fetch example {fname}: {e!r}")
    return fetched
