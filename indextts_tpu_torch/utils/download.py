"""Model/asset download management (a copy of the JAX package's
`indextts_tpu/utils/download.py`, for the port's CLI `download`).

Behavioral reference: the reference's `indextts/utils/model_download.py` +
`utils/network_detection.py`: auto-select HuggingFace vs ModelScope by TCP
latency probe, flat-layout aux cache under ``{model_dir}/hf_cache/``, single
file + snapshot download with hf-mirror fallback, and legacy HF-cache
migration. All network deps are optional imports (offline environments degrade
to clear errors instead of crashes).
"""

from __future__ import annotations

import logging
import os
import shutil
import socket
import time
from typing import Dict, Optional

logger = logging.getLogger("indextts_tpu_torch.download")

AUX_REPOS = {
    "w2v_bert": ("facebook/w2v-bert-2.0", "dir"),
    "semantic_codec": ("amphion/MaskGCT", "semantic_codec/model.safetensors"),
    "campplus": ("funasr/campplus", "campplus_cn_common.bin"),
    "bigvgan": ("nvidia/bigvgan_v2_22khz_80band_256x", "dir"),
}

AUX_LOCAL = {
    "w2v_bert": "w2v-bert-2.0",
    "semantic_codec": "semantic_codec_model.safetensors",
    "campplus": "campplus_cn_common.bin",
    "bigvgan": "bigvgan",
}


def _tcp_latency(host: str, port: int = 443, timeout: float = 1.5) -> Optional[float]:
    try:
        t0 = time.perf_counter()
        with socket.create_connection((host, port), timeout=timeout):
            return time.perf_counter() - t0
    except OSError:
        return None


def need_proxy() -> bool:
    """True when ModelScope is preferable (HF unreachable or much slower).

    Reference `utils/network_detection.py:30+` probes both endpoints.
    """
    hf = _tcp_latency("huggingface.co")
    ms = _tcp_latency("www.modelscope.cn")
    if hf is None:
        return ms is not None
    if ms is None:
        return False
    return hf > 3 * ms


def snapshot_download(repo_id: str, local_dir: str):
    """Auto-source snapshot download with HF -> mirror -> ModelScope fallbacks."""
    if need_proxy():
        return snapshot_from_modelscope(repo_id, local_dir)
    try:
        from huggingface_hub import snapshot_download as hf_snapshot

        return hf_snapshot(repo_id=repo_id, local_dir=local_dir)
    except Exception as e:
        logger.warning("HF download failed (%r), trying hf-mirror", e)
        try:
            os.environ.setdefault("HF_ENDPOINT", "https://hf-mirror.com")
            from huggingface_hub import snapshot_download as hf_snapshot

            return hf_snapshot(repo_id=repo_id, local_dir=local_dir)
        except Exception as e2:
            logger.warning("hf-mirror failed (%r), trying modelscope", e2)
            return snapshot_from_modelscope(repo_id, local_dir)


def snapshot_from_modelscope(repo_id: str, local_dir: str):
    from modelscope import snapshot_download as ms_snapshot  # type: ignore

    return ms_snapshot(repo_id, local_dir=local_dir)


def _download_single_file(repo_id: str, filename: str, local_path: str):
    os.makedirs(os.path.dirname(local_path), exist_ok=True)
    from huggingface_hub import hf_hub_download

    p = hf_hub_download(repo_id=repo_id, filename=filename)
    shutil.copyfile(p, local_path)
    return local_path


def ensure_models_available(model_dir: str) -> Dict[str, str]:
    """Ensure auxiliary models exist under ``{model_dir}/hf_cache/`` and return
    their paths (reference `model_download.py:142-226`). Already-present files
    are never re-downloaded (cache preservation contract)."""
    cache = os.path.join(model_dir, "hf_cache")
    os.makedirs(cache, exist_ok=True)
    paths: Dict[str, str] = {}
    for key, (repo, remote) in AUX_REPOS.items():
        local = os.path.join(cache, AUX_LOCAL[key])
        if remote == "dir":
            if not os.path.isdir(local) or not os.listdir(local):
                snapshot_download(repo, local)
        else:
            if not os.path.isfile(local):
                _download_single_file(repo, remote, local)
        paths[key] = local
    return paths
