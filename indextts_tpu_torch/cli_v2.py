"""The IndexTTS2 command line on the PyTorch port: a copy of the JAX
package's `indextts_tpu/cli_v2.py` (the reference CLI's contract) that drives
`indextts_tpu_torch.pipeline.infer_v2.IndexTTS2`.

    python -m indextts_tpu_torch.cli_v2 synth --text "..." --voice prompt.wav \
        --emotion-text "..." --output out.wav --model-dir checkpoints

Same surface as the JAX CLI: subcommands init/config/download/check/synth/batch/concat, exit
codes 0-4, persistent TOML config with CLI > env > persisted precedence,
JSONL batch manifests with strict validation, WAV concat with format matching
and temp-file atomicity, and the dependency-injected ``tts_factory`` for
model-free testing.

Differences from the JAX CLI, and only these: the required packages are
torch/numpy/indextts_tpu_torch; the device check reports cuda/cpu (from
`torch.cuda.is_available()`, ``cuda`` and ``cuda:N`` asking for the card);
`download` uses the port's copy of the download helpers
(`utils/download.py`); the engine is the port's `IndexTTS2`, on the card
unless ``--device`` says otherwise. The runtime flags are accepted (and
persisted) as in the JAX CLI: deepspeed and cuda-kernel are ignored by the
engine, ``--fp16`` reaches it as ``use_fp16=True`` (the port's float16
pipeline, as the JAX engine takes it), and ``batch --mesh N``
reaches it as ``mesh=N``, the dp=N mesh (cuda:0 .. cuda:N-1, or N CPU
ranks with ``--device cpu``). The
persisted ``config.toml`` (path, keys and precedence), the messages and
the exit codes are the JAX CLI's.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import math
import os
import re
import shutil
import sys
import tempfile
import wave
from pathlib import Path

# exit-code contract (pinned by the reference CLI and its test suite)
(EXIT_SUCCESS, EXIT_INPUT_ERROR, EXIT_MISSING_RESOURCE,
 EXIT_RUNTIME_UNAVAILABLE, EXIT_INFERENCE_ERROR) = range(5)

REQUIRED_MODEL_FILES = (
    "config.yaml", "bpe.model", "gpt.pth", "s2mel.pth",
    "wav2vec2bert_stats.pt", "feat1.pt", "feat2.pt",
)
REQUIRED_MODEL_DIRS = ("qwen0.6bemo4-merge",)
REQUIRED_AUX_MODEL_FILES = (
    "hf_cache/semantic_codec_model.safetensors",
    "hf_cache/campplus_cn_common.bin",
    "hf_cache/bigvgan/config.json",
    "hf_cache/bigvgan/bigvgan_generator.pt",
)
REQUIRED_AUX_MODEL_DIRS = ("hf_cache/w2v-bert-2.0",)
MODEL_REPO_ID = "IndexTeam/IndexTTS-2"
REQUIRED_PACKAGES = ("torch", "numpy", "indextts_tpu_torch")
PERSISTED_CONFIG_KEYS = (
    "model_dir", "default_device", "use_fp16", "use_deepspeed", "use_cuda_kernel",
)


class InputValidationError(ValueError):
    pass


class _Fail(Exception):
    """Contract failure: carries the stderr message + process exit code.

    The subcommand bodies below are written as straight-line validators that
    `_require(...)` their way through the contract; the dispatcher prints and
    maps to the exit code in one place.
    """

    def __init__(self, message, exit_code):
        super().__init__(message)
        self.message = message
        self.exit_code = exit_code


def _require(cond, message, exit_code=EXIT_INPUT_ERROR):
    if not cond:
        raise _Fail(f"ERROR: {message}", exit_code)


class _ExitCodedError(ValueError):
    """Validation error that knows which process exit code it maps to."""

    def __init__(self, message, exit_code):
        super().__init__(message)
        self.exit_code = exit_code


class BatchFileError(_ExitCodedError):
    pass


class ConcatFileError(_ExitCodedError):
    pass


class ConcatExecutionError(RuntimeError):
    """Concat synthesis failed; carries any secondary cleanup failure."""

    def __init__(self, message, cleanup_error=None):
        super().__init__(message)
        self.cleanup_error = cleanup_error


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def main(argv=None, tts_factory=None, stdin=None):
    parser = _build_parser()
    args = parser.parse_args(argv)
    dispatch = {
        "init": lambda: _run_init(args),
        "config": lambda: _run_config(args),
        "download": lambda: _run_download(args),
        "check": lambda: _run_check(args),
        "synth": lambda: _run_synth(args, tts_factory=tts_factory, stdin=stdin),
        "batch": lambda: _run_batch(args, tts_factory=tts_factory),
        "concat": lambda: _run_concat(args),
    }
    handler = dispatch.get(args.command)
    if handler is None:
        parser.print_help(sys.stderr)
        return EXIT_INPUT_ERROR
    return handler()


def _build_parser():
    parser = argparse.ArgumentParser(prog="indextts2",
                                     description="IndexTTS2 command line")
    sub = parser.add_subparsers(dest="command")

    init = sub.add_parser("init", help="Create persistent IndexTTS2 CLI state "
                                       "without downloading model resources")
    init.add_argument("--model-dir", default=None,
                      help="Persist a model resource directory")

    config = sub.add_parser("config",
                            help="Show or update persistent IndexTTS2 CLI configuration")
    csub = config.add_subparsers(dest="config_command")
    csub.add_parser("path", help="Print the persistent configuration file path")
    csub.add_parser("get", help="Print the current persistent configuration")
    cset = csub.add_parser("set", help="Persist one configuration value")
    cset.add_argument("key", choices=PERSISTED_CONFIG_KEYS)
    cset.add_argument("value")

    download = sub.add_parser("download", help="Download IndexTTS2 model resources")
    download.add_argument("--source", choices=("huggingface", "modelscope", "auto"),
                          default="auto",
                          help="Model download source (default: auto-detect based on network)")
    download.add_argument("--model-dir", default=None,
                          help="Path to the IndexTTS2 model resource directory")
    download.add_argument("--no-save", action="store_true",
                          help="Do not persist --model-dir after a successful download")

    check = sub.add_parser("check", help="Check local IndexTTS2 prerequisites "
                                         "without loading model weights")
    check.add_argument("--model-dir", default=None,
                       help="Path to the IndexTTS2 model directory")
    check.add_argument("--device", default=None,
                       help="Required runtime device, e.g. cpu or cuda")

    batch = sub.add_parser("batch", help="Validate a batch file and run batch synthesis")
    batch.add_argument("--batch-file", required=True,
                       help="Path to the JSON Lines batch file")
    batch.add_argument("--model-dir", default=None)
    batch.add_argument("--dry-run", action="store_true",
                       help="Validate the batch file without loading model weights")
    batch.add_argument("--force", action="store_true",
                       help="Overwrite output if it exists")
    batch.add_argument("--output-dir",
                       help="Directory for automatically named independent WAV outputs")
    batch.add_argument("--output-prefix",
                       help="Filename prefix for automatically named independent WAV outputs")
    batch.add_argument("--concat", action="store_true",
                       help="Generate one concatenated batch output")
    batch.add_argument("--output", help="Path to write concatenated batch WAV audio")
    batch.add_argument("--keep-temp", action="store_true",
                       help="Keep internal batch concat temporary files")
    batch.add_argument("--mesh", type=int, default=None, metavar="N",
                       help="Shard batch segments across N devices "
                            "(a data-parallel mesh)")
    _add_runtime_args(batch)
    batch.add_argument("--voice", help="Default speaker reference audio for every batch task")
    batch.add_argument("--emotion-audio", help="Default emotion reference audio for every batch task")
    batch.add_argument("--emotion-text", help="Default emotion description text for every batch task")
    batch.add_argument("--emotion-vector",
                       help="Default comma-separated 8-dimensional emotion vector")
    batch.add_argument("--emotion-weight", default="1.0",
                       help="Default emotion weight mapped to IndexTTS2 emo_alpha")

    concat = sub.add_parser("concat", help="Validate an audio concat file")
    concat.add_argument("--concat-file", required=True,
                        help="Path to the JSON Lines concat file")
    concat.add_argument("--output", required=True,
                        help="Path to write concatenated WAV audio")
    concat.add_argument("--force", action="store_true")
    concat.add_argument("--dry-run", action="store_true",
                        help="Validate the concat file without creating output audio")

    synth = sub.add_parser("synth", help="Synthesize one text input with IndexTTS2")
    synth.add_argument("--text", help="Text to synthesize")
    synth.add_argument("--text-file", help="UTF-8 text file to synthesize")
    synth.add_argument("--stdin", action="store_true",
                       help="Read text from standard input")
    synth.add_argument("--voice", help="Path to the speaker reference audio")
    synth.add_argument("--emotion-audio", help="Path to the emotion reference audio")
    synth.add_argument("--emotion-text", help="Emotion description text")
    synth.add_argument("--emotion-vector",
                       help="Comma-separated 8-dimensional emotion vector")
    synth.add_argument("--emotion-weight", default="1.0",
                       help="Emotion weight mapped to IndexTTS2 emo_alpha")
    synth.add_argument("--output", help="Path to write generated audio")
    synth.add_argument("--force", action="store_true",
                       help="Overwrite output if it exists")
    synth.add_argument("--model-dir", default=None)
    _add_runtime_args(synth)
    return parser


def _add_runtime_args(p):
    p.add_argument("--device", default=None, help="Runtime device")
    p.add_argument("--fp16", action=argparse.BooleanOptionalAction, default=None,
                   help="Use FP16 inference")
    p.add_argument("--deepspeed", action=argparse.BooleanOptionalAction,
                   default=None, help="Use DeepSpeed (ignored)")
    p.add_argument("--cuda-kernel", action=argparse.BooleanOptionalAction,
                   default=None, help="Use CUDA kernel (ignored: the port always runs its kernels)")
    p.add_argument("--verbose", action="store_true",
                   help="Show verbose inference output")


# ---------------------------------------------------------------------------
# persistent config (TOML-subset, platform paths)
# ---------------------------------------------------------------------------

def _platform_root(env_var, *home_fallback):
    """Platform config/data root: $env_var if set, else ~/<fallback...>."""
    root = os.environ.get(env_var) if env_var else None
    return Path(root) if root else Path.home().joinpath(*home_fallback)


def _config_path():
    roots = {
        "win32": ("APPDATA", ("AppData", "Roaming"), ("IndexTTS",)),
        "darwin": (None, ("Library", "Application Support"), ("IndexTTS",)),
    }
    env_var, fallback, leaf = roots.get(
        sys.platform, ("XDG_CONFIG_HOME", (".config",), ("indextts",)))
    return _platform_root(env_var, *fallback).joinpath(*leaf, "config.toml")


def _default_model_dir():
    roots = {
        "win32": ("LOCALAPPDATA", ("AppData", "Local"), ("IndexTTS",)),
        "darwin": (None, ("Library", "Application Support"), ("IndexTTS",)),
    }
    env_var, fallback, leaf = roots.get(
        sys.platform, ("XDG_DATA_HOME", (".local", "share"), ("indextts",)))
    return _platform_root(env_var, *fallback).joinpath(
        *leaf, "models", "IndexTTS-2")


def _load_persisted_config():
    path = _config_path()
    if not path.is_file():
        return {}
    config = {}
    for raw in path.read_text(encoding="utf-8").splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, value = [p.strip() for p in line.split("=", 1)]
        if key not in PERSISTED_CONFIG_KEYS:
            continue
        if value in {"true", "false"}:
            config[key] = value == "true"
        elif value.startswith('"') and value.endswith('"'):
            config[key] = re.sub(r'\\(["\\])', r"\1", value[1:-1])
    return config


def _save_persisted_config(config):
    _config_path().write_text(_format_persisted_config(config), encoding="utf-8")


def _toml_value(value):
    if isinstance(value, bool):
        return str(value).lower()
    quoted = str(value).replace("\\", "\\\\").replace('"', '\\"')
    return f'"{quoted}"'


def _format_persisted_config(config):
    lines = [f"{key} = {_toml_value(config[key])}"
             for key in PERSISTED_CONFIG_KEYS
             if config.get(key) is not None]
    return "\n".join(lines) + ("\n" if lines else "")


def _normalize_persisted_path(path_value):
    path = Path(path_value).expanduser()
    if not path.is_absolute():
        path = Path.cwd() / path
    return path.resolve(strict=False).as_posix()


def _parse_config_bool(value):
    v = value.strip().lower()
    return True if v == "true" else False if v == "false" else None


def _ensure_user_state(config=None):
    config = _load_persisted_config() if config is None else config
    model_dir = Path(config.get("model_dir") or _default_model_dir())
    config["model_dir"] = model_dir.as_posix()
    for d in (_config_path().parent, model_dir):
        d.mkdir(parents=True, exist_ok=True)
    _save_persisted_config(config)


def _resolve_model_dir(model_dir_arg=None):
    """Precedence: CLI arg > $INDEXTTS2_MODEL_DIR > persisted > default."""
    candidates = (model_dir_arg, os.environ.get("INDEXTTS2_MODEL_DIR") or None,
                  _load_persisted_config().get("model_dir") or None)
    chosen = next((c for c in candidates if c is not None), None)
    if chosen is None:
        return _default_model_dir().resolve(strict=False)
    return Path(chosen).expanduser().resolve(strict=False)


def _resolve_runtime_options(args):
    config = _load_persisted_config()
    return argparse.Namespace(
        device=args.device if args.device is not None else config.get("default_device"),
        fp16=args.fp16 if args.fp16 is not None else bool(config.get("use_fp16", False)),
        deepspeed=(args.deepspeed if args.deepspeed is not None
                   else bool(config.get("use_deepspeed", False))),
        cuda_kernel=(args.cuda_kernel if args.cuda_kernel is not None
                     else bool(config.get("use_cuda_kernel", False))),
    )


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def _persist_config_update(**updates):
    """Merge updates into the persisted TOML and write it back."""
    config = _load_persisted_config()
    config.update(updates)
    _config_path().parent.mkdir(parents=True, exist_ok=True)
    _save_persisted_config(config)
    return config


def _run_init(args):
    override = (_normalize_persisted_path(args.model_dir)
                if args.model_dir is not None else None)
    config = _load_persisted_config()
    model_dir = (override or config.get("model_dir")
                 or _default_model_dir().as_posix())
    config["model_dir"] = model_dir
    _ensure_user_state(config)
    for line in (f"Config: {_config_path()}",
                 f"Model directory: {Path(model_dir)}"):
        print(line)
    return EXIT_SUCCESS


def _config_set_handlers():
    """Per-key (normalize, echo) handlers for `config set`; a normalizer
    returning None means the value failed to parse."""
    def bool_norm(v):
        return _parse_config_bool(v)

    return {
        "model_dir": (lambda v: _normalize_persisted_path(v),
                      lambda v: str(Path(v))),
        "default_device": (lambda v: v, lambda v: v),
        "use_fp16": (bool_norm, lambda v: str(v).lower()),
        "use_deepspeed": (bool_norm, lambda v: str(v).lower()),
        "use_cuda_kernel": (bool_norm, lambda v: str(v).lower()),
    }


def _run_config(args):
    sub = args.config_command
    if sub == "path":
        print(_config_path())
    elif sub == "get":
        print(_format_persisted_config(_load_persisted_config()), end="")
    elif sub == "set":
        normalize, echo = _config_set_handlers()[args.key]
        value = normalize(args.value)
        if value is None:
            print(f"ERROR: {args.key} must be true or false", file=sys.stderr)
            return EXIT_INPUT_ERROR
        _persist_config_update(**{args.key: value})
        print(f"{args.key} = {echo(value)}")
    else:
        print("ERROR: config requires a subcommand: path, get or set",
              file=sys.stderr)
        return EXIT_INPUT_ERROR
    return EXIT_SUCCESS


def _run_download(args):
    model_dir = _resolve_model_dir(args.model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    try:
        _download_model_resources(args.source, model_dir)
    except (ImportError, OSError) as exc:
        for line in (
                f"ERROR: runtime unavailable for {args.source} download "
                f"source: {exc}",
                f"Install download support with: pip install "
                f"{_download_support_package(args.source)}"):
            print(line, file=sys.stderr)
        return EXIT_RUNTIME_UNAVAILABLE

    if _report_missing_model_resources(model_dir) is not None:
        return EXIT_MISSING_RESOURCE

    persist = args.model_dir is not None and not args.no_save
    if persist:
        _persist_config_update(
            model_dir=_normalize_persisted_path(args.model_dir))
    print(f"Downloaded model resources to: {model_dir}")
    return EXIT_SUCCESS


def _download_model_resources(source, model_dir):
    from indextts_tpu_torch.utils import download as dl

    if source == "auto":
        dl.snapshot_download(MODEL_REPO_ID, local_dir=str(model_dir))
    elif source == "modelscope":
        dl.snapshot_from_modelscope(MODEL_REPO_ID, str(model_dir))
    else:
        from huggingface_hub import snapshot_download

        snapshot_download(repo_id=MODEL_REPO_ID, local_dir=str(model_dir))
    if _missing_primary_model_resources(model_dir):
        return
    dl.ensure_models_available(str(model_dir))


_DOWNLOAD_SUPPORT = {"auto": "huggingface_hub modelscope",
                     "huggingface": "huggingface_hub",
                     "modelscope": "modelscope"}


def _download_support_package(source):
    return _DOWNLOAD_SUPPORT.get(source, "modelscope")


def _run_check(args):
    _ensure_user_state()
    model_dir = _resolve_model_dir(args.model_dir)
    if _report_missing_model_resources(model_dir) is not None:
        return EXIT_MISSING_RESOURCE

    missing = []
    for package in REQUIRED_PACKAGES:
        try:
            importlib.import_module(package)
        except (ImportError, OSError):
            missing.append(package)
    if missing:
        print(f"ERROR: missing required Python packages: {', '.join(missing)}",
              file=sys.stderr)
        return EXIT_RUNTIME_UNAVAILABLE

    devices = _detect_devices()
    if args.device and not devices.get(_device_family(args.device), False):
        print(f"ERROR: requested device is not available: {args.device}",
              file=sys.stderr)
        return EXIT_RUNTIME_UNAVAILABLE

    print(f"Checking model directory: {model_dir}")
    print(f"OK: model directory {model_dir}")
    print("OK: required model files")
    print("OK: python packages")
    for device in ("cuda", "cpu"):
        status = "available" if devices.get(device) else "unavailable"
        print(f"{device}: {status}")
    return EXIT_SUCCESS


def _detect_devices():
    devices = {"cpu": True, "cuda": False}
    try:
        import torch

        devices["cuda"] = torch.cuda.is_available()
    except ImportError:
        pass
    return devices


def _device_family(device):
    if device == "cuda" or device.startswith("cuda:"):
        return "cuda"
    if device == "cpu":
        return "cpu"
    return device


def _validated_synth_request(args, stdin):
    """Contract validation for `synth`; raises _Fail with the pinned message
    + exit code at the first violation, returns the assembled request."""
    _require(_text_source_count(args) == 1,
             "provide exactly one text source: --text, --text-file or --stdin")
    if args.text_file:
        _require(Path(args.text_file).is_file(),
                 f"text file does not exist: {args.text_file}",
                 EXIT_MISSING_RESOURCE)
    text = _read_synth_text(args, stdin)
    _require(bool(text), "text is empty")
    _require(bool(args.voice), "--voice is required", EXIT_MISSING_RESOURCE)
    voice_path = Path(args.voice)
    _require(voice_path.is_file(),
             f"voice reference audio does not exist: {voice_path}",
             EXIT_MISSING_RESOURCE)
    conflict = _emotion_conflict_error(args)
    if conflict is not None:
        raise _Fail(conflict, EXIT_INPUT_ERROR)
    emotion_vector = None
    if args.emotion_vector is not None:
        try:
            emotion_vector = _parse_emotion_vector(args.emotion_vector)
        except InputValidationError as exc:
            raise _Fail(f"ERROR: {exc}", EXIT_INPUT_ERROR)
    if args.emotion_text is not None:
        _require(bool(args.emotion_text.strip()),
                 "--emotion-text must not be empty")
    emotion_path = (Path(args.emotion_audio)
                    if args.emotion_audio is not None else None)
    if emotion_path is not None:
        _require(emotion_path.is_file(),
                 f"emotion reference audio does not exist: {emotion_path}",
                 EXIT_MISSING_RESOURCE)
    try:
        emotion_weight = float(args.emotion_weight)
    except ValueError:
        raise _Fail(f"ERROR: --emotion-weight must be a float: "
                    f"{args.emotion_weight}", EXIT_INPUT_ERROR)
    _require(bool(args.output), "--output is required")
    output_path = Path(args.output)
    _require(args.force or not output_path.exists(),
             f"output file already exists: {output_path}")
    return argparse.Namespace(
        text=text, voice_path=voice_path, output_path=output_path,
        emotion_path=emotion_path, emotion_vector=emotion_vector,
        emotion_weight=emotion_weight, emotion_text=args.emotion_text)


def _engine_factory(model_dir, tts_factory):
    """Resolve the TTS factory; injection keeps tests model-free (reference
    `cli_v2.py` contract). Loader ImportError/OSError -> _Fail exit 3;
    errors from *calling* the factory stay inference errors (exit 4)."""
    if tts_factory is not None:
        return tts_factory
    try:
        return _load_indextts2(model_dir)
    except (ImportError, OSError) as exc:
        raise _Fail(f"ERROR: runtime unavailable: {exc}",
                    EXIT_RUNTIME_UNAVAILABLE)


def _make_engine(factory, model_dir, runtime, verbose, extra=None):
    with _synth_stdout_context(verbose):
        return factory(
            cfg_path=str(model_dir / "config.yaml"),
            model_dir=str(model_dir),
            use_fp16=runtime.fp16,
            device=runtime.device,
            use_cuda_kernel=runtime.cuda_kernel,
            use_deepspeed=runtime.deepspeed,
            **(extra or {}),
        )


def _emotion_infer_kwargs(emotion_path, emotion_text, emotion_vector,
                          emotion_weight):
    kw = {}
    if emotion_path is not None:
        kw.update(emo_audio_prompt=str(emotion_path))
    if emotion_text is not None:
        kw.update(use_emo_text=True, emo_text=emotion_text)
    if emotion_vector is not None:
        kw.update(emo_vector=emotion_vector)
    if kw:
        kw["emo_alpha"] = emotion_weight
    return kw


def _run_synth(args, tts_factory=None, stdin=None):
    try:
        req = _validated_synth_request(args, stdin)
    except _Fail as fail:
        print(fail.message, file=sys.stderr)
        return fail.exit_code
    _ensure_user_state()
    model_dir = _resolve_model_dir(args.model_dir)
    runtime = _resolve_runtime_options(args)
    if _report_missing_model_resources(model_dir) is not None:
        return EXIT_MISSING_RESOURCE
    req.output_path.parent.mkdir(parents=True, exist_ok=True)
    try:
        factory = _engine_factory(model_dir, tts_factory)
    except _Fail as fail:
        print(fail.message, file=sys.stderr)
        return fail.exit_code
    try:
        tts = _make_engine(factory, model_dir, runtime, args.verbose)
        with _synth_stdout_context(args.verbose):
            tts.infer(spk_audio_prompt=str(req.voice_path), text=req.text,
                      output_path=str(req.output_path), verbose=args.verbose,
                      **_emotion_infer_kwargs(req.emotion_path,
                                              req.emotion_text,
                                              req.emotion_vector,
                                              req.emotion_weight))
    except Exception as exc:
        print(f"ERROR: inference failed: {exc}", file=sys.stderr)
        return EXIT_INFERENCE_ERROR
    print(f"Generated: {req.output_path}")
    return EXIT_SUCCESS


def _run_batch(args, tts_factory=None):
    try:
        defaults = _validate_batch_defaults(args)
        output_config = _validate_batch_output_config(args)
        tasks = _load_batch_tasks(Path(args.batch_file), force=args.force,
                                  defaults=defaults, output_config=output_config)
    except BatchFileError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return exc.exit_code

    _ensure_user_state()
    model_dir = _resolve_model_dir(args.model_dir)
    runtime = _resolve_runtime_options(args)
    if _report_missing_model_resources(model_dir) is not None:
        return EXIT_MISSING_RESOURCE
    if args.dry_run:
        if output_config["mode"] == "concat":
            print(f"Batch concat OK: {len(tasks)} tasks")
        else:
            print(f"Batch file OK: {len(tasks)} tasks")
        return EXIT_SUCCESS
    try:
        factory = _engine_factory(model_dir, tts_factory)
    except _Fail as fail:
        print(fail.message, file=sys.stderr)
        return fail.exit_code
    verbose = getattr(args, "verbose", False)
    mesh = getattr(args, "mesh", None)
    try:
        tts = _make_engine(factory, model_dir, runtime, verbose,
                           extra={"mesh": mesh} if mesh else None)
    except Exception as exc:
        print(f"ERROR: inference failed: {exc}", file=sys.stderr)
        return EXIT_INFERENCE_ERROR

    if output_config["mode"] == "concat":
        return _run_batch_concat(args, tasks, tts, verbose,
                                 output_config["output_path"])

    for task in tasks:
        output_path = task["output_path"]
        output_path.parent.mkdir(parents=True, exist_ok=True)
        try:
            _synthesize_task(tts, task, output_path, verbose)
        except Exception as exc:
            _print_task_failure(task, exc)
            return EXIT_INFERENCE_ERROR
        print(f"Generated: {output_path}")
    print(f"Batch complete: {len(tasks)} tasks generated")
    return EXIT_SUCCESS


def _synthesize_task(tts, task, output_path, verbose):
    """One manifest line -> one WAV (shared by per-file batch and concat)."""
    with _synth_stdout_context(verbose):
        tts.infer(spk_audio_prompt=str(task["voice_path"]),
                  text=task["text"], output_path=str(output_path),
                  verbose=verbose, **task["emotion_kwargs"])


def _print_task_failure(task, exc):
    print(f"ERROR: batch file line {task['line_number']} inference "
          f"failed: {exc}", file=sys.stderr)


def _run_batch_concat(args, tasks, tts, verbose, output_path):
    temp_dir = None
    try:
        output_path.parent.mkdir(parents=True, exist_ok=True)
        temp_dir = Path(tempfile.mkdtemp(prefix=f".{output_path.name}.",
                                         dir=output_path.parent))
        segments = []
        expected_format = None
        expected_line = None
        for index, task in enumerate(tasks, start=1):
            segment_path = temp_dir / f"{index:04d}.wav"
            try:
                _synthesize_task(tts, task, segment_path, verbose)
                audio_format = _read_concat_wav_format(segment_path,
                                                       task["line_number"])
                if expected_format is None:
                    expected_format = audio_format
                    expected_line = task["line_number"]
                elif audio_format != expected_format:
                    raise ConcatFileError(
                        f"generated WAV format does not match baseline "
                        f"line {expected_line}", EXIT_INFERENCE_ERROR)
            except Exception as exc:
                _print_task_failure(task, exc)
                _cleanup_after_failure(temp_dir, args.keep_temp)
                return EXIT_INFERENCE_ERROR
            segments.append({
                "line_number": task["line_number"], "audio_path": segment_path,
                "silence_after_ms": task["silence_after_ms"],
                "format": audio_format,
            })
        try:
            _concatenate_wav_segments(segments, output_path)
        except ConcatExecutionError as exc:
            print(f"ERROR: concat failed: {exc}", file=sys.stderr)
            if exc.cleanup_error is not None:
                print(f"WARNING: cleanup failed: {exc.cleanup_error}", file=sys.stderr)
            _cleanup_after_failure(temp_dir, args.keep_temp)
            return EXIT_INFERENCE_ERROR
        if args.keep_temp:
            print(f"Generated: {output_path}")
            print(f"Temp dir: {temp_dir}")
        else:
            try:
                shutil.rmtree(temp_dir)
            except OSError as exc:
                print(f"ERROR: cleanup failed: {exc}", file=sys.stderr)
                return EXIT_INFERENCE_ERROR
            print(f"Generated: {output_path}")
        return EXIT_SUCCESS
    except Exception as exc:
        print(f"ERROR: batch concat failed: {exc}", file=sys.stderr)
        _cleanup_after_failure(temp_dir, args.keep_temp)
        return EXIT_INFERENCE_ERROR


def _cleanup_after_failure(temp_dir, keep_temp):
    if keep_temp:
        if temp_dir is not None:
            print(f"Temp dir: {temp_dir}", file=sys.stderr)
        return
    if temp_dir is not None:
        try:
            shutil.rmtree(temp_dir)
        except OSError as exc:
            print(f"WARNING: cleanup failed: {exc}", file=sys.stderr)


def _run_concat(args):
    try:
        output_path = _resolve_command_path(args.output)
        segments = _load_concat_segments(_resolve_command_path(args.concat_file),
                                         output_path, force=args.force)
    except ConcatFileError as exc:
        print(f"ERROR: {exc}", file=sys.stderr)
        return exc.exit_code
    if args.dry_run:
        print(f"Concat file OK: {len(segments)} segments")
        return EXIT_SUCCESS
    try:
        _concatenate_wav_segments(segments, output_path)
    except ConcatExecutionError as exc:
        print(f"ERROR: concat failed: {exc}", file=sys.stderr)
        if exc.cleanup_error is not None:
            print(f"WARNING: cleanup failed: {exc.cleanup_error}",
                  file=sys.stderr)
        return EXIT_INFERENCE_ERROR
    print(f"Generated: {output_path}")
    return EXIT_SUCCESS


# ---------------------------------------------------------------------------
# synth/batch helpers
# ---------------------------------------------------------------------------

def _text_source_count(args):
    return sum((args.text is not None, args.text_file is not None, args.stdin))


def _emotion_source_count(args):
    return sum((args.emotion_audio is not None, args.emotion_text is not None,
                args.emotion_vector is not None))


def _emotion_conflict_error(args):
    if _emotion_source_count(args) <= 1:
        return None
    if (args.emotion_vector is None and args.emotion_audio is not None
            and args.emotion_text is not None):
        return "ERROR: --emotion-audio and --emotion-text are mutually exclusive"
    return ("ERROR: --emotion-vector, --emotion-audio and --emotion-text are "
            "mutually exclusive")


def _read_synth_text(args, stdin):
    if args.stdin:
        raw = (stdin or sys.stdin).read()
    elif args.text_file:
        raw = Path(args.text_file).read_text(encoding="utf-8")
    else:
        raw = args.text
    return raw.strip()


def _validate_batch_defaults(args):
    conflict = _emotion_conflict_error(args)
    if conflict is not None:
        raise BatchFileError(_strip_error_prefix(conflict), EXIT_INPUT_ERROR)
    try:
        emotion_weight = _parse_emotion_weight(args.emotion_weight, "--emotion-weight")
    except InputValidationError as exc:
        raise BatchFileError(str(exc), EXIT_INPUT_ERROR) from exc

    voice_path = None
    if args.voice is not None:
        voice_path = Path(args.voice)
        if not voice_path.is_file():
            raise BatchFileError(
                f"voice reference audio does not exist: {voice_path}",
                EXIT_MISSING_RESOURCE)

    emotion_source = None
    if args.emotion_audio is not None:
        emotion_path = Path(args.emotion_audio)
        if not emotion_path.is_file():
            raise BatchFileError(
                f"emotion reference audio does not exist: {emotion_path}",
                EXIT_MISSING_RESOURCE)
        emotion_source = ("emotion_audio", emotion_path)
    elif args.emotion_text is not None:
        if not args.emotion_text.strip():
            raise BatchFileError("--emotion-text must not be empty", EXIT_INPUT_ERROR)
        emotion_source = ("emotion_text", args.emotion_text)
    elif args.emotion_vector is not None:
        try:
            emotion_source = ("emotion_vector",
                              _parse_emotion_vector(args.emotion_vector))
        except InputValidationError as exc:
            raise BatchFileError(str(exc), EXIT_INPUT_ERROR) from exc

    return {"voice_path": voice_path, "emotion_source": emotion_source,
            "emotion_weight": emotion_weight}


def _validate_batch_output_config(args):
    if args.concat:
        if args.output_dir is not None:
            raise BatchFileError("--concat cannot be used with --output-dir",
                                 EXIT_INPUT_ERROR)
        if args.output_prefix is not None:
            raise BatchFileError("--concat cannot be used with --output-prefix",
                                 EXIT_INPUT_ERROR)
        if args.output is None:
            raise BatchFileError("--output is required with --concat",
                                 EXIT_INPUT_ERROR)
        output_path = _resolve_command_path(args.output)
        if not _has_wav_extension(output_path):
            raise BatchFileError(f"--output must be a .wav file: {output_path}",
                                 EXIT_INPUT_ERROR)
        _reject_output_parent_conflicts(output_path, BatchFileError)
        return {"mode": "concat", "output_path": output_path}
    if args.output is not None:
        raise BatchFileError("--output is only valid with --concat",
                             EXIT_INPUT_ERROR)
    if args.keep_temp:
        raise BatchFileError("--keep-temp requires --concat", EXIT_INPUT_ERROR)
    if args.output_prefix is not None and args.output_dir is None:
        raise BatchFileError("--output-prefix requires --output-dir",
                             EXIT_INPUT_ERROR)
    if args.output_prefix is not None:
        _validate_batch_output_prefix(args.output_prefix)
    if args.output_dir is None:
        return {"mode": "row"}
    return {"mode": "auto", "output_dir": _resolve_command_path(args.output_dir),
            "output_prefix": args.output_prefix}


def _validate_batch_output_prefix(output_prefix):
    if "/" in output_prefix or "\\" in output_prefix:
        raise BatchFileError("--output-prefix must not contain path separators",
                             EXIT_INPUT_ERROR)
    if Path(output_prefix).suffix:
        raise BatchFileError("--output-prefix must not include a file extension",
                             EXIT_INPUT_ERROR)
    if not output_prefix.strip():
        raise BatchFileError("--output-prefix must not be empty", EXIT_INPUT_ERROR)


def _strip_error_prefix(message):
    return message[len("ERROR: "):] if message.startswith("ERROR: ") else message


BATCH_ALLOWED_FIELDS = {
    "output", "text", "text_file", "voice", "emotion_audio", "emotion_text",
    "emotion_vector", "emotion_weight", "silence_after_ms",
}


def _load_batch_tasks(batch_file, force=False, defaults=None, output_config=None):
    if not batch_file.is_file():
        raise BatchFileError(f"batch file does not exist: {batch_file}",
                             EXIT_MISSING_RESOURCE)
    if defaults is None:
        defaults = {"voice_path": None, "emotion_source": None, "emotion_weight": 1.0}
    if output_config is None:
        output_config = {"mode": "row"}
    batch_dir = batch_file.parent
    tasks = []
    outputs = {}
    for line_number, raw in enumerate(
            batch_file.read_text(encoding="utf-8").splitlines(), start=1):
        if not raw.strip():
            continue
        text_path = None
        try:
            task = json.loads(raw)
        except json.JSONDecodeError as exc:
            raise BatchFileError(
                f"batch file line {line_number} is not valid JSON: {exc.msg}",
                EXIT_INPUT_ERROR) from exc
        if not isinstance(task, dict):
            raise BatchFileError(
                f"batch file line {line_number} must be a JSON object",
                EXIT_INPUT_ERROR)
        unknown = sorted(set(task) - BATCH_ALLOWED_FIELDS)
        if unknown:
            raise BatchFileError(
                f"batch file line {line_number} has unknown fields: "
                f"{', '.join(unknown)}", EXIT_INPUT_ERROR)
        if "silence_after_ms" in task and output_config["mode"] != "concat":
            raise BatchFileError(
                f"batch file line {line_number} field 'silence_after_ms' is "
                f"only valid with --concat", EXIT_INPUT_ERROR)
        silence_after_ms = _parse_silence_after_ms(task, line_number, "batch",
                                                   BatchFileError)

        n_text = sum(k in task for k in ("text", "text_file"))
        if n_text != 1:
            raise BatchFileError(
                f"batch file line {line_number} must provide exactly one text "
                f"source: text or text_file", EXIT_INPUT_ERROR)
        if "text" in task:
            if not isinstance(task["text"], str):
                raise BatchFileError(
                    f"batch file line {line_number} field 'text' must be a string",
                    EXIT_INPUT_ERROR)
            text = task["text"].strip()
            if not text:
                raise BatchFileError(
                    f"batch file line {line_number} text is empty", EXIT_INPUT_ERROR)
        else:
            text_file = _require_string(task, "text_file", line_number, "batch",
                                        BatchFileError)
            text_path = _resolve_relative(batch_dir, text_file)
            if not text_path.is_file():
                raise BatchFileError(
                    f"batch file line {line_number} text file does not exist: "
                    f"{text_path}", EXIT_MISSING_RESOURCE)
            text = text_path.read_text(encoding="utf-8").strip()
            if not text:
                raise BatchFileError(
                    f"batch file line {line_number} text is empty", EXIT_INPUT_ERROR)

        if "voice" in task:
            voice_path = _resolve_relative(
                batch_dir, _require_string(task, "voice", line_number, "batch",
                                           BatchFileError))
        else:
            voice_path = defaults["voice_path"]
        if voice_path is None:
            raise BatchFileError(
                f"batch file line {line_number} missing required field: voice",
                EXIT_INPUT_ERROR)
        if not voice_path.is_file():
            raise BatchFileError(
                f"batch file line {line_number} voice reference audio does not "
                f"exist: {voice_path}", EXIT_MISSING_RESOURCE)

        emotion_kwargs = _batch_emotion_kwargs(task, batch_dir, line_number, defaults)
        output_path = _batch_task_output_path(task, batch_dir, line_number,
                                              len(tasks) + 1, output_config)
        protected = [batch_file, voice_path]
        if text_path is not None:
            protected.append(text_path)
        if emotion_kwargs.get("emo_audio_prompt"):
            protected.append(Path(emotion_kwargs["emo_audio_prompt"]))
        if output_config["mode"] == "auto":
            _reject_output_input_conflicts(output_path, line_number, protected)
            _reject_output_parent_conflicts(output_path, BatchFileError)
        if output_config["mode"] == "concat":
            _reject_output_input_conflicts(output_path, line_number, protected)
        else:
            key = str(output_path.resolve(strict=False))
            if key in outputs:
                raise BatchFileError(
                    f"batch file line {line_number} has duplicate output path: "
                    f"{output_path}", EXIT_INPUT_ERROR)
            outputs[key] = line_number
            if output_path.exists() and not force:
                raise BatchFileError(
                    f"batch file line {line_number} output file already exists: "
                    f"{output_path}", EXIT_INPUT_ERROR)
        tasks.append({
            "line_number": line_number, "text": text, "voice_path": voice_path,
            "output_path": output_path, "emotion_kwargs": emotion_kwargs,
            "silence_after_ms": silence_after_ms,
        })
    if output_config["mode"] == "concat":
        if not tasks and (_normalized_path_key(output_config["output_path"])
                          == _normalized_path_key(batch_file)):
            raise BatchFileError(
                f"generated output conflicts with protected input path: "
                f"{batch_file}", EXIT_INPUT_ERROR)
        if output_config["output_path"].exists() and not force:
            raise BatchFileError(
                f"output file already exists: {output_config['output_path']}",
                EXIT_INPUT_ERROR)
    return tasks


def _reject_output_input_conflicts(output_path, line_number, protected_paths):
    key = _normalized_path_key(output_path)
    for p in protected_paths:
        if key == _normalized_path_key(p):
            raise BatchFileError(
                f"batch file line {line_number} generated output conflicts "
                f"with protected input path: {p}", EXIT_INPUT_ERROR)


def _reject_output_parent_conflicts(output_path, error_cls):
    parent = output_path.parent
    existing = parent
    while not existing.exists():
        if existing.parent == existing:
            break
        existing = existing.parent
    if existing.exists() and not existing.is_dir():
        raise error_cls(
            f"output parent path cannot be created because a file exists: "
            f"{existing}", EXIT_INPUT_ERROR)


def _batch_task_output_path(task, batch_dir, line_number, task_number, output_config):
    value = task.get("output")
    if output_config["mode"] == "row":
        if value is None:
            raise BatchFileError(
                f"batch file line {line_number} missing required field: output",
                EXIT_INPUT_ERROR)
        return _resolve_relative(
            batch_dir, _require_string(task, "output", line_number, "batch",
                                       BatchFileError))
    if output_config["mode"] == "concat":
        if value is not None:
            raise BatchFileError(
                f"batch file line {line_number} field 'output' is not allowed "
                f"with --concat", EXIT_INPUT_ERROR)
        return output_config["output_path"]
    if value is not None:
        raise BatchFileError(
            f"batch file line {line_number} field 'output' is not allowed "
            f"with --output-dir", EXIT_INPUT_ERROR)
    stem = f"{task_number:04d}"
    if output_config["output_prefix"]:
        stem = f"{output_config['output_prefix']}-{stem}"
    return output_config["output_dir"] / f"{stem}.wav"


def _batch_emotion_kwargs(task, batch_dir, line_number, defaults):
    row_fields = [f for f in ("emotion_audio", "emotion_text", "emotion_vector")
                  if f in task]
    if len(row_fields) > 1:
        raise BatchFileError(
            f"batch file line {line_number} emotion_audio, emotion_text and "
            f"emotion_vector are mutually exclusive", EXIT_INPUT_ERROR)
    if "emotion_weight" in task:
        try:
            emotion_weight = _parse_emotion_weight(
                task["emotion_weight"],
                f"batch file line {line_number} field 'emotion_weight'")
        except InputValidationError as exc:
            raise BatchFileError(str(exc), EXIT_INPUT_ERROR) from exc
    else:
        emotion_weight = defaults["emotion_weight"]

    if row_fields:
        field = row_fields[0]
        if field == "emotion_audio":
            path = _resolve_relative(batch_dir,
                                     _require_string(task, field, line_number,
                                                     "batch", BatchFileError))
            if not path.is_file():
                raise BatchFileError(
                    f"batch file line {line_number} emotion reference audio "
                    f"does not exist: {path}", EXIT_MISSING_RESOURCE)
            source = ("emotion_audio", path)
        elif field == "emotion_text":
            source = ("emotion_text",
                      _require_string(task, field, line_number, "batch",
                                      BatchFileError))
        else:
            try:
                source = ("emotion_vector", _parse_emotion_vector(
                    task[field],
                    f"batch file line {line_number} field 'emotion_vector'"))
            except InputValidationError as exc:
                raise BatchFileError(str(exc), EXIT_INPUT_ERROR) from exc
    else:
        source = defaults["emotion_source"]

    if source is None:
        if "emotion_weight" in task:
            raise BatchFileError(
                f"batch file line {line_number} field 'emotion_weight' requires "
                f"an emotion source", EXIT_INPUT_ERROR)
        return {}
    name, value = source
    if name == "emotion_audio":
        return {"emo_audio_prompt": str(value), "emo_alpha": emotion_weight}
    if name == "emotion_text":
        return {"use_emo_text": True, "emo_text": value, "emo_alpha": emotion_weight}
    return {"emo_vector": value, "emo_alpha": emotion_weight}


def _parse_silence_after_ms(obj, line_number, kind, error_cls):
    if "silence_after_ms" not in obj:
        return 0
    value = obj["silence_after_ms"]
    if isinstance(value, bool) or not isinstance(value, int) or value < 0:
        raise error_cls(
            f"{kind} file line {line_number} field 'silence_after_ms' must be "
            f"a non-negative integer", EXIT_INPUT_ERROR)
    return value


def _require_string(obj, field, line_number, kind, error_cls):
    if field not in obj:
        raise error_cls(
            f"{kind} file line {line_number} missing required field: {field}",
            EXIT_INPUT_ERROR)
    value = obj[field]
    if not isinstance(value, str):
        raise error_cls(
            f"{kind} file line {line_number} field '{field}' must be a string",
            EXIT_INPUT_ERROR)
    if not value.strip():
        raise error_cls(
            f"{kind} file line {line_number} field '{field}' must not be empty",
            EXIT_INPUT_ERROR)
    return value


def _resolve_relative(base_dir, path_value):
    path = Path(path_value)
    return path if path.is_absolute() else base_dir / path


def _resolve_command_path(path_value):
    path = Path(path_value)
    return path if path.is_absolute() else Path.cwd() / path


def _has_wav_extension(path):
    return path.suffix.lower() == ".wav"


def _normalized_path_key(path):
    return str(path.resolve(strict=False)).casefold()


# ---------------------------------------------------------------------------
# concat
# ---------------------------------------------------------------------------

CONCAT_ALLOWED_FIELDS = {"audio", "silence_after_ms"}


def _load_concat_segments(concat_file, output_path, force=False):
    if not concat_file.is_file():
        raise ConcatFileError(f"concat file does not exist: {concat_file}",
                              EXIT_MISSING_RESOURCE)
    if _normalized_path_key(output_path) == _normalized_path_key(concat_file):
        raise ConcatFileError("--output must not be the same path as --concat-file",
                              EXIT_INPUT_ERROR)
    if not _has_wav_extension(output_path):
        raise ConcatFileError(f"--output must be a .wav file: {output_path}",
                              EXIT_INPUT_ERROR)
    _reject_output_parent_conflicts(output_path, ConcatFileError)

    concat_dir = concat_file.parent
    segments = []
    expected_format = None
    expected_line = None
    for line_number, raw in enumerate(
            concat_file.read_text(encoding="utf-8").splitlines(), start=1):
        if not raw.strip():
            continue
        try:
            segment = json.loads(raw)
        except json.JSONDecodeError as exc:
            raise ConcatFileError(
                f"concat file line {line_number} is not valid JSON: {exc.msg}",
                EXIT_INPUT_ERROR) from exc
        if not isinstance(segment, dict):
            raise ConcatFileError(
                f"concat file line {line_number} must be a JSON object",
                EXIT_INPUT_ERROR)
        unknown = sorted(set(segment) - CONCAT_ALLOWED_FIELDS)
        if unknown:
            raise ConcatFileError(
                f"concat file line {line_number} has unknown fields: "
                f"{', '.join(unknown)}", EXIT_INPUT_ERROR)
        audio_path = _resolve_relative(
            concat_dir, _require_string(segment, "audio", line_number, "concat",
                                        ConcatFileError))
        if not _has_wav_extension(audio_path):
            raise ConcatFileError(
                f"concat file line {line_number} field 'audio' must be a .wav "
                f"file: {audio_path}", EXIT_INPUT_ERROR)
        silence_after_ms = _parse_silence_after_ms(segment, line_number,
                                                   "concat", ConcatFileError)
        audio_format = _read_concat_wav_format(audio_path, line_number)
        if expected_format is None:
            expected_format, expected_line = audio_format, line_number
        elif audio_format != expected_format:
            raise ConcatFileError(
                f"concat file line {line_number} WAV format does not match "
                f"baseline line {expected_line}", EXIT_INPUT_ERROR)
        segments.append({
            "line_number": line_number, "audio_path": audio_path,
            "silence_after_ms": silence_after_ms, "format": audio_format,
        })
    if not segments:
        raise ConcatFileError("concat file must contain at least one segment",
                              EXIT_INPUT_ERROR)
    key = _normalized_path_key(output_path)
    for segment in segments:
        if key == _normalized_path_key(segment["audio_path"]):
            raise ConcatFileError(
                f"concat file line {segment['line_number']} audio conflicts "
                f"with --output: {segment['audio_path']}", EXIT_INPUT_ERROR)
    if output_path.exists() and not force:
        raise ConcatFileError(f"output file already exists: {output_path}",
                              EXIT_INPUT_ERROR)
    return segments


def _read_concat_wav_format(audio_path, line_number):
    if not audio_path.is_file():
        raise ConcatFileError(
            f"concat file line {line_number} audio file does not exist: "
            f"{audio_path}", EXIT_MISSING_RESOURCE)
    try:
        with wave.open(str(audio_path), "rb") as wav_file:
            audio_format = (wav_file.getframerate(), wav_file.getnchannels(),
                            wav_file.getsampwidth())
            frame_count = wav_file.getnframes()
    except (wave.Error, EOFError, OSError) as exc:
        raise ConcatFileError(
            f"concat file line {line_number} audio file is not a readable WAV: "
            f"{audio_path}", EXIT_INPUT_ERROR) from exc
    if frame_count <= 0:
        raise ConcatFileError(
            f"concat file line {line_number} audio file is empty: {audio_path}",
            EXIT_INPUT_ERROR)
    return audio_format


def _concatenate_wav_segments(segments, output_path):
    temp_path = None
    try:
        output_path.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(prefix=f".{output_path.name}.",
                                         suffix=".wav", dir=output_path.parent,
                                         delete=False) as tf:
            temp_path = Path(tf.name)
        frame_rate, channels, sample_width = segments[0]["format"]
        with wave.open(str(temp_path), "wb") as out:
            out.setnchannels(channels)
            out.setsampwidth(sample_width)
            out.setframerate(frame_rate)
            for segment in segments:
                with wave.open(str(segment["audio_path"]), "rb") as inp:
                    out.writeframes(inp.readframes(inp.getnframes()))
                silence_frames = frame_rate * segment["silence_after_ms"] // 1000
                if silence_frames:
                    out.writeframes(b"\0" * channels * sample_width * silence_frames)
        os.replace(temp_path, output_path)
        temp_path = None
    except Exception as exc:
        cleanup_error = None
        if temp_path is not None:
            try:
                temp_path.unlink(missing_ok=True)
            except OSError as cleanup_exc:
                cleanup_error = cleanup_exc
        raise ConcatExecutionError(str(exc), cleanup_error=cleanup_error) from exc


# ---------------------------------------------------------------------------
# validation helpers
# ---------------------------------------------------------------------------

def _emotion_vector_parts(value, label):
    """Split an emotion vector argument (comma string / bracketed string /
    JSON list) into raw entries, validating emptiness and entry types."""
    def fail(reason):
        raise InputValidationError(f"{label} {reason}")

    if isinstance(value, str):
        body = value.strip()
        if body[:1] == "[" and body[-1:] == "]":
            body = body[1:-1]
        if not body.strip():
            fail("must not be empty")
        return [p.strip() for p in body.split(",")]
    if isinstance(value, list):
        if not value:
            fail("must not be empty")
        if any(isinstance(p, bool) for p in value):
            fail("entries must be numeric")
        return value
    fail("must be a string or JSON array")


def _parse_emotion_vector(value, label="--emotion-vector"):
    parts = _emotion_vector_parts(value, label)
    try:
        vector = [float(p) for p in parts]
    except (TypeError, ValueError) as exc:
        raise InputValidationError(f"{label} entries must be numeric") from exc
    checks = (
        (len(vector) != 8,
         f"must contain exactly 8 values; got {len(vector)}"),
        (any(not math.isfinite(v) or not 0.0 <= v <= 1.0 for v in vector),
         "values must be between 0.0 and 1.0"),
        (sum(vector) > 0.8, f"sum must be <= 0.8; got {sum(vector):g}"),
    )
    for bad, reason in checks:
        if bad:
            raise InputValidationError(f"{label} {reason}")
    return vector


def _parse_emotion_weight(value, label):
    if not isinstance(value, bool):
        try:
            return float(value)
        except (TypeError, ValueError):
            pass
    raise InputValidationError(f"{label} must be a float: {value}")


def _report_missing_model_resources(model_dir):
    missing_files = _missing_model_files(model_dir)
    if missing_files is None:
        error = f"model directory does not exist: {model_dir}"
        summary = "model directory does not exist"
    elif missing_files:
        summary = ", ".join(missing_files)
        error = f"missing required model files: {summary}"
    else:
        return None
    for line in (f"ERROR: {error}",) + _model_resource_help(model_dir, summary):
        print(line, file=sys.stderr)
    return EXIT_MISSING_RESOURCE


def _model_resource_help(model_dir, missing_summary):
    return (
        f"Model directory: {model_dir}",
        f"Missing resources: {missing_summary}",
        "Download with HuggingFace:",
        f'  huggingface-cli download {MODEL_REPO_ID} --local-dir "{model_dir}"',
        "Download with ModelScope:",
        f'  modelscope download --model {MODEL_REPO_ID} --local_dir "{model_dir}"',
        "Persist a different model resource directory:",
        f"  indextts2 config set model_dir {model_dir}",
        "Hint: rerun indextts2 download or choose a different model resource "
        "directory.",
    )


def _missing_model_files(model_dir):
    if not model_dir.is_dir():
        return None
    missing = [f for f in REQUIRED_MODEL_FILES if not (model_dir / f).is_file()]
    missing += [d for d in REQUIRED_MODEL_DIRS if not (model_dir / d).is_dir()]
    missing += [f for f in REQUIRED_AUX_MODEL_FILES
                if not model_dir.joinpath(*f.split("/")).is_file()]
    missing += [d for d in REQUIRED_AUX_MODEL_DIRS
                if not model_dir.joinpath(*d.split("/")).is_dir()]
    return missing


def _missing_primary_model_resources(model_dir):
    missing = [f for f in REQUIRED_MODEL_FILES if not (model_dir / f).is_file()]
    missing += [d for d in REQUIRED_MODEL_DIRS if not (model_dir / d).is_dir()]
    return missing


def _load_indextts2(model_dir=None):
    if model_dir is not None:
        # aux HF models (w2v-bert etc.) resolve from the model resource dir,
        # not a stale user-level cache (reference cli_v2.py:1469)
        os.environ["HF_HUB_CACHE"] = str(Path(model_dir) / "hf_cache")
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    return IndexTTS2


def _synth_stdout_context(verbose):
    """Engine chatter goes to stdout only under --verbose."""
    return (contextlib.nullcontext() if verbose
            else contextlib.redirect_stdout(io.StringIO()))


if __name__ == "__main__":
    raise SystemExit(main())
