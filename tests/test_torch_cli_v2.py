"""The port's IndexTTS2 CLI (`python -m indextts_tpu_torch.cli_v2`) against
the JAX package's (`indextts_tpu/cli_v2.py`).

One parametrised parity test runs both CLIs' ``main(argv, tts_factory=
recorder, stdin=...)`` over a table of argv cases drawn from
`tests/test_cli_v2*.py` (synth from each text source and with each emotion
source, the emotion conflicts and bad values, valid and invalid batch
files, batch concat, concat, init, config path / get / set, check, missing
files), each side in its own identical tree with its own
``XDG_CONFIG_HOME`` / ``XDG_DATA_HOME``: the exit codes, stdout and stderr,
the engine's constructor and ``infer`` kwargs and the files written are
equal, the tree's path aside. The one documented difference: check prints
a ``cuda:`` line where the JAX CLI prints ``tpu:``. Separately: check's
device lines and ``--device`` handling, ``download`` exiting 3 without the
hub packages (with every socket connection refused), and the module run
as ``python -m``.
"""

import io
import json
import os
import re
import socket
import subprocess
import sys
import wave
from pathlib import Path

import pytest

from indextts_tpu import cli_v2 as jcli
from indextts_tpu_torch import cli_v2 as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wav(path, seconds=0.1, sr=22050):
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(b"\x01\x00" * int(seconds * sr))


def _jl(*rows):
    return "\n".join(json.dumps(r, ensure_ascii=False) if isinstance(r, dict) else r
                     for r in rows) + "\n"


def _tree(root: Path):
    """The inputs every case sees: a model directory with every required
    resource (placeholder bytes), a voice and an emotion wav, a text file,
    batch files and a concat file."""
    model = root / "model"
    for f in jcli.REQUIRED_MODEL_FILES + jcli.REQUIRED_AUX_MODEL_FILES:
        p = model.joinpath(*f.split("/"))
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"x")
    for d in jcli.REQUIRED_MODEL_DIRS + jcli.REQUIRED_AUX_MODEL_DIRS:
        model.joinpath(*d.split("/")).mkdir(parents=True, exist_ok=True)
    partial = root / "partial"
    partial.mkdir()
    (partial / "config.yaml").write_bytes(b"x")
    _wav(root / "voice.wav")
    _wav(root / "emo.wav")
    (root / "text.txt").write_text("text from a file\n", encoding="utf-8")
    (root / "batch.jsonl").write_text(_jl(
        {"text": "first", "voice": "voice.wav", "output": "out/a.wav"},
        {"text_file": "text.txt", "voice": "voice.wav", "output": "out/b.wav",
         "emotion_text": "so sad", "emotion_weight": 0.5},
        {"text": "third", "voice": "voice.wav", "output": "out/c.wav",
         "emotion_vector": [0, 0.2, 0, 0, 0, 0, 0, 0.1]}), encoding="utf-8")
    (root / "batch_concat.jsonl").write_text(_jl(
        {"text": "one", "voice": "voice.wav", "silence_after_ms": 100},
        {"text": "two", "voice": "voice.wav", "emotion_audio": "emo.wav"}), encoding="utf-8")
    (root / "batch_auto.jsonl").write_text(_jl(
        {"text": "one", "voice": "voice.wav"},
        {"text": "two", "voice": "voice.wav", "emotion_vector": [0.1] * 8}), encoding="utf-8")
    (root / "batch_bad.jsonl").write_text(_jl(
        {"text": "hello", "voice": "voice.wav", "output": "o.wav", "bogus": True}),
        encoding="utf-8")
    (root / "batch_json.jsonl").write_text('\n["not", "an", "object"]\n', encoding="utf-8")
    (root / "batch_conflict.jsonl").write_text(_jl(
        {"text": "hello", "voice": "voice.wav", "output": "o.wav", "emotion_text": "x",
         "emotion_audio": "emo.wav"}), encoding="utf-8")
    (root / "concat.jsonl").write_text(_jl(
        {"audio": "voice.wav", "silence_after_ms": 50}, {"audio": "emo.wav"}), encoding="utf-8")
    (root / "concat_bad.jsonl").write_text(_jl({"audio": "missing.wav"}), encoding="utf-8")
    (root / "exists.wav").write_bytes(b"old")


# (argv with {R} for the tree's root, stdin text or None)
CASES = {
    "synth-text": (["synth", "--text", "hello", "--voice", "{R}/voice.wav", "--output",
                    "{R}/gen/out.wav", "--model-dir", "{R}/model"], None),
    "synth-text-file": (["synth", "--text-file", "{R}/text.txt", "--voice", "{R}/voice.wav",
                         "--output", "{R}/out.wav", "--model-dir", "{R}/model"], None),
    "synth-stdin": (["synth", "--stdin", "--voice", "{R}/voice.wav", "--output",
                     "{R}/out.wav", "--model-dir", "{R}/model"], "text from stdin\n"),
    "synth-emotion-audio": (["synth", "--text", "hi", "--voice", "{R}/voice.wav",
                             "--emotion-audio", "{R}/emo.wav", "--emotion-weight", "0.6",
                             "--output", "{R}/out.wav", "--model-dir", "{R}/model"], None),
    "synth-emotion-text": (["synth", "--text", "hi", "--voice", "{R}/voice.wav",
                            "--emotion-text", "warm and calm", "--emotion-weight", "0.7",
                            "--output", "{R}/out.wav", "--model-dir", "{R}/model"], None),
    "synth-emotion-vector": (["synth", "--text", "hi", "--voice", "{R}/voice.wav",
                              "--emotion-vector", "0.1,0,0,0,0,0,0,0.5", "--output",
                              "{R}/out.wav", "--model-dir", "{R}/model"], None),
    "synth-emotion-vector-list": (["synth", "--text", "hi", "--voice", "{R}/voice.wav",
                                   "--emotion-vector", "[0, 0.3, 0, 0, 0, 0, 0, 0]",
                                   "--output", "{R}/out.wav", "--model-dir", "{R}/model"],
                                  None),
    "synth-runtime-flags": (["synth", "--text", "hi", "--voice", "{R}/voice.wav", "--output",
                             "{R}/out.wav", "--model-dir", "{R}/model", "--device", "cpu",
                             "--fp16", "--cuda-kernel", "--no-deepspeed", "--verbose"], None),
    "synth-force": (["synth", "--text", "hi", "--voice", "{R}/voice.wav", "--output",
                     "{R}/exists.wav", "--force", "--model-dir", "{R}/model"], None),
    "synth-conflict-audio-text": (["synth", "--text", "hi", "--voice", "{R}/voice.wav",
                                   "--emotion-audio", "{R}/emo.wav", "--emotion-text", "sad",
                                   "--output", "{R}/out.wav", "--model-dir", "{R}/model"],
                                  None),
    "synth-conflict-vector-text": (["synth", "--text", "hi", "--voice", "{R}/voice.wav",
                                    "--emotion-vector", "0,0,0,0,0,0,0,1", "--emotion-text",
                                    "sad", "--output", "{R}/out.wav", "--model-dir",
                                    "{R}/model"], None),
    "synth-empty-emotion-text": (["synth", "--text", "hi", "--voice", "{R}/voice.wav",
                                  "--emotion-text", "   ", "--output", "{R}/out.wav",
                                  "--model-dir", "{R}/model"], None),
    "synth-bad-vector": (["synth", "--text", "hi", "--voice", "{R}/voice.wav",
                          "--emotion-vector", "1,2", "--output", "{R}/out.wav",
                          "--model-dir", "{R}/model"], None),
    "synth-bad-weight": (["synth", "--text", "hi", "--voice", "{R}/voice.wav",
                          "--emotion-text", "sad", "--emotion-weight", "lots", "--output",
                          "{R}/out.wav", "--model-dir", "{R}/model"], None),
    "synth-missing-emotion-audio": (["synth", "--text", "hi", "--voice", "{R}/voice.wav",
                                     "--emotion-audio", "{R}/nope.wav", "--output",
                                     "{R}/out.wav", "--model-dir", "{R}/model"], None),
    "synth-no-text": (["synth", "--voice", "{R}/voice.wav", "--output", "{R}/out.wav"], None),
    "synth-two-texts": (["synth", "--text", "hi", "--stdin", "--voice", "{R}/voice.wav",
                         "--output", "{R}/out.wav"], "x"),
    "synth-missing-text-file": (["synth", "--text-file", "{R}/nope.txt", "--voice",
                                 "{R}/voice.wav", "--output", "{R}/out.wav"], None),
    "synth-no-voice": (["synth", "--text", "hi", "--output", "{R}/out.wav"], None),
    "synth-output-exists": (["synth", "--text", "hi", "--voice", "{R}/voice.wav", "--output",
                             "{R}/exists.wav", "--model-dir", "{R}/model"], None),
    "synth-model-dir-missing": (["synth", "--text", "hi", "--voice", "{R}/voice.wav",
                                 "--output", "{R}/out.wav", "--model-dir", "{R}/nodir"], None),
    "synth-model-files-missing": (["synth", "--text", "hi", "--voice", "{R}/voice.wav",
                                   "--output", "{R}/out.wav", "--model-dir", "{R}/partial"],
                                  None),
    "batch": (["batch", "--batch-file", "{R}/batch.jsonl", "--model-dir", "{R}/model"], None),
    "batch-dry-run": (["batch", "--batch-file", "{R}/batch.jsonl", "--model-dir", "{R}/model",
                       "--dry-run"], None),
    "batch-defaults": (["batch", "--batch-file", "{R}/batch_auto.jsonl", "--model-dir",
                        "{R}/model", "--output-dir", "{R}/auto", "--output-prefix", "take",
                        "--emotion-text", "happy", "--emotion-weight", "0.9"], None),
    "batch-silence-without-concat": (["batch", "--batch-file", "{R}/batch_concat.jsonl",
                                      "--model-dir", "{R}/model", "--output-dir", "{R}/auto"],
                                     None),
    "batch-concat": (["batch", "--batch-file", "{R}/batch_concat.jsonl", "--model-dir",
                      "{R}/model", "--concat", "--output", "{R}/all.wav"], None),
    "batch-unknown-field": (["batch", "--batch-file", "{R}/batch_bad.jsonl", "--model-dir",
                             "{R}/model", "--dry-run"], None),
    "batch-not-object": (["batch", "--batch-file", "{R}/batch_json.jsonl", "--model-dir",
                          "{R}/model"], None),
    "batch-emotion-conflict": (["batch", "--batch-file", "{R}/batch_conflict.jsonl",
                                "--model-dir", "{R}/model"], None),
    "batch-concat-no-output": (["batch", "--batch-file", "{R}/batch_concat.jsonl",
                                "--model-dir", "{R}/model", "--concat"], None),
    "concat": (["concat", "--concat-file", "{R}/concat.jsonl", "--output", "{R}/joined.wav"],
               None),
    "concat-dry-run": (["concat", "--concat-file", "{R}/concat.jsonl", "--output",
                        "{R}/joined.wav", "--dry-run"], None),
    "concat-missing-audio": (["concat", "--concat-file", "{R}/concat_bad.jsonl", "--output",
                              "{R}/joined.wav"], None),
    "init": (["init", "--model-dir", "{R}/mymodels"], None),
    "init-default": (["init"], None),
    "config-path": (["config", "path"], None),
    "config-get": (["config", "get"], None),
    "config-set-bool": (["config", "set", "use_fp16", "true"], None),
    "config-set-bad-bool": (["config", "set", "use_fp16", "maybe"], None),
    "config-set-model-dir": (["config", "set", "model_dir", "{R}/elsewhere"], None),
    "config-set-device": (["config", "set", "default_device", "cpu"], None),
    "config-no-subcommand": (["config"], None),
    "check": (["check", "--model-dir", "{R}/model"], None),
    "check-device-cpu": (["check", "--model-dir", "{R}/model", "--device", "cpu"], None),
    "check-missing-dir": (["check", "--model-dir", "{R}/nodir"], None),
    "check-missing-files": (["check", "--model-dir", "{R}/partial"], None),
    "no-command": ([], None),
}


def _recorder(record):
    class Engine:
        def __init__(self, **kw):
            record.append(("init", kw))

        def infer(self, **kw):
            record.append(("infer", kw))
            _wav(Path(kw["output_path"]))
            return kw["output_path"]

    return Engine


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _norm(x, root: str):
    """Paths of the side's tree as <R>; mkdtemp's random suffix as XXXXXXXX."""
    if isinstance(x, dict):
        return {_norm(k, root): _norm(v, root) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v, root) for v in x)
    if isinstance(x, Path):
        x = str(x)
    if isinstance(x, bytes):
        try:
            return _norm(x.decode("utf-8"), root).encode("utf-8")
        except UnicodeDecodeError:
            return x
    if isinstance(x, str):
        x = x.replace(root, "<R>")
        return re.sub(r"(\.[^/]+\.wav\.)[A-Za-z0-9_]{8}", r"\1XXXXXXXX", x)
    return x


def _side(cli, root: Path, argv, stdin, monkeypatch, capsys):
    root.mkdir()
    _tree(root)
    home = root / "home"
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("XDG_CONFIG_HOME", str(home / ".config"))
    monkeypatch.setenv("XDG_DATA_HOME", str(home / ".local" / "share"))
    monkeypatch.delenv("INDEXTTS2_MODEL_DIR", raising=False)
    record = []
    capsys.readouterr()
    rc = cli.main([a.replace("{R}", str(root)) for a in argv], tts_factory=_recorder(record),
                  stdin=None if stdin is None else io.StringIO(stdin))
    out = capsys.readouterr()
    return _norm((rc, out.out, out.err, record, _files(root)), str(root))


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_the_jax_cli(case, tmp_path, monkeypatch, capsys):
    argv, stdin = CASES[case]
    j = _side(jcli, tmp_path / "jax", argv, stdin, monkeypatch, capsys)
    t = _side(tcli, tmp_path / "port", argv, stdin, monkeypatch, capsys)
    if case.startswith("check") and j[0] == 0:
        # the documented difference: the accelerator line (here unavailable
        # on both sides: no TPU, no card)
        j = (j[0], j[1].replace("tpu: unavailable", "cuda: unavailable")) + j[2:]
        assert "cuda: unavailable\ncpu: available\n" in t[1]
    assert t == j
    assert t[0] in (0, 1, 2, 3, 4)
    if case == "synth-emotion-text":
        (_, init), (_, call) = t[3]
        assert (call["use_emo_text"], call["emo_text"], call["emo_alpha"]) == \
            (True, "warm and calm", 0.7)
        assert init["cfg_path"] == "<R>/model/config.yaml" and init["device"] is None


@pytest.mark.parametrize("available,device,rc", [
    (True, None, 0), (True, "cuda", 0), (True, "cuda:1", 0), (False, "cuda", 3),
    (False, "cuda:0", 3), (False, "cpu", 0), (True, "tpu", 3)])
def test_check_reports_the_card(tmp_path, monkeypatch, capsys, available, device, rc):
    """check's device lines come from torch.cuda.is_available(); cuda and
    cuda:N ask for the card; a TPU is not a device of the port."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    root = tmp_path / "t"
    root.mkdir()
    _tree(root)
    monkeypatch.setenv("XDG_CONFIG_HOME", str(root / "cfg"))
    monkeypatch.setenv("XDG_DATA_HOME", str(root / "data"))
    argv = ["check", "--model-dir", str(root / "model")] + (["--device", device] if device else [])
    capsys.readouterr()
    assert tcli.main(argv) == rc
    out = capsys.readouterr()
    if rc == 0:
        assert out.out.endswith(f"cuda: {'available' if available else 'unavailable'}\n"
                                f"cpu: available\n")
        assert "OK: python packages" in out.out
    else:
        assert out.err == f"ERROR: requested device is not available: {device}\n"
    assert tcli._detect_devices() == {"cpu": True, "cuda": available}


@pytest.mark.parametrize("source", ["auto", "huggingface", "modelscope"])
def test_download_exits_3_without_the_hub_packages(tmp_path, monkeypatch, capsys, source):
    """No hub package importable and every socket connection refused: both
    CLIs exit 3 with the same message and persist nothing."""
    def refuse(*a, **k):
        raise OSError("network disabled in this test")

    monkeypatch.setattr(socket, "create_connection", refuse)
    for mod in ("huggingface_hub", "modelscope"):
        monkeypatch.setitem(sys.modules, mod, None)
    monkeypatch.setenv("HF_ENDPOINT", "http://localhost:9")
    outs = []
    for cli, side in ((jcli, "jax"), (tcli, "port")):
        root = tmp_path / side
        root.mkdir()
        monkeypatch.setenv("XDG_CONFIG_HOME", str(root / "cfg"))
        monkeypatch.setenv("XDG_DATA_HOME", str(root / "data"))
        capsys.readouterr()
        rc = cli.main(["download", "--source", source, "--model-dir", str(root / "m")])
        out = capsys.readouterr()
        outs.append(_norm((rc, out.out, out.err), str(root)))
        assert not cli._config_path().exists()
    assert outs[1] == outs[0]
    rc, stdout, stderr = outs[1]
    assert (rc, stdout) == (3, "")
    assert f"ERROR: runtime unavailable for {source} download source" in stderr


def test_runs_as_a_module(tmp_path):
    """``python -m indextts_tpu_torch.cli_v2``: check on a missing model
    directory exits 2 with the resource help."""
    env = dict(os.environ, XDG_CONFIG_HOME=str(tmp_path / "cfg"),
               XDG_DATA_HOME=str(tmp_path / "data"))
    env.pop("INDEXTTS2_MODEL_DIR", None)
    res = subprocess.run([sys.executable, "-m", "indextts_tpu_torch.cli_v2", "check",
                          "--model-dir", str(tmp_path / "none")], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert res.returncode == 2, res.stderr
    assert "ERROR: model directory does not exist" in res.stderr
    assert "Missing resources" in res.stderr
