"""The IndexTTS-1 command line on the port (counterpart of
`indextts_tpu/cli.py`):

    python -m indextts_tpu_torch.cli infer "text" -v prompt.wav -o out.wav \\
        --model_dir checkpoints [--fp16] [--fast] [--device cuda|cpu]

``infer`` takes the JAX CLI's flags, required-file checks and exit codes
and builds the port's `IndexTTS` (``--device`` defaults to the card).
``download`` needs the network, which the port does not use: it returns 1
and says where the files come from.
"""

from __future__ import annotations

import argparse
import os
import sys

REQUIRED_FILES = ("bpe.model", "gpt.pth", "config.yaml", "bigvgan_generator.pth")
MODEL_REPO_V1 = "IndexTeam/IndexTTS-1.5"


def main(argv=None, tts_factory=None) -> int:
    parser = argparse.ArgumentParser(description="IndexTTS Command Line (PyTorch + CUDA port)",
                                     prog="python -m indextts_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command")

    dl = sub.add_parser("download", help="Download model checkpoints (not in the port)")
    dl.add_argument("--model_dir", type=str, default="checkpoints")

    inf = sub.add_parser("infer", help="Synthesize speech")
    inf.add_argument("text", type=str, help="Text to be synthesized")
    inf.add_argument("-v", "--voice", type=str, required=True,
                     help="Path to the audio prompt file (wav)")
    inf.add_argument("-o", "--output_path", type=str, default="gen.wav",
                     help="Path to the output wav file")
    inf.add_argument("-c", "--config", type=str, default=None,
                     help="Path to the config file. Default: <model_dir>/config.yaml")
    inf.add_argument("--model_dir", type=str, default="checkpoints",
                     help="Path to the model directory")
    inf.add_argument("--fp16", action="store_true", default=False,
                     help="Use fp16 for inference")
    inf.add_argument("--force", action="store_true", default=False,
                     help="Force to overwrite the output file")
    inf.add_argument("--fast", action="store_true", default=False,
                     help="Use bucketed batch inference (infer_fast)")
    inf.add_argument("--device", type=str, default=None,
                     help="Device to run model on (default: cuda; or cpu)")

    args = parser.parse_args(argv)
    if args.command == "download":
        return _run_download(args)
    if args.command == "infer":
        return _run_infer(args, tts_factory)
    parser.print_help(sys.stderr)
    return 1


def _run_download(args) -> int:
    print(f"ERROR: the port does not download: fetch {MODEL_REPO_V1} "
          f"({', '.join(REQUIRED_FILES)}) into {args.model_dir} by other means "
          "(ROADMAP.md, queue 1 item 8)", file=sys.stderr)
    return 1


def _run_infer(args, tts_factory=None) -> int:
    if not args.text.strip():
        print("ERROR: text is empty", file=sys.stderr)
        return 1
    if not os.path.exists(args.voice):
        print(f"ERROR: voice file does not exist: {args.voice}", file=sys.stderr)
        return 1
    if os.path.exists(args.output_path) and not args.force:
        print(f"ERROR: output file already exists: {args.output_path} "
              f"(use --force to overwrite)", file=sys.stderr)
        return 1
    cfg_path = args.config or os.path.join(args.model_dir, "config.yaml")
    missing = [f for f in REQUIRED_FILES
               if not os.path.exists(os.path.join(args.model_dir, f))]
    if missing and tts_factory is None:
        print(f"ERROR: missing model files in {args.model_dir}: "
              f"{', '.join(missing)}", file=sys.stderr)
        return 1
    if tts_factory is None:
        from indextts_tpu_torch.pipeline.infer_v1 import IndexTTS

        tts_factory = IndexTTS
    tts = tts_factory(cfg_path=cfg_path, model_dir=args.model_dir,
                      use_fp16=args.fp16, device=args.device)
    infer_fn = tts.infer_fast if args.fast else tts.infer
    infer_fn(audio_prompt=args.voice, text=args.text, output_path=args.output_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
