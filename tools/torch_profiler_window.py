"""Does a `torch.profiler` window keep every device record of what ran in it?

Runs ``--launches`` small elementwise kernels in the active step of a
profiler schedule, as chip_smoke.py's `profile_decode` runs a decode,
``--repeats`` times each way:

- bare: the warm-up step launches nothing and the active step holds only the
  run, so its first and last kernels sit at the window's edges;
- padded: chip_smoke.py's pads (`_spin_pad`) lead and trail the run inside
  the window, as in `profile_decode`.

Prints, for each window, how many of the run's kernels the profiler
recorded, and for the padded one how many pad records it kept. Run from
the repository root on a machine with a CUDA card:

    python3 tools/torch_profiler_window.py [--launches 600000] [--repeats 2]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def window(n: int, padded: bool) -> str:
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    x = torch.zeros(16, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        if padded:
            cs._spin_pad(launches=cs.PROFILE_WARMUP_LAUNCHES, seconds=0)
        prof.step()
        if padded:
            cs._spin_pad(launches=0)
        for _ in range(n):
            x.add_(1)
        torch.cuda.synchronize()
        if padded:
            cs._spin_pad()
        prof.step()
    pads: list = []
    by, spans = cs.device_records(prof, pads=pads)
    line = f"recorded {sum(c for c, _ in by.values())} of the run's {n} kernels"
    return line + (f"; {cs.pads_kept(pads, spans)}" if padded else "")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--launches", type=int, default=600000)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profiler_window: CUDA is not available", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}", flush=True)
    for padded in (False, True):
        for r in range(args.repeats):
            print(f"{'padded' if padded else 'bare'} window {r}, {args.launches} launches: "
                  f"{window(args.launches, padded)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
