"""Device times of the port's weight-only GEMV kernel (`csrc/int8_gemv.cu`):
K7a `int8_matvec` and the int4 GEMV at K1's four projection shapes (M=3
decode rows, D=1280; qkv also at M=1), K7b `int8_mlp`, the int4 MLP and K1
(`fused_decode_step`, chip_smoke.py's case), each as the median and range of
5 CUDA-graph replays (`chip_smoke.graph_ms`), beside `F.linear` on the bf16
weight.

``--root DIR`` imports the package and chip_smoke.py from another checkout
(e.g. the parent commit unpacked with `git archive` into a git-ignored
directory), so two versions can be timed on one card in turns:

    python3 tools/torch_gemv_bench.py --root build/parent
    python3 tools/torch_gemv_bench.py

Prints one JSON line per reading and the card's name and power limit.
"""

import argparse
import json
import os
import sys
import time

REPS = 5
SHAPES = (("qkv", 3, 3840, 1280), ("attn-proj", 3, 1280, 1280), ("fc", 3, 5120, 1280),
          ("mlp-proj", 3, 1280, 5120), ("qkv-m1", 1, 3840, 1280))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_gemv_bench: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from indextts_tpu_torch.ops import cuda, int8

    card = cs.card_line()
    t0 = time.perf_counter()
    cuda.build()
    print(f"card: {card}; root {args.root}; build {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2)

    def spread(fn):
        xs = sorted(cs.graph_ms(fn) for _ in range(REPS))
        return [xs[len(xs) // 2], xs[0], xs[-1]]

    def emit(**kw):
        print(json.dumps({**kw, "card": card}), flush=True)

    for name, M, N, K in SHAPES:
        x, q, scale, _ = cs.int8_operands(g, M, K, N)
        x4, q4, _, _, w4_bf16 = cs.int4_operands(g, M, K, N)
        w_bf16 = (q.float() * scale[:, None]).to(torch.bfloat16)
        ref8, ref4 = int8.int8_matvec_plain(x, q), int8.int4_matvec_plain(x4, q4)
        err8 = cs.rel_l2(int8.int8_matvec(x, q), ref8)
        err4 = cs.rel_l2(int8.int4_matvec(x4, q4), ref4)
        emit(shape=name, M=M, N=N, K=K, int8_ms=spread(lambda: int8.int8_matvec(x, q)),
             int4_ms=spread(lambda: int8.int4_matvec(x4, q4)), int8_rel_l2=err8,
             int4_rel_l2=err4, linear_ms=spread(lambda: F.linear(x, w_bf16)),
             linear4_ms=spread(lambda: F.linear(x4, w4_bf16)))
    D, M = 1280, 3
    x, w1, s1, b1 = cs.int8_operands(g, M, D, 4 * D)
    _, w2, _, _ = cs.int8_operands(g, M, 4 * D, D)
    x4, v1, t1, c1, _ = cs.int4_operands(g, M, D, 4 * D)
    _, v2, _, _, _ = cs.int4_operands(g, M, 4 * D, D)
    emit(shape="mlp", M=M, int8_ms=spread(lambda: int8.int8_mlp(x, w1, s1, b1, w2)),
         int4_ms=spread(lambda: int8.int4_mlp(x4, v1, t1, c1, v2)))
    from indextts_tpu_torch.ops.decode_step import fused_decode_step

    dims, _, params, kv, valid, x, anc, _ = cs.k1_case(g)
    cache = {"k": kv[0], "v": kv[1]}
    emit(shape="k1", M=M, ms=spread(lambda: fused_decode_step(params, x, dims, cs.K1_POS, cache,
                                                              valid, anc, M)))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
