"""Device times of the port's hand-written kernels on one card, for one
checkout or two.

Parts (``--only``, comma-separated; all by default):

- gemv: K7a `int8_matvec` and the int4 GEMV (`csrc/int8_gemv.cu`) at K1's
  four projection shapes (M=3 decode rows, D=1280; qkv also at M=1), beside
  `F.linear` on the bf16 weight, and K7b `int8_mlp` and the int4 MLP;
- attention: K1's attention alone (`decode_attention`, `csrc/
  decode_attention.cu`) at chip_smoke.py's `DA_CASES`, with its checks and
  SDPA on the gathered cache beside it (`chip_smoke.decode_attention_phase`);
- plans: `decode_attention` at the K1 case (3 rows, the ancestry map,
  pos=300) and at S=2048, pos=1500, under every launch plan of 1, 2, 4 or
  5 heads a block, the one `attention_plan` chooses marked;
- k3: K3, K5 and K3' (`csrc/antialias_snake.cu`) summed over BigVGAN's six
  stage shapes;
- steps: K1 (`fused_decode_step`, the persistent kernel `csrc/
  decode_step.cu`) at chip_smoke.py's case: group=3, group=1, the int8
  cache (KVQ), int4 weights (W4), both (int4kv), each beside the chain of
  standalone kernels it replaced (`fused_decode_step_chain`, in turns), and
  K6 co-located (`fused_decode_step_tp`, both shards on this card,
  group=3). A checkout without the chain (an older one, via ``--root``)
  times its `fused_decode_step` alone;
  Each persistent case also prints its timeline (`decode_step.step_timeline`:
  the mean µs a layer in each phase and barrier wait, from %globaltimer
  stamps);
- barrier: the bare-barrier floor of the persistent step, the kernel of
  `decode_step.grid_barriers` (nothing but grid barriers, on the step's grid
  at the K1 case's cluster and shared memory) at 0, 1, 24, 119 (= a
  24-layer step's) and 240 barriers, and the time a barrier from the slope;
  then whether the cooperative-launch attribute combines with the cluster.

Each reading is the median and [min, max] of 5 CUDA-graph replays, and the
median eager time (`chip_smoke.timing_spread`). ``--attention-pos 0,64,300``
adds `decode_attention` alone at those positions (the K1 case's 3 rows).

``--root DIR`` imports the package from another checkout (e.g. the parent
commit unpacked with `git archive` into a git-ignored directory); the
measuring code is this checkout's chip_smoke.py, which calls only the
kernels' public wrappers. Two versions are then timed on one card in turns:

    python3 tools/torch_kernel_bench.py --root build/parent
    python3 tools/torch_kernel_bench.py

``--k3-variant vec=8,run=16`` (repeatable) times K3 built with other
constants: the package is copied to ``build/variants/vec8_run16/`` (git
ignores it), `VEC` (channels a thread) and `RUN` (output rows a thread) are
set in the copy's `csrc/antialias_snake.cu`, and the k3 part runs there in
a subprocess, with the compiler's registers and spills. The checkout's own
K3 is timed before and after the variants.

Prints one JSON line per reading and the card's name and power limit.
"""

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAN_CASES = {"k1": (3, 3, 512, 300), "long": (3, 3, 2048, 1500)}   # M, group, S, pos
PLAN_HEADS = (1, 2, 4, 5)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--only", default="gemv,attention,plans,k3,steps,barrier",
                    help="what to time: gemv, attention, plans, k3, steps, barrier "
                         "(comma-separated)")
    ap.add_argument("--attention-pos", default="",
                    help="more positions (comma-separated) at which to time decode_attention "
                         "alone at the K1 case's 3 rows with the ancestry map")
    ap.add_argument("--k3-variant", action="append", default=[],
                    help="K3 built with other constants, e.g. vec=8,run=16 (repeatable)")
    args = ap.parse_args()
    only = set(args.only.split(","))
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_bench: CUDA is not available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from indextts_tpu_torch.ops import cuda

    card = cs.card_line()
    t0 = time.perf_counter()
    cuda.build()
    print(f"card: {card}; root {args.root}; build {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    def emit(**kw):
        print(json.dumps({**kw, "root": args.root, "card": card}), flush=True)

    g = torch.Generator(device="cuda").manual_seed(9)
    if "gemv" in only:
        time_gemv(cs, g, emit)
    if "attention" in only:
        res = cs.decode_attention_phase(card)
        for label, r in res["decode_attention"]["spread"]["cases"].items():
            emit(kernel="decode_attention", case=label, **r)
    if args.attention_pos:
        from indextts_tpu_torch.ops.decode_step import decode_attention

        for pos in map(int, args.attention_pos.split(",")):
            qkv, c, valid, anc, _ = cs.da_case(g, cs.K1_ROWS, cs.K1_ROWS, False, cs.K1_S, pos)
            emit(kernel="decode_attention", case=f"pos={pos}", **graph(cs, lambda: decode_attention(
                qkv, c["k"], c["v"], valid, pos, cs.K1_H, anc, cs.K1_ROWS)))
    if "plans" in only:
        time_plans(cs, g, emit)
    if "k3" in only:
        time_k3(cs, g, emit)
        if args.k3_variant:
            for spec_ in args.k3_variant:
                run_k3_variant(spec_)
            time_k3(cs, g, emit)
    if "steps" in only:
        time_steps(cs, g, emit)
    if "barrier" in only:
        time_barriers(cs, emit)
    print(card, flush=True)
    return 0


def graph(cs, fn, library=None) -> dict:
    """A reading of ``fn`` (and ``library`` in turns): graph-replay median
    and range, eager median, ms."""
    kt, lt = cs.timing_spread(fn, library)
    out = {"ms": kt["graph"], "ms_range": kt["graph_range"], "eager_ms": kt["eager"]}
    if lt is not None:
        out.update(library_ms=lt["graph"], library_ms_range=lt["graph_range"])
    return out


def time_gemv(cs, g, emit) -> None:
    import torch
    import torch.nn.functional as F

    from indextts_tpu_torch.ops import int8

    for name, M, N, K in (("qkv", 3, 3840, 1280), ("attn-proj", 3, 1280, 1280),
                          ("fc", 3, 5120, 1280), ("mlp-proj", 3, 1280, 5120),
                          ("qkv-m1", 1, 3840, 1280)):
        x, q, scale, _ = cs.int8_operands(g, M, K, N)
        x4, q4, _, _, w4_bf16 = cs.int4_operands(g, M, K, N)
        w_bf16 = (q.float() * scale[:, None]).to(torch.bfloat16)
        err8 = cs.rel_l2(int8.int8_matvec(x, q), int8.int8_matvec_plain(x, q))
        err4 = cs.rel_l2(int8.int4_matvec(x4, q4), int8.int4_matvec_plain(x4, q4))
        emit(kernel="int8_matvec", shape=name, M=M, N=N, K=K, rel_l2=err8,
             **graph(cs, lambda: int8.int8_matvec(x, q), lambda: F.linear(x, w_bf16)))
        emit(kernel="int4_matvec", shape=name, M=M, N=N, K=K, rel_l2=err4,
             **graph(cs, lambda: int8.int4_matvec(x4, q4), lambda: F.linear(x4, w4_bf16)))
    D, M = 1280, 3
    x, w1, s1, b1 = cs.int8_operands(g, M, D, 4 * D)
    _, w2, _, _ = cs.int8_operands(g, M, 4 * D, D)
    x4, v1, t1, c1, _ = cs.int4_operands(g, M, D, 4 * D)
    _, v2, _, _, _ = cs.int4_operands(g, M, 4 * D, D)
    emit(kernel="int8_mlp", M=M, **graph(cs, lambda: int8.int8_mlp(x, w1, s1, b1, w2)))
    emit(kernel="int4_mlp", M=M, **graph(cs, lambda: int8.int4_mlp(x4, v1, t1, c1, v2)))


def time_plans(cs, g, emit) -> None:
    """`decode_attention` under each plan of `PLAN_HEADS` heads a block,
    each output checked bit-identical to the chosen plan's."""
    import torch

    from indextts_tpu_torch.ops.decode_step import attention_plan, decode_attention

    for label, (M, group, S, pos) in PLAN_CASES.items():
        qkv, c, valid, anc, _ = cs.da_case(g, M, group, False, S, pos)
        chosen = attention_plan(M, cs.K1_H, pos)
        ref = decode_attention(qkv, c["k"], c["v"], valid, pos, cs.K1_H, anc, group)
        for heads in PLAN_HEADS:
            plan = attention_plan(M, cs.K1_H, pos, heads=heads)

            def fn(plan=plan):
                return decode_attention(qkv, c["k"], c["v"], valid, pos, cs.K1_H, anc, group,
                                        plan=plan)

            same = torch.equal(fn(), ref)
            emit(kernel="decode_attention", case=label, S=S, pos=pos, plan=plan._asdict(),
                 blocks=M * cs.K1_H // heads * plan.cluster, chosen=plan == chosen,
                 bit_identical=same, **graph(cs, fn))
            assert same, (label, plan)


def time_k3(cs, g, emit) -> None:
    import math

    from indextts_tpu_torch.ops import cuda, snake

    entries = {"antialias_snake": snake.antialias_snake,
               "fused_antialias_activation": snake.fused_antialias_activation}
    tot = {name: {} for name in (*entries, "antialias_activation_prefolded")}
    for C, up in cs.K3_SHAPES:
        T, L = cs.MEL_FRAMES * up, 700 * up
        x, alpha, beta, lens = cs.k3_inputs(g, C, T, L)
        f = 128 // math.gcd(C, 128)
        xf = x.view(1, T // f, f * C)
        fns = {name: (lambda fn=fn: fn(x, alpha, beta, lens)) for name, fn in entries.items()}
        fns["antialias_activation_prefolded"] = lambda: snake.antialias_activation_prefolded(
            xf, alpha, beta, f, C, lens)
        ref = snake.antialias_snake_plain(x, alpha, beta, lens)
        err = cs.rel_l2(fns["antialias_snake"]()[0, :L], ref[0, :L])
        assert err <= cs.K3_REL_L2, (C, err)
        for name, fn in fns.items():
            tot[name] = cs.add_spread(tot[name], cs.timing_spread(fn, None)[0])
    for name, t in tot.items():
        emit(kernel=name, shapes="six BigVGAN stages, summed", ms=t["graph"],
             ms_range=t["graph_range"], eager_ms=t["eager"])
    log = (cuda.build_dir() / "build.log").read_text()
    print("\n".join(line for line in cs.build_lines(log, "antialias_snake")
                    if "registers" in line or "spill" in line), flush=True)


def run_k3_variant(spec: str) -> None:
    """K3 with ``spec``'s constants (vec=V,run=R), in a copy of the package."""
    consts = {k.strip(): int(v) for k, v in (p.split("=") for p in spec.split(","))}
    if set(consts) - {"vec", "run"} or consts.get("vec", 4) not in (2, 4, 8) \
            or consts.get("run", 16) < 1:
        raise ValueError(f"--k3-variant takes vec=2|4|8 and run>=1, got {spec!r}")
    name = "_".join(f"{k}{v}" for k, v in sorted(consts.items()))
    root = os.path.join(HERE, "build", "variants", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "indextts_tpu_torch"),
                    os.path.join(root, "indextts_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(root, "indextts_tpu_torch", "csrc", "antialias_snake.cu")
    text = open(src).read()
    for key, const in (("vec", "VEC"), ("run", "RUN")):
        if key in consts:
            text, n = re.subn(rf"^constexpr int {const} = \d+;", f"constexpr int {const} = "
                              f"{consts[key]};", text, flags=re.M)
            if n != 1:
                raise RuntimeError(f"{src}: no single 'constexpr int {const} = ...;' to set")
    with open(src, "w") as f:
        f.write(text)
    subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root, "--only", "k3"],
                   check=True)


def time_steps(cs, g, emit) -> None:
    from indextts_tpu_torch.models.gpt.gpt2 import kv_quantize_flat, quantize_gpt2_int4
    from indextts_tpu_torch.ops import decode_step
    from indextts_tpu_torch.ops.decode_step_tp import fused_decode_step_tp
    from indextts_tpu_torch.parallel.mesh import make_mesh, shard_gpt2_tp

    dims, bf16_params, params8, kv, valid, x, anc, _ = cs.k1_case(g)
    params4 = quantize_gpt2_int4(bf16_params)
    del bf16_params
    kq, vq, kvs = kv_quantize_flat(kv[0], kv[1], cs.K1_H)
    M, P = cs.K1_ROWS, cs.K1_POS
    bf16_cache, int8_cache = {"k": kv[0], "v": kv[1]}, {"k": kq, "v": vq, "kvs": kvs}
    c1 = {k: t[:, :1].contiguous() for k, t in bf16_cache.items()}
    cases = {"k1 group=3": (params8, x, bf16_cache, valid, anc, M),
             "k1 group=1": (params8, x[:1], c1, valid[:1], None, 1),
             "k1 kvq": (params8, x, int8_cache, valid, anc, M),
             "k1 w4": (params4, x, bf16_cache, valid, anc, M),
             "k1 int4kv": (params4, x, int8_cache, valid, anc, M)}
    chain = getattr(decode_step, "fused_decode_step_chain", None)
    for label, (p, xi, c, v, a, grp) in cases.items():
        def step(fn=decode_step.fused_decode_step):
            return fn(p, xi, dims, P, c, v, a, grp)

        if chain is None:
            emit(kernel="step", case=label, **graph(cs, step))
            continue
        kt, lt = cs.timing_spread(step, lambda: step(chain))
        emit(kernel="step", case=label, ms=kt["graph"], ms_range=kt["graph_range"],
             eager_ms=kt["eager"], chain_ms=lt["graph"], chain_ms_range=lt["graph_range"],
             chain_eager_ms=lt["eager"])
        emit(kernel="step timeline", case=label, **{
            k: round(v, 3) for k, v in decode_step.step_timeline(p, xi, dims, P, c, v, a,
                                                                 grp).items()})
    tp = shard_gpt2_tp(params8, make_mesh(["cuda:0", "cuda:0"]))
    Dl = cs.K1_D // 2
    tp_cache = {"shards": [{k: t[..., r * Dl:(r + 1) * Dl].contiguous()
                            for k, t in bf16_cache.items()} for r in range(2)]}
    emit(kernel="step", case="k6 co-located group=3", **graph(
        cs, lambda: fused_decode_step_tp(tp, x, dims, P, tp_cache, valid, anc, M)))


def time_barriers(cs, emit) -> None:
    """The persistent step's bare-barrier floor: graph replay of the
    barrier kernel at a few counts, and the time a barrier from the slope."""
    import torch

    from indextts_tpu_torch.ops import decode_step

    if not hasattr(decode_step, "grid_barriers"):
        print("barrier: this checkout has no persistent step", flush=True)
        return
    dev = torch.device("cuda:0")
    sh = decode_step.step_shape(cs.K1_ROWS, cs.K1_D, 4 * cs.K1_D)
    blocks = decode_step._step_blocks(dev, False, False, 1, sh.cluster, sh.smem)
    counts = (0, 1, 24, decode_step.step_barriers(cs.K1_L), 240)
    ms = {}
    for n in counts:
        kt, _ = cs.timing_spread(lambda n=n: decode_step.grid_barriers(dev, n), None)
        ms[n] = kt["graph"]
        emit(kernel="grid_barriers", barriers=n, ms=kt["graph"], ms_range=kt["graph_range"],
             eager_ms=kt["eager"])
    emit(kernel="grid_barrier", blocks=blocks, cluster=sh.cluster,
         us_per_barrier=1e3 * (ms[240] - ms[0]) / 240)
    try:
        decode_step.grid_barriers(dev, 1, cooperative=True)
        torch.cuda.synchronize()
        coop = "launched"
    except RuntimeError as e:
        coop = f"refused: {e}"
    emit(kernel="grid_barriers", cooperative_with_cluster=coop)


if __name__ == "__main__":
    sys.exit(main())
