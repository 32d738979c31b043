#!/usr/bin/env python3
"""Drive the PyTorch port (`indextts_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

1. Set-up: prints the card's name and power limit, builds the CUDA kernels
   from `indextts_tpu_torch/csrc` (one nvcc per source, in parallel, sm_90a).
2. Kernel phase: each hand-written kernel against its plain PyTorch twin on
   the same inputs at the main paths' shapes, with kernel, twin and (where
   one PyTorch call computes the same function) library times from CUDA
   events after warm-up, and each kernel's bound from the bytes and
   operations of this run's inputs:
   - K2 `attention_rope`, its rope pass (`rope_qk`, bit-identical to its
     twin) then K2''s attention kernel (rel-L2 <= 2e-2 over valid query rows;
     library: SDPA on pre-roped q and k, attention only) and K3 `antialias_snake`
     (rel-L2 <= 1e-3 over valid rows, and within 2 bf16 ulps on the 4 rows
     at each edge; timed by graph replay, the median [min-max] of 5 a shape,
     beside the eager CUDA-event time; its SFU and issue estimates printed);
   - K7a `int8_matvec` at the qkv, attn-proj, fc and mlp-proj shapes, M = 3,
     and at qkv, M = 1, and K7b `int8_mlp` at the MLP shape, M = 3 (rel-L2
     <= 1e-3; yardstick: F.linear with the bf16 weight the int8 one
     replaces). These and K1 are short launches: their kernel, twin and
     library times are device times, from CUDA events around the replay of a
     CUDA graph of 20 calls; K7a and the int4 GEMV, and F.linear beside them,
     are timed 5 times in turns (`timing_spread`: median and range, graph
     replay and eager);
   - K1 `fused_decode_step` (the persistent kernel, `csrc/decode_step.cu`:
     one launch a step) at L=24, D=1280, H=20, B*K=3, S=512, pos=300,
     staggered starts and a random ancestry map (hidden state rel-L2 <= 1e-2;
     written k/v rows of layer 0 within 1 bf16 ulp, of every layer rel-L2 <=
     1e-2), bit-identical to K1 on the physically gathered cache, and
     bit-identical to the chain of standalone kernels it replaced
     (`fused_decode_step_chain`: the hidden state, the whole cache after the
     step, every layer's input; two launches alike; `step_barriers` grid
     barriers), timed beside that chain in the same call (graph replay and
     eager) with its timeline (`step_timeline`: µs a layer in each phase
     and barrier); yardstick: the port's bf16 `gpt2_decode_step` at the
     same shape; and K1 at group=1 (one row, no ancestry map), the sampling
     decode's route; then (`k1_phase`) each variant (int8, KVQ, W4,
     int4kv) at group=3 and group=1, layer by layer against the twin and
     bit-identical to the chain at the K1 case, and bit-identical to the
     chain at pos=0, pos=1, S=2048 pos=1500 and 24 rows (`K1_EDGE_CASES`);
   - K1's attention alone (`decode_attention`, `decode_attention_phase`) at
     `DA_CASES`: the K1 case's layer (3 rows, the ancestry map, pos=300), 1
     row, the int8 cache, S=2048 at pos=1500, and the K1 case over 24
     layers' caches in turn (from HBM, as in a step): against its twin (rel-L2
     <= 1e-2), written rows bit-identical to the twin's, two launches
     bit-identical, the ancestry route bit-identical to the gathered cache,
     heads [0, 10) bit-identical to an H=10 call (K6's shard) and the
     output bit-identical under another launch plan; timed with
     `timing_spread` beside SDPA on the gathered bf16 cache (none for the
     int8 cache), with its bound from this run's valid positions;
   - K4 `single_block_attention` at the DiT flash tier's shape (B=2, H=8,
     D=64, T=1280, transposed (B, T, H, D) views) and at H=16 / D=32 and
     H=4 / D=128, and K2' `packed_pair_attention` at K2's shapes (rel-L2 <=
     2e-2; library: SDPA with the boolean key mask); K4 must refuse D=40;
   - the attention kernels (K2 at both T, K2', K4 at its three widths) and
     SDPA beside them are timed 5 times each, in turns, as device time (the
     replay of a CUDA graph of 20 calls) and eager (CUDA events around 10
     eager calls, host work included): the median and the min-max range of
     each, so the yardstick's spread is read in the same run; their
     `kernels` rows give the graph-replay medians as ``ms`` and
     ``library_ms``;
   - K5 `fused_antialias_activation` and K3' `antialias_activation_prefolded`
     (on the fold f = 128 // gcd(C, 128)) at K3's six shapes under both
     logscale values, with K3's gates and K3's timing. K2', K5 and K3' have
     no caller on the
     port's pipeline (the JAX package calls them from tests, tools and its
     unported stage-folded vocoder): their launches are this phase's.
3. bf16 pipeline pass: `IndexTTS2(cfg_path=None, device="cuda")` at the
   shipped widths with seeded random weights, a synthetic bpe.model and a 5 s
   prompt wav; two single-segment requests with the default generation
   kwargs (beam sampling, num_beams=3), decode pinned to 400 codes as the
   JAX bench pins it. Checks: finite wavs of int(codes * 1.72) * 256
   samples, K2 (and its rope pass) / K3 launch counts equal to what two
   requests must make,
   and, on a small input, every kernel call of the DiT and BigVGAN against
   its plain twin on the same inputs; then one more request whose CFM solve
   runs under `torch.profiler` (`profile_s2mel`: wall, device busy share,
   the attention kernels' device time), as the flash-tier request of the
   sampling pass does too.
4. int8 pipeline pass: the same with `quantization="int8"` (the serving
   configuration), two requests. Checks: the wavs as above; K1 launched once
   per decode step (399 a request) and none of the standalone GEMV or
   attention kernels; the bf16 decode step and the per-step K/V gather
   never ran (the ancestry route did). The first 8 K1 calls of the
   first request are also run through the twin on the same inputs, layer
   by layer (each layer's twin takes the kernel path's input of that layer):
   every layer's output and the hidden state after ln_f within rel-L2 1e-2,
   every layer's written k/v rows bit-identical to what the twin attention
   writes from the kernel's own qkv (`twin_by_layer`). The 24-layer chain of
   the twin alone is printed beside it, with the noise floor of that chain:
   the twin against itself with f64 instead of f32 sums (the random-weight
   decoder amplifies f32 summation-order noise to about 1e-2 over 24
   layers, so the end-to-end difference is reported, not gated).
5. Sampling pass (num_beams=1, `engine/decode.py::generate_adaptive`), int8
   weights, two requests pinned to 400 codes (the cache grows once, from
   the 256-code span to 400): K1 once per decode step, every call at
   group=1 with no ancestry map, the first 8 twin-checked as in the int8
   pass; the bf16 step and the beam engine never run; one span growth. The
   second request runs with INDEXTTS_PACKED_ATTN=0, the DiT's flash tier:
   K4 once per DiT layer and CFG step (13 x 25), K2 never, a finite wav,
   then every K4 call of the DiT on a small input against its twin; its
   s2mel stage is printed beside the packed tier's.
6. Memory-knob passes, the same way as the int8 pass, one request each:
   `quantization="int8kv"` (int8 weights, the flat int8 KV cache: K1's KVQ
   variant), `"int4"` (nibble-packed int4 weights: K1's W4 variant, the
   int4 GEMVs) and `"int4kv"` (both), the first 8 K1 calls twin-checked
   (the written int8 rows and their scale rows bit-identical); exact launch
   counts per pass (K1 once a step, no standalone GEMV or attention launch).
   The kernel phase holds the int4 GEMV at the four K7a shapes and the MLP
   (rel-L2 <= 1e-3, yardstick F.linear on the bf16 weight), and K1-KVQ,
   K1-W4 and K1 int4kv at the K1 shape layer by layer against the twin, and
   bit-identical to the same kernel on the gathered cache (scale rows
   gathered too); yardsticks: the int8 K1 and the bf16 step.
7. tp pass: the tp=2 int8 serving decode (kernel K6) with both shards on
   this card, `IndexTTS2(quantization="int8", mesh=make_mesh(["cuda:0",
   "cuda:0"]))` under INDEXTTS_TP_DECODE=kernel: one num_beams=3 request
   (its first 8 K6 steps twin-checked layer by layer: every layer within
   rel-L2 1e-2, the two shards' residual streams bit-identical, the written
   k/v rows bit-identical to K1's qkv GEMV on the same input, per head
   slice) and one num_beams=1 request, exact launch counts (K6 once a decode
   step, `tp_allreduce` twice a layer, step and shard, each shard's GEMVs and
   attention; K1 never), its gpt stage beside the int8 pass's, and a
   profiled tp decode. The kernel phase holds K6 at K1's shape (3 rows at
   group=3, and 1 row) the same way, beside K1 on the same inputs, and
   `tp_allreduce` alone, bit-identical to its twin for either rank.
8. Decode profile, after the bf16, int8, int8kv, int4 and tp passes: one
   request's `generate_beam` (399 steps) timed unprofiled, then under
   `torch.profiler` (its window opens after a discarded warm-up step and
   closes after a pad of spin kernels, on which the records the profiler
   drops at a window's end then fall): the device's busy share (the union
   of the records' intervals over the wall: the tp pass runs two streams),
   kernel launches per step and the largest device consumers; the recorded
   launches of the port's kernels (K1: one `decode_step_kernel` record a
   step, no GEMV or attention record on its route) and of the scorer's
   top-k equal the counters of that run.

`tools/torch_tp_two_cards.py` runs K6 with its shards on two cards, on a
machine that has two.

Each phase prints its elapsed time since the kernel build. Prints
per-stage times and RTF beside the card, then (second to last line) one
JSON object describing the kernels, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero with its
traceback. Exits 2 without a result when CUDA is unavailable or the port's
package cannot be imported (e.g. run outside the repository).
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

SENTENCE = ("the quick brown fox jumps over the lazy dog and runs into "
            "the forest . the dog runs over the lazy fox . ")
K2_TS = (1280, 2304)                       # prompt bucket + mel bucket
# K4's head widths: a 512-wide DiT at 8, 16 and 4 heads; the first is the
# shipped DiT's, the one the flash-tier request runs
K4_HEADS = ((8, 64), (16, 32), (4, 128))
MEL_FRAMES = 768                           # the 400-code mel bucket
K3_SHAPES = ((768, 4), (384, 16), (192, 32), (96, 64), (48, 128), (24, 256))
ATTN_REPS = 5                              # timings of each attention kernel and SDPA
K2_REL_L2 = 2e-2                           # the repo's packed_attn_rel_l2 gate
K3_REL_L2 = 1e-3                           # bf16 output rounding is ~2e-5 here
K7_REL_L2 = 1e-3                           # f32 sums in another order
# (name, M, N, K) of the GEMV rows: K1's four projections at M = 3, qkv at M = 1
GEMV_SHAPES = (("qkv", 3, 3 * 1280, 1280), ("attn-proj", 3, 1280, 1280),
               ("fc", 3, 4 * 1280, 1280), ("mlp-proj", 3, 1280, 4 * 1280),
               ("qkv", 1, 3 * 1280, 1280))
K1_REL_L2 = 1e-2                           # bf16 chain over 24 layers
EDGE_ROWS = 4                              # the halo a K3 output row reads: 3
K3_OPS_PER_ELEMENT = 56                    # 2x6-tap up, 2 snakes, 12-tap down
# the GPT decoder of the shipped config, and the K1 kernel-phase shape
K1_L, K1_D, K1_H, K1_ROWS, K1_S, K1_POS = 24, 1280, 20, 3, 512, 300
# K1's attention alone (`decode_attention`): label -> (rows, group, int8
# cache, S, pos, layers); "long" is max_mel_tokens' reach; "k1 24 layers"
# times the K1 case over 24 layers' caches in turn, as a decode step reads
# them (94 MB, past the 50 MB L2: the others replay one layer from L2)
DA_CASES = {"k1": (3, 3, False, K1_S, K1_POS, 1), "group=1": (1, 1, False, K1_S, K1_POS, 1),
            "kvq": (3, 3, True, K1_S, K1_POS, 1), "long": (3, 3, False, 2048, 1500, 1),
            "k1 24 layers": (3, 3, False, K1_S, K1_POS, K1_L)}
BF16_REQUESTS, INT8_REQUESTS = 2, 2
# the num_beams=1 sampling pass (int8): a twin-checked request on the packed
# DiT tier, then one on the flash tier (INDEXTTS_PACKED_ATTN=0)
SAMPLING_REQUESTS = 2
DECODE_STEPS = 399                         # 400 codes: 399 steps after prefill
TWIN_CHECKED_STEPS = 8
# the memory-knob passes: quantization -> (requests, profiled)
QUANT_PASSES = {"int8kv": (1, True), "int4": (1, True), "int4kv": (1, False)}
# K1's variants in the kernel phase: name -> (int4 weights, int8 cache)
K1_VARIANTS = {"fused_decode_step_kvq": (False, True), "fused_decode_step_w4": (True, False),
               "fused_decode_step_w4_kvq": (True, True)}
# K1's bit-identity cases beside the K1 case: label -> (rows, S, pos)
K1_EDGE_CASES = {"pos=0": (K1_ROWS, K1_S, 0), "pos=1": (K1_ROWS, K1_S, 1),
                 "S=2048 pos=1500": (K1_ROWS, 2048, 1500), "24 rows": (24, K1_S, K1_POS)}
# the tp pass: both tp=2 shards on this card
TP_DEVICES = ("cuda:0", "cuda:0")
# H100 SXM datasheet peaks: HBM bytes/s, bf16 tensor-core
# and f32 FLOP/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12


def edge_err(out, ref, L: int) -> float:
    """K3 at the rows whose taps reach the replicated edges, [0, 4) and
    [L-4, L): the largest error over the larger of the two blocks' magnitudes
    in units of 2 bf16 ulps (2**-6 relative): <= 1 passes."""
    worst = 0.0
    for rows in (slice(0, EDGE_ROWS), slice(L - EDGE_ROWS, L)):
        o, r = out[rows].float(), ref[rows].float()
        worst = max(worst, ((o - r).abs().max()
                            / (2 ** -6 * r.abs().max()).clamp_min(1e-30)).item())
    return worst


def ulp_err(out, ref) -> float:
    """Largest |out - ref| in bf16 ulps of |ref|, the ulp taken at no less
    than 1e-3 of ref's largest magnitude (a value the bias cancels to near
    zero keeps the absolute error of the f32 sum it came from): <= 1 passes."""
    o, r = out.float(), ref.float()
    mag = r.abs().clamp_min(1e-3 * r.abs().max().item()).clamp_min(1e-30)
    return ((o - r).abs() / 2.0 ** (mag.log2().floor() - 7)).max().item()


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters=10, warmup=2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20, replays=5) -> float:
    """Device time of one ``fn`` call: a CUDA graph of ``iters`` calls,
    replayed ``replays`` times between CUDA events (no host time inside)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def timing_spread(kernel, library, reps: int = ATTN_REPS) -> tuple:
    """``kernel`` and ``library`` timed in turns, ``reps`` times each, as
    device time (`graph_ms`) and eager (`time_ms`, host work included): for
    each, {"graph", "eager"} medians and {"graph_range", "eager_range"} (min,
    max), ms. A ``library`` of None (no PyTorch call computes the function)
    is not timed and gives None."""
    fns = [f for f in (kernel, library) if f is not None]
    runs = {f: {"graph": [], "eager": []} for f in fns}
    for _ in range(reps):
        for f in fns:
            runs[f]["graph"].append(graph_ms(f))
            runs[f]["eager"].append(time_ms(f))
    out = []
    for f in fns:
        r = {}
        for how, xs in runs[f].items():
            xs = sorted(xs)
            r[how], r[f"{how}_range"] = xs[len(xs) // 2], (xs[0], xs[-1])
        out.append(r)
    return tuple(out) + (None,) * (2 - len(out))


def spread_text(t) -> str:
    if t is None:
        return "none"
    return (f"graph {t['graph']:.4f} ms [{t['graph_range'][0]:.4f}-{t['graph_range'][1]:.4f}]"
            f" eager {t['eager']:.4f} ms [{t['eager_range'][0]:.4f}-{t['eager_range'][1]:.4f}]")


def spread_row(kt: dict, lt: dict, **extra) -> dict:
    """The result fields of an attention kernel timed by `timing_spread`:
    ``ms`` and ``library_ms`` are graph-replay medians; ``spread`` (the
    ranges, the eager times and ``extra``) goes into its ``kernels`` row as
    it is."""
    lib = {} if lt is None else {
        "library_ms_range": lt["graph_range"], "library_eager_ms": lt["eager"],
        "library_eager_ms_range": lt["eager_range"]}
    return {"ms": kt["graph"], "library_ms": None if lt is None else lt["graph"], "spread": {
        "ms_timing": f"graph replay, median of {ATTN_REPS}", "ms_range": kt["graph_range"],
        "eager_ms": kt["eager"], "eager_ms_range": kt["eager_range"], **lib, **extra}}


def gemv_shape_row(kt: dict, lt: dict, b: dict) -> dict:
    """A GEMV shape's entry in its ``kernels`` row: graph-replay medians
    and ranges of the kernel and F.linear, and the shape's bound."""
    return {"ms": kt["graph"], "ms_range": kt["graph_range"], "library_ms": lt["graph"],
            "library_ms_range": lt["graph_range"], "bound_ms": b["bound_ms"]}


def plan_text(M: int, N: int, K: int, w4: bool = False) -> str:
    """The GEMV kernel's launch plan for the shape (`ops/int8.py::gemv_plan`)."""
    from indextts_tpu_torch.nn import int4_halfspan
    from indextts_tpu_torch.ops.int8 import gemv_plan

    p = gemv_plan(M, N, K, int4_halfspan(K // 2) if w4 else 0)
    return (f"{-(-N // (16 * p.rows)) * p.split} blocks of {p.rows} 16-row tile(s), split "
            f"{p.split} x {p.span} columns, {p.smem} B shared")


def build_lines(log: str, kernel: str) -> list:
    """ptxas's lines (registers, shared memory, spills) for every
    instantiation of ``kernel`` in the build log."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            keep = kernel in line
        if keep:
            out.append(line.strip())
    return out


def rel_l2(a, b) -> float:
    import torch

    return (torch.linalg.norm((a - b).float()) / torch.linalg.norm(b.float())).item()


def bound(nbytes: float, ops: float, peak_ops: float) -> dict:
    """The least time for the work: the larger of bytes over the HBM rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def build_fake_assets(d: str) -> str:
    """A tiny bpe.model and a 5 s 16 kHz prompt wav (the JAX bench's assets)."""
    from indextts_tpu_torch.text import build_model_file

    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    words = ["▁THE", "▁QUICK", "▁BROWN", "▁FOX", "▁JUMPS", "▁OVER", "▁LAZY",
             "▁DOG", "▁AND", "▁RUNS", "▁INTO", "▁FOREST", "▁."]
    vocab = [w[:i] for w in words for i in range(2, len(w) + 1)] + ["▁", ".", "▁,"]
    seen, score = set(), -1.0
    for w in vocab:
        if w not in seen:
            seen.add(w)
            pieces.append((w, score, 1))
            score -= 1.0
    build_model_file(pieces, os.path.join(d, "bpe.model"))
    sr = 16000
    t = np.arange(5 * sr) / sr
    wav = 0.25 * np.sin(2 * np.pi * 170 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    wav += 0.02 * np.random.default_rng(0).standard_normal(len(t))
    path = os.path.join(d, "prompt.wav")
    with wave.open(path, "wb") as f:                    # 16-bit PCM, mono
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(np.round(np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())
    return path


def kernel_phase(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from indextts_tpu_torch.ops.attn import (attention_rope, attention_rope_plain, rope_qk,
                                             rope_qk_plain)
    from indextts_tpu_torch.ops.rope import apply_rotary_emb_half, precompute_freqs_cis
    from indextts_tpu_torch.ops.snake import antialias_snake, antialias_snake_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    res = {"attention_rope": {"err": 0.0, "abs": 0.0}, "antialias_snake": {"err": 0.0, "abs": 0.0}}

    H, D = 8, 64
    for T in K2_TS:
        q, k, v = (torch.randn((2, T, H * D), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        lens = torch.tensor([T - 37, T // 2 + 5], device=dev, dtype=torch.int32)
        fc = torch.as_tensor(precompute_freqs_cis(T, D), device=dev)
        out = attention_rope(q, k, v, lens, fc, H)
        ref = attention_rope_plain(q, k, v, lens, fc, H)
        torch.cuda.synchronize()
        err = max(rel_l2(out[b, :L], ref[b, :L]) for b, L in enumerate(lens.tolist()))
        mab = max((out[b, :L].float() - ref[b, :L].float()).abs().max().item()
                  for b, L in enumerate(lens.tolist()))
        rope_equal = all(torch.equal(a, b) for a, b in zip(rope_qk(q, k, fc, H),
                                                            rope_qk_plain(q, k, fc, H)))
        pms = time_ms(lambda: attention_rope_plain(q, k, v, lens, fc, H))
        # yardstick: SDPA on q and k roped beforehand (attention only)
        qr, kr = (apply_rotary_emb_half(t.reshape(2, T, H, D), fc).transpose(1, 2).contiguous()
                  for t in (q, k))
        vh = v.reshape(2, T, H, D).transpose(1, 2).contiguous()
        key_ok = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        kt, lt = timing_spread(lambda: attention_rope(q, k, v, lens, fc, H),
                               lambda: F.scaled_dot_product_attention(qr, kr, vh,
                                                                      attn_mask=key_ok))
        rope_ms = graph_ms(lambda: rope_qk(q, k, fc, H))
        # QK^T and PV over each row's valid keys for all T query rows
        b = bound(4 * 2 * T * H * D * 2 + 2 * 4 + T * D * 4,
                  sum(4 * H * D * T * L for L in lens.tolist()), BF16_FLOPS)
        print(f"K2 attention_rope B=2 H={H} D={D} T={T}: rel_l2 {err:.3e} max_abs {mab:.3e}"
              f" rope pass bit-identical {rope_equal}, kernel (rope pass + attention) "
              f"{spread_text(kt)} (rope pass alone graph {rope_ms:.4f} ms), plain {pms:.4f} ms,"
              f" SDPA (attention only) {spread_text(lt)}; medians and [min-max] of "
              f"{ATTN_REPS}; bound {b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]",
              flush=True)
        assert err <= K2_REL_L2 and np.isfinite(err), f"K2 rel-L2 {err} > {K2_REL_L2} at T={T}"
        assert rope_equal, "K2's rope pass differs from its twin"
        r = res["attention_rope"]
        r["err"], r["abs"] = max(r["err"], err), max(r["abs"], mab)
        if T == K2_TS[0]:
            r.update(plain_ms=pms, **spread_row(kt, lt, rope_pass_ms=rope_ms), **b)

    tot, tot_pms = {}, 0.0
    k3_bytes = k3_ops = 0
    for C, up in K3_SHAPES:
        T, L = MEL_FRAMES * up, 700 * up
        x, alpha, beta, lens = k3_inputs(g, C, T, L)
        out = antialias_snake(x, alpha, beta, lens)
        ref = antialias_snake_plain(x, alpha, beta, lens)
        torch.cuda.synchronize()
        err = rel_l2(out[0, :L], ref[0, :L])
        edge = edge_err(out[0], ref[0], L)
        mab = (out[0, :L].float() - ref[0, :L].float()).abs().max().item()
        kt = timing_spread(lambda: antialias_snake(x, alpha, beta, lens), None)[0]
        pms = time_ms(lambda: antialias_snake_plain(x, alpha, beta, lens))
        tot, tot_pms = add_spread(tot, kt), tot_pms + pms
        k3_bytes += 2 * T * C * 2 + 2 * C * 4
        k3_ops += K3_OPS_PER_ELEMENT * T * C
        print(f"K3 antialias_snake B=1 C={C} T={T} L={L} ({k3_plan_text(1, T, C)}): rel_l2 "
              f"{err:.3e} max_abs {mab:.3e} edge rows {edge:.3f} of 2 ulps kernel "
              f"{spread_text(kt)} plain {pms:.4f} ms [{card}]", flush=True)
        assert err <= K3_REL_L2 and np.isfinite(err), f"K3 rel-L2 {err} > {K3_REL_L2} at C={C}"
        assert edge <= 1.0, f"K3 edge rows off by {edge} x 2 ulps at C={C}"
        r = res["antialias_snake"]
        r["err"], r["abs"] = max(r["err"], err), max(r["abs"], mab)
    b = bound(k3_bytes, k3_ops, F32_FLOPS)
    res["antialias_snake"].update(ms=tot["graph"], plain_ms=tot_pms, library_ms=None, **b,
                                  spread=k3_spread(tot))
    print(f"K3 sum over the six stage shapes: kernel {spread_text(tot)} (medians and [min-max] "
          f"of {ATTN_REPS} a shape, summed) plain {tot_pms:.4f} ms bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}: {k3_bytes} B, {k3_ops} f32 ops); "
          f"{k3_floor_text(k3_ops // K3_OPS_PER_ELEMENT)} [{card}]", flush=True)
    return res


def k3_inputs(g, C: int, T: int, L: int, B: int = 1):
    """K3's inputs at one BigVGAN stage shape: x (B, T, C) bf16, SnakeBeta's
    log-scale alpha and beta (C,), lengths (B,) of L frames."""
    import torch

    dev = torch.device("cuda")
    x = (2 * torch.randn((B, T, C), generator=g, device=dev)).to(torch.bfloat16)
    alpha = 0.3 * torch.randn((C,), generator=g, device=dev)
    beta = 0.3 * torch.randn((C,), generator=g, device=dev)
    return x, alpha, beta, torch.full((B,), L, device=dev, dtype=torch.int32)


def k3_plan_text(B: int, T: int, C: int) -> str:
    from indextts_tpu_torch.ops.snake import SNAKE_VEC, snake_plan

    p = snake_plan(B, T, C)
    return (f"{p.blocks} blocks of {p.threads} threads, runs of {p.rows} rows x {SNAKE_VEC} "
            f"channels")


# K3's floors beside its byte bound, printed as estimates on its lines and
# kept out of the kernels line (neither is measured): its two sines an
# element on the SFUs (16 a clock an SM) and the issue of its instructions
# (4 warp instructions a clock an SM), on H100_SMS SMs at the clock that
# F32_FLOPS implies (128 f32 lanes an SM, 2 operations a lane a clock).
# K3_INSTR_PER_ELEMENT is a count by hand from the SASS of the kernel's
# interior loop, to be redone when the kernel changes: 53 an element and
# row step (42 floating-point: 12 FFMA for the two 6-tap phases, 2 x 9 for
# the snakes, 12 FFMA for the lowpass; 11 of addresses, branches, moves and
# conversions), times 21 / 16 for a 16-row run's halo.
H100_SMS = 132
SM_CLOCK_HZ = F32_FLOPS / (H100_SMS * 128 * 2)
K3_INSTR_PER_ELEMENT = 69


def k3_floors(elements: int) -> dict:
    """K3's SFU floor and issue estimate (ms) for ``elements`` outputs."""
    return {"sfu_ms": 2 * elements / (16 * H100_SMS * SM_CLOCK_HZ) * 1e3,
            "issue_ms": K3_INSTR_PER_ELEMENT * elements / (128 * H100_SMS * SM_CLOCK_HZ) * 1e3}


def k3_floor_text(elements: int) -> str:
    f = k3_floors(elements)
    return (f"estimates: SFU sine floor {f['sfu_ms']:.4f} ms, instruction issue {f['issue_ms']:.4f}"
            f" ms ({K3_INSTR_PER_ELEMENT} instructions an element, counted by hand from the "
            f"kernel's SASS; {SM_CLOCK_HZ / 1e9:.3f} GHz)")


def k3_spread(kt: dict) -> dict:
    """The ``spread`` of an anti-alias row: ``kt`` holds the six shapes'
    `timing_spread` results summed."""
    return {"ms_timing": f"graph replay, median of {ATTN_REPS} a shape, summed over the six",
            "ms_range": kt["graph_range"], "eager_ms": kt["eager"],
            "eager_ms_range": kt["eager_range"]}


def add_spread(tot: dict, t: dict) -> dict:
    """``tot`` plus one `timing_spread` result, key by key (an empty ``tot``
    starts the sum)."""
    if not tot:
        return dict(t)
    return {k: tuple(a + b for a, b in zip(tot[k], v)) if isinstance(v, tuple) else tot[k] + v
            for k, v in t.items()}


def attention_kernel_phase(card: str) -> dict:
    """K4 `single_block_attention` at the DiT flash tier's shape (B=2, H=8,
    D=64, the q, k, v the DiT hands over: transposed (B, T, H, D) views) and
    at H=16 / D=32 and H=4 / D=128, and K2' `packed_pair_attention` at K2's
    shapes, each against its twin (rel-L2 <= 2e-2 over valid query rows);
    library: SDPA with the boolean key mask. K4's wrapper must refuse a head
    width of 40. K2' has no pipeline caller (the JAX package calls it from
    tests and tools only): its launches are this phase's."""
    import torch
    import torch.nn.functional as F

    from indextts_tpu_torch.ops.attn import (packed_pair_attention, packed_pair_attention_plain,
                                             single_block_attention,
                                             single_block_attention_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    res = {"single_block_attention": {"err": 0.0, "abs": 0.0},
           "packed_pair_attention": {"err": 0.0, "abs": 0.0}}
    T = K2_TS[0]
    lens = torch.tensor([T - 37, T // 2 + 5], device=dev, dtype=torch.int32)
    key_ok = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    for H, D in K4_HEADS:
        q, k, v = (torch.randn((2, T, H, D), generator=g, device=dev).to(torch.bfloat16)
                   .transpose(1, 2) for _ in range(3))
        out = single_block_attention(q, k, v, lens)
        ref = single_block_attention_plain(q, k, v, lens)
        torch.cuda.synchronize()
        err = max(rel_l2(out[b, :, :L], ref[b, :, :L]) for b, L in enumerate(lens.tolist()))
        mab = max((out[b, :, :L].float() - ref[b, :, :L].float()).abs().max().item()
                  for b, L in enumerate(lens.tolist()))
        pms = time_ms(lambda: single_block_attention_plain(q, k, v, lens))
        kt, lt = timing_spread(lambda: single_block_attention(q, k, v, lens),
                               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=key_ok))
        b = bound(4 * 2 * T * H * D * 2 + 2 * 4,
                  sum(4 * H * D * T * L for L in lens.tolist()), BF16_FLOPS)
        print(f"K4 single_block_attention B=2 H={H} D={D} T={T}: rel_l2 {err:.3e} max_abs "
              f"{mab:.3e} kernel {spread_text(kt)}, plain {pms:.4f} ms, SDPA {spread_text(lt)};"
              f" medians and [min-max] of {ATTN_REPS}; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}) [{card}]", flush=True)
        assert err <= K2_REL_L2 and np.isfinite(err), f"K4 rel-L2 {err} at D={D}"
        r = res["single_block_attention"]
        r["err"], r["abs"] = max(r["err"], err), max(r["abs"], mab)
        if (H, D) == K4_HEADS[0]:
            r.update(plain_ms=pms, **spread_row(kt, lt), **b)
    try:
        x40 = torch.zeros((1, 8, 64, 40), device=dev, dtype=torch.bfloat16)
        single_block_attention(x40, x40, x40, lens[:1])
    except ValueError as e:
        print(f"K4 refuses head width 40: {e}", flush=True)
    else:
        raise AssertionError("K4 took a head width of 40")

    packed_pair_attention.launches = 0
    H, D = 8, 64
    for T in K2_TS:
        q, k, v = (torch.randn((2, T, H * D), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        lens = torch.tensor([T - 37, T // 2 + 5], device=dev, dtype=torch.int32)
        out = packed_pair_attention(q, k, v, lens, H)
        ref = packed_pair_attention_plain(q, k, v, lens, H)
        torch.cuda.synchronize()
        err = max(rel_l2(out[b, :L], ref[b, :L]) for b, L in enumerate(lens.tolist()))
        mab = max((out[b, :L].float() - ref[b, :L].float()).abs().max().item()
                  for b, L in enumerate(lens.tolist()))
        pms = time_ms(lambda: packed_pair_attention_plain(q, k, v, lens, H))
        qh, kh, vh = (t.reshape(2, T, H, D).transpose(1, 2) for t in (q, k, v))
        key_ok = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        kt, lt = timing_spread(lambda: packed_pair_attention(q, k, v, lens, H),
                               lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                      attn_mask=key_ok))
        b = bound(4 * 2 * T * H * D * 2 + 2 * 4,
                  sum(4 * H * D * T * L for L in lens.tolist()), BF16_FLOPS)
        print(f"K2' packed_pair_attention B=2 H={H} D={D} T={T}: rel_l2 {err:.3e} max_abs "
              f"{mab:.3e} kernel {spread_text(kt)}, plain {pms:.4f} ms, SDPA {spread_text(lt)};"
              f" medians and [min-max] of {ATTN_REPS}; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}) [{card}]", flush=True)
        assert err <= K2_REL_L2 and np.isfinite(err), f"K2' rel-L2 {err} at T={T}"
        r = res["packed_pair_attention"]
        r["err"], r["abs"] = max(r["err"], err), max(r["abs"], mab)
        if T == K2_TS[0]:
            r.update(plain_ms=pms, **spread_row(kt, lt), **b)
    res["packed_pair_attention"]["launches"] = packed_pair_attention.launches
    return res


def antialias_entries_phase(card: str) -> dict:
    """K5 `fused_antialias_activation` and K3' `antialias_activation_prefolded`
    (both on K3's hand-written kernel) at the six BigVGAN stage shapes with
    lengths, under both logscale values (linear-scale parameters positive),
    K3' on the (B, T/f, f*C) fold, f = 128 // gcd(C, 128), each against the
    plain twin with K3's gates (rel-L2 <= 1e-3, the 4 edge rows within 2
    bf16 ulps). Timed at logscale=True, summed over the six shapes like K3.
    Neither has a pipeline caller (K5: the JAX package's tests; K3': its
    stage-folded vocoder, which is not ported): their launches are this
    phase's."""
    import torch

    from indextts_tpu_torch.ops.snake import (antialias_activation_prefolded,
                                              antialias_snake_plain,
                                              fused_antialias_activation)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    names = ("fused_antialias_activation", "antialias_activation_prefolded")
    res = {n: {"err": 0.0, "abs": 0.0, "plain_ms": 0.0, "times": {}} for n in names}
    fused_antialias_activation.launches = antialias_activation_prefolded.launches = 0
    nbytes = ops = 0
    for C, up in K3_SHAPES:
        T, L = MEL_FRAMES * up, 700 * up
        f = 128 // math.gcd(C, 128)
        x, _, _, lens = k3_inputs(g, C, T, L)
        for logscale in (True, False):
            alpha = 0.3 * torch.randn((C,), generator=g, device=dev)
            beta = 0.3 * torch.randn((C,), generator=g, device=dev)
            if not logscale:
                alpha, beta = alpha.exp(), beta.exp()
            ref = antialias_snake_plain(x, alpha, beta, lens, logscale)
            outs = {names[0]: fused_antialias_activation(x, alpha, beta, lens, logscale),
                    names[1]: antialias_activation_prefolded(
                        x.view(1, T // f, f * C), alpha, beta, f, C, lens,
                        logscale).view(1, T, C)}
            torch.cuda.synchronize()
            for name, out in outs.items():
                err, edge = rel_l2(out[0, :L], ref[0, :L]), edge_err(out[0], ref[0], L)
                mab = (out[0, :L].float() - ref[0, :L].float()).abs().max().item()
                assert err <= K3_REL_L2 and np.isfinite(err), (name, C, logscale, err)
                assert edge <= 1.0, f"{name} edge rows off by {edge} x 2 ulps at C={C}"
                r = res[name]
                r["err"], r["abs"] = max(r["err"], err), max(r["abs"], mab)
                print(f"{name} B=1 C={C} T={T} L={L} f={f} logscale={logscale}: rel_l2 "
                      f"{err:.3e} max_abs {mab:.3e} edge rows {edge:.3f} of 2 ulps",
                      flush=True)
            if logscale:
                xf = x.view(1, T // f, f * C)
                for name, fn in ((names[0], lambda: fused_antialias_activation(
                        x, alpha, beta, lens)), (names[1], lambda: antialias_activation_prefolded(
                        xf, alpha, beta, f, C, lens))):
                    res[name]["times"] = add_spread(res[name]["times"],
                                                    timing_spread(fn, None)[0])
                pms = time_ms(lambda: antialias_snake_plain(x, alpha, beta, lens))
                for name in names:
                    res[name]["plain_ms"] += pms
        nbytes += 2 * T * C * 2 + 2 * C * 4
        ops += K3_OPS_PER_ELEMENT * T * C
    b = bound(nbytes, ops, F32_FLOPS)
    for name, fn in zip(names, (fused_antialias_activation, antialias_activation_prefolded)):
        r = res[name]
        tot = r.pop("times")
        r.update(ms=tot["graph"], library_ms=None, launches=fn.launches, **b,
                 spread=k3_spread(tot))
        print(f"{name} sum over the six stage shapes: kernel {spread_text(tot)} (medians and "
              f"[min-max] of {ATTN_REPS} a shape, summed) plain {r['plain_ms']:.4f} ms bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}); "
              f"{k3_floor_text(ops // K3_OPS_PER_ELEMENT)}; {fn.launches} launches in this "
              f"phase [{card}]", flush=True)
    return res


def _matvec_f64(x, q, *, ln=None, scale=None, bias=None, residual=None):
    """`int8_matvec_plain` with f64 sums: a second summation order."""
    import torch

    from indextts_tpu_torch.ops.int8 import layer_norm_bf16

    if ln is not None:
        x = layer_norm_bf16(x, *ln)
    acc = (x.double() @ q.double().t()).float()
    if scale is None:
        return acc
    v = (acc * scale + bias.float()).to(torch.bfloat16)
    return v if residual is None else residual + v


def _mlp_f64(x, w1q, s1, b1, w2q, *, ln=None, scale2=None, bias2=None, residual=None):
    from indextts_tpu_torch.ops.int8 import gelu_new_bf16

    h = gelu_new_bf16(_matvec_f64(x, w1q, ln=ln, scale=s1, bias=b1))
    return _matvec_f64(h, w2q, scale=scale2, bias=bias2, residual=residual)


def _f64_twins():
    from indextts_tpu_torch.nn import unpack_int4
    from indextts_tpu_torch.ops.decode_step import StepOps, decode_attention_plain

    def matvec4(x, q4, **kw):
        return _matvec_f64(x, unpack_int4(q4), **kw)

    def mlp4(x, w1, s1, b1, w2, **kw):
        return _mlp_f64(x, unpack_int4(w1), s1, b1, unpack_int4(w2), **kw)

    return StepOps(_matvec_f64, _mlp_f64, matvec4, mlp4, decode_attention_plain)


def int8_operands(g, M: int, K: int, N: int):
    import torch

    dev = torch.device("cuda")
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    w = 0.02 * torch.randn((N, K), generator=g, device=dev)
    scale = w.abs().amax(1) / 127.0
    q = torch.round(w / scale[:, None]).to(torch.int8)
    bias = (0.02 * torch.randn((N,), generator=g, device=dev)).to(torch.bfloat16)
    return x, q, scale, bias


def int4_operands(g, M: int, K: int, N: int):
    """x, an int4 weight (N, K/2) from seeded random bf16 values, its scale,
    a bias, and the bf16 weight the int4 one replaces (unpacked x scale)."""
    import torch

    from indextts_tpu_torch.nn import quantize_dense_int4, unpack_int4

    dev = torch.device("cuda")
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    p = quantize_dense_int4({"weight": 0.02 * torch.randn((N, K), generator=g, device=dev)})
    bias = (0.02 * torch.randn((N,), generator=g, device=dev)).to(torch.bfloat16)
    w_bf16 = (unpack_int4(p["q4"]).float() * p["scale"][:, None]).to(torch.bfloat16)
    return x, p["q4"], p["scale"], bias, w_bf16


def k1_case(g):
    """K1 at the shipped decoder's widths: int8 weights from seeded random
    bf16 ones, a (L, 3, 512, 1280) cache filled below pos 300, rows starting
    at 0, 41 and 97 (left padding), a random in-group ancestry map."""
    import torch

    from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims, init_gpt2, quantize_gpt2_int8
    from indextts_tpu_torch.nn import InitRng
    from indextts_tpu_torch.utils.jax_params import to_torch

    dev = torch.device("cuda")
    dims = GPT2Dims(K1_L, K1_D, K1_H)
    bf16_params = to_torch(init_gpt2(InitRng(0, dev), dims), dev, torch.bfloat16)
    params = quantize_gpt2_int8(bf16_params)
    shape = (K1_L, K1_ROWS, K1_S, K1_D)
    kv = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(2)]
    for t in kv:
        t[:, :, K1_POS:] = 0
    starts = [0, 41, 97]
    valid = torch.zeros((K1_ROWS, K1_S), dtype=torch.bool, device=dev)
    for r, s in enumerate(starts):
        valid[r, s:K1_POS + 1] = True
    x = torch.randn((K1_ROWS, K1_D), generator=g, device=dev).to(torch.bfloat16)
    anc = torch.randint(0, K1_ROWS, (K1_ROWS, K1_S), generator=g, device=dev,
                        dtype=torch.int32)
    return dims, bf16_params, params, kv, valid, x, anc, starts


def k1_bound(starts, params, M: int, S: int, L: int, D: int, H: int = K1_H,
             kvq: bool = False) -> dict:
    """Bytes K1 must move at this run's inputs: every weight (int8, or int4
    packed two a byte), scale, bias and LayerNorm vector once, x in and out,
    kv_valid and the ancestry map, each row's valid cached k and v of every
    layer (bf16; or int8 plus the 2H bf16 scales of the position that the
    heads use), the new k/v rows written (the int8 cache: with their
    256-lane scale row); operations: two per weight value and row, plus the
    attention's products."""
    from indextts_tpu_torch.models.gpt.gpt2 import SCALE_LANES

    wbytes = sum(t.numel() * t.element_size() for lp in params["h"]
                 for grp in (lp["attn"], lp["mlp"]) for d in grp.values() for t in d.values())
    wbytes += sum(t.numel() * t.element_size() for lp in params["h"]
                  for ln in (lp["ln_1"], lp["ln_2"]) for t in ln.values())
    n_weights = sum(d["q"].numel() if "q" in d else 2 * d["q4"].numel() for lp in params["h"]
                    for d in (*lp["attn"].values(), *lp["mlp"].values()))
    cached = sum(K1_POS - s for s in starts)
    per_pos, per_row = (2 * D + 2 * H * 2, 2 * D + SCALE_LANES * 2) if kvq else (4 * D, 4 * D)
    nbytes = (wbytes + 2 * M * D * 2 + M * S * (1 + 4)
              + L * cached * per_pos + L * M * per_row)
    ops = 2 * M * n_weights + L * 4 * (cached + M) * D
    return bound(nbytes, ops, BF16_FLOPS)


def k1_against_chain(params, x, dims, pos: int, base: dict, valid, anc, group: int) -> dict:
    """The persistent K1 (`fused_decode_step`, `csrc/decode_step.cu`) and
    the chain of standalone kernels it replaced (`fused_decode_step_chain`)
    on copies of one cache: whether the hidden state, the whole cache after
    the step (every written k/v row and scale row, and nothing else), and
    every layer's input are bit-identical; whether a second launch repeats
    the first; and whether the launch took `step_barriers` grid barriers
    (the barrier's count word)."""
    import torch

    from indextts_tpu_torch.ops.decode_step import (fused_decode_step, fused_decode_step_chain,
                                                    step_barrier, step_barriers)

    caches = [{k: t.clone() for k, t in base.items()} for _ in range(3)]
    count = step_barrier(x.device)
    before = int(count[1])
    lk, lc = [], []
    h = fused_decode_step(params, x, dims, pos, caches[0], valid, anc, group, layer_inputs=lk)
    torch.cuda.synchronize()
    barriers = int(count[1]) - before
    hc = fused_decode_step_chain(params, x, dims, pos, caches[1], valid, anc, group,
                                 layer_inputs=lc)
    h2 = fused_decode_step(params, x, dims, pos, caches[2], valid, anc, group)
    torch.cuda.synchronize()
    out = {"hidden": torch.equal(h, hc),
           "cache": all(torch.equal(caches[0][k], caches[1][k]) for k in base),
           "layers": len(lk) == len(lc) and all(map(torch.equal, lk, lc)),
           "again": torch.equal(h, h2) and all(torch.equal(caches[0][k], caches[2][k])
                                              for k in base),
           "barriers": barriers == step_barriers(len(params["h"]))}
    out["ok"] = all(out.values())
    return out


def k1_timing(params, x, dims, pos: int, cache: dict, valid, anc, group: int) -> dict:
    """The persistent K1 and, in the same call, the chain it replaced:
    device time by graph replay, and eager (CUDA events over the calls,
    host work included)."""
    from indextts_tpu_torch.ops.decode_step import fused_decode_step, fused_decode_step_chain

    def call(fn):
        return lambda: fn(params, x, dims, pos, cache, valid, anc, group)

    return {"ms": graph_ms(call(fused_decode_step)),
            "chain_ms": graph_ms(call(fused_decode_step_chain)),
            "eager_ms": time_ms(call(fused_decode_step), iters=20),
            "chain_eager_ms": time_ms(call(fused_decode_step_chain), iters=10)}


def timing_text(t: dict) -> str:
    return (f"persistent {t['ms']:.4f} ms (eager {t['eager_ms']:.4f}), the chain it replaced "
            f"{t['chain_ms']:.4f} ms (eager {t['chain_eager_ms']:.4f})")


def k1_edge_inputs(g, rows: int, S: int, pos: int):
    """A K1 case of ``rows`` rows at (S, pos): a random bf16 cache zero from
    pos, staggered starts, a random in-group ancestry map (groups of 3)."""
    import torch

    shape = (K1_L, rows, S, K1_D)
    kv = [torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2)]
    for t in kv:
        t[:, :, pos:] = 0
    valid = torch.zeros((rows, S), dtype=torch.bool, device="cuda")
    for r in range(rows):
        valid[r, (37 * r) % (pos + 1):pos + 1] = True
    x = torch.randn((rows, K1_D), generator=g, device="cuda").to(torch.bfloat16)
    anc = torch.randint(0, K1_ROWS, (rows, S), generator=g, device="cuda", dtype=torch.int32)
    return kv, valid, x, anc


def k1_phase(card: str) -> dict:
    """The persistent K1 for each variant (int8, KVQ, W4, int4kv) at
    group=3 and group=1: at the K1 case layer by layer against the twin
    (`twin_by_layer`) and bit-identical to the chain (`k1_against_chain`),
    then bit-identical to the chain at `K1_EDGE_CASES` (pos=0, pos=1, S=2048
    pos=1500, 24 rows). Returns the case count."""
    import torch

    from indextts_tpu_torch.models.gpt.gpt2 import kv_quantize_flat, quantize_gpt2_int4
    from indextts_tpu_torch.ops.decode_step import fused_decode_step

    g = torch.Generator(device="cuda").manual_seed(4)
    dims, bf16_params, params8, kv, valid, x, anc, _ = k1_case(g)
    params4 = quantize_gpt2_int4(bf16_params)
    del bf16_params
    variants = {"int8": (False, False), "kvq": (False, True), "w4": (True, False),
                "int4kv": (True, True)}

    def caches(kv_, kvq):
        if not kvq:
            return {"k": kv_[0], "v": kv_[1]}
        kq, vq, kvs = kv_quantize_flat(kv_[0], kv_[1], K1_H)
        return {"k": kq, "v": vq, "kvs": kvs}

    n = 0
    for name, (w4, kvq) in variants.items():
        params = params4 if w4 else params8
        base = caches(kv, kvq)
        for group in (K1_ROWS, 1):
            rows = slice(0, group)
            b = {k: t[:, rows].contiguous() for k, t in base.items()}
            v, a = valid[rows].contiguous(), (anc if group > 1 else None)
            args = dict(params=params, x=x[rows], dims=dims, pos=K1_POS,
                        kv_cache={k: t.clone() for k, t in b.items()}, kv_valid=v, anc=a,
                        group=group, layer_inputs=[])
            h = fused_decode_step(**args)
            torch.cuda.synchronize()
            tw = twin_by_layer(args, h)
            vs = k1_against_chain(params, x[rows], dims, K1_POS, b, v, a, group)
            print(f"K1 {name} group={group} K1 case: twin layer by layer rel_l2 <= "
                  f"{tw['layer']:.3e}, hidden {tw['hidden']:.3e}, rows {tw['rows_exact']}; "
                  f"against the chain {vs} [{card}]", flush=True)
            assert tw["layer"] <= K1_REL_L2 and tw["hidden"] <= K1_REL_L2, (name, group, tw)
            assert tw["rows_exact"] and vs["ok"], (name, group, tw, vs)
            n += 1
        for label, (rows, S, pos) in K1_EDGE_CASES.items():
            kv_e, valid_e, x_e, anc_e = k1_edge_inputs(g, rows, S, pos)
            base_e = caches(kv_e, kvq)
            del kv_e
            for group in (K1_ROWS, 1):
                vs = k1_against_chain(params, x_e, dims, pos, base_e, valid_e,
                                      anc_e if group > 1 else None, group)
                print(f"K1 {name} group={group} {label} ({rows} rows, S={S}, pos={pos}): "
                      f"against the chain {vs} [{card}]", flush=True)
                assert vs["ok"], (name, group, label, vs)
                n += 1
            del base_e
            torch.cuda.empty_cache()
    return n


def da_case(g, M: int, group: int, kvq: bool, S: int, pos: int, H: int = K1_H):
    """`decode_attention`'s inputs: a random qkv (M, 3 * 64H) of the current
    token, one layer of a (M, S, 64H) cache filled below ``pos`` (the int8
    cache and its scale rows when ``kvq``), rows starting at 0, 41 and 97
    (left padding), a random in-group ancestry map at ``group`` > 1."""
    import torch

    from indextts_tpu_torch.models.gpt.gpt2 import kv_quantize_flat

    dev, D = torch.device("cuda"), 64 * H
    qkv = torch.randn((M, 3 * D), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((M, S, D), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    k[:, pos:], v[:, pos:] = 0, 0
    starts = [0, 41, 97][:M]
    valid = torch.zeros((M, S), dtype=torch.bool, device=dev)
    for r, st in enumerate(starts):
        valid[r, st:pos + 1] = True
    anc = torch.randint(0, group, (M, S), generator=g, device=dev,
                        dtype=torch.int32) if group > 1 else None
    cache = dict(zip(("k", "v", "kvs"), kv_quantize_flat(k, v, H))) if kvq else {"k": k, "v": v}
    return qkv, cache, valid, anc, starts


def da_gathered(cache: dict, anc, group: int) -> dict:
    """The cache with each row's hypothesis gathered physically (anc)."""
    import torch

    M, S = cache["k"].shape[:2]
    dev = cache["k"].device
    rows = (torch.arange(M, device=dev)[:, None] // group) * group + anc.long()
    slot = torch.arange(S, device=dev)[None, :]
    return {k: t[rows, slot].contiguous() for k, t in cache.items()}


def da_bound(starts, M: int, S: int, pos: int, H: int, kvq: bool, anc: bool) -> dict:
    """Bytes `decode_attention` must move at these inputs: each row's valid
    cached k and v (bf16; or int8 plus the 2H bf16 scales a position's heads
    use), qkv in, the output, the new k/v rows written (the int8 cache: with
    their 256-lane scale row), kv_valid and the ancestry map's entries of the
    valid positions, each once; operations: 4 per cached or current value
    (q.k and p.v), on the CUDA cores (f32 sums)."""
    from indextts_tpu_torch.models.gpt.gpt2 import SCALE_LANES

    D, elt = 64 * H, 1 if kvq else 2
    cached = sum(pos - st for st in starts)
    nbytes = (cached * (2 * D * elt + (2 * H * 2 if kvq else 0)) + M * 3 * D * 2 + M * D * 2
              + M * 2 * D * elt + (M * SCALE_LANES * 2 if kvq else 0) + M * S
              + (cached * 4 if anc else 0))
    return bound(nbytes, 4 * D * (cached + M), F32_FLOPS)


def per_call(t, n: int):
    """A `timing_spread` result for calls of n launches, a launch's times."""
    if t is None:
        return None
    return {k: tuple(x / n for x in v) if isinstance(v, tuple) else v / n for k, v in t.items()}


def da_library(qkv, cache: dict, valid, anc, group: int, pos: int, H: int):
    """The yardstick: one `F.scaled_dot_product_attention` call on (M, H, 1,
    64) q against the physically gathered bf16 cache below ``pos`` plus the
    current token, with the key mask; the gather is done here, outside the
    timed call (as K2's yardstick takes pre-roped q and k)."""
    import torch
    import torch.nn.functional as F

    M, D = qkv.shape[0], qkv.shape[1] // 3
    kv = cache if anc is None else da_gathered(cache, anc, group)
    k, v = (torch.cat([kv[n][:, :pos], qkv[:, None, j * D:(j + 1) * D]], 1)
            .reshape(M, pos + 1, H, 64).transpose(1, 2).contiguous()
            for j, n in ((1, "k"), (2, "v")))
    q = qkv[:, :D].reshape(M, H, 1, 64).contiguous()
    mask = valid[:, None, None, :pos + 1].contiguous()
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def decode_attention_phase(card: str) -> dict:
    """K1's attention alone (`decode_attention`, `csrc/decode_attention.cu`)
    at `DA_CASES`: against its twin (rel-L2 <= 1e-2: the bf16 output of f32
    sums in another order), the cache rows written at pos bit-identical to
    the twin's, two launches bit-identical (output and cache), the ancestry
    route bit-identical to the same kernel on the physically gathered cache,
    heads [0, H/2) bit-identical to a call at H/2 heads on those heads'
    slices (K6's shard), and the output bit-identical under a plan of other
    heads a block (`attention_plan(heads=)`). Timed with `timing_spread`
    beside SDPA on the gathered bf16 cache (`da_library`; none for the int8
    cache); the twin by graph replay. Returns the ``kernels`` rows "decode_attention" (the K1
    case) and "decode_attention_kvq", each case's figures under "cases"."""
    import torch

    from indextts_tpu_torch.ops.decode_step import (attention_plan, decode_attention,
                                                    decode_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(7)
    H, cases = K1_H, {}
    for label, (M, group, kvq, S, pos, layers) in DA_CASES.items():
        qkv, base, valid, anc, starts = da_case(g, M, group, kvq, S, pos, H)
        more = [da_case(g, M, group, kvq, S, pos, H)[1] for _ in range(layers - 1)]

        def cache():
            return {k: t.clone() for k, t in base.items()}

        def run(c, q=qkv, heads=H, a=anc, grp=group, plan=None):
            return decode_attention(q, c["k"], c["v"], valid, pos, heads, a, grp, c.get("kvs"),
                                    plan)

        c0, c1, c2 = cache(), cache(), cache()
        out, again = run(c0), run(c1)
        ref = decode_attention_plain(qkv, c2["k"], c2["v"], valid, pos, H, anc, group,
                                     c2.get("kvs"))
        twice = torch.equal(out, again) and all(torch.equal(c0[k], c1[k]) for k in c0)
        rows = all(torch.equal(c0[k][:, pos], c2[k][:, pos]) for k in c0)
        gat_exact = True
        if anc is not None:
            out_gat = run(da_gathered(base, anc, group), a=None, grp=1)
            gat_exact = torch.equal(out, out_gat)
        D, Dh = 64 * H, 64 * (H // 2)
        sub_qkv = torch.cat([qkv[:, j * D:j * D + Dh] for j in range(3)], 1).contiguous()
        sub = {k: t if k == "kvs" else t[..., :Dh] for k, t in cache().items()}
        heads_exact = torch.equal(run({k: t.contiguous() for k, t in sub.items()}, q=sub_qkv,
                                      heads=H // 2), out[:, :Dh])
        other = attention_plan(M, H, pos, kvq,
                               heads=2 if attention_plan(M, H, pos, kvq).heads == 1 else 1)
        plan_exact = torch.equal(run(cache(), plan=other), out)
        torch.cuda.synchronize()
        err, mab = rel_l2(out, ref), (out.float() - ref.float()).abs().max().item()
        c = cache()
        lib = None if kvq else [da_library(qkv, ci, valid, anc, group, pos, H)
                                for ci in [base] + more]
        kt, lt = (per_call(t, layers) for t in timing_spread(
            lambda: [run(ci) for ci in [c] + more], lib and (lambda: [f() for f in lib])))
        pms = graph_ms(lambda: decode_attention_plain(qkv, c["k"], c["v"], valid, pos, H, anc,
                                                      group, c.get("kvs")), iters=3, replays=2)
        b = da_bound(starts, M, S, pos, H, kvq, anc is not None)
        print(f"decode_attention {label}: M={M} group={group} {'int8' if kvq else 'bf16'} cache "
              f"S={S} pos={pos} H={H} starts={starts}, times a call over {layers} layer(s): "
              f"rel_l2 {err:.3e} max_abs {mab:.3e}; "
              f"written rows bit-identical to the twin's: {rows}; two launches bit-identical: "
              f"{twice}; ancestry bit-identical to the gathered cache: "
              f"{gat_exact if anc is not None else 'n/a'}; heads [0, {H // 2}) bit-identical "
              f"to an H={H // 2} call: {heads_exact}; another plan ({other.heads} heads a "
              f"block) bit-identical: {plan_exact}; kernel {spread_text(kt)}, plain (graph) "
              f"{pms:.4f} ms, SDPA on the gathered bf16 cache {spread_text(lt)}; medians and "
              f"[min-max] of {ATTN_REPS}; bound {b['bound_ms']:.5f} ms ({b['bound_by']}) "
              f"[{card}]", flush=True)
        assert err <= K1_REL_L2 and np.isfinite(err), f"decode_attention {label} rel-L2 {err}"
        assert rows and twice and gat_exact and heads_exact and plan_exact, (
            label, rows, twice, gat_exact, heads_exact, plan_exact)
        cases[label] = dict(err=err, abs=mab, plain_ms=pms, **spread_row(kt, lt), **b)
    summary = {k: {"ms": v["ms"], "ms_range": v["spread"]["ms_range"],
                   "library_ms": v["library_ms"], "bound_ms": v["bound_ms"]}
               for k, v in cases.items()}
    res = {}
    for name, label in (("decode_attention", "k1"), ("decode_attention_kvq", "kvq")):
        r = dict(cases[label])
        r["spread"] = {**r["spread"], "cases": summary}
        res[name] = r
    return res


def int8_kernel_phase(card: str) -> dict:
    """K7a, K7b and K1 against their twins at the int8 decode's shapes."""
    import torch
    import torch.nn.functional as F

    from indextts_tpu_torch.models.gpt.gpt2 import gpt2_decode_step
    from indextts_tpu_torch.ops.decode_step import (fused_decode_step, fused_decode_step_plain,
                                                    step_timeline)
    from indextts_tpu_torch.ops.int8 import (int8_matvec, int8_matvec_plain, int8_mlp,
                                             int8_mlp_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2)
    res = {}
    D, M = K1_D, K1_ROWS
    mv = {"err": 0.0, "abs": 0.0}
    shapes = {}
    for name, Mi, N, K in GEMV_SHAPES:
        x, q, scale, bias = int8_operands(g, Mi, K, N)
        out, ref = int8_matvec(x, q), int8_matvec_plain(x, q)
        ep = int8_matvec(x, q, scale=scale, bias=bias)
        ep_ref = int8_matvec_plain(x, q, scale=scale, bias=bias)
        torch.cuda.synchronize()
        err = max(rel_l2(out, ref), rel_l2(ep, ep_ref))
        mab = (out - ref).abs().max().item()
        w_bf16 = (q.float() * scale[:, None]).to(torch.bfloat16)
        kt, lt = timing_spread(lambda: int8_matvec(x, q), lambda: F.linear(x, w_bf16))
        pms = graph_ms(lambda: int8_matvec_plain(x, q))
        b = bound(N * K + Mi * K * 2 + Mi * N * 4, 2 * Mi * N * K, BF16_FLOPS)
        print(f"K7a int8_matvec {name} M={Mi} K={K} N={N} ({plan_text(Mi, N, K)}): rel_l2 "
              f"{err:.3e} max_abs {mab:.3e} device: kernel {spread_text(kt)}; F.linear(bf16 "
              f"weight) {spread_text(lt)}; plain {pms:.4f} ms; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}) [{card}]", flush=True)
        assert err <= K7_REL_L2 and np.isfinite(err), f"K7a rel-L2 {err} at {name}"
        mv["err"], mv["abs"] = max(mv["err"], err), max(mv["abs"], mab)
        shapes[f"{name} M={Mi}"] = gemv_shape_row(kt, lt, b)
        if name == "qkv" and Mi == M:
            mv.update(plain_ms=pms, **b, **spread_row(kt, lt, shapes=shapes))
    res["int8_matvec"] = mv

    x, w1, s1, b1 = int8_operands(g, M, D, 4 * D)
    _, w2, _, _ = int8_operands(g, M, 4 * D, D)
    out, ref = int8_mlp(x, w1, s1, b1, w2), int8_mlp_plain(x, w1, s1, b1, w2)
    torch.cuda.synchronize()
    err, mab = rel_l2(out, ref), (out - ref).abs().max().item()
    ms = graph_ms(lambda: int8_mlp(x, w1, s1, b1, w2))
    pms = graph_ms(lambda: int8_mlp_plain(x, w1, s1, b1, w2))
    eager = time_ms(lambda: int8_mlp(x, w1, s1, b1, w2), iters=50)
    b = bound(2 * 4 * D * D + 4 * D * (4 + 2) + M * D * (2 + 4), 4 * M * 4 * D * D, BF16_FLOPS)
    print(f"K7b int8_mlp M={M} D={D} F={4 * D}: rel_l2 {err:.3e} max_abs {mab:.3e}"
          f" device: kernel {ms:.4f} ms plain {pms:.4f} ms bound {b['bound_ms']:.4f} ms"
          f" ({b['bound_by']}); eager call {eager:.4f} ms [{card}]", flush=True)
    assert err <= K7_REL_L2 and np.isfinite(err), f"K7b rel-L2 {err}"
    res["int8_mlp"] = dict(err=err, abs=mab, ms=ms, plain_ms=pms, library_ms=None, **b)

    dims, bf16_params, params, kv, valid, x, anc, starts = k1_case(g)
    caches = [{"k": kv[0].clone(), "v": kv[1].clone()} for _ in range(3)]
    h = fused_decode_step(params, x, dims, K1_POS, caches[0], valid, anc, M)
    ref = fused_decode_step_plain(params, x, dims, K1_POS, caches[1], valid, anc, M)
    rows = (torch.arange(M, device=x.device)[:, None] // M) * M + anc.long()
    slot = torch.arange(K1_S, device=x.device)[None, :]
    gathered = {k: t[:, rows, slot].contiguous() for k, t in zip("kv", kv)}
    h_gat = fused_decode_step(params, x, dims, K1_POS, gathered, valid)
    torch.cuda.synchronize()
    err, mab = rel_l2(h, ref), (h.float() - ref.float()).abs().max().item()
    row_ulps = max(ulp_err(caches[0][k][0, :, K1_POS], caches[1][k][0, :, K1_POS]) for k in "kv")
    row_err = max(rel_l2(caches[0][k][:, :, K1_POS], caches[1][k][:, :, K1_POS]) for k in "kv")
    exact = torch.equal(h, h_gat) and all(
        torch.equal(caches[0][k][:, :, K1_POS], gathered[k][:, :, K1_POS]) for k in "kv")
    cache = caches[2]
    vs = k1_against_chain(params, x, dims, K1_POS, {"k": kv[0], "v": kv[1]}, valid, anc, M)
    t = k1_timing(params, x, dims, K1_POS, cache, valid, anc, M)
    pms = graph_ms(lambda: fused_decode_step_plain(params, x, dims, K1_POS, cache, valid, anc,
                                                   M), iters=3, replays=2)
    yms = graph_ms(lambda: gpt2_decode_step(bf16_params, x, dims, K1_POS, cache, valid),
                   iters=5, replays=2)
    timeline = step_timeline(params, x, dims, K1_POS, cache, valid, anc, M)
    b = k1_bound(starts, params, M, K1_S, K1_L, K1_D)
    print(f"K1 fused_decode_step L={K1_L} D={K1_D} H={K1_H} B*K={M} S={K1_S} pos={K1_POS} "
          f"starts={starts}: hidden rel_l2 {err:.3e} max_abs {mab:.3e}, k/v rows layer 0 "
          f"{row_ulps:.3f} ulps, all layers rel_l2 {row_err:.3e}, ancestry bit-identical to "
          f"the gathered cache: {exact}; against the chain {vs}; device: {timing_text(t)}, "
          f"plain {pms:.4f} ms, bf16 gpt2_decode_step (yardstick) {yms:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]", flush=True)
    print("K1 timeline, µs a layer (mean over blocks and layers; 'slowest': a phase's slowest "
          "block): " + ", ".join(f"{k} {v:.2f}" for k, v in timeline.items()), flush=True)
    assert err <= K1_REL_L2 and np.isfinite(err), f"K1 hidden rel-L2 {err}"
    assert row_ulps <= 1.0 and row_err <= K1_REL_L2, (row_ulps, row_err)
    assert exact, "K1 with the ancestry map differs from K1 on the gathered cache"
    assert vs["ok"], f"K1 against the chain: {vs}"
    assert gpt2_decode_step.calls > 0                       # the yardstick ran
    res["fused_decode_step"] = dict(err=err, abs=mab, plain_ms=pms, library_ms=None,
                                    bf16_step_ms=yms, timeline=timeline, **t, **b)

    # K1 at group=1, the sampling decode's route: one row, no ancestry map
    x1, valid1 = x[:1], valid[:1]
    c1 = [{k: t[:, :1].clone() for k, t in zip("kv", kv)} for _ in range(2)]
    h1 = fused_decode_step(params, x1, dims, K1_POS, c1[0], valid1)
    ref1 = fused_decode_step_plain(params, x1, dims, K1_POS, c1[1], valid1)
    torch.cuda.synchronize()
    err, mab = rel_l2(h1, ref1), (h1.float() - ref1.float()).abs().max().item()
    t = k1_timing(params, x1, dims, K1_POS, c1[0], valid1, None, 1)
    pms = graph_ms(lambda: fused_decode_step_plain(params, x1, dims, K1_POS, c1[0], valid1),
                   iters=3, replays=2)
    b = k1_bound(starts[:1], params, 1, K1_S, K1_L, K1_D)
    print(f"K1 fused_decode_step group=1 L={K1_L} D={K1_D} H={K1_H} B=1 S={K1_S} pos={K1_POS}:"
          f" hidden rel_l2 {err:.3e} max_abs {mab:.3e}; device: {timing_text(t)}, plain "
          f"{pms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]", flush=True)
    assert err <= K1_REL_L2 and np.isfinite(err), f"K1 group=1 hidden rel-L2 {err}"
    res["fused_decode_step_g1"] = dict(err=err, abs=mab, plain_ms=pms, library_ms=None, **t,
                                       **b)
    return res


def twin_by_layer(args, h) -> dict:
    """K1's call ``args`` (each layer's input under "layer_inputs") and its
    output ``h`` against the twins, layer by layer on the kernel path's
    inputs. The kernel wrote only the rows at pos, which attention does not
    read, so a copy of the cache holds the inputs. Returns the largest
    layer-output rel-L2, the hidden state's after ln_f, and whether every
    layer's written rows (k, v and the int8 cache's scale rows) are
    bit-identical to what the twin attention writes from the kernel's own
    qkv: the qkv GEMV is launched again for that, uncounted (it repeats its
    result exactly), since the twin's qkv differs from the kernel's by the
    f32 summation order, and a LayerNorm value that rounds the other way
    moves a near-zero k/v value by several of its ulps."""
    import torch

    from indextts_tpu_torch import nn
    from indextts_tpu_torch.ops.decode_step import TWINS, decode_layer
    from indextts_tpu_torch.ops.int8 import EPI_BIAS, _gemv_cuda

    pos, kv, xs = args["pos"], args["kv_cache"], args["layer_inputs"]
    rest = dict(heads=args["dims"].heads, pos=pos, kv_valid=args["kv_valid"],
                anc=args["anc"], group=args["group"])
    twin = {k: t.clone() for k, t in kv.items()}
    out = {"layer": 0.0, "rows_exact": True}
    for li, lp in enumerate(args["params"]["h"]):
        layer = {k: t[li].clone() for k, t in twin.items()}
        y = decode_layer(TWINS, lp, xs[li], ck=twin["k"][li], cv=twin["v"][li],
                         kvs=twin["kvs"][li] if "kvs" in twin else None, **rest)
        out["layer"] = max(out["layer"], rel_l2(xs[li + 1], y))
        c_attn, ln = lp["attn"]["c_attn"], (lp["ln_1"]["weight"], lp["ln_1"]["bias"])
        w4 = "q4" in c_attn
        qkv = _gemv_cuda(xs[li], c_attn["q4" if w4 else "q"], ln, c_attn["scale"],
                         c_attn["bias"], EPI_BIAS, None, w4=w4)
        TWINS.attention(qkv, layer["k"], layer["v"], kvs=layer.get("kvs"), **rest)
        out["rows_exact"] &= all(torch.equal(kv[k][li, :, pos], layer[k][:, pos]) for k in kv)
    out["hidden"] = rel_l2(h, nn.layer_norm(args["params"]["ln_f"], y))
    return out


def quant_kernel_phase(card: str, int8_k1: dict) -> dict:
    """The int4 GEMVs and K1's KVQ, W4 and int4kv variants against their
    twins at the decode's shapes (yardsticks: F.linear on the bf16 weight;
    the int8 K1 and the bf16 step of ``int8_k1``)."""
    import torch
    import torch.nn.functional as F

    from indextts_tpu_torch.models.gpt.gpt2 import kv_quantize_flat, quantize_gpt2_int4
    from indextts_tpu_torch.ops.decode_step import fused_decode_step, fused_decode_step_plain
    from indextts_tpu_torch.ops.int8 import (int4_matvec, int4_matvec_plain, int4_mlp,
                                             int4_mlp_plain)

    g = torch.Generator(device="cuda").manual_seed(3)
    res = {}
    D, M = K1_D, K1_ROWS
    mv = {"err": 0.0, "abs": 0.0}
    shapes = {}
    for name, Mi, N, K in GEMV_SHAPES:
        x, q4, scale, bias, w_bf16 = int4_operands(g, Mi, K, N)
        out, ref = int4_matvec(x, q4), int4_matvec_plain(x, q4)
        ep = int4_matvec(x, q4, scale=scale, bias=bias)
        ep_ref = int4_matvec_plain(x, q4, scale=scale, bias=bias)
        torch.cuda.synchronize()
        err = max(rel_l2(out, ref), rel_l2(ep, ep_ref))
        mab = (out - ref).abs().max().item()
        kt, lt = timing_spread(lambda: int4_matvec(x, q4), lambda: F.linear(x, w_bf16))
        pms = graph_ms(lambda: int4_matvec_plain(x, q4))
        b = bound(N * K // 2 + Mi * K * 2 + Mi * N * 4, 2 * Mi * N * K, BF16_FLOPS)
        print(f"W4 int4_matvec {name} M={Mi} K={K} N={N} ({plan_text(Mi, N, K, True)}): "
              f"rel_l2 {err:.3e} max_abs {mab:.3e} device: kernel {spread_text(kt)}; F.linear"
              f"(bf16 weight) {spread_text(lt)}; plain {pms:.4f} ms; bound {b['bound_ms']:.4f}"
              f" ms ({b['bound_by']}) [{card}]", flush=True)
        assert err <= K7_REL_L2 and np.isfinite(err), f"W4 GEMV rel-L2 {err} at {name}"
        mv["err"], mv["abs"] = max(mv["err"], err), max(mv["abs"], mab)
        shapes[f"{name} M={Mi}"] = gemv_shape_row(kt, lt, b)
        if name == "qkv" and Mi == M:
            mv.update(plain_ms=pms, **b, **spread_row(kt, lt, shapes=shapes))
    res["int4_matvec"] = mv

    x, w1, s1, b1, _ = int4_operands(g, M, D, 4 * D)
    _, w2, _, _, _ = int4_operands(g, M, 4 * D, D)
    out, ref = int4_mlp(x, w1, s1, b1, w2), int4_mlp_plain(x, w1, s1, b1, w2)
    torch.cuda.synchronize()
    err, mab = rel_l2(out, ref), (out - ref).abs().max().item()
    ms = graph_ms(lambda: int4_mlp(x, w1, s1, b1, w2))
    pms = graph_ms(lambda: int4_mlp_plain(x, w1, s1, b1, w2))
    b = bound(4 * D * D + 4 * D * (4 + 2) + M * D * (2 + 4), 4 * M * 4 * D * D, BF16_FLOPS)
    print(f"W4 int4_mlp M={M} D={D} F={4 * D}: rel_l2 {err:.3e} max_abs {mab:.3e} device: "
          f"kernel {ms:.4f} ms plain {pms:.4f} ms bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}) [{card}]", flush=True)
    assert err <= K7_REL_L2 and np.isfinite(err), f"W4 MLP rel-L2 {err}"
    res["int4_mlp"] = dict(err=err, abs=mab, ms=ms, plain_ms=pms, library_ms=None, **b)

    dims, bf16_params, params8, kv, valid, x, anc, starts = k1_case(g)
    params4 = quantize_gpt2_int4(bf16_params)
    del bf16_params
    kq, vq, kvs = kv_quantize_flat(kv[0], kv[1], K1_H)
    rows = (torch.arange(M, device=x.device)[:, None] // M) * M + anc.long()
    slot = torch.arange(K1_S, device=x.device)[None, :]
    for name, (w4, kvq) in K1_VARIANTS.items():
        params = params4 if w4 else params8
        base = {"k": kq, "v": vq, "kvs": kvs} if kvq else {"k": kv[0], "v": kv[1]}

        def cache():
            return {k: t.clone() for k, t in base.items()}

        args = dict(params=params, x=x, dims=dims, pos=K1_POS, kv_cache=cache(), kv_valid=valid,
                    anc=anc, group=M, layer_inputs=[])
        h = fused_decode_step(**args)
        ref = fused_decode_step_plain(params, x, dims, K1_POS, cache(), valid, anc, M)
        gathered = {k: t[:, rows, slot].contiguous() for k, t in base.items()}
        h_gat = fused_decode_step(params, x, dims, K1_POS, gathered, valid)
        torch.cuda.synchronize()
        tw = twin_by_layer(args, h)
        chain, mab = rel_l2(h, ref), (h.float() - ref.float()).abs().max().item()
        exact = torch.equal(h, h_gat) and all(
            torch.equal(args["kv_cache"][k][:, :, K1_POS], gathered[k][:, :, K1_POS])
            for k in base)
        c = cache()
        vs = k1_against_chain(params, x, dims, K1_POS, base, valid, anc, M)
        t = k1_timing(params, x, dims, K1_POS, c, valid, anc, M)
        pms = graph_ms(lambda: fused_decode_step_plain(params, x, dims, K1_POS, c, valid, anc,
                                                       M), iters=3, replays=2)
        b = k1_bound(starts, params, M, K1_S, K1_L, K1_D, K1_H, kvq)
        print(f"K1 {name} L={K1_L} D={K1_D} H={K1_H} B*K={M} S={K1_S} pos={K1_POS}: layer by "
              f"layer on the kernel path's inputs: layer outputs rel_l2 <= {tw['layer']:.3e}, "
              f"hidden after ln_f {tw['hidden']:.3e}, written rows bit-identical to the twin's"
              f" write of the kernel's qkv: {tw['rows_exact']}; 24-layer chain against the "
              f"twin {chain:.3e}"
              f" (max_abs {mab:.3e}); ancestry bit-identical to the gathered cache: {exact};"
              f" against the chain {vs}; device: {timing_text(t)}, plain {pms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}); yardsticks: int8 K1 "
              f"{int8_k1['ms']:.4f} ms, bf16 gpt2_decode_step {int8_k1['bf16_step_ms']:.4f} ms "
              f"[{card}]", flush=True)
        assert tw["layer"] <= K1_REL_L2 and tw["hidden"] <= K1_REL_L2, (name, tw)
        assert tw["rows_exact"], (name, tw)
        assert exact, f"K1 {name} with the ancestry map differs from the gathered cache"
        assert vs["ok"], f"K1 {name} against the chain: {vs}"
        res[name] = dict(err=tw["hidden"], abs=mab, plain_ms=pms, library_ms=None, **t, **b)
    return res


def full_c_attn(tp, li: int) -> dict:
    """Layer ``li``'s unsharded qkv projection and ln_1, rebuilt from the
    tp shards (rank t holds rows q_t | k_t | v_t)."""
    import torch

    parts = [shard[li]["attn"]["c_attn"] for shard in tp["shards"]]

    def cat(k):
        rest = parts[0][k].shape[1:]
        return torch.cat([p[k].reshape(3, -1, *rest) for p in parts], 1).reshape(-1, *rest)
    return {"c_attn": {k: cat(k) for k in parts[0]}, "ln_1": tp["shards"][0][li]["ln_1"]}


def tp_twin_by_layer(args, h, full_layers) -> dict:
    """K6's call ``args`` (per layer, the tuple of the shards' inputs under
    "layer_inputs") and its output ``h`` (after ln_f) against the twins,
    layer by layer on the kernel path's inputs (`twin_by_layer`'s scheme:
    the kernel wrote only the rows at pos, so a copy of the cache holds the
    inputs). Returns the largest layer-output rel-L2, the hidden state's
    after ln_f, whether the two shards' residual streams are bit-identical
    at every layer, and whether every layer's written k/v rows are
    bit-identical to K1's qkv GEMV on the same input (the unsharded weight
    and ln_1 of ``full_layers[li]``; launched uncounted), per head slice."""
    import torch

    from indextts_tpu_torch import nn
    from indextts_tpu_torch.ops.decode_step_tp import TWINS, decode_layer_tp, per_rank
    from indextts_tpu_torch.ops.int8 import EPI_BIAS, _gemv_cuda

    tp, pos, xs = args["params"], args["pos"], args["layer_inputs"]
    caches = args["kv_cache"]["shards"]
    devs = tp["mesh"].devices
    twin = [{k: t.clone() for k, t in c.items()} for c in caches]
    D = args["dims"].dim
    Dl = D // len(caches)
    valids, ancs = per_rank(args["kv_valid"], devs), per_rank(args["anc"], devs)
    out = {"layer": 0.0, "streams_equal": True, "rows_exact": True}

    def same(a, b):
        return torch.equal(a, b.to(a.device))

    for li, layers in enumerate(zip(*tp["shards"])):
        out["streams_equal"] &= all(same(xs[li][0], x) for x in xs[li])
        y = decode_layer_tp(TWINS, layers, list(xs[li]), args["dims"].heads // len(caches), pos,
                            twin, li, valids, ancs, args["group"])
        out["layer"] = max(out["layer"], rel_l2(xs[li + 1][0], y[0]))
        lp = full_layers[li]
        ca = lp["c_attn"]
        qkv = _gemv_cuda(xs[li][0], ca["q"], (lp["ln_1"]["weight"], lp["ln_1"]["bias"]),
                         ca["scale"], ca["bias"], EPI_BIAS, None)
        for t, c in enumerate(caches):
            for j, key in ((1, "k"), (2, "v")):
                out["rows_exact"] &= same(qkv[:, j * D + t * Dl:j * D + (t + 1) * Dl],
                                          c[key][li, :, pos])
    out["streams_equal"] &= all(same(xs[-1][0], x) for x in xs[-1])
    out["hidden"] = rel_l2(h, nn.layer_norm(tp["ln_f"], y[0]))
    return out


def tp_bound(tp, starts, M: int, S: int, ranks=(0, 1)) -> dict:
    """Bytes and operations of K6 at this run's inputs on the shards
    ``ranks``: each shard's weights, scales, biases and LayerNorm vectors
    once (the replicated ones once a shard), x in and its residual stream
    out, kv_valid and the ancestry map, its valid cached k/v of every layer
    and its written rows, and each (layer, exchange)'s f32 partial written
    once and read by both shards; operations: two per weight value and row
    plus the attention's products. All ranks: the step on one card (K1's
    bytes plus the partials' and the replicated vectors); one rank: what one
    card would move with the shards on two (not measured)."""
    total_b = total_ops = 0
    for r in ranks:
        layers = tp["shards"][r]
        L = len(layers)
        D = layers[0]["attn"]["c_proj"]["q"].shape[0]
        Dl = layers[0]["attn"]["c_proj"]["q"].shape[1]
        wbytes = sum(t.numel() * t.element_size() for lp in layers
                     for grp in (lp["attn"], lp["mlp"], {"a": lp["ln_1"], "b": lp["ln_2"]})
                     for d in grp.values() for t in d.values())
        n_weights = sum(d["q"].numel() for lp in layers
                        for d in (*lp["attn"].values(), *lp["mlp"].values()))
        cached = sum(K1_POS - st for st in starts)
        total_b += (wbytes + 2 * M * D * 2 + M * S * (1 + 4) + L * cached * 4 * Dl
                    + L * M * 4 * Dl + L * 2 * M * D * 4 * 3)
        total_ops += 2 * M * n_weights + L * 4 * (cached + M) * Dl
    return bound(total_b, total_ops, BF16_FLOPS)


def tp_kernel_phase(card: str, kres: dict) -> dict:
    """K6 `fused_decode_step_tp` with both shards on this card
    (`make_mesh(["cuda:0", "cuda:0"])`, each shard on its own stream) at
    K1's shape: 3 rows at group=3 with a random ancestry map, and 1 row at
    group=1. Each against the twin layer by layer on the kernel path's
    inputs (`tp_twin_by_layer`: rel-L2 <= 1e-2, residual streams and
    written rows bit-identical), its hidden state beside K1's on the same
    inputs; device ms from the replay of a CUDA graph of 20 steps with both
    shard streams forked inside the capture. And `tp_allreduce` alone at
    M=3, N=1280, bit-identical to its twin for either rank."""
    import torch

    from indextts_tpu_torch import nn
    from indextts_tpu_torch.ops.decode_step import fused_decode_step
    from indextts_tpu_torch.ops.decode_step_tp import (fused_decode_step_tp,
                                                       fused_decode_step_tp_plain, tp_allreduce,
                                                       tp_allreduce_plain)
    from indextts_tpu_torch.parallel.mesh import make_mesh, shard_gpt2_tp

    g = torch.Generator(device="cuda").manual_seed(6)
    dims, bf16_params, params, kv, valid, x, anc, starts = k1_case(g)
    del bf16_params
    mesh = make_mesh(list(TP_DEVICES))
    tp = shard_gpt2_tp(params, mesh)
    full = [{"c_attn": lp["attn"]["c_attn"], "ln_1": lp["ln_1"]} for lp in params["h"]]
    Dl = K1_D // mesh.tp
    res = {}
    for name, M, group in (("fused_decode_step_tp", K1_ROWS, K1_ROWS),
                           ("fused_decode_step_tp_g1", 1, 1)):
        xr, vr, ar = x[:M], valid[:M], anc if group > 1 else None

        def cache():
            return {"shards": [{k: kv[i][:, :M, :, t * Dl:(t + 1) * Dl].contiguous()
                                for i, k in enumerate("kv")} for t in range(mesh.tp)]}

        args = dict(params=tp, x=xr, dims=dims, pos=K1_POS, kv_cache=cache(), kv_valid=vr,
                    anc=ar, group=group, layer_inputs=[])
        h = nn.layer_norm(tp["ln_f"], fused_decode_step_tp(**args))
        k1_cache = {k: kv[i][:, :M].clone() for i, k in enumerate("kv")}
        h_k1 = fused_decode_step(params, xr, dims, K1_POS, k1_cache, vr, ar, group)
        torch.cuda.synchronize()
        tw = tp_twin_by_layer(args, h, full)
        vs_k1, mab = rel_l2(h, h_k1), (h.float() - h_k1.float()).abs().max().item()
        c = cache()
        ms = graph_ms(lambda: fused_decode_step_tp(tp, xr, dims, K1_POS, c, vr, ar, group))
        pms = graph_ms(lambda: fused_decode_step_tp_plain(tp, xr, dims, K1_POS, c, vr, ar, group),
                       iters=3, replays=2)
        b = tp_bound(tp, starts[:M], M, K1_S)
        shard_b = tp_bound(tp, starts[:M], M, K1_S, ranks=(0,))
        k1_ms = kres["fused_decode_step" if M == K1_ROWS else "fused_decode_step_g1"]["ms"]
        print(f"K6 {name} L={K1_L} D={K1_D} H={K1_H} (10 a shard) B*K={M} group={group} "
              f"S={K1_S} pos={K1_POS}, shards co-located on two streams: layer by layer on the "
              f"kernel path's inputs: layer outputs rel_l2 <= {tw['layer']:.3e}, hidden after "
              f"ln_f {tw['hidden']:.3e}; residual streams bit-identical: {tw['streams_equal']};"
              f" written rows bit-identical to K1's qkv kernel: {tw['rows_exact']}; hidden "
              f"against K1 on the same inputs {vs_k1:.3e} (max_abs {mab:.3e}); device: kernel "
              f"{ms:.4f} ms plain {pms:.4f} ms K1 {k1_ms:.4f} ms bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}); bound of one shard on two cards (half the weight bytes a "
              f"card; not measured) {shard_b['bound_ms']:.4f} ms [{card}]", flush=True)
        assert tw["layer"] <= K1_REL_L2 and tw["hidden"] <= K1_REL_L2, (name, tw)
        assert tw["streams_equal"] and tw["rows_exact"], (name, tw)
        assert vs_k1 <= K1_REL_L2 and np.isfinite(vs_k1), (name, vs_k1)
        res[name] = dict(err=tw["hidden"], abs=mab, ms=ms, plain_ms=pms, library_ms=None, **b)

    M, N = K1_ROWS, K1_D
    p0, p1 = (torch.randn((M, N), generator=g, device="cuda") * 1e3 for _ in range(2))
    scale = torch.rand((N,), generator=g, device="cuda") / 127 / 30
    bias = (0.1 * torch.randn((N,), generator=g, device="cuda")).to(torch.bfloat16)
    resid = torch.randn((M, N), generator=g, device="cuda").to(torch.bfloat16)
    outs = [tp_allreduce(p0, p1, scale, bias, resid, 0),
            tp_allreduce(p1, p0, scale, bias, resid, 1)]
    ref = tp_allreduce_plain(p0, p1, scale, bias, resid, 0)
    torch.cuda.synchronize()
    exact = all(torch.equal(o, ref) for o in outs)
    mab = max((o.float() - ref.float()).abs().max().item() for o in outs)
    ms = graph_ms(lambda: tp_allreduce(p0, p1, scale, bias, resid, 0))
    pms = graph_ms(lambda: tp_allreduce_plain(p0, p1, scale, bias, resid, 0))
    b = bound(2 * M * N * 4 + N * (4 + 2) + 2 * M * N * 2, 4 * M * N, F32_FLOPS)
    print(f"tp_allreduce M={M} N={N}: bit-identical to the twin for both ranks: {exact} "
          f"(max_abs {mab:.3e}); device: kernel {ms:.4f} ms plain {pms:.4f} ms bound "
          f"{b['bound_ms']:.5f} ms ({b['bound_by']}) [{card}]", flush=True)
    assert exact, "tp_allreduce differs from its twin"
    res["tp_allreduce"] = dict(err=0.0, abs=mab, ms=ms, plain_ms=pms, library_ms=None, **b)
    return res


def reference_check(tts, card: str, flash: bool = False) -> None:
    """The DiT velocity and BigVGAN on a small input with ragged lengths.
    Every kernel call is also run through its plain twin on the same inputs
    as it happens (rel-L2 over valid rows within the kernel-phase bounds,
    and K3's edge rows within 2 ulps); both outputs must be finite. With
    ``flash`` (INDEXTTS_PACKED_ATTN=0 set by the caller) every DiT layer's
    attention is K4's, else K2's."""
    import torch

    from indextts_tpu_torch import nn as tnn
    from indextts_tpu_torch.models.s2mel import dit as dit_mod
    from indextts_tpu_torch.models.vocoder import bigvgan as bv_mod
    from indextts_tpu_torch.ops.attn import (attention_rope, attention_rope_plain,
                                             single_block_attention,
                                             single_block_attention_plain)
    from indextts_tpu_torch.ops.rope import precompute_freqs_cis
    from indextts_tpu_torch.ops.snake import antialias_snake, antialias_snake_plain

    names = ("attention_rope", "single_block_attention", "antialias_snake")
    site = {**{n: 0.0 for n in names}, **{f"{n} calls": 0 for n in names}, "edge": 0.0}

    def checked(name, kernel, plain):
        def run(*args):
            out, ref = kernel(*args), plain(*args)
            site[f"{name} calls"] += 1
            for b, L in enumerate(args[3].tolist()):        # lengths
                rows = (b, slice(None), slice(0, L)) if name == "single_block_attention" \
                    else (b, slice(0, L))
                site[name] = max(site[name], rel_l2(out[rows], ref[rows]))
                if name == "antialias_snake":
                    site["edge"] = max(site["edge"], edge_err(out[b], ref[b], L))
            return out
        return run

    cfg, dev, dt = tts.cfg, tts.device, tts.dtype
    g = torch.Generator(device=dev).manual_seed(1)
    T = 200
    s2 = cfg.s2mel
    x = torch.randn((2, T, 80), generator=g, device=dev)
    prompt = torch.randn((2, T, 80), generator=g, device=dev).to(dt)
    cond = torch.randn((2, T, s2.DiT.content_dim), generator=g, device=dev).to(dt)
    style = torch.randn((2, s2.style_encoder.dim), generator=g, device=dev).to(dt)
    lens = torch.tensor([T, 150], device=dev)
    t = torch.tensor([0.3, 0.3], device=dev)
    fc = torch.as_tensor(precompute_freqs_cis(T, s2.DiT.head_dim), device=dev)
    mel = torch.randn((1, 64, 80), generator=g, device=dev).to(dt)
    mel_lens = torch.tensor([60], device=dev)

    saved = dit_mod.attention_rope, tnn.single_block_attention, bv_mod.antialias_snake
    dit_mod.attention_rope = checked("attention_rope", attention_rope, attention_rope_plain)
    tnn.single_block_attention = checked("single_block_attention", single_block_attention,
                                         single_block_attention_plain)
    bv_mod.antialias_snake = checked("antialias_snake", antialias_snake, antialias_snake_plain)
    try:
        with torch.inference_mode():
            v = dit_mod.dit_forward(tts.s2mel_params["cfm"], s2, x, prompt, lens, t, style,
                                    cond, fc)
            w = bv_mod.bigvgan_forward(tts.bigvgan_params, cfg.bigvgan, mel, mel_lens)
    finally:
        dit_mod.attention_rope, tnn.single_block_attention, bv_mod.antialias_snake = saved
    attn = "single_block_attention" if flash else "attention_rope"
    print(f"reference check (small input, DiT {'flash' if flash else 'packed'} tier), kernel vs"
          f" plain twin at every call: rel_l2 {attn} {site[attn]:.3e} over "
          f"{site[attn + ' calls']} calls, antialias_snake {site['antialias_snake']:.3e}, K3 "
          f"edge rows {site['edge']:.3f} of 2 ulps [{card}]", flush=True)
    other = "attention_rope" if flash else "single_block_attention"
    assert site[f"{attn} calls"] == s2.DiT.depth and site[f"{other} calls"] == 0, site
    assert site[attn] <= K2_REL_L2 and site["antialias_snake"] <= K3_REL_L2, site
    assert site["edge"] <= 1.0, site
    assert bool(torch.isfinite(v).all()) and bool(torch.isfinite(w[0, :60 * 256]).all())


def run_requests(tts, prompt: str, n: int, card: str, label: str, **kwargs) -> list:
    """``n`` requests pinned to 400 codes, with the generation ``kwargs``;
    checks and prints each."""
    reports = []
    for i in range(n):
        sr, wav = tts.infer(spk_audio_prompt=prompt, text=SENTENCE, output_path=None,
                            max_mel_tokens=400, min_new_tokens=399, **kwargs)
        st = dict(tts.last_stage_times)
        clen = st["codes"]
        expect = int(np.float32(clen) * np.float32(1.72)) * 256
        assert sr == 22050 and wav.shape == (expect, 1), (wav.shape, expect)
        assert np.all(np.isfinite(wav)) and np.abs(wav).max() > 0
        reports.append(st)
        stages = " ".join(f"{k}={st[k]:.4f}s" for k in
                          ("prompt", "gpt", "gpt_forward", "s2mel", "bigvgan", "total"))
        print(f"{label} request {i + 1}: codes={clen} audio={st['audio_s']:.4f}s {stages} "
              f"RTF={st['rtf']:.4f} [{card}]", flush=True)
    return reports


def kernel_counters() -> dict:
    """Every launch counter of the port's kernels, by kernel name: (object,
    attribute)."""
    from indextts_tpu_torch.ops.attn import (attention_rope, packed_pair_attention, rope_qk,
                                             single_block_attention)
    from indextts_tpu_torch.ops.decode_step import decode_attention, fused_decode_step
    from indextts_tpu_torch.ops.decode_step_tp import fused_decode_step_tp, tp_allreduce
    from indextts_tpu_torch.ops.int8 import int4_matvec, int4_mlp, int8_matvec, int8_mlp
    from indextts_tpu_torch.ops.snake import (antialias_activation_prefolded, antialias_snake,
                                              fused_antialias_activation)

    counters = {f.__name__: (f, "launches") for f in (
        attention_rope, rope_qk, single_block_attention, packed_pair_attention, antialias_snake,
        fused_antialias_activation, antialias_activation_prefolded, fused_decode_step,
        int8_matvec, int8_mlp, int4_matvec, int4_mlp, decode_attention, fused_decode_step_tp,
        tp_allreduce)}
    counters["decode_attention_kvq"] = (decode_attention, "kvq_launches")
    return counters


def reset_counts() -> None:
    from indextts_tpu_torch.engine import beam, decode
    from indextts_tpu_torch.models.gpt.gpt2 import gpt2_decode_step

    for f, attr in kernel_counters().values():
        setattr(f, attr, 0)
    gpt2_decode_step.calls = 0
    beam.kv_gathers = 0
    decode.span_growths = 0


def read_counts() -> dict:
    from indextts_tpu_torch.engine import beam, decode
    from indextts_tpu_torch.models.gpt.gpt2 import gpt2_decode_step

    counts = {name: getattr(f, attr) for name, (f, attr) in kernel_counters().items()}
    counts.update(gpt2_decode_step=gpt2_decode_step.calls, kv_gathers=beam.kv_gathers,
                  span_growths=decode.span_growths)
    return counts


# pads of spin kernels inside the profiler's window, left out of every
# figure. The window can lose records at both ends: the last 9 steps of a
# 399-step decode in one run, the last 57 steps (some 22,000 records) in
# another, before the tail pad of PROFILE_PAD_LAUNCHES short spins; the bf16
# decode's two first top-k records in a third, its run opening the window; a
# window's first kernel, right after the warm-up step, in runs of
# tools/torch_profiler_window.py. The profiler keeps a device record only if
# it falls inside the window as the host's clock sets it, and the two clocks
# disagree near the edges, so a lead pad opens the window and a tail pad
# closes it, each spanning PROFILE_PAD_S of device time (long spins of
# PROFILE_PAD_CYCLES, ~5 ms each at the H100's clock); the tail pad has the
# short spins first. The smoke prints how many of each pad's records the
# window kept.
PROFILE_PAD_LAUNCHES = 40000
PROFILE_PAD_S = 1.0
PROFILE_PAD_CYCLES = 10_000_000
# the warm-up step's pad: its records are discarded, but take room in the
# profiler's record buffers until the window closes
PROFILE_WARMUP_LAUNCHES = 100


def _spin_pad(devices=("cuda:0",), launches: int = PROFILE_PAD_LAUNCHES,
              seconds: float = PROFILE_PAD_S) -> None:
    """``launches`` short spin kernels over ``devices``, then about
    ``seconds`` of long ones on each, and a synchronize."""
    import torch

    for _ in range(launches // len(devices)):
        for d in devices:
            with torch.cuda.device(d):
                torch.cuda._sleep(100)
    for _ in range(round(seconds / 5e-3)):
        for d in devices:
            with torch.cuda.device(d):
                torch.cuda._sleep(PROFILE_PAD_CYCLES)
    for d in devices:
        torch.cuda.synchronize(d)


def device_records(prof, key=lambda e: e.name(), pads=None) -> tuple:
    """A profiler window's raw device records, the spin pads left out: a
    dict ``key(record)`` -> [count, device ns], and each record's (start,
    end) ns. With ``pads`` (a list), the pads' records' start ns are
    appended to it. Read raw: `key_averages()` builds a Python event object
    for every record first, which cost the bf16 pass, ~400,000 launches in
    its window, about half its time."""
    by: dict = {}
    spans = []
    for e in prof.profiler.kineto_results.events():
        ns = e.duration_ns()
        if ns <= 0 or not str(e.device_type()).endswith("CUDA"):
            continue
        if "spin_kernel" in e.name():
            if pads is not None:
                pads.append(e.start_ns())
            continue
        acc = by.setdefault(key(e), [0, 0])
        acc[0] += 1
        acc[1] += ns
        spans.append((e.start_ns(), e.end_ns()))
    return by, spans


def pads_kept(pads, spans) -> str:
    """How many pad records the window kept before and after the run's."""
    first, last = min(a for a, _ in spans), max(a for a, _ in spans)
    lead, tail = sum(t < first for t in pads), sum(t > last for t in pads)
    return (f"pad records kept: lead {lead} of {round(PROFILE_PAD_S / 5e-3)}, tail {tail} of "
            f"{PROFILE_PAD_LAUNCHES + round(PROFILE_PAD_S / 5e-3)}")


def union_ns(spans) -> int:
    """The time the device was busy on any stream: the union of the records'
    (start, end) intervals, ns."""
    busy, reach = 0, None
    for a, b in sorted(spans):
        if reach is None or a > reach:
            busy, reach = busy + b - a, b
        elif b > reach:
            busy, reach = busy + b - reach, b
    return busy


def profile_s2mel(tts, prompt: str, card: str, label: str, **kwargs) -> None:
    """One more request (after the pass's counts are read) whose CFM solve,
    the s2mel stage's 25 DiT evaluations, runs under `torch.profiler`
    (device activity, spin pads leading and trailing the solve): its synchronized
    wall, the device's busy share over it, the launches, and the DiT
    attention kernels' launches (13 x 25 of the attention kernel, asserted,
    and on the packed tier as many rope passes) and device time, and the
    largest device consumers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from indextts_tpu_torch.pipeline import infer_v2

    cfm, seen = infer_v2.cfm_inference, {}

    def profiled(*args, **kw):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _spin_pad(launches=0)
            t0 = time.perf_counter()
            out = cfm(*args, **kw)
            torch.cuda.synchronize()
            seen["wall"] = time.perf_counter() - t0
            _spin_pad()
        seen["prof"] = prof
        return out

    infer_v2.cfm_inference = profiled
    try:
        tts.infer(spk_audio_prompt=prompt, text=SENTENCE, output_path=None, max_mel_tokens=400,
                  min_new_tokens=399, **kwargs)
    finally:
        infer_v2.cfm_inference = cfm
    pads: list = []
    by_name, spans = device_records(seen["prof"], pads=pads)
    wall, busy = seen["wall"], union_ns(spans) / 1e9
    attn = {k: v for k, v in by_name.items() if "attention_kernel" in k or "rope_qk_kernel" in k}
    n_attn = sum(n for k, (n, _) in attn.items() if "attention_kernel" in k)
    # a kernel's name up to its argument list
    parts = ", ".join(f"{n} x {k[:k.find('(', 1)]} {ns / 1e6:.2f} ms"
                      for k, (n, ns) in attn.items())
    print(f"{label} CFM profile (25 DiT steps): wall {wall:.4f} s, device busy {busy:.4f} s = "
          f"{100 * busy / wall:.1f} % (union), {sum(n for n, _ in by_name.values())} launches; "
          f"attention kernels: {parts}; {pads_kept(pads, spans)}; largest device consumers: "
          f"[{card}]", flush=True)
    for key, (n, ns) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"    {ns / 1e6:9.2f} ms {n:7d} x  {key[:90]}", flush=True)
    assert n_attn == tts.cfg.s2mel.DiT.depth * 25, attn


def profile_decode(tts, prompt: str, card: str, label: str) -> None:
    """The decode of one request (`generate_beam`, 399 steps after the
    prefill) with the request's own prefix: unprofiled wall (best of two),
    then under `torch.profiler` (device activity only: recording every host
    op of the bf16 decode costs minutes): device time, kernels and copies,
    over that wall (the busy share), kernels launched per step, and the
    largest consumers. The profiler's window opens after a discarded warm-up
    step, and a pad of spin kernels (`_spin_pad`, left out of every figure)
    leads and trails the run inside it; the recorded launches of the port's
    GEMV and attention kernels and of the scorer's top-k must equal the
    counters of the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from indextts_tpu_torch.engine.beam import generate_beam
    from indextts_tpu_torch.pipeline.buckets import pick_bucket

    spk, emo = tts._prepare_spk_prompt(prompt), tts._prepare_emo_cond(prompt)
    ids = tts.tokenizer.convert_tokens_to_ids(tts.tokenizer.tokenize(SENTENCE))
    text_ids = np.zeros((1, pick_bucket(len(ids), tts.cfg.engine.text_buckets)), np.int64)
    text_ids[0, :len(ids)] = ids
    _, _, embeds, mask = tts.prefix(spk, emo, 1.0, text_ids, len(ids))
    sampling = tts._sampling({"min_new_tokens": DECODE_STEPS})

    def run():
        with torch.inference_mode():
            generate_beam(tts.gpt_params, tts.cfg.gpt, tts.gpt_dims, embeds, mask,
                          tts.generator, DECODE_STEPS + 1, sampling, tts.dtype)
        torch.cuda.synchronize()

    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        _spin_pad(launches=PROFILE_WARMUP_LAUNCHES, seconds=0)
        prof.step()
        _spin_pad(launches=0)
        reset_counts()
        run()
        counts = read_counts()
        _spin_pad()
        prof.step()
    t_parse = time.perf_counter()
    pads: list = []
    by_name, spans = device_records(prof, pads=pads)
    busy_ns = union_ns(spans)
    t_parse = time.perf_counter() - t_parse
    device = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    kernels = [(k, v) for k, v in device if not k.startswith(("Memcpy", "Memset"))]
    device_s = sum(ns for _, (_, ns) in device) / 1e9
    launches = sum(n for _, (n, _) in kernels)

    def recorded(name):
        return sum(n for k, (n, _) in kernels if name in k)

    # each scorer step (the prefill's and the 399 decode steps') calls
    # torch.topk twice: the top-k warper and the candidate draw
    got = {"step": recorded("decode_step_kernel"), "gemv": recorded("int8_gemv_kernel"),
           "attention": recorded("decode_attention_kernel"),
           "allreduce": recorded("tp_allreduce_kernel"), "topk": recorded("gatherTopK")}
    # K1: one persistent launch a step; one GEMV launch a matvec, two an MLP
    want = {"step": counts["fused_decode_step"],
            "gemv": counts["int8_matvec"] + counts["int4_matvec"]
            + 2 * (counts["int8_mlp"] + counts["int4_mlp"]),
            "attention": counts["decode_attention"] + counts["decode_attention_kvq"],
            "allreduce": counts["tp_allreduce"], "topk": 2 * (DECODE_STEPS + 1)}
    print(f"{label} decode profile ({DECODE_STEPS} steps): wall {min(walls):.4f} s unprofiled "
          f"(runs {walls[0]:.4f}, {walls[1]:.4f}), device time {device_s:.4f} s (sum over "
          f"records), busy {busy_ns / 1e9:.4f} s = {100 * busy_ns / 1e9 / min(walls):.1f} % "
          f"(union over streams), {launches} launches "
          f"({launches / DECODE_STEPS:.0f} per step); recorded launches {got}, counters "
          f"{want}; profiled window and records read in {time.perf_counter() - t_prof:.1f} s "
          f"(reading {t_parse:.1f} s); {pads_kept(pads, spans)} [{card}]", flush=True)
    for key, (n, ns) in device[:6]:
        print(f"    {ns / 1e6:9.2f} ms {n:7d} x  {key[:90]}", flush=True)
    assert got == want, f"{label} profile recorded {got}, the counters say {want}"


def pipeline_phase(card: str, prompt: str, model_dir: str) -> dict:
    """The bf16 pass (the first slice's main path): two requests."""
    import torch

    from indextts_tpu_torch.models.vocoder.bigvgan import activation1d_calls
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    t0 = time.perf_counter()
    tts = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"bf16 model build (random weights, shipped widths): "
          f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    n_tok = len(tts.tokenizer.split_segments(tts.tokenizer.tokenize(SENTENCE), 120))
    assert n_tok == 1, f"smoke text must be one segment, got {n_tok}"

    reset_counts()
    run_requests(tts, prompt, BF16_REQUESTS, card, "bf16")
    counts = read_counts()
    cfg = tts.cfg
    want_k2 = BF16_REQUESTS * cfg.s2mel.DiT.depth * 25   # depth x CFG-stacked Euler steps
    want_k3 = BF16_REQUESTS * activation1d_calls(cfg.bigvgan)
    print(f"launches over {BF16_REQUESTS} bf16 requests: {counts} (expect attention_rope and "
          f"its rope pass rope_qk {want_k2}, antialias_snake {want_k3})", flush=True)
    assert counts["attention_rope"] == counts["rope_qk"] == want_k2, counts
    assert counts["antialias_snake"] == want_k3, counts
    assert counts["fused_decode_step"] == 0 and counts["kv_gathers"] > 0, counts
    reference_check(tts, card)
    profile_s2mel(tts, prompt, card, "bf16 (DiT packed tier, K2)")
    profile_decode(tts, prompt, card, "bf16")
    del tts
    torch.cuda.empty_cache()
    return counts


def want_counts(tts, quantization: str, n: int) -> dict:
    """The launches ``n`` requests of a quantized pass must make: K1 once a
    decode step (under a tp mesh K6, with two `tp_allreduce` a layer and
    shard);
    per layer and step (and shard) the int8 or int4 GEMVs (qkv and
    attn-proj, and the MLP) and the bf16- or int8-cache attention; K2 / K3
    (and K2's rope pass) as in the bf16 pass; no bf16 step, no cache gather, no cache growth
    (the beam engine sizes its cache once), and none of the kernels without
    a caller on this path."""
    from indextts_tpu_torch.models.vocoder.bigvgan import activation1d_calls

    steps, L = n * DECODE_STEPS, tts.cfg.gpt.layers
    tp = tts.mesh.tp if tts.mesh is not None else 0
    # K1 is one persistent launch a step and launches none of the standalone
    # kernels; K6 runs the int8 GEMVs and the attention a layer and shard,
    # and each shard two exchanges (`tp_allreduce`) a layer
    return {"attention_rope": n * tts.cfg.s2mel.DiT.depth * 25,
            "rope_qk": n * tts.cfg.s2mel.DiT.depth * 25,      # K2's rope pass
            "antialias_snake": n * activation1d_calls(tts.cfg.bigvgan),
            "fused_decode_step": 0 if tp else steps, "fused_decode_step_tp": steps if tp else 0,
            "tp_allreduce": 2 * tp * L * steps,
            "int8_matvec": 2 * tp * L * steps, "int8_mlp": tp * L * steps,
            "int4_matvec": 0, "int4_mlp": 0,
            "decode_attention": tp * L * steps, "decode_attention_kvq": 0,
            "single_block_attention": 0, "packed_pair_attention": 0,
            "fused_antialias_activation": 0, "antialias_activation_prefolded": 0,
            "gpt2_decode_step": 0, "kv_gathers": 0, "span_growths": 0}


def k1_twin_check():
    """A ``decode_check`` hook that holds the first 8 K1 calls against the
    twin on the same inputs, layer by layer (`twin_by_layer`), and puts the
    24-layer chain of the twin with f32 and with f64 sums beside it; and
    the ``site`` dict it fills (``groups`` records every call's group and
    whether it had an ancestry map)."""
    from indextts_tpu_torch import nn
    from indextts_tpu_torch.ops.decode_step import TWINS, decode_layer

    site = {"n": 0, "layer": 0.0, "hidden": 0.0, "rows_exact": True, "chain": 0.0,
            "floor": 0.0, "groups": set()}

    def check(args, h):
        site["groups"].add((args["group"], args["anc"] is not None))
        if site["n"] >= TWIN_CHECKED_STEPS:
            return
        site["n"] += 1
        tw = twin_by_layer(args, h)
        for key in ("layer", "hidden"):
            site[key] = max(site[key], tw[key])
        site["rows_exact"] &= tw["rows_exact"]
        kv = args["kv_cache"]
        rest = dict(heads=args["dims"].heads, pos=args["pos"], kv_valid=args["kv_valid"],
                    anc=args["anc"], group=args["group"])
        chains = []
        for ops in (TWINS, _f64_twins()):
            x, twin = args["x"], {k: t.clone() for k, t in kv.items()}
            for li, lp in enumerate(args["params"]["h"]):
                x = decode_layer(ops, lp, x, ck=twin["k"][li], cv=twin["v"][li],
                                 kvs=twin["kvs"][li] if "kvs" in twin else None, **rest)
            chains.append(nn.layer_norm(args["params"]["ln_f"], x))
        site["chain"] = max(site["chain"], rel_l2(h, chains[0]))
        site["floor"] = max(site["floor"], rel_l2(chains[1], chains[0]))

    return site, check


def report_k1_twin_check(site: dict, label: str, card: str) -> None:
    print(f"{label} twin check of the first {site['n']} K1 calls, layer by layer on the "
          f"kernel path's inputs: layer outputs rel_l2 <= {site['layer']:.3e}, hidden after "
          f"ln_f {site['hidden']:.3e}, written rows bit-identical to the twin's write of the "
          f"kernel's qkv: {site['rows_exact']}; the 24-layer chain of the twin: "
          f"{site['chain']:.3e} "
          f"(noise floor, twin with f64 against f32 sums: {site['floor']:.3e}) [{card}]",
          flush=True)
    assert site["n"] == TWIN_CHECKED_STEPS, site
    assert site["layer"] <= K1_REL_L2 and site["hidden"] <= K1_REL_L2, site
    assert site["rows_exact"], site


def quant_pipeline_phase(card: str, prompt: str, model_dir: str, quantization: str,
                         n_requests: int, profiled: bool) -> dict:
    """A quantized pass (int8, int8kv, int4 or int4kv): ``n_requests``
    requests through K1 with the ancestry map; the first 8 K1 calls held
    against the twin at the call site."""
    import torch

    from indextts_tpu_torch.engine import beam
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    t0 = time.perf_counter()
    tts = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cuda", seed=0,
                    quantization=quantization)
    torch.cuda.synchronize()
    print(f"{quantization} model build (random weights, shipped widths): "
          f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    site, check = k1_twin_check()
    reset_counts()
    tts.decode_check = check
    reports = run_requests(tts, prompt, 1, card, f"{quantization} (first 8 K1 steps twin-checked)")
    tts.decode_check = None
    reports += run_requests(tts, prompt, n_requests - 1, card, quantization)
    counts = read_counts()
    want = want_counts(tts, quantization, n_requests)
    print(f"launches over {n_requests} {quantization} requests: {counts} (expect {want}); "
          f"ancestry route: {beam.last_use_anc}", flush=True)
    report_k1_twin_check(site, quantization, card)
    assert counts == want, (counts, want)
    assert beam.last_use_anc is True and site["groups"] == {(3, True)}, site["groups"]
    if profiled:
        profile_decode(tts, prompt, card, quantization)
    del tts
    torch.cuda.empty_cache()
    return counts, reports


def tp_twin_check():
    """A ``decode_check`` hook that holds the first 8 K6 calls against the
    twin layer by layer (`tp_twin_by_layer`), and the ``site`` dict it
    fills (``groups``: every call's group and whether it had an ancestry
    map)."""
    site = {"n": 0, "layer": 0.0, "hidden": 0.0, "streams_equal": True, "rows_exact": True,
            "groups": set()}
    full: dict = {}

    def check(args, h):
        site["groups"].add((args["group"], args["anc"] is not None))
        if site["n"] >= TWIN_CHECKED_STEPS:
            return
        site["n"] += 1
        if not full:
            full["layers"] = [full_c_attn(args["params"], li)
                              for li in range(len(args["params"]["shards"][0]))]
        tw = tp_twin_by_layer(args, h, full["layers"])
        for key in ("layer", "hidden"):
            site[key] = max(site[key], tw[key])
        for key in ("streams_equal", "rows_exact"):
            site[key] &= tw[key]

    return site, check


def tp_pipeline_phase(card: str, prompt: str, model_dir: str, int8_gpt: float) -> dict:
    """The tp=2 int8 serving decode, both shards on this card:
    `IndexTTS2(quantization="int8", mesh=make_mesh(["cuda:0", "cuda:0"]))`
    under INDEXTTS_TP_DECODE=kernel. One num_beams=3 request, its first 8 K6
    calls held against the twin layer by layer (`tp_twin_check`), then one
    num_beams=1 request; each with exact launch counts (K6 once a decode
    step); the gpt stage beside the int8 pass's (``int8_gpt``, its second
    request); a profiled tp decode. Returns the counts of each request."""
    import torch

    from indextts_tpu_torch.engine import beam, decode
    from indextts_tpu_torch.parallel.mesh import make_mesh
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    saved = os.environ.get("INDEXTTS_TP_DECODE")
    os.environ["INDEXTTS_TP_DECODE"] = "kernel"
    try:
        t0 = time.perf_counter()
        tts = IndexTTS2(cfg_path=None, model_dir=model_dir, seed=0, quantization="int8",
                        mesh=make_mesh(list(TP_DEVICES)))
        torch.cuda.synchronize()
        print(f"tp model build ({tts.mesh}, random weights, shipped widths): "
              f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
        site, check = tp_twin_check()
        reset_counts()
        tts.decode_check = check
        beams = run_requests(tts, prompt, 1, card, "tp int8 (first 8 K6 steps twin-checked)")[0]
        tts.decode_check = None
        counts = {"tp": read_counts()}
        want = want_counts(tts, "int8", 1)
        print(f"launches of the tp num_beams=3 request: {counts['tp']} (expect {want}); ancestry "
              f"route: {beam.last_use_anc}; K6 calls (group, ancestry map): {site['groups']}",
              flush=True)
        print(f"tp twin check of the first {site['n']} K6 calls, layer by layer on the kernel "
              f"path's inputs: layer outputs rel_l2 <= {site['layer']:.3e}, hidden after ln_f "
              f"{site['hidden']:.3e}, residual streams bit-identical: {site['streams_equal']}, "
              f"written rows bit-identical to K1's qkv kernel: {site['rows_exact']} [{card}]",
              flush=True)
        assert site["n"] == TWIN_CHECKED_STEPS, site
        assert site["layer"] <= K1_REL_L2 and site["hidden"] <= K1_REL_L2, site
        assert site["streams_equal"] and site["rows_exact"], site
        assert counts["tp"] == want, (counts["tp"], want)
        assert beam.last_use_anc is True and site["groups"] == {(3, True)}, site["groups"]

        reset_counts()
        sampling = run_requests(tts, prompt, 1, card, "tp int8 num_beams=1", num_beams=1)[0]
        counts["tp_sampling"] = read_counts()
        want["span_growths"] = 1
        print(f"launches of the tp num_beams=1 request: {counts['tp_sampling']} (expect {want}); "
              f"decode route {decode.last_route}", flush=True)
        assert counts["tp_sampling"] == want and decode.last_route == "tp", counts
        print(f"gpt stage: tp num_beams=3 {beams['gpt']:.4f} s, tp num_beams=1 "
              f"{sampling['gpt']:.4f} s, against the int8 pass's num_beams=3 request "
              f"{int8_gpt:.4f} s: {beams['gpt'] / int8_gpt:.3f}x [{card}]", flush=True)
        profile_decode(tts, prompt, card, "tp")
    finally:
        if saved is None:
            del os.environ["INDEXTTS_TP_DECODE"]
        else:
            os.environ["INDEXTTS_TP_DECODE"] = saved
    del tts
    torch.cuda.empty_cache()
    return counts


def sampling_pipeline_phase(card: str, prompt: str, model_dir: str) -> dict:
    """The num_beams=1 sampling decode (`engine/decode.py::
    generate_adaptive`) with int8 weights, two requests pinned to 400 codes,
    so the cache grows once (the 256-code span, then 400). Request 1, on
    the packed DiT tier: K1 once a decode step, every call at group=1
    without an ancestry map, the first 8 held against the twin layer by
    layer; the bf16 step and the beam engine never run; one span growth.
    Request 2 with INDEXTTS_PACKED_ATTN=0, the DiT's flash tier: the same,
    with K4 once per DiT layer and CFG step and K2 never; then every K4
    call of the DiT on a small input against its twin. Returns the counts
    of each request."""
    import torch

    from indextts_tpu_torch.engine import beam, decode
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    t0 = time.perf_counter()
    tts = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cuda", seed=0,
                    quantization="int8")
    torch.cuda.synchronize()
    print(f"int8 model build for the sampling pass: {time.perf_counter() - t0:.2f} s [{card}]",
          flush=True)
    dit_calls = tts.cfg.s2mel.DiT.depth * 25            # depth x CFG-stacked Euler steps
    site, check = k1_twin_check()
    beam.last_use_anc = None
    reset_counts()
    tts.decode_check = check
    packed = run_requests(tts, prompt, 1, card, "int8 num_beams=1 (packed DiT tier; first 8 K1 "
                          "steps twin-checked)", num_beams=1)[0]
    tts.decode_check = None
    counts = {"sampling": read_counts()}
    want = want_counts(tts, "int8", 1)
    want["span_growths"] = 1
    print(f"launches of the num_beams=1 request: {counts['sampling']} (expect {want}); decode "
          f"route {decode.last_route}, K1 calls (group, ancestry map): {site['groups']}",
          flush=True)
    report_k1_twin_check(site, "int8 num_beams=1", card)
    assert counts["sampling"] == want, (counts["sampling"], want)
    assert decode.last_route == "fused" and site["groups"] == {(1, False)}, site["groups"]
    assert beam.last_use_anc is None                    # the beam engine never ran

    saved = os.environ.get("INDEXTTS_PACKED_ATTN")
    os.environ["INDEXTTS_PACKED_ATTN"] = "0"
    try:
        reset_counts()
        flash = run_requests(tts, prompt, 1, card, "int8 num_beams=1, DiT flash tier (K4)",
                             num_beams=1)[0]
        counts["flash"] = read_counts()
        reference_check(tts, card, flash=True)
        profile_s2mel(tts, prompt, card, "int8 num_beams=1 (DiT flash tier, K4)", num_beams=1)
    finally:
        if saved is None:
            del os.environ["INDEXTTS_PACKED_ATTN"]
        else:
            os.environ["INDEXTTS_PACKED_ATTN"] = saved
    want.update(attention_rope=0, rope_qk=0, single_block_attention=dit_calls)
    print(f"launches of the flash-tier request: {counts['flash']} (expect {want}); s2mel stage "
          f"flash tier (K4) {flash['s2mel']:.4f} s against packed tier (K2) "
          f"{packed['s2mel']:.4f} s [{card}]", flush=True)
    assert counts["flash"] == want, (counts["flash"], want)
    del tts
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing measured", file=sys.stderr)
        return 2
    try:
        from indextts_tpu_torch.ops import cuda
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    card = card_line()
    print(f"card: {card}", flush=True)
    print(sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda,
          flush=True)
    t0 = time.perf_counter()
    lib = cuda.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s -> {lib}", flush=True)
    log = (lib.parent / "build.log").read_text()
    print(log, flush=True)
    print("int8_gemv_kernel (csrc/int8_gemv.cu), registers / shared memory / spills a "
          "block:\n  " + "\n  ".join(build_lines(log, "int8_gemv_kernel")), flush=True)

    def mark(what):
        print(f"-- {what} at {time.perf_counter() - t0:.1f} s", flush=True)

    kres = kernel_phase(card)
    kres.update(attention_kernel_phase(card))
    kres.update(antialias_entries_phase(card))
    kres.update(int8_kernel_phase(card))
    kres.update(decode_attention_phase(card))
    kres.update(quant_kernel_phase(card, kres["fused_decode_step"]))
    n_k1 = k1_phase(card)
    mark(f"K1 phase done ({n_k1} cases bit-identical to the chain)")
    kres.update(tp_kernel_phase(card, kres))
    phase_counts = read_counts()
    for name in ("int4_matvec", "int4_mlp", "decode_attention_kvq"):  # the chain's only
        kres[name]["launches"] = phase_counts[name]
    mark("kernel phase done")
    with tempfile.TemporaryDirectory(prefix="indextts_smoke_") as d:
        prompt = build_fake_assets(d)
        counts = {"bf16": pipeline_phase(card, prompt, d)}
        mark("bf16 pass done")
        counts["int8"], int8_reports = quant_pipeline_phase(card, prompt, d, "int8",
                                                            INT8_REQUESTS, True)
        mark("int8 pass done")
        counts.update(sampling_pipeline_phase(card, prompt, d))
        mark("sampling pass done")
        for quantization, (n, profiled) in QUANT_PASSES.items():
            counts[quantization] = quant_pipeline_phase(card, prompt, d, quantization, n,
                                                        profiled)[0]
            mark(f"{quantization} pass done")
        counts.update(tp_pipeline_phase(card, prompt, d, int8_reports[-1]["gpt"]))
        mark("tp pass done")
    assert "jax" not in sys.modules, "the port imported jax"
    assert not any(m == "indextts_tpu" or m.startswith("indextts_tpu.") for m in sys.modules)

    k1 = "decode_step.py:460"
    k1_src = ("decode_step.cu", "gemv_core.cuh", "decode_attention_core.cuh")
    k6_src = ("tp_allreduce.cu", "int8_gemv.cu", "decode_attention.cu")
    # name, counter, sources (the first the row's "source"; a decode step's
    # time covers all of them), TPU kernel replaced, the pass whose
    # launches count (None: no pipeline caller, the kernel phase's launches)
    k2_src = ("attention_rope.cu", "attention_tma.cuh")
    specs = (("attention_rope", "attention_rope", k2_src, "attn.py:188", "bf16"),
             ("antialias_snake", "antialias_snake", "antialias_snake.cu", "antialias.py:269",
              "bf16"),
             ("fused_decode_step", "fused_decode_step", k1_src, k1, "int8"),
             ("decode_attention", "decode_attention", ("decode_attention.cu",
                                                        "decode_attention_core.cuh"),
              f"{k1} (attention, :257-419)", "tp"),
             ("decode_attention_kvq", None, ("decode_attention.cu", "decode_attention_core.cuh"),
              f"{k1} (attention, KVQ)", None),
             ("int8_matvec", "int8_matvec", ("int8_gemv.cu", "gemv_core.cuh"),
              "int8_matmul.py:104", "tp"),
             ("int8_mlp", "int8_mlp", ("int8_gemv.cu", "gemv_core.cuh"), "int8_matmul.py:71",
              "tp"),
             ("fused_decode_step_kvq", "fused_decode_step", k1_src, f"{k1} (KVQ)", "int8kv"),
             ("fused_decode_step_w4", "fused_decode_step", k1_src, f"{k1} (W4)", "int4"),
             ("fused_decode_step_w4_kvq", "fused_decode_step", k1_src, f"{k1} (W4, KVQ)",
              "int4kv"),
             ("int4_matvec", None, ("int8_gemv.cu", "gemv_core.cuh"), f"{k1} (W4)", None),
             ("int4_mlp", None, ("int8_gemv.cu", "gemv_core.cuh"), f"{k1} (W4)", None),
             ("fused_decode_step_g1", "fused_decode_step", k1_src, f"{k1} (group=1)",
              "sampling"),
             ("single_block_attention", "single_block_attention",
              ("attention_block.cu", "attention_tma.cuh"), "attn.py:253", "flash"),
             ("packed_pair_attention", None, k2_src, "attn.py:76", None),
             ("fused_antialias_activation", None, "antialias_snake.cu", "antialias.py:457",
              None),
             ("antialias_activation_prefolded", None, "antialias_snake.cu", "antialias.py:322",
              None),
             ("fused_decode_step_tp", "fused_decode_step_tp", k6_src, "decode_step_tp.py:367",
              "tp"),
             ("fused_decode_step_tp_g1", "fused_decode_step_tp", k6_src,
              "decode_step_tp.py:367 (group=1)", "tp_sampling"),
             ("tp_allreduce", "tp_allreduce", "tp_allreduce.cu",
              "decode_step_tp.py:367 (all_reduce, :201)", "tp"))
    kernels = []
    for name, counter, src, tpu, pass_ in specs:
        r = kres[name]
        srcs = [f"indextts_tpu_torch/csrc/{f}" for f in ((src,) if isinstance(src, str) else src)]
        kernels.append({"name": name, "route": "cuda", "source": srcs[0],
                        **({"sources": srcs} if len(srcs) > 1 else {}),
                        "replaces": f"indextts_tpu/ops/pallas/{tpu}",
                        "launches": r["launches"] if pass_ is None else counts[pass_][counter],
                        "launched_in": pass_ or "kernel phase (no pipeline caller)",
                        "max_abs_err": r["abs"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        **r.get("spread", {})})
    for k, name in zip(kernels, (spec[0] for spec in specs)):
        r = kres[name]
        if "chain_ms" in r:   # K1: the persistent kernel's eager time, the chain's as "was"
            k.update(eager_ms=r["eager_ms"], was_chain_ms=r["chain_ms"],
                     was_chain_eager_ms=r["chain_eager_ms"])
    assert all(math.isfinite(k["ms"]) and k["launches"] > 0 for k in kernels), kernels
    print(f"kernels line: ms and library_ms of attention_rope, packed_pair_attention, "
          f"single_block_attention, int8_matvec and int4_matvec are graph-replay medians of "
          f"{ATTN_REPS} (their rows' ms_timing; the GEMV rows at qkv, M=3, every shape under "
          f"'shapes'); the K1 rows' ms (graph replay) and eager_ms are the persistent "
          f"kernel's, was_chain_ms the chain it replaced in the same call; the standalone "
          f"GEMV and attention rows count their launches in the tp pass (K6), or, for the "
          f"chain's only (int4, KVQ), in the kernel phase; every other row as timed in its "
          f"phase", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
