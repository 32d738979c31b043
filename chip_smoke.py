#!/usr/bin/env python3
"""Drive the PyTorch port (`indextts_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

1. Set-up: prints the card's name and power limit, builds the CUDA kernels
   from `indextts_tpu_torch/csrc` (nvcc, sm_90a).
2. Kernel phase: each hand-written kernel against its plain PyTorch twin on
   the same bf16 inputs at the main path's shapes, with ragged lengths:
   K2 `attention_rope` (rel-L2 <= 2e-2 over valid query rows) and K3
   `antialias_snake` (rel-L2 <= 1e-3 over valid rows, and within 2 bf16
   ulps on the 4 rows at each edge); kernel and plain times from CUDA events
   after warm-up.
3. Pipeline phase: `IndexTTS2(cfg_path=None, device="cuda")` at the shipped
   widths with seeded random weights, a synthetic bpe.model and a 5 s prompt
   wav; three single-segment requests with the default generation kwargs
   (beam sampling, num_beams=3), decode pinned to 400 codes as the JAX
   bench pins it. Checks: finite wavs of int(codes * 1.72) * 256 samples,
   launch counts of both kernels equal to what three requests must make,
   and, on a small input, every kernel call of the DiT and BigVGAN against
   its plain twin on the same inputs.

Prints per-stage times and RTF beside the card, then (second to last line)
one JSON object describing the kernels, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero with its
traceback. Exits 2 without a result when CUDA is unavailable or the port's
package cannot be imported (e.g. run outside the repository).
"""

import json
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
MEL_FRAMES = 768                           # the 400-code mel bucket
K3_SHAPES = ((768, 4), (384, 16), (192, 32), (96, 64), (48, 128), (24, 256))
K2_REL_L2 = 2e-2                           # the repo's packed_attn_rel_l2 gate
K3_REL_L2 = 1e-3                           # bf16 output rounding is ~2e-5 here
EDGE_ROWS = 4                              # the halo a K3 output row reads: 3


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


def rel_l2(a, b) -> float:
    import torch

    return (torch.linalg.norm((a - b).float()) / torch.linalg.norm(b.float())).item()


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

    from indextts_tpu_torch.ops.attn import attention_rope, attention_rope_plain
    from indextts_tpu_torch.ops.rope import precompute_freqs_cis
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
        ms = time_ms(lambda: attention_rope(q, k, v, lens, fc, H))
        pms = time_ms(lambda: attention_rope_plain(q, k, v, lens, fc, H))
        print(f"K2 attention_rope B=2 H={H} D={D} T={T}: rel_l2 {err:.3e} max_abs {mab:.3e}"
              f" kernel {ms:.4f} ms plain {pms:.4f} ms [{card}]", flush=True)
        assert err <= K2_REL_L2 and np.isfinite(err), f"K2 rel-L2 {err} > {K2_REL_L2} at T={T}"
        r = res["attention_rope"]
        r["err"], r["abs"] = max(r["err"], err), max(r["abs"], mab)
        if T == K2_TS[0]:
            r["ms"], r["plain_ms"] = ms, pms

    tot_ms = tot_pms = 0.0
    for C, up in K3_SHAPES:
        T = MEL_FRAMES * up
        x = (2 * torch.randn((1, T, C), generator=g, device=dev)).to(torch.bfloat16)
        alpha = 0.3 * torch.randn((C,), generator=g, device=dev)
        beta = 0.3 * torch.randn((C,), generator=g, device=dev)
        L = 700 * up
        lens = torch.tensor([L], device=dev, dtype=torch.int32)
        out = antialias_snake(x, alpha, beta, lens)
        ref = antialias_snake_plain(x, alpha, beta, lens)
        torch.cuda.synchronize()
        err = rel_l2(out[0, :L], ref[0, :L])
        edge = edge_err(out[0], ref[0], L)
        mab = (out[0, :L].float() - ref[0, :L].float()).abs().max().item()
        ms = time_ms(lambda: antialias_snake(x, alpha, beta, lens))
        pms = time_ms(lambda: antialias_snake_plain(x, alpha, beta, lens))
        tot_ms, tot_pms = tot_ms + ms, tot_pms + pms
        print(f"K3 antialias_snake B=1 C={C} T={T} L={L}: rel_l2 {err:.3e} max_abs {mab:.3e}"
              f" edge rows {edge:.3f} of 2 ulps kernel {ms:.4f} ms plain {pms:.4f} ms"
              f" [{card}]", flush=True)
        assert err <= K3_REL_L2 and np.isfinite(err), f"K3 rel-L2 {err} > {K3_REL_L2} at C={C}"
        assert edge <= 1.0, f"K3 edge rows off by {edge} x 2 ulps at C={C}"
        r = res["antialias_snake"]
        r["err"], r["abs"] = max(r["err"], err), max(r["abs"], mab)
    res["antialias_snake"]["ms"], res["antialias_snake"]["plain_ms"] = tot_ms, tot_pms
    print(f"K3 sum over the six stage shapes: kernel {tot_ms:.4f} ms plain {tot_pms:.4f} ms"
          f" [{card}]", flush=True)
    return res


def reference_check(tts, card: str) -> None:
    """The DiT velocity and BigVGAN on a small input with ragged lengths.
    Every kernel call is also run through its plain twin on the same inputs
    as it happens (rel-L2 over valid rows within the kernel-phase bounds,
    and K3's edge rows within 2 ulps); both outputs must be finite."""
    import torch

    from indextts_tpu_torch.models.s2mel import dit as dit_mod
    from indextts_tpu_torch.models.vocoder import bigvgan as bv_mod
    from indextts_tpu_torch.ops.attn import attention_rope, attention_rope_plain
    from indextts_tpu_torch.ops.rope import precompute_freqs_cis
    from indextts_tpu_torch.ops.snake import antialias_snake, antialias_snake_plain

    site = {"attention_rope": 0.0, "antialias_snake": 0.0, "edge": 0.0}

    def checked(name, kernel, plain):
        def run(*args):
            out, ref = kernel(*args), plain(*args)
            for b, L in enumerate(args[3].tolist()):        # lengths
                site[name] = max(site[name], rel_l2(out[b, :L], ref[b, :L]))
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

    saved = dit_mod.attention_rope, bv_mod.antialias_snake
    dit_mod.attention_rope = checked("attention_rope", attention_rope, attention_rope_plain)
    bv_mod.antialias_snake = checked("antialias_snake", antialias_snake, antialias_snake_plain)
    try:
        with torch.inference_mode():
            v = dit_mod.dit_forward(tts.s2mel_params["cfm"], s2, x, prompt, lens, t, style,
                                    cond, fc)
            w = bv_mod.bigvgan_forward(tts.bigvgan_params, cfg.bigvgan, mel, mel_lens)
    finally:
        dit_mod.attention_rope, bv_mod.antialias_snake = saved
    print(f"reference check (small input), kernel vs plain twin at every call: rel_l2 "
          f"attention_rope {site['attention_rope']:.3e}, antialias_snake "
          f"{site['antialias_snake']:.3e}, K3 edge rows {site['edge']:.3f} of 2 ulps "
          f"[{card}]", flush=True)
    assert site["attention_rope"] <= K2_REL_L2 and site["antialias_snake"] <= K3_REL_L2, site
    assert site["edge"] <= 1.0, site
    assert bool(torch.isfinite(v).all()) and bool(torch.isfinite(w[0, :60 * 256]).all())


def pipeline_phase(card: str) -> dict:
    import torch

    from indextts_tpu_torch.models.vocoder.bigvgan import activation1d_calls
    from indextts_tpu_torch.ops.attn import attention_rope
    from indextts_tpu_torch.ops.snake import antialias_snake
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    with tempfile.TemporaryDirectory(prefix="indextts_smoke_") as d:
        prompt = build_fake_assets(d)
        t0 = time.perf_counter()
        tts = IndexTTS2(cfg_path=None, model_dir=d, device="cuda", seed=0)
        torch.cuda.synchronize()
        print(f"model build (random weights, shipped widths): "
              f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
        n_tok = len(tts.tokenizer.split_segments(tts.tokenizer.tokenize(SENTENCE), 120))
        assert n_tok == 1, f"smoke text must be one segment, got {n_tok}"

        attention_rope.launches = 0
        antialias_snake.launches = 0
        reports = []
        for i in range(3):
            sr, wav = tts.infer(spk_audio_prompt=prompt, text=SENTENCE, output_path=None,
                                max_mel_tokens=400, min_new_tokens=399)
            st = dict(tts.last_stage_times)
            clen = st["codes"]
            expect = int(np.float32(clen) * np.float32(1.72)) * 256
            assert sr == 22050 and wav.shape == (expect, 1), (wav.shape, expect)
            assert np.all(np.isfinite(wav)) and np.abs(wav).max() > 0
            reports.append(st)
            stages = " ".join(f"{k}={st[k]:.4f}s" for k in
                              ("prompt", "gpt", "gpt_forward", "s2mel", "bigvgan", "total"))
            print(f"request {i + 1}: codes={clen} audio={st['audio_s']:.4f}s {stages} "
                  f"RTF={st['rtf']:.4f} [{card}]", flush=True)
        k2, k3 = attention_rope.launches, antialias_snake.launches
        cfg = tts.cfg
        want_k2 = 3 * cfg.s2mel.DiT.depth * 25      # depth x CFG-stacked Euler steps
        want_k3 = 3 * activation1d_calls(cfg.bigvgan)
        print(f"launches over 3 requests: attention_rope {k2} (expect {want_k2}), "
              f"antialias_snake {k3} (expect {want_k3})", flush=True)
        assert k2 == want_k2 and k3 == want_k3, (k2, want_k2, k3, want_k3)
        reference_check(tts, card)
    return {"attention_rope": k2, "antialias_snake": k3}


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
    print((lib.parent / "build.log").read_text(), flush=True)

    kres = kernel_phase(card)
    launches = pipeline_phase(card)
    assert "jax" not in sys.modules, "the port imported jax"

    kernels = [
        {"name": "attention_rope", "route": "cuda",
         "source": "indextts_tpu_torch/csrc/attention_rope.cu",
         "replaces": "indextts_tpu/ops/pallas/attn.py:188",
         "launches": launches["attention_rope"],
         "max_abs_err": kres["attention_rope"]["abs"],
         "ms": kres["attention_rope"]["ms"], "plain_ms": kres["attention_rope"]["plain_ms"]},
        {"name": "antialias_snake", "route": "cuda",
         "source": "indextts_tpu_torch/csrc/antialias_snake.cu",
         "replaces": "indextts_tpu/ops/pallas/antialias.py:269",
         "launches": launches["antialias_snake"],
         "max_abs_err": kres["antialias_snake"]["abs"],
         "ms": kres["antialias_snake"]["ms"], "plain_ms": kres["antialias_snake"]["plain_ms"]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
