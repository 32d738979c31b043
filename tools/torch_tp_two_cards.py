"""K6 of the PyTorch port (the tp=2 fused decode step,
`indextts_tpu_torch/ops/decode_step_tp.py`) with its shards on two cards.

At chip_smoke.py's K1 shape (L=24, D=1280, H=20, S=512, pos=300, 3 rows at
group=3 with a random ancestry map), for the shards co-located on cuda:0
(the persistent kernel, the exchange folded into it) and then on cuda:0 and
cuda:1 (the chain: the exchange, `tp_allreduce`, reading the peer card's
partial over NVLink): layer by layer against the plain twin (`tp_twin_by_layer`:
rel-L2 <= 1e-2, residual streams and written k/v rows bit-identical), and
the two layouts bit-identical to each other. Then the device ms a step on
each card of K1 (one card), K6 co-located and K6 on two cards, each summed
from `torch.profiler` over 20 eager steps, beside one shard's bound (half
the weight bytes a card). Needs two CUDA devices with peer access; from the
repository root:

    python3 tools/torch_tp_two_cards.py

Exits non-zero on any mismatch.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

STEPS = 20


def per_card_ms(step, devices) -> dict:
    """Device ms per call of ``step`` on each card: ``STEPS`` eager calls
    under `torch.profiler` (the window padded with spin kernels on every
    card, as in chip_smoke.py's `profile_decode`), kernel time summed per
    card; with the `tp_allreduce` launches recorded per card."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        step()
    for d in devices:
        torch.cuda.synchronize(d)
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        cs._spin_pad(devices)
        prof.step()
        for _ in range(STEPS):
            step()
        cs._spin_pad(devices)
        prof.step()
    ns: dict = {}
    reduces: dict = {}
    by, _ = cs.device_records(prof, lambda e: (e.device_index(), e.name()))
    for (d, name), (count, t) in by.items():
        if name.startswith(("Memcpy", "Memset")):
            continue
        ns[d] = ns.get(d, 0) + t
        reduces[d] = reduces.get(d, 0) + (count if "tp_allreduce_kernel" in name else 0)
    return {"ms": {d: v / 1e6 / STEPS for d, v in sorted(ns.items())},
            "reduces": dict(sorted(reduces.items()))}


def main() -> int:
    import torch

    if torch.cuda.device_count() < 2:
        print("torch_tp_two_cards: needs two CUDA devices", file=sys.stderr)
        return 2
    from indextts_tpu_torch import nn
    from indextts_tpu_torch.ops import cuda
    from indextts_tpu_torch.ops.decode_step import fused_decode_step
    from indextts_tpu_torch.ops.decode_step_tp import co_located, fused_decode_step_tp
    from indextts_tpu_torch.parallel.mesh import Replicated, make_mesh, shard_gpt2_tp

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    cuda.build()
    g = torch.Generator(device="cuda").manual_seed(6)
    dims, bf16_params, params, kv, valid, x, anc, starts = cs.k1_case(g)
    del bf16_params
    full = [{"c_attn": lp["attn"]["c_attn"], "ln_1": lp["ln_1"]} for lp in params["h"]]
    Dl, M = cs.K1_D // 2, cs.K1_ROWS
    runs = {}
    for label, devs in (("co-located", cs.TP_DEVICES), ("two cards", ("cuda:0", "cuda:1"))):
        mesh = make_mesh(list(devs))
        tp = shard_gpt2_tp(params, mesh)
        vr, ar = Replicated.of(valid, mesh), Replicated.of(anc, mesh)

        def cache():
            return {"shards": [{k: kv[i][..., t * Dl:(t + 1) * Dl].contiguous().to(d)
                                for i, k in enumerate("kv")} for t, d in enumerate(mesh.devices)]}

        args = dict(params=tp, x=x, dims=dims, pos=cs.K1_POS, kv_cache=cache(), kv_valid=vr,
                    anc=ar, group=M, layer_inputs=[])
        h = nn.layer_norm(tp["ln_f"], fused_decode_step_tp(**args))
        for d in set(mesh.devices):
            torch.cuda.synchronize(d)
        tw = cs.tp_twin_by_layer(args, h, full)
        c = cache()
        timing = per_card_ms(lambda: fused_decode_step_tp(tp, x, dims, cs.K1_POS, c, vr, ar, M),
                             sorted(set(mesh.devices), key=str))
        runs[label] = h
        reduces = 0 if co_located(mesh) else 4 * cs.K1_L * STEPS
        print(f"K6 {label} {[str(d) for d in mesh.devices]} L={cs.K1_L} D={cs.K1_D} B*K={M} "
              f"group={M} S={cs.K1_S} pos={cs.K1_POS}: layer outputs rel_l2 <= "
              f"{tw['layer']:.3e}, hidden {tw['hidden']:.3e}, residual streams bit-identical: "
              f"{tw['streams_equal']}, written rows bit-identical to K1's qkv kernel: "
              f"{tw['rows_exact']}; device ms a step by card (eager, profiler): "
              f"{ {f'cuda:{d}': round(v, 4) for d, v in timing['ms'].items()} }, "
              f"tp_allreduce launches recorded by card {timing['reduces']} of {reduces} "
              f"[{card}]", flush=True)
        assert tw["layer"] <= cs.K1_REL_L2 and tw["hidden"] <= cs.K1_REL_L2, (label, tw)
        assert tw["streams_equal"] and tw["rows_exact"], (label, tw)
        assert sum(timing["reduces"].values()) == reduces, timing
    assert torch.equal(runs["co-located"], runs["two cards"]), "two cards differ from one"
    k1_cache = {k: kv[i].clone() for i, k in enumerate("kv")}
    k1 = per_card_ms(lambda: fused_decode_step(params, x, dims, cs.K1_POS, k1_cache, valid, anc,
                                               M), ["cuda:0"])
    b = cs.tp_bound(shard_gpt2_tp(params, make_mesh(list(cs.TP_DEVICES))), starts, M, cs.K1_S,
                    ranks=(0,))
    print(f"K1 L={cs.K1_L} D={cs.K1_D} B*K={M} on one card: device ms a step (eager, profiler) "
          f"{k1['ms'][0]:.4f}; K6 on two cards bit-identical to co-located: True; one shard's "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
