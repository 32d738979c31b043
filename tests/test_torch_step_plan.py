"""PyTorch port: the launch plan of the persistent decode step, K1
(`indextts_tpu_torch/ops/decode_step.py::step_plan`, `csrc/decode_step.cuh`),
held on the CPU at the shipped widths (D=1280, F=5120, H=20): every GEMV
output tile of every phase owned by exactly one block (or, where K is
split, one cluster whose ranks each take one span); each GEMV's split and
span equal to `gemv_plan`'s for that K, so the f32 sum order equals the
chain's; the attention units covering each row's chunks [0, pos) once, in
ascending merge order; a block's shared memory, with at least two weight
slots in flight, within the H100's 227 KB; the step's barrier count as the
CUDA source issues it; and ValueError for shapes no plan fits. Also that
`fused_decode_step` on CPU tensors is its plain twin, bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from indextts_tpu_torch import nn
from indextts_tpu_torch.ops import decode_step as ds
from indextts_tpu_torch.ops import int8

D, F, H = 1280, 5120, 20
SOURCE = Path(ds.__file__).resolve().parents[1] / "csrc" / "decode_step.cuh"


@pytest.mark.parametrize("blocks", [128, 132, 64, 8])
@pytest.mark.parametrize("w4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("M", [1, 3, 24])
def test_every_tile_owned_once(M, w4, blocks):
    sh = ds.step_shape(M, D, F, w4)
    if blocks % sh.cluster:
        with pytest.raises(ValueError):
            ds.step_plan(M, D, H, F, 512, 300, False, w4, blocks)
        return
    plan = ds.step_plan(M, D, H, F, 512, 300, False, w4, blocks)
    N = (3 * D, D, F, D)
    split = (plan.split_d,) * 3 + (plan.split_f,)
    per_block = np.zeros(blocks, np.int64)
    for (li, ph), owned in ds.step_tiles(plan, D, F, 3).items():
        seen = np.zeros(-(-N[ph] // 16), np.int64)
        for b, tiles in owned.items():
            per_block[b] += len(tiles)
            if split[ph] > 1:   # a cluster's ranks take the same tiles, one span each
                assert tiles == owned[b - b % plan.cluster]
                if b % plan.cluster:
                    continue
            seen[tiles] += 1
        assert (seen == 1).all(), (li, ph)
    # the rotation spreads the step's tiles: over 3 layers no block streams
    # more than a phase's tile above another (a split phase's tile counts
    # once on each rank)
    assert per_block.max() - per_block.min() <= 4


@pytest.mark.parametrize("w4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("M", list(range(1, 25)))
def test_splits_are_the_chains(M, w4):
    """Each GEMV phase splits K as `gemv_plan` does for that K (and any N),
    so every output's f32 sum runs in the chain's order; the cluster is the
    largest split."""
    sh = ds.step_shape(M, D, F, w4)
    for K, split, span, Ns in ((D, sh.split_d, sh.span_d, (3 * D, D, F)),
                               (F, sh.split_f, sh.span_f, (D,))):
        half = nn.int4_halfspan(K // 2) if w4 else 0
        for N in Ns:
            gp = int8.gemv_plan(M, N, K, half)
            assert (split, span) == (gp.split, gp.span), (K, N)
    assert sh.cluster == sh.split_f == 4 and sh.split_d == 1


@pytest.mark.parametrize("kvq", [False, True], ids=["bf16", "kvq"])
@pytest.mark.parametrize("M", [1, 3, 24])
def test_attention_units_cover_the_chunks_once(M, kvq):
    for S, pos in ((512, 0), (512, 1), (512, 63), (512, 64), (512, 65), (512, 300),
                   (512, 511), (2048, 1500), (2048, 2047)):
        plan = ds.step_plan(M, D, H, F, S, pos, kvq, False, 128)
        n = -(-pos // ds.CHUNK)
        covered = {}
        for units in ds.step_units(plan, M, H, pos).values():
            for row, h0, ranks in units:
                # the runs' chunks, in run order, are 0..n-1: the merge order;
                # every rank takes one run, rank 0 (the merger) the last
                assert [c for _, cs in ranks for c in cs] == list(range(n)), (S, pos)
                assert sorted(k for k, _ in ranks) == list(range(plan.cluster))
                assert ranks[-1][0] == 0 and len(ranks[-1][1]) <= len(ranks[0][1])
                for h in range(h0, h0 + plan.heads):
                    covered[row, h] = covered.get((row, h), 0) + 1
        assert covered == {(r, h): 1 for r in range(M) for h in range(H)}, (S, pos)
        assert plan.chunks * plan.cluster >= n and 1 <= plan.stages <= min(plan.chunks, 4)


@pytest.mark.parametrize("S", [512, 2048])
@pytest.mark.parametrize("kvq", [False, True], ids=["bf16", "kvq"])
@pytest.mark.parametrize("w4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("M", [1, 3, 24])
def test_shared_memory_fits_with_two_slabs_in_flight(M, w4, kvq, S):
    sh = ds.step_shape(M, D, F, w4)
    assert 2 <= sh.slots <= ds.STEP_MAX_SLOTS
    for pos in (0, 1, 64, S // 2, S - 1):
        plan = ds.step_plan(M, D, H, F, S, pos, kvq, w4, 128)
        assert plan.smem <= 227 * 1024
        assert plan.smem == ds._step_layout(M, D, F, w4, plan.cluster, plan.split_d,
                                            plan.span_d, plan.split_f, plan.span_f,
                                            plan.slots)[2]
        # the attention's layout fits the region it shares with x's staging
        assert ds._attention_smem(plan.heads, plan.chunks, plan.cluster, plan.stages,
                                  kvq) <= sh.region
        # a GEMV phase's staging fits it too, and a slot holds a whole tile
        assert ds._step_gemv_region(M, 1280, plan.cluster) <= sh.region
        assert sh.slot_bytes >= 16 * (640 if w4 else 1280)


def test_barrier_count_is_what_the_kernel_issues():
    """5 a layer but the last layer's last: the kernel's layer loop walks
    STEPS = 5 phases and holds one grid barrier, after every phase but the
    step's last."""
    src = SOURCE.read_text()
    assert re.search(r"constexpr int STEPS = 5;", src)
    loop = src[src.index("for (int l = 0; l < a.L; ++l) {"):]
    loop = loop[:loop.index("\n  }\n")]
    assert "for (int step = 0; step < STEPS; ++step) {" in loop
    assert len(re.findall(r"gb\.sync\(\);", loop)) == 1
    assert re.search(r"if \(step \+ 1 < STEPS \|\| l \+ 1 < a\.L\) \{\s*gb\.sync\(\);", loop)
    for L in (1, 2, 24):
        assert ds.step_barriers(L) == 5 * L - 1


def test_shapes_no_plan_fits_raise():
    with pytest.raises(ValueError):
        ds.step_shape(25, D, F)                        # more rows than the kernel takes
    with pytest.raises(ValueError):
        ds.step_plan(3, D, 16, F, 512, 300)            # head dim 80
    with pytest.raises(ValueError):
        ds.step_plan(3, D, H, F, 512, 512)             # pos outside the cache
    with pytest.raises(ValueError):
        ds.step_plan(3, D, H, F, 512, 300, blocks=130)  # not whole clusters of 4
    with pytest.raises(ValueError):
        ds.step_plan(3, D, H, F, 1 << 20, (1 << 20) - 1)  # the chunks' partials overflow
    with pytest.raises(ValueError):
        ds.step_shape(3, D, 16 * 1280)                 # a split of 16: no cluster of <= 8
    with pytest.raises(ValueError):
        ds.step_shape(3, 2 * D, 4 * 2 * D)             # a LayerNorm phase split over 2


def test_cpu_step_is_the_plain_twin_bit_for_bit():
    """On CPU tensors `fused_decode_step` takes the twin: the same bits as
    `fused_decode_step_plain`, the same written rows, the same layer inputs,
    and no launch counted."""
    from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims, init_gpt2, quantize_gpt2_int8
    from indextts_tpu_torch.nn import InitRng
    from indextts_tpu_torch.utils.jax_params import to_torch

    torch.manual_seed(0)
    dims = GPT2Dims(2, 128, 2)
    params = quantize_gpt2_int8(to_torch(init_gpt2(InitRng(0), dims), "cpu", torch.bfloat16))
    rng = np.random.default_rng(0)
    M, S, pos = 3, 96, 70
    kv = torch.tensor(rng.standard_normal((2, 2, M, S, 128)), dtype=torch.float32)
    kv = kv.to(torch.bfloat16)
    kv[..., pos:, :] = 0
    valid = torch.zeros((M, S), dtype=torch.bool)
    for r, s in enumerate((0, 9, 33)):
        valid[r, s:pos + 1] = True
    anc = torch.tensor(rng.integers(0, M, (M, S)), dtype=torch.int32)
    x = torch.tensor(rng.standard_normal((M, 128)), dtype=torch.float32).to(torch.bfloat16)
    before = ds.fused_decode_step.launches
    c1, c2 = ({"k": kv[0].clone(), "v": kv[1].clone()} for _ in range(2))
    li1, li2 = [], []
    h1 = ds.fused_decode_step(params, x, dims, pos, c1, valid, anc, M, layer_inputs=li1)
    h2 = ds.fused_decode_step_plain(params, x, dims, pos, c2, valid, anc, M, layer_inputs=li2)
    assert torch.equal(h1, h2)
    assert all(torch.equal(c1[k], c2[k]) for k in "kv")
    assert len(li1) == len(li2) == 3 and all(torch.equal(a, b) for a, b in zip(li1, li2))
    assert ds.fused_decode_step.launches == before
