"""PyTorch port: the launch plan of K6 with both tp shards on one card, the
TP variant of the persistent decode step (`indextts_tpu_torch/ops/
decode_step.py::step_tp_plan`, `csrc/decode_step.cuh`), held on the CPU at
the shipped widths (D=1280, F=5120, H=20, 10 heads a shard): every GEMV
slab of both shards owned by exactly one block (an out-projection tile's
two slabs by one block, an MLP projection tile by one cluster, whose ranks
take each shard's spans of K once, shard 0's first); each shard's split of K
equal to
`gemv_plan`'s (K = 640 and 1280 unsplit, 2560 in two), so every f32 sum
runs in the chain's order; the attention units covering every (shard, row,
head) and each row's chunks [0, pos) once, in ascending merge order; a
block's shared memory within the H100's 227 KB with at least two weight
slots; the barrier count as the CUDA source issues it; ValueError for shapes
no plan fits; the folded exchange's sum order (a CPU emulation, bit-identical
to `tp_allreduce_plain`, where the sequential order is not); and the route
`fused_decode_step_tp` takes by the mesh's devices.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from indextts_tpu_torch.ops import decode_step as ds
from indextts_tpu_torch.ops import int8
from indextts_tpu_torch.ops.decode_step_tp import co_located, tp_allreduce_plain
from indextts_tpu_torch.parallel.mesh import Mesh

D, F, H = 1280, 5120, 20
SOURCE = Path(ds.__file__).resolve().parents[1] / "csrc" / "decode_step.cuh"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("blocks", [120, 132, 64, 8])
@pytest.mark.parametrize("M", [1, 3, 24])
def test_every_slab_of_both_shards_owned_once(M, blocks):
    plan = ds.step_tp_plan(M, D, H, F, 512, 300, blocks)
    cluster = plan.cluster
    # (a shard's output rows, spans of a shard's K) by phase
    shapes = ((3 * D // 2, 1), (D, 1), (F // 2, 1), (D, plan.split_f))
    per_block = np.zeros(blocks, np.int64)
    for (li, ph), owned in ds.step_tp_tiles(plan, D, F, 3).items():
        N, spans = shapes[ph]
        seen = np.zeros((2, -(-N // 16), spans), np.int64)
        where = {}
        for b, parts in owned.items():
            per_block[b] += len(parts)
            for shard, tile, span in parts:
                seen[shard, tile, span] += 1
                where.setdefault(tile, set()).add(b)
                if ph == 3:   # the rank's place in its cluster: shard 0's spans first
                    assert b % cluster == shard * spans + span, (li, ph, b)
            if ph in (0, 2):   # a block's tiles are one shard's (one scale, bias, output)
                assert len({shard for shard, _, _ in parts}) <= 1, (li, ph, b)
        assert (seen == 1).all(), (li, ph)
        if ph == 1:   # the out-projection: one block takes a tile's two slabs
            assert all(len(bs) == 1 for bs in where.values())
        if ph == 3:   # the MLP projection: a tile's parts fill one cluster
            for tile, bs in where.items():
                assert len(bs) == cluster and min(bs) % cluster == 0
                assert max(bs) - min(bs) == cluster - 1
    # the rotation spreads the step's slabs: over 3 layers no block streams
    # more than a phase's share above another
    assert per_block.max() - per_block.min() <= 5


@pytest.mark.parametrize("M", list(range(1, 25)))
def test_each_shards_split_is_the_chains(M):
    """Each shard's GEMV splits K as `gemv_plan` does for that K (the chain's
    launches at shard shapes): 1280 (qkv, fc) and 640 (out-projection)
    unsplit, 2560 (the MLP projection) in two spans of 1280; a row-parallel
    tile's ranks hold both shards' spans, so the cluster is 4."""
    sh = ds.step_tp_shape(M, D, F)
    for N, K, split in ((3 * D // 2, D, 1), (F // 2, D, 1), (D, D // 2, 1),
                        (D, F // 2, sh.split_f)):
        gp = int8.gemv_plan(M, N, K)
        assert gp.split == split, (N, K)
    assert (sh.split_f, sh.span_f) == (2, 1280) == (int8.gemv_plan(M, D, F // 2).split,
                                                    int8.gemv_plan(M, D, F // 2).span)
    assert sh.cluster == 4 and (sh.split_d, sh.span_d) == (1, D)


@pytest.mark.parametrize("M", [1, 3, 24])
def test_attention_units_cover_both_shards_once(M):
    for S, pos in ((512, 0), (512, 1), (512, 63), (512, 64), (512, 65), (512, 300),
                   (512, 511), (2048, 1500), (2048, 2047)):
        plan = ds.step_tp_plan(M, D, H, F, S, pos)
        n = -(-pos // ds.CHUNK)
        covered = {}
        for units in ds.step_tp_units(plan, M, H, pos).values():
            for shard, row, h0, ranks in units:
                # the runs' chunks, in run order, are 0..n-1: the merge order
                assert [c for _, cs in ranks for c in cs] == list(range(n)), (S, pos)
                assert sorted(k for k, _ in ranks) == list(range(plan.cluster))
                assert ranks[-1][0] == 0 and len(ranks[-1][1]) <= len(ranks[0][1])
                for h in range(h0, h0 + plan.heads):
                    covered[shard, row, h] = covered.get((shard, row, h), 0) + 1
        assert covered == {(t, r, h): 1 for t in range(2) for r in range(M)
                           for h in range(H // 2)}, (S, pos)
        assert plan.chunks * plan.cluster >= n and 1 <= plan.stages <= min(plan.chunks, 4)


@pytest.mark.parametrize("S", [512, 2048])
@pytest.mark.parametrize("M", [1, 3, 24])
def test_shared_memory_fits_with_two_slabs_in_flight(M, S):
    sh = ds.step_tp_shape(M, D, F)
    assert 2 <= sh.slots <= ds.STEP_MAX_SLOTS
    for pos in (0, 1, 64, S // 2, S - 1):
        plan = ds.step_tp_plan(M, D, H, F, S, pos)
        assert plan.smem <= 227 * 1024
        # the layout's formula, with the (L, 2) layer table and K = F / 2
        assert plan.smem == ds._step_layout(M, D, F // 2, False, plan.cluster, plan.split_d,
                                            plan.span_d, plan.split_f, plan.span_f, plan.slots,
                                            shards=2)[2]
        assert plan.smem == ds._step_layout(M, D, F // 2, False, plan.cluster, 1, D, 2, 1280,
                                            plan.slots)[2] + ds.STEP_MAX_LAYERS * 128
        assert ds._attention_smem(plan.heads, plan.chunks, plan.cluster, plan.stages,
                                  False) <= sh.region
        assert ds._step_gemv_region(M, D, plan.cluster) <= sh.region
        # the out-projection stages both shards' attention rows (2M of D / 2)
        nt = -(-M // 8)
        assert (2 * M * ds._x_stride(D // 2) + 4 * (D // 2)
                + (ds.GEMV_WARPS + plan.cluster - 1) * ds.STEP_MAX_TILES * nt * 32 * 16
                + 2 * ds.MAX_ROWS * 4) <= sh.region
        assert sh.slot_bytes >= 16 * D


def test_barrier_count_is_the_k1_loops():
    """K6 runs K1's layer loop (the TP flag is a template argument of the
    one kernel): 5 barriers a layer but the last layer's last, and none for
    the exchange, which stays inside the cluster."""
    src = SOURCE.read_text()
    assert re.search(r"template <bool W4, bool KVQ, int NT, bool TP, typename E>\s*__global__",
                     src)
    assert "decode_step_kernel<W4, KVQ, 1, TP, E>" in src
    loop = src[src.index("for (int l = 0; l < a.L; ++l) {"):]
    loop = loop[:loop.index("\n  }\n")]
    assert len(re.findall(r"gb\.sync\(\);", loop)) == 1
    assert re.search(r"if \(step \+ 1 < STEPS \|\| l \+ 1 < a\.L\) \{\s*gb\.sync\(\);", loop)
    assert "gb.sync" not in src[src.index("__device__ __forceinline__ void gemv_phase"):
                                src.index("__global__ void __launch_bounds__")]
    for L in (1, 2, 24):
        assert ds.step_barriers(L) == 5 * L - 1


def test_shapes_no_plan_fits_raise():
    with pytest.raises(ValueError):
        ds.step_tp_shape(25, D, F)                         # more rows than the kernel takes
    with pytest.raises(ValueError):
        ds.step_tp_plan(3, 1216, 19, F, 512, 300)          # an odd head count: no even split
    with pytest.raises(ValueError):
        ds.step_tp_plan(3, D, 16, F, 512, 300)             # head dim 80
    with pytest.raises(ValueError):
        ds.step_tp_plan(3, D, H, F, 512, 512)              # pos outside the cache
    with pytest.raises(ValueError):
        ds.step_tp_plan(3, D, H, F, 512, 300, blocks=130)  # not whole clusters of 4
    with pytest.raises(ValueError):
        ds.step_tp_shape(3, 2 * D, 4 * 2 * D)              # a LayerNorm phase split over 2
    with pytest.raises(ValueError):
        ds.step_tp_shape(3, D, 2 * 5 * 1280)               # 2 x 5 spans: a cluster of 10


def _bf16_round(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(v).to(torch.bfloat16).float().numpy()


def test_folded_exchange_emulation_is_tp_allreduce_bit_for_bit():
    """The MLP projection's folded exchange, emulated in f32 numpy as the
    kernel's leader runs it (the four ranks' partials s0, s1 of shard 0 and
    s2, s3 of shard 1; gemv_core.cuh::sum_shards: (s0 + s1) + (s2 + s3);
    then EPI_TP: bf16(bf16(acc * scale + bias) + residual), the product and
    the sum rounded apart), equals `tp_allreduce_plain` on the chain's
    partials (each shard's s_2t + s_2t+1) bit for bit. The sequential order
    ((s0 + s1) + s2) + s3 differs somewhere, so the order is what is
    tested."""
    rng = np.random.default_rng(0)
    M, N = 24, 1280
    s = (rng.standard_normal((4, M, N)) * 1e3).astype(np.float32)
    # the four partials cancel to O(1), as a product's spans can, so that an
    # f32 sum's order shows through the bf16 roundings
    s[3] = (-(s[0] + s[1] + s[2]) + rng.standard_normal((M, N))).astype(np.float32)
    scale = (0.5 + rng.random(N)).astype(np.float32)
    bias = _bf16_round((0.01 * rng.standard_normal(N)).astype(np.float32))
    res = _bf16_round(rng.standard_normal((M, N)).astype(np.float32))

    def epilogue(acc):
        v = _bf16_round((acc * scale).astype(np.float32) + bias)
        return _bf16_round((res + v).astype(np.float32))

    pair = (s[0] + s[1]) + (s[2] + s[3])
    seq = ((s[0] + s[1]) + s[2]) + s[3]
    ref = tp_allreduce_plain(torch.from_numpy(s[0] + s[1]), torch.from_numpy(s[2] + s[3]),
                             torch.from_numpy(scale), torch.from_numpy(bias).to(torch.bfloat16),
                             torch.from_numpy(res).to(torch.bfloat16), 0)
    assert np.array_equal(epilogue(pair), ref.float().numpy())
    assert (pair != seq).any()
    assert not np.array_equal(epilogue(seq), ref.float().numpy())


def test_route_follows_the_meshs_devices():
    """`fused_decode_step_tp` takes the persistent kernel only with both
    shards on one CUDA card; two cards (the chain) and the CPU (the twins)
    do not, whatever else holds."""
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert co_located(Mesh((cuda0, cuda0)))
    assert not co_located(Mesh((cuda0, cuda1)))
    assert not co_located(Mesh((torch.device("cpu"),) * 2))
