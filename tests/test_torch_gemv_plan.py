"""PyTorch port: the launch plan of the weight-only GEMV kernel
(`indextts_tpu_torch/ops/int8.py::gemv_plan`, `csrc/int8_gemv.cu`), held
on the CPU for every shape the port launches: K1's four projections at the
shipped width (D=1280) and K6's four shard shapes, int8 and int4, at every
row count 1..24. Each block's slab (16-row tiles x one split's span of K)
is disjoint from the others and together they cover N x K; int4 splits fall
on whole nibble groups; a block's shared memory stays within the H100's
227 KB; and the split, so the f32 sum order, depends on K alone.
"""

import pytest

from indextts_tpu_torch import nn
from indextts_tpu_torch.ops import int8

D = 1280
# (N, K): K1's qkv, attn-proj, fc, mlp-proj; K6's shards of the same
PORT_SHAPES = [(3 * D, D), (D, D), (4 * D, D), (D, 4 * D),
               (3 * D // 2, D), (D, D // 2), (2 * D, D), (D, 2 * D)]


def _blocks(plan, N, K):
    """(rows, columns) of every block of the launch, as the kernel derives
    them from its block index: rank = b % split, row tile = b // split."""
    tile = 16 * plan.rows
    for b in range(-(-N // tile) * plan.split):
        rank, n0 = b % plan.split, (b // plan.split) * tile
        yield (n0, min(N, n0 + tile)), (rank * plan.span, min(K, (rank + 1) * plan.span))


@pytest.mark.parametrize("w4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("N,K", PORT_SHAPES)
def test_plan_slabs_cover_the_weight_once(N, K, w4):
    half = nn.int4_halfspan(K // 2) if w4 else 0
    for M in range(1, int8.MAX_ROWS + 1):
        plan = int8.gemv_plan(M, N, K, half)
        assert 1 <= plan.split <= int8.MAX_SPLIT and 1 <= plan.rows <= int8.MAX_TILES
        rows_seen = [0] * N
        for (r0, r1), (k0, k1) in _blocks(plan, N, K):
            assert k0 < k1, "an empty split"
            if w4:
                assert k0 % (2 * half) == 0 and (k1 - k0) % (2 * half) == 0
            if k0 == 0:
                for r in range(r0, r1):
                    rows_seen[r] += 1
        assert rows_seen == [1] * N
        # the splits of one row tile tile K exactly
        spans = [k for (r, _), k in _blocks(plan, N, K) if r == 0]
        assert spans[0][0] == 0 and spans[-1][1] == K
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert plan.smem <= 227 * 1024
        assert plan.smem == int8._gemv_smem(M, K, plan.rows, plan.split, plan.span, w4)


@pytest.mark.parametrize("w4", [False, True], ids=["int8", "int4"])
def test_plan_split_follows_k_not_n(w4):
    """The sum order of an output depends on K only: K6's qkv shard and the
    unsharded qkv split alike, and so do every N at one K."""
    for K in (D // 2, D, 2 * D, 4 * D):
        half = nn.int4_halfspan(K // 2) if w4 else 0
        plans = {(p.split, p.span) for N in (16, 1000, 1920, 3840, 5120, 20000)
                 for p in [int8.gemv_plan(3, N, K, half)]}
        assert len(plans) == 1, (K, plans)
    assert int8.gemv_plan(3, D, 4 * D).split == 4      # mlp-proj: clusters of 4


def test_plan_fits_the_largest_x_slice_and_refuses_what_does_not_fit():
    """A span of at most SPAN columns bounds the staged x: M=24 at K=5120
    (the largest slice the port launches) fits whole, beside the slab."""
    for w4 in (False, True):
        plan = int8.gemv_plan(24, D, 4 * D, 320 if w4 else 0)
        assert plan.span == int8.SPAN and plan.smem <= int8.SMEM_MAX
    with pytest.raises(ValueError, match="plan"):
        int8.gemv_plan(3, 16, 10 * D)                    # 10 splits of 1280 columns
