"""PyTorch port: the launch plans of K1's decode attention
(`indextts_tpu_torch/ops/decode_step.py::attention_plan`,
`csrc/decode_attention.cu`) and of the anti-alias kernel K3
(`indextts_tpu_torch/ops/snake.py::snake_plan`, `csrc/antialias_snake.cu`),
held on the CPU at every shape the port launches.

Attention: K1 at 1, 3 and 24 rows of 20 heads and a K6 shard of 10 heads,
the bf16 and the int8 cache, caches of 512 and 2048 positions, pos at the
chunk edges. A row's chunks (64 positions, the rounding unit) cover [0,
pos) once and whole, split in order over a cluster of at most 8 blocks;
a block's shared memory stays within the H100's 227 KB; the chunk
boundaries, and so the order of the merge (chunks 0, 1, ... on rank 0), do
not depend on the plan, the head count or the card's SM count; a plan of
a fixed number of heads a block (`attention_plan(heads=)`) fits or is
refused.

K3: the threads' runs of output rows cover [0, T) once for every channel
piece and batch row at T off the run length, at every BigVGAN width
(24-1536) and at one off 8; a width that is not a multiple of 4 is
refused.
"""

import pytest

from indextts_tpu_torch.ops import decode_step, snake
from indextts_tpu_torch.ops.int8 import SMEM_MAX

ROWS = (1, 3, 24)            # K1 at group=1, the beam's 3 rows, the most a step takes
HEADS = (20, 10)             # the shipped decoder, a K6 shard
POSITIONS = (0, 1, 63, 64, 65, 300)


def _chunks_of(plan, pos):
    """Each rank's chunks, as the kernel derives them: rank k takes
    [k * chunks, min((k + 1) * chunks, ceil(pos / 64)))."""
    n = -(-pos // decode_step.CHUNK)
    return [list(range(k * plan.chunks, min((k + 1) * plan.chunks, n)))
            for k in range(plan.cluster)]


def _positions(chunk, pos):
    c = decode_step.CHUNK
    return range(c * chunk, min(c * chunk + c, pos))


@pytest.mark.parametrize("kvq", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("H", HEADS)
@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("S", [512, 2048])
def test_attention_plan_covers_the_positions_once(S, M, H, kvq):
    for pos in POSITIONS + (S // 2 + 1, S - 1):
        plan = decode_step.attention_plan(M, H, pos, kvq)
        assert 1 <= plan.cluster <= decode_step.MAX_CLUSTER
        assert 1 <= plan.heads <= decode_step.MAX_HEADS and H % plan.heads == 0
        assert 1 <= plan.stages <= min(plan.chunks, decode_step.MAX_STAGES)
        assert plan.smem <= SMEM_MAX
        assert plan.smem == decode_step._attention_smem(plan.heads, plan.chunks, plan.cluster,
                                                        plan.stages, kvq)
        ranks = _chunks_of(plan, pos)
        merged = [c for chunks in ranks for c in chunks]
        assert merged == list(range(-(-pos // 64))), (pos, plan)   # ascending, each once
        assert pos == 0 or all(ranks), "a rank without a chunk"
        seen = [p for c in merged for p in _positions(c, pos)]
        assert seen == list(range(pos))


def test_attention_plan_chunks_do_not_depend_on_the_plan():
    """The rounding unit and the merge order follow from pos alone: the same
    chunk boundaries at every head count, row count and SM count, and under
    every fixed number of heads a block, though the grid differs."""
    for pos in POSITIONS + (511, 1500, 2047):
        bounds = set()
        plans = set()
        for M in ROWS:
            for H in HEADS:
                for sms in (66, 132, 264):
                    for heads in (None, 1, 2, 5):
                        plan = decode_step.attention_plan(M, H, pos, False, sms, heads)
                        assert heads is None or plan.heads == heads
                        plans.add(plan)
                        bounds.add(tuple(tuple(_positions(c, pos))[:1]
                                         for chunks in _chunks_of(plan, pos) for c in chunks))
        assert len(bounds) == 1, pos
        assert len(plans) > 1   # the plans do differ


@pytest.mark.parametrize("kvq", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("heads", [1, 2, 4, 5, 10])
def test_attention_plan_takes_a_fixed_head_count(heads, kvq):
    """`attention_plan(heads=)`, the other plans the card's checks and the
    bench launch: every divisor of 20 up to 8 fits shared memory at the
    main path's positions; 10 (over the kernel's 8) and 3 (no divisor of
    20) are refused."""
    for M, pos in ((3, 300), (3, 1500), (1, 300), (24, 511)):
        if heads > decode_step.MAX_HEADS:
            with pytest.raises(ValueError, match="heads a block"):
                decode_step.attention_plan(M, 20, pos, kvq, heads=heads)
            continue
        plan = decode_step.attention_plan(M, 20, pos, kvq, heads=heads)
        assert plan.heads == heads and plan.smem <= SMEM_MAX
        assert plan.smem == decode_step._attention_smem(heads, plan.chunks, plan.cluster,
                                                        plan.stages, kvq)
    with pytest.raises(ValueError, match="heads a block"):
        decode_step.attention_plan(3, 20, 300, kvq, heads=3)


def test_attention_plan_fills_the_card_in_one_wave():
    """At the main path's shapes the grid holds at least a block an SM and
    is resident at once: one head a block where that fits, more where the
    grid would otherwise take a second wave."""
    sms = 132
    for M, H, pos, kvq in ((3, 20, 300, False), (3, 20, 300, True), (3, 10, 300, False),
                           (3, 20, 1500, False), (1, 20, 1500, False)):
        plan = decode_step.attention_plan(M, H, pos, kvq, sms)
        blocks = plan.cluster * (H // plan.heads) * M
        per_sm = min(decode_step.BLOCKS_PER_SM, decode_step.SM_SMEM // (plan.smem + 1024))
        assert sms <= blocks <= per_sm * sms, (M, H, pos, plan)
    assert decode_step.attention_plan(3, 20, 300) == decode_step.attention_plan(
        3, 20, 300, sms=sms)
    p = decode_step.attention_plan(3, 20, 300)
    assert (p.heads, p.cluster, p.stages) == (1, 5, 1)    # 300 blocks, three an SM
    assert decode_step.attention_plan(1, 20, 300).heads == 1  # 100 units: one head a block
    long = decode_step.attention_plan(3, 20, 1500)           # 480 blocks of one head would
    assert (long.heads, long.cluster, long.chunks, long.stages) == (2, 8, 3, 3)  # take 2 waves


def _snake_thread(T, C, gid):
    """(batch row, first output row, first channel) of global thread
    ``gid``, as the kernel derives them: channel piece first, then the runs,
    then the batch rows."""
    vecs, runs = C // snake.SNAKE_VEC, -(-T // snake.SNAKE_RUN)
    rest = gid // vecs
    return rest // runs, (rest % runs) * snake.SNAKE_RUN, (gid % vecs) * snake.SNAKE_VEC


@pytest.mark.parametrize("C", [20, 24, 48, 96, 192, 384, 768, 1536])
@pytest.mark.parametrize("B,T", [(1, 1), (1, 15), (2, 16), (2, 100), (1, 3072)])
def test_snake_runs_cover_the_rows_once(B, T, C):
    plan = snake.snake_plan(B, T, C)
    runs = -(-T // plan.rows)
    n = B * runs * (C // snake.SNAKE_VEC)
    assert plan.blocks * plan.threads >= n > (plan.blocks - 1) * plan.threads
    seen = {}
    for gid in range(n):
        b, t0, c0 = _snake_thread(T, C, gid)
        assert 0 <= b < B and 0 <= t0 < T and 0 <= c0 < C and c0 % snake.SNAKE_VEC == 0
        for t in range(t0, min(t0 + plan.rows, T)):
            seen[(b, t, c0)] = seen.get((b, t, c0), 0) + 1
    assert len(seen) == B * T * (C // snake.SNAKE_VEC) and set(seen.values()) == {1}


@pytest.mark.parametrize("C", [2, 6, 22, 1538])
def test_snake_plan_refuses_a_width_off_the_8_byte_piece(C):
    with pytest.raises(ValueError, match="multiple of 4"):
        snake.snake_plan(1, 64, C)
