"""PyTorch port: the hand-written CUDA kernels against their plain twins.

Tests marked `cuda` need an NVIDIA GPU (sm_90a build) and skip elsewhere.
This file imports no jax, so on a machine with the card it runs on its own:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Tolerances are the ones `chip_smoke.py` holds at the main path's shapes:
rel-L2 over valid rows <= 2e-2 for K2 (attention_rope, bf16 probabilities
before PV, online vs whole-row softmax) and <= 1e-2 for K3 (antialias_snake,
f32 inside, one bf16 rounding at the output); rel-L2 <= 1e-3 for K7a / K7b
(int8 products, f32 sums in another order; at K1's and K6's shapes, M of 1,
3, 8, 9 and 24, N off the 16-row tile and the largest x slice; two launches
bit-identical, and the order of the sums independent of N, so a qkv shard
equals the unsharded qkv) and <= 1e-2 on the hidden state
for K1 (fused_decode_step), whose ancestry route is bit-identical to the
physically gathered cache and kv_valid (K1 attends exactly the slots
kv_valid marks, of each position's physical row). The same holds for the
int4 GEMVs (int4_matvec,
int4_mlp) and K1's KVQ (int8 cache) and W4 (int4 weights) variants, whose
layer-0 written rows are within 1 int8 count and their scale rows within 1
bf16 ulp of the twin's (the same inputs; the bf16 k/v quantized differ by at
most an ulp from the f32 summation order). K4 (single_block_attention) and
K2' (packed_pair_attention) take K2's rel-L2 <= 2e-2, at T off the 64-row
tile, lengths of 0 (K4: every key), 1, T and past T, B=1 and every K4 head
width, each in bf16 and in fp16 (the kernels' two instantiations; K2 too);
K2's rope pass (rope_qk) is bit-identical to its twin, and a layout
the kernels' TMA loads cannot read raises before any launch; K5
(fused_antialias_activation) and K3' (antialias_activation_prefolded), which
launch K3's kernel, take K3's 1e-2; at the edges (T under the kernel's
16-row run, L = 1, L < T, C = 24 and 768, logscale on and off) the three
entries are bit-identical and within rel-L2 1e-3 of the twin, their 4 edge
rows within 2 bf16 ulps; a width off 8 runs and one off 4 is refused.
K1's attention (decode_attention) alone, at pos 0, 1, 63, 64, 65, 300,
S-1 and 1500 of 2048, with a fully padded row, bf16 and int8 cache, with
and without the ancestry map: rel-L2 <= 1e-2 against the twin, written
rows bit-identical to the twin's, two launches bit-identical, the ancestry
route bit-identical to the gathered cache, heads [0, 10) of an H=10 call
bit-identical to an H=20 call's, every plan of 1, 2, 4 or 5 heads a block
bit-identical, and a misaligned operand refused. K1 is one persistent
launch a step (`csrc/decode_step.cu`), bit-identical to the chain of
standalone kernels it replaced (`fused_decode_step_chain`) for every
variant at group=3 and group=1 and pos 0, 1 and 150 (the hidden state, the
whole cache after the step, every layer's input, a second launch), with
`step_barriers` grid barriers and no standalone kernel launched. The
num_beams=1 sampling decode with int8
weights launches K1 once a step (at group=1) and never the bf16 step; the
speculative decoder K1 once a single step and the chunk step once a
verify; diverse beam K1 at group=2 once a step. K6's
all-reduce (tp_allreduce) is bit-identical to its twin, for either rank; K6
(fused_decode_step_tp) with both shards co-located on one card is one
launch a step of the persistent kernel's TP variant, bit-identical to the
chain of standalone kernels it replaced (`fused_decode_step_tp_chain`) at
group=3 and group=1, pos 0, 1 and 150, S=2048 pos=1500 and 24 rows (the
hidden state, both shards' caches, every layer's input, a second launch;
`step_barriers` grid barriers; no tp_allreduce, GEMV or attention launch),
a CUDA graph of it replays bit-identically, and it holds each layer within
rel-L2 1e-2 of the twin on the kernel path's input and writes k/v rows
bit-identical to K1's qkv kernel on the same input, per head slice.
With two cards, K6 with its shards on cuda:0 and cuda:1 (the exchange
reading the peer card's partial) is bit-identical to the co-located run,
and greedy tp decodes (beams on the ancestry and the gather route, the
adaptive sampling decode) are token-equal across the two layouts.
"""

import pytest
import torch

from indextts_tpu_torch.models.gpt.gpt2 import (GPT2Dims, init_gpt2, kv_quantize_flat,
                                                quantize_gpt2_int4, quantize_gpt2_int8)
from indextts_tpu_torch.nn import InitRng, quantize_dense_int4
from indextts_tpu_torch.ops import attn, decode_step, decode_step_tp, int8, snake
from indextts_tpu_torch.parallel.mesh import Replicated, make_mesh, shard_gpt2_tp
from indextts_tpu_torch.ops.rope import precompute_freqs_cis
from indextts_tpu_torch.utils.jax_params import to_torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def rel_l2(a, b):
    return (torch.linalg.norm((a - b).float()) / torch.linalg.norm(b.float())).item()


def _attn_args(T, lengths, device, dtype=torch.bfloat16, H=8, D=64):
    g = torch.Generator().manual_seed(T)
    q, k, v = (torch.randn((len(lengths), T, H * D), generator=g).to(device, dtype)
               for _ in range(3))
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, k, v, lens, torch.as_tensor(precompute_freqs_cis(T, D), device=device), H


def _snake_args(T, C, lengths, device, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(C)
    x = (2 * torch.randn((len(lengths), T, C), generator=g)).to(device, dtype)
    alpha = (0.3 * torch.randn(C, generator=g)).to(device)
    beta = (0.3 * torch.randn(C, generator=g)).to(device)
    return x, alpha, beta, torch.tensor(lengths, device=device)


def _counters():
    return (attn.attention_rope.launches, attn.packed_pair_attention.launches,
            attn.single_block_attention.launches, snake.antialias_snake.launches,
            snake.fused_antialias_activation.launches,
            snake.antialias_activation_prefolded.launches)


def _launches():
    """`_counters` and K2's rope pass (`rope_qk`)."""
    return _counters() + (attn.rope_qk.launches,)


def _block_args(T, lengths, device, H, D, transposed=True, dtype=torch.bfloat16):
    """(B, H, T, D) q, k, v: transposed views of (B, T, H, D) tensors, as the
    DiT hands them over, or contiguous."""
    g = torch.Generator().manual_seed(T + D)
    shape = (len(lengths), T, H, D) if transposed else (len(lengths), H, T, D)
    q, k, v = (torch.randn(shape, generator=g).to(device, dtype) for _ in range(3))
    if transposed:
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=device)


def test_cpu_tensors_run_the_plain_twins_without_counting():
    before = _launches()
    a = _attn_args(64, [64, 17], "cpu", torch.float32, H=2)
    torch.testing.assert_close(attn.attention_rope(*a), attn.attention_rope_plain(*a))
    torch.testing.assert_close(attn.packed_pair_attention(*a[:4], a[5]),
                               attn.packed_pair_attention_plain(*a[:4], a[5]))
    torch.testing.assert_close(attn.rope_qk(*a[:2], *a[4:]), attn.rope_qk_plain(*a[:2], *a[4:]))
    b = _block_args(64, [64, 17], "cpu", 2, 40)
    torch.testing.assert_close(attn.single_block_attention(*b),
                               attn.single_block_attention_plain(*b))
    s = _snake_args(64, 8, [64, 5], "cpu", torch.float32)
    torch.testing.assert_close(snake.antialias_snake(*s), snake.antialias_snake_plain(*s))
    torch.testing.assert_close(snake.fused_antialias_activation(*s, logscale=False),
                               snake.antialias_snake_plain(*s, logscale=False))
    x, alpha, beta, lens = s
    torch.testing.assert_close(
        snake.antialias_activation_prefolded(x.reshape(2, 16, 32), alpha, beta, 4, 8, lens),
        snake.antialias_snake_plain(*s).reshape(2, 16, 32))
    assert _launches() == before


# T off the 64-row tile (1000, 1279), lengths of 1, of T and past T, B=1
ATTN_EDGES = [(256, [256, 141]), (1000, [1000, 1]), (1280, [1201, 630]), (1279, [1279, 1500]),
              (1279, [64, 65]), (1000, [700])]
# the attention kernels' two instantiations: bf16, and fp16 (use_fp16=True)
ATTN_DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                                      ids=["bf16", "fp16"])


@pytest.mark.cuda
@ATTN_DTYPES
@pytest.mark.parametrize("T,lengths", ATTN_EDGES)
def test_attention_rope_kernel_matches_plain(cuda_device, T, lengths, dtype):
    """K2: the rope pass then K2''s attention kernel; a call counts one K2
    and one rope pass, and no K2'."""
    a = _attn_args(T, lengths, cuda_device, dtype)
    before = _launches()
    out = attn.attention_rope(*a)
    after = _launches()
    assert [x - y for x, y in zip(after, before)] == [1, 0, 0, 0, 0, 0, 1]
    ref = attn.attention_rope_plain(*a)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    for b, L in enumerate(lengths):
        L = min(L, T)
        assert rel_l2(out[b, :L], ref[b, :L]) <= 2e-2
    assert torch.isfinite(out).all()


@pytest.mark.cuda
@ATTN_DTYPES
@pytest.mark.parametrize("T", [1000, 1280])
def test_rope_pass_bit_identical_to_plain(cuda_device, T, dtype):
    q, k, _, _, fc, H = _attn_args(T, [T, T // 2], cuda_device, dtype)
    before = attn.rope_qk.launches
    qr, kr = attn.rope_qk(q, k, fc, H)
    assert attn.rope_qk.launches == before + 1
    pq, pk = attn.rope_qk_plain(q, k, fc, H)
    torch.cuda.synchronize()
    assert torch.equal(qr, pq) and torch.equal(kr, pk)


@pytest.mark.cuda
def test_attention_rope_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v, lens, fc, H = _attn_args(128, [128], cuda_device, torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        attn.attention_rope(q, k, v, lens, fc, H)
    q, k, v, lens, fc, H = _attn_args(128, [128], cuda_device, H=4, D=32)
    with pytest.raises(ValueError, match="head dim 64"):
        attn.attention_rope(q, k, v, lens, fc, H)
    q, k, v, lens, fc, H = _attn_args(128, [128], cuda_device)
    with pytest.raises(ValueError, match="freqs_cis"):       # no silent f32 copy
        attn.attention_rope(q, k, v, lens, fc.double(), H)


@pytest.mark.cuda
@pytest.mark.parametrize("T,C,lengths", [(512, 768, [512, 480]), (4096, 24, [4096, 4059]),
                                         (1000, 96, [1, 999])])
def test_antialias_snake_kernel_matches_plain(cuda_device, T, C, lengths):
    s = _snake_args(T, C, lengths, cuda_device)
    before = snake.antialias_snake.launches
    out = snake.antialias_snake(*s)
    assert snake.antialias_snake.launches == before + 1
    ref = snake.antialias_snake_plain(*s)
    torch.cuda.synchronize()
    for b, L in enumerate(lengths):
        assert rel_l2(out[b, :L], ref[b, :L]) <= 1e-2


@pytest.mark.cuda
def test_antialias_snake_kernel_rejects_non_contiguous(cuda_device):
    x, alpha, beta, lens = _snake_args(256, 32, [256], cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        snake.antialias_snake(x.transpose(1, 2).contiguous().transpose(1, 2),
                              alpha, beta, lens)


def _int8_args(M, K, N, device):
    g = torch.Generator().manual_seed(M * K + N)
    x = torch.randn((M, K), generator=g).to(device, torch.bfloat16)
    q = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8).to(device)
    scale = (torch.rand(N, generator=g) / 127 / 30).to(device)
    bias = (0.1 * torch.randn(N, generator=g)).to(device, torch.bfloat16)
    return x, q, scale, bias


def _k1_case(device, B=3, S=256, pos=150, dims=GPT2Dims(2, 640, 10),
             quantize=quantize_gpt2_int8):
    params = quantize(to_torch(init_gpt2(InitRng(0, device), dims), device, torch.bfloat16))
    g = torch.Generator().manual_seed(1)
    kv = torch.randn((2, dims.layers, B, S, dims.dim), generator=g)
    kv[:, :, :, pos:] = 0
    valid = torch.zeros((B, S), dtype=torch.bool)
    for b in range(B):
        valid[b, 7 * b:pos + 1] = True
    x = torch.randn((B, dims.dim), generator=g).to(device, torch.bfloat16)
    anc = torch.randint(0, B, (B, S), generator=g, dtype=torch.int32).to(device)
    return params, dims, x, kv.to(device, torch.bfloat16), valid.to(device), anc, pos


def test_cpu_tensors_run_the_int8_twins_without_counting():
    before = (int8.int8_matvec.launches, int8.int8_mlp.launches,
              decode_step.decode_attention.launches, decode_step.fused_decode_step.launches)
    x, q, scale, bias = _int8_args(3, 64, 48, "cpu")
    torch.testing.assert_close(int8.int8_matvec(x, q), int8.int8_matvec_plain(x, q))
    params, dims, x, kv, valid, anc, pos = _k1_case("cpu", S=32, pos=20,
                                                    dims=GPT2Dims(1, 64, 4))
    cache = {"k": kv[0].clone(), "v": kv[1].clone()}
    h = decode_step.fused_decode_step(params, x, dims, pos, cache, valid, anc, 3)
    ref = decode_step.fused_decode_step_plain(params, x, dims, pos,
                                              {"k": kv[0].clone(), "v": kv[1].clone()},
                                              valid, anc, 3)
    assert torch.equal(h, ref)
    assert (int8.int8_matvec.launches, int8.int8_mlp.launches,
            decode_step.decode_attention.launches,
            decode_step.fused_decode_step.launches) == before


# The GEMV shapes held on the card: K1's four projections (qkv, attn-proj, fc,
# mlp-proj at D=1280), M in {1, 3, 8, 9, 24} (1-3 n-tiles of the MMA), K6's
# four shard shapes (D/2 a shard; the f32 partials are the no-epilogue
# output), N off the 16-row tile, and M=24 at K=5120 (the largest x slice).
GEMV_SHAPES = [(3, 1280, 3840), (3, 5120, 1280), (24, 1280, 5120), (5, 640, 1000),
               (1, 1280, 3840), (8, 1280, 3840), (9, 1280, 1280), (24, 5120, 1280),
               (3, 1280, 1920), (3, 640, 1280), (3, 1280, 2560), (3, 2560, 1280)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", GEMV_SHAPES)
def test_int8_matvec_kernel_matches_plain(cuda_device, M, K, N):
    x, q, scale, bias = _int8_args(M, K, N, cuda_device)
    before = int8.int8_matvec.launches
    out = int8.int8_matvec(x, q)
    assert int8.int8_matvec.launches == before + 1
    assert out.dtype == torch.float32
    assert rel_l2(out, int8.int8_matvec_plain(x, q)) <= 1e-3
    ln = (torch.ones(K, device=cuda_device, dtype=torch.bfloat16),
          torch.zeros(K, device=cuda_device, dtype=torch.bfloat16))
    res = torch.randn((M, N), device=cuda_device).to(torch.bfloat16)
    for kw in (dict(scale=scale, bias=bias), dict(ln=ln, scale=scale, bias=bias),
               dict(scale=scale, bias=bias, residual=res)):
        assert rel_l2(int8.int8_matvec(x, q, **kw), int8.int8_matvec_plain(x, q, **kw)) <= 1e-3


@pytest.mark.cuda
def test_int8_mlp_kernel_matches_plain(cuda_device):
    x, w1, s1, b1 = _int8_args(3, 1280, 5120, cuda_device)
    _, w2, s2, b2 = _int8_args(3, 5120, 1280, cuda_device)
    before = int8.int8_mlp.launches
    out = int8.int8_mlp(x, w1, s1, b1, w2)
    assert int8.int8_mlp.launches == before + 1
    assert rel_l2(out, int8.int8_mlp_plain(x, w1, s1, b1, w2)) <= 1e-3


@pytest.mark.cuda
def test_int8_kernels_reject_what_they_do_not_take(cuda_device):
    x, q, _, _ = _int8_args(25, 64, 32, cuda_device)
    with pytest.raises(ValueError, match="rows"):
        int8.int8_matvec(x, q)
    x, q, _, _ = _int8_args(3, 64, 32, cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        int8.int8_matvec(x.float(), q)
    shifted = torch.empty(3 * 64 + 4, device=cuda_device, dtype=torch.bfloat16)[4:].view(3, 64)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="aligned"):    # TMA reads 16-byte aligned rows
        int8.int8_matvec(shifted, q)
    x, q, _, _ = _int8_args(3, 12800, 16, cuda_device)
    with pytest.raises(ValueError, match="plan"):       # 10 splits of 1280 columns
        int8.int8_matvec(x, q)


@pytest.mark.cuda
def test_fused_decode_step_kernel_matches_plain_and_ancestry_is_exact(cuda_device):
    params, dims, x, kv, valid, anc, pos = _k1_case(cuda_device)
    caches = [{"k": kv[0].clone(), "v": kv[1].clone()} for _ in range(2)]
    before = decode_step.fused_decode_step.launches
    h = decode_step.fused_decode_step(params, x, dims, pos, caches[0], valid, anc, 3)
    assert decode_step.fused_decode_step.launches == before + 1
    ref = decode_step.fused_decode_step_plain(params, x, dims, pos, caches[1], valid, anc, 3)
    torch.cuda.synchronize()
    assert rel_l2(h, ref) <= 1e-2
    assert rel_l2(caches[0]["k"][:, :, pos], caches[1]["k"][:, :, pos]) <= 1e-2
    rows = (torch.arange(3, device=cuda_device)[:, None] // 3) * 3 + anc.long()
    pos_ix = torch.arange(kv.shape[3], device=cuda_device)[None, :]
    gathered = {"k": kv[0][:, rows, pos_ix].contiguous(), "v": kv[1][:, rows, pos_ix].contiguous()}
    # a gather route gathers kv_valid with the cache
    h_gat = decode_step.fused_decode_step(params, x, dims, pos, gathered,
                                          valid[rows, pos_ix].contiguous())
    assert torch.equal(h, h_gat)
    for key in ("k", "v"):
        assert torch.equal(caches[0][key][:, :, pos], gathered[key][:, :, pos])


def _k1_counters():
    """K1's launches, then the standalone kernels' of its chain."""
    return (decode_step.fused_decode_step.launches, int8.int8_matvec.launches,
            int8.int8_mlp.launches, int8.int4_matvec.launches, int8.int4_mlp.launches,
            decode_step.decode_attention.launches, decode_step.decode_attention.kvq_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 1, 150])
@pytest.mark.parametrize("group", [3, 1])
@pytest.mark.parametrize("variant", ["int8", "kvq", "w4", "w4-kvq"])
def test_fused_decode_step_bit_identical_to_the_chain(cuda_device, variant, group, pos):
    """K1's persistent kernel (one launch a step) against the chain of
    standalone kernels it replaced, on copies of one cache: the hidden
    state, the whole cache after the step and every layer's input
    bit-identical, a second launch repeating the first, `step_barriers`
    grid barriers, and none of the standalone kernels launched."""
    kvq = variant.endswith("kvq")
    quantize = quantize_gpt2_int4 if variant.startswith("w4") else quantize_gpt2_int8
    params, dims, x, kv, valid, anc, _ = _k1_case(cuda_device, quantize=quantize, pos=pos)
    rows = slice(0, group)
    x, valid = x[rows], valid[rows].contiguous()
    anc = anc if group > 1 else None
    make = _kvq_cache if kvq else (lambda t: {"k": t[0].clone(), "v": t[1].clone()})
    base = {k: t[:, rows].contiguous() for k, t in make(kv).items()}
    caches = [{k: t.clone() for k, t in base.items()} for _ in range(3)]
    count = decode_step.step_barrier(x.device)
    before = (int(count[1]), *_k1_counters())
    lk, lc = [], []
    h = decode_step.fused_decode_step(params, x, dims, pos, caches[0], valid, anc, group,
                                      layer_inputs=lk)
    torch.cuda.synchronize()
    assert int(count[1]) - before[0] == decode_step.step_barriers(dims.layers)
    after = _k1_counters()
    assert after[0] == before[1] + 1 and after[1:] == before[2:]   # K1 only
    hc = decode_step.fused_decode_step_chain(params, x, dims, pos, caches[1], valid, anc, group,
                                             layer_inputs=lc)
    h2 = decode_step.fused_decode_step(params, x, dims, pos, caches[2], valid, anc, group)
    torch.cuda.synchronize()
    assert torch.equal(h, hc) and torch.equal(h, h2)
    for key in base:
        assert torch.equal(caches[0][key], caches[1][key])
        assert torch.equal(caches[0][key], caches[2][key])
    assert len(lk) == len(lc) == dims.layers + 1 and all(map(torch.equal, lk, lc))


@pytest.mark.cuda
def test_fused_decode_step_refuses_what_it_does_not_take(cuda_device):
    params, dims, x, kv, valid, anc, pos = _k1_case(cuda_device)
    cache = {"k": kv[0].clone(), "v": kv[1].clone()}
    with pytest.raises(ValueError):   # the ancestry map's rows do not match
        decode_step.fused_decode_step(params, x, dims, pos, cache, valid, anc[:2], 3)
    with pytest.raises(ValueError):   # a non-contiguous cache
        decode_step.fused_decode_step(params, x, dims, pos,
                                      {"k": kv[0].transpose(2, 3), "v": kv[1]}, valid, anc, 3)
    with pytest.raises(ValueError):   # pos outside the cache
        decode_step.fused_decode_step(params, x, dims, kv.shape[3], cache, valid, anc, 3)


def _int4_args(M, K, N, device):
    """x, an int4 weight (N, K/2) from random bf16 values, scale, bias."""
    x, _, _, bias = _int8_args(M, K, N, device)
    g = torch.Generator().manual_seed(K + N)
    p = quantize_dense_int4({"weight": 0.02 * torch.randn((N, K), generator=g)})
    return x, p["q4"].to(device), p["scale"].to(device), bias


def _kvq_cache(kv):
    """The int8 cache {"k", "v", "kvs"} of a bf16 (2, L, B, S, D) one."""
    heads = kv.shape[-1] // 64
    k, v, kvs = kv_quantize_flat(kv[0], kv[1], heads)
    return {"k": k, "v": v, "kvs": kvs}


def _rows_within(got, ref, key):
    """int8 rows within 1 count, scale rows within 1 bf16 ulp."""
    if key == "kvs":
        g, r = got.float(), ref.float()
        ulp = 2.0 ** (torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - 7)
        return bool(((g - r).abs() <= ulp).all())
    return int((got.int() - ref.int()).abs().max()) <= 1


def test_cpu_tensors_run_the_int4_and_int8_cache_twins_without_counting():
    before = (int8.int4_matvec.launches, int8.int4_mlp.launches,
              decode_step.decode_attention.kvq_launches, decode_step.fused_decode_step.launches)
    x, q4, scale, bias = _int4_args(3, 64, 48, "cpu")
    torch.testing.assert_close(int8.int4_matvec(x, q4, scale=scale, bias=bias),
                               int8.int4_matvec_plain(x, q4, scale=scale, bias=bias))
    params, dims, x, kv, valid, anc, pos = _k1_case("cpu", S=32, pos=20, dims=GPT2Dims(1, 64, 4),
                                                    quantize=quantize_gpt2_int4)
    caches = [_kvq_cache(kv) for _ in range(2)]
    h = decode_step.fused_decode_step(params, x, dims, pos, caches[0], valid, anc, 3)
    ref = decode_step.fused_decode_step_plain(params, x, dims, pos, caches[1], valid, anc, 3)
    assert torch.equal(h, ref)
    for key in ("k", "v", "kvs"):
        assert torch.equal(caches[0][key], caches[1][key])
    assert (int8.int4_matvec.launches, int8.int4_mlp.launches,
            decode_step.decode_attention.kvq_launches,
            decode_step.fused_decode_step.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", GEMV_SHAPES + [(5, 64, 96), (3, 64, 1000)])
def test_int4_matvec_kernel_matches_plain(cuda_device, M, K, N):
    x, q4, scale, bias = _int4_args(M, K, N, cuda_device)
    assert bool(((q4 << 4) >> 4).lt(0).any()) and bool((q4 >> 4).lt(0).any())
    before = int8.int4_matvec.launches
    out = int8.int4_matvec(x, q4)
    assert int8.int4_matvec.launches == before + 1
    assert out.dtype == torch.float32
    assert rel_l2(out, int8.int4_matvec_plain(x, q4)) <= 1e-3
    ln = (torch.ones(K, device=cuda_device, dtype=torch.bfloat16),
          torch.zeros(K, device=cuda_device, dtype=torch.bfloat16))
    res = torch.randn((M, N), device=cuda_device).to(torch.bfloat16)
    for kw in (dict(scale=scale, bias=bias), dict(ln=ln, scale=scale, bias=bias),
               dict(scale=scale, bias=bias, residual=res)):
        assert rel_l2(int8.int4_matvec(x, q4, **kw), int8.int4_matvec_plain(x, q4, **kw)) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("w4", [False, True])
@pytest.mark.parametrize("M,K,N", [(3, 1280, 3840), (3, 5120, 1280), (24, 5120, 1280),
                                   (3, 2560, 1280)])
def test_gemv_kernel_is_deterministic(cuda_device, M, K, N, w4):
    """Two launches on the same inputs give the same bits: the split-K sum
    runs in a fixed order, with no atomics."""
    x, q, scale, bias = (_int4_args if w4 else _int8_args)(M, K, N, cuda_device)
    fn = int8.int4_matvec if w4 else int8.int8_matvec
    ln = (torch.rand(K, device=cuda_device).to(torch.bfloat16),
          torch.randn(K, device=cuda_device).to(torch.bfloat16))
    for kw in (dict(), dict(ln=ln, scale=scale, bias=bias)):
        first = fn(x, q, **kw)
        assert all(torch.equal(first, fn(x, q, **kw)) for _ in range(3))


@pytest.mark.cuda
def test_gemv_order_does_not_depend_on_n(cuda_device):
    """K6's qkv shard (N=1920) equals the unsharded qkv (N=3840) row for row."""
    x, q, scale, bias = _int8_args(3, 1280, 3840, cuda_device)
    full = int8.int8_matvec(x, q, scale=scale, bias=bias)
    half = int8.int8_matvec(x, q[1920:].contiguous(), scale=scale[1920:].contiguous(),
                            bias=bias[1920:].contiguous())
    assert torch.equal(full[:, 1920:], half)


@pytest.mark.cuda
def test_int4_mlp_kernel_matches_plain(cuda_device):
    x, w1, s1, b1 = _int4_args(3, 1280, 5120, cuda_device)
    _, w2, _, _ = _int4_args(3, 5120, 1280, cuda_device)
    before = int8.int4_mlp.launches
    out = int8.int4_mlp(x, w1, s1, b1, w2)
    assert int8.int4_mlp.launches == before + 1
    assert rel_l2(out, int8.int4_mlp_plain(x, w1, s1, b1, w2)) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["kvq", "w4", "w4-kvq"])
def test_fused_decode_step_variants_match_plain_and_ancestry_is_exact(cuda_device, variant):
    kvq = variant.endswith("kvq")
    quantize = quantize_gpt2_int4 if variant.startswith("w4") else quantize_gpt2_int8
    params, dims, x, kv, valid, anc, pos = _k1_case(cuda_device, quantize=quantize)
    make = _kvq_cache if kvq else (lambda t: {"k": t[0].clone(), "v": t[1].clone()})
    caches = [make(kv) for _ in range(2)]
    before = (decode_step.fused_decode_step.launches, decode_step.decode_attention.kvq_launches)
    h = decode_step.fused_decode_step(params, x, dims, pos, caches[0], valid, anc, 3)
    assert decode_step.fused_decode_step.launches == before[0] + 1
    assert decode_step.decode_attention.kvq_launches == before[1]   # one persistent launch
    ref = decode_step.fused_decode_step_plain(params, x, dims, pos, caches[1], valid, anc, 3)
    torch.cuda.synchronize()
    assert rel_l2(h, ref) <= 1e-2
    for key in caches[0]:
        if kvq:
            assert _rows_within(caches[0][key][0, :, pos], caches[1][key][0, :, pos], key)
        else:
            assert rel_l2(caches[0][key][:, :, pos], caches[1][key][:, :, pos]) <= 1e-2
    rows = (torch.arange(3, device=cuda_device)[:, None] // 3) * 3 + anc.long()
    pos_ix = torch.arange(kv.shape[3], device=cuda_device)[None, :]
    gathered = {key: t[:, rows, pos_ix].contiguous() for key, t in make(kv).items()}
    h_gat = decode_step.fused_decode_step(params, x, dims, pos, gathered,
                                          valid[rows, pos_ix].contiguous())
    assert torch.equal(h, h_gat)
    for key in caches[0]:
        assert torch.equal(caches[0][key][:, :, pos], gathered[key][:, :, pos])


# decode_attention at the plan test's edge positions (pos, S): the chunk
# edges, the main path's 300, the cache's last slot, max_mel_tokens' reach
DA_EDGES = [(0, 512), (1, 512), (63, 512), (64, 512), (65, 512), (300, 512), (511, 512),
            (1500, 2048)]


def _da_case(device, M, H, S, pos, group, kvq, seed=0):
    """decode_attention's inputs: qkv of the current token, one layer of a
    (M, S, 64H) cache filled below pos (int8 with its scale rows for kvq),
    rows starting at 0, 5, 10, ... and the last row fully padded (start =
    pos + 1), a random in-group ancestry map at group > 1."""
    g = torch.Generator().manual_seed(seed)
    D = 64 * H
    qkv = torch.randn((M, 3 * D), generator=g).to(device, torch.bfloat16)
    k, v = torch.randn((2, M, S, D), generator=g).to(device, torch.bfloat16)
    k[:, pos:], v[:, pos:] = 0, 0
    valid = torch.zeros((M, S), dtype=torch.bool)
    for r in range(M - 1):
        valid[r, min(5 * r, pos):pos + 1] = True
    anc = torch.randint(0, group, (M, S), generator=g, dtype=torch.int32).to(device) \
        if group > 1 else None
    cache = dict(zip("k v kvs".split(), kv_quantize_flat(k, v, H))) if kvq else {"k": k, "v": v}
    return qkv, cache, valid.to(device), anc


def _da_counter(kvq):
    return decode_step.decode_attention.kvq_launches if kvq \
        else decode_step.decode_attention.launches


@pytest.mark.cuda
@pytest.mark.parametrize("kvq", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("pos,S", DA_EDGES)
def test_decode_attention_kernel_matches_plain(cuda_device, pos, S, group, kvq):
    """Against the twin (rel-L2 <= 1e-2, the written rows bit-identical),
    two launches bit-identical, and with the ancestry map bit-identical to
    the same kernel on the physically gathered cache."""
    qkv, base, valid, anc = _da_case(cuda_device, 3, 20, S, pos, group, kvq)
    caches = [{k: t.clone() for k, t in base.items()} for _ in range(3)]
    before = _da_counter(kvq)
    out = decode_step.decode_attention(qkv, caches[0]["k"], caches[0]["v"], valid, pos, 20, anc,
                                       group, caches[0].get("kvs"))
    assert _da_counter(kvq) == before + 1
    again = decode_step.decode_attention(qkv, caches[1]["k"], caches[1]["v"], valid, pos, 20,
                                         anc, group, caches[1].get("kvs"))
    ref = decode_step.decode_attention_plain(qkv, caches[2]["k"], caches[2]["v"], valid, pos, 20,
                                             anc, group, caches[2].get("kvs"))
    torch.cuda.synchronize()
    assert rel_l2(out, ref) <= 1e-2
    if anc is None:     # the fully padded row (under ancestry its slots are its group's rows')
        assert torch.equal(out[-1], torch.zeros_like(out[-1]))
    assert torch.equal(out, again)
    for key in base:
        assert torch.equal(caches[0][key], caches[1][key])
        assert torch.equal(caches[0][key][:, pos], caches[2][key][:, pos])
    if anc is not None:
        rows = (torch.arange(3, device=cuda_device)[:, None] // group) * group + anc.long()
        slot = torch.arange(S, device=cuda_device)[None, :]
        gat = {key: t[rows, slot].contiguous() for key, t in base.items()}
        out_gat = decode_step.decode_attention(qkv, gat["k"], gat["v"],
                                               valid[rows, slot].contiguous(), pos, 20,
                                               kvs=gat.get("kvs"))
        assert torch.equal(out, out_gat)


@pytest.mark.cuda
@pytest.mark.parametrize("kvq", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("pos,S", [(65, 512), (300, 512), (1500, 2048)])
def test_decode_attention_heads_do_not_depend_on_h(cuda_device, pos, S, kvq):
    """Heads [0, 10) of an H=10 call (K6's shard) equal the same heads of an
    H=20 call bit for bit (at pos 1500 the two launch with other plans)."""
    qkv, base, valid, anc = _da_case(cuda_device, 3, 20, S, pos, 3, kvq, seed=1)
    full = {k: t.clone() for k, t in base.items()}
    out = decode_step.decode_attention(qkv, full["k"], full["v"], valid, pos, 20, anc, 3,
                                       full.get("kvs"))
    Dh = 640
    sub_qkv = torch.cat([qkv[:, j * 1280:j * 1280 + Dh] for j in range(3)], 1).contiguous()
    sub = {k: (t.clone() if k == "kvs" else t[..., :Dh].contiguous()) for k, t in base.items()}
    half = decode_step.decode_attention(sub_qkv, sub["k"], sub["v"], valid, pos, 10, anc, 3,
                                        sub.get("kvs"))
    torch.cuda.synchronize()
    assert torch.equal(half, out[:, :Dh])
    assert torch.equal(sub["k"][:, pos], full["k"][:, pos, :Dh])


@pytest.mark.cuda
@pytest.mark.parametrize("kvq", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("pos,S", [(1, 512), (65, 512), (300, 512), (1500, 2048)])
def test_decode_attention_plan_does_not_change_the_bits(cuda_device, pos, S, kvq):
    """The output and the written rows are bit-identical under every plan of
    1, 2, 4 or 5 heads a block (`attention_plan(heads=)`)."""
    qkv, base, valid, anc = _da_case(cuda_device, 3, 20, S, pos, 3, kvq, seed=2)
    outs, caches = [], []
    for heads in (None, 1, 2, 4, 5):
        c = {k: t.clone() for k, t in base.items()}
        plan = None if heads is None else decode_step.attention_plan(3, 20, pos, kvq,
                                                                     heads=heads)
        outs.append(decode_step.decode_attention(qkv, c["k"], c["v"], valid, pos, 20, anc, 3,
                                                 c.get("kvs"), plan))
        caches.append(c)
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert all(torch.equal(c[k], caches[0][k]) for c in caches[1:] for k in c)


@pytest.mark.cuda
def test_decode_attention_refuses_a_misaligned_operand(cuda_device):
    qkv, base, valid, anc = _da_case(cuda_device, 3, 20, 512, 300, 3, False)
    shifted = torch.zeros(3 * 512 + 1, dtype=torch.bool, device=cuda_device)[1:].view(3, 512)
    shifted.copy_(valid)
    with pytest.raises(ValueError, match="aligned"):
        decode_step.decode_attention(qkv, base["k"], base["v"], shifted, 300, 20, anc, 3)


def _edge_ulps(out, ref, L):
    """The largest error on the 4 rows at each edge of [0, L), over the
    rows' largest magnitude, in units of 2 bf16 ulps (2**-6 relative)."""
    worst = 0.0
    for rows in (slice(0, min(4, L)), slice(max(0, L - 4), L)):
        o, r = out[rows].float(), ref[rows].float()
        worst = max(worst, ((o - r).abs().max() / (2 ** -6 * r.abs().max()).clamp_min(1e-30))
                    .item())
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("logscale", [True, False])
@pytest.mark.parametrize("C", [24, 768])
@pytest.mark.parametrize("T,lengths", [(10, [10, 3]), (100, [1, 100]), (1000, [37, 999])])
def test_antialias_kernels_at_the_edges(cuda_device, T, lengths, C, logscale):
    """K3, K5 and K3' at T under the 16-row run, L = 1, L < T, the narrowest
    and a wide width: rel-L2 <= 1e-3 over the valid rows, the 4 rows at each
    edge within 2 bf16 ulps, and the three entries bit-identical."""
    x, alpha, beta, lens = _snake_args(T, C, lengths, cuda_device)
    if not logscale:
        alpha, beta = alpha.exp(), beta.exp()
    ref = snake.antialias_snake_plain(x, alpha, beta, lens, logscale)
    f = 2 if T % 2 == 0 else 1
    outs = [snake.antialias_snake(x, alpha, beta, lens, logscale),
            snake.fused_antialias_activation(x, alpha, beta, lens, logscale),
            snake.antialias_activation_prefolded(x.view(2, T // f, f * C), alpha, beta, f, C,
                                                 lens, logscale).view(2, T, C)]
    torch.cuda.synchronize()
    for b, L in enumerate(lengths):
        L = min(L, T)
        assert rel_l2(outs[0][b, :L], ref[b, :L]) <= 1e-3
        assert _edge_ulps(outs[0][b], ref[b], L) <= 1.0
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("logscale", [True, False])
@pytest.mark.parametrize("C", [96, 768])
@pytest.mark.parametrize("T,lengths", [(10, [10, 3]), (1000, [37, 999])])
def test_antialias_kernels_at_fp16(cuda_device, T, lengths, C, logscale):
    """K3, K5 and K3' on fp16 (BigVGAN v1's type): rel-L2 <= 1e-3 over the
    valid rows, the 4 rows at each edge within 2 fp16 ulps (2**-9 of their
    largest magnitude), the three entries bit-identical; an f32 input is
    refused."""
    x, alpha, beta, lens = _snake_args(T, C, lengths, cuda_device, torch.float16)
    if not logscale:
        alpha, beta = alpha.exp(), beta.exp()
    ref = snake.antialias_snake_plain(x, alpha, beta, lens, logscale)
    f = 2 if T % 2 == 0 else 1
    outs = [snake.antialias_snake(x, alpha, beta, lens, logscale),
            snake.fused_antialias_activation(x, alpha, beta, lens, logscale),
            snake.antialias_activation_prefolded(x.view(2, T // f, f * C), alpha, beta, f, C,
                                                 lens, logscale).view(2, T, C)]
    torch.cuda.synchronize()
    assert all(o.dtype == torch.float16 for o in outs)
    for b, L in enumerate(lengths):
        assert rel_l2(outs[0][b, :L], ref[b, :L]) <= 1e-3
        for rows in (slice(0, min(4, L)), slice(max(0, L - 4), L)):
            o, r = outs[0][b, rows].float(), ref[b, rows].float()
            assert (o - r).abs().max() <= 2 ** -9 * r.abs().max()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    with pytest.raises(ValueError, match="bf16 or fp16"):
        snake.antialias_snake(x.float(), alpha, beta, lens, logscale)


@pytest.mark.cuda
def test_antialias_kernel_takes_a_width_off_8_and_refuses_one_off_4(cuda_device):
    s = _snake_args(100, 20, [100, 61], cuda_device)
    out, ref = snake.antialias_snake(*s), snake.antialias_snake_plain(*s)
    torch.cuda.synchronize()
    assert rel_l2(out[0], ref[0]) <= 1e-3 and rel_l2(out[1, :61], ref[1, :61]) <= 1e-3
    x, alpha, beta, lens = _snake_args(64, 22, [64], cuda_device)
    with pytest.raises(ValueError, match="multiple of 4"):
        snake.antialias_snake(x, alpha, beta, lens)


@pytest.mark.cuda
@ATTN_DTYPES
@pytest.mark.parametrize("H,D,transposed", [(8, 64, True), (16, 32, True), (4, 128, True),
                                            (2, 16, False)])
def test_single_block_attention_kernel_matches_plain(cuda_device, H, D, transposed, dtype):
    lengths = [1280, 645]
    q, k, v, lens = _block_args(1280, lengths, cuda_device, H, D, transposed, dtype)
    before = attn.single_block_attention.launches
    out = attn.single_block_attention(q, k, v, lens)
    assert attn.single_block_attention.launches == before + 1
    ref = attn.single_block_attention_plain(q, k, v, lens)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == dtype
    for b, L in enumerate(lengths):
        assert rel_l2(out[b, :, :L], ref[b, :, :L]) <= 2e-2
    assert torch.isfinite(out).all()


@pytest.mark.cuda
@ATTN_DTYPES
@pytest.mark.parametrize("D", [16, 32, 48, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("T,lengths,transposed", [(1000, [0, 1000], True), (1279, [1, 2000], False),
                                                  (1279, [1279], True)])
def test_single_block_attention_kernel_edges(cuda_device, D, T, lengths, transposed, dtype):
    """K4 at each head width: T off the tile, a length of 0 (every key), 1,
    T and past T, B=1, transposed and contiguous views."""
    q, k, v, lens = _block_args(T, lengths, cuda_device, 2, D, transposed, dtype)
    out = attn.single_block_attention(q, k, v, lens)
    ref = attn.single_block_attention_plain(q, k, v, lens)
    torch.cuda.synchronize()
    for b, L in enumerate(lengths):
        L = min(L, T) or T
        assert rel_l2(out[b, :, :L], ref[b, :, :L]) <= 2e-2
    assert torch.isfinite(out).all()


@pytest.mark.cuda
def test_attention_kernels_refuse_a_layout_tma_cannot_read(cuda_device):
    """A q whose time stride is not a multiple of 16 bytes (a slice of wider
    rows) raises ValueError in the wrapper; nothing is copied or launched."""
    before = _launches()
    wide = torch.zeros((2, 8, 128, 68), device=cuda_device, dtype=torch.bfloat16)
    _, k, v, lens = _block_args(128, [128, 64], cuda_device, 8, 64, transposed=False)
    with pytest.raises(ValueError, match="16 bytes"):
        attn.single_block_attention(wide[..., :64], k, v, lens)
    q = torch.zeros((2, 8, 200), device=cuda_device, dtype=torch.bfloat16).view(-1)[4:]
    q = q[:2 * 8 * 128].view(2, 8, 128)    # contiguous, base 8 bytes off
    with pytest.raises(ValueError, match="16 bytes"):
        attn.packed_pair_attention(q, q, q, lens, 2)
    assert _launches() == before


@pytest.mark.cuda
def test_single_block_attention_kernel_raises_on_what_it_does_not_take(cuda_device):
    """A head width of 40 raises in K4's wrapper: no plain fallback runs."""
    before = attn.single_block_attention.launches
    q, k, v, lens = _block_args(128, [128], cuda_device, 8, 40)
    with pytest.raises(ValueError, match="multiple of 16"):
        attn.single_block_attention(q, k, v, lens)
    q, k, v, lens = _block_args(128, [128], cuda_device, 2, 64)
    with pytest.raises(ValueError, match="bf16"):
        attn.single_block_attention(q.float(), k, v, lens)
    assert attn.single_block_attention.launches == before


@pytest.mark.cuda
@ATTN_DTYPES
@pytest.mark.parametrize("T,lengths", [(256, [256, 141]), (1280, [1243, 645])] + ATTN_EDGES[1:])
def test_packed_pair_attention_kernel_matches_plain(cuda_device, T, lengths, dtype):
    q, k, v, lens, _, H = _attn_args(T, lengths, cuda_device, dtype)
    before = _launches()
    out = attn.packed_pair_attention(q, k, v, lens, H)
    after = _launches()
    assert [x - y for x, y in zip(after, before)] == [0, 1, 0, 0, 0, 0, 0]
    ref = attn.packed_pair_attention_plain(q, k, v, lens, H)
    torch.cuda.synchronize()
    for b, L in enumerate(lengths):
        L = min(L, T)
        assert rel_l2(out[b, :L], ref[b, :L]) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("logscale", [True, False])
@pytest.mark.parametrize("T,C,lengths", [(512, 768, [512, 480]), (4096, 24, [4096, 4059]),
                                         (1000, 96, [1, 999])])
def test_antialias_entries_match_plain(cuda_device, T, C, lengths, logscale):
    """K5 on (B, T, C) and K3' on its (B, T/f, f*C) fold, f = 128 // gcd(C,
    128), each counted by its own entry."""
    import math

    x, alpha, beta, lens = _snake_args(T, C, lengths, cuda_device)
    if not logscale:
        alpha, beta = alpha.exp(), beta.exp()
    ref = snake.antialias_snake_plain(x, alpha, beta, lens, logscale)
    before = _counters()
    out = snake.fused_antialias_activation(x, alpha, beta, lens, logscale)
    f = 128 // math.gcd(C, 128)
    folded = snake.antialias_activation_prefolded(x.reshape(2, T // f, f * C), alpha, beta,
                                                  f, C, lens, logscale)
    torch.cuda.synchronize()
    after = _counters()
    assert after[3:] == (before[3], before[4] + 1, before[5] + 1)
    for b, L in enumerate(lengths):
        assert rel_l2(out[b, :L], ref[b, :L]) <= 1e-2
    assert torch.equal(folded.reshape(2, T, C), out)


@pytest.mark.cuda
def test_sampling_decode_takes_k1_at_group_1(cuda_device):
    """num_beams=1 with int8 weights at B <= 24: K1 once a decode step (11
    after the prefill for 12 codes, across two cache growths), the bf16
    step never."""
    from indextts_tpu_torch.config import GPTConfig
    from indextts_tpu_torch.engine import decode
    from indextts_tpu_torch.models.gpt.gpt2 import gpt2_decode_step
    from indextts_tpu_torch.models.gpt.unified_voice import init_unified_voice

    cfg = GPTConfig(layers=2, model_dim=640, heads=10, max_text_tokens=30, max_mel_tokens=60,
                    number_text_tokens=40, number_mel_codes=50, start_mel_token=48,
                    stop_mel_token=49)
    params = to_torch(init_unified_voice(InitRng(0, cuda_device), cfg), cuda_device,
                      torch.bfloat16)
    params["gpt"] = quantize_gpt2_int8(params["gpt"])
    g = torch.Generator(device=cuda_device).manual_seed(0)
    prefix = torch.randn((2, 9, 640), generator=g, device=cuda_device).to(torch.bfloat16)
    mask = torch.ones((2, 9), dtype=torch.bool, device=cuda_device)
    mask[1, :4] = False
    k1, calls = decode_step.fused_decode_step.launches, gpt2_decode_step.calls
    toks, lens = decode.generate_adaptive(
        params, cfg, GPT2Dims(2, 640, 10), prefix, mask, g, 12,
        decode.SamplingConfig(num_beams=1, min_new_tokens=11), spans=(4, 8))
    torch.cuda.synchronize()
    assert decode.last_route == "fused"
    assert decode_step.fused_decode_step.launches == k1 + 11
    assert gpt2_decode_step.calls == calls
    assert list(lens) == [12, 12] and bool(((toks >= 0) & (toks < 50)).all())


def _k1_decode_case(device):
    """The 2 x 640 int8 GPT of `test_sampling_decode_takes_k1_at_group_1`
    on the card, and one 9-token prefix."""
    from indextts_tpu_torch.config import GPTConfig
    from indextts_tpu_torch.models.gpt.unified_voice import init_unified_voice

    cfg = GPTConfig(layers=2, model_dim=640, heads=10, max_text_tokens=30, max_mel_tokens=60,
                    number_text_tokens=40, number_mel_codes=50, start_mel_token=48,
                    stop_mel_token=49)
    params = to_torch(init_unified_voice(InitRng(0, device), cfg), device, torch.bfloat16)
    params["gpt"] = quantize_gpt2_int8(params["gpt"])
    g = torch.Generator(device=device).manual_seed(0)
    prefix = torch.randn((1, 9, 640), generator=g, device=device).to(torch.bfloat16)
    return cfg, params, prefix, torch.ones((1, 9), dtype=torch.bool, device=device), g


@pytest.mark.cuda
def test_speculative_decode_takes_k1_for_single_steps(cuda_device):
    """The one-row speculative decoder with int8 weights on the card: K1 at
    group=1 once a single step, the chunk step once a verify, never the
    plain step, with drafts from the sequential decode's codes (K1's rounding
    chain may part the two early, so commits are not counted)."""
    from indextts_tpu_torch.engine import decode, speculative
    from indextts_tpu_torch.models.gpt.gpt2 import gpt2_chunk_step, gpt2_decode_step

    cfg, params, prefix, mask, g = _k1_decode_case(cuda_device)
    samp = decode.SamplingConfig(num_beams=1, do_sample=False, min_new_tokens=23)
    seq, _ = decode.generate_adaptive(params, cfg, GPT2Dims(2, 640, 10), prefix, mask, g, 24,
                                      samp)
    k1, calls, chunks = (decode_step.fused_decode_step.launches, gpt2_decode_step.calls,
                         gpt2_chunk_step.calls)
    toks, lens, stats = speculative.generate_spec(params, cfg, GPT2Dims(2, 640, 10), prefix,
                                                  mask, g, 24, samp, gamma=4, forced=True,
                                                  draft_source=seq[0])
    torch.cuda.synchronize()
    assert decode.last_route == "fused" and stats[0] > 0 and stats[1] >= stats[0]
    assert decode_step.fused_decode_step.launches == k1 + stats[2]
    assert gpt2_chunk_step.calls == chunks + stats[0] and gpt2_decode_step.calls == calls
    assert list(lens) == [24] and bool(((toks >= 0) & (toks < 50)).all())


@pytest.mark.cuda
def test_diverse_beam_takes_k1_at_group_2(cuda_device):
    """Diverse beam search at num_beams=4, two groups, int8 weights: K1 with
    the ancestry map at group=2 once a decode step, no cache gather."""
    from indextts_tpu_torch.engine import beam, decode

    cfg, params, prefix, mask, g = _k1_decode_case(cuda_device)
    samp = decode.SamplingConfig(num_beams=4, num_beam_groups=2, diversity_penalty=1.0,
                                 do_sample=False, min_new_tokens=11)
    k1, gathers = decode_step.fused_decode_step.launches, beam.kv_gathers
    toks, lens = beam.generate_group_beam(params, cfg, GPT2Dims(2, 640, 10), prefix, mask, g,
                                          12, samp)
    torch.cuda.synchronize()
    assert beam.last_use_anc is True and beam.kv_gathers == gathers
    assert decode_step.fused_decode_step.launches == k1 + 11
    assert list(lens) == [12] and bool(((toks >= 0) & (toks < 50)).all())


def _tp_case(device, group=1):
    """K1's case split over a tp=2 mesh of ``device`` named twice: the int8
    tree, its shards, and a maker of fresh per-shard caches."""
    params, dims, x, kv, valid, anc, pos = _k1_case(device)
    tp = shard_gpt2_tp(params, make_mesh([device, device]))
    Dl = dims.dim // 2

    def cache():
        return {"shards": [{k: kv[i][..., t * Dl:(t + 1) * Dl].contiguous()
                            for i, k in enumerate("kv")} for t in range(2)]}
    return params, tp, dims, x, cache, valid, anc if group > 1 else None, pos


def test_cpu_tensors_run_the_tp_twins_without_counting():
    before = (decode_step_tp.tp_allreduce.launches, decode_step_tp.fused_decode_step_tp.launches)
    params, tp, dims, x, cache, valid, anc, pos = _tp_case("cpu", group=3)
    h = decode_step_tp.fused_decode_step_tp(tp, x, dims, pos, cache(), valid, anc, 3)
    ref = decode_step_tp.fused_decode_step_tp_plain(tp, x, dims, pos, cache(), valid, anc, 3)
    assert torch.equal(h, ref)
    assert (decode_step_tp.tp_allreduce.launches,
            decode_step_tp.fused_decode_step_tp.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("M", [3, 24])
def test_tp_allreduce_kernel_bit_identical_to_plain(cuda_device, M):
    g = torch.Generator().manual_seed(M)
    p0, p1 = (1e3 * torch.randn((M, 1280), generator=g)).to(cuda_device), \
        (1e3 * torch.randn((M, 1280), generator=g)).to(cuda_device)
    scale = (torch.rand(1280, generator=g) / 127 / 30).to(cuda_device)
    bias = (0.1 * torch.randn(1280, generator=g)).to(cuda_device, torch.bfloat16)
    res = torch.randn((M, 1280), generator=g).to(cuda_device, torch.bfloat16)
    before = decode_step_tp.tp_allreduce.launches
    out0 = decode_step_tp.tp_allreduce(p0, p1, scale, bias, res, 0)
    out1 = decode_step_tp.tp_allreduce(p1, p0, scale, bias, res, 1)
    ref = decode_step_tp.tp_allreduce_plain(p0, p1, scale, bias, res, 0)
    torch.cuda.synchronize()
    assert decode_step_tp.tp_allreduce.launches == before + 2
    assert torch.equal(out0, ref) and torch.equal(out1, ref)
    with pytest.raises(ValueError, match="rank"):
        decode_step_tp.tp_allreduce(p0, p1, scale, bias, res, 2)
    with pytest.raises(ValueError, match="bfloat16"):
        decode_step_tp.tp_allreduce(p0, p1, scale, bias, res.float(), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 3])
def test_fused_decode_step_tp_co_located_matches_plain(cuda_device, group):
    params, tp, dims, x, cache, valid, anc, pos = _tp_case(cuda_device, group)
    kc, xs = cache(), []
    before = (decode_step_tp.fused_decode_step_tp.launches, decode_step_tp.tp_allreduce.launches)
    h = decode_step_tp.fused_decode_step_tp(tp, x, dims, pos, kc, valid, anc, group,
                                            layer_inputs=xs)
    torch.cuda.synchronize()
    # one persistent launch; the exchange is folded into it, no tp_allreduce
    assert (decode_step_tp.fused_decode_step_tp.launches,
            decode_step_tp.tp_allreduce.launches) == (before[0] + 1, before[1])
    D, Dl = dims.dim, dims.dim // 2
    for li, layers in enumerate(zip(*tp["shards"])):
        assert torch.equal(*xs[li])                       # the residual streams agree
        y = decode_step_tp.decode_layer_tp(decode_step_tp.TWINS, layers, list(xs[li]),
                                           dims.heads // 2, pos, cache()["shards"], li,
                                           [valid] * 2, [anc] * 2, group)
        assert rel_l2(xs[li + 1][0], y[0]) <= 1e-2
        lp = params["h"][li]
        qkv = int8.int8_matvec(xs[li][0], lp["attn"]["c_attn"]["q"],
                               ln=(lp["ln_1"]["weight"], lp["ln_1"]["bias"]),
                               scale=lp["attn"]["c_attn"]["scale"],
                               bias=lp["attn"]["c_attn"]["bias"])
        for t, c in enumerate(kc["shards"]):
            for j, key in ((1, "k"), (2, "v")):
                cols = slice(j * D + t * Dl, j * D + (t + 1) * Dl)
                assert torch.equal(c[key][li, :, pos], qkv[:, cols])
    assert torch.equal(h, xs[-1][0]) and torch.equal(*xs[-1])
    ref = decode_step_tp.fused_decode_step_tp_plain(tp, x, dims, pos, cache(), valid, anc, group)
    assert rel_l2(h, ref) <= 1e-2


# K6's bit-identity cases: label -> (rows, S, pos)
TP_CASES = {"pos=0": (3, 256, 0), "pos=1": (3, 256, 1), "pos=150": (3, 256, 150),
            "S=2048 pos=1500": (3, 2048, 1500), "24 rows": (24, 256, 150)}


def _tp_counters():
    """K6's launches, then those of the kernels of its chain and K1's."""
    return (decode_step_tp.fused_decode_step_tp.launches, decode_step_tp.tp_allreduce.launches,
            int8.int8_matvec.launches, int8.int8_mlp.launches,
            decode_step.decode_attention.launches, decode_step.fused_decode_step.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TP_CASES))
@pytest.mark.parametrize("group", [3, 1])
def test_fused_decode_step_tp_bit_identical_to_the_chain(cuda_device, group, case):
    """K6 co-located (one persistent launch a step) against the chain of
    standalone kernels it replaced, on copies of the shards' caches: the
    hidden state, both caches after the step and every layer's input
    bit-identical, a second launch repeating the first, `step_barriers`
    grid barriers, and no tp_allreduce, GEMV, attention or K1 launch."""
    B, S, pos = TP_CASES[case]
    params, dims, x, kv, valid, anc, _ = _k1_case(cuda_device, B=B, S=S, pos=pos)
    anc = anc % 3 if group > 1 else None      # in-group rows
    tp = shard_gpt2_tp(params, make_mesh([cuda_device, cuda_device]))
    Dl = dims.dim // 2
    base = [{k: kv[i][..., t * Dl:(t + 1) * Dl].contiguous() for i, k in enumerate("kv")}
            for t in range(2)]
    caches = [{"shards": [{k: c.clone() for k, c in b.items()} for b in base]} for _ in range(3)]
    count = decode_step.step_barrier(x.device)
    before = (int(count[1]), *_tp_counters())
    lk, lc = [], []
    h = decode_step_tp.fused_decode_step_tp(tp, x, dims, pos, caches[0], valid, anc, group,
                                            layer_inputs=lk)
    torch.cuda.synchronize()
    assert int(count[1]) - before[0] == decode_step.step_barriers(dims.layers)
    after = _tp_counters()
    assert after[0] == before[1] + 1 and after[1:] == before[2:]   # K6's kernel only
    hc = decode_step_tp.fused_decode_step_tp_chain(tp, x, dims, pos, caches[1], valid, anc,
                                                   group, layer_inputs=lc)
    h2 = decode_step_tp.fused_decode_step_tp(tp, x, dims, pos, caches[2], valid, anc, group)
    torch.cuda.synchronize()
    assert torch.equal(h, hc) and torch.equal(h, h2)
    for t in range(2):
        for key in "kv":
            assert torch.equal(caches[0]["shards"][t][key], caches[1]["shards"][t][key])
            assert torch.equal(caches[0]["shards"][t][key], caches[2]["shards"][t][key])
    assert len(lk) == len(lc) == dims.layers + 1
    for a, b in zip(lk, lc):
        assert all(torch.equal(a[0], t) for t in (*a, *b))


@pytest.mark.cuda
@pytest.mark.parametrize("group", [3, 1])
def test_fused_decode_step_tp_graph_replays_bit_identically(cuda_device, group):
    """A CUDA graph of K6's step (captured after one eager call, which
    uploads the pointer table) replays the eager step's bits, twice."""
    params, tp, dims, x, cache, valid, anc, pos = _tp_case(cuda_device, group)
    eager, captured = cache(), cache()
    h = decode_step_tp.fused_decode_step_tp(tp, x, dims, pos, eager, valid, anc, group)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_step_tp.fused_decode_step_tp(tp, x, dims, pos, captured, valid, anc, group)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_step_tp.fused_decode_step_tp(tp, x, dims, pos, captured, valid, anc, group)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, h)
        for a, b in zip(eager["shards"], captured["shards"]):
            assert all(torch.equal(a[k], b[k]) for k in "kv")


def _two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    return ("cuda:0", "cuda:0"), ("cuda:0", "cuda:1")


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 3])
def test_fused_decode_step_tp_on_two_cards_equals_co_located(group):
    layouts = _two_cards()
    params, dims, x, kv, valid, anc, pos = _k1_case(torch.device("cuda:0"))
    anc = anc if group > 1 else None
    Dl = dims.dim // 2
    runs = []
    for devs in layouts:
        mesh = make_mesh(list(devs))
        tp = shard_gpt2_tp(params, mesh)
        cache = {"shards": [{k: kv[i][..., t * Dl:(t + 1) * Dl].contiguous().to(d)
                             for i, k in enumerate("kv")} for t, d in enumerate(mesh.devices)]}
        xs = []
        h = decode_step_tp.fused_decode_step_tp(
            tp, x, dims, pos, cache, Replicated.of(valid, mesh),
            None if anc is None else Replicated.of(anc, mesh), group, layer_inputs=xs)
        for d in set(mesh.devices):
            torch.cuda.synchronize(d)
        runs.append((h, cache, xs))
    (h0, c0, xs0), (h1, c1, xs1) = runs
    assert h1.device == torch.device("cuda:0") and torch.equal(h0, h1)
    for a, b in zip(c0["shards"], c1["shards"]):
        for key in "kv":
            assert torch.equal(a[key], b[key].to(a[key].device))
    for l0, l1 in zip(xs0, xs1):
        assert all(torch.equal(l0[0], t.to(l0[0].device)) for t in (*l0, *l1))


@pytest.mark.cuda
def test_greedy_tp_decodes_on_two_cards_token_equal_co_located():
    """Prefill, beams (ancestry and gather routes) and the adaptive decode
    with its cache growth, with the shards on two cards and on one."""
    from indextts_tpu_torch.config import GPTConfig
    from indextts_tpu_torch.engine import beam, decode
    from indextts_tpu_torch.models.gpt.unified_voice import init_unified_voice

    layouts = _two_cards()
    dev = torch.device("cuda:0")
    cfg = GPTConfig(layers=2, model_dim=640, heads=10, max_text_tokens=30, max_mel_tokens=60,
                    number_text_tokens=40, number_mel_codes=50, start_mel_token=48,
                    stop_mel_token=49)
    params = to_torch(init_unified_voice(InitRng(0, dev), cfg), dev, torch.bfloat16)
    params["gpt"] = quantize_gpt2_int8(params["gpt"])
    g = torch.Generator(device=dev).manual_seed(0)
    prefix = torch.randn((2, 9, 640), generator=g, device=dev).to(torch.bfloat16)
    mask = torch.ones((2, 9), dtype=torch.bool, device=dev)
    mask[1, :4] = False
    dims = GPT2Dims(2, 640, 10)
    out = {}
    for devs in layouts:
        p = {**params, "gpt": shard_gpt2_tp(params["gpt"], make_mesh(list(devs)))}
        for gather in (False, True):
            out[devs, "beam", gather] = beam.generate_beam(
                p, cfg, dims, prefix, mask, torch.Generator(device=dev).manual_seed(0), 10,
                decode.SamplingConfig(do_sample=False, num_beams=3), cache_gather=gather)
        out[devs, "adaptive"] = decode.generate_adaptive(
            p, cfg, dims, prefix, mask, torch.Generator(device=dev).manual_seed(0), 12,
            decode.SamplingConfig(do_sample=False, num_beams=1, min_new_tokens=11), spans=(4, 8))
        assert decode.last_route == "tp"
    for key in (("beam", False), ("beam", True), ("adaptive",)):
        (t0, l0), (t1, l1) = (out[(layouts[i], *key)] for i in range(2))
        assert torch.equal(t0, t1) and list(l0) == list(l1), key
    assert torch.equal(out[layouts[1], "beam", False][0], out[layouts[1], "beam", True][0])


# ---------------------------------------------------------------------------
# K1 and K6 at fp16: the E = fp16 instantiations (`csrc/decode_step_fp16.cu`)


def _fp16_tree(tree):
    """A quantized tree's bf16 leaves (biases, LayerNorm vectors) at fp16:
    the same values."""
    if isinstance(tree, dict):
        return {k: _fp16_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fp16_tree(v) for v in tree]
    return tree.half() if tree.dtype == torch.bfloat16 else tree


def _fp16_inputs(kv, x):
    """fp16 x and cache off the bf16 grid (bf16 values plus small noise)."""
    g = torch.Generator().manual_seed(16)
    noise = lambda t: (1e-3 * torch.randn(t.shape, generator=g)).to(t.device)  # noqa: E731
    return (kv.float() + noise(kv)).half(), (x.float() + noise(x)).half()


def _bf16_copy(cache):
    return {k: t.to(torch.bfloat16) if t.dtype == torch.float16 else t.clone()
            for k, t in cache.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [1, 150])
@pytest.mark.parametrize("group", [3, 1])
@pytest.mark.parametrize("variant", ["int8", "kvq", "w4", "w4-kvq"])
def test_fused_decode_step_fp16_is_the_bf16_body(cuda_device, variant, group, pos):
    """K1's fp16 instantiation (fp16 x, cache, biases and LayerNorm vectors)
    against the bf16 instantiation on bf16 copies of the same values: every
    layer's output and the rows written at pos bit-identical (the fp16 rows
    equal to the bf16 ones cast); one launch; the output fp16 and within
    rel-L2 1e-2 of the fp16 twin."""
    kvq = variant.endswith("kvq")
    quantize = quantize_gpt2_int4 if variant.startswith("w4") else quantize_gpt2_int8
    params, dims, x, kv, valid, anc, _ = _k1_case(cuda_device, quantize=quantize, pos=pos)
    kv16, x16 = _fp16_inputs(kv, x)
    rows = slice(0, group)
    x16, valid = x16[rows].contiguous(), valid[rows].contiguous()
    anc = anc if group > 1 else None
    base = _kvq_cache(kv16.to(torch.bfloat16)) if kvq else {"k": kv16[0], "v": kv16[1]}
    base = {k: t[:, rows].contiguous() for k, t in base.items()}
    c16, cb, ct = ({k: t.clone() for k, t in base.items()}, _bf16_copy(base),
                   {k: t.clone() for k, t in base.items()})
    p16 = _fp16_tree(params)
    before = decode_step.fused_decode_step.launches
    l16, lb = [], []
    h = decode_step.fused_decode_step(p16, x16, dims, pos, c16, valid, anc, group,
                                      layer_inputs=l16)
    decode_step.fused_decode_step(params, x16.to(torch.bfloat16), dims, pos, cb, valid, anc,
                                  group, layer_inputs=lb)
    ref = decode_step.fused_decode_step_plain(p16, x16, dims, pos, ct, valid, anc, group)
    torch.cuda.synchronize()
    assert decode_step.fused_decode_step.launches == before + 2
    assert h.dtype == torch.float16 and len(l16) == len(lb) == dims.layers + 1
    assert all(torch.equal(a, b) for a, b in zip(l16[1:], lb[1:]))
    for key in base:
        assert torch.equal(c16[key][:, :, pos], cb[key][:, :, pos].to(c16[key].dtype))
    assert rel_l2(h, ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 3])
def test_fused_decode_step_tp_fp16_is_the_bf16_body(cuda_device, group):
    """K6 co-located at fp16 against its bf16 instantiation on bf16 copies:
    every layer's residual stream and both shards' written rows
    bit-identical; the output fp16, within rel-L2 1e-2 of the fp16 twin."""
    params, dims, x, kv, valid, anc, pos = _k1_case(cuda_device)
    kv16, x16 = _fp16_inputs(kv, x)
    rows = slice(0, group)
    x16, valid = x16[rows].contiguous(), valid[rows].contiguous()
    anc = anc if group > 1 else None
    mesh = make_mesh([cuda_device, cuda_device])
    t16, tb = shard_gpt2_tp(_fp16_tree(params), mesh), shard_gpt2_tp(params, mesh)
    Dl = dims.dim // 2

    def cache(dtype):
        return {"shards": [{k: kv16[i][:, rows, ..., t * Dl:(t + 1) * Dl].to(dtype).contiguous()
                            for i, k in enumerate("kv")} for t in range(2)]}

    c16, cb = cache(torch.float16), cache(torch.bfloat16)
    l16, lb = [], []
    h = decode_step_tp.fused_decode_step_tp(t16, x16, dims, pos, c16, valid, anc, group,
                                            layer_inputs=l16)
    decode_step_tp.fused_decode_step_tp(tb, x16.to(torch.bfloat16), dims, pos, cb, valid, anc,
                                        group, layer_inputs=lb)
    ref = decode_step_tp.fused_decode_step_tp_plain(t16, x16, dims, pos, cache(torch.float16),
                                                    valid, anc, group)
    torch.cuda.synchronize()
    assert h.dtype == torch.float16
    assert all(torch.equal(a[0], b[0]) for a, b in zip(l16[1:], lb[1:]))
    for a, b in zip(c16["shards"], cb["shards"]):
        for key in "kv":
            assert torch.equal(a[key][:, :, pos], b[key][:, :, pos].half())
    assert rel_l2(h, ref) <= 1e-2


# each per-layer vector of the step: the LayerNorms' and the GEMVs' biases
FP16_VECTORS = [("ln_1", "weight"), ("ln_1", "bias"), ("ln_2", "weight"), ("ln_2", "bias"),
                ("attn", "c_attn", "bias"), ("attn", "c_proj", "bias"),
                ("mlp", "c_fc", "bias"), ("mlp", "c_proj", "bias")]


def _off_grid(tree, g):
    """`_fp16_tree` with every fp16 leaf (biases, LayerNorm vectors) moved
    by N(0, 0.05) noise: values bf16 cannot hold."""
    if isinstance(tree, dict):
        return {k: _off_grid(v, g) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_off_grid(v, g) for v in tree]
    if tree.dtype != torch.float16:
        return tree
    return (tree.float() + 0.05 * torch.randn(tree.shape, generator=g).to(tree.device)).half()


def _through_bf16(tree, path):
    """The tree with the fp16 vector at ``path`` of every layer rounded to
    bf16 and stored at fp16 again: what a read of it through bf16 sees."""
    def at(node, keys):
        if not keys:
            return node.to(torch.bfloat16).half()
        return {**node, keys[0]: at(node[keys[0]], keys[1:])}

    return {**tree, "h": [at(lp, path) for lp in tree["h"]]}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["int8", "kvq", "w4", "w4-kvq", "tp"])
def test_fused_decode_step_fp16_reads_biases_and_layernorm_vectors_exactly(cuda_device,
                                                                          variant):
    """K1's fp16 instantiation (each variant, group 3) and K6's co-located
    on a tree whose biases and LayerNorm vectors bf16 cannot hold, against
    the same kernel on the tree with one kind of vector rounded to bf16
    (each of the eight in turn): the outputs differ. A kernel that read
    that vector through bf16 would give both trees the same bits."""
    kvq = variant.endswith("kvq")
    quantize = quantize_gpt2_int4 if variant.startswith("w4") else quantize_gpt2_int8
    params, dims, x, kv, valid, anc, pos = _k1_case(cuda_device, quantize=quantize)
    kv16, x16 = _fp16_inputs(kv, x)
    tree = _off_grid(_fp16_tree(params), torch.Generator().manual_seed(5))
    base = _kvq_cache(kv16.to(torch.bfloat16)) if kvq else {"k": kv16[0], "v": kv16[1]}
    mesh = make_mesh([cuda_device, cuda_device])
    Dl = dims.dim // 2

    def step(t):
        if variant != "tp":
            cache = {k: v.clone() for k, v in base.items()}
            return decode_step.fused_decode_step(t, x16, dims, pos, cache, valid, anc, 3)
        cache = {"shards": [{k: kv16[i][..., s * Dl:(s + 1) * Dl].contiguous()
                             for i, k in enumerate("kv")} for s in range(2)]}
        return decode_step_tp.fused_decode_step_tp(shard_gpt2_tp(t, mesh), x16, dims, pos,
                                                   cache, valid, anc, 3)

    h = step(tree)
    assert h.dtype == torch.float16
    for path in FP16_VECTORS:
        assert not torch.equal(h, step(_through_bf16(tree, path))), path


@pytest.mark.cuda
def test_fused_decode_step_tp_fp16_on_two_cards_raises():
    """The chain over two cards runs the bf16-only standalone kernels: at
    fp16 it raises (the two-card fp16 chain is not ported)."""
    _, layout = _two_cards()
    params, dims, x, kv, valid, anc, pos = _k1_case(torch.device("cuda:0"))
    mesh = make_mesh(list(layout))
    tp = shard_gpt2_tp(_fp16_tree(params), mesh)
    Dl = dims.dim // 2
    cache = {"shards": [{k: kv[i][..., t * Dl:(t + 1) * Dl].half().contiguous().to(d)
                         for i, k in enumerate("kv")} for t, d in enumerate(mesh.devices)]}
    with pytest.raises(ValueError, match="not ported"):
        decode_step_tp.fused_decode_step_tp(tp, x.half(), dims, pos, cache,
                                            Replicated.of(valid, mesh))
