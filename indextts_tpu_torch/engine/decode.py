"""The decode engine (PyTorch counterpart of `indextts_tpu/engine/decode.py`):
the decode route and step that every engine takes, and the sampling decode
of ``num_beams=1`` (`generate`, `generate_adaptive`: HF's `_sample`).

Reference quirks kept: mel position indices during incremental decode are
[0] for start_mel and i + 2 for the i-th generated token; HF's repetition
penalty sees the fake prefix ids (all 1s plus start_mel), so token 1 and
start_mel are penalized from the first step.

The JAX engine runs a span of steps as one device loop that exits when every
row has emitted stop_mel. Eagerly, that exit is a host read: the port reads
the all-rows-done flag once every ``_DONE_POLL`` steps inside a span (and
once per span in `generate_adaptive`); a finished row is inert (it emits
stop_mel and counts nothing), so the steps run past the JAX loop's exit
change no token. ``span_growths`` counts the cache growths of
`generate_adaptive`, ``last_route`` the decode route of the last sampling
decode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from indextts_tpu_torch import nn
from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.models.gpt.gpt2 import (GPT2Dims, gpt2_decode_step, gpt2_prefill,
                                                init_kv_cache, is_quantized, map_cache)
from indextts_tpu_torch.models.gpt.unified_voice import mel_logits_from_hidden
from indextts_tpu_torch.nn import Params
from indextts_tpu_torch.ops.decode_step import STEP_DTYPES, fused_decode_step
from indextts_tpu_torch.ops.decode_step_tp import fused_decode_step_tp
from indextts_tpu_torch.ops.int8 import MAX_ROWS
from indextts_tpu_torch.ops.sampling import sample_logits
from indextts_tpu_torch.parallel.mesh import TP, Replicated, is_tp

# steps between two reads of the all-rows-done flag (the decode loops' only
# device->host copy)
_DONE_POLL = 8

# cache growths made by `generate_adaptive`, and the route of the last
# sampling decode ("fused": K1 at group=1; "tp": K6 at group=1; "plain":
# gpt2_decode_step)
span_growths = 0
last_route = None


@dataclass(frozen=True)
class SamplingConfig:
    """The generation kwargs of `IndexTTS2.infer` that the port's engines
    honour (HF semantics; the beam engine ignores the typical warper, as
    the JAX one does). The aux modes' fields select `engine/beam.py::
    generate_group_beam` and `engine/modes.py`."""

    do_sample: bool = True
    temperature: float = 0.8
    top_k: int = 30
    top_p: float = 0.8
    repetition_penalty: float = 10.0
    typical_sampling: bool = False
    typical_mass: float = 0.9
    num_beams: int = 3
    length_penalty: float = 0.0
    min_new_tokens: int = 0
    # diverse (group) beam search, HF `_group_beam_search` (greedy only)
    num_beam_groups: int = 1
    diversity_penalty: float = 0.0
    # contrastive search (HF `_contrastive_search`) when > 0 with top_k > 1
    # and greedy
    penalty_alpha: float = 0.0
    # DoLa (HF `_dola_decoding`): "low" / "high" / a tuple of hidden-state
    # indices (0 = the embeddings); None disables
    dola_layers: object = None
    # the flat int8 KV cache with packed scale rows (`quantization="int8kv"`
    # / `"int4kv"`); prefill attention stays exact, decode runs K1's KVQ
    kv_quant: bool = False


def _cache_len(P: int, span: int) -> int:
    """Cache slots for prefix P + 1 start token + ``span`` generated tokens."""
    return P + 1 + span


def _embed_mel_token(params: Params, token: torch.Tensor, pos: int, dtype) -> torch.Tensor:
    """mel_embedding(token) + mel_pos_embedding(pos); token (B,), pos int."""
    emb = params["mel_embedding"]["weight"].to(dtype)[token.long()]
    return emb + params["mel_pos_embedding"]["weight"][pos].to(dtype)[None, :]


def decode_route(params: Params, batch: int, kv_quant: bool = False) -> str:
    """The decode step a (B*K)-row batch takes (`engine/decode.py::
    _fused_decode_ok` of the JAX package): "fused" (kernel K1) for int8 or
    int4 GPT-2 weights and B*K <= 24, with the cache at the tree's type or
    (``kv_quant``) the int8 cache; "tp" (kernel K6) for the tensor-parallel
    tree of `parallel/mesh.py::shard_gpt2_tp` made with ``kernel`` (the
    pipeline's INDEXTTS_TP_DECODE=kernel) at tp=2 with int8 weights, the
    cache at the tree's type and B*K <= 24, the JAX gate's "tp"; both only
    for a tree of a 16-bit type (`STEP_DTYPES`: bf16 or fp16; K1 and K6
    stage 2-byte cache elements); "plain" (`gpt2_decode_step`, the JAX
    package's XLA step, on the shards of a tensor-parallel tree its GSPMD
    decode) everywhere else: an f32 tree (quantized or not: the step the
    JAX pipeline takes on every backend but the TPU), float weights (with
    either cache), quantized weights past 24 rows, and on a tensor-parallel
    tree float or int4 weights, the int8 cache, more than 24 rows, tp other
    than 2, or a tree made without ``kernel``. The JAX package's D % 640 and
    S % 128 gates come from TPU memory tiling; the port's kernels mask
    ragged tiles."""
    gpt = params["gpt"]
    if gpt["ln_f"]["weight"].dtype not in STEP_DTYPES:
        return "plain"
    if is_tp(gpt):
        kernel = (gpt.get("kernel", False) and gpt["mesh"].tp == TP
                  and "q" in gpt["shards"][0][0]["attn"]["c_attn"])
        return "tp" if kernel and not kv_quant and batch <= MAX_ROWS else "plain"
    if is_quantized(gpt) and batch <= MAX_ROWS:
        return "fused"
    return "plain"


# called as check(args, hidden) after each fused step when set by the caller
StepCheck = Optional[Callable[[Dict, torch.Tensor], None]]


def decode_step(route: str, params: Params, x: torch.Tensor, dims: GPT2Dims, pos: int,
                kv: Dict[str, torch.Tensor], kv_valid: torch.Tensor,
                anc: Optional[torch.Tensor] = None, group: int = 1,
                check: StepCheck = None) -> torch.Tensor:
    """One token through the GPT-2 backbone by ``route``; returns (B, D)
    after ln_f. ``check`` sees every fused call's (K1's or K6's) arguments,
    with each layer's input under "layer_inputs", and its output (the smoke
    test holds the kernel against its plain twin there). The "tp" route runs
    K6 on the tree's mesh, then ln_f on rank 0's device; its ``kv_valid``
    and ``anc`` are `Replicated`."""
    if route in ("fused", "tp"):
        args = dict(params=params["gpt"], x=x, dims=dims, pos=pos, kv_cache=kv,
                    kv_valid=kv_valid, anc=anc, group=group,
                    layer_inputs=None if check is None else [])
        if route == "fused":
            h = fused_decode_step(**args)
        else:
            h = nn.layer_norm(params["gpt"]["ln_f"], fused_decode_step_tp(**args))
        if check is not None:
            check(args, h)
        return h
    return gpt2_decode_step(params["gpt"], x, dims, pos, kv, kv_valid)


# ---------------------------------------------------------------------------
# the sampling decode (num_beams=1)
# ---------------------------------------------------------------------------

def _min_len_mask(logits: torch.Tensor, stop: int, step: int,
                  min_new_tokens: int) -> torch.Tensor:
    """HF `MinNewTokensLengthLogitsProcessor`: the stop token is unreachable
    until ``min_new_tokens`` codes have been generated; ``step`` is the
    index of the token about to be sampled (0 = the first new token)."""
    if step >= min_new_tokens:
        return logits
    logits = logits.clone()
    logits[:, stop] = float("-inf")
    return logits


def _sample(generator: torch.Generator, logits: torch.Tensor, counts: torch.Tensor,
            sampling: SamplingConfig) -> torch.Tensor:
    return sample_logits(generator, logits, counts, temperature=sampling.temperature,
                         top_k=sampling.top_k, top_p=sampling.top_p,
                         repetition_penalty=sampling.repetition_penalty,
                         do_sample=sampling.do_sample,
                         typical_mass=sampling.typical_mass if sampling.typical_sampling
                         else None)


@dataclass
class DecodeState:
    """The sampling decode between steps; ``step`` is the index of the next
    token to sample (token 0 comes from the prefill's logits)."""
    step: int
    tokens: torch.Tensor        # (B, max_new_tokens) int64, stop-padded
    counts: torch.Tensor        # (B, V) int32 repetition counts
    kv: Dict[str, torch.Tensor]
    kv_valid: torch.Tensor      # (B, S) bool; on the "tp" route Replicated
    finished: torch.Tensor      # (B,) bool
    lengths: torch.Tensor       # (B,) int64: index of the first stop token
    route: str


def prefill_rows(params: Params, cfg: GPTConfig, dims: GPT2Dims, prefix_embeds: torch.Tensor,
                 prefix_mask: torch.Tensor, S: int, kv_quant: bool, dtype, repeat: int = 1,
                 collect_hiddens: bool = False):
    """Prefill [prefix][start_mel] of every row, ``repeat`` times each (a
    row's beams adjacent), into a cache of S slots. Returns (the cache,
    kv_valid (B * repeat, S), the hidden after ln_f (B * repeat, P + 1, D),
    the repetition counts (B * repeat, V) of HF's fake prefix ids: P ones
    and start_mel), with ``collect_hiddens`` then every block's input at the
    last position (L, B * repeat, D)."""
    B, P, _ = prefix_embeds.shape
    dev, R = prefix_embeds.device, B * repeat
    start = torch.full((R,), cfg.start_mel_token, device=dev)
    seq = torch.cat([prefix_embeds.to(dtype).repeat_interleave(repeat, dim=0),
                     _embed_mel_token(params, start, 0, dtype)[:, None]], dim=1)
    seq_mask = torch.cat([prefix_mask.bool().repeat_interleave(repeat, dim=0),
                          torch.ones((R, 1), dtype=torch.bool, device=dev)], dim=1)
    kv = init_kv_cache(dims, R, S, dtype=dtype, device=dev, quantized=kv_quant,
                       mesh=params["gpt"].get("mesh"))
    out = gpt2_prefill(params["gpt"], seq, dims, seq_mask, kv, collect_hiddens=collect_hiddens)
    kv_valid = torch.zeros((R, S), dtype=torch.bool, device=dev)
    kv_valid[:, :P + 1] = seq_mask
    counts = torch.zeros((R, cfg.number_mel_codes), dtype=torch.int32, device=dev)
    counts[:, 1] += P
    counts[:, cfg.start_mel_token] += 1
    return (kv, kv_valid, *out, counts) if collect_hiddens else (kv, kv_valid, out, counts)


def _prefill_state(params: Params, cfg: GPTConfig, dims: GPT2Dims,
                   prefix_embeds: torch.Tensor, prefix_mask: torch.Tensor,
                   generator: torch.Generator, max_new_tokens: int, span_end: int,
                   sampling: SamplingConfig, dtype) -> DecodeState:
    """Prefill [prefix][start_mel] into a cache sized for ``span_end``
    generated tokens, and sample token 0."""
    B, P, _ = prefix_embeds.shape
    dev, stop = prefix_embeds.device, cfg.stop_mel_token
    route = decode_route(params, B, sampling.kv_quant)
    kv, kv_valid, hidden, counts = prefill_rows(params, cfg, dims, prefix_embeds, prefix_mask,
                                                _cache_len(P, span_end), sampling.kv_quant,
                                                dtype)
    logits = _min_len_mask(mel_logits_from_hidden(params, hidden[:, -1]), stop, 0,
                           sampling.min_new_tokens)
    if route == "tp":
        kv_valid = Replicated.of(kv_valid, params["gpt"]["mesh"])
    tok = _sample(generator, logits, counts, sampling)
    tokens = torch.full((B, max_new_tokens), stop, dtype=torch.long, device=dev)
    tokens[:, 0] = tok
    counts[torch.arange(B, device=dev), tok] += 1
    finished = tok == stop
    lengths = torch.where(finished, 0, max_new_tokens)
    return DecodeState(1, tokens, counts, kv, kv_valid, finished, lengths, route)


def _decode_span_body(params: Params, cfg: GPTConfig, dims: GPT2Dims, st: DecodeState,
                      P: int, end: int, sampling: SamplingConfig, dtype,
                      generator: torch.Generator, step_check: StepCheck = None) -> None:
    """Steps ``st.step`` .. ``end - 1`` in place, or fewer once every row is
    done (read every ``_DONE_POLL`` steps). Each step is one
    `decode_step` on ``st.route``: K1 at ``group=1`` for quantized weights,
    K6 at ``group=1`` for the tensor-parallel tree."""
    stop = cfg.stop_mel_token
    rows = torch.arange(st.tokens.shape[0], device=st.tokens.device)
    while st.step < end:
        if st.step % _DONE_POLL == 0 and bool(st.finished.all()):
            break
        step = st.step
        # token i is embedded at mel position i + 2 (prev token i = step - 1)
        x = _embed_mel_token(params, st.tokens[:, step - 1], step + 1, dtype)
        pos = P + 1 + step
        st.kv_valid[:, pos] = True
        h = decode_step(st.route, params, x, dims, pos, st.kv, st.kv_valid, check=step_check)
        logits = _min_len_mask(mel_logits_from_hidden(params, h), stop, step,
                               sampling.min_new_tokens)
        tok = torch.where(st.finished, stop, _sample(generator, logits, st.counts, sampling))
        st.tokens[:, step] = tok
        st.counts[rows, tok] += (~st.finished).int()
        st.lengths = torch.where(~st.finished & (tok == stop), step, st.lengths)
        st.finished = st.finished | (tok == stop)
        st.step += 1


def _grow(st: DecodeState, S: int) -> None:
    """Pad every cache entry (values, and the int8 cache's scale rows; each
    shard's under tp) and ``kv_valid`` (each copy under tp) along S to ``S``
    slots."""
    def pad(buf: torch.Tensor, axis: int) -> torch.Tensor:
        shape = list(buf.shape)
        shape[axis] = S
        out = buf.new_zeros(shape)
        out.narrow(axis, 0, buf.shape[axis]).copy_(buf)
        return out
    st.kv = map_cache(st.kv, lambda buf: pad(buf, 2))
    st.kv_valid = st.kv_valid.map(lambda buf: pad(buf, 1)) \
        if isinstance(st.kv_valid, Replicated) else pad(st.kv_valid, 1)


@torch.no_grad()
def generate_adaptive(params: Params, cfg: GPTConfig, dims: GPT2Dims,
                      prefix_embeds: torch.Tensor, prefix_mask: torch.Tensor,
                      generator: torch.Generator, max_new_tokens: int,
                      sampling: SamplingConfig = SamplingConfig(num_beams=1),
                      dtype=torch.bfloat16, spans=(256, 512, 1024, 1536),
                      step_check: StepCheck = None) -> Tuple[torch.Tensor, np.ndarray]:
    """Sample mel codes with a growing KV cache. prefix_embeds (B, P, D)
    left-padded [pad][cond][text], prefix_mask (B, P) bool. Decodes in spans
    (those below ``max_new_tokens``, then ``max_new_tokens``): after each,
    one host read of the done flag decides whether the cache grows to the
    next span (`_grow`) and decoding goes on, so per-step attention reads
    track the tokens generated, not the budget. Token-identical to
    `generate` for the same generator. Returns (codes (B, max_new_tokens)
    on the device, stop-padded past each length; lengths (B,) numpy = the
    index of each row's first stop token). ``step_check`` is handed to
    every fused decode step (`decode_step`)."""
    global span_growths, last_route
    spans = tuple(s for s in spans if s < max_new_tokens) + (max_new_tokens,)
    P = prefix_embeds.shape[1]
    st = _prefill_state(params, cfg, dims, prefix_embeds, prefix_mask, generator,
                        max_new_tokens, spans[0], sampling, dtype)
    last_route = st.route
    _decode_span_body(params, cfg, dims, st, P, spans[0], sampling, dtype, generator,
                      step_check)
    for nxt in spans[1:]:
        if st.step >= max_new_tokens or bool(st.finished.all()):
            break
        _grow(st, _cache_len(P, nxt))
        span_growths += 1
        _decode_span_body(params, cfg, dims, st, P, nxt, sampling, dtype, generator,
                          step_check)
    return st.tokens, st.lengths.clamp(max=max_new_tokens).cpu().numpy()


def generate(params: Params, cfg: GPTConfig, dims: GPT2Dims, prefix_embeds: torch.Tensor,
             prefix_mask: torch.Tensor, generator: torch.Generator, max_new_tokens: int,
             sampling: SamplingConfig = SamplingConfig(num_beams=1), dtype=torch.bfloat16,
             step_check: StepCheck = None) -> Tuple[torch.Tensor, np.ndarray]:
    """`generate_adaptive` with the cache sized for ``max_new_tokens`` from
    the start (one span)."""
    return generate_adaptive(params, cfg, dims, prefix_embeds, prefix_mask, generator,
                             max_new_tokens, sampling, dtype, spans=(), step_check=step_check)
