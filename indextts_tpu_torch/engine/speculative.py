"""Speculative (prompt-lookup) decoding for one row (PyTorch counterpart of
`indextts_tpu/engine/speculative.py`), the JAX pipeline's default decode of a
segment run alone at ``num_beams=1``.

- draft: the last ``ngram`` generated codes are matched against the earlier
  history, and the ``gamma`` codes that followed the most recent match are
  proposed (`_lookup_draft`); ``forced`` reads them from ``draft_source``
  instead (oracle or adversarial drafts, for checks);
- verify: one `gpt2_chunk_step` over [previous token, draft] (gamma + 1
  tokens, one pass over the weights) gives the logits the sequential loop
  would compute at each position, provided the earlier drafts match. The
  sequential sampler is replayed position by position: the repetition counts
  grow by the committed tokens, the min-length mask goes by the absolute
  step, and each position draws from ``generator`` at the sequential loop's
  (1, V) shape. The first position whose token differs from its draft (or
  is the stop token) ends the run; its token is the correction, so n
  matches commit n + 1 tokens;
- fallback: without a draft, or where a chunk's gamma + 1 writes would cross
  the span's end, one `decode_step` on the decode route (K1 at group=1 for
  quantized weights, the plain step otherwise), exactly
  `engine/decode.py::_decode_span_body`'s step;
- self-gating (`generate_spec_adaptive`): `generate_adaptive`'s span ladder;
  at each span boundary the committed-per-chunk ratio is held against
  `spec_commit_ratio`, and below it the rest of the segment takes the plain
  span loop.

Tokens are the sequential sampler's: the replay samples every position of a
chunk (the stream of a torch generator cannot be split as a JAX key is), then
puts ``generator`` back to its state after the committed positions' draws, so
the stream stays aligned with `generate_adaptive`'s across rejected chunks,
span boundaries and the demotion. What differs is which program computes the
logits (a chunk's products against single steps'), float reassociation only:
token-equal on the CPU in f32.

The JAX engine drafts and accepts inside its device loop. Here the host
chooses each step, so it reads once a step or chunk: the committed token(s)
into a host copy of the row, where the draft lookup runs. The gamma clamp to
``max_new_tokens - 1`` is made once and the gate is computed from the
clamped gamma (the JAX engine computes it from the caller's).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.engine import decode
from indextts_tpu_torch.engine.decode import (DecodeState, SamplingConfig, StepCheck,
                                              _cache_len, _decode_span_body, _embed_mel_token,
                                              _grow, _min_len_mask, _prefill_state, _sample,
                                              decode_step)
from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims, gpt2_chunk_step
from indextts_tpu_torch.models.gpt.unified_voice import mel_logits_from_hidden
from indextts_tpu_torch.nn import Params
from indextts_tpu_torch.parallel.mesh import is_tp


def _lookup_draft(row: torch.Tensor, step: int, gamma: int,
                  ngram: int) -> Tuple[torch.Tensor, bool]:
    """Prompt-lookup draft over one row's codes, ``row`` (W,), of which
    [0, step) are generated. A start j matches when row[j:j+ngram] equals
    row[step-ngram:step] and its continuation row[j+ngram:j+ngram+gamma]
    lies inside the history; the most recent match wins. Returns (draft
    (gamma,), whether there is one)."""
    W = row.shape[0]
    iota = torch.arange(W, device=row.device)
    match = torch.ones(W, dtype=torch.bool, device=row.device)
    for o in range(ngram):
        shifted = row if o == 0 else torch.cat([row[o:], row.new_full((o,), -1)])
        match &= shifted == row[min(max(step - ngram + o, 0), W - 1)]
    ok = match & (iota <= step - ngram - gamma)
    jbest = int(torch.where(ok, iota, -1).max())
    start = min(max(jbest + ngram, 0), W - gamma)
    return row[start:start + gamma], jbest >= 0 and step >= ngram


def spec_commit_ratio(gamma: int) -> float:
    """The demotion gate, the JAX package's fit of a TPU A/B (a chunk
    verify of gamma drafts costs 1.62 + 0.045 gamma single steps there,
    `docs/KERNELS.md` §1): speculation goes on while the committed tokens a
    chunk exceed this. Tokens do not depend on it."""
    return 1.62 + 0.045 * gamma


def _single(params: Params, cfg: GPTConfig, dims: GPT2Dims, st: DecodeState, P: int,
            sampling: SamplingConfig, dtype, generator: torch.Generator,
            step_check: StepCheck) -> int:
    """One step on ``st.route`` (`_decode_span_body`'s), in place; returns
    the token (the step's host read)."""
    step, stop = st.step, cfg.stop_mel_token
    x = _embed_mel_token(params, st.tokens[:, step - 1], step + 1, dtype)
    pos = P + 1 + step
    st.kv_valid[:, pos] = True
    h = decode_step(st.route, params, x, dims, pos, st.kv, st.kv_valid, check=step_check)
    logits = _min_len_mask(mel_logits_from_hidden(params, h), stop, step,
                           sampling.min_new_tokens)
    tok = _sample(generator, logits, st.counts, sampling)
    st.tokens[:, step] = tok
    st.counts[0, tok] += 1
    t = int(tok)
    if t == stop:
        st.lengths.fill_(step)
        st.finished.fill_(True)
    st.step += 1
    return t


def _chunk(params: Params, cfg: GPTConfig, dims: GPT2Dims, st: DecodeState, P: int,
           sampling: SamplingConfig, dtype, generator: torch.Generator,
           prev: int, draft: Sequence[int]) -> Tuple[list, bool]:
    """Verify ``draft`` after the token ``prev`` with one chunk step and
    commit the matching prefix plus the correction token, in place. Returns
    the gamma + 1 values written to the row (the committed tokens, then stop
    tokens) and whether the last committed one is the stop token (the
    chunk's host read)."""
    step, stop, dev = st.step, cfg.stop_mel_token, st.tokens.device
    gamma = len(draft)
    G1 = gamma + 1
    ids = torch.tensor([prev, *draft], device=dev)
    x = params["mel_embedding"]["weight"].to(dtype)[ids] \
        + params["mel_pos_embedding"]["weight"][step + 1:step + 1 + G1].to(dtype)
    pos0 = P + 1 + step
    h = gpt2_chunk_step(params["gpt"], x[None], dims, pos0, st.kv, st.kv_valid)
    logits = mel_logits_from_hidden(params, h[0])                       # (G1, V)
    want = torch.tensor([*draft, -1], device=dev)
    counts = st.counts.clone()
    alive = torch.ones((1,), dtype=torch.bool, device=dev)
    toks, states = [], []
    for j in range(G1):
        tok = _sample(generator, _min_len_mask(logits[j:j + 1], stop, step + j,
                                               sampling.min_new_tokens), counts, sampling)
        if sampling.do_sample:
            states.append(generator.get_state())
        counts[0, tok] += alive.int()
        alive &= (tok == want[j]) & (tok != stop)
        toks.append(tok)
    toks = torch.cat(toks)
    host = toks.tolist()
    n = next((j for j in range(gamma) if host[j] != draft[j] or host[j] == stop), gamma)
    m = n + 1
    if sampling.do_sample:
        generator.set_state(states[n])
    toks[m:] = stop
    st.tokens[0, step:step + G1] = toks
    st.counts = counts
    st.kv_valid[:, pos0:pos0 + m] = True
    if host[n] == stop:
        st.lengths.fill_(step + n)
        st.finished.fill_(True)
    st.step += m
    return host[:m] + [stop] * (G1 - m), host[n] == stop


def _spec_span_body(params: Params, cfg: GPTConfig, dims: GPT2Dims, st: DecodeState, P: int,
                    end: int, sampling: SamplingConfig, dtype, generator: torch.Generator,
                    gamma: int, ngram: int, draft_source: Optional[list], stats: list,
                    step_check: StepCheck = None) -> None:
    """Steps ``st.step`` .. ``end - 1`` (or until the stop token), chunk
    verifies where a draft is found and its gamma + 1 writes fit ``end``,
    single steps elsewhere; ``stats`` [chunk verifies, tokens committed by
    chunks, single steps] grows in place. ``draft_source`` (a list of
    max_new_tokens codes) replaces the lookup when given. The cache must
    hold ``end`` generated tokens."""
    stop, W = cfg.stop_mel_token, st.tokens.shape[1]
    row = st.tokens[0].cpu()                               # the span's host copy
    done = bool((row[:st.step] == stop).any())
    while st.step < end and not done:
        step = st.step
        if draft_source is not None:
            start = min(max(step, 0), W - gamma)
            draft, have = draft_source[start:start + gamma], True
        else:
            d, have = _lookup_draft(row, step, gamma, ngram)
            draft = d.tolist()
        if have and step + gamma + 1 <= end:
            vals, done = _chunk(params, cfg, dims, st, P, sampling, dtype, generator,
                                int(row[step - 1]), draft)
            row[step:step + len(vals)] = torch.tensor(vals)
            stats[0] += 1
            stats[1] += st.step - step
        else:
            t = _single(params, cfg, dims, st, P, sampling, dtype, generator, step_check)
            row[step] = t
            stats[2] += 1
            done = t == stop


@torch.no_grad()
def generate_spec_adaptive(params: Params, cfg: GPTConfig, dims: GPT2Dims,
                           prefix_embeds: torch.Tensor, prefix_mask: torch.Tensor,
                           generator: torch.Generator, max_new_tokens: int,
                           sampling: SamplingConfig = SamplingConfig(num_beams=1),
                           dtype=torch.bfloat16, gamma: int = 8, ngram: int = 2,
                           spans=(256, 512, 1024, 1536), commit_ratio: Optional[float] = None,
                           forced: bool = False, draft_source=None,
                           step_check: StepCheck = None
                           ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Self-gating speculative decode of one row with a growing KV cache:
    `generate_adaptive`'s spans (the first is the acceptance probe), and at
    each boundary, while speculating, a demotion to the plain span loop when
    the tokens committed a chunk fall below ``commit_ratio`` (default
    `spec_commit_ratio` of the clamped gamma) or no chunk fired. ``forced``
    takes the drafts from ``draft_source`` (max_new_tokens codes). Tokens
    equal `generate_adaptive`'s for the same generator state, up to the
    logits' float reassociation. Returns (codes (1, max_new_tokens) on the
    device, lengths (1,) numpy, stats (3,) numpy: [chunk verifies, tokens
    committed by chunks, single steps])."""
    if prefix_embeds.shape[0] != 1:
        raise ValueError("speculative decode is a one-row (single segment) path")
    if is_tp(params["gpt"]):
        raise NotImplementedError("speculative decode on the tensor-parallel tree is not "
                                  "ported (the JAX pipeline turns it off under a mesh)")
    spans = tuple(s for s in spans if s < max_new_tokens) + (max_new_tokens,)
    P = prefix_embeds.shape[1]
    st = _prefill_state(params, cfg, dims, prefix_embeds, prefix_mask, generator,
                        max_new_tokens, spans[0], sampling, dtype)
    decode.last_route = st.route
    stats = [0, 0, 0]
    if max_new_tokens >= 2:
        gamma = max(1, min(gamma, max_new_tokens - 1))
        ratio = spec_commit_ratio(gamma) if commit_ratio is None else commit_ratio
        source = None
        if forced:
            source = [int(t) for t in np.asarray(torch.as_tensor(draft_source).cpu())]
        args = (sampling, dtype, generator)
        _spec_span_body(params, cfg, dims, st, P, spans[0], *args, gamma, ngram, source, stats,
                        step_check)
        use_spec = True
        for nxt in spans[1:]:
            if st.step >= max_new_tokens or bool(st.finished.all()):
                break
            if use_spec and (stats[0] == 0 or stats[1] < ratio * stats[0]):
                use_spec = False
            _grow(st, _cache_len(P, nxt))
            decode.span_growths += 1
            if use_spec:
                _spec_span_body(params, cfg, dims, st, P, nxt, *args, gamma, ngram, source,
                                stats, step_check)
            else:
                _decode_span_body(params, cfg, dims, st, P, nxt, *args, step_check)
    return (st.tokens, st.lengths.clamp(max=max_new_tokens).cpu().numpy(),
            np.asarray(stats, np.int64))


def generate_spec(params: Params, cfg: GPTConfig, dims: GPT2Dims, prefix_embeds: torch.Tensor,
                  prefix_mask: torch.Tensor, generator: torch.Generator, max_new_tokens: int,
                  sampling: SamplingConfig = SamplingConfig(num_beams=1), dtype=torch.bfloat16,
                  gamma: int = 8, ngram: int = 2, forced: bool = False, draft_source=None,
                  step_check: StepCheck = None) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """`generate_spec_adaptive` with the cache sized for ``max_new_tokens``
    from the start (one span, so the gate never reads)."""
    return generate_spec_adaptive(params, cfg, dims, prefix_embeds, prefix_mask, generator,
                                  max_new_tokens, sampling, dtype, gamma, ngram, spans=(),
                                  forced=forced, draft_source=draft_source,
                                  step_check=step_check)
