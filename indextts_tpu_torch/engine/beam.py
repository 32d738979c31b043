"""Beam search / beam sampling (PyTorch counterpart of
`indextts_tpu/engine/beam.py::generate_beam`), the decode of `IndexTTS2.infer`
with its default ``num_beams=3``.

HF `BeamSearchScorer` semantics (transformers 4.52, early_stopping=False),
per row of a left-padded (B, P, D) prefix batch:
- beam scores start [0, -inf, ...] so step one expands beam 0 only;
- per step: log_softmax -> repetition penalty -> min_new_tokens mask ->
  + beam score; sampling then warps (temperature, top-k, top-p), draws 2K
  Gumbel-top candidates and re-sorts them by score; greedy takes the top 2K;
- candidates in score order: an EOS among the top K closes a hypothesis
  (score / generated_len ** length_penalty), the first K others are the live
  beams; a row is done when its K hypothesis slots are full and the worst
  is no lower than the step's best candidate at the current length;
- at the end the live beams of unfinished rows are closed; the best
  hypothesis wins.

Everything runs on the device, the scorer included: `_scorer_process` and
`_hyps_done` are the JAX engine's functions as tensor ops over the B rows,
so a step makes no device->host copy. The K/V cache is reordered by a
gather over the beam axis every step (the JAX package's unquantized path;
its in-kernel ancestry map belongs to the fused int8 decode kernel, not
ported yet). Whether every row is done is read back once every
``_DONE_POLL`` steps: a done row is frozen (identity reorder, stop token,
unchanged scores and hypotheses), so the steps run past the JAX loop's exit
change nothing in the result.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from indextts_tpu.config import GPTConfig
from indextts_tpu_torch.engine.decode import SamplingConfig, _cache_len, _embed_mel_token
from indextts_tpu_torch.models.gpt.gpt2 import (GPT2Dims, gpt2_decode_step, gpt2_prefill,
                                                init_kv_cache)
from indextts_tpu_torch.models.gpt.unified_voice import mel_logits_from_hidden
from indextts_tpu_torch.nn import Params
from indextts_tpu_torch.ops.sampling import (apply_repetition_penalty, apply_temperature,
                                             apply_top_k, apply_top_p)

NEG = -1e9


def _length_norm(lp: float):
    """score / generated_len ** lp with generated_len = step + 1 (the closing
    EOS counts), in f32; the identity for lp == 0."""
    def norm(score: torch.Tensor, step: int) -> torch.Tensor:
        if lp == 0:
            return score
        return score / float(max(np.float32(step + 1) ** np.float32(lp), np.float32(1e-9)))
    return norm


def beam_step_scores(logits: torch.Tensor, counts: torch.Tensor,
                     beam_scores: torch.Tensor, step: int, stop: int,
                     sampling: SamplingConfig) -> torch.Tensor:
    """(B, K, V) logits -> the combined, warped scores the candidates are
    drawn from (HF processor then warper order)."""
    lf = torch.log_softmax(logits.float(), dim=-1)
    lf = apply_repetition_penalty(lf, counts, sampling.repetition_penalty)
    if step < sampling.min_new_tokens:
        lf = lf.clone()
        lf[..., stop] = float("-inf")
    combined = lf + beam_scores[..., None]
    if sampling.do_sample:
        combined = apply_temperature(combined, sampling.temperature)
        combined = apply_top_k(combined, sampling.top_k)
        combined = apply_top_p(combined, sampling.top_p)
    return combined


def _select_candidates(combined: torch.Tensor, K: int, sampling: SamplingConfig,
                       generator: torch.Generator):
    """(B, K, V) -> 2K (beam, token, score) per row, best first."""
    B, _, V = combined.shape
    flat = combined.reshape(B, K * V)
    if sampling.do_sample:
        u = torch.rand(flat.shape, generator=generator, device=flat.device)
        g = -torch.log(-torch.log(u.clamp(min=1e-20)))
        order_scores = torch.where(flat <= NEG / 2, torch.full_like(flat, NEG), flat + g)
        idx = torch.topk(order_scores, 2 * K, dim=-1).indices
        scores = torch.gather(flat, 1, idx)
        order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
        idx, scores = torch.gather(idx, 1, order), torch.gather(scores, 1, order)
    else:
        scores, idx = torch.topk(flat, 2 * K, dim=-1)
    return idx // V, idx % V, scores


def _add_hyps(hyp_scores, hyp_tokens, hyp_lens, take, score, seq, step: int):
    """Per row where ``take``: the (score, seq (B, L), step) hypothesis
    replaces the row's worst one if it scores higher."""
    K = hyp_scores.shape[1]
    worst = hyp_scores.argmin(1, keepdim=True)
    take = take & (score > hyp_scores.gather(1, worst)[:, 0])
    slot = (torch.arange(K, device=worst.device)[None, :] == worst) & take[:, None]
    return (torch.where(slot, score[:, None].expand_as(hyp_scores), hyp_scores),
            torch.where(slot[:, :, None], seq[:, None, :].expand_as(hyp_tokens), hyp_tokens),
            hyp_lens.masked_fill(slot, step))


def _scorer_process(cb, ct, cs, step: int, beam_scores, hyp_scores, hyp_tokens, hyp_lens,
                    tokens, done, *, stop: int, norm):
    """BeamSearchScorer.process for B rows over their 2K candidates (B, 2K),
    best first: EOS candidates of rank < K close hypotheses, the first K
    others become the live beams. Rows already ``done`` keep their
    hypotheses and get the identity reorder, the stop token and their old
    scores. Returns (parent beam, token, score) (B, K) and the hypotheses."""
    B, K = beam_scores.shape
    dev = cb.device
    ar_b, ar_k = torch.arange(B, device=dev), torch.arange(K, device=dev)
    is_eos = ct == stop
    for i in range(K):
        hyp_scores, hyp_tokens, hyp_lens = _add_hyps(
            hyp_scores, hyp_tokens, hyp_lens, is_eos[:, i] & ~done, norm(cs[:, i], step),
            tokens[ar_b, cb[:, i]], step)
    live = ~is_eos
    slot_of_cand = torch.where(live, live.cumsum(1) - 1, torch.full_like(cb, 2 * K))
    cand_of_slot = (slot_of_cand[:, None, :] == ar_k[None, :, None]).int().argmax(2)
    nb, nt, ns = (t.gather(1, cand_of_slot) for t in (cb, ct, cs))
    # fewer than K live candidates (degenerate): pad with the first one's beam
    valid = ar_k[None, :] < live.sum(1, keepdim=True)
    nb = torch.where(valid, nb, cb.gather(1, cand_of_slot[:, :1]))
    nt, ns = nt.masked_fill(~valid, stop), ns.masked_fill(~valid, NEG)
    d = done[:, None]
    nb = torch.where(d, ar_k[None, :].expand_as(nb), nb)
    return (nb, nt.masked_fill(d, stop), torch.where(d, beam_scores, ns),
            hyp_scores, hyp_tokens, hyp_lens)


def _hyps_done(cand_max, hyp_scores, step: int, *, norm):
    """BeamHypotheses.is_done (early_stopping=False): all K slots full and
    the worst no lower than the step's best candidate at the current length."""
    return (torch.isfinite(hyp_scores).all(1)
            & (hyp_scores.min(1).values >= norm(cand_max, step)))


# steps between two reads of the all-rows-done flag (the decode loop's only
# device->host copy)
_DONE_POLL = 8


@torch.no_grad()
def generate_beam(params: Params, cfg: GPTConfig, dims: GPT2Dims,
                  prefix_embeds: torch.Tensor, prefix_mask: torch.Tensor,
                  generator: torch.Generator, max_new_tokens: int,
                  sampling: SamplingConfig = SamplingConfig(),
                  dtype=torch.bfloat16) -> Tuple[torch.Tensor, np.ndarray]:
    """Beam decode for B rows of K beams. prefix_embeds (B, P, D) left-padded,
    prefix_mask (B, P) bool. Returns (codes (B, max_new_tokens) on the
    device, stop-padded past each length; lengths (B,) numpy)."""
    K = sampling.num_beams
    B, P, _ = prefix_embeds.shape
    V = cfg.number_mel_codes
    dev = prefix_embeds.device
    stop, L = cfg.stop_mel_token, max_new_tokens
    S = _cache_len(P, max_new_tokens)
    norm = _length_norm(sampling.length_penalty)

    pe = prefix_embeds.to(dtype).repeat_interleave(K, dim=0)
    pm = prefix_mask.bool().repeat_interleave(K, dim=0)
    start = torch.full((B * K,), cfg.start_mel_token, device=dev)
    seq = torch.cat([pe, _embed_mel_token(params, start, 0, dtype)[:, None]], dim=1)
    seq_mask = torch.cat([pm, torch.ones((B * K, 1), dtype=torch.bool, device=dev)], dim=1)
    kv = init_kv_cache(dims, B * K, S, dtype=dtype, device=dev)
    hidden = gpt2_prefill(params["gpt"], seq, dims, seq_mask, kv)
    logits = mel_logits_from_hidden(params, hidden[:, -1]).reshape(B, K, V)
    kv_valid = torch.zeros((B * K, S), dtype=torch.bool, device=dev)
    kv_valid[:, :P + 1] = seq_mask
    counts = torch.zeros((B, K, V), dtype=torch.int32, device=dev)
    counts[:, :, 1] += P
    counts[:, :, cfg.start_mel_token] += 1
    beam_scores = torch.full((B, K), NEG, device=dev)
    beam_scores[:, 0] = 0.0
    tokens = torch.full((B, K, L), stop, dtype=torch.long, device=dev)
    hyp_scores = torch.full((B, K), float("-inf"), device=dev)
    hyp_tokens = torch.full((B, K, L), stop, dtype=torch.long, device=dev)
    hyp_lens = torch.zeros((B, K), dtype=torch.long, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    row_base = torch.arange(B, device=dev)[:, None] * K
    ones = torch.ones((B, K, 1), dtype=torch.int32, device=dev)

    step = 0
    while True:
        combined = beam_step_scores(logits, counts, beam_scores, step, stop, sampling)
        cb, ct, cs = _select_candidates(combined, K, sampling, generator)
        nb, nt, beam_scores, hyp_scores, hyp_tokens, hyp_lens = _scorer_process(
            cb, ct, cs, step, beam_scores, hyp_scores, hyp_tokens, hyp_lens, tokens, done,
            stop=stop, norm=norm)
        gidx = (row_base + nb).reshape(-1)
        tokens = tokens.reshape(B * K, L)[gidx].reshape(B, K, L)
        tokens[:, :, step] = nt
        counts = counts.reshape(B * K, V)[gidx].reshape(B, K, V)
        counts.scatter_add_(2, nt[:, :, None], ones)
        if K > 1:
            kv = {name: buf[:, gidx] for name, buf in kv.items()}
            kv_valid = kv_valid[gidx]
        done = done | _hyps_done(cs[:, 0], hyp_scores, step, norm=norm)
        step += 1
        if step >= max_new_tokens or (step % _DONE_POLL == 0 and bool(done.all())):
            break
        # token i is embedded at mel position i + 2 (prev token i = step - 1)
        x = _embed_mel_token(params, nt.reshape(B * K), step + 1, dtype)
        pos = P + 1 + step
        kv_valid[:, pos] = True
        h = gpt2_decode_step(params["gpt"], x, dims, pos, kv, kv_valid)
        logits = mel_logits_from_hidden(params, h).reshape(B, K, V)

    # HF finalize: close the live beams of rows not done; the best hypothesis
    final = norm(beam_scores, step - 1)
    for k in range(K):
        hyp_scores, hyp_tokens, hyp_lens = _add_hyps(hyp_scores, hyp_tokens, hyp_lens, ~done,
                                                     final[:, k], tokens[:, k], step)
    best = hyp_scores.argmax(1, keepdim=True)
    lens = hyp_lens.gather(1, best)
    best_tokens = hyp_tokens.gather(1, best[:, :, None].expand(B, 1, L))[:, 0]
    codes = torch.where(torch.arange(L, device=dev)[None, :] < lens, best_tokens,
                        torch.full_like(best_tokens, stop))
    return codes, lens[:, 0].cpu().numpy()
