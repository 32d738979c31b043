"""Beam search / beam sampling (PyTorch counterpart of
`indextts_tpu/engine/beam.py::generate_beam`), the decode of `IndexTTS2.infer`
with its default ``num_beams=3``, and diverse group beam search
(`generate_group_beam`, ``num_beam_groups`` > 1).

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
so a step makes no device->host copy. Whether every row is done is read
back once every ``_DONE_POLL`` steps: a done row is frozen (identity
reorder, stop token, unchanged scores and hypotheses), so the steps run
past the JAX loop's exit change nothing in the result.

How the cache follows the beams depends on the decode route
(`engine/decode.py::decode_route`), as in the JAX engine:
- float weights ("plain"): the K/V cache and ``kv_valid`` are gathered over
  the beam axis every step;
- int8 or int4 weights ("fused", kernel K1), and the tensor-parallel int8
  tree ("tp", kernel K6; the map and ``kv_valid`` are
  `parallel.mesh.Replicated`, a copy on each shard's device, since they
  index batch rows): the cache rows never move. An in-group
  ancestry map ``anc`` (B*K, S) int32 stays on the device: before each step
  ``anc[:, pos]`` is stamped with each row's own index (the row computes
  its k/v there), and after the scorer ``anc = anc[gidx]``, so row r's
  entry at position g lives in physical row (r // K) * K + anc[r, g]; the
  kernel reads it there. ``kv_valid`` rows are equal within a group (same
  prefix, lock-step writes) and are not gathered either.
With ``sampling.kv_quant`` the cache is the flat int8 one with its packed
scale rows "kvs", which K1 selects by the same ancestry (the gather route
reorders "kvs" with the values; under tp it reorders both shards' caches).
`last_use_anc` records which of the two the last call took, and
`kv_gathers` counts the cache gathers made.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.engine.decode import (_DONE_POLL, SamplingConfig, StepCheck,
                                              _cache_len, _embed_mel_token, decode_route,
                                              decode_step, prefill_rows)
from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims, map_cache
from indextts_tpu_torch.models.gpt.unified_voice import mel_logits_from_hidden
from indextts_tpu_torch.nn import Params
from indextts_tpu_torch.ops.sampling import (apply_repetition_penalty, apply_temperature,
                                             apply_top_k, apply_top_p)
from indextts_tpu_torch.parallel.mesh import Replicated

NEG = -1e9

# the cache-reorder route of the last `generate_beam` call (True: ancestry
# map, no cache gather) and the number of per-step cache gathers made
last_use_anc = None
kv_gathers = 0


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
                     sampling: SamplingConfig,
                     diversity: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, K, V) logits -> the combined, warped scores the candidates are
    drawn from (HF processor then warper order). ``diversity`` (B, V), the
    Hamming penalty of a beam group, is subtracted first, as HF's diversity
    processor precedes the repetition penalty."""
    lf = torch.log_softmax(logits.float(), dim=-1)
    if diversity is not None:
        lf = lf - diversity[:, None, :]
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


@torch.no_grad()
def generate_beam(params: Params, cfg: GPTConfig, dims: GPT2Dims,
                  prefix_embeds: torch.Tensor, prefix_mask: torch.Tensor,
                  generator: torch.Generator, max_new_tokens: int,
                  sampling: SamplingConfig = SamplingConfig(),
                  dtype=torch.bfloat16, step_check: StepCheck = None,
                  cache_gather: bool = False) -> Tuple[torch.Tensor, np.ndarray]:
    """Beam decode for B rows of K beams. prefix_embeds (B, P, D) left-padded,
    prefix_mask (B, P) bool. Returns (codes (B, max_new_tokens) on the
    device, stop-padded past each length; lengths (B,) numpy).
    ``step_check`` is handed to every fused decode step
    (`engine/decode.py::decode_step`). ``cache_gather`` reorders the cache
    by the per-step gather on the fused route too (the JAX engine's
    INDEXTTS_BEAM_ANC=0), for checks that the two routes agree."""
    return _beam_search(params, cfg, dims, prefix_embeds, prefix_mask, generator,
                        max_new_tokens, sampling, dtype, step_check, cache_gather, groups=1)


@torch.no_grad()
def generate_group_beam(params: Params, cfg: GPTConfig, dims: GPT2Dims,
                        prefix_embeds: torch.Tensor, prefix_mask: torch.Tensor,
                        generator: torch.Generator, max_new_tokens: int,
                        sampling: SamplingConfig = SamplingConfig(num_beam_groups=3),
                        dtype=torch.bfloat16, step_check: StepCheck = None,
                        cache_gather: bool = False) -> Tuple[torch.Tensor, np.ndarray]:
    """Diverse (group) beam search, HF `_group_beam_search` (the JAX
    package's `engine/beam.py::generate_group_beam`), `generate_beam`'s
    arguments and results: K = num_beams beams in G = num_beam_groups groups
    of Kg = K // G, greedy only. One decode step runs all B*K beams; the
    scorer then takes the groups one after another: group g's log-softmax
    scores lose ``diversity_penalty`` times the count of each token the
    groups before it chose this step, then a Kg-beam scorer step. A done
    group keeps adding its stop token to the later groups' counts, as in
    HF. The best hypothesis is pooled over every group of a row. Reorders
    never cross a group, so on the fused route K1 runs with the ancestry map
    at ``group=Kg``, and the gather route gathers within groups."""
    if sampling.num_beams % sampling.num_beam_groups or sampling.do_sample:
        raise ValueError("diverse beam search needs num_beams divisible by num_beam_groups "
                         "and do_sample=False")
    return _beam_search(params, cfg, dims, prefix_embeds, prefix_mask, generator,
                        max_new_tokens, sampling, dtype, step_check, cache_gather,
                        groups=sampling.num_beam_groups)


def _beam_search(params: Params, cfg: GPTConfig, dims: GPT2Dims, prefix_embeds: torch.Tensor,
                 prefix_mask: torch.Tensor, generator: torch.Generator, max_new_tokens: int,
                 sampling: SamplingConfig, dtype, step_check: StepCheck, cache_gather: bool,
                 groups: int) -> Tuple[torch.Tensor, np.ndarray]:
    """The beam engine over R = B * groups scorer rows of Kg = K // groups
    beams each (a prefix row's groups adjacent): `generate_beam` at one
    group, `generate_group_beam` at more."""
    global last_use_anc, kv_gathers
    K, G = sampling.num_beams, groups
    Kg = K // G
    B, P, _ = prefix_embeds.shape
    R, V, dev = B * G, cfg.number_mel_codes, prefix_embeds.device
    stop, L = cfg.stop_mel_token, max_new_tokens
    S = _cache_len(P, max_new_tokens)
    norm = _length_norm(sampling.length_penalty)
    route = decode_route(params, B * K, sampling.kv_quant)
    use_anc = route in ("fused", "tp") and Kg > 1 and not cache_gather
    last_use_anc = use_anc

    kv, kv_valid, hidden, counts = prefill_rows(params, cfg, dims, prefix_embeds, prefix_mask,
                                                S, sampling.kv_quant, dtype, repeat=K)
    logits = mel_logits_from_hidden(params, hidden[:, -1])
    counts = counts.reshape(R, Kg, V)
    beam_scores = torch.full((R, Kg), NEG, device=dev)     # slot 0 of every group starts
    beam_scores[:, 0] = 0.0
    tokens = torch.full((R, Kg, L), stop, dtype=torch.long, device=dev)
    hyp_scores = torch.full((R, Kg), float("-inf"), device=dev)
    hyp_tokens = torch.full((R, Kg, L), stop, dtype=torch.long, device=dev)
    hyp_lens = torch.zeros((R, Kg), dtype=torch.long, device=dev)
    done = torch.zeros((R,), dtype=torch.bool, device=dev)
    row_base = torch.arange(R, device=dev)[:, None] * Kg
    ones = torch.ones((R, Kg, 1), dtype=torch.int32, device=dev)
    own_idx = torch.arange(B * K, dtype=torch.int32, device=dev) % Kg
    anc = own_idx[:, None].repeat(1, S) if use_anc else None
    if route == "tp":
        mesh = params["gpt"]["mesh"]
        kv_valid, own_idx = Replicated.of(kv_valid, mesh), Replicated.of(own_idx, mesh)
        anc = None if anc is None else Replicated.of(anc, mesh)

    step = 0
    while True:
        # the groups one after another, each penalized by the tokens the
        # groups before it chose this step
        state = [t.reshape(B, G, *t.shape[1:]) for t in
                 (logits.reshape(R, Kg, V), counts, beam_scores, hyp_scores, hyp_tokens,
                  hyp_lens, tokens, done)]
        freq = torch.zeros((B, V), device=dev) if G > 1 else None
        outs = []
        for g in range(G):
            lg, cn, bs, hs, ht, hl, tk, gd = (t[:, g] for t in state)
            combined = beam_step_scores(lg, cn, bs, step, stop, sampling,
                                        sampling.diversity_penalty * freq if g else None)
            cb, ct, cs = _select_candidates(combined, Kg, sampling, generator)
            nb, nt, ns, hs, ht, hl = _scorer_process(cb, ct, cs, step, bs, hs, ht, hl, tk, gd,
                                                     stop=stop, norm=norm)
            outs.append((nb, nt, ns, hs, ht, hl, gd | _hyps_done(cs[:, 0], hs, step, norm=norm)))
            if freq is not None:
                freq.scatter_add_(1, nt, torch.ones_like(nt, dtype=freq.dtype))
        nb, nt, beam_scores, hyp_scores, hyp_tokens, hyp_lens, done = (
            torch.stack(t, 1).reshape(R, *t[0].shape[1:]) for t in zip(*outs))
        gidx = (row_base + nb).reshape(-1)
        tokens = tokens.reshape(B * K, L)[gidx].reshape(R, Kg, L)
        tokens[:, :, step] = nt
        counts = counts.reshape(B * K, V)[gidx].reshape(R, Kg, V)
        counts.scatter_add_(2, nt[:, :, None], ones)
        if use_anc:
            anc = anc[gidx]
        elif Kg > 1:
            kv = map_cache(kv, lambda buf: buf[:, gidx.to(buf.device)])
            kv_valid = kv_valid[gidx]
            kv_gathers += 1
        step += 1
        if step >= max_new_tokens or (step % _DONE_POLL == 0 and bool(done.all())):
            break
        # token i is embedded at mel position i + 2 (prev token i = step - 1)
        x = _embed_mel_token(params, nt.reshape(B * K), step + 1, dtype)
        pos = P + 1 + step
        kv_valid[:, pos] = True
        if use_anc:
            anc[:, pos] = own_idx
        h = decode_step(route, params, x, dims, pos, kv, kv_valid, anc, Kg if use_anc else 1,
                        step_check)
        logits = mel_logits_from_hidden(params, h)

    return _finalize(beam_scores, tokens, hyp_scores, hyp_tokens, hyp_lens, done, step, norm,
                     B, stop)


def _finalize(beam_scores, tokens, hyp_scores, hyp_tokens, hyp_lens, done, step: int, norm,
              B: int, stop: int) -> Tuple[torch.Tensor, np.ndarray]:
    """HF finalize over (R, k) beams in R scorer rows (a row, or a beam
    group): close the live beams of the rows not done, then the best
    hypothesis of each of the B prefix rows, pooled over its R / B scorer
    rows. Returns (codes (B, L), lengths (B,) numpy)."""
    L = tokens.shape[-1]
    final = norm(beam_scores, step - 1)
    for k in range(beam_scores.shape[1]):
        hyp_scores, hyp_tokens, hyp_lens = _add_hyps(hyp_scores, hyp_tokens, hyp_lens, ~done,
                                                     final[:, k], tokens[:, k], step)
    hyp_scores, hyp_lens = hyp_scores.reshape(B, -1), hyp_lens.reshape(B, -1)
    best = hyp_scores.argmax(1, keepdim=True)
    lens = hyp_lens.gather(1, best)
    best_tokens = hyp_tokens.reshape(B, -1, L).gather(1, best[:, :, None].expand(B, 1, L))[:, 0]
    codes = torch.where(torch.arange(L, device=tokens.device)[None, :] < lens, best_tokens,
                        torch.full_like(best_tokens, stop))
    return codes, lens[:, 0].cpu().numpy()
