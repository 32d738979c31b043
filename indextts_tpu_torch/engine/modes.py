"""The auxiliary HF generation modes (PyTorch counterpart of
`indextts_tpu/engine/modes.py`): contrastive search and DoLa decoding.

The reference reaches both through `inference_speech(**hf_generate_kwargs)`,
the JAX pipeline through its ``generation_kwargs``. Both run the plain decode
step (`gpt2_decode_step`) for every weight format, as the JAX modes run the
XLA step: contrastive search batches its top_k candidates against a
k-expanded cache, DoLa reads every layer's input. Greedy contracts
(``do_sample=False``) are held token-equal to the JAX functions.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.engine.decode import (SamplingConfig, _embed_mel_token, _min_len_mask,
                                              prefill_rows)
from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims, gpt2_decode_step, map_cache
from indextts_tpu_torch.models.gpt.unified_voice import mel_logits_from_hidden
from indextts_tpu_torch.nn import Params
from indextts_tpu_torch.ops.sampling import (apply_repetition_penalty, apply_temperature,
                                             apply_top_k, apply_top_p)

NEG = -1e9


@torch.no_grad()
def generate_contrastive(params: Params, cfg: GPTConfig, dims: GPT2Dims,
                         prefix_embeds: torch.Tensor, prefix_mask: torch.Tensor,
                         generator: torch.Generator, max_new_tokens: int,
                         sampling: SamplingConfig = SamplingConfig(num_beams=1, top_k=4,
                                                                   penalty_alpha=0.6),
                         dtype=torch.bfloat16, step_check=None) -> Tuple[torch.Tensor, np.ndarray]:
    """Contrastive search (HF `_contrastive_search`, low_memory=False). Each
    step, the top_k candidates of the current logits run one batched decode
    step against the k-expanded cache; each is scored (1 - alpha) p - alpha
    * its hidden's largest cosine with the earlier positions' last-layer
    hiddens (`_ranking_fast`, padding masked); the winner's cache rows,
    hidden and logits go on. A finished row keeps its trajectory (HF pads
    only input_ids), so the repetition counts see the stop token. Greedy;
    ``generator`` and ``step_check`` are unused. Returns (codes (B,
    max_new_tokens), lengths (B,) numpy) like `generate_adaptive`."""
    del generator, step_check
    B, P, D = prefix_embeds.shape
    V, k = cfg.number_mel_codes, sampling.top_k
    stop, dev = cfg.stop_mel_token, prefix_embeds.device
    S = P + 1 + max_new_tokens             # cache slots = hidden-context positions
    alpha = torch.tensor(sampling.penalty_alpha, device=dev)       # f32, as the JAX scalar
    kv, valid, hidden, counts = prefill_rows(params, cfg, dims, prefix_embeds, prefix_mask, S,
                                             sampling.kv_quant, dtype)
    logits = mel_logits_from_hidden(params, hidden[:, -1])
    # the k-expanded cache (HF's expansion: a row's candidates adjacent)
    kv = map_cache(kv, lambda buf: buf.repeat_interleave(k, dim=1))
    kv_valid = valid.repeat_interleave(k, dim=0)
    ctx_h = torch.zeros((B, S, D), device=dev)
    ctx_h[:, :P + 1] = hidden.float()
    ctx_v = valid.clone()
    tokens = torch.full((B, max_new_tokens), stop, dtype=torch.long, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    lengths = torch.full((B,), max_new_tokens, dtype=torch.long, device=dev)
    brange = torch.arange(B, device=dev)

    def unit(t):
        return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp(min=1e-12)

    for step in range(max_new_tokens):
        if step % 8 == 0 and bool(finished.all()):
            break
        proc = apply_repetition_penalty(logits.float(), counts, sampling.repetition_penalty)
        proc = _min_len_mask(proc, stop, step, sampling.min_new_tokens)
        tkp, tki = torch.topk(torch.softmax(proc, dim=-1), k, dim=-1)        # (B, k)
        # token index `step` sits at mel position step + 2, cache slot P + 1 + step
        x = _embed_mel_token(params, tki.reshape(B * k), step + 2, dtype)
        pos = P + 1 + step
        kv_valid[:, pos] = True
        h = gpt2_decode_step(params["gpt"], x, dims, pos, kv, kv_valid)
        logits_k = mel_logits_from_hidden(params, h).reshape(B, k, V)
        hk = h.reshape(B, k, D).float()
        sim = torch.einsum("bcd,bkd->bkc", unit(ctx_h), unit(hk))
        degen = torch.where(ctx_v[:, None, :], sim, NEG).amax(-1)           # (B, k)
        sel = ((1.0 - alpha) * tkp - alpha * degen).argmax(-1)
        tok = torch.where(finished, stop, tki[brange, sel])
        tokens[:, step] = tok
        counts[brange, tok] += 1
        gidx = (brange * k + sel).repeat_interleave(k)
        kv = map_cache(kv, lambda buf: buf[:, gidx.to(buf.device)])
        ctx_h[:, pos] = hk[brange, sel]
        ctx_v[:, pos] = True
        logits = logits_k[brange, sel]
        newly = ~finished & (tok == stop)
        lengths = torch.where(newly, step, lengths)
        finished = finished | newly
    tokens = torch.where(torch.arange(max_new_tokens, device=dev)[None, :] < lengths[:, None],
                         tokens, stop)
    return tokens, lengths.cpu().numpy()


def resolve_dola_layers(dola_layers, L: int) -> Tuple[int, ...]:
    """HF's candidate premature layers: hidden-state indices (0 = the
    embeddings, i = the input of block i). The reference's GPT-2 ties its
    word embeddings (HF's default), so "low" starts at 2 (1 for a two-layer
    model)."""
    start = 2 if L > 2 else (1 if L == 2 else 0)
    if dola_layers == "low":
        if start == L // 2:
            cands = [start]
        else:
            cands = list(range(start, L // 2, 2)) if L <= 40 else list(range(start, 20, 2))
    elif dola_layers == "high":
        cands = list(range(L // 2, L, 2)) if L <= 40 else list(range(L - 20, L, 2))
    elif isinstance(dola_layers, (list, tuple)):
        cands = [i for i in dola_layers if i < L]
    else:
        raise ValueError(f"dola_layers must be 'low', 'high' or a sequence of ints, "
                         f"got {dola_layers!r}")
    if not cands:
        raise ValueError(f"no DoLa candidate layers from {dola_layers!r}")
    return tuple(cands)


def _dola_contrast(cands: Tuple[int, ...], prem: torch.Tensor,
                   mature: torch.Tensor) -> torch.Tensor:
    """HF `_dola_select_contrast` + `_relative_top_filter`: the premature
    layer with the largest Jensen-Shannon divergence from the mature
    distribution (batch mean, one layer for the batch), then
    log_softmax(mature) - log_softmax(premature) with the plausibility
    constraint (tokens below 0.1 x the top mature probability go to -inf).
    prem (C, B, V) candidate logits, mature (B, V)."""
    mature, prem = mature.float(), prem.float()
    if len(cands) == 1:
        base = prem[0]
    else:
        avg = 0.5 * (torch.softmax(mature, -1)[None] + torch.softmax(prem, -1))
        a_log_a = torch.special.xlogy(avg, avg)        # 0 where avg == 0, as F.kl_div
        kl1 = (a_log_a - avg * torch.log_softmax(mature, -1)[None]).mean(-1)     # (C, B)
        kl2 = (a_log_a - avg * torch.log_softmax(prem, -1)).mean(-1)
        base = prem.index_select(0, (0.5 * (kl1 + kl2)).mean(-1).argmax().reshape(1))[0]
    sn = torch.log_softmax(mature, -1)
    bn = torch.log_softmax(base, -1)
    low = sn < sn.amax(-1, keepdim=True) + math.log(0.1)
    return torch.where(low, float("-inf"), sn) - torch.where(low, -1e-3, bn)


@torch.no_grad()
def generate_dola(params: Params, cfg: GPTConfig, dims: GPT2Dims, prefix_embeds: torch.Tensor,
                  prefix_mask: torch.Tensor, generator: torch.Generator, max_new_tokens: int,
                  sampling: SamplingConfig = SamplingConfig(num_beams=1, dola_layers="high"),
                  dtype=torch.bfloat16, step_check=None) -> Tuple[torch.Tensor, np.ndarray]:
    """DoLa decoding (HF `_dola_decoding`): each step contrasts the mature
    logits with the early exit (ln_f + mel head on a block's input) of the
    candidate layer of `_dola_contrast`, then the repetition penalty and,
    with ``do_sample``, temperature / top-k / top-p and a draw from
    ``generator``. ``sampling.dola_layers``: "low", "high" or hidden-state
    indices. ``step_check`` is unused. Returns (codes (B, max_new_tokens),
    lengths (B,) numpy)."""
    del step_check
    B, P, _ = prefix_embeds.shape
    stop, dev = cfg.stop_mel_token, prefix_embeds.device
    S = P + 1 + max_new_tokens
    cands = resolve_dola_layers(sampling.dola_layers, dims.layers)
    cidx = torch.tensor(cands, device=dev)
    kv, kv_valid, hidden, hs, counts = prefill_rows(params, cfg, dims, prefix_embeds,
                                                    prefix_mask, S, sampling.kv_quant, dtype,
                                                    collect_hiddens=True)
    brange = torch.arange(B, device=dev)

    def pick(mature, hs, step):
        logits = _dola_contrast(cands, mel_logits_from_hidden(params, hs[cidx]), mature)
        logits = apply_repetition_penalty(logits, counts, sampling.repetition_penalty)
        logits = _min_len_mask(logits, stop, step, sampling.min_new_tokens)
        if not sampling.do_sample:
            return logits.argmax(-1)
        w = apply_top_p(apply_top_k(apply_temperature(logits, sampling.temperature),
                                    sampling.top_k), sampling.top_p)
        return torch.multinomial(torch.softmax(w, -1), 1, generator=generator)[:, 0]

    tok = pick(mel_logits_from_hidden(params, hidden[:, -1]), hs, 0)
    tokens = torch.full((B, max_new_tokens), stop, dtype=torch.long, device=dev)
    tokens[:, 0] = tok
    counts[brange, tok] += 1
    finished = tok == stop
    lengths = torch.where(finished, 0, max_new_tokens)
    for step in range(1, max_new_tokens):
        if step % 8 == 0 and bool(finished.all()):
            break
        x = _embed_mel_token(params, tokens[:, step - 1], step + 1, dtype)
        pos = P + 1 + step
        kv_valid[:, pos] = True
        h, hs = gpt2_decode_step(params["gpt"], x, dims, pos, kv, kv_valid, collect_hiddens=True)
        tok = torch.where(finished, stop, pick(mel_logits_from_hidden(params, h), hs, step))
        tokens[:, step] = tok
        counts[brange, tok] += 1
        newly = ~finished & (tok == stop)
        lengths = torch.where(newly, step, lengths)
        finished = finished | newly
    tokens = torch.where(torch.arange(max_new_tokens, device=dev)[None, :] < lengths[:, None],
                         tokens, stop)
    return tokens, lengths.cpu().numpy()
