"""UnifiedVoice v2, the autoregressive speech-token model (PyTorch counterpart
of `indextts_tpu/models/gpt/unified_voice.py`).

Token stream: [cond(32 latents) + emo_vec] [dur_half] [dur] [text] [mel].
Conditioning = conformer + perceiver over w2v-bert features; the emotion
vector = a smaller conformer + 1-latent perceiver -> emovec_layer ->
emo_layer, merged as base + alpha * (emo - base).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from indextts_tpu_torch import nn
from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.models.gpt.conformer import (ConformerDims, conformer_encode,
                                                     init_conformer)
from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims, gpt2_forward, init_gpt2
from indextts_tpu_torch.models.gpt.perceiver import (PerceiverDims, init_perceiver,
                                                     perceiver_resample)
from indextts_tpu_torch.nn import InitRng, Params


def make_dims(cfg: GPTConfig):
    cond, emo = cfg.condition_module, cfg.emo_condition_module

    def conformer(c):
        return ConformerDims(input_size=cfg.cond_input_dim, output_size=c.output_size,
                             attention_heads=c.attention_heads,
                             linear_units=c.linear_units, num_blocks=c.num_blocks,
                             input_layer=c.input_layer)

    return {
        "gpt": GPT2Dims(cfg.layers, cfg.model_dim, cfg.heads),
        "cond_conformer": conformer(cond),
        "cond_perceiver": PerceiverDims(
            dim=cfg.model_dim, dim_context=cond.output_size,
            num_latents=cfg.condition_num_latent, heads=cond.attention_heads,
            ff_mult=cond.perceiver_mult),
        "emo_conformer": conformer(emo),
        "emo_perceiver": PerceiverDims(
            dim=cfg.cond_input_dim, dim_context=emo.output_size, num_latents=1,
            heads=emo.attention_heads, ff_mult=emo.perceiver_mult),
    }


def init_unified_voice(rng: InitRng, cfg: GPTConfig) -> Params:
    dims = make_dims(cfg)
    D = cfg.model_dim
    return {
        "conditioning_encoder": init_conformer(rng, dims["cond_conformer"]),
        "perceiver_encoder": init_perceiver(rng, dims["cond_perceiver"]),
        "emo_conditioning_encoder": init_conformer(rng, dims["emo_conformer"]),
        "emo_perceiver_encoder": init_perceiver(rng, dims["emo_perceiver"]),
        "text_embedding": nn.embedding_init(rng, cfg.text_vocab_size, D),
        "mel_embedding": nn.embedding_init(rng, cfg.number_mel_codes, D),
        "text_pos_embedding": nn.embedding_init(rng, cfg.max_text_positions, D),
        "mel_pos_embedding": nn.embedding_init(rng, cfg.max_mel_positions, D),
        "emo_layer": nn.dense_init(rng, D, D),
        "emovec_layer": nn.dense_init(rng, cfg.cond_input_dim, D),
        "speed_emb": {"weight": rng.zeros((2, D))},
        "gpt": init_gpt2(rng, dims["gpt"]),
        "final_norm": nn.layer_norm_init(rng, D),
        "mel_head": nn.dense_init(rng, D, cfg.number_mel_codes),
        "text_head": nn.dense_init(rng, D, cfg.text_vocab_size),
    }


def _with_latent_mask(mask: torch.Tensor, n: int) -> torch.Tensor:
    ones = torch.ones((mask.shape[0], n), dtype=torch.bool, device=mask.device)
    return torch.cat([ones, mask], dim=1)


def get_conditioning(params: Params, cfg: GPTConfig, cond_emb: torch.Tensor,
                     cond_lens: torch.Tensor) -> torch.Tensor:
    """(B, T, 1024) w2v-bert features -> (B, 32, dim) speaker latents."""
    dims = make_dims(cfg)
    enc, mask = conformer_encode(params["conditioning_encoder"], dims["cond_conformer"],
                                 cond_emb, cond_lens)
    return perceiver_resample(params["perceiver_encoder"], dims["cond_perceiver"], enc,
                              _with_latent_mask(mask, cfg.condition_num_latent))


def get_emovec(params: Params, cfg: GPTConfig, emo_emb: torch.Tensor,
               emo_lens: torch.Tensor) -> torch.Tensor:
    """(B, T, 1024) -> (B, dim): perceiver -> emovec_layer -> emo_layer."""
    dims = make_dims(cfg)
    enc, mask = conformer_encode(params["emo_conditioning_encoder"], dims["emo_conformer"],
                                 emo_emb, emo_lens)
    v = perceiver_resample(params["emo_perceiver_encoder"], dims["emo_perceiver"], enc,
                           _with_latent_mask(mask, 1))[:, 0]
    return nn.dense(params["emo_layer"], nn.dense(params["emovec_layer"], v))


def merge_emovec(params: Params, cfg: GPTConfig, spk_emb: torch.Tensor,
                 emo_emb: torch.Tensor, spk_lens: torch.Tensor,
                 emo_lens: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """base + alpha * (emo - base)."""
    emo_vec = get_emovec(params, cfg, emo_emb, emo_lens)
    base_vec = get_emovec(params, cfg, spk_emb, spk_lens)
    return base_vec + alpha * (emo_vec - base_vec)


def build_conds_latent(params: Params, cond_latents: torch.Tensor,
                       emo_vec: torch.Tensor) -> torch.Tensor:
    """[cond + emo, dur_half, dur] prefix (B, 34, dim)."""
    B, _, D = cond_latents.shape
    speed = params["speed_emb"]["weight"].to(cond_latents.dtype)
    dur = speed[0][None, None].expand(B, 1, D)
    dur_half = speed[1][None, None].expand(B, 1, D)
    conds = cond_latents + emo_vec[:, None, :].to(cond_latents.dtype)
    return torch.cat([conds, dur_half, dur], dim=1)


def prepare_prefix_embeds(params: Params, cfg: GPTConfig, conds_latent: torch.Tensor,
                          text_ids: torch.Tensor, text_lens: torch.Tensor,
                          prefix_len: int, dtype=torch.float32
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-padded [pad][conds][start_text][text][stop_text] rows of static
    length ``prefix_len``: (embeds (B, prefix_len, D), mask (B, prefix_len))."""
    B, Lmax = text_ids.shape
    dev = text_ids.device
    n_cond = conds_latent.shape[1]
    total = Lmax + 2
    ar = torch.arange(total, device=dev)[None, :]
    ids = torch.full((B, total), cfg.stop_text_token, dtype=torch.long, device=dev)
    ids[:, 0] = cfg.start_text_token
    ids[:, 1:1 + Lmax] = text_ids.long()
    stop_pos = text_lens.long().to(dev) + 1
    ids = torch.where(ar == stop_pos[:, None], torch.full_like(ids, cfg.stop_text_token), ids)
    valid = ar <= stop_pos[:, None]
    text_emb = nn.embedding(params["text_embedding"], ids, dtype) \
        + params["text_pos_embedding"]["weight"][:total].to(dtype)[None]
    seq = torch.cat([conds_latent.to(dtype), text_emb], dim=1)
    seq_valid = torch.cat([torch.ones((B, n_cond), dtype=torch.bool, device=dev), valid], 1)
    shift = prefix_len - (n_cond + stop_pos + 1)
    idx = torch.arange(prefix_len, device=dev)[None, :] - shift[:, None]
    in_range = (idx >= 0) & (idx < seq.shape[1])
    idx = idx.clamp(0, seq.shape[1] - 1)
    embeds = torch.gather(seq, 1, idx[:, :, None].expand(-1, -1, seq.shape[2]))
    mask = torch.gather(seq_valid, 1, idx) & in_range
    return embeds * mask[:, :, None].to(dtype), mask


def forward_latents(params: Params, cfg: GPTConfig, cond_latents: torch.Tensor,
                    emo_vec: torch.Tensor, text_ids: torch.Tensor,
                    text_lens: torch.Tensor, mel_codes: torch.Tensor,
                    mel_lens: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Teacher-forced pass: final-norm hidden states over the mel span minus
    its last two positions, (B, T_mel, dim)."""
    return teacher_forced(params, cfg, build_conds_latent(params, cond_latents, emo_vec),
                          text_ids, text_lens, mel_codes, mel_lens, dtype)


def teacher_forced(params: Params, cfg: GPTConfig, conds: torch.Tensor,
                   text_ids: torch.Tensor, text_lens: torch.Tensor, mel_codes: torch.Tensor,
                   mel_lens: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The hidden states over the mel span of `_framed_pass` minus its last
    two positions, (B, T_mel, dim). v2 passes its conditioning prefix, v1
    its latents."""
    enc, text_in, _ = _framed_pass(params, cfg, conds, text_ids, text_lens, mel_codes,
                                   mel_lens, dtype)
    return enc[:, text_in.shape[1]:][:, :-2]


def _framed_pass(params: Params, cfg: GPTConfig, conds: torch.Tensor,
                 text_ids: torch.Tensor, text_lens: torch.Tensor, mel_codes: torch.Tensor,
                 mel_lens: torch.Tensor, dtype=torch.float32):
    """[conds][start_text][text][stop_text][start_mel][mel][stop_mel]
    through GPT-2 and the final norm. Ids past each row's length become the
    stop token. Returns (the final-norm hidden states after the conds, (B,
    Lt + 2 + Lm + 2, dim); the framed text ids; the framed mel ids)."""
    B = text_ids.shape[0]
    dev = text_ids.device

    def framed(ids, lens, start, stop):
        n = ids.shape[1]
        ids = torch.where(torch.arange(n, device=dev)[None, :] < lens.to(dev)[:, None],
                          ids.long(), torch.full_like(ids.long(), stop))
        return torch.cat([torch.full((B, 1), start, device=dev, dtype=torch.long), ids,
                          torch.full((B, 1), stop, device=dev, dtype=torch.long)], dim=1)

    text_in = framed(text_ids, text_lens, cfg.start_text_token, cfg.stop_text_token)
    mel_in = framed(mel_codes, mel_lens, cfg.start_mel_token, cfg.stop_mel_token)
    conds = conds.to(dtype)
    text_emb = nn.embedding(params["text_embedding"], text_in, dtype) \
        + params["text_pos_embedding"]["weight"][: text_in.shape[1]].to(dtype)[None]
    mel_emb = nn.embedding(params["mel_embedding"], mel_in, dtype) \
        + params["mel_pos_embedding"]["weight"][: mel_in.shape[1]].to(dtype)[None]
    emb = torch.cat([conds, text_emb, mel_emb], dim=1)
    hidden = gpt2_forward(params["gpt"], emb,
                          GPT2Dims(cfg.layers, cfg.model_dim, cfg.heads))
    return nn.layer_norm(params["final_norm"], hidden[:, conds.shape[1]:]), text_in, mel_in


def forward_logits(params: Params, cfg: GPTConfig, cond_latents: torch.Tensor,
                   emo_vec: torch.Tensor, text_ids: torch.Tensor, text_lens: torch.Tensor,
                   mel_codes: torch.Tensor, mel_lens: torch.Tensor, dtype=torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """The training forward: (text_logits (B, Lt + 2, text vocab),
    mel_logits (B, Lm + 2, mel codes), {"text_targets", "mel_targets"}),
    the inputs shifted by one with a stop token appended
    ([text][stop][stop], [mel][stop][stop])."""
    enc, text_in, mel_in = _framed_pass(params, cfg,
                                        build_conds_latent(params, cond_latents, emo_vec),
                                        text_ids, text_lens, mel_codes, mel_lens, dtype)
    lt = text_in.shape[1]
    text_logits = nn.dense(params["text_head"], enc[:, :lt])
    mel_logits = nn.dense(params["mel_head"], enc[:, lt:])

    def shifted(ids, stop):
        return torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], stop)], dim=1)

    return text_logits, mel_logits, {
        "text_targets": shifted(text_in, cfg.stop_text_token),
        "mel_targets": shifted(mel_in, cfg.stop_mel_token)}


def mel_logits_from_hidden(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """final_norm -> mel_head on top of the backbone's ln_f output."""
    return nn.dense(params["mel_head"], nn.layer_norm(params["final_norm"], hidden))
