#!/usr/bin/env python3
"""Drive the PyTorch port (`indextts_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one card

1. Set-up: prints the card's name and power limit, builds the CUDA kernels
   from `indextts_tpu_torch/csrc` (one nvcc per source, in parallel, sm_90a).
2. Kernel phase: each hand-written kernel against its plain PyTorch twin on
   the same inputs at the main paths' shapes, with kernel, twin and (where
   one PyTorch call computes the same function) library times from CUDA
   events after warm-up, and each kernel's bound from the bytes and
   operations of this run's inputs:
   - K2 `attention_rope`, its rope pass (`rope_qk`, bit-identical to its
     twin) then K2''s attention kernel (rel-L2 <= 2e-2 over valid query rows;
     library: SDPA on pre-roped q and k, attention only) and K3 `antialias_snake`
     (rel-L2 <= 1e-3 over valid rows, and within 2 bf16 ulps on the 4 rows
     at each edge; timed by graph replay, the median [min-max] of 5 a shape,
     beside the eager CUDA-event time; its SFU and issue estimates printed);
   - K7a `int8_matvec` at the qkv, attn-proj, fc and mlp-proj shapes, M = 3,
     and at qkv, M = 1, and K7b `int8_mlp` at the MLP shape, M = 3 (rel-L2
     <= 1e-3; yardstick: F.linear with the bf16 weight the int8 one
     replaces). These and K1 are short launches: their kernel, twin and
     library times are device times, from CUDA events around the replay of a
     CUDA graph of 20 calls; K7a and the int4 GEMV, and F.linear beside them,
     are timed 5 times in turns (`timing_spread`: median and range, graph
     replay and eager);
   - K1 `fused_decode_step` (the persistent kernel, `csrc/decode_step.cu`:
     one launch a step) at L=24, D=1280, H=20, B*K=3, S=512, pos=300,
     staggered starts and a random ancestry map (hidden state rel-L2 <= 1e-2;
     written k/v rows of layer 0 within 1 bf16 ulp, of every layer rel-L2 <=
     1e-2), bit-identical to K1 on the physically gathered cache, and
     bit-identical to the chain of standalone kernels it replaced
     (`fused_decode_step_chain`: the hidden state, the whole cache after the
     step, every layer's input; two launches alike; `step_barriers` grid
     barriers), timed beside that chain in the same call (graph replay and
     eager) with its timeline (`step_timeline`: µs a layer in each phase
     and barrier); yardstick: the port's bf16 `gpt2_decode_step` at the
     same shape; and K1 at group=1 (one row, no ancestry map), the sampling
     decode's route; then (`k1_phase`) each variant (int8, KVQ, W4,
     int4kv) at group=3 and group=1, layer by layer against the twin and
     bit-identical to the chain at the K1 case, and bit-identical to the
     chain at pos=0, pos=1, S=2048 pos=1500 and 24 rows (`K1_EDGE_CASES`);
   - K1's attention alone (`decode_attention`, `decode_attention_phase`) at
     `DA_CASES`: the K1 case's layer (3 rows, the ancestry map, pos=300), 1
     row, the int8 cache, S=2048 at pos=1500, and the K1 case over 24
     layers' caches in turn (from HBM, as in a step): against its twin (rel-L2
     <= 1e-2), written rows bit-identical to the twin's, two launches
     bit-identical, the ancestry route bit-identical to the gathered cache,
     heads [0, 10) bit-identical to an H=10 call (K6's shard) and the
     output bit-identical under another launch plan; timed with
     `timing_spread` beside SDPA on the gathered bf16 cache (none for the
     int8 cache), with its bound from this run's valid positions;
   - K4 `single_block_attention` at the DiT flash tier's shape (B=2, H=8,
     D=64, T=1280, transposed (B, T, H, D) views) and at H=16 / D=32 and
     H=4 / D=128, and K2' `packed_pair_attention` at K2's shapes (rel-L2 <=
     2e-2; library: SDPA with the boolean key mask); K4 must refuse D=40;
   - the attention kernels (K2 at both T, K2', K4 at its three widths) and
     SDPA beside them are timed 5 times each, in turns, as device time (the
     replay of a CUDA graph of 20 calls) and eager (CUDA events around 10
     eager calls, host work included): the median and the min-max range of
     each, so the yardstick's spread is read in the same run; their
     `kernels` rows give the graph-replay medians as ``ms`` and
     ``library_ms``;
   - K5 `fused_antialias_activation` and K3' `antialias_activation_prefolded`
     (on the fold f = 128 // gcd(C, 128)) at K3's six shapes under both
     logscale values, with K3's gates and K3's timing. K2', K5 and K3' have
     no caller on the
     port's pipeline (the JAX package calls them from tests, tools and its
     unported stage-folded vocoder): their launches are this phase's.
3. bf16 pipeline pass: `IndexTTS2(cfg_path=None, device="cuda")` at the
   shipped widths with seeded random weights, a synthetic bpe.model and a 5 s
   prompt wav; two single-segment requests with the default generation
   kwargs (beam sampling, num_beams=3), decode pinned to 400 codes as the
   JAX bench pins it. Checks: finite wavs of int(codes * 1.72) * 256
   samples, K2 (and its rope pass) / K3 launch counts equal to what two
   requests must make,
   and, on a small input, every kernel call of the DiT and BigVGAN against
   its plain twin on the same inputs; then one more request whose CFM solve
   runs under `torch.profiler` (`profile_s2mel`: wall, device busy share,
   the attention kernels' device time), as the flash-tier request of the
   sampling pass does too.
4. int8 pipeline pass: the same with `quantization="int8"` (the serving
   configuration), two requests. Checks: the wavs as above; K1 launched once
   per decode step (399 a request) and none of the standalone GEMV or
   attention kernels; the bf16 decode step and the per-step K/V gather
   never ran (the ancestry route did). The first 8 K1 calls of the
   first request are also run through the twin on the same inputs, layer
   by layer (each layer's twin takes the kernel path's input of that layer):
   every layer's output and the hidden state after ln_f within rel-L2 1e-2,
   every layer's written k/v rows bit-identical to what the twin attention
   writes from the kernel's own qkv (`twin_by_layer`). The 24-layer chain of
   the twin alone is printed beside it, with the noise floor of that chain:
   the twin against itself with f64 instead of f32 sums (the random-weight
   decoder amplifies f32 summation-order noise to about 1e-2 over 24
   layers, so the end-to-end difference is reported, not gated).
   Then the checkpoint pass (`checkpoint_phase`): the int8 pass's seed-0
   weights written by `tools/torch_reference_ckpt.py` as the released
   model directory (config.yaml, gpt.pth, s2mel.pth under its 'net'
   wrapper, the codec and w2v-bert as safetensors, campplus, BigVGAN's
   config.json and bigvgan_generator.pt under its 'generator' wrapper with
   the weight norm unfolded, the w2v-bert statistics, the emotion and
   speaker matrices: about 6.9 GB of f32 under the temporary directory,
   whose free space is printed first and must hold it), then
   `IndexTTS2(cfg_path=<dir>/config.yaml, model_dir=<dir>,
   quantization="int8", allow_random_init=False)`: per family the file's
   bytes and the seconds to read, convert and place it, and the
   constructor's wall; every loaded leaf bit-identical to the random-weight
   model's (the writer nudges the few weight-norm elements whose fold would
   round to another bf16 value); one warm
   num_beams=3, do_sample=False request on each model with the generator
   reseeded alike: codes token-equal, the int16 wav within rel-L2 1e-3, the
   loaded request's launches exactly one int8 request's (K1 399), and its
   stage seconds beside the random-weight model's. The directory is
   deleted after the emotion-text pass.
4a. Emotion-text pass (`emo_text_phase`), on that directory: a Qwen3-0.6B
   classifier at the published widths (28 x 1024, 16 / 8 heads of 128,
   vocab 151936, tied; random weights from seed 0, ~1.19 GB of bf16
   model.safetensors) and a synthetic tokenizer.json covering its ids (the
   Qwen3 added tokens at their published ids) written at
   ``<dir>/qwen0.6bemo4-merge``; a bf16 `IndexTTS2` read from the
   directory. Printed: the classifier's load seconds (every leaf as
   written), the prompt's token count, the prefill ms, the greedy decode's
   steps and ms a step, its device busy share (`profile_busy`), the emotion
   dict. Held: the f32 prefill logits on the card against the host CPU
   (TF32 off), rel-L2 <= 1e-3, and the first 8 f32 greedy tokens equal (the
   bf16 logits against f32 printed). Then one `use_emo_text=True` request
   with an ``emo_text``, pinned to 400 codes (stage seconds, RTF; K2 / K3
   as one bf16 request), and the CLI: ``python -m indextts_tpu_torch.cli_v2
   synth --emotion-text ... --model-dir <dir>`` in a subprocess at its
   defaults (num_beams=3, up to 1500 codes): exit code 0 and the wav
   written.
5. Sampling pass (num_beams=1: the JAX pipeline's default for a segment
   decoded alone, the self-gating speculative decoder
   `engine/speculative.py::generate_spec_adaptive`, gamma 8), int8
   weights, two requests pinned to 400 codes (the cache grows once, from
   the 256-code span to 400): K1 once per single step and the chunk step
   once per verify (`last_spec_stats`), every K1 call at group=1 with no
   ancestry map, the first 8 twin-checked as in the int8 pass; the bf16
   step and the beam engine never run; one span growth. The
   second request runs with INDEXTTS_PACKED_ATTN=0, the DiT's flash tier:
   K4 once per DiT layer and CFG step (13 x 25), K2 never, a finite wav,
   then every K4 call of the DiT on a small input against its twin; its
   s2mel stage is printed beside the packed tier's.
6. Memory-knob passes, the same way as the int8 pass, one request each:
   `quantization="int8kv"` (int8 weights, the flat int8 KV cache: K1's KVQ
   variant), `"int4"` (nibble-packed int4 weights: K1's W4 variant, the
   int4 GEMVs) and `"int4kv"` (both), the first 8 K1 calls twin-checked
   (the written int8 rows and their scale rows bit-identical); exact launch
   counts per pass (K1 once a step, no standalone GEMV or attention launch).
   The kernel phase holds the int4 GEMV at the four K7a shapes and the MLP
   (rel-L2 <= 1e-3, yardstick F.linear on the bf16 weight), and K1-KVQ,
   K1-W4 and K1 int4kv at the K1 shape layer by layer against the twin, and
   bit-identical to the same kernel on the gathered cache (scale rows
   gathered too); yardsticks: the int8 K1 and the bf16 step.
7. tp pass: the tp=2 int8 serving decode (kernel K6) with both shards on
   this card, `IndexTTS2(quantization="int8", mesh=make_mesh(["cuda:0",
   "cuda:0"]))` under INDEXTTS_TP_DECODE=kernel: one num_beams=3 request
   (its first 8 K6 steps twin-checked layer by layer: every layer within
   rel-L2 1e-2, the two shards' residual streams bit-identical, the written
   k/v rows bit-identical to K1's qkv GEMV on the same input, per head
   slice) and one num_beams=1 request, exact launch counts (K6 once a decode
   step: one launch of the persistent kernel's TP variant, the exchange
   folded into it; no `tp_allreduce`, standalone GEMV or attention launch,
   K1 never), its gpt stage beside the int8 pass's, and a profiled tp
   decode. The kernel phase holds K6 at K1's shape (3 rows at group=3, and
   1 row) the same way, beside K1 on the same inputs, bit-identical to the
   chain it replaced (`fused_decode_step_tp_chain`) and timed beside it in
   the same call (graph replay and eager) with its timeline; then
   (`k6_phase`) at group=3 and group=1 layer by layer against the twin and
   bit-identical to the chain at the K1 case, pos=0, pos=1, S=2048 pos=1500
   and 24 rows; and `tp_allreduce` alone (the chain's exchange),
   bit-identical to its twin for either rank.
7a. Speculative passes (`spec_phase`), int8 then bf16, after a short
   warm-up request: one num_beams=1 request pinned to 400 codes with
   speculation on and one with INDEXTTS_SPEC_DECODE=0, each from the
   generator seeded 0 (stats, gpt stage, exact K1 / chunk / plain step
   counts, the tokens the two share before they first differ); a forced
   oracle decode of 200 codes (greedy, the sequential greedy decode's codes
   as drafts) beside that sequential decode; `gpt2_chunk_step` over 9
   tokens against 9 single steps at the decode's layout and at a
   contiguous one (`chunk_against_steps`: each position's hidden, and
   every layer on the chunk's own inputs within rel-L2 1e-2 of the plain
   step's, and of K1's at the contiguous layout) and the verify /
   single-step cost ratio beside the JAX gate `spec_commit_ratio(8)` =
   1.98 (a TPU fit); the int8 speculative decode's device busy share.
   Between them, the aux pass (`aux_phase`, int8): diverse beam search
   (num_beams=4, two groups: K1 at group=2 once a step), contrastive
   search (top_k=4, alpha 0.6) and DoLa ("high"), both on the plain step,
   one request each at 400 codes with exact launch counts. The kernel
   phase holds K1 at group=2 (4 rows, a random ancestry map) against its
   twin layer by layer and bit-identical to its chain, timed beside both
   (`k1_group2_phase`).
8. Decode profile, after the bf16, int8, int8kv, int4 and tp passes: one
   request's `generate_beam` (399 steps) timed unprofiled, then under
   `torch.profiler` (its window opens after a discarded warm-up step and
   closes after a pad of spin kernels, on which the records the profiler
   drops at a window's end then fall): the device's busy share (the union
   of the records' intervals over the wall: the tp pass runs two streams),
   kernel launches per step and the largest device consumers; the recorded
   launches of the port's kernels (K1 and K6: one `decode_step_kernel`
   record a step, no GEMV, attention or `tp_allreduce` record on their
   route) and of the scorer's top-k equal the counters of that run.

9. Streaming pass (`longform_phase`), int8: SENTENCE repeated until it
   splits into 8 segments at the default 120 tokens (x 36: seven of 115
   tokens and one of 23), three requests at the JAX bench's streaming
   settings (num_beams=1, 60 codes a segment, more_segment_before=8,
   stream_return=True): the time to the first yielded chunk (median of the
   last two printed), 16 chunks (each segment's wav, then its silence),
   exact launches of the last request (K1 once a single step of the
   segments' speculative decodes, the chunk step once a verify, K2 and K3
   8 single-segment requests' worth).
10. Long-form int8 pass, same model: first the batched synthesis
   (`IndexTTS2.codes_to_wav`) of the 8 segment rows at 400, 355, ..., 85
   codes (`ragged_synthesis`): each row sounds up to its own
   int(clen * 1.72) * 256 samples and is zero past them, and K2 at the
   CFM's first DiT call (16 rows) and K3 at the vocoder's first call of
   each stage shape (8 rows), each row at its own length, against their
   twins and timed (the `*_longform` rows). Then one num_beams=3 request
   of the long text, every segment pinned to 400 codes. The segments run
   as one batch: the wav is 8 x int(400 * 1.72) * 256 samples plus 7
   silences of 4410; K1 launched once per decode step of the one 24-row
   chunk (399, not 8 x 399), K2 and K3 as often as in one single-segment
   request (one CFM over a DiT batch of 16 rows, one BigVGAN call over 8
   rows), exact counts as in the int8 pass; its stage times and RTF. K1
   at two of its decode steps (24 rows, per-row left padding, the beam
   ancestry map) layer by layer against the twin and bit-identical to its
   chain (the twin's 24-layer chain printed beside its noise floor), timed
   at those inputs (`fused_decode_step_longform`).
11. Long-form bf16 pass: the same long text at bf16, num_beams=3, one
   request: a 24-row decode on the gather route (the bf16 step once a
   decode step, cache gathers), K2 and K3 as in one single-segment request.

12. IndexTTS-1.5 passes (`v1_phase`): `IndexTTS(cfg=IndexTTS1Config())`
   at the repository's default v1 widths (GPT 24 x 1280, 20 heads,
   conformer + perceiver conditioning on the 24 kHz 100-bin mel; BigVGAN v1
   1536 channels, rates 4.4.4.4 after the x4 feature upsampling, ECAPA
   512), random weights from seed 0, the constructor's default fp16, the
   same prompt and bpe.model: a warm-up and a measured request at the
   default kwargs (num_beams=3, the plain decode route), the decode pinned
   to 400 codes through the instance's `_sampling_from_kwargs` (the v1
   `infer` takes no min_new_tokens): every synthesized row finite, the wav
   400 x 1024 samples, exact launches (K3 73 times, the decode step 399, no
   other kernel), stage seconds, audio seconds and RTF; K3 at fp16 at the
   warm-up request's first call of each of its four stage shapes (B = 1,
   T 8192 .. 524288, C 768 .. 96, the 400-code lengths) against its twin
   with K3's gates in fp16 ulps, timed by graph replay (the
   `antialias_snake_v1_fp16` row); then a bf16 model (use_fp16=False, the
   CLI's default) and one `infer_fast` request over SENTENCE repeated into
   two buckets of segments, 120 codes a segment: a finite wav of the
   right length.
13. fp16 pass (`fp16_phase`): `IndexTTS2(use_fp16=True)`, what the port's
   webui builds for ``--fp16``: one num_beams=3 request at 400 codes with
   the generation kwargs of the webui's emotion-vector mode
   (`webui.build_infer_kwargs`), its stage times and RTF, exact launches
   (the plain step once a decode step) and K2 and K3 launched at fp16; one
   `codes_to_wav` on the DiT's flash tier (K4 at fp16, 325 launches); the
   request's codes and one noise through the fp16, bf16 and f32 models
   (seed 0): the mel and the wav of fp16 and of bf16 against f32, both
   finite, fp16's distance no larger than bf16's. The kernel phase holds
   K2, K2' and K4 at fp16 against their twins beside SDPA at fp16 (the
   `*_fp16` rows). K1 and K6 (`k1_phase`, `k6_phase`) are also held
   bit-identical with a 64-slot chunk that kv_valid does not mark inserted
   inside the valid run (they attend exactly the marked slots), and the
   speculative passes assert that speculation on and off share all 400
   tokens at int8 and at bf16.

14. training pass (`train_phase`), `python -m indextts_tpu_torch.train`'s
   `run` on the card: the shipped GPTConfig() and S2MelConfig() (956.8 M
   trainable parameters, seed 0, drawn on the card), 5 steps of B = 4 read
   from `.npz` batches (`--data-dir`; conditioning and emotion features
   250 x 1024, 64 text ids, 400 mel codes, a 688-frame DiT target with a
   172-frame prompt, cfm_cond 688 x 512, style 192), f32 with TF32 off:
   each step's losses, the median synchronized step time of steps 2-5 and
   the peak allocated memory beside the card; every loss finite and no
   kernel launched (the counters unchanged: the DiT trains on its dense
   tier). Then, at a reduced depth (GPT 2 layers, DiT depth 2, one
   conformer block each, the shipped widths, 444.3 M parameters, B = 1):
   one step on the card and the same step on the host CPU (loss within rel
   1e-4, every gradient leaf within rel-L2 1e-3, a leaf's gradient zero on
   one side only if on the other), and 3 steps, a save, a resume and 2
   more steps against 5 steps straight (atol 1e-6, rtol 1e-5; the
   bit-identical leaves counted), with the seconds to save and resume.
15. DVAE pass (`dvae_phase`): `init_dvae` at its published defaults (8192
   tokens, codebook 512, hidden 512, 2 layers, 3 res-blocks), drawn on the
   card, and a 5 s synthetic wav through mel, codes and reconstruction on
   the card and on the host CPU: the share of codes that agree (>= 0.99),
   the reconstruction's rel-L2 from the same codes, and the card's ms.

`tools/torch_tp_two_cards.py` runs K6 with its shards on two cards, on a
machine that has two.

Each phase prints its elapsed time since the kernel build. Prints
per-stage times and RTF beside the card, then (second to last line) one
JSON object describing the kernels, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero with its
traceback. Exits 2 without a result when CUDA is unavailable or the port's
package cannot be imported (e.g. run outside the repository).
"""

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

SENTENCE = ("the quick brown fox jumps over the lazy dog and runs into "
            "the forest . the dog runs over the lazy fox . ")
K2_TS = (1280, 2304)                       # prompt bucket + mel bucket
# K4's head widths: a 512-wide DiT at 8, 16 and 4 heads; the first is the
# shipped DiT's, the one the flash-tier request runs
K4_HEADS = ((8, 64), (16, 32), (4, 128))
MEL_FRAMES = 768                           # the 400-code mel bucket
K3_SHAPES = ((768, 4), (384, 16), (192, 32), (96, 64), (48, 128), (24, 256))
ATTN_REPS = 5                              # timings of each attention kernel and SDPA
K2_REL_L2 = 2e-2                           # the repo's packed_attn_rel_l2 gate
K3_REL_L2 = 1e-3                           # bf16 output rounding is ~2e-5 here
K7_REL_L2 = 1e-3                           # f32 sums in another order
# (name, M, N, K) of the GEMV rows: K1's four projections at M = 3, qkv at M = 1
GEMV_SHAPES = (("qkv", 3, 3 * 1280, 1280), ("attn-proj", 3, 1280, 1280),
               ("fc", 3, 4 * 1280, 1280), ("mlp-proj", 3, 1280, 4 * 1280),
               ("qkv", 1, 3 * 1280, 1280))
K1_REL_L2 = 1e-2                           # bf16 chain over 24 layers
EDGE_ROWS = 4                              # the halo a K3 output row reads: 3
K3_OPS_PER_ELEMENT = 56                    # 2x6-tap up, 2 snakes, 12-tap down
# the GPT decoder of the shipped config, and the K1 kernel-phase shape
K1_L, K1_D, K1_H, K1_ROWS, K1_S, K1_POS = 24, 1280, 20, 3, 512, 300
CHUNK_SLOTS = 64                           # K1's attention chunk: the rounding unit
# K1's attention alone (`decode_attention`): label -> (rows, group, int8
# cache, S, pos, layers); "long" is max_mel_tokens' reach; "k1 24 layers"
# times the K1 case over 24 layers' caches in turn, as a decode step reads
# them (94 MB, past the 50 MB L2: the others replay one layer from L2)
DA_CASES = {"k1": (3, 3, False, K1_S, K1_POS, 1), "group=1": (1, 1, False, K1_S, K1_POS, 1),
            "kvq": (3, 3, True, K1_S, K1_POS, 1), "long": (3, 3, False, 2048, 1500, 1),
            "k1 24 layers": (3, 3, False, K1_S, K1_POS, K1_L)}
BF16_REQUESTS, INT8_REQUESTS = 2, 2
# the num_beams=1 sampling pass (int8): a twin-checked request on the packed
# DiT tier, then one on the flash tier (INDEXTTS_PACKED_ATTN=0)
SAMPLING_REQUESTS = 2
DECODE_STEPS = 399                         # 400 codes: 399 steps after prefill
TWIN_CHECKED_STEPS = 8
# the memory-knob passes: quantization -> (requests, profiled)
QUANT_PASSES = {"int8kv": (1, True), "int4": (1, True), "int4kv": (1, False)}
# K1's variants in the kernel phase: name -> (int4 weights, int8 cache)
K1_VARIANTS = {"fused_decode_step_kvq": (False, True), "fused_decode_step_w4": (True, False),
               "fused_decode_step_w4_kvq": (True, True)}
# K1's bit-identity cases beside the K1 case: label -> (rows, S, pos)
K1_EDGE_CASES = {"pos=0": (K1_ROWS, K1_S, 0), "pos=1": (K1_ROWS, K1_S, 1),
                 "S=2048 pos=1500": (K1_ROWS, 2048, 1500), "24 rows": (24, K1_S, K1_POS)}
# the tp pass: both tp=2 shards on this card
TP_DEVICES = ("cuda:0", "cuda:0")
# the long-form passes: SENTENCE repeated until it splits into
# LONGFORM_SEGMENTS segments at the default 120 tokens (as many as the JAX
# bench's long text); the long-form int8 decode's K1 calls kept for the
# twin (0 = the first decode step); the silence between two segments
# (interval_silence=200 ms at 22.05 kHz)
LONGFORM_SEGMENTS = 8
LONGFORM_K1_CALLS = (0, 200)
# the long-form synthesis's code lengths, one a segment row: 400 down by 45
RAGGED_CODES = tuple(400 - 45 * b for b in range(LONGFORM_SEGMENTS))
SILENCE_SAMPLES = 4410
# the streaming first-audio pass: the JAX bench's streaming settings
STREAM_REQUESTS = 3
STREAM_KWARGS = dict(num_beams=1, max_mel_tokens=60, min_new_tokens=59, more_segment_before=8)
# the speculative pass: the JAX pipeline's gamma, the chunk step's last hidden
# against gamma + 1 single steps (K1's layer tolerance), and the aux pass's
# requests (int8): label -> generation kwargs
SPEC_GAMMA = 8
SPEC_CHUNK_REL_L2 = 1e-2
SPEC_ORACLE_CODES = 200                    # the forced oracle decode's depth
AUX_REQUESTS = {"diverse beam": dict(num_beams=4, num_beam_groups=2, diversity_penalty=1.0,
                                     do_sample=False),
                "contrastive": dict(num_beams=1, penalty_alpha=0.6, top_k=4, do_sample=False),
                "dola": dict(num_beams=1, dola_layers="high", do_sample=False)}
# the emotion-text pass: the classifier's input, its f32 card-vs-host
# logits gate and how many f32 greedy tokens must agree, the corpus the
# synthetic tokenizer learns its first merges from, and about the bytes of
# the Qwen3 directory it writes into the checkpoint pass's directory
EMO_TEXT = "今天终于见到了多年未见的老朋友，我高兴得说不出话来！"
QWEN_F32_REL_L2 = 1e-3
QWEN_CHECK_TOKENS = 8
QWEN_CORPUS = ('{"高兴": 0.9, "愤怒": 0.0, "悲伤": 0.1, "恐惧": 0.0, "反感": 0.0, "低落": 0.0, '
               '"惊讶": 0.3, "自然": 0.2}\n文本情感分类 ' + EMO_TEXT + " " + SENTENCE) * 8
QWEN_BYTES = 1.3e9
# H100 SXM datasheet peaks: HBM bytes/s, bf16 tensor-core
# and f32 FLOP/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12


def edge_err(out, ref, L: int) -> float:
    """K3 at the rows whose taps reach the replicated edges, [0, 4) and
    [L-4, L): the largest error over the larger of the two blocks' magnitudes
    in units of 2 ulps of out's type (2**-6 relative for bf16, 2**-9 for
    fp16): <= 1 passes."""
    import torch

    unit = 2 * torch.finfo(out.dtype).eps
    worst = 0.0
    for rows in (slice(0, EDGE_ROWS), slice(L - EDGE_ROWS, L)):
        o, r = out[rows].float(), ref[rows].float()
        worst = max(worst, ((o - r).abs().max()
                            / (unit * r.abs().max()).clamp_min(1e-30)).item())
    return worst


def ulp_err(out, ref) -> float:
    """Largest |out - ref| in bf16 ulps of |ref|, the ulp taken at no less
    than 1e-3 of ref's largest magnitude (a value the bias cancels to near
    zero keeps the absolute error of the f32 sum it came from): <= 1 passes."""
    o, r = out.float(), ref.float()
    mag = r.abs().clamp_min(1e-3 * r.abs().max().item()).clamp_min(1e-30)
    return ((o - r).abs() / 2.0 ** (mag.log2().floor() - 7)).max().item()


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters=10, warmup=2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20, replays=5) -> float:
    """Device time of one ``fn`` call: a CUDA graph of ``iters`` calls,
    replayed ``replays`` times between CUDA events (no host time inside)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def timing_spread(kernel, library, reps: int = ATTN_REPS) -> tuple:
    """``kernel`` and ``library`` timed in turns, ``reps`` times each, as
    device time (`graph_ms`) and eager (`time_ms`, host work included): for
    each, {"graph", "eager"} medians and {"graph_range", "eager_range"} (min,
    max), ms. A ``library`` of None (no PyTorch call computes the function)
    is not timed and gives None."""
    fns = [f for f in (kernel, library) if f is not None]
    runs = {f: {"graph": [], "eager": []} for f in fns}
    for _ in range(reps):
        for f in fns:
            runs[f]["graph"].append(graph_ms(f))
            runs[f]["eager"].append(time_ms(f))
    out = []
    for f in fns:
        r = {}
        for how, xs in runs[f].items():
            xs = sorted(xs)
            r[how], r[f"{how}_range"] = xs[len(xs) // 2], (xs[0], xs[-1])
        out.append(r)
    return tuple(out) + (None,) * (2 - len(out))


def spread_text(t) -> str:
    if t is None:
        return "none"
    return (f"graph {t['graph']:.4f} ms [{t['graph_range'][0]:.4f}-{t['graph_range'][1]:.4f}]"
            f" eager {t['eager']:.4f} ms [{t['eager_range'][0]:.4f}-{t['eager_range'][1]:.4f}]")


def spread_row(kt: dict, lt: dict, **extra) -> dict:
    """The result fields of an attention kernel timed by `timing_spread`:
    ``ms`` and ``library_ms`` are graph-replay medians; ``spread`` (the
    ranges, the eager times and ``extra``) goes into its ``kernels`` row as
    it is."""
    lib = {} if lt is None else {
        "library_ms_range": lt["graph_range"], "library_eager_ms": lt["eager"],
        "library_eager_ms_range": lt["eager_range"]}
    return {"ms": kt["graph"], "library_ms": None if lt is None else lt["graph"], "spread": {
        "ms_timing": f"graph replay, median of {ATTN_REPS}", "ms_range": kt["graph_range"],
        "eager_ms": kt["eager"], "eager_ms_range": kt["eager_range"], **lib, **extra}}


def gemv_shape_row(kt: dict, lt: dict, b: dict) -> dict:
    """A GEMV shape's entry in its ``kernels`` row: graph-replay medians
    and ranges of the kernel and F.linear, and the shape's bound."""
    return {"ms": kt["graph"], "ms_range": kt["graph_range"], "library_ms": lt["graph"],
            "library_ms_range": lt["graph_range"], "bound_ms": b["bound_ms"]}


def plan_text(M: int, N: int, K: int, w4: bool = False) -> str:
    """The GEMV kernel's launch plan for the shape (`ops/int8.py::gemv_plan`)."""
    from indextts_tpu_torch.nn import int4_halfspan
    from indextts_tpu_torch.ops.int8 import gemv_plan

    p = gemv_plan(M, N, K, int4_halfspan(K // 2) if w4 else 0)
    return (f"{-(-N // (16 * p.rows)) * p.split} blocks of {p.rows} 16-row tile(s), split "
            f"{p.split} x {p.span} columns, {p.smem} B shared")


def build_lines(log: str, kernel: str) -> list:
    """ptxas's lines (registers, shared memory, spills) for every
    instantiation of ``kernel`` in the build log."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            keep = kernel in line
        if keep:
            out.append(line.strip())
    return out


def rel_l2(a, b) -> float:
    import torch

    return (torch.linalg.norm((a - b).float()) / torch.linalg.norm(b.float())).item()


def bound(nbytes: float, ops: float, peak_ops: float) -> dict:
    """The least time for the work: the larger of bytes over the HBM rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def build_fake_assets(d: str) -> str:
    """A tiny bpe.model and a 5 s 16 kHz prompt wav (the JAX bench's assets)."""
    from indextts_tpu_torch.text import build_model_file

    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    words = ["▁THE", "▁QUICK", "▁BROWN", "▁FOX", "▁JUMPS", "▁OVER", "▁LAZY",
             "▁DOG", "▁AND", "▁RUNS", "▁INTO", "▁FOREST", "▁."]
    vocab = [w[:i] for w in words for i in range(2, len(w) + 1)] + ["▁", ".", "▁,"]
    seen, score = set(), -1.0
    for w in vocab:
        if w not in seen:
            seen.add(w)
            pieces.append((w, score, 1))
            score -= 1.0
    build_model_file(pieces, os.path.join(d, "bpe.model"))
    sr = 16000
    t = np.arange(5 * sr) / sr
    wav = 0.25 * np.sin(2 * np.pi * 170 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    wav += 0.02 * np.random.default_rng(0).standard_normal(len(t))
    path = os.path.join(d, "prompt.wav")
    with wave.open(path, "wb") as f:                    # 16-bit PCM, mono
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(np.round(np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())
    return path


def kernel_phase(card: str) -> dict:
    """K2 at `K2_TS` (its row from the first) and K3 at the six BigVGAN stage
    shapes, each against its twin (`k2_case`, `k3_sum`)."""
    import torch

    from indextts_tpu_torch.ops.rope import precompute_freqs_cis

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    k2 = []
    H, D = 8, 64
    for T in K2_TS:
        q, k, v = (torch.randn((2, T, H * D), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        lens = torch.tensor([T - 37, T // 2 + 5], device=dev, dtype=torch.int32)
        fc = torch.as_tensor(precompute_freqs_cis(T, D), device=dev)
        k2.append(k2_case(q, k, v, lens, fc, H, card, ""))
    k3 = k3_sum([k3_inputs(g, C, MEL_FRAMES * up, 700 * up) for C, up in K3_SHAPES], card, "")
    # the fp16 instantiation (IndexTTS2(use_fp16=True)) at the first shape
    T = K2_TS[0]
    q, k, v = (torch.randn((2, T, H * D), generator=g, device=dev).to(torch.float16)
               for _ in range(3))
    lens = torch.tensor([T - 37, T // 2 + 5], device=dev, dtype=torch.int32)
    fc = torch.as_tensor(precompute_freqs_cis(T, D), device=dev)
    k2_fp16 = k2_case(q, k, v, lens, fc, H, card, " fp16")
    return {"attention_rope": {**k2[0], "err": max(r["err"] for r in k2),
                               "abs": max(r["abs"] for r in k2)},
            "attention_rope_fp16": k2_fp16, "antialias_snake": k3}


def k2_case(q, k, v, lens, fc, H: int, card: str, where: str) -> dict:
    """K2 on one input against its twin over each row's valid query rows
    (rel-L2 <= 2e-2), its rope pass bit-identical to the twin's; timed
    beside the plain twin and SDPA on q and k roped beforehand (attention
    only); its bound from the lengths. ``where`` names the input."""
    import torch
    import torch.nn.functional as F

    from indextts_tpu_torch.ops.attn import (attention_rope, attention_rope_plain, rope_qk,
                                             rope_qk_plain)
    from indextts_tpu_torch.ops.rope import apply_rotary_emb_half

    B, T, HD = q.shape
    D = HD // H
    out, ref = attention_rope(q, k, v, lens, fc, H), attention_rope_plain(q, k, v, lens, fc, H)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype, (out.dtype, q.dtype)
    L = lens.tolist()
    err = max(rel_l2(out[b, :n], ref[b, :n]) for b, n in enumerate(L))
    mab = max((out[b, :n].float() - ref[b, :n].float()).abs().max().item()
              for b, n in enumerate(L))
    rope_equal = all(torch.equal(a, b) for a, b in zip(rope_qk(q, k, fc, H),
                                                        rope_qk_plain(q, k, fc, H)))
    pms = time_ms(lambda: attention_rope_plain(q, k, v, lens, fc, H))
    qr, kr = (apply_rotary_emb_half(t.reshape(B, T, H, D), fc).transpose(1, 2).contiguous()
              for t in (q, k))
    vh = v.reshape(B, T, H, D).transpose(1, 2).contiguous()
    key_ok = (torch.arange(T, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    kt, lt = timing_spread(lambda: attention_rope(q, k, v, lens, fc, H),
                           lambda: F.scaled_dot_product_attention(qr, kr, vh, attn_mask=key_ok))
    rope_ms = graph_ms(lambda: rope_qk(q, k, fc, H))
    # QK^T and PV over each row's valid keys for all T query rows
    b = bound(4 * B * T * HD * 2 + B * 4 + T * D * 4, sum(4 * HD * T * n for n in L),
              BF16_FLOPS)
    print(f"K2 attention_rope{where} B={B} H={H} D={D} T={T}: rel_l2 {err:.3e} max_abs "
          f"{mab:.3e} rope pass bit-identical {rope_equal}, kernel (rope pass + attention) "
          f"{spread_text(kt)} (rope pass alone graph {rope_ms:.4f} ms), plain {pms:.4f} ms, "
          f"SDPA (attention only) {spread_text(lt)}; medians and [min-max] of {ATTN_REPS}; "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]", flush=True)
    assert err <= K2_REL_L2 and np.isfinite(err), f"K2 rel-L2 {err} > {K2_REL_L2} at T={T}"
    assert rope_equal, "K2's rope pass differs from its twin"
    return dict(err=err, abs=mab, plain_ms=pms, **spread_row(kt, lt, rope_pass_ms=rope_ms), **b)


def k3_sum(cases, card: str, where: str) -> dict:
    """K3 on each (x, alpha, beta, lengths) of ``cases`` (log-scale alpha
    and beta) against its twin
    over each row's valid frames (rel-L2 <= 1e-3; the 4 rows at each edge
    within 2 ulps of x's type), timed by graph replay beside the plain twin; the
    row of the kernels line: times summed over the cases, the bound from
    their bytes and operations. ``where`` names the inputs."""
    import torch

    from indextts_tpu_torch.ops.snake import antialias_snake, antialias_snake_plain

    row, tot, tot_pms, nbytes, ops = {"err": 0.0, "abs": 0.0}, {}, 0.0, 0, 0
    for x, alpha, beta, lens in cases:
        B, T, C = x.shape
        out, ref = antialias_snake(x, alpha, beta, lens), antialias_snake_plain(x, alpha, beta,
                                                                                lens)
        torch.cuda.synchronize()
        L = lens.tolist()
        err = max(rel_l2(out[b, :n], ref[b, :n]) for b, n in enumerate(L))
        edge = max(edge_err(out[b], ref[b], n) for b, n in enumerate(L))
        mab = max((out[b, :n].float() - ref[b, :n].float()).abs().max().item()
                  for b, n in enumerate(L))
        kt = timing_spread(lambda: antialias_snake(x, alpha, beta, lens), None)[0]
        pms = time_ms(lambda: antialias_snake_plain(x, alpha, beta, lens))
        tot, tot_pms = add_spread(tot, kt), tot_pms + pms
        nbytes += 2 * B * T * C * 2 + 2 * C * 4
        ops += K3_OPS_PER_ELEMENT * B * T * C
        print(f"K3 antialias_snake{where} B={B} C={C} T={T} L={sorted(set(L))} "
              f"({k3_plan_text(B, T, C)}): rel_l2 {err:.3e} max_abs {mab:.3e} edge rows "
              f"{edge:.3f} of 2 ulps kernel {spread_text(kt)} plain {pms:.4f} ms [{card}]",
              flush=True)
        assert err <= K3_REL_L2 and np.isfinite(err), f"K3 rel-L2 {err} > {K3_REL_L2} at C={C}"
        assert edge <= 1.0, f"K3 edge rows off by {edge} x 2 ulps at C={C}"
        row["err"], row["abs"] = max(row["err"], err), max(row["abs"], mab)
    b = bound(nbytes, ops, F32_FLOPS)
    print(f"K3{where}, sum over the {len(cases)} stage shapes: kernel {spread_text(tot)} "
          f"(medians and [min-max] of {ATTN_REPS} a shape, summed) plain {tot_pms:.4f} ms bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {nbytes} B, {ops} f32 ops); "
          f"{k3_floor_text(ops // K3_OPS_PER_ELEMENT)} [{card}]", flush=True)
    row.update(ms=tot["graph"], plain_ms=tot_pms, library_ms=None,
               spread=k3_spread(tot, len(cases)), **b)
    return row


def k3_inputs(g, C: int, T: int, L: int, B: int = 1):
    """K3's inputs at one BigVGAN stage shape: x (B, T, C) bf16, SnakeBeta's
    log-scale alpha and beta (C,), lengths (B,) of L frames."""
    import torch

    dev = torch.device("cuda")
    x = (2 * torch.randn((B, T, C), generator=g, device=dev)).to(torch.bfloat16)
    alpha = 0.3 * torch.randn((C,), generator=g, device=dev)
    beta = 0.3 * torch.randn((C,), generator=g, device=dev)
    return x, alpha, beta, torch.full((B,), L, device=dev, dtype=torch.int32)


def k3_plan_text(B: int, T: int, C: int) -> str:
    from indextts_tpu_torch.ops.snake import SNAKE_VEC, snake_plan

    p = snake_plan(B, T, C)
    return (f"{p.blocks} blocks of {p.threads} threads, runs of {p.rows} rows x {SNAKE_VEC} "
            f"channels")


# K3's floors beside its byte bound, printed as estimates on its lines and
# kept out of the kernels line (neither is measured): its two sines an
# element on the SFUs (16 a clock an SM) and the issue of its instructions
# (4 warp instructions a clock an SM), on H100_SMS SMs at the clock that
# F32_FLOPS implies (128 f32 lanes an SM, 2 operations a lane a clock).
# K3_INSTR_PER_ELEMENT is a count by hand from the SASS of the kernel's
# interior loop, to be redone when the kernel changes: 53 an element and
# row step (42 floating-point: 12 FFMA for the two 6-tap phases, 2 x 9 for
# the snakes, 12 FFMA for the lowpass; 11 of addresses, branches, moves and
# conversions), times 21 / 16 for a 16-row run's halo.
H100_SMS = 132
SM_CLOCK_HZ = F32_FLOPS / (H100_SMS * 128 * 2)
K3_INSTR_PER_ELEMENT = 69


def k3_floors(elements: int) -> dict:
    """K3's SFU floor and issue estimate (ms) for ``elements`` outputs."""
    return {"sfu_ms": 2 * elements / (16 * H100_SMS * SM_CLOCK_HZ) * 1e3,
            "issue_ms": K3_INSTR_PER_ELEMENT * elements / (128 * H100_SMS * SM_CLOCK_HZ) * 1e3}


def k3_floor_text(elements: int) -> str:
    f = k3_floors(elements)
    return (f"estimates: SFU sine floor {f['sfu_ms']:.4f} ms, instruction issue {f['issue_ms']:.4f}"
            f" ms ({K3_INSTR_PER_ELEMENT} instructions an element, counted by hand from the "
            f"kernel's SASS; {SM_CLOCK_HZ / 1e9:.3f} GHz)")


def k3_spread(kt: dict, shapes: int = len(K3_SHAPES)) -> dict:
    """The ``spread`` of an anti-alias row: ``kt`` holds the `timing_spread`
    results of its ``shapes`` stage shapes, summed."""
    return {"ms_timing": f"graph replay, median of {ATTN_REPS} a shape, summed over the "
                         f"{shapes}",
            "ms_range": kt["graph_range"], "eager_ms": kt["eager"],
            "eager_ms_range": kt["eager_range"]}


def add_spread(tot: dict, t: dict) -> dict:
    """``tot`` plus one `timing_spread` result, key by key (an empty ``tot``
    starts the sum)."""
    if not tot:
        return dict(t)
    return {k: tuple(a + b for a, b in zip(tot[k], v)) if isinstance(v, tuple) else tot[k] + v
            for k, v in t.items()}


def attention_kernel_phase(card: str) -> dict:
    """K4 `single_block_attention` at the DiT flash tier's shape (B=2, H=8,
    D=64, the q, k, v the DiT hands over: transposed (B, T, H, D) views) and
    at H=16 / D=32 and H=4 / D=128, and K2' `packed_pair_attention` at K2's
    shapes, each against its twin (rel-L2 <= 2e-2 over valid query rows);
    library: SDPA with the boolean key mask. Then both at fp16 (the
    `IndexTTS2(use_fp16=True)` instantiations) at their first shapes, the
    same checks and timings (the fp16 dense peak equals the bf16 one). K4's
    wrapper must refuse a head width of 40. K2' has no pipeline caller (the
    JAX package calls it from tests and tools only): its launches are this
    phase's."""
    import torch
    import torch.nn.functional as F

    from indextts_tpu_torch.ops.attn import (packed_pair_attention, packed_pair_attention_plain,
                                             single_block_attention,
                                             single_block_attention_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    res = {name: {"err": 0.0, "abs": 0.0} for name in
           ("single_block_attention", "packed_pair_attention", "single_block_attention_fp16",
            "packed_pair_attention_fp16")}

    def k4(H, D, dt, row):
        T = K2_TS[0]
        lens = torch.tensor([T - 37, T // 2 + 5], device=dev, dtype=torch.int32)
        key_ok = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        q, k, v = (torch.randn((2, T, H, D), generator=g, device=dev).to(dt)
                   .transpose(1, 2) for _ in range(3))
        out = single_block_attention(q, k, v, lens)
        ref = single_block_attention_plain(q, k, v, lens)
        torch.cuda.synchronize()
        err = max(rel_l2(out[b, :, :L], ref[b, :, :L]) for b, L in enumerate(lens.tolist()))
        mab = max((out[b, :, :L].float() - ref[b, :, :L].float()).abs().max().item()
                  for b, L in enumerate(lens.tolist()))
        pms = time_ms(lambda: single_block_attention_plain(q, k, v, lens))
        kt, lt = timing_spread(lambda: single_block_attention(q, k, v, lens),
                               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=key_ok))
        b = bound(4 * 2 * T * H * D * 2 + 2 * 4,
                  sum(4 * H * D * T * L for L in lens.tolist()), BF16_FLOPS)
        print(f"K4 single_block_attention {str(dt)[6:]} B=2 H={H} D={D} T={T}: rel_l2 {err:.3e} "
              f"max_abs {mab:.3e} kernel {spread_text(kt)}, plain {pms:.4f} ms, SDPA "
              f"{spread_text(lt)}; medians and [min-max] of {ATTN_REPS}; bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]", flush=True)
        assert out.dtype == dt and err <= K2_REL_L2 and np.isfinite(err), \
            f"K4 {dt} rel-L2 {err} at D={D}"
        r = res[row]
        r["err"], r["abs"] = max(r["err"], err), max(r["abs"], mab)
        if (H, D) == K4_HEADS[0]:
            r.update(plain_ms=pms, **spread_row(kt, lt), **b)

    def k2p(T, dt, row):
        H, D = 8, 64
        q, k, v = (torch.randn((2, T, H * D), generator=g, device=dev).to(dt)
                   for _ in range(3))
        lens = torch.tensor([T - 37, T // 2 + 5], device=dev, dtype=torch.int32)
        out = packed_pair_attention(q, k, v, lens, H)
        ref = packed_pair_attention_plain(q, k, v, lens, H)
        torch.cuda.synchronize()
        err = max(rel_l2(out[b, :L], ref[b, :L]) for b, L in enumerate(lens.tolist()))
        mab = max((out[b, :L].float() - ref[b, :L].float()).abs().max().item()
                  for b, L in enumerate(lens.tolist()))
        pms = time_ms(lambda: packed_pair_attention_plain(q, k, v, lens, H))
        qh, kh, vh = (t.reshape(2, T, H, D).transpose(1, 2) for t in (q, k, v))
        key_ok = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        kt, lt = timing_spread(lambda: packed_pair_attention(q, k, v, lens, H),
                               lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                      attn_mask=key_ok))
        b = bound(4 * 2 * T * H * D * 2 + 2 * 4,
                  sum(4 * H * D * T * L for L in lens.tolist()), BF16_FLOPS)
        print(f"K2' packed_pair_attention {str(dt)[6:]} B=2 H={H} D={D} T={T}: rel_l2 {err:.3e} "
              f"max_abs {mab:.3e} kernel {spread_text(kt)}, plain {pms:.4f} ms, SDPA "
              f"{spread_text(lt)}; medians and [min-max] of {ATTN_REPS}; bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]", flush=True)
        assert out.dtype == dt and err <= K2_REL_L2 and np.isfinite(err), \
            f"K2' {dt} rel-L2 {err} at T={T}"
        r = res[row]
        r["err"], r["abs"] = max(r["err"], err), max(r["abs"], mab)
        if T == K2_TS[0]:
            r.update(plain_ms=pms, **spread_row(kt, lt), **b)

    for H, D in K4_HEADS:
        k4(H, D, torch.bfloat16, "single_block_attention")
    try:
        x40 = torch.zeros((1, 8, 64, 40), device=dev, dtype=torch.bfloat16)
        single_block_attention(x40, x40, x40, torch.tensor([5], device=dev))
    except ValueError as e:
        print(f"K4 refuses head width 40: {e}", flush=True)
    else:
        raise AssertionError("K4 took a head width of 40")
    try:
        x32 = torch.zeros((1, 8, 64, 64), device=dev, dtype=torch.float32)
        single_block_attention(x32, x32, x32, torch.tensor([5], device=dev))
    except ValueError as e:
        print(f"K4 refuses f32: {e}", flush=True)
    else:
        raise AssertionError("K4 took f32 operands")

    packed_pair_attention.launches = 0
    for T in K2_TS:
        k2p(T, torch.bfloat16, "packed_pair_attention")
    res["packed_pair_attention"]["launches"] = packed_pair_attention.launches
    k4(*K4_HEADS[0], torch.float16, "single_block_attention_fp16")
    k2p(K2_TS[0], torch.float16, "packed_pair_attention_fp16")
    res["packed_pair_attention_fp16"]["launches"] = (packed_pair_attention.launches
                                                     - res["packed_pair_attention"]["launches"])
    return res


def antialias_entries_phase(card: str) -> dict:
    """K5 `fused_antialias_activation` and K3' `antialias_activation_prefolded`
    (both on K3's hand-written kernel) at the six BigVGAN stage shapes with
    lengths, under both logscale values (linear-scale parameters positive),
    K3' on the (B, T/f, f*C) fold, f = 128 // gcd(C, 128), each against the
    plain twin with K3's gates (rel-L2 <= 1e-3, the 4 edge rows within 2
    bf16 ulps). Timed at logscale=True, summed over the six shapes like K3.
    Neither has a pipeline caller (K5: the JAX package's tests; K3': its
    stage-folded vocoder, which is not ported): their launches are this
    phase's."""
    import torch

    from indextts_tpu_torch.ops.snake import (antialias_activation_prefolded,
                                              antialias_snake_plain,
                                              fused_antialias_activation)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    names = ("fused_antialias_activation", "antialias_activation_prefolded")
    res = {n: {"err": 0.0, "abs": 0.0, "plain_ms": 0.0, "times": {}} for n in names}
    fused_antialias_activation.launches = antialias_activation_prefolded.launches = 0
    nbytes = ops = 0
    for C, up in K3_SHAPES:
        T, L = MEL_FRAMES * up, 700 * up
        f = 128 // math.gcd(C, 128)
        x, _, _, lens = k3_inputs(g, C, T, L)
        for logscale in (True, False):
            alpha = 0.3 * torch.randn((C,), generator=g, device=dev)
            beta = 0.3 * torch.randn((C,), generator=g, device=dev)
            if not logscale:
                alpha, beta = alpha.exp(), beta.exp()
            ref = antialias_snake_plain(x, alpha, beta, lens, logscale)
            outs = {names[0]: fused_antialias_activation(x, alpha, beta, lens, logscale),
                    names[1]: antialias_activation_prefolded(
                        x.view(1, T // f, f * C), alpha, beta, f, C, lens,
                        logscale).view(1, T, C)}
            torch.cuda.synchronize()
            for name, out in outs.items():
                err, edge = rel_l2(out[0, :L], ref[0, :L]), edge_err(out[0], ref[0], L)
                mab = (out[0, :L].float() - ref[0, :L].float()).abs().max().item()
                assert err <= K3_REL_L2 and np.isfinite(err), (name, C, logscale, err)
                assert edge <= 1.0, f"{name} edge rows off by {edge} x 2 ulps at C={C}"
                r = res[name]
                r["err"], r["abs"] = max(r["err"], err), max(r["abs"], mab)
                print(f"{name} B=1 C={C} T={T} L={L} f={f} logscale={logscale}: rel_l2 "
                      f"{err:.3e} max_abs {mab:.3e} edge rows {edge:.3f} of 2 ulps",
                      flush=True)
            if logscale:
                xf = x.view(1, T // f, f * C)
                for name, fn in ((names[0], lambda: fused_antialias_activation(
                        x, alpha, beta, lens)), (names[1], lambda: antialias_activation_prefolded(
                        xf, alpha, beta, f, C, lens))):
                    res[name]["times"] = add_spread(res[name]["times"],
                                                    timing_spread(fn, None)[0])
                pms = time_ms(lambda: antialias_snake_plain(x, alpha, beta, lens))
                for name in names:
                    res[name]["plain_ms"] += pms
        nbytes += 2 * T * C * 2 + 2 * C * 4
        ops += K3_OPS_PER_ELEMENT * T * C
    b = bound(nbytes, ops, F32_FLOPS)
    for name, fn in zip(names, (fused_antialias_activation, antialias_activation_prefolded)):
        r = res[name]
        tot = r.pop("times")
        r.update(ms=tot["graph"], library_ms=None, launches=fn.launches, **b,
                 spread=k3_spread(tot))
        print(f"{name} sum over the six stage shapes: kernel {spread_text(tot)} (medians and "
              f"[min-max] of {ATTN_REPS} a shape, summed) plain {r['plain_ms']:.4f} ms bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}); "
              f"{k3_floor_text(ops // K3_OPS_PER_ELEMENT)}; {fn.launches} launches in this "
              f"phase [{card}]", flush=True)
    return res


def _matvec_f64(x, q, *, ln=None, scale=None, bias=None, residual=None):
    """`int8_matvec_plain` with f64 sums: a second summation order."""
    import torch

    from indextts_tpu_torch.ops.int8 import layer_norm_bf16

    if ln is not None:
        x = layer_norm_bf16(x, *ln)
    acc = (x.double() @ q.double().t()).float()
    if scale is None:
        return acc
    v = (acc * scale + bias.float()).to(torch.bfloat16)
    return v if residual is None else residual + v


def _mlp_f64(x, w1q, s1, b1, w2q, *, ln=None, scale2=None, bias2=None, residual=None):
    from indextts_tpu_torch.ops.int8 import gelu_new_bf16

    h = gelu_new_bf16(_matvec_f64(x, w1q, ln=ln, scale=s1, bias=b1))
    return _matvec_f64(h, w2q, scale=scale2, bias=bias2, residual=residual)


def _f64_twins():
    from indextts_tpu_torch.nn import unpack_int4
    from indextts_tpu_torch.ops.decode_step import StepOps, decode_attention_plain

    def matvec4(x, q4, **kw):
        return _matvec_f64(x, unpack_int4(q4), **kw)

    def mlp4(x, w1, s1, b1, w2, **kw):
        return _mlp_f64(x, unpack_int4(w1), s1, b1, unpack_int4(w2), **kw)

    return StepOps(_matvec_f64, _mlp_f64, matvec4, mlp4, decode_attention_plain)


def int8_operands(g, M: int, K: int, N: int):
    import torch

    dev = torch.device("cuda")
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    w = 0.02 * torch.randn((N, K), generator=g, device=dev)
    scale = w.abs().amax(1) / 127.0
    q = torch.round(w / scale[:, None]).to(torch.int8)
    bias = (0.02 * torch.randn((N,), generator=g, device=dev)).to(torch.bfloat16)
    return x, q, scale, bias


def int4_operands(g, M: int, K: int, N: int):
    """x, an int4 weight (N, K/2) from seeded random bf16 values, its scale,
    a bias, and the bf16 weight the int4 one replaces (unpacked x scale)."""
    import torch

    from indextts_tpu_torch.nn import quantize_dense_int4, unpack_int4

    dev = torch.device("cuda")
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    p = quantize_dense_int4({"weight": 0.02 * torch.randn((N, K), generator=g, device=dev)})
    bias = (0.02 * torch.randn((N,), generator=g, device=dev)).to(torch.bfloat16)
    w_bf16 = (unpack_int4(p["q4"]).float() * p["scale"][:, None]).to(torch.bfloat16)
    return x, p["q4"], p["scale"], bias, w_bf16


def k1_case(g):
    """K1 at the shipped decoder's widths: int8 weights from seeded random
    bf16 ones, a (L, 3, 512, 1280) cache filled below pos 300, rows starting
    at 0, 41 and 97 (left padding), a random in-group ancestry map."""
    import torch

    from indextts_tpu_torch.models.gpt.gpt2 import GPT2Dims, init_gpt2, quantize_gpt2_int8
    from indextts_tpu_torch.nn import InitRng
    from indextts_tpu_torch.utils.jax_params import to_torch

    dev = torch.device("cuda")
    dims = GPT2Dims(K1_L, K1_D, K1_H)
    bf16_params = to_torch(init_gpt2(InitRng(0, dev), dims), dev, torch.bfloat16)
    params = quantize_gpt2_int8(bf16_params)
    shape = (K1_L, K1_ROWS, K1_S, K1_D)
    kv = [torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(2)]
    for t in kv:
        t[:, :, K1_POS:] = 0
    starts = [0, 41, 97]
    valid = torch.zeros((K1_ROWS, K1_S), dtype=torch.bool, device=dev)
    for r, s in enumerate(starts):
        valid[r, s:K1_POS + 1] = True
    x = torch.randn((K1_ROWS, K1_D), generator=g, device=dev).to(torch.bfloat16)
    anc = torch.randint(0, K1_ROWS, (K1_ROWS, K1_S), generator=g, device=dev,
                        dtype=torch.int32)
    return dims, bf16_params, params, kv, valid, x, anc, starts


def k1_bound(starts, params, M: int, S: int, L: int, D: int, H: int = K1_H,
             kvq: bool = False, pos: int = K1_POS) -> dict:
    """Bytes K1 must move at this run's inputs: every weight (int8, or int4
    packed two a byte), scale, bias and LayerNorm vector once, x in and out,
    kv_valid and the ancestry map, each row's valid cached k and v of every
    layer (bf16; or int8 plus the 2H bf16 scales of the position that the
    heads use), the new k/v rows written (the int8 cache: with their
    256-lane scale row); operations: two per weight value and row, plus the
    attention's products."""
    from indextts_tpu_torch.models.gpt.gpt2 import SCALE_LANES

    wbytes = sum(t.numel() * t.element_size() for lp in params["h"]
                 for grp in (lp["attn"], lp["mlp"]) for d in grp.values() for t in d.values())
    wbytes += sum(t.numel() * t.element_size() for lp in params["h"]
                  for ln in (lp["ln_1"], lp["ln_2"]) for t in ln.values())
    n_weights = sum(d["q"].numel() if "q" in d else 2 * d["q4"].numel() for lp in params["h"]
                    for d in (*lp["attn"].values(), *lp["mlp"].values()))
    cached = sum(pos - s for s in starts)
    per_pos, per_row = (2 * D + 2 * H * 2, 2 * D + SCALE_LANES * 2) if kvq else (4 * D, 4 * D)
    nbytes = (wbytes + 2 * M * D * 2 + M * S * (1 + 4)
              + L * cached * per_pos + L * M * per_row)
    ops = 2 * M * n_weights + L * 4 * (cached + M) * D
    return bound(nbytes, ops, BF16_FLOPS)


def k1_against_chain(params, x, dims, pos: int, base: dict, valid, anc, group: int) -> dict:
    """The persistent K1 (`fused_decode_step`, `csrc/decode_step.cu`) and
    the chain of standalone kernels it replaced (`fused_decode_step_chain`)
    on copies of one cache: whether the hidden state, the whole cache after
    the step (every written k/v row and scale row, and nothing else), and
    every layer's input are bit-identical; whether a second launch repeats
    the first; and whether the launch took `step_barriers` grid barriers
    (the barrier's count word)."""
    import torch

    from indextts_tpu_torch.ops.decode_step import (fused_decode_step, fused_decode_step_chain,
                                                    step_barrier, step_barriers)

    caches = [{k: t.clone() for k, t in base.items()} for _ in range(3)]
    count = step_barrier(x.device)
    before = int(count[1])
    lk, lc = [], []
    h = fused_decode_step(params, x, dims, pos, caches[0], valid, anc, group, layer_inputs=lk)
    torch.cuda.synchronize()
    barriers = int(count[1]) - before
    hc = fused_decode_step_chain(params, x, dims, pos, caches[1], valid, anc, group,
                                 layer_inputs=lc)
    h2 = fused_decode_step(params, x, dims, pos, caches[2], valid, anc, group)
    torch.cuda.synchronize()
    out = {"hidden": torch.equal(h, hc),
           "cache": all(torch.equal(caches[0][k], caches[1][k]) for k in base),
           "layers": len(lk) == len(lc) and all(map(torch.equal, lk, lc)),
           "again": torch.equal(h, h2) and all(torch.equal(caches[0][k], caches[2][k])
                                              for k in base),
           "barriers": barriers == step_barriers(len(params["h"]))}
    out["ok"] = all(out.values())
    return out


def k1_timing(params, x, dims, pos: int, cache: dict, valid, anc, group: int) -> dict:
    """The persistent K1 and, in the same call, the chain it replaced:
    device time by graph replay, and eager (CUDA events over the calls,
    host work included)."""
    from indextts_tpu_torch.ops.decode_step import fused_decode_step, fused_decode_step_chain

    def call(fn):
        return lambda: fn(params, x, dims, pos, cache, valid, anc, group)

    return {"ms": graph_ms(call(fused_decode_step)),
            "chain_ms": graph_ms(call(fused_decode_step_chain)),
            "eager_ms": time_ms(call(fused_decode_step), iters=20),
            "chain_eager_ms": time_ms(call(fused_decode_step_chain), iters=10)}


def timing_text(t: dict) -> str:
    return (f"persistent {t['ms']:.4f} ms (eager {t['eager_ms']:.4f}), the chain it replaced "
            f"{t['chain_ms']:.4f} ms (eager {t['chain_eager_ms']:.4f})")


def k1_edge_inputs(g, rows: int, S: int, pos: int):
    """A K1 case of ``rows`` rows at (S, pos): a random bf16 cache zero from
    pos, staggered starts, a random in-group ancestry map (groups of 3)."""
    import torch

    shape = (K1_L, rows, S, K1_D)
    kv = [torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16) for _ in range(2)]
    for t in kv:
        t[:, :, pos:] = 0
    valid = torch.zeros((rows, S), dtype=torch.bool, device="cuda")
    for r in range(rows):
        valid[r, (37 * r) % (pos + 1):pos + 1] = True
    x = torch.randn((rows, K1_D), generator=g, device="cuda").to(torch.bfloat16)
    anc = torch.randint(0, K1_ROWS, (rows, S), generator=g, device="cuda", dtype=torch.int32)
    return kv, valid, x, anc


def insert_invalid_chunk(cache: dict, valid, anc, g, at: int = 64, n: int = CHUNK_SLOTS):
    """A decode step's inputs with ``n`` slots inserted at slot ``at`` that
    kv_valid does not mark (random content, and a random ancestry map
    there), every later slot moved up by n (the last n slots, zero, are
    dropped); the caller moves pos up by n. ``cache`` is {name: (L, M, S,
    X)}, or a tp cache {"shards": [...]}. K1 and K6 attend exactly the
    marked slots, and the inserted chunk of a whole 64 positions keeps every
    other chunk's contents: the step's output must not change, bit for bit."""
    import torch

    S = valid.shape[1]

    def ins(t, axis, fill):
        return torch.cat([t.narrow(axis, 0, at), fill, t.narrow(axis, at, S - at - n)],
                         axis).contiguous()

    def fill(t):
        shape = t.shape[:2] + (n,) + t.shape[3:]
        if t.dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=g, device=t.device,
                                 dtype=torch.int8)
        return (30 * torch.randn(shape, generator=g, device=t.device)).to(t.dtype)

    if "shards" in cache:
        out = {"shards": [{k: ins(t, 2, fill(t)) for k, t in c.items()} for c in cache["shards"]]}
    else:
        out = {k: ins(t, 2, fill(t)) for k, t in cache.items()}
    M = valid.shape[0]
    v = ins(valid, 1, torch.zeros((M, n), dtype=torch.bool, device=valid.device))
    a = None if anc is None else ins(anc, 1, torch.randint(0, K1_ROWS, (M, n), generator=g,
                                                           device=anc.device,
                                                           dtype=torch.int32))
    return out, v, a


def k1_phase(card: str) -> dict:
    """The persistent K1 for each variant (int8, KVQ, W4, int4kv) at
    group=3 and group=1: at the K1 case layer by layer against the twin
    (`twin_by_layer`), bit-identical to the chain (`k1_against_chain`), and
    bit-identical with an invalid chunk inserted inside the valid run
    (`insert_invalid_chunk`: K1 attends exactly the kv_valid slots), then
    bit-identical to the chain at `K1_EDGE_CASES` (pos=0, pos=1, S=2048
    pos=1500, 24 rows). Returns the case count."""
    import torch

    from indextts_tpu_torch.models.gpt.gpt2 import kv_quantize_flat, quantize_gpt2_int4
    from indextts_tpu_torch.ops.decode_step import fused_decode_step

    g = torch.Generator(device="cuda").manual_seed(4)
    dims, bf16_params, params8, kv, valid, x, anc, _ = k1_case(g)
    params4 = quantize_gpt2_int4(bf16_params)
    del bf16_params
    variants = {"int8": (False, False), "kvq": (False, True), "w4": (True, False),
                "int4kv": (True, True)}

    def caches(kv_, kvq):
        if not kvq:
            return {"k": kv_[0], "v": kv_[1]}
        kq, vq, kvs = kv_quantize_flat(kv_[0], kv_[1], K1_H)
        return {"k": kq, "v": vq, "kvs": kvs}

    n = 0
    for name, (w4, kvq) in variants.items():
        params = params4 if w4 else params8
        base = caches(kv, kvq)
        for group in (K1_ROWS, 1):
            rows = slice(0, group)
            b = {k: t[:, rows].contiguous() for k, t in base.items()}
            v, a = valid[rows].contiguous(), (anc if group > 1 else None)
            args = dict(params=params, x=x[rows], dims=dims, pos=K1_POS,
                        kv_cache={k: t.clone() for k, t in b.items()}, kv_valid=v, anc=a,
                        group=group, layer_inputs=[])
            h = fused_decode_step(**args)
            torch.cuda.synchronize()
            tw = twin_by_layer(args, h)
            vs = k1_against_chain(params, x[rows], dims, K1_POS, b, v, a, group)
            ci, vi, ai = insert_invalid_chunk(b, v, a, g)
            inserted = torch.equal(h, fused_decode_step(params, x[rows], dims,
                                                        K1_POS + CHUNK_SLOTS, ci, vi, ai, group))
            del ci
            print(f"K1 {name} group={group} K1 case: twin layer by layer rel_l2 <= "
                  f"{tw['layer']:.3e}, hidden {tw['hidden']:.3e}, rows {tw['rows_exact']}; "
                  f"against the chain {vs}; an invalid chunk inserted inside the valid run "
                  f"changes nothing: {inserted} [{card}]", flush=True)
            assert tw["layer"] <= K1_REL_L2 and tw["hidden"] <= K1_REL_L2, (name, group, tw)
            assert tw["rows_exact"] and vs["ok"] and inserted, (name, group, tw, vs, inserted)
            n += 1
        for label, (rows, S, pos) in K1_EDGE_CASES.items():
            kv_e, valid_e, x_e, anc_e = k1_edge_inputs(g, rows, S, pos)
            base_e = caches(kv_e, kvq)
            del kv_e
            for group in (K1_ROWS, 1):
                vs = k1_against_chain(params, x_e, dims, pos, base_e, valid_e,
                                      anc_e if group > 1 else None, group)
                print(f"K1 {name} group={group} {label} ({rows} rows, S={S}, pos={pos}): "
                      f"against the chain {vs} [{card}]", flush=True)
                assert vs["ok"], (name, group, label, vs)
                n += 1
            del base_e
            torch.cuda.empty_cache()
    return n


def da_case(g, M: int, group: int, kvq: bool, S: int, pos: int, H: int = K1_H):
    """`decode_attention`'s inputs: a random qkv (M, 3 * 64H) of the current
    token, one layer of a (M, S, 64H) cache filled below ``pos`` (the int8
    cache and its scale rows when ``kvq``), rows starting at 0, 41 and 97
    (left padding), a random in-group ancestry map at ``group`` > 1."""
    import torch

    from indextts_tpu_torch.models.gpt.gpt2 import kv_quantize_flat

    dev, D = torch.device("cuda"), 64 * H
    qkv = torch.randn((M, 3 * D), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((M, S, D), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    k[:, pos:], v[:, pos:] = 0, 0
    starts = [0, 41, 97][:M]
    valid = torch.zeros((M, S), dtype=torch.bool, device=dev)
    for r, st in enumerate(starts):
        valid[r, st:pos + 1] = True
    anc = torch.randint(0, group, (M, S), generator=g, device=dev,
                        dtype=torch.int32) if group > 1 else None
    cache = dict(zip(("k", "v", "kvs"), kv_quantize_flat(k, v, H))) if kvq else {"k": k, "v": v}
    return qkv, cache, valid, anc, starts


def da_gathered(cache: dict, anc, group: int) -> dict:
    """The cache with each row's hypothesis gathered physically (anc)."""
    import torch

    M, S = cache["k"].shape[:2]
    dev = cache["k"].device
    rows = (torch.arange(M, device=dev)[:, None] // group) * group + anc.long()
    slot = torch.arange(S, device=dev)[None, :]
    return {k: t[rows, slot].contiguous() for k, t in cache.items()}


def da_bound(starts, M: int, S: int, pos: int, H: int, kvq: bool, anc: bool) -> dict:
    """Bytes `decode_attention` must move at these inputs: each row's valid
    cached k and v (bf16; or int8 plus the 2H bf16 scales a position's heads
    use), qkv in, the output, the new k/v rows written (the int8 cache: with
    their 256-lane scale row), kv_valid and the ancestry map's entries of the
    valid positions, each once; operations: 4 per cached or current value
    (q.k and p.v), on the CUDA cores (f32 sums)."""
    from indextts_tpu_torch.models.gpt.gpt2 import SCALE_LANES

    D, elt = 64 * H, 1 if kvq else 2
    cached = sum(pos - st for st in starts)
    nbytes = (cached * (2 * D * elt + (2 * H * 2 if kvq else 0)) + M * 3 * D * 2 + M * D * 2
              + M * 2 * D * elt + (M * SCALE_LANES * 2 if kvq else 0) + M * S
              + (cached * 4 if anc else 0))
    return bound(nbytes, 4 * D * (cached + M), F32_FLOPS)


def per_call(t, n: int):
    """A `timing_spread` result for calls of n launches, a launch's times."""
    if t is None:
        return None
    return {k: tuple(x / n for x in v) if isinstance(v, tuple) else v / n for k, v in t.items()}


def da_library(qkv, cache: dict, valid, anc, group: int, pos: int, H: int):
    """The yardstick: one `F.scaled_dot_product_attention` call on (M, H, 1,
    64) q against the physically gathered bf16 cache below ``pos`` plus the
    current token, with the key mask; the gather is done here, outside the
    timed call (as K2's yardstick takes pre-roped q and k)."""
    import torch
    import torch.nn.functional as F

    M, D = qkv.shape[0], qkv.shape[1] // 3
    kv = cache if anc is None else da_gathered(cache, anc, group)
    k, v = (torch.cat([kv[n][:, :pos], qkv[:, None, j * D:(j + 1) * D]], 1)
            .reshape(M, pos + 1, H, 64).transpose(1, 2).contiguous()
            for j, n in ((1, "k"), (2, "v")))
    q = qkv[:, :D].reshape(M, H, 1, 64).contiguous()
    mask = valid[:, None, None, :pos + 1].contiguous()
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def decode_attention_phase(card: str) -> dict:
    """K1's attention alone (`decode_attention`, `csrc/decode_attention.cu`)
    at `DA_CASES`: against its twin (rel-L2 <= 1e-2: the bf16 output of f32
    sums in another order), the cache rows written at pos bit-identical to
    the twin's, two launches bit-identical (output and cache), the ancestry
    route bit-identical to the same kernel on the physically gathered cache,
    heads [0, H/2) bit-identical to a call at H/2 heads on those heads'
    slices (K6's shard), and the output bit-identical under a plan of other
    heads a block (`attention_plan(heads=)`). Timed with `timing_spread`
    beside SDPA on the gathered bf16 cache (`da_library`; none for the int8
    cache); the twin by graph replay. Returns the ``kernels`` rows "decode_attention" (the K1
    case) and "decode_attention_kvq", each case's figures under "cases"."""
    import torch

    from indextts_tpu_torch.ops.decode_step import (attention_plan, decode_attention,
                                                    decode_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(7)
    H, cases = K1_H, {}
    for label, (M, group, kvq, S, pos, layers) in DA_CASES.items():
        qkv, base, valid, anc, starts = da_case(g, M, group, kvq, S, pos, H)
        more = [da_case(g, M, group, kvq, S, pos, H)[1] for _ in range(layers - 1)]

        def cache():
            return {k: t.clone() for k, t in base.items()}

        def run(c, q=qkv, heads=H, a=anc, grp=group, plan=None, vm=valid):
            return decode_attention(q, c["k"], c["v"], vm, pos, heads, a, grp, c.get("kvs"),
                                    plan)

        c0, c1, c2 = cache(), cache(), cache()
        out, again = run(c0), run(c1)
        ref = decode_attention_plain(qkv, c2["k"], c2["v"], valid, pos, H, anc, group,
                                     c2.get("kvs"))
        twice = torch.equal(out, again) and all(torch.equal(c0[k], c1[k]) for k in c0)
        rows = all(torch.equal(c0[k][:, pos], c2[k][:, pos]) for k in c0)
        gat_exact = True
        if anc is not None:
            # a gather route gathers kv_valid with the cache
            out_gat = run(da_gathered(base, anc, group), a=None, grp=1,
                          vm=da_gathered({"k": valid}, anc, group)["k"])
            gat_exact = torch.equal(out, out_gat)
        D, Dh = 64 * H, 64 * (H // 2)
        sub_qkv = torch.cat([qkv[:, j * D:j * D + Dh] for j in range(3)], 1).contiguous()
        sub = {k: t if k == "kvs" else t[..., :Dh] for k, t in cache().items()}
        heads_exact = torch.equal(run({k: t.contiguous() for k, t in sub.items()}, q=sub_qkv,
                                      heads=H // 2), out[:, :Dh])
        other = attention_plan(M, H, pos, kvq,
                               heads=2 if attention_plan(M, H, pos, kvq).heads == 1 else 1)
        plan_exact = torch.equal(run(cache(), plan=other), out)
        torch.cuda.synchronize()
        err, mab = rel_l2(out, ref), (out.float() - ref.float()).abs().max().item()
        c = cache()
        lib = None if kvq else [da_library(qkv, ci, valid, anc, group, pos, H)
                                for ci in [base] + more]
        kt, lt = (per_call(t, layers) for t in timing_spread(
            lambda: [run(ci) for ci in [c] + more], lib and (lambda: [f() for f in lib])))
        pms = graph_ms(lambda: decode_attention_plain(qkv, c["k"], c["v"], valid, pos, H, anc,
                                                      group, c.get("kvs")), iters=3, replays=2)
        b = da_bound(starts, M, S, pos, H, kvq, anc is not None)
        print(f"decode_attention {label}: M={M} group={group} {'int8' if kvq else 'bf16'} cache "
              f"S={S} pos={pos} H={H} starts={starts}, times a call over {layers} layer(s): "
              f"rel_l2 {err:.3e} max_abs {mab:.3e}; "
              f"written rows bit-identical to the twin's: {rows}; two launches bit-identical: "
              f"{twice}; ancestry bit-identical to the gathered cache: "
              f"{gat_exact if anc is not None else 'n/a'}; heads [0, {H // 2}) bit-identical "
              f"to an H={H // 2} call: {heads_exact}; another plan ({other.heads} heads a "
              f"block) bit-identical: {plan_exact}; kernel {spread_text(kt)}, plain (graph) "
              f"{pms:.4f} ms, SDPA on the gathered bf16 cache {spread_text(lt)}; medians and "
              f"[min-max] of {ATTN_REPS}; bound {b['bound_ms']:.5f} ms ({b['bound_by']}) "
              f"[{card}]", flush=True)
        assert err <= K1_REL_L2 and np.isfinite(err), f"decode_attention {label} rel-L2 {err}"
        assert rows and twice and gat_exact and heads_exact and plan_exact, (
            label, rows, twice, gat_exact, heads_exact, plan_exact)
        cases[label] = dict(err=err, abs=mab, plain_ms=pms, **spread_row(kt, lt), **b)
    summary = {k: {"ms": v["ms"], "ms_range": v["spread"]["ms_range"],
                   "library_ms": v["library_ms"], "bound_ms": v["bound_ms"]}
               for k, v in cases.items()}
    res = {}
    for name, label in (("decode_attention", "k1"), ("decode_attention_kvq", "kvq")):
        r = dict(cases[label])
        r["spread"] = {**r["spread"], "cases": summary}
        res[name] = r
    return res


def int8_kernel_phase(card: str) -> dict:
    """K7a, K7b and K1 against their twins at the int8 decode's shapes."""
    import torch
    import torch.nn.functional as F

    from indextts_tpu_torch.models.gpt.gpt2 import gpt2_decode_step
    from indextts_tpu_torch.ops.decode_step import (fused_decode_step, fused_decode_step_plain,
                                                    step_timeline)
    from indextts_tpu_torch.ops.int8 import (int8_matvec, int8_matvec_plain, int8_mlp,
                                             int8_mlp_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2)
    res = {}
    D, M = K1_D, K1_ROWS
    mv = {"err": 0.0, "abs": 0.0}
    shapes = {}
    for name, Mi, N, K in GEMV_SHAPES:
        x, q, scale, bias = int8_operands(g, Mi, K, N)
        out, ref = int8_matvec(x, q), int8_matvec_plain(x, q)
        ep = int8_matvec(x, q, scale=scale, bias=bias)
        ep_ref = int8_matvec_plain(x, q, scale=scale, bias=bias)
        torch.cuda.synchronize()
        err = max(rel_l2(out, ref), rel_l2(ep, ep_ref))
        mab = (out - ref).abs().max().item()
        w_bf16 = (q.float() * scale[:, None]).to(torch.bfloat16)
        kt, lt = timing_spread(lambda: int8_matvec(x, q), lambda: F.linear(x, w_bf16))
        pms = graph_ms(lambda: int8_matvec_plain(x, q))
        b = bound(N * K + Mi * K * 2 + Mi * N * 4, 2 * Mi * N * K, BF16_FLOPS)
        print(f"K7a int8_matvec {name} M={Mi} K={K} N={N} ({plan_text(Mi, N, K)}): rel_l2 "
              f"{err:.3e} max_abs {mab:.3e} device: kernel {spread_text(kt)}; F.linear(bf16 "
              f"weight) {spread_text(lt)}; plain {pms:.4f} ms; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}) [{card}]", flush=True)
        assert err <= K7_REL_L2 and np.isfinite(err), f"K7a rel-L2 {err} at {name}"
        mv["err"], mv["abs"] = max(mv["err"], err), max(mv["abs"], mab)
        shapes[f"{name} M={Mi}"] = gemv_shape_row(kt, lt, b)
        if name == "qkv" and Mi == M:
            mv.update(plain_ms=pms, **b, **spread_row(kt, lt, shapes=shapes))
    res["int8_matvec"] = mv

    x, w1, s1, b1 = int8_operands(g, M, D, 4 * D)
    _, w2, _, _ = int8_operands(g, M, 4 * D, D)
    out, ref = int8_mlp(x, w1, s1, b1, w2), int8_mlp_plain(x, w1, s1, b1, w2)
    torch.cuda.synchronize()
    err, mab = rel_l2(out, ref), (out - ref).abs().max().item()
    ms = graph_ms(lambda: int8_mlp(x, w1, s1, b1, w2))
    pms = graph_ms(lambda: int8_mlp_plain(x, w1, s1, b1, w2))
    eager = time_ms(lambda: int8_mlp(x, w1, s1, b1, w2), iters=50)
    b = bound(2 * 4 * D * D + 4 * D * (4 + 2) + M * D * (2 + 4), 4 * M * 4 * D * D, BF16_FLOPS)
    print(f"K7b int8_mlp M={M} D={D} F={4 * D}: rel_l2 {err:.3e} max_abs {mab:.3e}"
          f" device: kernel {ms:.4f} ms plain {pms:.4f} ms bound {b['bound_ms']:.4f} ms"
          f" ({b['bound_by']}); eager call {eager:.4f} ms [{card}]", flush=True)
    assert err <= K7_REL_L2 and np.isfinite(err), f"K7b rel-L2 {err}"
    res["int8_mlp"] = dict(err=err, abs=mab, ms=ms, plain_ms=pms, library_ms=None, **b)

    dims, bf16_params, params, kv, valid, x, anc, starts = k1_case(g)
    caches = [{"k": kv[0].clone(), "v": kv[1].clone()} for _ in range(3)]
    h = fused_decode_step(params, x, dims, K1_POS, caches[0], valid, anc, M)
    ref = fused_decode_step_plain(params, x, dims, K1_POS, caches[1], valid, anc, M)
    rows = (torch.arange(M, device=x.device)[:, None] // M) * M + anc.long()
    slot = torch.arange(K1_S, device=x.device)[None, :]
    gathered = {k: t[:, rows, slot].contiguous() for k, t in zip("kv", kv)}
    # a gather route gathers kv_valid with the cache
    h_gat = fused_decode_step(params, x, dims, K1_POS, gathered, valid[rows, slot].contiguous())
    torch.cuda.synchronize()
    err, mab = rel_l2(h, ref), (h.float() - ref.float()).abs().max().item()
    row_ulps = max(ulp_err(caches[0][k][0, :, K1_POS], caches[1][k][0, :, K1_POS]) for k in "kv")
    row_err = max(rel_l2(caches[0][k][:, :, K1_POS], caches[1][k][:, :, K1_POS]) for k in "kv")
    exact = torch.equal(h, h_gat) and all(
        torch.equal(caches[0][k][:, :, K1_POS], gathered[k][:, :, K1_POS]) for k in "kv")
    cache = caches[2]
    vs = k1_against_chain(params, x, dims, K1_POS, {"k": kv[0], "v": kv[1]}, valid, anc, M)
    t = k1_timing(params, x, dims, K1_POS, cache, valid, anc, M)
    pms = graph_ms(lambda: fused_decode_step_plain(params, x, dims, K1_POS, cache, valid, anc,
                                                   M), iters=3, replays=2)
    yms = graph_ms(lambda: gpt2_decode_step(bf16_params, x, dims, K1_POS, cache, valid),
                   iters=5, replays=2)
    timeline = step_timeline(params, x, dims, K1_POS, cache, valid, anc, M)
    b = k1_bound(starts, params, M, K1_S, K1_L, K1_D)
    print(f"K1 fused_decode_step L={K1_L} D={K1_D} H={K1_H} B*K={M} S={K1_S} pos={K1_POS} "
          f"starts={starts}: hidden rel_l2 {err:.3e} max_abs {mab:.3e}, k/v rows layer 0 "
          f"{row_ulps:.3f} ulps, all layers rel_l2 {row_err:.3e}, ancestry bit-identical to "
          f"the gathered cache: {exact}; against the chain {vs}; device: {timing_text(t)}, "
          f"plain {pms:.4f} ms, bf16 gpt2_decode_step (yardstick) {yms:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]", flush=True)
    print("K1 timeline, µs a layer (mean over blocks and layers; 'slowest': a phase's slowest "
          "block): " + ", ".join(f"{k} {v:.2f}" for k, v in timeline.items()), flush=True)
    assert err <= K1_REL_L2 and np.isfinite(err), f"K1 hidden rel-L2 {err}"
    assert row_ulps <= 1.0 and row_err <= K1_REL_L2, (row_ulps, row_err)
    assert exact, "K1 with the ancestry map differs from K1 on the gathered cache"
    assert vs["ok"], f"K1 against the chain: {vs}"
    assert gpt2_decode_step.calls > 0                       # the yardstick ran
    res["fused_decode_step"] = dict(err=err, abs=mab, plain_ms=pms, library_ms=None,
                                    bf16_step_ms=yms, timeline=timeline, **t, **b)

    # K1 at group=1, the sampling decode's route: one row, no ancestry map
    x1, valid1 = x[:1], valid[:1]
    c1 = [{k: t[:, :1].clone() for k, t in zip("kv", kv)} for _ in range(2)]
    h1 = fused_decode_step(params, x1, dims, K1_POS, c1[0], valid1)
    ref1 = fused_decode_step_plain(params, x1, dims, K1_POS, c1[1], valid1)
    torch.cuda.synchronize()
    err, mab = rel_l2(h1, ref1), (h1.float() - ref1.float()).abs().max().item()
    t = k1_timing(params, x1, dims, K1_POS, c1[0], valid1, None, 1)
    pms = graph_ms(lambda: fused_decode_step_plain(params, x1, dims, K1_POS, c1[0], valid1),
                   iters=3, replays=2)
    b = k1_bound(starts[:1], params, 1, K1_S, K1_L, K1_D)
    print(f"K1 fused_decode_step group=1 L={K1_L} D={K1_D} H={K1_H} B=1 S={K1_S} pos={K1_POS}:"
          f" hidden rel_l2 {err:.3e} max_abs {mab:.3e}; device: {timing_text(t)}, plain "
          f"{pms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]", flush=True)
    assert err <= K1_REL_L2 and np.isfinite(err), f"K1 group=1 hidden rel-L2 {err}"
    res["fused_decode_step_g1"] = dict(err=err, abs=mab, plain_ms=pms, library_ms=None, **t,
                                       **b)
    return res


def k1_group2_phase(card: str) -> dict:
    """K1 at group=2, diverse beam search's configuration at num_beams=4,
    num_beam_groups=2 (`engine/beam.py::generate_group_beam`): 4 rows in two
    groups of two beams, the groups' prefixes starting at 0 and 41, a random
    in-group ancestry map, int8 weights, S=512, pos=300. Layer by layer
    against the twin (`twin_by_layer`), bit-identical to the chain
    (`k1_against_chain`), and timed beside it and the twin."""
    import torch

    from indextts_tpu_torch.ops.decode_step import fused_decode_step, fused_decode_step_plain

    g = torch.Generator(device="cuda").manual_seed(7)
    dims, _, params, _, _, _, _, _ = k1_case(g)
    M, group = 4, 2
    kv = [torch.randn((K1_L, M, K1_S, K1_D), generator=g, device="cuda").to(torch.bfloat16)
          for _ in range(2)]
    for t in kv:
        t[:, :, K1_POS:] = 0
    starts = [0, 0, 41, 41]
    valid = torch.zeros((M, K1_S), dtype=torch.bool, device="cuda")
    for r, st in enumerate(starts):
        valid[r, st:K1_POS + 1] = True
    x = torch.randn((M, K1_D), generator=g, device="cuda").to(torch.bfloat16)
    anc = torch.randint(0, group, (M, K1_S), generator=g, device="cuda", dtype=torch.int32)
    base = {"k": kv[0], "v": kv[1]}
    args = dict(params=params, x=x, dims=dims, pos=K1_POS,
                kv_cache={k: t.clone() for k, t in base.items()}, kv_valid=valid, anc=anc,
                group=group, layer_inputs=[])
    h = fused_decode_step(**args)
    ref = fused_decode_step_plain(params, x, dims, K1_POS, {k: t.clone() for k, t in base.items()},
                                  valid, anc, group)
    torch.cuda.synchronize()
    err, mab = rel_l2(h, ref), (h.float() - ref.float()).abs().max().item()
    tw = twin_by_layer(args, h)
    vs = k1_against_chain(params, x, dims, K1_POS, base, valid, anc, group)
    cache = {k: t.clone() for k, t in base.items()}
    t = k1_timing(params, x, dims, K1_POS, cache, valid, anc, group)
    pms = graph_ms(lambda: fused_decode_step_plain(params, x, dims, K1_POS, cache, valid, anc,
                                                   group), iters=3, replays=2)
    b = k1_bound(starts, params, M, K1_S, K1_L, K1_D)
    print(f"K1 fused_decode_step group=2 (diverse beam: 2 groups of 2) L={K1_L} D={K1_D} "
          f"H={K1_H} rows={M} S={K1_S} pos={K1_POS} starts={starts}: hidden rel_l2 {err:.3e} "
          f"max_abs {mab:.3e}; twin layer by layer rel_l2 <= {tw['layer']:.3e}, hidden "
          f"{tw['hidden']:.3e}, rows {tw['rows_exact']}; against the chain {vs}; device: "
          f"{timing_text(t)}, plain {pms:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}) [{card}]", flush=True)
    assert tw["layer"] <= K1_REL_L2 and tw["hidden"] <= K1_REL_L2 and tw["rows_exact"], tw
    assert err <= K1_REL_L2 and np.isfinite(err) and vs["ok"], (err, vs)
    return {"fused_decode_step_g2": dict(err=err, abs=mab, plain_ms=pms, library_ms=None, **t,
                                         **b)}


def twin_by_layer(args, h) -> dict:
    """K1's call ``args`` (each layer's input under "layer_inputs") and its
    output ``h`` against the twins, layer by layer on the kernel path's
    inputs. The kernel wrote only the rows at pos, which attention does not
    read, so a copy of the cache holds the inputs. Returns the largest
    layer-output rel-L2, the hidden state's after ln_f, and whether every
    layer's written rows (k, v and the int8 cache's scale rows) are
    bit-identical to what the twin attention writes from the kernel's own
    qkv: the qkv GEMV is launched again for that, uncounted (it repeats its
    result exactly), since the twin's qkv differs from the kernel's by the
    f32 summation order, and a LayerNorm value that rounds the other way
    moves a near-zero k/v value by several of its ulps."""
    import torch

    from indextts_tpu_torch import nn
    from indextts_tpu_torch.ops.decode_step import TWINS, decode_layer
    from indextts_tpu_torch.ops.int8 import EPI_BIAS, _gemv_cuda

    pos, kv, xs = args["pos"], args["kv_cache"], args["layer_inputs"]
    rest = dict(heads=args["dims"].heads, pos=pos, kv_valid=args["kv_valid"],
                anc=args["anc"], group=args["group"])
    twin = {k: t.clone() for k, t in kv.items()}
    out = {"layer": 0.0, "rows_exact": True}
    for li, lp in enumerate(args["params"]["h"]):
        layer = {k: t[li].clone() for k, t in twin.items()}
        y = decode_layer(TWINS, lp, xs[li], ck=twin["k"][li], cv=twin["v"][li],
                         kvs=twin["kvs"][li] if "kvs" in twin else None, **rest)
        out["layer"] = max(out["layer"], rel_l2(xs[li + 1], y))
        c_attn, ln = lp["attn"]["c_attn"], (lp["ln_1"]["weight"], lp["ln_1"]["bias"])
        w4 = "q4" in c_attn
        qkv = _gemv_cuda(xs[li], c_attn["q4" if w4 else "q"], ln, c_attn["scale"],
                         c_attn["bias"], EPI_BIAS, None, w4=w4)
        TWINS.attention(qkv, layer["k"], layer["v"], kvs=layer.get("kvs"), **rest)
        out["rows_exact"] &= all(torch.equal(kv[k][li, :, pos], layer[k][:, pos]) for k in kv)
    out["hidden"] = rel_l2(h, nn.layer_norm(args["params"]["ln_f"], y))
    return out


def quant_kernel_phase(card: str, int8_k1: dict) -> dict:
    """The int4 GEMVs and K1's KVQ, W4 and int4kv variants against their
    twins at the decode's shapes (yardsticks: F.linear on the bf16 weight;
    the int8 K1 and the bf16 step of ``int8_k1``)."""
    import torch
    import torch.nn.functional as F

    from indextts_tpu_torch.models.gpt.gpt2 import kv_quantize_flat, quantize_gpt2_int4
    from indextts_tpu_torch.ops.decode_step import fused_decode_step, fused_decode_step_plain
    from indextts_tpu_torch.ops.int8 import (int4_matvec, int4_matvec_plain, int4_mlp,
                                             int4_mlp_plain)

    g = torch.Generator(device="cuda").manual_seed(3)
    res = {}
    D, M = K1_D, K1_ROWS
    mv = {"err": 0.0, "abs": 0.0}
    shapes = {}
    for name, Mi, N, K in GEMV_SHAPES:
        x, q4, scale, bias, w_bf16 = int4_operands(g, Mi, K, N)
        out, ref = int4_matvec(x, q4), int4_matvec_plain(x, q4)
        ep = int4_matvec(x, q4, scale=scale, bias=bias)
        ep_ref = int4_matvec_plain(x, q4, scale=scale, bias=bias)
        torch.cuda.synchronize()
        err = max(rel_l2(out, ref), rel_l2(ep, ep_ref))
        mab = (out - ref).abs().max().item()
        kt, lt = timing_spread(lambda: int4_matvec(x, q4), lambda: F.linear(x, w_bf16))
        pms = graph_ms(lambda: int4_matvec_plain(x, q4))
        b = bound(N * K // 2 + Mi * K * 2 + Mi * N * 4, 2 * Mi * N * K, BF16_FLOPS)
        print(f"W4 int4_matvec {name} M={Mi} K={K} N={N} ({plan_text(Mi, N, K, True)}): "
              f"rel_l2 {err:.3e} max_abs {mab:.3e} device: kernel {spread_text(kt)}; F.linear"
              f"(bf16 weight) {spread_text(lt)}; plain {pms:.4f} ms; bound {b['bound_ms']:.4f}"
              f" ms ({b['bound_by']}) [{card}]", flush=True)
        assert err <= K7_REL_L2 and np.isfinite(err), f"W4 GEMV rel-L2 {err} at {name}"
        mv["err"], mv["abs"] = max(mv["err"], err), max(mv["abs"], mab)
        shapes[f"{name} M={Mi}"] = gemv_shape_row(kt, lt, b)
        if name == "qkv" and Mi == M:
            mv.update(plain_ms=pms, **b, **spread_row(kt, lt, shapes=shapes))
    res["int4_matvec"] = mv

    x, w1, s1, b1, _ = int4_operands(g, M, D, 4 * D)
    _, w2, _, _, _ = int4_operands(g, M, 4 * D, D)
    out, ref = int4_mlp(x, w1, s1, b1, w2), int4_mlp_plain(x, w1, s1, b1, w2)
    torch.cuda.synchronize()
    err, mab = rel_l2(out, ref), (out - ref).abs().max().item()
    ms = graph_ms(lambda: int4_mlp(x, w1, s1, b1, w2))
    pms = graph_ms(lambda: int4_mlp_plain(x, w1, s1, b1, w2))
    b = bound(4 * D * D + 4 * D * (4 + 2) + M * D * (2 + 4), 4 * M * 4 * D * D, BF16_FLOPS)
    print(f"W4 int4_mlp M={M} D={D} F={4 * D}: rel_l2 {err:.3e} max_abs {mab:.3e} device: "
          f"kernel {ms:.4f} ms plain {pms:.4f} ms bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}) [{card}]", flush=True)
    assert err <= K7_REL_L2 and np.isfinite(err), f"W4 MLP rel-L2 {err}"
    res["int4_mlp"] = dict(err=err, abs=mab, ms=ms, plain_ms=pms, library_ms=None, **b)

    dims, bf16_params, params8, kv, valid, x, anc, starts = k1_case(g)
    params4 = quantize_gpt2_int4(bf16_params)
    del bf16_params
    kq, vq, kvs = kv_quantize_flat(kv[0], kv[1], K1_H)
    rows = (torch.arange(M, device=x.device)[:, None] // M) * M + anc.long()
    slot = torch.arange(K1_S, device=x.device)[None, :]
    for name, (w4, kvq) in K1_VARIANTS.items():
        params = params4 if w4 else params8
        base = {"k": kq, "v": vq, "kvs": kvs} if kvq else {"k": kv[0], "v": kv[1]}

        def cache():
            return {k: t.clone() for k, t in base.items()}

        args = dict(params=params, x=x, dims=dims, pos=K1_POS, kv_cache=cache(), kv_valid=valid,
                    anc=anc, group=M, layer_inputs=[])
        h = fused_decode_step(**args)
        ref = fused_decode_step_plain(params, x, dims, K1_POS, cache(), valid, anc, M)
        gathered = {k: t[:, rows, slot].contiguous() for k, t in base.items()}
        h_gat = fused_decode_step(params, x, dims, K1_POS, gathered,
                                  valid[rows, slot].contiguous())
        torch.cuda.synchronize()
        tw = twin_by_layer(args, h)
        chain, mab = rel_l2(h, ref), (h.float() - ref.float()).abs().max().item()
        exact = torch.equal(h, h_gat) and all(
            torch.equal(args["kv_cache"][k][:, :, K1_POS], gathered[k][:, :, K1_POS])
            for k in base)
        c = cache()
        vs = k1_against_chain(params, x, dims, K1_POS, base, valid, anc, M)
        t = k1_timing(params, x, dims, K1_POS, c, valid, anc, M)
        pms = graph_ms(lambda: fused_decode_step_plain(params, x, dims, K1_POS, c, valid, anc,
                                                       M), iters=3, replays=2)
        b = k1_bound(starts, params, M, K1_S, K1_L, K1_D, K1_H, kvq)
        print(f"K1 {name} L={K1_L} D={K1_D} H={K1_H} B*K={M} S={K1_S} pos={K1_POS}: layer by "
              f"layer on the kernel path's inputs: layer outputs rel_l2 <= {tw['layer']:.3e}, "
              f"hidden after ln_f {tw['hidden']:.3e}, written rows bit-identical to the twin's"
              f" write of the kernel's qkv: {tw['rows_exact']}; 24-layer chain against the "
              f"twin {chain:.3e}"
              f" (max_abs {mab:.3e}); ancestry bit-identical to the gathered cache: {exact};"
              f" against the chain {vs}; device: {timing_text(t)}, plain {pms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}); yardsticks: int8 K1 "
              f"{int8_k1['ms']:.4f} ms, bf16 gpt2_decode_step {int8_k1['bf16_step_ms']:.4f} ms "
              f"[{card}]", flush=True)
        assert tw["layer"] <= K1_REL_L2 and tw["hidden"] <= K1_REL_L2, (name, tw)
        assert tw["rows_exact"], (name, tw)
        assert exact, f"K1 {name} with the ancestry map differs from the gathered cache"
        assert vs["ok"], f"K1 {name} against the chain: {vs}"
        res[name] = dict(err=tw["hidden"], abs=mab, plain_ms=pms, library_ms=None, **t, **b)
    return res


def full_c_attn(tp, li: int) -> dict:
    """Layer ``li``'s unsharded qkv projection and ln_1, rebuilt from the
    tp shards (rank t holds rows q_t | k_t | v_t)."""
    import torch

    parts = [shard[li]["attn"]["c_attn"] for shard in tp["shards"]]

    def cat(k):
        rest = parts[0][k].shape[1:]
        return torch.cat([p[k].reshape(3, -1, *rest) for p in parts], 1).reshape(-1, *rest)
    return {"c_attn": {k: cat(k) for k in parts[0]}, "ln_1": tp["shards"][0][li]["ln_1"]}


def tp_twin_by_layer(args, h, full_layers) -> dict:
    """K6's call ``args`` (per layer, the tuple of the shards' inputs under
    "layer_inputs") and its output ``h`` (after ln_f) against the twins,
    layer by layer on the kernel path's inputs (`twin_by_layer`'s scheme:
    the kernel wrote only the rows at pos, so a copy of the cache holds the
    inputs). Returns the largest layer-output rel-L2, the hidden state's
    after ln_f, whether the two shards' residual streams are bit-identical
    at every layer, and whether every layer's written k/v rows are
    bit-identical to K1's qkv GEMV on the same input (the unsharded weight
    and ln_1 of ``full_layers[li]``; launched uncounted), per head slice."""
    import torch

    from indextts_tpu_torch import nn
    from indextts_tpu_torch.ops.decode_step_tp import TWINS, decode_layer_tp, per_rank
    from indextts_tpu_torch.ops.int8 import EPI_BIAS, _gemv_cuda

    tp, pos, xs = args["params"], args["pos"], args["layer_inputs"]
    caches = args["kv_cache"]["shards"]
    devs = tp["mesh"].devices
    twin = [{k: t.clone() for k, t in c.items()} for c in caches]
    D = args["dims"].dim
    Dl = D // len(caches)
    valids, ancs = per_rank(args["kv_valid"], devs), per_rank(args["anc"], devs)
    out = {"layer": 0.0, "streams_equal": True, "rows_exact": True}

    def same(a, b):
        return torch.equal(a, b.to(a.device))

    for li, layers in enumerate(zip(*tp["shards"])):
        out["streams_equal"] &= all(same(xs[li][0], x) for x in xs[li])
        y = decode_layer_tp(TWINS, layers, list(xs[li]), args["dims"].heads // len(caches), pos,
                            twin, li, valids, ancs, args["group"])
        out["layer"] = max(out["layer"], rel_l2(xs[li + 1][0], y[0]))
        lp = full_layers[li]
        ca = lp["c_attn"]
        qkv = _gemv_cuda(xs[li][0], ca["q"], (lp["ln_1"]["weight"], lp["ln_1"]["bias"]),
                         ca["scale"], ca["bias"], EPI_BIAS, None)
        for t, c in enumerate(caches):
            for j, key in ((1, "k"), (2, "v")):
                out["rows_exact"] &= same(qkv[:, j * D + t * Dl:j * D + (t + 1) * Dl],
                                          c[key][li, :, pos])
    out["streams_equal"] &= all(same(xs[-1][0], x) for x in xs[-1])
    out["hidden"] = rel_l2(h, nn.layer_norm(tp["ln_f"], y[0]))
    return out


def tp_bound(tp, starts, M: int, S: int, ranks=(0, 1)) -> dict:
    """Bytes and operations of K6 at this run's inputs on the shards
    ``ranks``: every weight, scale, bias and LayerNorm tensor once (the
    shards' copies on one card are one tensor), x in and its residual
    stream out, kv_valid and the ancestry map, each shard's valid cached
    k/v of every layer and its written rows; operations: two per weight
    value and row plus the attention's products. All ranks: the step on
    one card, where the exchange stays inside the kernel (no partial in
    device memory). One rank: what one card would move with the shards on
    two, its f32 partial written and the peer's read at each of a layer's
    two exchanges (not measured)."""
    seen, nbytes, ops = set(), 0, 0
    for r in ranks:
        layers = tp["shards"][r]
        L = len(layers)
        D = layers[0]["attn"]["c_proj"]["q"].shape[0]
        Dl = layers[0]["attn"]["c_proj"]["q"].shape[1]
        for lp in layers:
            for grp in (lp["attn"], lp["mlp"], {"a": lp["ln_1"], "b": lp["ln_2"]}):
                for d in grp.values():
                    for t in d.values():
                        if t.data_ptr() not in seen:
                            seen.add(t.data_ptr())
                            nbytes += t.numel() * t.element_size()
        n_weights = sum(d["q"].numel() for lp in layers
                        for d in (*lp["attn"].values(), *lp["mlp"].values()))
        cached = sum(K1_POS - st for st in starts)
        nbytes += L * cached * 4 * Dl + L * M * 4 * Dl
        ops += 2 * M * n_weights + L * 4 * (cached + M) * Dl
    nbytes += 2 * M * D * 2 + M * S * (1 + 4)
    if len(ranks) == 1:
        nbytes += L * 2 * M * D * 4 * 2
    return bound(nbytes, ops, BF16_FLOPS)


def tp_split_cache(kv, tp_width: int = 2) -> dict:
    """A (L, M, S, D) k, v pair as the tp step's per-shard cache: shard t
    holds columns [t D/2, (t + 1) D/2), contiguous."""
    Dl = kv[0].shape[-1] // tp_width
    return {"shards": [{k: t[..., r * Dl:(r + 1) * Dl].contiguous() for k, t in zip("kv", kv)}
                       for r in range(tp_width)]}


def k6_against_chain(tp, x, dims, pos: int, base: dict, valid, anc, group: int) -> dict:
    """K6 co-located (`fused_decode_step_tp`: the persistent kernel's TP
    variant) and the chain of standalone kernels it replaced
    (`fused_decode_step_tp_chain`) on copies of the shards' caches, as
    `k1_against_chain`: the hidden state, both shards' whole caches after
    the step, every layer's input (both entries of a layer's tuple), a
    second launch, `step_barriers` grid barriers."""
    import torch

    from indextts_tpu_torch.ops.decode_step import step_barrier, step_barriers
    from indextts_tpu_torch.ops.decode_step_tp import (fused_decode_step_tp,
                                                       fused_decode_step_tp_chain)

    def copy():
        return {"shards": [{k: t.clone() for k, t in c.items()} for c in base["shards"]]}

    caches = [copy() for _ in range(3)]
    count = step_barrier(x.device)
    before = int(count[1])
    lk, lc = [], []
    h = fused_decode_step_tp(tp, x, dims, pos, caches[0], valid, anc, group, layer_inputs=lk)
    torch.cuda.synchronize()
    barriers = int(count[1]) - before
    hc = fused_decode_step_tp_chain(tp, x, dims, pos, caches[1], valid, anc, group,
                                    layer_inputs=lc)
    h2 = fused_decode_step_tp(tp, x, dims, pos, caches[2], valid, anc, group)
    torch.cuda.synchronize()

    def same_cache(a, b):
        return all(torch.equal(ca[k], cb[k]) for ca, cb in zip(a["shards"], b["shards"])
                   for k in ca)

    out = {"hidden": torch.equal(h, hc), "cache": same_cache(caches[0], caches[1]),
           "layers": len(lk) == len(lc) and all(torch.equal(a[0], t) for a, b in zip(lk, lc)
                                                for t in (*a, *b)),
           "again": torch.equal(h, h2) and same_cache(caches[0], caches[2]),
           "barriers": barriers == step_barriers(len(tp["shards"][0]))}
    out["ok"] = all(out.values())
    return out


def k6_timing(tp, x, dims, pos: int, cache: dict, valid, anc, group: int) -> dict:
    """K6's persistent kernel and, in the same call, the chain it replaced
    (its two shard streams forked inside the capture): device time by graph
    replay, and eager (CUDA events over the calls, host work included)."""
    from indextts_tpu_torch.ops.decode_step_tp import (fused_decode_step_tp,
                                                       fused_decode_step_tp_chain)

    def call(fn):
        return lambda: fn(tp, x, dims, pos, cache, valid, anc, group)

    return {"ms": graph_ms(call(fused_decode_step_tp)),
            "chain_ms": graph_ms(call(fused_decode_step_tp_chain)),
            "eager_ms": time_ms(call(fused_decode_step_tp), iters=20),
            "chain_eager_ms": time_ms(call(fused_decode_step_tp_chain), iters=10)}


def k6_phase(card: str) -> int:
    """K6 co-located (the persistent kernel's TP variant) at group=3 and
    group=1: at the K1 case layer by layer against the twin
    (`tp_twin_by_layer`), bit-identical to the chain it replaced
    (`k6_against_chain`) and with an invalid chunk inserted inside the valid
    run (`insert_invalid_chunk`), then bit-identical to the chain at
    `K1_EDGE_CASES` (pos=0, pos=1, S=2048 pos=1500, 24 rows). Returns the
    case count."""
    import torch

    from indextts_tpu_torch import nn
    from indextts_tpu_torch.ops.decode_step_tp import fused_decode_step_tp
    from indextts_tpu_torch.parallel.mesh import make_mesh, shard_gpt2_tp

    g = torch.Generator(device="cuda").manual_seed(7)
    dims, bf16_params, params, kv, valid, x, anc, _ = k1_case(g)
    del bf16_params
    tp = shard_gpt2_tp(params, make_mesh(list(TP_DEVICES)))
    full = [{"c_attn": lp["attn"]["c_attn"], "ln_1": lp["ln_1"]} for lp in params["h"]]
    n = 0
    for group in (K1_ROWS, 1):
        rows = slice(0, group)
        base = tp_split_cache([t[:, rows] for t in kv])
        v, a = valid[rows].contiguous(), (anc if group > 1 else None)
        args = dict(params=tp, x=x[rows], dims=dims, pos=K1_POS, kv_cache=tp_split_cache(
            [t[:, rows] for t in kv]), kv_valid=v, anc=a, group=group, layer_inputs=[])
        h = nn.layer_norm(tp["ln_f"], fused_decode_step_tp(**args))
        torch.cuda.synchronize()
        tw = tp_twin_by_layer(args, h, full)
        vs = k6_against_chain(tp, x[rows], dims, K1_POS, base, v, a, group)
        ci, vi, ai = insert_invalid_chunk(base, v, a, g)
        inserted = torch.equal(h, nn.layer_norm(tp["ln_f"], fused_decode_step_tp(
            tp, x[rows], dims, K1_POS + CHUNK_SLOTS, ci, vi, ai, group)))
        del ci
        print(f"K6 group={group} K1 case: twin layer by layer rel_l2 <= {tw['layer']:.3e}, "
              f"hidden {tw['hidden']:.3e}, residual streams {tw['streams_equal']}, rows "
              f"{tw['rows_exact']}; against the chain {vs}; an invalid chunk inserted inside "
              f"the valid run changes nothing: {inserted} [{card}]", flush=True)
        assert tw["layer"] <= K1_REL_L2 and tw["hidden"] <= K1_REL_L2, (group, tw)
        assert tw["streams_equal"] and tw["rows_exact"] and vs["ok"] and inserted, \
            (group, tw, vs, inserted)
        n += 1
    for label, (rows, S, pos) in K1_EDGE_CASES.items():
        kv_e, valid_e, x_e, anc_e = k1_edge_inputs(g, rows, S, pos)
        base_e = tp_split_cache(kv_e)
        del kv_e
        for group in (K1_ROWS, 1):
            vs = k6_against_chain(tp, x_e, dims, pos, base_e, valid_e,
                                  anc_e if group > 1 else None, group)
            print(f"K6 group={group} {label} ({rows} rows, S={S}, pos={pos}): against the chain "
                  f"{vs} [{card}]", flush=True)
            assert vs["ok"], (group, label, vs)
            n += 1
        del base_e
        torch.cuda.empty_cache()
    return n


def tp_kernel_phase(card: str, kres: dict) -> dict:
    """K6 `fused_decode_step_tp` with both shards on this card
    (`make_mesh(["cuda:0", "cuda:0"])`: one launch a step of the persistent
    kernel's TP variant) at K1's shape: 3 rows at group=3 with a random
    ancestry map, and 1 row at group=1. Each against the twin layer by layer
    on the kernel path's inputs (`tp_twin_by_layer`: rel-L2 <= 1e-2,
    residual streams and written rows bit-identical), bit-identical to the
    chain it replaced (`k6_against_chain`), its hidden state beside K1's on
    the same inputs; device ms by graph replay and eager beside the chain's
    in the same call (`k6_timing`), and at group=3 its timeline
    (`step_timeline`: µs a layer in each phase and barrier). And
    `tp_allreduce` alone at M=3, N=1280, bit-identical to its twin for
    either rank (the chain's exchange; folded into K6's kernel on this
    route)."""
    import torch

    from indextts_tpu_torch import nn
    from indextts_tpu_torch.ops.decode_step import fused_decode_step, step_timeline
    from indextts_tpu_torch.ops.decode_step_tp import (fused_decode_step_tp,
                                                       fused_decode_step_tp_plain, tp_allreduce,
                                                       tp_allreduce_plain)
    from indextts_tpu_torch.parallel.mesh import make_mesh, shard_gpt2_tp

    g = torch.Generator(device="cuda").manual_seed(6)
    dims, bf16_params, params, kv, valid, x, anc, starts = k1_case(g)
    del bf16_params
    mesh = make_mesh(list(TP_DEVICES))
    tp = shard_gpt2_tp(params, mesh)
    full = [{"c_attn": lp["attn"]["c_attn"], "ln_1": lp["ln_1"]} for lp in params["h"]]
    res = {}
    for name, M, group in (("fused_decode_step_tp", K1_ROWS, K1_ROWS),
                           ("fused_decode_step_tp_g1", 1, 1)):
        xr, vr, ar = x[:M], valid[:M], anc if group > 1 else None

        def cache():
            return tp_split_cache([t[:, :M] for t in kv])

        args = dict(params=tp, x=xr, dims=dims, pos=K1_POS, kv_cache=cache(), kv_valid=vr,
                    anc=ar, group=group, layer_inputs=[])
        h = nn.layer_norm(tp["ln_f"], fused_decode_step_tp(**args))
        k1_cache = {k: kv[i][:, :M].clone() for i, k in enumerate("kv")}
        h_k1 = fused_decode_step(params, xr, dims, K1_POS, k1_cache, vr, ar, group)
        torch.cuda.synchronize()
        tw = tp_twin_by_layer(args, h, full)
        vs_k1, mab = rel_l2(h, h_k1), (h.float() - h_k1.float()).abs().max().item()
        vs = k6_against_chain(tp, xr, dims, K1_POS, cache(), vr, ar, group)
        c = cache()
        t = k6_timing(tp, xr, dims, K1_POS, c, vr, ar, group)
        pms = graph_ms(lambda: fused_decode_step_tp_plain(tp, xr, dims, K1_POS, c, vr, ar, group),
                       iters=3, replays=2)
        b = tp_bound(tp, starts[:M], M, K1_S)
        shard_b = tp_bound(tp, starts[:M], M, K1_S, ranks=(0,))
        k1_ms = kres["fused_decode_step" if M == K1_ROWS else "fused_decode_step_g1"]["ms"]
        print(f"K6 {name} L={K1_L} D={K1_D} H={K1_H} (10 a shard) B*K={M} group={group} "
              f"S={K1_S} pos={K1_POS}, shards co-located: layer by layer on the "
              f"kernel path's inputs: layer outputs rel_l2 <= {tw['layer']:.3e}, hidden after "
              f"ln_f {tw['hidden']:.3e}; residual streams bit-identical: {tw['streams_equal']};"
              f" written rows bit-identical to K1's qkv kernel: {tw['rows_exact']}; against "
              f"the chain {vs}; hidden against K1 on the same inputs {vs_k1:.3e} (max_abs "
              f"{mab:.3e}); device: {timing_text(t)}, plain {pms:.4f} ms, K1 {k1_ms:.4f} ms, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}); bound of one shard on two "
              f"cards (half the weight bytes a card; not measured) {shard_b['bound_ms']:.4f} ms "
              f"[{card}]", flush=True)
        assert tw["layer"] <= K1_REL_L2 and tw["hidden"] <= K1_REL_L2, (name, tw)
        assert tw["streams_equal"] and tw["rows_exact"], (name, tw)
        assert vs["ok"], f"K6 {name} against the chain: {vs}"
        assert vs_k1 <= K1_REL_L2 and np.isfinite(vs_k1), (name, vs_k1)
        res[name] = dict(err=tw["hidden"], abs=mab, plain_ms=pms, library_ms=None, **t, **b)
        if group > 1:
            timeline = step_timeline(tp, xr, dims, K1_POS, c, vr, ar, group)
            print("K6 timeline, µs a layer (mean over blocks and layers; 'slowest': a phase's "
                  "slowest block): " + ", ".join(f"{k} {v:.2f}" for k, v in timeline.items()),
                  flush=True)
            res[name]["timeline"] = timeline

    M, N = K1_ROWS, K1_D
    p0, p1 = (torch.randn((M, N), generator=g, device="cuda") * 1e3 for _ in range(2))
    scale = torch.rand((N,), generator=g, device="cuda") / 127 / 30
    bias = (0.1 * torch.randn((N,), generator=g, device="cuda")).to(torch.bfloat16)
    resid = torch.randn((M, N), generator=g, device="cuda").to(torch.bfloat16)
    outs = [tp_allreduce(p0, p1, scale, bias, resid, 0),
            tp_allreduce(p1, p0, scale, bias, resid, 1)]
    ref = tp_allreduce_plain(p0, p1, scale, bias, resid, 0)
    torch.cuda.synchronize()
    exact = all(torch.equal(o, ref) for o in outs)
    mab = max((o.float() - ref.float()).abs().max().item() for o in outs)
    ms = graph_ms(lambda: tp_allreduce(p0, p1, scale, bias, resid, 0))
    pms = graph_ms(lambda: tp_allreduce_plain(p0, p1, scale, bias, resid, 0))
    b = bound(2 * M * N * 4 + N * (4 + 2) + 2 * M * N * 2, 4 * M * N, F32_FLOPS)
    print(f"tp_allreduce M={M} N={N}: bit-identical to the twin for both ranks: {exact} "
          f"(max_abs {mab:.3e}); device: kernel {ms:.4f} ms plain {pms:.4f} ms bound "
          f"{b['bound_ms']:.5f} ms ({b['bound_by']}) [{card}]", flush=True)
    assert exact, "tp_allreduce differs from its twin"
    res["tp_allreduce"] = dict(err=0.0, abs=mab, ms=ms, plain_ms=pms, library_ms=None, **b)
    return res


def reference_check(tts, card: str, flash: bool = False) -> None:
    """The DiT velocity and BigVGAN on a small input with ragged lengths.
    Every kernel call is also run through its plain twin on the same inputs
    as it happens (rel-L2 over valid rows within the kernel-phase bounds,
    and K3's edge rows within 2 ulps); both outputs must be finite. With
    ``flash`` (INDEXTTS_PACKED_ATTN=0 set by the caller) every DiT layer's
    attention is K4's, else K2's."""
    import torch

    from indextts_tpu_torch import nn as tnn
    from indextts_tpu_torch.models.s2mel import dit as dit_mod
    from indextts_tpu_torch.models.vocoder import bigvgan as bv_mod
    from indextts_tpu_torch.ops.attn import (attention_rope, attention_rope_plain,
                                             single_block_attention,
                                             single_block_attention_plain)
    from indextts_tpu_torch.ops.rope import precompute_freqs_cis
    from indextts_tpu_torch.ops.snake import antialias_snake, antialias_snake_plain

    names = ("attention_rope", "single_block_attention", "antialias_snake")
    site = {**{n: 0.0 for n in names}, **{f"{n} calls": 0 for n in names}, "edge": 0.0}

    def checked(name, kernel, plain):
        def run(*args):
            out, ref = kernel(*args), plain(*args)
            site[f"{name} calls"] += 1
            for b, L in enumerate(args[3].tolist()):        # lengths
                rows = (b, slice(None), slice(0, L)) if name == "single_block_attention" \
                    else (b, slice(0, L))
                site[name] = max(site[name], rel_l2(out[rows], ref[rows]))
                if name == "antialias_snake":
                    site["edge"] = max(site["edge"], edge_err(out[b], ref[b], L))
            return out
        return run

    cfg, dev, dt = tts.cfg, tts.device, tts.dtype
    g = torch.Generator(device=dev).manual_seed(1)
    T = 200
    s2 = cfg.s2mel
    x = torch.randn((2, T, 80), generator=g, device=dev)
    prompt = torch.randn((2, T, 80), generator=g, device=dev).to(dt)
    cond = torch.randn((2, T, s2.DiT.content_dim), generator=g, device=dev).to(dt)
    style = torch.randn((2, s2.style_encoder.dim), generator=g, device=dev).to(dt)
    lens = torch.tensor([T, 150], device=dev)
    t = torch.tensor([0.3, 0.3], device=dev)
    fc = torch.as_tensor(precompute_freqs_cis(T, s2.DiT.head_dim), device=dev)
    mel = torch.randn((1, 64, 80), generator=g, device=dev).to(dt)
    mel_lens = torch.tensor([60], device=dev)

    saved = dit_mod.attention_rope, tnn.single_block_attention, bv_mod.antialias_snake
    dit_mod.attention_rope = checked("attention_rope", attention_rope, attention_rope_plain)
    tnn.single_block_attention = checked("single_block_attention", single_block_attention,
                                         single_block_attention_plain)
    bv_mod.antialias_snake = checked("antialias_snake", antialias_snake, antialias_snake_plain)
    try:
        with torch.inference_mode():
            v = dit_mod.dit_forward(tts.s2mel_params["cfm"], s2, x, prompt, lens, t, style,
                                    cond, fc)
            w = bv_mod.bigvgan_forward(tts.bigvgan_params, cfg.bigvgan, mel, mel_lens)
    finally:
        dit_mod.attention_rope, tnn.single_block_attention, bv_mod.antialias_snake = saved
    attn = "single_block_attention" if flash else "attention_rope"
    print(f"reference check (small input, DiT {'flash' if flash else 'packed'} tier), kernel vs"
          f" plain twin at every call: rel_l2 {attn} {site[attn]:.3e} over "
          f"{site[attn + ' calls']} calls, antialias_snake {site['antialias_snake']:.3e}, K3 "
          f"edge rows {site['edge']:.3f} of 2 ulps [{card}]", flush=True)
    other = "attention_rope" if flash else "single_block_attention"
    assert site[f"{attn} calls"] == s2.DiT.depth and site[f"{other} calls"] == 0, site
    assert site[attn] <= K2_REL_L2 and site["antialias_snake"] <= K3_REL_L2, site
    assert site["edge"] <= 1.0, site
    assert bool(torch.isfinite(v).all()) and bool(torch.isfinite(w[0, :60 * 256]).all())


def run_requests(tts, prompt: str, n: int, card: str, label: str, **kwargs) -> list:
    """``n`` requests pinned to 400 codes, with the generation ``kwargs``;
    checks and prints each."""
    reports = []
    for i in range(n):
        sr, wav = tts.infer(spk_audio_prompt=prompt, text=SENTENCE, output_path=None,
                            max_mel_tokens=400, min_new_tokens=399, **kwargs)
        st = dict(tts.last_stage_times)
        clen = st["codes"]
        expect = int(np.float32(clen) * np.float32(1.72)) * 256
        assert sr == 22050 and wav.shape == (expect, 1), (wav.shape, expect)
        assert np.all(np.isfinite(wav)) and np.abs(wav).max() > 0
        reports.append(st)
        stages = " ".join(f"{k}={st[k]:.4f}s" for k in
                          ("prompt", "gpt", "gpt_forward", "s2mel", "bigvgan", "total"))
        print(f"{label} request {i + 1}: codes={clen} audio={st['audio_s']:.4f}s {stages} "
              f"RTF={st['rtf']:.4f} [{card}]", flush=True)
    return reports


def kernel_counters() -> dict:
    """Every launch counter of the port's kernels, by kernel name: (object,
    attribute)."""
    from indextts_tpu_torch.ops.attn import (attention_rope, packed_pair_attention, rope_qk,
                                             single_block_attention)
    from indextts_tpu_torch.ops.decode_step import decode_attention, fused_decode_step
    from indextts_tpu_torch.ops.decode_step_tp import fused_decode_step_tp, tp_allreduce
    from indextts_tpu_torch.ops.int8 import int4_matvec, int4_mlp, int8_matvec, int8_mlp
    from indextts_tpu_torch.ops.snake import (antialias_activation_prefolded, antialias_snake,
                                              fused_antialias_activation)

    counters = {f.__name__: (f, "launches") for f in (
        attention_rope, rope_qk, single_block_attention, packed_pair_attention, antialias_snake,
        fused_antialias_activation, antialias_activation_prefolded, fused_decode_step,
        int8_matvec, int8_mlp, int4_matvec, int4_mlp, decode_attention, fused_decode_step_tp,
        tp_allreduce)}
    counters["decode_attention_kvq"] = (decode_attention, "kvq_launches")
    return counters


def reset_counts() -> None:
    from indextts_tpu_torch.engine import beam, decode
    from indextts_tpu_torch.models.gpt.gpt2 import gpt2_chunk_step, gpt2_decode_step

    for f, attr in kernel_counters().values():
        setattr(f, attr, 0)
    gpt2_decode_step.calls = gpt2_chunk_step.calls = 0
    beam.kv_gathers = 0
    decode.span_growths = 0


def read_counts() -> dict:
    from indextts_tpu_torch.engine import beam, decode
    from indextts_tpu_torch.models.gpt.gpt2 import gpt2_chunk_step, gpt2_decode_step

    counts = {name: getattr(f, attr) for name, (f, attr) in kernel_counters().items()}
    counts.update(gpt2_decode_step=gpt2_decode_step.calls,
                  gpt2_chunk_step=gpt2_chunk_step.calls, kv_gathers=beam.kv_gathers,
                  span_growths=decode.span_growths)
    return counts


# pads of spin kernels inside the profiler's window, left out of every
# figure. The window can lose records at both ends: the last 9 steps of a
# 399-step decode in one run, the last 57 steps (some 22,000 records) in
# another, before the tail pad of PROFILE_PAD_LAUNCHES short spins; the bf16
# decode's two first top-k records in a third, its run opening the window; a
# window's first kernel, right after the warm-up step, in runs of
# tools/torch_profiler_window.py. The profiler keeps a device record only if
# it falls inside the window as the host's clock sets it, and the two clocks
# disagree near the edges, so a lead pad opens the window and a tail pad
# closes it, each spanning PROFILE_PAD_S of device time (long spins of
# PROFILE_PAD_CYCLES, ~5 ms each at the H100's clock); the tail pad has the
# short spins first. The smoke prints how many of each pad's records the
# window kept.
PROFILE_PAD_LAUNCHES = 40000
PROFILE_PAD_S = 1.0
PROFILE_PAD_CYCLES = 10_000_000
# the warm-up step's pad: its records are discarded, but take room in the
# profiler's record buffers until the window closes
PROFILE_WARMUP_LAUNCHES = 100
# unprofiled runs before a profiled one (their best is the wall a busy share
# is taken over); one keeps the smoke inside its time limit
PROFILE_UNPROFILED_RUNS = 1


def _spin_pad(devices=("cuda:0",), launches: int = PROFILE_PAD_LAUNCHES,
              seconds: float = PROFILE_PAD_S) -> None:
    """``launches`` short spin kernels over ``devices``, then about
    ``seconds`` of long ones on each, and a synchronize."""
    import torch

    for _ in range(launches // len(devices)):
        for d in devices:
            with torch.cuda.device(d):
                torch.cuda._sleep(100)
    for _ in range(round(seconds / 5e-3)):
        for d in devices:
            with torch.cuda.device(d):
                torch.cuda._sleep(PROFILE_PAD_CYCLES)
    for d in devices:
        torch.cuda.synchronize(d)


def device_records(prof, key=lambda e: e.name(), pads=None) -> tuple:
    """A profiler window's raw device records, the spin pads left out: a
    dict ``key(record)`` -> [count, device ns], and each record's (start,
    end) ns. With ``pads`` (a list), the pads' records' start ns are
    appended to it. Read raw: `key_averages()` builds a Python event object
    for every record first, which cost the bf16 pass, ~400,000 launches in
    its window, about half its time."""
    by: dict = {}
    spans = []
    for e in prof.profiler.kineto_results.events():
        ns = e.duration_ns()
        if ns <= 0 or not str(e.device_type()).endswith("CUDA"):
            continue
        if "spin_kernel" in e.name():
            if pads is not None:
                pads.append(e.start_ns())
            continue
        acc = by.setdefault(key(e), [0, 0])
        acc[0] += 1
        acc[1] += ns
        spans.append((e.start_ns(), e.end_ns()))
    return by, spans


def pads_kept(pads, spans) -> str:
    """How many pad records the window kept before and after the run's."""
    first, last = min(a for a, _ in spans), max(a for a, _ in spans)
    lead, tail = sum(t < first for t in pads), sum(t > last for t in pads)
    return (f"pad records kept: lead {lead} of {round(PROFILE_PAD_S / 5e-3)}, tail {tail} of "
            f"{PROFILE_PAD_LAUNCHES + round(PROFILE_PAD_S / 5e-3)}")


def union_ns(spans) -> int:
    """The time the device was busy on any stream: the union of the records'
    (start, end) intervals, ns."""
    busy, reach = 0, None
    for a, b in sorted(spans):
        if reach is None or a > reach:
            busy, reach = busy + b - a, b
        elif b > reach:
            busy, reach = busy + b - reach, b
    return busy


def profile_s2mel(tts, prompt: str, card: str, label: str, **kwargs) -> None:
    """One more request (after the pass's counts are read) whose CFM solve,
    the s2mel stage's 25 DiT evaluations, runs under `torch.profiler`
    (device activity, spin pads leading and trailing the solve): its synchronized
    wall, the device's busy share over it, the launches, and the DiT
    attention kernels' launches (13 x 25 of the attention kernel, asserted,
    and on the packed tier as many rope passes) and device time, and the
    largest device consumers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from indextts_tpu_torch.pipeline import infer_v2

    cfm, seen = infer_v2.cfm_inference, {}

    def profiled(*args, **kw):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _spin_pad(launches=0)
            t0 = time.perf_counter()
            out = cfm(*args, **kw)
            torch.cuda.synchronize()
            seen["wall"] = time.perf_counter() - t0
            _spin_pad()
        seen["prof"] = prof
        return out

    infer_v2.cfm_inference = profiled
    try:
        tts.infer(spk_audio_prompt=prompt, text=SENTENCE, output_path=None, max_mel_tokens=400,
                  min_new_tokens=399, **kwargs)
    finally:
        infer_v2.cfm_inference = cfm
    pads: list = []
    by_name, spans = device_records(seen["prof"], pads=pads)
    wall, busy = seen["wall"], union_ns(spans) / 1e9
    attn = {k: v for k, v in by_name.items() if "attention_kernel" in k or "rope_qk_kernel" in k}
    n_attn = sum(n for k, (n, _) in attn.items() if "attention_kernel" in k)
    # a kernel's name up to its argument list
    parts = ", ".join(f"{n} x {k[:k.find('(', 1)]} {ns / 1e6:.2f} ms"
                      for k, (n, ns) in attn.items())
    print(f"{label} CFM profile (25 DiT steps): wall {wall:.4f} s, device busy {busy:.4f} s = "
          f"{100 * busy / wall:.1f} % (union), {sum(n for n, _ in by_name.values())} launches; "
          f"attention kernels: {parts}; {pads_kept(pads, spans)}; largest device consumers: "
          f"[{card}]", flush=True)
    for key, (n, ns) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"    {ns / 1e6:9.2f} ms {n:7d} x  {key[:90]}", flush=True)
    assert n_attn == tts.cfg.s2mel.DiT.depth * 25, attn


def profile_decode(tts, prompt: str, card: str, label: str) -> None:
    """The decode of one request (`generate_beam`, 399 steps after the
    prefill) with the request's own prefix: unprofiled wall (the best of
    `PROFILE_UNPROFILED_RUNS`), then under `torch.profiler` (device activity
    only: recording every host op of the bf16 decode costs minutes): device
    time, kernels and copies,
    over that wall (the busy share), kernels launched per step, and the
    largest consumers. The profiler's window opens after a discarded warm-up
    step, and a pad of spin kernels (`_spin_pad`, left out of every figure)
    leads and trails the run inside it; the recorded launches of the port's
    GEMV and attention kernels and of the scorer's top-k must equal the
    counters of the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from indextts_tpu_torch.engine.beam import generate_beam
    from indextts_tpu_torch.pipeline.buckets import pick_bucket

    spk, emo = tts._prepare_spk_prompt(prompt), tts._prepare_emo_cond(prompt)
    ids = tts.tokenizer.convert_tokens_to_ids(tts.tokenizer.tokenize(SENTENCE))
    text_ids = np.zeros((1, pick_bucket(len(ids), tts.cfg.engine.text_buckets)), np.int64)
    text_ids[0, :len(ids)] = ids
    _, _, embeds, mask = tts.prefix(spk, emo, 1.0, text_ids, len(ids))
    sampling = tts._sampling({"min_new_tokens": DECODE_STEPS})

    def run():
        with torch.inference_mode():
            generate_beam(tts.gpt_params, tts.cfg.gpt, tts.gpt_dims, embeds, mask,
                          tts.generator, DECODE_STEPS + 1, sampling, tts.dtype)
        torch.cuda.synchronize()

    walls = []
    for _ in range(PROFILE_UNPROFILED_RUNS):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        _spin_pad(launches=PROFILE_WARMUP_LAUNCHES, seconds=0)
        prof.step()
        _spin_pad(launches=0)
        reset_counts()
        run()
        counts = read_counts()
        _spin_pad()
        prof.step()
    t_parse = time.perf_counter()
    pads: list = []
    by_name, spans = device_records(prof, pads=pads)
    busy_ns = union_ns(spans)
    t_parse = time.perf_counter() - t_parse
    device = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    kernels = [(k, v) for k, v in device if not k.startswith(("Memcpy", "Memset"))]
    device_s = sum(ns for _, (_, ns) in device) / 1e9
    launches = sum(n for _, (n, _) in kernels)

    def recorded(name):
        return sum(n for k, (n, _) in kernels if name in k)

    # each scorer step (the prefill's and the 399 decode steps') calls
    # torch.topk twice: the top-k warper and the candidate draw
    got = {"step": recorded("decode_step_kernel"), "gemv": recorded("int8_gemv_kernel"),
           "attention": recorded("decode_attention_kernel"),
           "allreduce": recorded("tp_allreduce_kernel"), "topk": recorded("gatherTopK")}
    # K1 and K6 co-located: one persistent launch a step (one kernel, its TP
    # variant for K6); one GEMV launch a matvec, two an MLP
    want = {"step": counts["fused_decode_step"] + counts["fused_decode_step_tp"],
            "gemv": counts["int8_matvec"] + counts["int4_matvec"]
            + 2 * (counts["int8_mlp"] + counts["int4_mlp"]),
            "attention": counts["decode_attention"] + counts["decode_attention_kvq"],
            "allreduce": counts["tp_allreduce"], "topk": 2 * (DECODE_STEPS + 1)}
    print(f"{label} decode profile ({DECODE_STEPS} steps): wall {min(walls):.4f} s unprofiled "
          f"(runs {', '.join(f'{w:.4f}' for w in walls)}), device time {device_s:.4f} s (sum over "
          f"records), busy {busy_ns / 1e9:.4f} s = {100 * busy_ns / 1e9 / min(walls):.1f} % "
          f"(union over streams), {launches} launches "
          f"({launches / DECODE_STEPS:.0f} per step); recorded launches {got}, counters "
          f"{want}; profiled window and records read in {time.perf_counter() - t_prof:.1f} s "
          f"(reading {t_parse:.1f} s); {pads_kept(pads, spans)} [{card}]", flush=True)
    for key, (n, ns) in device[:6]:
        print(f"    {ns / 1e6:9.2f} ms {n:7d} x  {key[:90]}", flush=True)
    assert got == want, f"{label} profile recorded {got}, the counters say {want}"


def pipeline_phase(card: str, prompt: str, model_dir: str) -> dict:
    """The bf16 pass (the first slice's main path): two requests."""
    import torch

    from indextts_tpu_torch.models.vocoder.bigvgan import activation1d_calls
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    t0 = time.perf_counter()
    tts = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"bf16 model build (random weights, shipped widths): "
          f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    n_tok = len(tts.tokenizer.split_segments(tts.tokenizer.tokenize(SENTENCE), 120))
    assert n_tok == 1, f"smoke text must be one segment, got {n_tok}"

    reset_counts()
    run_requests(tts, prompt, BF16_REQUESTS, card, "bf16")
    counts = read_counts()
    cfg = tts.cfg
    want_k2 = BF16_REQUESTS * cfg.s2mel.DiT.depth * 25   # depth x CFG-stacked Euler steps
    want_k3 = BF16_REQUESTS * activation1d_calls(cfg.bigvgan)
    print(f"launches over {BF16_REQUESTS} bf16 requests: {counts} (expect attention_rope and "
          f"its rope pass rope_qk {want_k2}, antialias_snake {want_k3})", flush=True)
    assert counts["attention_rope"] == counts["rope_qk"] == want_k2, counts
    assert counts["antialias_snake"] == want_k3, counts
    assert counts["fused_decode_step"] == 0 and counts["kv_gathers"] > 0, counts
    reference_check(tts, card)
    profile_s2mel(tts, prompt, card, "bf16 (DiT packed tier, K2)")
    profile_decode(tts, prompt, card, "bf16")
    del tts
    torch.cuda.empty_cache()
    return counts


def want_counts(tts, quantization: str, n: int) -> dict:
    """The launches ``n`` requests of a quantized pass must make: K1 once a
    decode step (under the tp mesh, both shards on this card, K6 once a
    decode step), and none of the standalone GEMV, attention or
    `tp_allreduce` kernels; K2 / K3
    (and K2's rope pass) as in the bf16 pass, K2 once a DiT shard under the
    tp mesh; no bf16 step, no cache gather, no cache growth
    (the beam engine sizes its cache once), and none of the kernels without
    a caller on this path."""
    from indextts_tpu_torch.models.vocoder.bigvgan import activation1d_calls

    steps = n * DECODE_STEPS
    tp = tts.mesh is not None
    k2 = n * tts.cfg.s2mel.DiT.depth * 25 * (tts.mesh.tp if tp else 1)   # once a DiT shard
    return {"attention_rope": k2,
            "rope_qk": k2,                                     # K2's rope pass
            "antialias_snake": n * activation1d_calls(tts.cfg.bigvgan),
            "fused_decode_step": 0 if tp else steps, "fused_decode_step_tp": steps if tp else 0,
            "tp_allreduce": 0, "int8_matvec": 0, "int8_mlp": 0, "int4_matvec": 0,
            "int4_mlp": 0, "decode_attention": 0, "decode_attention_kvq": 0,
            "single_block_attention": 0, "packed_pair_attention": 0,
            "fused_antialias_activation": 0, "antialias_activation_prefolded": 0,
            "gpt2_decode_step": 0, "gpt2_chunk_step": 0, "kv_gathers": 0, "span_growths": 0}


def k1_twin_check():
    """A ``decode_check`` hook that holds the first 8 K1 calls against the
    twin on the same inputs, layer by layer (`twin_by_layer`), and puts the
    24-layer chain of the twin with f32 and with f64 sums beside it; and
    the ``site`` dict it fills (``groups`` records every call's group and
    whether it had an ancestry map)."""
    site = {"n": 0, "layer": 0.0, "hidden": 0.0, "rows_exact": True, "chain": 0.0,
            "floor": 0.0, "groups": set()}

    def check(args, h):
        site["groups"].add((args["group"], args["anc"] is not None))
        if site["n"] >= TWIN_CHECKED_STEPS:
            return
        site["n"] += 1
        tw = twin_by_layer(args, h)
        for key in ("layer", "hidden"):
            site[key] = max(site[key], tw[key])
        site["rows_exact"] &= tw["rows_exact"]
        chains = twin_chains(args)
        site["chain"] = max(site["chain"], rel_l2(h, chains[0]))
        site["floor"] = max(site["floor"], rel_l2(chains[1], chains[0]))

    return site, check


def twin_chains(args) -> list:
    """The 24-layer chain of the twin on K1's call ``args`` (its own copy of
    the cache), with f32 and with f64 sums: the hidden state after ln_f of
    each (the second against the first is the chain's noise floor)."""
    from indextts_tpu_torch import nn
    from indextts_tpu_torch.ops.decode_step import TWINS, decode_layer

    kv = args["kv_cache"]
    rest = dict(heads=args["dims"].heads, pos=args["pos"], kv_valid=args["kv_valid"],
                anc=args["anc"], group=args["group"])
    chains = []
    for ops in (TWINS, _f64_twins()):
        x, twin = args["x"], {k: t.clone() for k, t in kv.items()}
        for li, lp in enumerate(args["params"]["h"]):
            x = decode_layer(ops, lp, x, ck=twin["k"][li], cv=twin["v"][li],
                             kvs=twin["kvs"][li] if "kvs" in twin else None, **rest)
        chains.append(nn.layer_norm(args["params"]["ln_f"], x))
    return chains


def report_k1_twin_check(site: dict, label: str, card: str) -> None:
    print(f"{label} twin check of the first {site['n']} K1 calls, layer by layer on the "
          f"kernel path's inputs: layer outputs rel_l2 <= {site['layer']:.3e}, hidden after "
          f"ln_f {site['hidden']:.3e}, written rows bit-identical to the twin's write of the "
          f"kernel's qkv: {site['rows_exact']}; the 24-layer chain of the twin: "
          f"{site['chain']:.3e} "
          f"(noise floor, twin with f64 against f32 sums: {site['floor']:.3e}) [{card}]",
          flush=True)
    assert site["n"] == TWIN_CHECKED_STEPS, site
    assert site["layer"] <= K1_REL_L2 and site["hidden"] <= K1_REL_L2, site
    assert site["rows_exact"], site


def quant_pipeline_phase(card: str, prompt: str, model_dir: str, quantization: str,
                         n_requests: int, profiled: bool) -> dict:
    """A quantized pass (int8, int8kv, int4 or int4kv): ``n_requests``
    requests through K1 with the ancestry map; the first 8 K1 calls held
    against the twin at the call site."""
    import torch

    from indextts_tpu_torch.engine import beam
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    t0 = time.perf_counter()
    tts = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cuda", seed=0,
                    quantization=quantization)
    torch.cuda.synchronize()
    print(f"{quantization} model build (random weights, shipped widths): "
          f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    site, check = k1_twin_check()
    reset_counts()
    tts.decode_check = check
    reports = run_requests(tts, prompt, 1, card, f"{quantization} (first 8 K1 steps twin-checked)")
    tts.decode_check = None
    reports += run_requests(tts, prompt, n_requests - 1, card, quantization)
    counts = read_counts()
    want = want_counts(tts, quantization, n_requests)
    print(f"launches over {n_requests} {quantization} requests: {counts} (expect {want}); "
          f"ancestry route: {beam.last_use_anc}", flush=True)
    report_k1_twin_check(site, quantization, card)
    assert counts == want, (counts, want)
    assert beam.last_use_anc is True and site["groups"] == {(3, True)}, site["groups"]
    if profiled:
        profile_decode(tts, prompt, card, quantization)
    del tts
    torch.cuda.empty_cache()
    return counts, reports


CKPT_BYTES = 7.0e9                         # the f32 model directory's size, about


def _state_leaves(tts) -> dict:
    """Every leaf of a pipeline's loaded state by its path."""
    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from walk(v, f"{path}/{i}")
        else:
            yield path, tree

    state = {"gpt": tts.gpt_params, "s2mel": tts.s2mel_params, "codec": tts.codec_params,
             "campplus": tts.campplus_params, "bigvgan": tts.bigvgan_params,
             "w2v": tts.w2v_params, "w2v_mean": tts.w2v_mean, "w2v_std": tts.w2v_std,
             "emo_matrix": tts.emo_matrix, "spk_matrix": tts.spk_matrix}
    return dict(walk(state, ""))


def compare_loaded(loaded, ref) -> int:
    """Every leaf of ``loaded`` bit-identical to ``ref``'s; returns their count."""
    import torch

    a, b = _state_leaves(loaded), _state_leaves(ref)
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))[:10]
    for path, x in a.items():
        y = b[path]
        assert x.dtype == y.dtype and x.shape == y.shape, (path, x.dtype, y.dtype)
        assert torch.equal(x, y), path
    return len(a)


def checkpoint_phase(card: str, prompt: str, model_dir: str, d: str, int8_st=None) -> dict:
    """The checkpoint pass: the int8 pass's random-weight model (seed 0)
    written as a released model directory ``d``, read back, and served
    (the emotion-text pass then serves ``d`` too). The
    weight-norm pairs are written as g = ||v||, v = w with the few elements
    nudged whose fold would round to another bf16 value
    (`tools/torch_reference_ckpt.py::match_fold`), so every loaded leaf is
    the random model's bit for bit: left as they fold, 1-ulp differences
    in the vocoder's and DiT's weights move the bf16 vocoder's wav by
    rel-L2 5e-3 (`tools/torch_ckpt_fold_probe.py`)."""
    import shutil

    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import torch_reference_ckpt as refckpt

    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    usage = shutil.disk_usage(d)
    need = CKPT_BYTES + QWEN_BYTES
    print(f"checkpoint pass: {d} has {usage.free} bytes free of {usage.total} (the model "
          f"directory and the emotion-text pass's Qwen3 need about {need:.0f})", flush=True)
    assert usage.free >= 1.2 * need, f"too little room under {d} for the model directory"
    t_pass = time.perf_counter()
    ref = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cuda", seed=0,
                    quantization="int8")
    t0 = time.perf_counter()
    trees = ref.random_params(0)
    H = ref.cfg.w2v_bert.hidden_size
    trees["w2v_mean"], trees["w2v_std"] = np.zeros(H, np.float32), np.ones(H, np.float32)
    written = refckpt.write_model_dir(
        d, trees, ref.cfg, wrapped=True, match_dtype=ref.dtype,
        log=lambda p, n, s: print(f"  wrote {p}: {n} bytes in {s:.2f} s", flush=True))
    del trees
    torch.cuda.empty_cache()
    build_fake_assets(d)
    nudged = written.pop("nudged")
    total = sum(written.values())
    print(f"checkpoint pass: model directory written in the released layout, {total} bytes "
          f"in {len(written)} files, {time.perf_counter() - t0:.2f} s; {nudged} weight_v "
          f"elements nudged by an f32 ulp so that the fold's bf16 cast is the model's",
          flush=True)
    t0 = time.perf_counter()
    tts = IndexTTS2(cfg_path=os.path.join(d, "config.yaml"), model_dir=d, device="cuda",
                    quantization="int8", allow_random_init=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in tts.load_report:
        print(f"  loaded {r['family']} from {os.path.relpath(r['path'], d)}: {r['bytes']} "
              f"bytes, read {r['read_s']:.3f} s, convert {r['convert_s']:.3f} s, place "
              f"{r['place_s']:.3f} s [{card}]", flush=True)
    print(f"checkpoint pass: IndexTTS2(cfg_path=<dir>/config.yaml, model_dir=<dir>, "
          f"quantization='int8', allow_random_init=False) built in {wall:.2f} s "
          f"[{card}]", flush=True)
    assert [r["family"] for r in tts.load_report] == [
        "gpt", "s2mel", "codec", "campplus", "bigvgan", "w2v", "w2v_stat", "matrices"]
    assert tts.cfg == ref.cfg, "config.yaml did not give the config back"
    print(f"checkpoint pass: all {compare_loaded(tts, ref)} loaded leaves bit-identical "
          f"to the random-weight int8 model's", flush=True)

    def request(model):
        kept = {}
        decode = model.decode

        def run(*args, **kwargs):
            kept["codes"], kept["lens"] = decode(*args, **kwargs)
            return kept["codes"], kept["lens"]

        model.decode = run
        model.generator.manual_seed(1234)
        sr, wav = model.infer(spk_audio_prompt=prompt, text=SENTENCE, output_path=None,
                              max_mel_tokens=400, min_new_tokens=399, num_beams=3,
                              do_sample=False)
        del model.decode
        st = dict(model.last_stage_times)
        assert st["codes"] == 400 and np.all(np.isfinite(wav)), st
        return kept["codes"][0, :400].cpu(), wav.astype(np.float64), st

    request(tts)                                   # warm: the prompt cache, the kernels
    request(ref)
    reset_counts()
    codes, wav, st = request(tts)
    counts = read_counts()
    ref_codes, ref_wav, ref_st = request(ref)
    rel = float(np.linalg.norm(wav - ref_wav) / np.linalg.norm(ref_wav))
    want = want_counts(tts, "int8", 1)
    print(f"checkpoint pass: one num_beams=3, do_sample=False request on each model: codes "
          f"token-equal {bool(torch.equal(codes, ref_codes))}, wav rel_l2 {rel:.3e} (<= 1e-3); "
          f"launches of the loaded model's request {counts} (expect {want})", flush=True)
    for label, x in (("loaded", st), ("random-weight", ref_st),
                     ("int8 pass (sampling, beams=3)", int8_st or {})):
        if not x:
            continue
        print(f"  {label} int8 request: " + " ".join(
            f"{k}={x[k]:.4f}s" for k in ("prompt", "gpt", "gpt_forward", "s2mel", "bigvgan",
                                         "total")) + f" RTF={x['rtf']:.4f} [{card}]", flush=True)
    assert torch.equal(codes, ref_codes), "codes differ between the loaded and the random model"
    assert rel <= 1e-3, rel
    assert counts == want, (counts, want)
    del tts, ref
    torch.cuda.empty_cache()
    print(f"checkpoint pass: {time.perf_counter() - t_pass:.1f} s in all [{card}]", flush=True)
    return counts


def qwen_state_dict(tree: dict, c) -> dict:
    """The HF Qwen3ForCausalLM state dict of a `models/qwen.py` tree (the
    inverse of `convert_qwen`: per-layer keys, (out, in) kernels)."""
    names = {"input_ln": "input_layernorm", "post_ln": "post_attention_layernorm",
             "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
             "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
             "q_norm": "self_attn.q_norm", "k_norm": "self_attn.k_norm",
             "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
             "down_proj": "mlp.down_proj"}
    sd = {"model.embed_tokens.weight": tree["embed"], "model.norm.weight": tree["final_ln"]}
    for key, hf in names.items():
        for i in range(c.num_hidden_layers):
            w = tree["layers"][key][i]
            sd[f"model.layers.{i}.{hf}.weight"] = w.t() if w.ndim == 2 else w
    if "lm_head" in tree:
        sd["lm_head.weight"] = tree["lm_head"]
    return sd


def write_qwen_dir(d: str, card: str):
    """A Qwen3-0.6B classifier directory at the published widths (the
    `QwenConfig` defaults): config.json, model.safetensors (random weights
    from seed 0, drawn on the card, stored in bf16) and a synthetic
    tokenizer.json whose ids cover the whole vocab (the Qwen3 added tokens
    at their published ids) with its tokenizer_config.json. Returns (the
    config, the bf16 tree as written)."""
    import dataclasses

    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import torch_reference_ckpt as refckpt

    from indextts_tpu_torch.models.qwen import QwenConfig, init_qwen
    from indextts_tpu_torch.nn import InitRng
    from indextts_tpu_torch.text.qwen_tokenizer import build_tokenizer_json

    t0 = time.perf_counter()
    os.makedirs(d)
    c = QwenConfig()
    tree = init_qwen(InitRng(0, "cuda"), c)
    tree = {k: ({kk: vv.to(torch.bfloat16) for kk, vv in v.items()} if isinstance(v, dict)
                else v.to(torch.bfloat16)) for k, v in tree.items()}
    hf = dict(dataclasses.asdict(c), architectures=["Qwen3ForCausalLM"], model_type="qwen3",
              hidden_act="silu", bos_token_id=151643, max_position_embeddings=40960,
              torch_dtype="bfloat16")
    with open(os.path.join(d, "config.json"), "w", encoding="utf-8") as f:
        json.dump(hf, f, indent=2)
    n_weights = refckpt.save_safetensors(qwen_state_dict(tree, c),
                                         os.path.join(d, "model.safetensors"))
    tj = build_tokenizer_json(QWEN_CORPUS, c.vocab_size)
    with open(os.path.join(d, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(tj, f, ensure_ascii=False)
    with open(os.path.join(d, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"tokenizer_class": "Qwen2Tokenizer", "clean_up_tokenization_spaces": False,
                   "eos_token": "<|im_end|>", "pad_token": "<|endoftext|>"}, f)
    n_params = sum(v.numel() for v in tree["layers"].values()) + tree["embed"].numel() \
        + tree["final_ln"].numel()
    print(f"emotion-text pass: Qwen3-0.6B directory written ({n_params} parameters, "
          f"model.safetensors {n_weights} bytes in bf16; tokenizer.json "
          f"{len(tj['model']['vocab'])} ids, {len(tj['model']['merges'])} merges) in "
          f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    return c, tree


def emo_text_phase(card: str, prompt: str, d: str) -> dict:
    """The emotion-text pass on the checkpoint pass's released directory
    ``d``: the Qwen3-0.6B classifier written at ``d/<qwen_emo_path>``, then
    a bf16 `IndexTTS2` read from ``d``:
    - the classifier's load seconds (every loaded leaf bit-identical to the
      tree written), the prompt's token count, the bf16 prefill ms (CUDA
      events) and the greedy decode's steps and ms a step, its device busy
      share (`profile_busy`), the emotion dict;
    - the f32 prefill logits (the written bf16 weights in f32, TF32 off) on
      the card against the host CPU: rel-L2 <= QWEN_F32_REL_L2, held; the
      first QWEN_CHECK_TOKENS f32 greedy tokens equal, held; the bf16
      logits against the f32 ones, printed;
    - one request with ``use_emo_text=True`` and ``emo_text``, pinned to 400
      codes: its stage seconds and RTF, the classifier inside its prompt
      stage, K2 / K3 as one bf16 request launches them;
    - the CLI, ``python -m indextts_tpu_torch.cli_v2 synth --emotion-text
      ... --model-dir d`` in a subprocess at its defaults (num_beams=3, up
      to 1500 codes): exit code 0 and the wav written.
    Returns the request's launches."""
    import torch

    from indextts_tpu_torch import cli_v2
    from indextts_tpu_torch.models import qwen as qm
    from indextts_tpu_torch.models.vocoder.bigvgan import activation1d_calls
    from indextts_tpu_torch.pipeline import emotion as te
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    t_pass = time.perf_counter()
    t0 = time.perf_counter()
    tts = IndexTTS2(cfg_path=os.path.join(d, "config.yaml"), model_dir=d, device="cuda")
    torch.cuda.synchronize()
    print(f"emotion-text pass: bf16 IndexTTS2 read from the model directory in "
          f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    qe = tts.qwen_emo
    c, tree = write_qwen_dir(qe.model_dir, card)
    t0 = time.perf_counter()
    qe._load()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    assert qe.qwen_cfg == c and qe.dtype == torch.bfloat16
    assert torch.equal(qe.model["embed"], tree["embed"])
    assert all(torch.equal(qe.model["layers"][k], v) for k, v in tree["layers"].items())
    del tree
    ids = qe.prompt_ids(EMO_TEXT)
    mask = torch.ones_like(ids)
    P, N = ids.shape[1], te.MAX_NEW_TOKENS
    prefill_ms = time_ms(lambda: qm.qwen_prefill(qe.model, c, ids, mask, P + N), iters=5)
    steps = []
    step = qm.qwen_decode_step

    def counted(*a, **k):
        steps.append(1)
        return step(*a, **k)

    qm.qwen_decode_step = counted
    try:                    # two unprofiled decodes, then a profiled one
        busy, wall = profile_busy(lambda: qm.qwen_generate_greedy(qe.model, c, ids, mask, N),
                                  card, "emotion-text pass: Qwen3 greedy decode (bf16)")
    finally:
        qm.qwen_decode_step = step
    assert len(steps) % 3 == 0, len(steps)
    n_steps = len(steps) // 3
    print(f"emotion-text pass: Qwen3-0.6B (bf16) loaded in {load_s:.3f} s; prompt {P} tokens; "
          f"prefill {prefill_ms:.3f} ms; greedy decode {n_steps} steps (of {N - 1}), "
          f"{1e3 * wall:.1f} ms of wall, {(1e3 * wall - prefill_ms) / max(n_steps, 1):.3f} ms a "
          f"step, busy {100 * busy:.1f} % [{card}]", flush=True)

    t0 = time.perf_counter()
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32

    def f32(tree, device):
        return {k: ({kk: vv.to(device).float() for kk, vv in v.items()} if isinstance(v, dict)
                    else v.to(device).float()) for k, v in tree.items()}

    w32, w32_cpu = f32(qe.model, "cuda"), f32(qe.model, "cpu")
    with torch.inference_mode():
        l_card = qm.qwen_prefill(w32, c, ids, mask, P + 1, torch.float32)[0]
        l_cpu = qm.qwen_prefill(w32_cpu, c, ids.cpu(), mask.cpu(), P + 1, torch.float32)[0]
        l_bf16 = qm.qwen_prefill(qe.model, c, ids, mask, P + 1)[0]
    rel = rel_l2(l_card.cpu(), l_cpu)
    rel_bf16 = rel_l2(l_bf16.cpu(), l_card.cpu())
    t_card = qm.qwen_generate_greedy(w32, c, ids, mask, QWEN_CHECK_TOKENS, torch.float32)[0]
    t_cpu = qm.qwen_generate_greedy(w32_cpu, c, ids.cpu(), mask.cpu(), QWEN_CHECK_TOKENS,
                                    torch.float32)[0]
    print(f"emotion-text pass: f32 prefill logits, card vs host CPU (TF32 off): rel_l2 "
          f"{rel:.3e} (<= {QWEN_F32_REL_L2:g}); first {QWEN_CHECK_TOKENS} f32 greedy tokens "
          f"card {t_card[0].tolist()} host {t_cpu[0].tolist()}; bf16 logits vs f32: rel_l2 "
          f"{rel_bf16:.3e} (printed, not held); {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    assert rel <= QWEN_F32_REL_L2, rel
    assert torch.equal(t_card.cpu(), t_cpu), (t_card, t_cpu)
    del w32, w32_cpu

    dicts = []
    infer_emo = qe.inference
    qe.inference = lambda text: dicts.append(infer_emo(text)) or dicts[-1]
    reset_counts()
    run_requests(tts, prompt, 1, card, "emotion-text (bf16, use_emo_text)", use_emo_text=True,
                 emo_text=EMO_TEXT)
    counts = read_counts()
    del qe.inference
    assert len(dicts) == 1 and list(dicts[0]) == te.EMOTION_KEYS, dicts
    print(f"emotion-text pass: the request's emotion dict of {EMO_TEXT!r}: {dicts[0]}",
          flush=True)
    want_k2, want_k3 = tts.cfg.s2mel.DiT.depth * 25, activation1d_calls(tts.cfg.bigvgan)
    print(f"launches of the emotion-text request: {counts} (expect attention_rope and rope_qk "
          f"{want_k2}, antialias_snake {want_k3}, no K1)", flush=True)
    assert counts["attention_rope"] == counts["rope_qk"] == want_k2, counts
    assert counts["antialias_snake"] == want_k3 and counts["fused_decode_step"] == 0, counts
    del tts, qe
    torch.cuda.empty_cache()

    from pathlib import Path
    missing = cli_v2._missing_model_files(Path(d))
    assert missing == [], missing
    out = os.path.join(d, "cli.wav")
    env = dict(os.environ, XDG_CONFIG_HOME=os.path.join(d, "xdg_config"),
               XDG_DATA_HOME=os.path.join(d, "xdg_data"))
    cmd = [sys.executable, "-m", "indextts_tpu_torch.cli_v2", "synth", "--text", SENTENCE,
           "--voice", prompt, "--emotion-text", EMO_TEXT, "--output", out, "--model-dir", d,
           "--verbose"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)), env=env)
    cli_s = time.perf_counter() - t0
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith((">> ", "detected", "Gen"))]
    print("emotion-text pass: cli_v2 synth --emotion-text (bf16, its default num_beams=3, up to "
          f"1500 codes): exit {res.returncode} in {cli_s:.1f} s of wall [{card}]\n  "
          + "\n  ".join(lines[-4:]), flush=True)
    assert res.returncode == 0, res.stderr[-4000:]
    with wave.open(out, "rb") as w:
        n, sr = w.getnframes(), w.getframerate()
    assert sr == 22050 and n > 0, (sr, n)
    print(f"emotion-text pass: the CLI wrote {n} samples ({n / sr:.2f} s); the pass took "
          f"{time.perf_counter() - t_pass:.1f} s [{card}]", flush=True)
    return counts


def tp_twin_check():
    """A ``decode_check`` hook that holds the first 8 K6 calls against the
    twin layer by layer (`tp_twin_by_layer`), and the ``site`` dict it
    fills (``groups``: every call's group and whether it had an ancestry
    map)."""
    site = {"n": 0, "layer": 0.0, "hidden": 0.0, "streams_equal": True, "rows_exact": True,
            "groups": set()}
    full: dict = {}

    def check(args, h):
        site["groups"].add((args["group"], args["anc"] is not None))
        if site["n"] >= TWIN_CHECKED_STEPS:
            return
        site["n"] += 1
        if not full:
            full["layers"] = [full_c_attn(args["params"], li)
                              for li in range(len(args["params"]["shards"][0]))]
        tw = tp_twin_by_layer(args, h, full["layers"])
        for key in ("layer", "hidden"):
            site[key] = max(site[key], tw[key])
        for key in ("streams_equal", "rows_exact"):
            site[key] &= tw[key]

    return site, check


def tp_pipeline_phase(card: str, prompt: str, model_dir: str, int8_gpt: float) -> dict:
    """The tp=2 int8 serving decode, both shards on this card:
    `IndexTTS2(quantization="int8", mesh=make_mesh(["cuda:0", "cuda:0"]))`
    under INDEXTTS_TP_DECODE=kernel. One num_beams=3 request, its first 8 K6
    calls held against the twin layer by layer (`tp_twin_check`), then one
    num_beams=1 request; each with exact launch counts (K6 once a decode
    step); the gpt stage beside the int8 pass's (``int8_gpt``, its second
    request); a profiled tp decode. Returns the counts of each request."""
    import torch

    from indextts_tpu_torch.engine import beam, decode
    from indextts_tpu_torch.parallel.mesh import make_mesh
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    saved = os.environ.get("INDEXTTS_TP_DECODE")
    os.environ["INDEXTTS_TP_DECODE"] = "kernel"
    try:
        t0 = time.perf_counter()
        tts = IndexTTS2(cfg_path=None, model_dir=model_dir, seed=0, quantization="int8",
                        mesh=make_mesh(list(TP_DEVICES)))
        torch.cuda.synchronize()
        print(f"tp model build ({tts.mesh}, random weights, shipped widths): "
              f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
        site, check = tp_twin_check()
        reset_counts()
        tts.decode_check = check
        beams = run_requests(tts, prompt, 1, card, "tp int8 (first 8 K6 steps twin-checked)")[0]
        tts.decode_check = None
        counts = {"tp": read_counts()}
        want = want_counts(tts, "int8", 1)
        print(f"launches of the tp num_beams=3 request: {counts['tp']} (expect {want}); ancestry "
              f"route: {beam.last_use_anc}; K6 calls (group, ancestry map): {site['groups']}",
              flush=True)
        print(f"tp twin check of the first {site['n']} K6 calls, layer by layer on the kernel "
              f"path's inputs: layer outputs rel_l2 <= {site['layer']:.3e}, hidden after ln_f "
              f"{site['hidden']:.3e}, residual streams bit-identical: {site['streams_equal']}, "
              f"written rows bit-identical to K1's qkv kernel: {site['rows_exact']} [{card}]",
              flush=True)
        assert site["n"] == TWIN_CHECKED_STEPS, site
        assert site["layer"] <= K1_REL_L2 and site["hidden"] <= K1_REL_L2, site
        assert site["streams_equal"] and site["rows_exact"], site
        assert counts["tp"] == want, (counts["tp"], want)
        assert beam.last_use_anc is True and site["groups"] == {(3, True)}, site["groups"]

        reset_counts()
        sampling = run_requests(tts, prompt, 1, card, "tp int8 num_beams=1", num_beams=1)[0]
        counts["tp_sampling"] = read_counts()
        want["span_growths"] = 1
        print(f"launches of the tp num_beams=1 request: {counts['tp_sampling']} (expect {want}); "
              f"decode route {decode.last_route}", flush=True)
        assert counts["tp_sampling"] == want and decode.last_route == "tp", counts
        print(f"gpt stage: tp num_beams=3 {beams['gpt']:.4f} s, tp num_beams=1 "
              f"{sampling['gpt']:.4f} s, against the int8 pass's num_beams=3 request "
              f"{int8_gpt:.4f} s: {beams['gpt'] / int8_gpt:.3f}x [{card}]", flush=True)
        profile_decode(tts, prompt, card, "tp")
    finally:
        if saved is None:
            del os.environ["INDEXTTS_TP_DECODE"]
        else:
            os.environ["INDEXTTS_TP_DECODE"] = saved
    del tts
    torch.cuda.empty_cache()
    return counts


def spec_want(want: dict, stats: list, steps: int = DECODE_STEPS) -> dict:
    """``want`` with the launches of speculative decodes of ``steps`` steps
    each whose `last_spec_stats` are ``stats``: K1 once a step that no
    verify committed (the single steps, and the plain loop's steps after a
    demotion, which the stats do not count), the chunk step once a
    verify."""
    return {**want, "fused_decode_step": sum(steps - s[2] for s in stats),
            "gpt2_chunk_step": sum(s[1] for s in stats)}


def record_decodes(tts) -> list:
    """Wrap ``tts.decode``: each call appends (codes on the host, lengths,
    the call's `last_spec_stats` or None) to the returned list. ``del
    tts.decode`` unwraps."""
    seen = []
    orig = tts.decode

    def decode(*args, **kwargs):
        tts.last_spec_stats = None
        codes, lens = orig(*args, **kwargs)
        seen.append((codes.cpu(), np.asarray(lens), tts.last_spec_stats))
        return codes, lens

    tts.decode = decode
    return seen


def sampling_pipeline_phase(card: str, prompt: str, model_dir: str) -> dict:
    """The num_beams=1 decode of one segment with int8 weights, two requests
    pinned to 400 codes: the JAX pipeline's default there, the self-gating
    speculative decoder (`engine/speculative.py::generate_spec_adaptive`),
    whose cache grows once (the 256-code span, then 400). Request 1, on
    the packed DiT tier: K1 once a single step, every call at group=1
    without an ancestry map, the first 8 held against the twin layer by
    layer; the chunk step once a verify (`last_spec_stats`); the bf16 step
    and the beam engine never run; one span growth.
    Request 2 with INDEXTTS_PACKED_ATTN=0, the DiT's flash tier: the same,
    with K4 once per DiT layer and CFG step and K2 never; then every K4
    call of the DiT on a small input against its twin. Returns the counts
    of each request."""
    import torch

    from indextts_tpu_torch.engine import beam, decode
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    t0 = time.perf_counter()
    tts = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cuda", seed=0,
                    quantization="int8")
    torch.cuda.synchronize()
    print(f"int8 model build for the sampling pass: {time.perf_counter() - t0:.2f} s [{card}]",
          flush=True)
    dit_calls = tts.cfg.s2mel.DiT.depth * 25            # depth x CFG-stacked Euler steps
    site, check = k1_twin_check()
    beam.last_use_anc = None
    reset_counts()
    tts.decode_check = check
    packed = run_requests(tts, prompt, 1, card, "int8 num_beams=1 (packed DiT tier; first 8 K1 "
                          "steps twin-checked)", num_beams=1)[0]
    tts.decode_check = None
    counts = {"sampling": read_counts()}
    want = spec_want(want_counts(tts, "int8", 1), [tts.last_spec_stats])
    want["span_growths"] = 1
    print(f"launches of the num_beams=1 request: {counts['sampling']} (expect {want}); decode "
          f"route {decode.last_route}, K1 calls (group, ancestry map): {site['groups']}; "
          f"speculative decode (gamma, chunk verifies, tokens they committed, single steps): "
          f"{tts.last_spec_stats}", flush=True)
    report_k1_twin_check(site, "int8 num_beams=1", card)
    assert counts["sampling"] == want, (counts["sampling"], want)
    assert decode.last_route == "fused" and site["groups"] == {(1, False)}, site["groups"]
    assert beam.last_use_anc is None                    # the beam engine never ran

    saved = os.environ.get("INDEXTTS_PACKED_ATTN")
    os.environ["INDEXTTS_PACKED_ATTN"] = "0"
    try:
        reset_counts()
        flash = run_requests(tts, prompt, 1, card, "int8 num_beams=1, DiT flash tier (K4)",
                             num_beams=1)[0]
        counts["flash"] = read_counts()
        want = spec_want(want, [tts.last_spec_stats])
        reference_check(tts, card, flash=True)
        profile_s2mel(tts, prompt, card, "int8 num_beams=1 (DiT flash tier, K4)", num_beams=1)
    finally:
        if saved is None:
            del os.environ["INDEXTTS_PACKED_ATTN"]
        else:
            os.environ["INDEXTTS_PACKED_ATTN"] = saved
    want.update(attention_rope=0, rope_qk=0, single_block_attention=dit_calls)
    print(f"launches of the flash-tier request: {counts['flash']} (expect {want}); s2mel stage "
          f"flash tier (K4) {flash['s2mel']:.4f} s against packed tier (K2) "
          f"{packed['s2mel']:.4f} s [{card}]", flush=True)
    assert counts["flash"] == want, (counts["flash"], want)
    del tts
    torch.cuda.empty_cache()
    return counts


def agree(a, b) -> int:
    """Leading tokens two code rows share, before their first difference."""
    a, b = np.asarray(a), np.asarray(b)
    n = min(len(a), len(b))
    diff = np.nonzero(a[:n] != b[:n])[0]
    return int(diff[0]) if len(diff) else n


def request_prefix(tts, prompt: str):
    """The one-segment request's prefix embeds and mask (SENTENCE)."""
    spk, emo = tts._prepare_spk_prompt(prompt), tts._prepare_emo_cond(prompt)
    ids = tts.tokenizer.convert_tokens_to_ids(tts.tokenizer.tokenize(SENTENCE))
    _, _, embeds, mask = tts.prefix(spk, emo, 1.0, tts._text_rows([ids]), len(ids))
    return embeds, mask


def profile_busy(run, card: str, label: str) -> tuple:
    """``run``'s unprofiled wall (the best of `PROFILE_UNPROFILED_RUNS`) and
    its device busy share under `torch.profiler` (device records only, spin pads inside the
    window as in `profile_decode`). Returns (the share, the wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    walls = []
    for _ in range(PROFILE_UNPROFILED_RUNS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        _spin_pad(launches=PROFILE_WARMUP_LAUNCHES, seconds=0)
        prof.step()
        _spin_pad(launches=0)
        run()
        _spin_pad()
        prof.step()
    pads: list = []
    by_name, spans = device_records(prof, pads=pads)
    busy = union_ns(spans) / 1e9
    launches = sum(n for k, (n, _) in by_name.items() if not k.startswith(("Memcpy", "Memset")))
    share = busy / min(walls)
    print(f"{label} profile: wall {min(walls):.4f} s unprofiled (runs "
          f"{', '.join(f'{w:.4f}' for w in walls)}), device busy {busy:.4f} s = "
          f"{100 * share:.1f} %, {launches} "
          f"launches; {pads_kept(pads, spans)} [{card}]", flush=True)
    return share, min(walls)


def chunk_against_steps(tts, embeds, mask, codes, card: str, label: str) -> dict:
    """`gpt2_chunk_step` over SPEC_GAMMA + 1 tokens (the prefill's token 0
    and the next SPEC_GAMMA of ``codes``) against single steps on copies of
    one cache, at two layouts: the decode's (the verify at step 1, pos0 =
    P + 2; the engines never write slot P + 1, the prefill filling [0, P])
    and a contiguous one (pos0 = P + 1). The single steps: the plain step
    (`gpt2_decode_step`, the chunk's own arithmetic at one row) and, for
    quantized weights, the decode route's K1 at group=1. Each position's
    hidden after ln_f is compared, and each layer on the chunk's own layer
    inputs and cache (the plain step's `cached_layer`, or K1's layer as its
    chain of kernels, `decode_layer(KERNELS)`, bit-identical to K1): every
    layer within SPEC_CHUNK_REL_L2 against the plain step and against K1 at
    both layouts (K1 attends exactly the kv_valid slots, as the chunk does,
    across the decode's unwritten slot too). Then how many of five calls on
    identical inputs repeat the first bit for bit (the single step, its
    first qkv product, its first attention, `cached_attention`), and of 200
    calls of that attention and of the library's fused attention on the
    same inputs (`nn.mha`: SDPA, which PyTorch hands to cuDNN for a masked
    attention; the decode no longer uses it), and a verify's and a
    single step's times (eager, CUDA events over the calls, host work
    included; and by graph replay) and their ratio beside the JAX gate's
    `spec_commit_ratio`."""
    import torch

    from indextts_tpu_torch import nn
    from indextts_tpu_torch.engine.decode import _prefill_state, decode_step
    from indextts_tpu_torch.engine.speculative import spec_commit_ratio
    from indextts_tpu_torch.models.gpt.gpt2 import (_cached_blocks, cached_layer, chunk_mask,
                                                    gpt2_chunk_step)
    from indextts_tpu_torch.ops.decode_step import KERNELS, decode_layer

    params, dims, dt = tts.gpt_params, tts.gpt_dims, tts.dtype
    gpt = params["gpt"]
    greedy = tts._sampling(dict(num_beams=1, do_sample=False))
    st = _prefill_state(params, tts.cfg.gpt, dims, embeds, mask, tts.generator,
                        DECODE_STEPS + 1, DECODE_STEPS + 1, greedy, dt)
    G1, P = SPEC_GAMMA + 1, embeds.shape[1]
    ids = torch.cat([st.tokens[0, :1], codes[0, 1:G1].to(st.tokens.device)])
    x = params["mel_embedding"]["weight"].to(dt)[ids] \
        + params["mel_pos_embedding"]["weight"][2:2 + G1].to(dt)
    routes = ["plain"] + (["fused"] if st.route == "fused" else [])

    def check(pos0):
        kv_c = {k: t.clone() for k, t in st.kv.items()}
        inputs: list = []
        h = _cached_blocks(gpt, x[None], dims, pos0, kv_c, chunk_mask(st.kv_valid, pos0, G1),
                           inputs)[0]
        out = {}
        for route in routes:
            kv, valid, errs = {k: t.clone() for k, t in st.kv.items()}, st.kv_valid.clone(), []
            for j in range(G1):
                valid[:, pos0 + j] = True
                errs.append(rel_l2(h[j:j + 1], decode_step(route, params, x[j:j + 1], dims,
                                                           pos0 + j, kv, valid)))
            layer = 0.0
            for j in range(G1):        # the chunk's layer inputs and cache below pos0 + j
                cache = {k: t.clone() for k, t in kv_c.items()}
                valid = st.kv_valid.clone()
                valid[:, pos0:pos0 + j + 1] = True
                for li, lp in enumerate(gpt["h"]):
                    xin = inputs[li][0, j:j + 1]
                    if route == "fused":
                        kvs = cache.get("kvs")
                        y = decode_layer(KERNELS, lp, xin, dims.heads, pos0 + j, cache["k"][li],
                                         cache["v"][li], valid,
                                         kvs=None if kvs is None else kvs[li])
                    else:
                        y = cached_layer(lp, xin[None], dims, pos0 + j, cache, li,
                                         valid[:, None, None, :])[0]
                    if li + 1 < len(inputs):
                        layer = max(layer, rel_l2(y, inputs[li + 1][0, j:j + 1]))
                    else:
                        layer = max(layer, rel_l2(nn.layer_norm(gpt["ln_f"], y), h[j:j + 1]))
            out[route] = (errs, layer)
        return out

    res = {"decode": check(P + 2), "contiguous": check(P + 1)}

    # the same call five times on identical inputs: how many of the last
    # four equal the first bit for bit (the step; its first qkv product; its
    # first attention, SDPA with the mask)
    def repeats(fn, n=5):
        outs = [fn() for _ in range(n)]
        return sum(torch.equal(outs[0], o) for o in outs[1:])

    from indextts_tpu_torch.models.gpt.gpt2 import _cache_layer, _heads, cached_attention

    v1 = st.kv_valid.clone()
    v1[:, P + 2] = True
    lp, xin = gpt["h"][0], x[:1, None]
    q = torch.chunk(nn.dense(lp["attn"]["c_attn"], nn.layer_norm(lp["ln_1"], xin)), 3, -1)[0]
    kc, vc = _cache_layer(st.kv, 0, dims.heads, dt)
    qh, kh, vh, m1 = _heads(q, dims), _heads(kc, dims), _heads(vc, dims), v1[:, None, None, :]
    same = {"step": repeats(lambda: decode_step(st.route, params, x[:1], dims, P + 2,
                                                {k: t.clone() for k, t in st.kv.items()}, v1)),
            "qkv": repeats(lambda: nn.dense(lp["attn"]["c_attn"], nn.layer_norm(lp["ln_1"], xin))),
            "attention": repeats(lambda: cached_attention(qh, kh, vh, m1)),
            "attention x200": repeats(lambda: cached_attention(qh, kh, vh, m1), 200),
            "library x200": repeats(lambda: nn.mha(qh, kh, vh, mask=m1), 200)}
    print(f"{label} repeats on identical inputs, bit-identical to the first: the {st.route} "
          f"single step {same['step']} of 4, its first qkv product {same['qkv']} of 4, its "
          f"first attention (cached_attention) {same['attention']} of 4 and "
          f"{same['attention x200']} of 199; the library's fused attention (SDPA, masked) on "
          f"the same inputs {same['library x200']} of 199 [{card}]", flush=True)
    assert same["attention x200"] == 199 and same["step"] == 4, same
    for layout, by_route in res.items():
        for route, (errs, layer) in by_route.items():
            print(f"{label} gpt2_chunk_step over {G1} tokens, {layout} layout, against {G1} "
                  f"{'K1' if route == 'fused' else 'plain'} single steps: hidden after ln_f "
                  f"rel_l2 a position {', '.join(f'{e:.2e}' for e in errs)}; layer by layer "
                  f"on the chunk's inputs <= {layer:.3e} [{card}]", flush=True)
            assert all(np.isfinite(errs)), errs
    assert all(layer <= SPEC_CHUNK_REL_L2 for by_route in res.values()
               for _, layer in by_route.values()), res

    kv_c = {k: t.clone() for k, t in st.kv.items()}
    valid = st.kv_valid.clone()
    valid[:, P + 2] = True
    pos0 = P + 2

    def single():
        decode_step(st.route, params, x[:1], dims, pos0, kv_c, valid)

    def chunk():
        gpt2_chunk_step(gpt, x[None], dims, pos0, kv_c, st.kv_valid)

    out = {"single_ms": time_ms(single, iters=20), "chunk_ms": time_ms(chunk, iters=20),
           "single_graph_ms": graph_ms(single, iters=5, replays=3),
           "chunk_graph_ms": graph_ms(chunk, iters=5, replays=3), "checks": res,
           "repeats": same}
    out.update(ratio=out["chunk_ms"] / out["single_ms"],
               graph_ratio=out["chunk_graph_ms"] / out["single_graph_ms"])
    print(f"{label} a verify of {G1} tokens {out['chunk_ms']:.4f} ms eager "
          f"({out['chunk_graph_ms']:.4f} by graph replay), a single step on the {st.route} "
          f"route {out['single_ms']:.4f} ({out['single_graph_ms']:.4f}): verify / single = "
          f"{out['ratio']:.3f} eager, {out['graph_ratio']:.3f} device, beside the JAX gate "
          f"spec_commit_ratio({SPEC_GAMMA}) = {spec_commit_ratio(SPEC_GAMMA):.2f} (a TPU fit) "
          f"[{card}]", flush=True)
    return out


def spec_phase(card: str, prompt: str, model_dir: str, quantization=None) -> tuple:
    """The speculative decoder at full width (bf16, or int8 weights): one
    num_beams=1 request pinned to 400 codes with speculation on (the
    default) and one with INDEXTTS_SPEC_DECODE=0, each from the generator
    seeded 0: `last_spec_stats`, gpt stage seconds, K1 / chunk / plain step
    counts (exact), and the tokens the two share before their first
    difference; a forced oracle decode (greedy, drafts = the sequential
    greedy decode's own codes, so chunks commit at full width) beside that
    sequential decode; `chunk_against_steps`; the speculative decode's
    device busy share. Returns (the counts of the spec-on request, the
    model)."""
    import torch

    from indextts_tpu_torch.engine import decode
    from indextts_tpu_torch.engine.speculative import generate_spec_adaptive
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    label = quantization or "bf16"
    tts = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cuda", seed=0,
                    quantization=quantization)
    # a short warm-up request: the prompt cache and the first calls' set-up
    # stay out of the two measured ones
    tts.infer(spk_audio_prompt=prompt, text=SENTENCE, output_path=None, num_beams=1,
              max_mel_tokens=20, min_new_tokens=19)
    seen = record_decodes(tts)
    saved = os.environ.get("INDEXTTS_SPEC_DECODE")
    runs = {}
    try:
        for mode, env in (("spec", None), ("plain", "0")):
            if env is None:
                os.environ.pop("INDEXTTS_SPEC_DECODE", None)
            else:
                os.environ["INDEXTTS_SPEC_DECODE"] = env
            tts.generator.manual_seed(0)
            reset_counts()
            st = run_requests(tts, prompt, 1, card, f"{label} num_beams=1, speculation "
                              f"{'on' if env is None else 'off'}", num_beams=1)[0]
            runs[mode] = (st, read_counts(), seen[-1][0][0].numpy(), seen[-1][2])
    finally:
        if saved is None:
            os.environ.pop("INDEXTTS_SPEC_DECODE", None)
        else:
            os.environ["INDEXTTS_SPEC_DECODE"] = saved
    del tts.decode
    (st_s, c_s, codes_s, stats), (st_p, c_p, codes_p, stats_p) = runs["spec"], runs["plain"]
    step_key = "fused_decode_step" if quantization else "gpt2_decode_step"
    n = agree(codes_s[:400], codes_p[:400])
    print(f"{label} speculative pass, num_beams=1 at 400 codes: on: last_spec_stats {stats} "
          f"(gamma, verifies, tokens they committed, single steps), gpt {st_s['gpt']:.4f} s, "
          f"K1 launches {c_s['fused_decode_step']}, plain steps {c_s['gpt2_decode_step']}, chunk "
          f"steps {c_s['gpt2_chunk_step']}; off: gpt {st_p['gpt']:.4f} s, K1 launches "
          f"{c_p['fused_decode_step']}, plain steps {c_p['gpt2_decode_step']}; {n} of 400 "
          f"tokens agree before the first difference [{card}]", flush=True)
    assert stats[0] == SPEC_GAMMA and stats_p is None, (stats, stats_p)
    # the speculative decoder keeps the sequential loop's stream: every token
    assert n == 400, f"{label}: speculation on and off share {n} of 400 tokens"
    assert c_s[step_key] == DECODE_STEPS - stats[2], (stats, c_s)
    assert c_s["gpt2_chunk_step"] == stats[1] and c_p["gpt2_chunk_step"] == 0, (c_s, c_p)
    assert c_p[step_key] == DECODE_STEPS and c_s["span_growths"] == 1, c_p

    embeds, mask = request_prefix(tts, prompt)
    n_orc = SPEC_ORACLE_CODES
    greedy = tts._sampling(dict(num_beams=1, do_sample=False, min_new_tokens=n_orc - 1))
    args = (tts.gpt_params, tts.cfg.gpt, tts.gpt_dims, embeds, mask, tts.generator, n_orc,
            greedy, tts.dtype)
    reset_counts()
    t0 = time.perf_counter()
    seq, _ = decode.generate_adaptive(*args)
    seq = seq.cpu()
    t_seq, c_seq = time.perf_counter() - t0, read_counts()
    reset_counts()
    t0 = time.perf_counter()
    orc, _, o_stats = generate_spec_adaptive(*args, gamma=SPEC_GAMMA, forced=True,
                                             draft_source=seq[0])
    orc = orc.cpu()
    t_orc, c_orc = time.perf_counter() - t0, read_counts()
    n = agree(orc[0].numpy(), seq[0].numpy())
    print(f"{label} forced oracle at {n_orc} codes (greedy; drafts = the sequential greedy "
          f"decode's own codes): stats {tuple(int(v) for v in o_stats)} (verifies, committed, "
          f"single steps; {o_stats[1] / max(o_stats[0], 1):.2f} a verify), {n} of {n_orc} "
          f"tokens agree with the "
          f"sequential decode before the first difference; decode wall {t_orc:.4f} s (K1 "
          f"{c_orc['fused_decode_step']}, plain {c_orc['gpt2_decode_step']}, chunk "
          f"{c_orc['gpt2_chunk_step']}) against the sequential {t_seq:.4f} s (K1 "
          f"{c_seq['fused_decode_step']}, plain {c_seq['gpt2_decode_step']}) [{card}]",
          flush=True)
    assert o_stats[0] > 0, o_stats
    assert c_orc["gpt2_chunk_step"] == o_stats[0], c_orc
    assert c_orc[step_key] == n_orc - 1 - o_stats[1], c_orc

    ratio = chunk_against_steps(tts, embeds, mask, seq, card, label)
    busy = None
    if quantization:        # bf16: the plain step's share, profiled in the bf16 pass
        sampling = tts._sampling(dict(num_beams=1, min_new_tokens=DECODE_STEPS))

        def run():
            with torch.inference_mode():
                generate_spec_adaptive(tts.gpt_params, tts.cfg.gpt, tts.gpt_dims, embeds,
                                       mask, tts.generator, DECODE_STEPS + 1, sampling,
                                       tts.dtype, gamma=SPEC_GAMMA)

        busy, _ = profile_busy(run, card, f"{label} speculative decode (sampling, 400 codes)")
    return {"spec": c_s, "ratio": ratio, "busy": busy}, tts


def aux_phase(tts, card: str, prompt: str) -> dict:
    """The aux decode modes on the int8 model, one request each, pinned to
    400 codes: diverse beam search (K1 at group=2 with the ancestry map,
    once a decode step), contrastive search and DoLa (the plain step on the
    int8 weights: once a step, the contrastive one over top_k rows). Stage
    seconds and exact launch counts. Returns the counts by request."""
    from indextts_tpu_torch.engine import beam

    counts = {}
    for label, kw in AUX_REQUESTS.items():
        reset_counts()
        beam.last_use_anc = None
        run_requests(tts, prompt, 1, card, f"int8 {label}", **kw)
        counts[label] = read_counts()
        want = want_counts(tts, "int8", 1)
        if label == "diverse beam":
            assert beam.last_use_anc is True
        else:
            # contrastive search steps once more: its last step's logits go unused
            want.update(fused_decode_step=0, gpt2_decode_step=DECODE_STEPS
                        + (label == "contrastive"))
        print(f"launches of the int8 {label} request: {counts[label]} (expect {want}) [{card}]",
              flush=True)
        assert counts[label] == want, (label, counts[label], want)
    return counts


def record_dtypes(targets) -> tuple:
    """Wrap each (module, name) of ``targets`` so that every call adds its
    first argument's dtype to a set; returns (the sets by name, the function
    that restores them)."""
    seen, origs = {}, []
    for module, name in targets:
        orig = getattr(module, name)
        seen[name] = set()

        def run(*args, _orig=orig, _name=name, **kw):
            seen[_name].add(args[0].dtype)
            return _orig(*args, **kw)

        origs.append((module, name, orig))
        setattr(module, name, run)

    def restore():
        for module, name, orig in origs:
            setattr(module, name, orig)
    return seen, restore


def fp16_phase(card: str, prompt: str, model_dir: str) -> tuple:
    """The float16 pipeline (`IndexTTS2(use_fp16=True)`, what the webui's
    ``--fp16`` builds): one request at 400 codes with the generation kwargs
    the port's webui builds for its emotion-vector mode
    (`webui.build_infer_kwargs`), its stage times and RTF, with K2 and K3
    asserted to launch at fp16 (exact launch counts, the plain step once a
    decode step); one CFM call on the DiT's flash tier (INDEXTTS_PACKED_ATTN
    =0), K4 at fp16 325 times; then from the request's codes and one fixed
    noise, the s2mel mel and the wav of the fp16, bf16 and f32 models (the
    same seeded weights; the kernels take 16-bit operands, so the f32 model
    runs K2's and K3's plain twins, f32 throughout): fp16's and bf16's
    rel-L2 to f32, both finite, and fp16's no larger (it has more mantissa
    than bf16, so a larger distance means an overflow). Returns (the
    request's launches, the flash call's, the request's stage times)."""
    import torch

    from indextts_tpu_torch import nn as tnn
    from indextts_tpu_torch import webui
    from indextts_tpu_torch.models.s2mel import dit
    from indextts_tpu_torch.models.vocoder import bigvgan
    from indextts_tpu_torch.ops.attn import attention_rope_plain
    from indextts_tpu_torch.ops.snake import antialias_snake_plain
    from indextts_tpu_torch.pipeline import infer_v2
    from indextts_tpu_torch.pipeline.buckets import pick_bucket
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    t0 = time.perf_counter()
    tts = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cuda", seed=0, use_fp16=True)
    torch.cuda.synchronize()
    assert tts.dtype == torch.float16
    print(f"fp16 model build (use_fp16=True, random weights, shipped widths): "
          f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    adv = dict(do_sample=True, top_p=0.8, top_k=30, temperature=0.8, length_penalty=0.0,
               num_beams=3, repetition_penalty=10.0, max_mel_tokens=400)
    kw = webui.build_infer_kwargs(2, None, 0.8, [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.6], "",
                                  False, 200, 120, adv, normalize_emo_vec=tts.normalize_emo_vec)
    tts.infer(spk_audio_prompt=prompt, text=SENTENCE, output_path=None, max_mel_tokens=20,
              min_new_tokens=19)                   # warm-up
    seen_codes = record_decodes(tts)
    dtypes, restore = record_dtypes([(dit, "attention_rope"), (bigvgan, "antialias_snake"),
                                     (tnn, "single_block_attention")])
    try:
        reset_counts()
        kw.pop("max_mel_tokens")
        st = run_requests(tts, prompt, 1, card, "fp16 (webui kwargs, emotion vectors)",
                          **kw)[0]
        counts = read_counts()
        want = want_counts(tts, "bf16", 1)
        want.update(fused_decode_step=0, gpt2_decode_step=DECODE_STEPS,
                    kv_gathers=counts["kv_gathers"])
        print(f"launches of the fp16 request: {counts} (expect {want}); kernels' input types "
              f"{ {k: sorted(str(t) for t in v) for k, v in dtypes.items()} } [{card}]",
              flush=True)
        assert counts == want, (counts, want)
        assert dtypes["attention_rope"] == {torch.float16} == dtypes["antialias_snake"], dtypes

        # the flash tier: one CFM call (one codes_to_wav) with K4 at fp16
        codes = seen_codes[-1][0][:, :400].to(tts.device)
        spk, emo = tts._prepare_spk_prompt(prompt), tts._prepare_emo_cond(prompt)
        ids = tts.tokenizer.convert_tokens_to_ids(tts.tokenizer.tokenize(SENTENCE))
        text_ids = tts._text_rows([ids])
        saved = os.environ.get("INDEXTTS_PACKED_ATTN")
        os.environ["INDEXTTS_PACKED_ATTN"] = "0"
        try:
            reset_counts()
            dtypes["single_block_attention"].clear()
            cond, emovec, _, _ = tts.prefix(spk, emo, 1.0, text_ids, len(ids))
            t1 = time.perf_counter()
            wav = tts.codes_to_wav(spk, cond, emovec, text_ids, len(ids), codes, 400)
            flash_s = time.perf_counter() - t1
            flash = read_counts()
        finally:
            if saved is None:
                os.environ.pop("INDEXTTS_PACKED_ATTN")
            else:
                os.environ["INDEXTTS_PACKED_ATTN"] = saved
        n_k4 = tts.cfg.s2mel.DiT.depth * 25
        print(f"fp16 flash tier (INDEXTTS_PACKED_ATTN=0): one codes_to_wav of 400 codes "
              f"{flash_s:.4f} s, K4 launches {flash['single_block_attention']} (expect {n_k4}) "
              f"at {sorted(str(t) for t in dtypes['single_block_attention'])}, K2 "
              f"{flash['attention_rope']}; wav finite {bool(np.isfinite(wav).all())} [{card}]",
              flush=True)
        assert flash["single_block_attention"] == n_k4 and flash["attention_rope"] == 0, flash
        assert dtypes["single_block_attention"] == {torch.float16}, dtypes
        assert np.isfinite(wav).all()
    finally:
        restore()

    # the same codes and noise through the fp16, bf16 and f32 models
    g = torch.Generator(device=tts.device).manual_seed(3)
    mels, wavs = {}, {}
    models = {"fp16": tts}
    for label, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        models[label] = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cuda", seed=0,
                                  dtype=dt)
    vocode = infer_v2.bigvgan_forward
    kernels = (dit.attention_rope, bigvgan.antialias_snake)
    z = None
    for label, m in models.items():
        spk, emo = m._prepare_spk_prompt(prompt), m._prepare_emo_cond(prompt)
        cond, emovec, _, _ = m.prefix(spk, emo, 1.0, text_ids, len(ids))
        if z is None:        # the CFM's (1, prompt bucket + mel bucket, 80) noise
            T = spk["prompt_cond"].shape[1] + pick_bucket(
                int(400 * m.MEL_PER_CODE) + 1, m.cfg.engine.mel_len_buckets)
            z = torch.randn((1, T, 80), generator=g, device=tts.device)

        def keep(params, cfg, mel, lengths, _label=label):
            mels[_label] = mel[:, :int(400 * m.MEL_PER_CODE)].float().cpu()
            return vocode(params, cfg, mel, lengths)

        infer_v2.bigvgan_forward = keep
        if label == "f32":
            dit.attention_rope, bigvgan.antialias_snake = attention_rope_plain, \
                antialias_snake_plain
        try:
            wavs[label] = m.codes_to_wav(spk, cond, emovec, text_ids, len(ids), codes, 400,
                                         z=z.clone())
        finally:
            infer_v2.bigvgan_forward = vocode
            dit.attention_rope, bigvgan.antialias_snake = kernels
    dist = {label: (rel_l2(mels[label], mels["f32"]),
                    rel_l2(torch.as_tensor(wavs[label]), torch.as_tensor(wavs["f32"])))
            for label in ("fp16", "bf16")}
    finite = all(np.isfinite(w).all() for w in wavs.values()) and all(
        bool(torch.isfinite(v).all()) for v in mels.values())
    print(f"fixed codes (400) and noise through the fp16, bf16 and f32 models: mel rel_l2 to "
          f"f32 fp16 {dist['fp16'][0]:.3e}, bf16 {dist['bf16'][0]:.3e}; wav rel_l2 to f32 fp16 "
          f"{dist['fp16'][1]:.3e}, bf16 {dist['bf16'][1]:.3e}; all finite {finite} [{card}]",
          flush=True)
    assert finite, "a non-finite mel or wav"
    assert dist["fp16"][0] <= dist["bf16"][0] and dist["fp16"][1] <= dist["bf16"][1], dist
    del models, tts
    torch.cuda.empty_cache()
    return counts, flash, st


def longform_text(tts, count: int = LONGFORM_SEGMENTS) -> str:
    """The long-form text: SENTENCE repeated until the tokenizer splits it
    into ``count`` segments at 120 tokens (the last one shorter, so its rows
    are left-padded more than the others)."""
    def segments(n):
        return tts.tokenizer.split_segments(tts.tokenizer.tokenize(SENTENCE * n), 120)

    n = 1
    while len(segments(n)) < count:
        n += 1
    segs = segments(n)
    print(f"long-form text: SENTENCE x {n} -> {len(segs)} segments of "
          f"{[len(s) for s in segs]} tokens at max_text_tokens_per_segment=120", flush=True)
    assert len(segs) == count, len(segs)
    return SENTENCE * n


def longform_request(tts, prompt: str, text: str, card: str, label: str, **kwargs) -> dict:
    """One long-form request, every segment pinned to 400 codes: the wav
    holds 8 segments of int(400 * 1.72) * 256 samples and the 7 silences
    between them; prints the stage times and the RTF."""
    sr, wav = tts.infer(spk_audio_prompt=prompt, text=text, output_path=None,
                        max_mel_tokens=400, min_new_tokens=399, **kwargs)
    st = dict(tts.last_stage_times)
    expect = (LONGFORM_SEGMENTS * int(np.float32(400) * np.float32(1.72)) * 256
              + (LONGFORM_SEGMENTS - 1) * SILENCE_SAMPLES)
    assert st["segment_codes"] == [400] * LONGFORM_SEGMENTS, st["segment_codes"]
    assert sr == 22050 and wav.shape == (expect, 1), (wav.shape, expect)
    assert np.abs(wav).max() > 0
    stages = " ".join(f"{k}={st[k]:.4f}s" for k in
                      ("prompt", "gpt", "gpt_forward", "s2mel", "bigvgan", "total"))
    print(f"{label} long-form request: {LONGFORM_SEGMENTS} segments x 400 codes, "
          f"{wav.shape[0]} samples, audio={st['audio_s']:.4f}s {stages} RTF={st['rtf']:.4f} "
          f"[{card}]", flush=True)
    return st


def record_first_calls(module, name: str, seen: dict):
    """Wrap ``module.name`` so that its first call at each input shape keeps
    clones of its arguments in ``seen`` (shape -> args); returns the
    function that restores it."""
    import torch

    orig = getattr(module, name)

    def run(*args):
        key = tuple(args[0].shape)
        if key not in seen:
            seen[key] = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        return orig(*args)

    setattr(module, name, run)
    return lambda: setattr(module, name, orig)


def k1_recorder(calls=LONGFORM_K1_CALLS):
    """A ``decode_check`` hook that keeps clones of the arguments and output
    of the K1 calls numbered in ``calls`` (0 = the first decode step), and
    the list it fills."""
    kept, n = [], [0]

    def check(args, h):
        if n[0] in calls:
            kept.append(({**args, "x": args["x"].clone(), "kv_valid": args["kv_valid"].clone(),
                          "anc": None if args["anc"] is None else args["anc"].clone(),
                          "kv_cache": {k: t.clone() for k, t in args["kv_cache"].items()},
                          "layer_inputs": [t.clone() for t in args["layer_inputs"]]},
                         h.clone()))
        n[0] += 1

    return kept, check


def longform_k1_row(kept, card: str) -> dict:
    """K1 at the long-form decode's own inputs (24 rows: 8 segments x 3
    beams, the rows of a segment's group left-padded alike, the beam
    ancestry map): each kept call layer by layer against the twin
    (`twin_by_layer`) and bit-identical to the chain (`k1_against_chain`);
    its hidden state against the twin's 24-layer chain is printed with that
    chain's noise floor (f64 against f32 sums), not gated, as in the int8
    pass; the last kept call timed (graph replay and eager, beside the
    chain) with the plain twin's time and its bound from its own valid
    positions."""
    from indextts_tpu_torch.ops.decode_step import fused_decode_step_plain

    row = {"err": 0.0, "abs": 0.0}
    for args, h in kept:
        params, x, dims, pos = args["params"], args["x"], args["dims"], args["pos"]
        valid, anc, group = args["kv_valid"], args["anc"], args["group"]
        tw = twin_by_layer(args, h)
        vs = k1_against_chain(params, x, dims, pos, args["kv_cache"], valid, anc, group)
        ref, ref64 = twin_chains(args)
        err, mab = rel_l2(h, ref), (h.float() - ref.float()).abs().max().item()
        starts = (pos + 1 - valid.sum(1)).tolist()
        print(f"K1 at the long-form decode's inputs ({x.shape[0]} rows, group={group}, pos={pos}"
              f", S={valid.shape[1]}, row starts {sorted(set(starts))}): twin layer by layer "
              f"rel_l2 <= {tw['layer']:.3e}, hidden {tw['hidden']:.3e}, rows {tw['rows_exact']};"
              f" against the chain {vs}; the twin's 24-layer chain: rel_l2 {err:.3e} max_abs "
              f"{mab:.3e} (noise floor, twin with f64 against f32 sums: "
              f"{rel_l2(ref64, ref):.3e}) [{card}]", flush=True)
        assert tw["layer"] <= K1_REL_L2 and tw["hidden"] <= K1_REL_L2 and tw["rows_exact"], tw
        assert vs["ok"], vs
        row["err"], row["abs"] = max(row["err"], err), max(row["abs"], mab)
    cache = {k: t.clone() for k, t in args["kv_cache"].items()}
    t = k1_timing(params, x, dims, pos, cache, valid, anc, group)
    pms = graph_ms(lambda: fused_decode_step_plain(params, x, dims, pos, cache, valid, anc,
                                                   group), iters=3, replays=2)
    b = k1_bound(starts, params, x.shape[0], valid.shape[1], len(params["h"]), x.shape[1],
                 dims.heads, pos=pos)
    print(f"K1 at the long-form decode's inputs, step at pos={pos}: device {timing_text(t)}, "
          f"plain {pms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]",
          flush=True)
    row.update(plain_ms=pms, library_ms=None, **t, **b)
    return row


def ragged_synthesis(tts, prompt: str, text: str, card: str) -> tuple:
    """The batched synthesis (`IndexTTS2.codes_to_wav`) of the long text's
    LONGFORM_SEGMENTS rows at a different code length a row
    (`RAGGED_CODES`; seeded random codes), as segments that stop at
    different lengths give it: every row finite and sound up to its own
    int(f32(clen) * f32(1.72)) * 256 samples and zero past them. K2's first
    DiT call (2B rows) and K3's first call at each stage shape (B rows) are
    kept, each row with its own length, and held against their twins
    (`k2_case`, `k3_sum`: the `*_longform` rows of the kernels line)."""
    import torch

    from indextts_tpu_torch.models.s2mel import dit as dit_mod
    from indextts_tpu_torch.models.vocoder import bigvgan as bv_mod

    tok = tts.tokenizer
    seg_ids = [tok.convert_tokens_to_ids(s) for s in
               tok.split_segments(tok.tokenize(text), 120)]
    tlens = [len(ids) for ids in seg_ids]
    g = torch.Generator(device=tts.device).manual_seed(0)
    codes = torch.randint(0, tts.cfg.gpt.start_mel_token, (len(seg_ids), max(RAGGED_CODES)),
                          generator=g, device=tts.device)
    k2_seen, k3_seen = {}, {}
    restore = [record_first_calls(dit_mod, "attention_rope", k2_seen),
               record_first_calls(bv_mod, "antialias_snake", k3_seen)]
    times = {}
    try:
        with torch.inference_mode():
            spk = tts._prepare_spk_prompt(prompt)
            cond_latents, emovec = tts.conditioning(spk, tts._prepare_emo_cond(prompt), 1.0)
            wav = tts.codes_to_wav(spk, cond_latents, emovec, tts._text_rows(seg_ids), tlens,
                                   codes, RAGGED_CODES, times=times)
    finally:
        for r in restore:
            r()
    n = [tts._n_samples(c) for c in RAGGED_CODES]
    print(f"long-form synthesis of {len(n)} rows at {list(RAGGED_CODES)} codes: wav {wav.shape}, "
          f"rows sound to {n} samples, zero past them; "
          + " ".join(f"{k}={v:.4f}s" for k, v in times.items()) + f" [{card}]", flush=True)
    assert wav.shape == (len(n), max(n)), (wav.shape, n)
    for b, m in enumerate(n):
        assert np.all(np.isfinite(wav[b])) and np.abs(wav[b, :m]).max() > 0, b
        assert not wav[b, m:].any(), f"row {b} sounds past its {m} samples"
    (k2_args,) = k2_seen.values()
    assert len(set(k2_args[3].tolist())) == len(n), k2_args[3]
    assert len(k3_seen) == len(K3_SHAPES) and all(len(set(a[3].tolist())) == len(n) and a[4]
                                     for a in k3_seen.values()), k3_seen.keys()
    where = " at the long-form synthesis's rows of different lengths"
    return k2_case(*k2_args, card, where), k3_sum([a[:4] for a in k3_seen.values()], card,
                                                  where)


def longform_phase(card: str, prompt: str, model_dir: str) -> tuple:
    """The streaming pass, then the long-form int8 pass on the same model.

    Streaming: STREAM_REQUESTS requests of the long text at the JAX bench's
    streaming settings (num_beams=1, 60 codes a segment,
    more_segment_before=8): the time to the first yielded chunk, the
    chunks (each segment's wav, then its silence), and the launches of the
    last request.

    Long-form: `ragged_synthesis` (K2 and K3 against their twins at rows of
    different lengths), then one request of 8 segments at num_beams=3,
    every segment pinned to 400 codes: one decode of 24 rows (one chunk of
    8 segments x 3 beams), so K1 once a decode step (399, not 8 x 399), and
    K2 and K3 as often as one single-segment request (one CFM over a DiT
    batch of 16 rows, one vocoder call over 8 rows). The request's K1 calls
    of LONGFORM_K1_CALLS are kept, then held against the twin and the chain
    and timed at those inputs. Returns the counts, the kernels rows and the
    request's stage times."""
    import statistics

    import torch

    from indextts_tpu_torch.engine import beam, decode
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    t0 = time.perf_counter()
    tts = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cuda", seed=0,
                    quantization="int8")
    torch.cuda.synchronize()
    print(f"int8 model build for the long-form pass: {time.perf_counter() - t0:.2f} s [{card}]",
          flush=True)
    text = longform_text(tts)

    firsts, counts = [], {}
    seen = record_decodes(tts)
    for i in range(STREAM_REQUESTS):
        del seen[:]
        reset_counts()
        t0 = time.perf_counter()
        gen = tts.infer(spk_audio_prompt=prompt, text=text, output_path=None, stream_return=True,
                        **STREAM_KWARGS)
        chunks = [next(gen)]
        firsts.append(time.perf_counter() - t0)
        chunks += list(gen)
        wall = time.perf_counter() - t0
        st_s = tts.last_stage_times
        seg = st_s["segment_codes"]
        want_shapes = [s for c in seg for s in ((1, int(np.float32(c) * np.float32(1.72)) * 256),
                                                (1, SILENCE_SAMPLES))]
        assert len(seg) == LONGFORM_SEGMENTS, seg
        assert [c.shape for c in chunks] == want_shapes, [c.shape for c in chunks]
        assert all(np.all(np.isfinite(c)) for c in chunks) and np.abs(chunks[0]).max() > 0
        stages = " ".join(f"{k}={st_s[k]:.4f}s" for k in ("gpt", "s2mel", "bigvgan"))
        print(f"streaming request {i + 1}: first chunk after {1e3 * firsts[-1]:.1f} ms, "
              f"{len(chunks)} chunks ({len(seg)} segments of {seg} codes, each then its "
              f"silence) in {wall:.4f} s; {stages} [{card}]", flush=True)
    counts["streaming"] = read_counts()
    del tts.decode
    stats = [st for _, _, st in seen]
    steps = STREAM_KWARGS["max_mel_tokens"] - 1
    want = spec_want({k: v * len(seg) for k, v in want_counts(tts, "int8", 1).items()}, stats,
                     steps)
    # one span of 60 codes: no demotion, every step is a verify's or a single one
    assert len(stats) == len(seg) and all(st[2] + st[3] == steps for st in stats), stats
    print(f"streaming first audio: median of requests 2-{STREAM_REQUESTS} "
          f"{1e3 * statistics.median(firsts[1:]):.1f} ms (all: "
          f"{', '.join(f'{1e3 * f:.1f}' for f in firsts)} ms); launches of the last request: "
          f"{counts['streaming']} (expect {want}); decode route {decode.last_route}; the "
          f"segments' speculative decodes (gamma, verifies, committed, single steps): {stats} "
          f"[{card}]", flush=True)
    assert counts["streaming"] == want, (counts["streaming"], want)
    assert decode.last_route == "fused"

    k2_row, k3_row = ragged_synthesis(tts, prompt, text, card)
    torch.cuda.empty_cache()
    kept, check = k1_recorder()
    tts.decode_check = check
    reset_counts()
    try:
        st = longform_request(tts, prompt, text, card, "int8 num_beams=3")
    finally:
        tts.decode_check = None
    counts["longform"] = read_counts()
    want = want_counts(tts, "int8", 1)
    print(f"launches of the long-form int8 request: {counts['longform']} (expect {want}: K1 once "
          f"a decode step of the one 24-row chunk, K2 and K3 as in one single-segment request); "
          f"ancestry route {beam.last_use_anc} [{card}]", flush=True)
    assert counts["longform"] == want, (counts["longform"], want)
    assert beam.last_use_anc is True and len(kept) == len(LONGFORM_K1_CALLS)
    assert kept[0][0]["x"].shape[0] == LONGFORM_SEGMENTS * 3 and kept[0][0]["group"] == 3
    rows = {"fused_decode_step_longform": longform_k1_row(kept, card),
            "attention_rope_longform": k2_row, "antialias_snake_longform": k3_row}
    del tts, kept
    torch.cuda.empty_cache()
    return counts, rows, st


def longform_bf16_phase(card: str, prompt: str, model_dir: str) -> tuple:
    """The long-form text at bf16, num_beams=3: one request, a 24-row decode
    on the gather route (the bf16 step once a decode step, the cache
    gathered by the beams), K2 and K3 as in one single-segment request."""
    import torch

    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    t0 = time.perf_counter()
    tts = IndexTTS2(cfg_path=None, model_dir=model_dir, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"bf16 model build for the long-form pass: {time.perf_counter() - t0:.2f} s [{card}]",
          flush=True)
    text = longform_text(tts)
    reset_counts()
    st = longform_request(tts, prompt, text, card, "bf16 num_beams=3")
    counts = read_counts()
    want = want_counts(tts, "int8", 1)
    want.update(fused_decode_step=0, gpt2_decode_step=DECODE_STEPS, kv_gathers=counts["kv_gathers"])
    print(f"launches of the long-form bf16 request: {counts} (expect {want}, kv_gathers > 0) "
          f"[{card}]", flush=True)
    assert counts == want and counts["kv_gathers"] > 0, (counts, want)
    del tts
    torch.cuda.empty_cache()
    return counts, st


# the mesh pass: the GSPMD decode's quantizations, its requests' codes, the
# checked steps (K6's gate), the DiT's tp and sp gates
MESH_TP_QUANT = (None, "int4", "int8kv", "int8")
MESH_TP_CODES = 48
MESH_ROWS_SEGMENTS = 9                     # 27 rows at num_beams=3
MESH_ROWS_CODES = 40
DIT_TP_REL_L2 = 2e-2                       # the attention gate
DIT_SP_REL_L2 = 1e-3
MESH_CFM_FRAMES = (172, 688)               # prompt and mel frames of a 400-code request


def join_gpt(tp) -> dict:
    """The unsharded GPT-2 tree of a tensor-parallel one (`shard_gpt2_tp`'s
    inverse, on rank 0's device): the same bytes as the tree it split."""
    import torch

    from indextts_tpu_torch import nn

    dev = tp["mesh"].devices[0]

    def rows(parts, groups):
        return {k: torch.cat([p[k].to(dev).reshape(groups, -1, *p[k].shape[1:])
                              for p in parts], 1).reshape(-1, *parts[0][k].shape[1:])
                for k in parts[0]}

    def cols(parts):
        out = {k: v for k, v in parts[0].items() if k not in ("q", "q4", "weight")}
        w = next(k for k in ("q", "q4", "weight") if k in parts[0])
        if w == "q4":
            out[w] = nn.pack_int4(torch.cat([nn.unpack_int4(p[w].to(dev)) for p in parts], 1))
        else:
            out[w] = torch.cat([p[w].to(dev) for p in parts], 1)
        return out

    h = [{"ln_1": lps[0]["ln_1"], "ln_2": lps[0]["ln_2"],
          "attn": {"c_attn": rows([lp["attn"]["c_attn"] for lp in lps], 3),
                   "c_proj": cols([lp["attn"]["c_proj"] for lp in lps])},
          "mlp": {"c_fc": rows([lp["mlp"]["c_fc"] for lp in lps], 1),
                  "c_proj": cols([lp["mlp"]["c_proj"] for lp in lps])}}
         for lps in zip(*tp["shards"])]
    return {"h": h, "ln_f": tp["ln_f"]}


def join_cache(kv, heads: int) -> dict:
    """A tensor-parallel cache's shards as one cache (each shard's int8
    scale lanes moved to its heads' lanes)."""
    import torch

    from indextts_tpu_torch.models.gpt.gpt2 import SCALE_LANES

    shards = kv["shards"]
    out = {k: torch.cat([c[k] for c in shards], -1) for k in ("k", "v")}
    if "kvs" in shards[0]:
        hl, half = heads // len(shards), SCALE_LANES // 2
        kvs = torch.zeros_like(shards[0]["kvs"])
        for t, c in enumerate(shards):
            kvs[..., t * hl:(t + 1) * hl] = c["kvs"][..., :hl]
            kvs[..., half + t * hl:half + (t + 1) * hl] = c["kvs"][..., half:half + hl]
        out["kvs"] = kvs
    return out


def gspmd_step_check(n: int = TWIN_CHECKED_STEPS):
    """Wrap the plain decode step of `engine/decode.py`: its first ``n``
    calls on a tensor-parallel tree run with every layer's input kept, and
    each layer is held against the unsharded tree's layer (`join_gpt`,
    `cached_layer`) on the same input, against a joined copy of the cache
    (`join_cache`): layer by layer, as K6's check holds its layers. Returns
    (the record, a function that unwraps)."""
    from indextts_tpu_torch import nn
    from indextts_tpu_torch.engine import decode
    from indextts_tpu_torch.models.gpt.gpt2 import cached_layer
    from indextts_tpu_torch.parallel.mesh import is_tp

    orig = decode.gpt2_decode_step
    site = {"n": 0, "layer": 0.0, "hidden": 0.0, "rows": set(), "joined": None}

    def checked(params, x, dims, pos, kv, kv_valid, collect_hiddens=False):
        if site["n"] >= n or not is_tp(params) or collect_hiddens:
            return orig(params, x, dims, pos, kv, kv_valid, collect_hiddens)
        if site["joined"] is None or site["joined"][0] is not params:
            site["joined"] = (params, join_gpt(params))
        joined = site["joined"][1]
        h, hs = orig(params, x, dims, pos, kv, kv_valid, True)
        ref_kv, mask = join_cache(kv, dims.heads), kv_valid[:, None, None, :]
        for li, lp in enumerate(joined["h"]):
            out = cached_layer(lp, hs[li][:, None], dims, pos, ref_kv, li, mask)[:, 0]
            if li + 1 < len(hs):
                site["layer"] = max(site["layer"], rel_l2(hs[li + 1], out))
            else:
                site["hidden"] = max(site["hidden"],
                                     rel_l2(h, nn.layer_norm(joined["ln_f"], out)))
        site["rows"].add(x.shape[0])
        site["n"] += 1
        return h

    decode.gpt2_decode_step = checked

    def undo():
        decode.gpt2_decode_step = orig
    return site, undo


def recorded_codes(tts) -> list:
    """Wrap ``tts.codes_to_wav``: each call appends (codes on the host,
    lengths) to the returned list; ``del tts.codes_to_wav`` unwraps."""
    seen = []
    orig = tts.codes_to_wav

    def record(*args, **kwargs):
        seen.append((args[5].cpu(), np.atleast_1d(np.asarray(args[6]))))
        return orig(*args, **kwargs)

    tts.codes_to_wav = record
    return seen


def mesh_dp_pass(card: str, prompt: str, model_dir: str) -> dict:
    """dp=2 x tp=1 with both ranks on this card: the long-form 8-segment
    int8 request at num_beams=3, do_sample=False, 400 codes a segment, on
    `IndexTTS2(mesh=make_mesh(["cuda:0", "cuda:0"], tp=1))`, against the
    single-device int8 pipeline on the same seed's weights decoding the
    same rows a chunk (MAX_ROWS = 12: chunks of 4 segments, the dp ranks'
    rows): codes equal, the long-form pass's wav gate, K1 launches per rank
    (one 12-row chunk each). The share of codes equal to the default
    single-device run (one 24-row chunk) is printed: K1's bits depend on the
    rows a launch holds. Returns the dp request's counts."""
    import torch

    from indextts_tpu_torch.ops.decode_step import fused_decode_step
    from indextts_tpu_torch.parallel.mesh import make_mesh
    from indextts_tpu_torch.pipeline import infer_v2 as iv2

    one = iv2.IndexTTS2(cfg_path=None, model_dir=model_dir, device="cuda", seed=0,
                        quantization="int8")
    text = longform_text(one)
    seen = recorded_codes(one)
    rows = iv2.MAX_ROWS
    for max_rows in (rows, LONGFORM_SEGMENTS // 2 * 3):
        iv2.MAX_ROWS = max_rows
        try:
            one.generator.manual_seed(0)
            longform_request(one, prompt, text, card, f"single-device int8 num_beams=3, "
                             f"{max_rows}-row chunks (mesh pass)", num_beams=3, do_sample=False)
        finally:
            iv2.MAX_ROWS = rows
    (codes24, lens24), (ref_codes, ref_lens) = seen
    del one, seen
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tts = iv2.IndexTTS2(cfg_path=None, model_dir=model_dir, seed=0, quantization="int8",
                        mesh=make_mesh(["cuda:0", "cuda:0"], tp=1))
    torch.cuda.synchronize()
    print(f"dp model build ({tts.mesh}): {time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    per_rank = []
    orig = tts._decode_rows

    def counted(*args, **kwargs):
        before = fused_decode_step.launches
        out = orig(*args, **kwargs)
        per_rank.append((args[1].shape[0], fused_decode_step.launches - before))
        return out

    tts._decode_rows = counted
    seen = recorded_codes(tts)
    reset_counts()
    tts.generator.manual_seed(0)
    longform_request(tts, prompt, text, card, "dp=2 int8 num_beams=3 (ranks co-located)",
                     num_beams=3, do_sample=False)
    counts = read_counts()
    codes, lens = seen[-1]

    def share(a, la, b, lb):
        return float(np.mean([(a[i, :n] == b[i, :n]).float().mean().item()
                              for i, n in enumerate(np.minimum(la, lb))]))

    equal = bool(np.array_equal(lens, ref_lens)) and all(
        torch.equal(codes[b, :n], ref_codes[b, :n]) for b, n in enumerate(ref_lens))
    print(f"dp=2 long-form request: ranks' (prefix rows, K1 launches) {per_rank}; codes equal "
          f"to the single-device run in 12-row chunks: {equal} "
          f"({100 * share(codes, lens, ref_codes, ref_lens):.2f} %), to the default one (one "
          f"24-row chunk): {100 * share(codes, lens, codes24, lens24):.2f} %; the two "
          f"single-device runs: {100 * share(ref_codes, ref_lens, codes24, lens24):.2f} %; "
          f"launches {counts} [{card}]", flush=True)
    assert per_rank == [(LONGFORM_SEGMENTS // 2, DECODE_STEPS)] * 2, per_rank
    assert counts["fused_decode_step"] == 2 * DECODE_STEPS, counts
    assert counts["attention_rope"] == 2 * tts.cfg.s2mel.DiT.depth * 25, counts
    assert equal
    del tts, seen
    torch.cuda.empty_cache()
    return counts


def mesh_tp_pass(card: str, prompt: str, model_dir: str) -> dict:
    """tp=2 with both ranks on this card and no INDEXTTS_TP_DECODE: the
    GSPMD route (the plain step on the shards) for bf16, int4, int8kv and
    int8. One single-segment num_beams=3 request each, MESH_TP_CODES codes,
    its first TWIN_CHECKED_STEPS steps held layer by layer against the
    unsharded plain step (`gspmd_step_check`, rel-L2 <= K1_REL_L2); the
    share of its codes equal to the same request on the unsharded tree
    (printed, not gated). Then, on the int8 model, 9 segments at
    num_beams=3 (27 rows) held the same way. Returns the counts."""
    import torch

    from indextts_tpu_torch.engine import decode
    from indextts_tpu_torch.parallel.mesh import make_mesh
    from indextts_tpu_torch.pipeline.infer_v2 import IndexTTS2

    saved = os.environ.pop("INDEXTTS_TP_DECODE", None)
    counts = {}
    try:
        for q in MESH_TP_QUANT:
            label = q or "bf16"
            t0 = time.perf_counter()
            tts = IndexTTS2(cfg_path=None, model_dir=model_dir, seed=0, quantization=q,
                            mesh=make_mesh(["cuda:0", "cuda:0"]))
            torch.cuda.synchronize()
            build = time.perf_counter() - t0
            site, undo = gspmd_step_check()
            reset_counts()
            kw = dict(max_mel_tokens=MESH_TP_CODES, min_new_tokens=MESH_TP_CODES - 1,
                      num_beams=3, do_sample=False)
            seen = recorded_codes(tts)
            try:
                tts.generator.manual_seed(0)
                sr, wav = tts.infer(spk_audio_prompt=prompt, text=SENTENCE, output_path=None,
                                    **kw)
            finally:
                undo()
            counts[f"mesh_tp_{label}"] = c = read_counts()
            st = tts.last_stage_times
            assert decode.decode_route(tts.gpt_params, 3, tts._sampling({}).kv_quant) == "plain"
            assert c["fused_decode_step"] == c["fused_decode_step_tp"] == 0, c
            assert np.all(np.isfinite(wav)) and np.abs(wav).max() > 0
            sharded = tts.gpt_params["gpt"]
            tts.gpt_params["gpt"] = join_gpt(sharded)
            tts.generator.manual_seed(0)
            tts.infer(spk_audio_prompt=prompt, text=SENTENCE, output_path=None, **kw)
            tts.gpt_params["gpt"] = sharded
            (a, la), (b, lb) = seen
            n = int(min(la[0], lb[0]))
            share = (a[0, :n] == b[0, :n]).float().mean().item()
            print(f"tp=2 GSPMD {label} request (model build {build:.2f} s): codes={st['codes']} "
                  f"gpt={st['gpt']:.4f}s gpt_forward={st['gpt_forward']:.4f}s "
                  f"s2mel={st['s2mel']:.4f}s bigvgan={st['bigvgan']:.4f}s "
                  f"total={st['total']:.4f}s RTF={st['rtf']:.4f}; first {site['n']} steps vs "
                  f"the unsharded plain step: layer outputs rel_l2 <= {site['layer']:.3e}, "
                  f"hidden after ln_f {site['hidden']:.3e}; codes equal to the unsharded "
                  f"tree's request: {100 * share:.2f} % [{card}]", flush=True)
            assert site["n"] == TWIN_CHECKED_STEPS and site["rows"] == {3}, site
            assert site["layer"] <= K1_REL_L2 and site["hidden"] <= K1_REL_L2, site
            if q == "int8":
                text = longform_text(tts, MESH_ROWS_SEGMENTS)
                site, undo = gspmd_step_check()
                try:
                    tts.generator.manual_seed(0)
                    sr, wav = tts.infer(spk_audio_prompt=prompt, text=text, output_path=None,
                                        max_mel_tokens=MESH_ROWS_CODES,
                                        min_new_tokens=MESH_ROWS_CODES - 1, num_beams=3,
                                        do_sample=False)
                finally:
                    undo()
                st = tts.last_stage_times
                print(f"tp=2 int8 {len(st['segment_codes'])} segments x 3 beams (one batch of "
                      f"{3 * len(st['segment_codes'])} rows on the GSPMD route): "
                      f"gpt={st['gpt']:.4f}s s2mel={st['s2mel']:.4f}s total={st['total']:.4f}s "
                      f"RTF={st['rtf']:.4f}; first {site['n']} steps layer outputs rel_l2 <= "
                      f"{site['layer']:.3e}, hidden {site['hidden']:.3e} [{card}]", flush=True)
                assert len(st["segment_codes"]) == MESH_ROWS_SEGMENTS, st["segment_codes"]
                assert site["rows"] == {3 * MESH_ROWS_SEGMENTS} and site["n"] == \
                    TWIN_CHECKED_STEPS, site
                assert site["layer"] <= K1_REL_L2 and site["hidden"] <= K1_REL_L2, site
                assert np.all(np.isfinite(wav)) and np.abs(wav).max() > 0
            del tts, seen
            torch.cuda.empty_cache()
    finally:
        if saved is not None:
            os.environ["INDEXTTS_TP_DECODE"] = saved
    return counts


def mesh_dit_pass(card: str) -> dict:
    """The DiT over the mesh at the shipped widths on this card: one CFM
    (25 steps, CFG, a 400-code request's MESH_CFM_FRAMES) on the tp=2 DiT
    (K2 once a shard: twice the single-device launches; then on the flash
    tier, K4 likewise) against the single-device CFM on the same tier
    (rel-L2 <= DIT_TP_REL_L2), and at sp=2 and sp=2 x tp=2 against the
    single-device dense tier (<= DIT_SP_REL_L2). Returns the K2 launches of
    the single-device and tp=2 calls and K4's of the tp=2 flash call."""
    import torch

    from indextts_tpu_torch.config import IndexTTS2Config
    from indextts_tpu_torch.models.s2mel.cfm import cfm_inference
    from indextts_tpu_torch.ops.attn import attention_rope, single_block_attention
    from indextts_tpu_torch.parallel.mesh import make_mesh, shard_dit
    from indextts_tpu_torch.pipeline.infer_v2 import random_trees
    from indextts_tpu_torch.utils.jax_params import to_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = IndexTTS2Config()
    s2 = cfg.s2mel
    dev, bf16 = torch.device("cuda:0"), torch.bfloat16
    cfm = to_torch(random_trees(cfg, 0, dev, ("s2mel",))["s2mel"], dev, bf16)["cfm"]
    g = torch.Generator(device=dev).manual_seed(3)
    P, M = MESH_CFM_FRAMES
    T = P + M
    mu = torch.randn((1, T, s2.DiT.content_dim), generator=g, device=dev).to(bf16)
    prompt = torch.randn((1, T, s2.DiT.in_channels), generator=g, device=dev).to(bf16)
    style = torch.randn((1, 192), generator=g, device=dev).to(bf16)
    z = torch.randn((1, T, s2.DiT.in_channels), generator=g, device=dev)
    x_lens, p_lens = torch.tensor([T - 37], device=dev), torch.tensor([P - 20], device=dev)

    def run(tree):
        attention_rope.launches = single_block_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cfm_inference(tree, s2, mu, x_lens, prompt, style, prompt_len=p_lens, z=z)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (out[:, :int(x_lens[0])], attention_rope.launches + single_block_attention.launches,
                wall)

    tp_dit = shard_dit(cfm, make_mesh(["cuda:0"] * 2, tp=2))
    ref, k2_one, w_one = run(cfm)
    tp_out, k2_tp, w_tp = run(tp_dit)
    saved = {k: os.environ.get(k) for k in ("INDEXTTS_PACKED_ATTN", "INDEXTTS_FLASH_DIT")}
    os.environ["INDEXTTS_PACKED_ATTN"] = "0"
    try:
        flash, k4_one, w_flash = run(cfm)
        tp_flash, k4_tp, w_tp_flash = run(tp_dit)
        assert attention_rope.launches == 0
        os.environ["INDEXTTS_FLASH_DIT"] = "0"
        dense, k2_dense, w_dense = run(cfm)
        sp_out, k2_sp, w_sp = run(shard_dit(cfm, make_mesh(["cuda:0"] * 2, tp=1, sp=2)))
        sptp, k2_sptp, w_sptp = run(shard_dit(cfm, make_mesh(["cuda:0"] * 4, tp=2, sp=2)))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rel = {"tp": rel_l2(tp_out, ref), "tp_flash": rel_l2(tp_flash, flash),
           "sp": rel_l2(sp_out, dense), "sptp": rel_l2(sptp, dense)}
    print(f"DiT over the mesh (one CFM, 25 steps, CFG, T={T}, shipped widths, ranks on this "
          f"card): single device {w_one:.4f} s ({k2_one} K2 launches), tp=2 {w_tp:.4f} s "
          f"({k2_tp} K2 launches: one a shard at 4 heads) mel rel_l2 {rel['tp']:.3e}; flash "
          f"tier single {w_flash:.4f} s ({k4_one} K4 launches), tp=2 {w_tp_flash:.4f} s "
          f"({k4_tp} K4) rel_l2 {rel['tp_flash']:.3e}; dense tier {w_dense:.4f} s, sp=2 "
          f"{w_sp:.4f} s rel_l2 {rel['sp']:.3e}, sp=2 x tp=2 {w_sptp:.4f} s rel_l2 "
          f"{rel['sptp']:.3e} [{card}]", flush=True)
    assert k2_one == k4_one == s2.DiT.depth * 25, (k2_one, k4_one)
    assert k2_tp == k4_tp == 2 * k2_one, (k2_tp, k4_tp)
    assert k2_dense == k2_sp == k2_sptp == 0
    assert rel["tp"] <= DIT_TP_REL_L2 and rel["tp_flash"] <= DIT_TP_REL_L2, rel
    assert rel["sp"] <= DIT_SP_REL_L2 and rel["sptp"] <= DIT_SP_REL_L2, rel
    assert all(bool(torch.isfinite(t).all()) for t in (tp_out, tp_flash, sp_out, sptp))
    return {"attention_rope": k2_one, "attention_rope_tp": k2_tp,
            "single_block_attention_tp": k4_tp}


def mesh_phase(card: str, prompt: str, model_dir: str) -> dict:
    """The mesh pass, every rank on this one card (co-located ranks, each
    on its own stream): `mesh_dp_pass`, `mesh_tp_pass`, `mesh_dit_pass`.
    Returns the counts."""
    t0 = time.perf_counter()
    counts = {"mesh_dp": mesh_dp_pass(card, prompt, model_dir)}
    counts.update(mesh_tp_pass(card, prompt, model_dir))
    counts["mesh_dit"] = mesh_dit_pass(card)
    print(f"mesh pass: {time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    return counts


def v1_pinned(tts, min_new_tokens: int, synth_rows: list):
    """Pin a v1 model's decode: the sampling config its
    ``_sampling_from_kwargs`` builds from the request's kwargs, with
    ``min_new_tokens`` set (`IndexTTS.infer` takes no such keyword), on this
    instance; every synthesized row's float wav is appended to
    ``synth_rows`` (the int16 output cannot show a NaN)."""
    import dataclasses

    cls = type(tts)

    def sampling(kw):
        s, n = cls._sampling_from_kwargs(tts, kw)
        return dataclasses.replace(s, min_new_tokens=min_new_tokens), n

    def synthesize(*args, **kwargs):
        rows = cls._synthesize_batch(tts, *args, **kwargs)
        synth_rows.extend(rows)
        return rows

    tts._sampling_from_kwargs = sampling
    tts._synthesize_batch = synthesize


def v1_request(tts, fn, card: str, label: str, **kwargs) -> tuple:
    """One v1 request (``fn``: infer or infer_fast, decode pinned by
    `v1_pinned`): a finite float wav a row, the int16 output of codes x
    total_upsample samples; prints its stage seconds and RTF; returns
    (stage times, launches)."""
    rows = []
    v1_pinned(tts, kwargs.pop("min_new_tokens"), rows)
    reset_counts()
    sr, wav = fn(output_path=None, **kwargs)
    counts = read_counts()
    st = dict(tts.last_stage_times)
    up = tts.cfg.bigvgan.total_upsample
    assert sr == 24000 and wav.shape == (st["codes"] * up, 1), (wav.shape, st["codes"], up)
    assert rows and all(np.all(np.isfinite(r)) for r in rows), "v1 wav not finite"
    assert np.abs(wav).max() > 0
    stages = " ".join(f"{k}={st[k]:.4f}s" for k in
                      ("prompt", "gpt", "gpt_forward", "bigvgan", "total"))
    print(f"{label}: codes={st['codes']} ({len(rows)} rows) samples={wav.shape[0]} "
          f"audio={st['audio_s']:.4f}s {stages} RTF={st['rtf']:.4f}; K3 launches "
          f"{counts['antialias_snake']} [{card}]", flush=True)
    return st, counts


def v1_fast_text(tts) -> str:
    """SENTENCE repeated until `IndexTTS.infer_fast`'s segments (at its
    default 100 tokens) fill two buckets."""
    tok = tts.tokenizer
    n = 1
    while True:
        segs = tok.split_segments(tok.tokenize(SENTENCE * n), 100)
        if len(segs) >= 5 and len(tts.bucket_segments(segs)) == 2:
            break
        n += 1
    print(f"v1 infer_fast text: SENTENCE x {n} -> {len(segs)} segments of "
          f"{[len(x) for x in segs]} tokens, buckets of "
          f"{[len(b) for b in tts.bucket_segments(segs)]} rows", flush=True)
    return SENTENCE * n


def v1_phase(card: str, prompt: str, model_dir: str) -> tuple:
    """The IndexTTS-1.5 pass: `IndexTTS(cfg=IndexTTS1Config())` at the
    repository's default v1 widths (GPT 24 x 1280, 20 heads, conformer +
    perceiver conditioning; BigVGAN v1 1536 channels, rates 4.4.4.4 after
    the x4 feature upsampling, ECAPA 512), random weights from seed 0, the
    constructor's default fp16. A warm-up and a measured request at the
    default kwargs (num_beams=3), the decode pinned to 400 codes: the wav
    finite, codes x 1024 samples; exact launches (K3 once an anti-aliased
    activation, 73; the bf16-or-fp16 plain decode step once a decode step;
    no other kernel). K3 at fp16 at the request's four stage shapes (its
    first call at each, kept from the warm-up request) against its twin:
    the `antialias_snake_v1_fp16` row. Then a bf16 model (use_fp16=False,
    the CLI's default) and one `infer_fast` request over a text of two
    buckets, 120 codes a segment: a finite wav of the right length.
    Returns (the measured request's launches, the K3 row)."""
    import torch

    from indextts_tpu_torch.config import IndexTTS1Config
    from indextts_tpu_torch.models.vocoder import bigvgan as bv_mod
    from indextts_tpu_torch.models.vocoder.bigvgan import activation1d_calls
    from indextts_tpu_torch.pipeline.infer_v1 import IndexTTS

    t0 = time.perf_counter()
    tts = IndexTTS(cfg=IndexTTS1Config(), model_dir=model_dir, seed=0)
    torch.cuda.synchronize()
    print(f"v1 model build (fp16, random weights, default v1 widths): "
          f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    assert tts.dtype == torch.float16 and tts.device.type == "cuda"
    n_seg = len(tts.tokenizer.split_segments(tts.tokenizer.tokenize(SENTENCE), 120))
    assert n_seg == 1, f"smoke text must be one v1 segment, got {n_seg}"
    k3_seen = {}
    restore = record_first_calls(bv_mod, "antialias_snake", k3_seen)
    try:
        v1_request(tts, tts.infer, card, "v1 fp16 warm-up request", audio_prompt=prompt,
                   text=SENTENCE, max_mel_tokens=400, min_new_tokens=399)
    finally:
        restore()
    st, counts = v1_request(tts, tts.infer, card, "v1 fp16 request", audio_prompt=prompt,
                            text=SENTENCE, max_mel_tokens=400, min_new_tokens=399)
    want = {k: 0 for k in counts}
    want.update(antialias_snake=activation1d_calls(tts.cfg.bigvgan),
                gpt2_decode_step=DECODE_STEPS, kv_gathers=counts["kv_gathers"])
    print(f"launches of the v1 fp16 request: {counts} (expect {want}, kv_gathers > 0) "
          f"[{card}]", flush=True)
    assert st["codes"] == 400 and counts == want and counts["kv_gathers"] > 0, (st, counts)
    cases = sorted(k3_seen.values(), key=lambda a: -a[0].shape[2])
    assert len(cases) == 4 and all(a[0].dtype == torch.float16 and a[4] for a in cases), \
        [(a[0].shape, a[0].dtype) for a in cases]
    k3 = k3_sum([a[:4] for a in cases], card, " fp16 at the v1 request's stage shapes")
    del tts, k3_seen, cases
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    fast = IndexTTS(cfg=IndexTTS1Config(), model_dir=model_dir, seed=0, use_fp16=False)
    torch.cuda.synchronize()
    print(f"v1 model build (bf16): {time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    assert fast.dtype == torch.bfloat16
    text = v1_fast_text(fast)
    n_seg = len(fast.tokenizer.split_segments(fast.tokenizer.tokenize(text), 100))
    st_fast, _ = v1_request(fast, fast.infer_fast, card, "v1 bf16 infer_fast request",
                            audio_prompt=prompt, text=text, max_mel_tokens=120,
                            min_new_tokens=119)
    assert st_fast["codes"] == 120 * n_seg, (st_fast["codes"], n_seg)
    del fast
    torch.cuda.empty_cache()
    return counts, k3


TRAIN_STEPS, TRAIN_BATCH = 5, 4
# conditioning frames (5 s of w2v-bert features), text ids, mel codes (8 s at
# 50 a second), DiT frames (8 s at 22050 / 256) and the prompt's quarter of them
TRAIN_LENGTHS = dict(cond=250, text=64, mel=400, frames=688, prompt=172)
TRAIN_GRAD_RTOL = 1e-3
TRAIN_LOSS_RTOL = 1e-4
# leaves whose gradient is exactly zero in exact arithmetic, so rounding noise
# alone on either device: the conformers' key bias (adding b to every key adds
# q.b to each score of a query, which the softmax ignores); held below this
# share of the whole gradient's norm instead of a relative distance
ZERO_GRAD = re.compile(r"attn/linear_k/bias$")
ZERO_GRAD_FLOOR = 1e-6
RESUME_ATOL, RESUME_RTOL = 1e-6, 1e-5
DVAE_SECONDS = 5.0
DVAE_AGREE = 0.99


def train_configs(reduced: bool):
    """The shipped GPT and s2mel configs; ``reduced`` cuts the depth (GPT 2
    layers, DiT depth 2, one conformer block each) and keeps the widths."""
    import dataclasses

    from indextts_tpu_torch.config import GPTConfig, S2MelConfig

    gpt, s2 = GPTConfig(), S2MelConfig()
    if reduced:
        gpt = dataclasses.replace(
            gpt, layers=2,
            condition_module=dataclasses.replace(gpt.condition_module, num_blocks=1),
            emo_condition_module=dataclasses.replace(gpt.emo_condition_module, num_blocks=1))
        s2 = dataclasses.replace(s2, DiT=dataclasses.replace(s2.DiT, depth=2))
    return gpt, s2


def write_train_batches(d: str, gpt, s2, B: int, n: int) -> str:
    """``n`` seeded batches of B rows at TRAIN_LENGTHS as ``.npz`` files in
    ``d`` (the trainer's --data-dir)."""
    L = TRAIN_LENGTHS
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        r = np.random.default_rng(100 + i)
        f32, i32 = np.float32, np.int32
        np.savez(os.path.join(d, f"batch-{i:03d}.npz"),
                 cond_emb=r.standard_normal((B, L["cond"], gpt.cond_input_dim)).astype(f32),
                 cond_lens=np.full((B,), L["cond"], i32),
                 emo_emb=r.standard_normal((B, L["cond"], gpt.cond_input_dim)).astype(f32),
                 emo_lens=np.full((B,), L["cond"], i32),
                 text_ids=r.integers(2, gpt.number_text_tokens, (B, L["text"])).astype(i32),
                 text_lens=np.full((B,), L["text"], i32),
                 mel_codes=r.integers(0, gpt.start_mel_token, (B, L["mel"])).astype(i32),
                 mel_lens=np.full((B,), L["mel"], i32),
                 mel_target=r.standard_normal((B, L["frames"], s2.DiT.in_channels)).astype(f32),
                 mel_frames=np.full((B,), L["frames"], i32),
                 prompt_frames=np.full((B,), L["prompt"], i32),
                 cfm_cond=r.standard_normal(
                     (B, L["frames"], s2.length_regulator.channels)).astype(f32),
                 style=r.standard_normal((B, s2.style_encoder.dim)).astype(f32))
    return d


def train_args(**kw):
    import argparse

    args = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, dp=1, tp=1, seed=0, ckpt_dir=None,
                save_every=3, log_every=1, data_dir=None, resume=False, device="cuda")
    args.update(kw)
    return argparse.Namespace(**args)


def card_against_host(gpt, s2, data_dir: str, card: str) -> None:
    """One step's loss and every gradient leaf on the card against the same
    step on the host CPU (the same weights, batch and draws)."""
    import torch

    from indextts_tpu_torch.models.s2mel.cfm import cfm_noise
    from indextts_tpu_torch.parallel import train as pt
    from indextts_tpu_torch.train import (init_trainable, npz_batch, step_generator,
                                          to_device)

    pt.make_train_step(gpt, s2)                       # TF32 off, as the step runs
    batch_np = npz_batch(os.path.join(data_dir, "batch-000.npz"))
    out = {}
    for dev in ("cuda", "cpu"):
        tr = init_trainable(gpt, s2, 0, "cuda")
        if dev == "cpu":
            tr = pt.tree_map(lambda p: p.cpu(), tr)
        pt.make_train_state(tr)
        batch = to_device(batch_np, dev)
        t, z = cfm_noise(batch["mel_target"].cpu(), step_generator(0, 0))
        t0 = time.perf_counter()
        loss, parts = pt.train_loss(tr, gpt, s2, batch, t.to(dev), z.to(dev))
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        grads = [p.grad.cpu() if p.grad is not None else torch.zeros_like(p, device="cpu")
                 for p in pt.leaves(tr)]
        out[dev] = (float(loss.detach()), {k: float(v.detach()) for k, v in parts.items()},
                    grads, sec)
        names = leaf_names(tr)
        del tr
        torch.cuda.empty_cache()
    (lc, pc, gc, sc), (lh, ph, gh, sh) = out["cuda"], out["cpu"]
    total = min(torch.linalg.norm(torch.stack([torch.linalg.norm(g) for g in gs])).item()
                for gs in (gc, gh))
    worst, zeros, noise = 0.0, [], {}
    for name, a, b in zip(names, gc, gh):
        na, nb = torch.linalg.norm(a).item(), torch.linalg.norm(b).item()
        if ZERO_GRAD.search(name):
            noise[name] = (na, nb)
            assert max(na, nb) <= ZERO_GRAD_FLOOR * total, (name, na, nb, total)
        elif na == 0 or nb == 0:
            assert na == nb == 0, (name, na, nb)
            zeros.append(name)
        else:
            worst = max(worst, torch.linalg.norm(a - b).item() / nb)
    loss_rel = abs(lc - lh) / abs(lh)
    print(f"training, card against host (reduced depth, B=1): loss {lc:.6f} vs {lh:.6f} (rel "
          f"{loss_rel:.3e}), gpt {pc['gpt']:.6f} vs {ph['gpt']:.6f}, cfm {pc['cfm']:.6f} vs "
          f"{ph['cfm']:.6f}; {len(gc)} gradient leaves (whole gradient's norm {total:.4e}), "
          f"worst rel-L2 {worst:.3e}; zero on both sides: {', '.join(zeros)}; rounding noise "
          f"only (exactly zero: the softmax over keys ignores a bias added to every key), "
          f"norms card / host: " + "; ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in
                                             noise.items())
          + f"; forward + backward {sc:.3f} s on the card, {sh:.3f} s on the host [{card}]",
          flush=True)
    assert loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_RTOL, (loss_rel, worst)


def leaf_names(tree, path: str = "") -> list:
    """The "/"-joined paths of a tree's leaves, in `parallel.train.leaves`'s
    order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{path}/{i}")]
    return [path]


def save_and_resume(gpt, s2, data_dir: str, card: str) -> None:
    """3 steps, a save, a resume and 2 more steps against 5 steps straight,
    on the card at the reduced depth."""
    import shutil

    import torch

    from indextts_tpu_torch.parallel.train import leaves
    from indextts_tpu_torch.train import run

    def done(result):
        trainable = result[0]
        host = [p.detach().cpu() for p in leaves(trainable)]
        del result, trainable
        torch.cuda.empty_cache()
        return host

    straight = done(run(train_args(batch=1, data_dir=data_dir), gpt, s2))
    with tempfile.TemporaryDirectory(prefix="indextts_train_") as ck:
        usage = shutil.disk_usage(ck)
        print(f"save and resume: {ck} has {usage.free} bytes free of {usage.total}", flush=True)
        t0 = time.perf_counter()
        first = run(train_args(batch=1, data_dir=data_dir, steps=3, ckpt_dir=ck), gpt, s2)
        t_first = time.perf_counter() - t0
        done(first)
        t0 = time.perf_counter()
        resumed = done(run(train_args(batch=1, data_dir=data_dir, ckpt_dir=ck, resume=True),
                           gpt, s2))
        t_resumed = time.perf_counter() - t0
        state_bytes = sum(os.path.getsize(os.path.join(ck, "state-3", f))
                          for f in os.listdir(os.path.join(ck, "state-3")))
    same = sum(torch.equal(a, b) for a, b in zip(straight, resumed))
    worst = max((a - b).abs().max().item() for a, b in zip(straight, resumed))
    print(f"save and resume (reduced depth, B=1): {same} of {len(straight)} leaves bit-identical "
          f"to 5 steps straight, max |diff| {worst:.3e}; a state {state_bytes} bytes; 3 steps "
          f"and a save {t_first:.2f} s, a resume and 2 steps and a save {t_resumed:.2f} s "
          f"[{card}]", flush=True)
    for a, b in zip(straight, resumed):
        torch.testing.assert_close(b, a, atol=RESUME_ATOL, rtol=RESUME_RTOL)


def train_phase(card: str) -> None:
    """The training pass (docstring item 14)."""
    import torch

    from indextts_tpu_torch.parallel.train import leaves
    from indextts_tpu_torch.train import run

    gpt, s2 = train_configs(reduced=False)
    with tempfile.TemporaryDirectory(prefix="indextts_batches_") as d:
        full = write_train_batches(os.path.join(d, "b4"), gpt, s2, TRAIN_BATCH, TRAIN_STEPS)
        one = write_train_batches(os.path.join(d, "b1"), gpt, s2, 1, TRAIN_STEPS)
        before = read_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainable, optimizer, losses, seconds = run(train_args(data_dir=full), gpt, s2)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(p.numel() for p in leaves(trainable))
        del trainable, optimizer
        torch.cuda.empty_cache()
        after = read_counts()
        print(f"training (full width, B={TRAIN_BATCH}, {TRAIN_LENGTHS}): {n_params} trainable "
              f"parameters; losses (total, gpt, cfm) " + "; ".join(
                  f"step {i + 1} {a:.4f} {b:.4f} {c:.4f}" for i, (a, b, c) in enumerate(losses))
              + f"; step seconds " + ", ".join(f"{s:.3f}" for s in seconds)
              + f"; median of steps 2-{TRAIN_STEPS} {float(np.median(seconds[1:])):.3f} s; "
              f"peak allocated {peak} bytes [{card}]", flush=True)
        assert len(losses) == TRAIN_STEPS and np.isfinite(losses).all(), losses
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        assert not launched, f"a training step launched kernels: {launched}"
        reduced = train_configs(reduced=True)
        card_against_host(*reduced, one, card)
        save_and_resume(*reduced, one, card)


def dvae_phase(card: str) -> None:
    """The DVAE pass (docstring item 15)."""
    import torch

    from indextts_tpu_torch.models.codec import dvae
    from indextts_tpu_torch.nn import InitRng
    from indextts_tpu_torch.parallel.train import tree_map
    from indextts_tpu_torch.utils.jax_params import to_torch

    params = {"cuda": to_torch(dvae.init_dvae(InitRng(0, "cuda")))}
    params["cpu"] = tree_map(lambda p: p.cpu(), params["cuda"])
    r = np.random.default_rng(0)
    t = np.arange(int(22050 * DVAE_SECONDS)) / 22050
    wav = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * r.standard_normal(t.size))
    wav = torch.tensor(wav[None].astype(np.float32))
    out = {}

    def tokens(dev):
        mel = dvae.dvae_wav_to_mel(wav.to(dev)).transpose(1, 2).contiguous()
        return mel, dvae.dvae_codebook_indices(params[dev], mel)

    with torch.no_grad():
        for dev in ("cuda", "cpu"):
            out[dev] = tokens(dev)
        codes = out["cpu"][1]
        recon = {dev: dvae.dvae_decode(params[dev], codes.to(dev)).cpu()
                 for dev in ("cuda", "cpu")}
        ms = time_ms(lambda: dvae.dvae_decode(params["cuda"], tokens("cuda")[1]), iters=5)
    agree = (out["cuda"][1].cpu() == codes).float().mean().item()
    mel_rel = rel_l2(out["cuda"][0].cpu(), out["cpu"][0])
    recon_rel = rel_l2(recon["cuda"], recon["cpu"])
    print(f"DVAE (published defaults, a {DVAE_SECONDS:.0f} s wav): {tuple(codes.shape)} codes, "
          f"{100 * agree:.2f} % equal card vs host; mel rel-L2 {mel_rel:.3e}; reconstruction "
          f"{tuple(recon['cpu'].shape)} from the same codes rel-L2 {recon_rel:.3e}; mel, codes "
          f"and reconstruction {ms:.3f} ms on the card [{card}]", flush=True)
    assert agree >= DVAE_AGREE and torch.isfinite(recon["cuda"]).all(), agree


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing measured", file=sys.stderr)
        return 2
    try:
        from indextts_tpu_torch.ops import cuda
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    card = card_line()
    print(f"card: {card}", flush=True)
    print(sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda,
          flush=True)
    t0 = time.perf_counter()
    lib = cuda.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s -> {lib}", flush=True)
    log = (lib.parent / "build.log").read_text()
    print(log, flush=True)
    print("int8_gemv_kernel (csrc/int8_gemv.cu), registers / shared memory / spills a "
          "block:\n  " + "\n  ".join(build_lines(log, "int8_gemv_kernel")), flush=True)

    def mark(what):
        print(f"-- {what} at {time.perf_counter() - t0:.1f} s", flush=True)

    kres = kernel_phase(card)
    kres.update(attention_kernel_phase(card))
    kres.update(antialias_entries_phase(card))
    kres.update(int8_kernel_phase(card))
    kres.update(k1_group2_phase(card))
    kres.update(decode_attention_phase(card))
    kres.update(quant_kernel_phase(card, kres["fused_decode_step"]))
    n_k1 = k1_phase(card)
    mark(f"K1 phase done ({n_k1} cases bit-identical to the chain)")
    kres.update(tp_kernel_phase(card, kres))
    n_k6 = k6_phase(card)
    mark(f"K6 phase done ({n_k6} cases bit-identical to the chain)")
    phase_counts = read_counts()
    # the chains' kernels only: no pipeline caller on one card
    for name in ("int4_matvec", "int4_mlp", "decode_attention_kvq", "int8_matvec", "int8_mlp",
                 "decode_attention", "tp_allreduce"):
        kres[name]["launches"] = phase_counts[name]
    mark("kernel phase done")
    with tempfile.TemporaryDirectory(prefix="indextts_smoke_") as d:
        prompt = build_fake_assets(d)
        counts = {"bf16": pipeline_phase(card, prompt, d)}
        mark("bf16 pass done")
        counts["int8"], int8_reports = quant_pipeline_phase(card, prompt, d, "int8",
                                                            INT8_REQUESTS, True)
        mark("int8 pass done")
        with tempfile.TemporaryDirectory(prefix="indextts_ckpt_") as ckpt:
            counts["checkpoint"] = checkpoint_phase(card, prompt, d, ckpt, int8_reports[-1])
            mark("checkpoint pass done")
            counts["emo_text"] = emo_text_phase(card, prompt, ckpt)
            mark("emotion-text pass done")
        counts.update(sampling_pipeline_phase(card, prompt, d))
        mark("sampling pass done")
        for quantization, (n, profiled) in QUANT_PASSES.items():
            counts[quantization] = quant_pipeline_phase(card, prompt, d, quantization, n,
                                                        profiled)[0]
            mark(f"{quantization} pass done")
        counts.update(tp_pipeline_phase(card, prompt, d, int8_reports[-1]["gpt"]))
        mark("tp pass done")
        spec_int8, tts = spec_phase(card, prompt, d, "int8")
        mark("int8 speculative pass done")
        aux = aux_phase(tts, card, prompt)
        counts["aux_beam"] = aux["diverse beam"]
        del tts
        torch.cuda.empty_cache()
        mark("aux pass done")
        spec_bf16, tts = spec_phase(card, prompt, d)
        del tts
        torch.cuda.empty_cache()
        mark("bf16 speculative pass done")
        print("speculative decode, verify / single-step cost (eager, device): " + "; ".join(
            f"{label} {r['ratio']['ratio']:.3f}, {r['ratio']['graph_ratio']:.3f}"
            for label, r in (("int8", spec_int8), ("bf16", spec_bf16)))
            + f"; int8 decode busy {100 * spec_int8['busy']:.1f} %; the JAX gate "
            f"spec_commit_ratio({SPEC_GAMMA}) = {1.62 + 0.045 * SPEC_GAMMA:.2f} [{card}]",
            flush=True)
        lf_counts, lf_rows, lf_int8 = longform_phase(card, prompt, d)
        counts.update(lf_counts)
        kres.update(lf_rows)
        mark("streaming and long-form int8 passes done")
        counts["longform_bf16"], lf_bf16 = longform_bf16_phase(card, prompt, d)
        mark("long-form bf16 pass done")
        counts["v1"], kres["antialias_snake_v1_fp16"] = v1_phase(card, prompt, d)
        mark("v1 passes done")
        counts["fp16"], counts["fp16_flash"], _ = fp16_phase(card, prompt, d)
        mark("fp16 pass done")
        counts.update(mesh_phase(card, prompt, d))
        mark("mesh pass done")
        print("long-form stages (one request, 8 segments x 400 codes): " + "; ".join(
            f"{label} " + " ".join(f"{k}={st[k]:.4f}s" for k in
                                   ("gpt", "gpt_forward", "s2mel", "bigvgan", "total"))
            + f" audio={st['audio_s']:.4f}s RTF={st['rtf']:.4f}"
            for label, st in (("int8", lf_int8), ("bf16", lf_bf16))) + f" [{card}]", flush=True)
    train_phase(card)
    mark("training pass done")
    dvae_phase(card)
    mark("DVAE pass done")
    assert "jax" not in sys.modules, "the port imported jax"
    assert not any(m == "indextts_tpu" or m.startswith("indextts_tpu.") for m in sys.modules)

    k1 = "decode_step.py:460"
    k1_src = ("decode_step.cu", "gemv_core.cuh", "decode_attention_core.cuh")
    k6_src = k1_src
    # name, counter, sources (the first the row's "source"; a decode step's
    # time covers all of them), TPU kernel replaced, the pass whose
    # launches count (None: no pipeline caller, the kernel phase's launches)
    k2_src = ("attention_rope.cu", "attention_tma.cuh")
    specs = (("attention_rope", "attention_rope", k2_src, "attn.py:188", "bf16"),
             ("antialias_snake", "antialias_snake", "antialias_snake.cu", "antialias.py:269",
              "bf16"),
             ("fused_decode_step", "fused_decode_step", k1_src, k1, "int8"),
             ("decode_attention", None, ("decode_attention.cu", "decode_attention_core.cuh"),
              f"{k1} (attention, :257-419)", None),
             ("decode_attention_kvq", None, ("decode_attention.cu", "decode_attention_core.cuh"),
              f"{k1} (attention, KVQ)", None),
             ("int8_matvec", None, ("int8_gemv.cu", "gemv_core.cuh"), "int8_matmul.py:104",
              None),
             ("int8_mlp", None, ("int8_gemv.cu", "gemv_core.cuh"), "int8_matmul.py:71", None),
             ("fused_decode_step_kvq", "fused_decode_step", k1_src, f"{k1} (KVQ)", "int8kv"),
             ("fused_decode_step_w4", "fused_decode_step", k1_src, f"{k1} (W4)", "int4"),
             ("fused_decode_step_w4_kvq", "fused_decode_step", k1_src, f"{k1} (W4, KVQ)",
              "int4kv"),
             ("int4_matvec", None, ("int8_gemv.cu", "gemv_core.cuh"), f"{k1} (W4)", None),
             ("int4_mlp", None, ("int8_gemv.cu", "gemv_core.cuh"), f"{k1} (W4)", None),
             ("fused_decode_step_g1", "fused_decode_step", k1_src, f"{k1} (group=1)",
              "sampling"),
             ("fused_decode_step_g2", "fused_decode_step", k1_src,
              f"{k1} (group=2: diverse beam, 2 groups of 2)", "aux_beam"),
             ("single_block_attention", "single_block_attention",
              ("attention_block.cu", "attention_tma.cuh"), "attn.py:253", "flash"),
             ("packed_pair_attention", None, k2_src, "attn.py:76", None),
             ("fused_antialias_activation", None, "antialias_snake.cu", "antialias.py:457",
              None),
             ("antialias_activation_prefolded", None, "antialias_snake.cu", "antialias.py:322",
              None),
             ("fused_decode_step_tp", "fused_decode_step_tp", k6_src, "decode_step_tp.py:367",
              "tp"),
             ("fused_decode_step_tp_g1", "fused_decode_step_tp", k6_src,
              "decode_step_tp.py:367 (group=1)", "tp_sampling"),
             ("tp_allreduce", None, "tp_allreduce.cu",
              "decode_step_tp.py:367 (all_reduce, :201)", None),
             ("fused_decode_step_longform", "fused_decode_step", k1_src,
              f"{k1} (group=3, 24 rows: 8 segments x 3 beams)", "longform"),
             ("attention_rope_longform", "attention_rope", k2_src,
              "attn.py:188 (DiT batch 2B = 16 rows)", "longform"),
             ("antialias_snake_longform", "antialias_snake", "antialias_snake.cu",
              "antialias.py:269 (8 segment rows)", "longform"),
             ("antialias_snake_v1_fp16", "antialias_snake", "antialias_snake.cu",
              "antialias.py:269 (fp16: BigVGAN v1's four stage shapes)", "v1"),
             ("attention_rope_fp16", "attention_rope", k2_src,
              "attn.py:188 (fp16: IndexTTS2(use_fp16=True))", "fp16"),
             ("single_block_attention_fp16", "single_block_attention",
              ("attention_block.cu", "attention_tma.cuh"),
              "attn.py:253 (fp16: the flash tier of IndexTTS2(use_fp16=True))", "fp16_flash"),
             ("packed_pair_attention_fp16", None, k2_src, "attn.py:76 (fp16)", None))
    # where a row's launches come from when no pipeline pass launches it
    launched_in = {"tp_allreduce": "kernel phase (the chain's exchange; folded into K6's kernel "
                                   "on the co-located route, launched on two cards)"}
    kernels = []
    for name, counter, src, tpu, pass_ in specs:
        r = kres[name]
        srcs = [f"indextts_tpu_torch/csrc/{f}" for f in ((src,) if isinstance(src, str) else src)]
        kernels.append({"name": name, "route": "cuda", "source": srcs[0],
                        **({"sources": srcs} if len(srcs) > 1 else {}),
                        "replaces": f"indextts_tpu/ops/pallas/{tpu}",
                        "launches": r["launches"] if pass_ is None else counts[pass_][counter],
                        "launched_in": pass_ or launched_in.get(
                            name, "kernel phase (no pipeline caller)"),
                        "max_abs_err": r["abs"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        **r.get("spread", {})})
    for k, name in zip(kernels, (spec[0] for spec in specs)):
        r = kres[name]
        if "chain_ms" in r:   # K1, K6: the persistent kernel's eager time, the chain's as "was"
            k.update(eager_ms=r["eager_ms"], was_chain_ms=r["chain_ms"],
                     was_chain_eager_ms=r["chain_eager_ms"])
    assert all(math.isfinite(k["ms"]) and k["launches"] > 0 for k in kernels), kernels
    print(f"kernels line: ms and library_ms of attention_rope, packed_pair_attention, "
          f"single_block_attention, int8_matvec and int4_matvec are graph-replay medians of "
          f"{ATTN_REPS} (their rows' ms_timing; the GEMV rows at qkv, M=3, every shape under "
          f"'shapes'); the K1 and K6 rows' ms (graph replay) and eager_ms are the persistent "
          f"kernel's, was_chain_ms the chain it replaced in the same call; the standalone "
          f"GEMV, attention and tp_allreduce rows, the chains' kernels, count their launches "
          f"in the kernel phase; the *_longform rows are K1 at the long-form int8 request's "
          f"own inputs (two decode steps of 24 rows), K2 and K3 at the long-form synthesis's "
          f"rows of different lengths (the CFM's first DiT call of 16 rows, the vocoder's first "
          f"call of each stage shape over 8 rows), with the request's launches; "
          f"antialias_snake_v1_fp16 is K3 at fp16 at the v1 request's first call of each of "
          f"its four stage shapes, with that request's launches; fused_decode_step_g2 is K1 "
          f"at group=2 in the kernel phase, with the int8 diverse beam request's launches; "
          f"fused_decode_step_g1's launches are the sampling request's single steps of its "
          f"speculative decode; the *_fp16 attention rows are the kernels' fp16 "
          f"instantiations in the kernel phase at the bf16 rows' first shapes, with the fp16 "
          f"request's K2 launches and the fp16 flash-tier CFM call's K4 launches; every other "
          f"row as timed in its phase", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
