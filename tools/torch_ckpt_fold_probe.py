#!/usr/bin/env python3
"""How far the weight-norm fold's rounding moves a full-width request, on one
card.

chip_smoke.py's checkpoint pass writes the random-weight int8 model as the
released model directory and holds the model read back from it against the
original. The released files keep BigVGAN's, the DiT's and RepCodec's
weight-normed modules as (weight_g, weight_v) pairs; written plainly (g =
||w||, v = w), the loaders' fold g * v / ||v|| returns w within 1 f32 ulp,
and a few elements then land on the other side of a bf16 rounding boundary.
This script writes the directory that way (`write_model_dir` without
``match_dtype``), loads it at int8, and runs one num_beams=3, do_sample=False
request on each model with the generator reseeded alike. It prints the
elements that differ per family, and rel-L2 between the two requests at
the CFM's output, the bf16 mel the vocoder takes, the vocoder's wav and the
int16 wav, then the same with the random-weight model's BigVGAN in the
loaded one (the DiT's differences alone).

    python3 tools/torch_ckpt_fold_probe.py      # from the repository root

Needs about 7 GB free under the temporary directory.
"""

import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
import torch_reference_ckpt as refckpt  # noqa: E402
from indextts_tpu_torch.ops import cuda  # noqa: E402
from indextts_tpu_torch.pipeline import infer_v2  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ckpt_fold_probe: CUDA is not available", file=sys.stderr)
        return 2
    card = cs.card_line()
    cuda.build()
    seen = {}
    bigvgan, cfm = infer_v2.bigvgan_forward, infer_v2.cfm_inference

    def bigvgan_seen(p, h, mel, lens):
        out = bigvgan(p, h, mel, lens)
        seen["mel"], seen["wav"] = mel.float().clone(), out.float().clone()
        return out

    def cfm_seen(*args, **kwargs):
        out = cfm(*args, **kwargs)
        seen["cfm"] = out.float().clone()
        return out

    infer_v2.bigvgan_forward, infer_v2.cfm_inference = bigvgan_seen, cfm_seen

    def request(model):
        model.generator.manual_seed(1234)
        _, wav = model.infer(spk_audio_prompt=prompt, text=cs.SENTENCE, output_path=None,
                             max_mel_tokens=400, min_new_tokens=399, num_beams=3,
                             do_sample=False)
        return {**seen, "int16": torch.as_tensor(wav.astype(np.float64))}

    def rel(a, b):
        return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))

    with tempfile.TemporaryDirectory() as assets, tempfile.TemporaryDirectory() as d:
        prompt = cs.build_fake_assets(assets)
        ref = infer_v2.IndexTTS2(cfg_path=None, model_dir=assets, device="cuda", seed=0,
                                 quantization="int8")
        trees = ref.random_params(0)
        refckpt.write_model_dir(d, trees, ref.cfg)
        del trees
        cs.build_fake_assets(d)
        torch.cuda.empty_cache()
        tts = infer_v2.IndexTTS2(cfg_path=os.path.join(d, "config.yaml"), model_dir=d,
                                 device="cuda", quantization="int8", allow_random_init=False)
        a, b = cs._state_leaves(tts), cs._state_leaves(ref)
        per = {}
        for path, x in a.items():
            n = int((x != b[path]).sum())
            if n:
                fam = per.setdefault(path.split("/")[1], [0, 0, 0])
                fam[0] += 1
                fam[1] += n
                fam[2] += x.numel()
        for fam, (leaves, n, numel) in per.items():
            print(f"{fam}: {n} elements of {numel} differ, in {leaves} leaves", flush=True)
        request(tts)
        request(ref)
        r, t = request(ref), request(tts)
        for k in ("cfm", "mel", "wav", "int16"):
            print(f"{k}: rel_l2 {rel(t[k], r[k]):.3e}, elements differing "
                  f"{int((t[k] != r[k]).sum())} of {r[k].numel()}, max |ref| "
                  f"{float(r[k].abs().max()):.4g} [{card}]", flush=True)
        tts.bigvgan_params = ref.bigvgan_params
        t = request(tts)
        print(f"with the random-weight model's BigVGAN: cfm {rel(t['cfm'], r['cfm']):.3e}, "
              f"int16 wav {rel(t['int16'], r['int16']):.3e} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
