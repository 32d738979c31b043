"""indextts_tpu_torch — the IndexTTS2 pipeline on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of the JAX package `indextts_tpu`, which stays the reference: the
modules mirror its layout and names, host-only pieces (config, text front
end, buckets, wav I/O, resampling) are imported from it, and nothing here
imports jax. Entry point: `indextts_tpu_torch.pipeline.infer_v2.IndexTTS2`.
"""
