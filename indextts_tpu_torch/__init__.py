"""indextts_tpu_torch — the IndexTTS2 pipeline on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of the JAX package `indextts_tpu`, which stays the reference: the
modules mirror its layout and names, the host-only pieces it needs (config,
text front end, buckets, wav I/O, resampling) are its own copies, and nothing
here imports jax or the JAX package. Entry point:
`indextts_tpu_torch.pipeline.infer_v2.IndexTTS2`.
"""
