"""Text front end of the port: the JAX package's normalizer, pure-Python BPE
tokenizer and `build_model_file` (host code; nothing in their imports
reaches jax), named here so that users of the port import only the port."""

from indextts_tpu.text.front import TextNormalizer, TextTokenizer
from indextts_tpu.text.spm import build_model_file

__all__ = ["TextNormalizer", "TextTokenizer", "build_model_file"]
