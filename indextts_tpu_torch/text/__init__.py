"""Text front end of the port: normalizer, pure-Python BPE tokenizer and
`build_model_file` (host code, copied from the JAX package's `text/`)."""

from indextts_tpu_torch.text.front import TextNormalizer, TextTokenizer
from indextts_tpu_torch.text.spm import build_model_file

__all__ = ["TextNormalizer", "TextTokenizer", "build_model_file"]
