"""Typed configuration of the PyTorch port (a copy of the JAX package's
`indextts_tpu/config.py`, kept in the port so that it imports nothing of that
package).

Mirrors the reference's ``config.yaml`` key layout (the OmegaConf tree consumed
by the upstream ``indextts/infer_v2.py:82-210``) as plain frozen dataclasses,
so the whole config is static and hashable.

All hyperparameters are config-driven; the defaults below describe the shipped
IndexTTS-2 checkpoint family (GPT latent dim 1280 per the reference's s2mel
``gpt_layer = Linear(1280, 256)``, `s2mel/modules/commons.py:415`; mel front-end
22.05 kHz / 80 mel / hop 256 per `s2mel/modules/bigvgan/config.json`). When a
real ``config.yaml`` is present in the model dir it overrides everything; it
is read without PyYAML (`utils/yaml_subset.py`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from indextts_tpu_torch.utils import yaml_subset


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _filter_kwargs(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


# ---------------------------------------------------------------------------
# GPT (UnifiedVoice) config — reference `gpt/model_v2.py:305-310` kwargs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ConditionModuleConfig:
    """Conformer conditioning encoder config (reference `model_v2.py:352-363`)."""

    output_size: int = 512
    linear_units: int = 2048
    attention_heads: int = 8
    num_blocks: int = 6
    input_layer: str = "conv2d2"
    perceiver_mult: int = 2

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ConditionModuleConfig":
        return cls(**_filter_kwargs(cls, d)) if d else cls()


@dataclass(frozen=True)
class GPTConfig:
    """UnifiedVoice-v2 hyperparameters (reference `gpt/model_v2.py:305-310`)."""

    layers: int = 24
    model_dim: int = 1280
    heads: int = 20
    max_text_tokens: int = 600
    max_mel_tokens: int = 1815
    max_conditioning_inputs: int = 1
    mel_length_compression: int = 1024
    number_text_tokens: int = 12000
    start_text_token: int = 0
    stop_text_token: int = 1
    number_mel_codes: int = 8194
    start_mel_token: int = 8192
    stop_mel_token: int = 8193
    types: int = 1
    condition_num_latent: int = 32
    condition_type: str = "conformer_perceiver"
    # dim of the w2v-bert conditioning features fed to the conformers
    # (hardcoded 1024 in the reference, model_v2.py:353,367)
    cond_input_dim: int = 1024
    condition_module: ConditionModuleConfig = field(default_factory=ConditionModuleConfig)
    emo_condition_module: ConditionModuleConfig = field(
        default_factory=lambda: ConditionModuleConfig(
            output_size=512, linear_units=1024, attention_heads=4, num_blocks=4
        )
    )
    use_mel_codes_as_input: bool = True

    @property
    def head_dim(self) -> int:
        return self.model_dim // self.heads

    @property
    def max_mel_positions(self) -> int:
        # reference `model_v2.py:388-390`: mel pos table = max_mel_tokens + 2 + max_conditioning_inputs
        return self.max_mel_tokens + 2 + self.max_conditioning_inputs

    @property
    def max_text_positions(self) -> int:
        return self.max_text_tokens + 2

    @property
    def text_vocab_size(self) -> int:
        # reference `model_v2.py:380`: number_text_tokens * types + 1
        return self.number_text_tokens * self.types + 1

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "GPTConfig":
        if not d:
            return cls()
        d = dict(d)
        d.pop("train_solo_embeddings", None)
        d.pop("checkpointing", None)
        d.pop("use_accel", None)
        if "condition_module" in d:
            d["condition_module"] = ConditionModuleConfig.from_dict(d["condition_module"])
        if "emo_condition_module" in d:
            d["emo_condition_module"] = ConditionModuleConfig.from_dict(d["emo_condition_module"])
        return cls(**_filter_kwargs(cls, d))


# ---------------------------------------------------------------------------
# Semantic codec (RepCodec) — reference `kmeans/repcodec_model.py:34-104`
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SemanticCodecConfig:
    codebook_size: int = 8192
    hidden_size: int = 1024
    codebook_dim: int = 8
    vocos_dim: int = 384
    vocos_intermediate_dim: int = 2048
    vocos_num_layers: int = 12
    num_quantizers: int = 1
    downsample_scale: int = 1

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "SemanticCodecConfig":
        return cls(**_filter_kwargs(cls, d)) if d else cls()


# ---------------------------------------------------------------------------
# s2mel — DiT + CFM + length regulator (reference `s2mel/modules/*`)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SpectParams:
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 256
    n_mels: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "SpectParams":
        if not d:
            return cls()
        d = dict(d)
        if d.get("fmax") in ("None", "none", ""):
            d["fmax"] = None
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True)
class PreprocessParams:
    sr: int = 22050
    spect_params: SpectParams = field(default_factory=SpectParams)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "PreprocessParams":
        if not d:
            return cls()
        return cls(
            sr=d.get("sr", 22050),
            spect_params=SpectParams.from_dict(d.get("spect_params")),
        )


@dataclass(frozen=True)
class DiTConfig:
    """DiT backbone (reference `diffusion_transformer.py:103-181` + gpt_fast args)."""

    hidden_dim: int = 512
    num_heads: int = 8
    depth: int = 13
    class_dropout_prob: float = 0.1
    block_size: int = 16384
    in_channels: int = 80
    content_dim: int = 512
    content_codebook_size: int = 1024
    content_type: str = "discrete"
    is_causal: bool = False
    long_skip_connection: bool = True
    uvit_skip_connection: bool = False
    time_as_token: bool = False
    style_as_token: bool = False
    style_condition: bool = True
    final_layer_type: str = "wavenet"
    target: str = "mel"
    zero_prompt_speech_token: bool = False
    rope_base: float = 10000.0
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @property
    def intermediate_size(self) -> int:
        # gpt_fast default: find_multiple(int(2 * 4 * dim / 3), 256)
        n_hidden = int(2 * (4 * self.hidden_dim) / 3)
        k = 256
        return n_hidden if n_hidden % k == 0 else n_hidden + k - (n_hidden % k)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "DiTConfig":
        return cls(**_filter_kwargs(cls, d)) if d else cls()


@dataclass(frozen=True)
class WaveNetConfig:
    hidden_dim: int = 512
    num_layers: int = 8
    kernel_size: int = 5
    dilation_rate: int = 1
    p_dropout: float = 0.2
    style_condition: bool = True

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "WaveNetConfig":
        return cls(**_filter_kwargs(cls, d)) if d else cls()


@dataclass(frozen=True)
class LengthRegulatorConfig:
    # NOTE: the shipped pipeline feeds *continuous* codec embeddings
    # (quantized w2v-bert features / vq2emb outputs, both 1024-d) into the
    # regulator (`infer_v2.py:454,648-656`), so is_discrete=False with a
    # 1024-d content_in_proj.
    channels: int = 512
    is_discrete: bool = False
    content_codebook_size: int = 8192
    in_channels: Optional[int] = 1024
    out_channels: Optional[int] = None
    sampling_ratios: Tuple[int, ...] = (1, 1, 1, 1)
    vector_quantize: bool = False
    n_codebooks: int = 1
    quantizer_dropout: float = 0.0
    f0_condition: bool = False
    n_f0_bins: int = 512

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "LengthRegulatorConfig":
        if not d:
            return cls()
        d = dict(d)
        if "sampling_ratios" in d and d["sampling_ratios"] is not None:
            d["sampling_ratios"] = tuple(d["sampling_ratios"])
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True)
class StyleEncoderConfig:
    dim: int = 192

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "StyleEncoderConfig":
        return cls(**_filter_kwargs(cls, d)) if d else cls()


@dataclass(frozen=True)
class S2MelConfig:
    preprocess_params: PreprocessParams = field(default_factory=PreprocessParams)
    dit_type: str = "DiT"
    reg_loss_type: str = "l1"
    style_encoder: StyleEncoderConfig = field(default_factory=StyleEncoderConfig)
    length_regulator: LengthRegulatorConfig = field(default_factory=LengthRegulatorConfig)
    DiT: DiTConfig = field(default_factory=DiTConfig)
    wavenet: WaveNetConfig = field(default_factory=WaveNetConfig)
    # gpt latent projection: Linear(1280->256->128->1024), reference commons.py:415
    gpt_dim: int = 1280
    gpt_proj_dims: Tuple[int, ...] = (256, 128, 1024)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "S2MelConfig":
        if not d:
            return cls()
        return cls(
            preprocess_params=PreprocessParams.from_dict(d.get("preprocess_params")),
            dit_type=d.get("dit_type", "DiT"),
            reg_loss_type=d.get("reg_loss_type", "l1"),
            style_encoder=StyleEncoderConfig.from_dict(d.get("style_encoder")),
            length_regulator=LengthRegulatorConfig.from_dict(d.get("length_regulator")),
            DiT=DiTConfig.from_dict(d.get("DiT")),
            wavenet=WaveNetConfig.from_dict(d.get("wavenet")),
        )


# ---------------------------------------------------------------------------
# BigVGAN-v2 vocoder — `s2mel/modules/bigvgan/config.json`
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BigVGANConfig:
    num_mels: int = 80
    upsample_rates: Tuple[int, ...] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock: str = "1"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True
    use_tanh_at_final: bool = False
    use_bias_at_final: bool = False
    sampling_rate: int = 22050

    @property
    def total_upsample(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "BigVGANConfig":
        if not d:
            return cls()
        d = dict(d)
        for k in ("upsample_rates", "upsample_kernel_sizes", "resblock_kernel_sizes"):
            if k in d and d[k] is not None:
                d[k] = tuple(d[k])
        if "resblock_dilation_sizes" in d and d["resblock_dilation_sizes"] is not None:
            d["resblock_dilation_sizes"] = tuple(tuple(x) for x in d["resblock_dilation_sizes"])
        return cls(**_filter_kwargs(cls, d))


# ---------------------------------------------------------------------------
# v1 (IndexTTS-1 / 1.5) family
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BigVGANV1Config:
    """BigVGAN v1: GPT-latent conditioned, ECAPA speaker embedding
    (reference `BigVGAN/models.py:131-260`)."""

    gpt_dim: int = 1280
    num_mels: int = 100
    upsample_rates: Tuple[int, ...] = (4, 4, 4, 4)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 8, 8)
    upsample_initial_channel: int = 1536
    resblock: str = "1"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True
    feat_upsample: bool = True
    cond_d_vector_in_each_upsampling_layer: bool = True
    speaker_embedding_dim: int = 512
    sampling_rate: int = 24000

    @property
    def total_upsample(self) -> int:
        out = 4 if self.feat_upsample else 1
        for r in self.upsample_rates:
            out *= r
        return out

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "BigVGANV1Config":
        if not d:
            return cls()
        d = dict(d)
        for k in ("upsample_rates", "upsample_kernel_sizes", "resblock_kernel_sizes"):
            if k in d and d[k] is not None:
                d[k] = tuple(d[k])
        if d.get("resblock_dilation_sizes") is not None:
            d["resblock_dilation_sizes"] = tuple(tuple(x) for x in d["resblock_dilation_sizes"])
        if "cond_d_vector_in_each_upsampling_layer" not in d and "cond_in_each_up_layer" in d:
            d["cond_d_vector_in_each_upsampling_layer"] = d["cond_in_each_up_layer"]
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True)
class IndexTTS1Config:
    """Top-level config for the v1 family (reference `infer.py` + v1 config.yaml)."""

    version: str = "1.5"
    gpt: GPTConfig = field(default_factory=lambda: GPTConfig(
        layers=24, model_dim=1280, heads=20, max_text_tokens=600,
        max_mel_tokens=800, number_text_tokens=12000, cond_input_dim=100,
        condition_type="conformer_perceiver"))
    gpt_checkpoint: str = "gpt.pth"
    bigvgan: BigVGANV1Config = field(default_factory=BigVGANV1Config)
    bigvgan_checkpoint: str = "bigvgan_generator.pth"
    dataset: dict = field(default_factory=lambda: {"bpe_model": "bpe.model"})
    engine: EngineConfig = field(default_factory=lambda: EngineConfig())

    @classmethod
    def from_dict(cls, d: dict) -> "IndexTTS1Config":
        kwargs: dict = {}
        if "version" in d:
            kwargs["version"] = str(d["version"])
        if "gpt" in d:
            g = dict(d["gpt"])
            g.setdefault("cond_input_dim", 100)
            kwargs["gpt"] = GPTConfig.from_dict(g)
        if "bigvgan" in d:
            kwargs["bigvgan"] = BigVGANV1Config.from_dict(d["bigvgan"])
        for k in ("gpt_checkpoint", "bigvgan_checkpoint"):
            if k in d:
                kwargs[k] = d[k]
        if "dataset" in d:
            kwargs["dataset"] = dict(d["dataset"])
        return cls(**kwargs)


def load_config_v1(path: str) -> IndexTTS1Config:
    """Load a v1 config.yaml (`utils/yaml_subset.py`: no PyYAML)."""
    return IndexTTS1Config.from_dict(yaml_subset.load(path) or {})


# ---------------------------------------------------------------------------
# w2v-bert-2.0 encoder — conditioning feature extractor
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class W2VBertConfig:
    """facebook/w2v-bert-2.0 architecture (conformer encoder over 160-d fbank stacks)."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    feature_projection_input_dim: int = 160
    num_mel_bins: int = 80
    position_embeddings_type: str = "relative_key"
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    conv_depthwise_kernel_size: int = 31
    output_hidden_layer: int = 17  # reference uses hidden_states[17], infer_v2.py:232
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "W2VBertConfig":
        return cls(**_filter_kwargs(cls, d)) if d else cls()


# ---------------------------------------------------------------------------
# Runtime / engine knobs (shape buckets; no reference analogue)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EngineConfig:
    """Decode-engine + compilation bucketing knobs."""

    # shape buckets so text/mel length variance doesn't trigger recompiles
    text_buckets: Tuple[int, ...] = (32, 64, 120, 256, 600)
    # multiples of 128 so padded mel/CFM/vocoder work tracks the true length
    # closely (a 344-frame target pads to 384, not 512); buckets compile
    # lazily, so unused sizes cost nothing
    # extends through the reference's serving envelope: max_mel_tokens=1500
    # codes -> 2581 mel frames (infer_v2.py:534, mel_per_code 1.72) needs the
    # 2688 bucket; the DiT block_size is 16384 so nothing above caps it
    mel_len_buckets: Tuple[int, ...] = (128, 256, 384, 512, 640, 768, 896,
                                        1024, 1280, 1536, 2048, 2304, 2688,
                                        3072)
    cond_len_buckets: Tuple[int, ...] = (128, 256, 512, 768)
    max_decode_tokens: int = 1500
    dtype: str = "bfloat16"
    donate_kv_cache: bool = True
    # decode all text segments as one left-padded batch (sampling path only):
    # the AR loop is HBM-bound on weight reads, so B segments decode in
    # ~the time of one. Disabled automatically for streaming/beam search.
    batch_segments: bool = True


# ---------------------------------------------------------------------------
# Top-level config — mirrors config.yaml root keys (infer_v2.py:82-210)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class IndexTTS2Config:
    version: str = "2.0"
    gpt: GPTConfig = field(default_factory=GPTConfig)
    gpt_checkpoint: str = "gpt.pth"
    s2mel: S2MelConfig = field(default_factory=S2MelConfig)
    s2mel_checkpoint: str = "s2mel.pth"
    semantic_codec: SemanticCodecConfig = field(default_factory=SemanticCodecConfig)
    bigvgan: BigVGANConfig = field(default_factory=BigVGANConfig)
    w2v_bert: W2VBertConfig = field(default_factory=W2VBertConfig)
    w2v_stat: str = "wav2vec2bert_stats.pt"
    qwen_emo_path: str = "qwen0.6bemo4-merge"
    emo_matrix: str = "feat1.pt"
    spk_matrix: str = "feat2.pt"
    emo_num: Tuple[int, ...] = (8, 9, 9, 5, 10, 8, 9, 8)
    dataset: dict = field(default_factory=lambda: {"bpe_model": "bpe.model"})
    engine: EngineConfig = field(default_factory=EngineConfig)

    @classmethod
    def from_dict(cls, d: dict) -> "IndexTTS2Config":
        d = dict(d)
        kwargs: dict[str, Any] = {}
        if "version" in d:
            kwargs["version"] = str(d["version"])
        kwargs["gpt"] = GPTConfig.from_dict(d.get("gpt"))
        kwargs["s2mel"] = S2MelConfig.from_dict(d.get("s2mel"))
        kwargs["semantic_codec"] = SemanticCodecConfig.from_dict(d.get("semantic_codec"))
        kwargs["bigvgan"] = BigVGANConfig.from_dict(d.get("bigvgan"))
        kwargs["w2v_bert"] = W2VBertConfig.from_dict(d.get("w2v_bert"))
        for k in ("gpt_checkpoint", "s2mel_checkpoint", "w2v_stat", "qwen_emo_path",
                  "emo_matrix", "spk_matrix"):
            if k in d:
                kwargs[k] = d[k]
        if "emo_num" in d:
            kwargs["emo_num"] = tuple(d["emo_num"])
        if "dataset" in d:
            kwargs["dataset"] = dict(d["dataset"])
        return cls(**kwargs)


def load_config(path: str) -> IndexTTS2Config:
    """Load a reference-layout config.yaml into typed dataclasses. The file
    is read by `utils/yaml_subset.py` (PyYAML's ``safe_load`` results on the
    subset the reference configs use; no PyYAML)."""
    return IndexTTS2Config.from_dict(yaml_subset.load(path) or {})
