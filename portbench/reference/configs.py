"""Configuration dataclasses, for the plain reference.

The benchmark's frozen copy of the port's `configs.py`: the four sub-configs
of the reference (`vibevoice/modular/configuration_vibevoice.py:13-241`) as
frozen dataclasses, read from a reference-style JSON config.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class AcousticTokenizerConfig:
    """sigma-VAE acoustic codec config (ref configuration_vibevoice.py:13-75)."""
    channels: int = 1
    vae_dim: int = 64
    fix_std: float = 0.5
    std_dist_type: str = "gaussian"  # 'fix' | 'gaussian' | 'none'
    # encoder
    encoder_n_filters: int = 32
    encoder_ratios: Tuple[int, ...] = (8, 5, 5, 4, 2, 2)
    encoder_depths: Tuple[int, ...] = (3, 3, 3, 3, 3, 3, 8)
    # decoder
    decoder_n_filters: int = 32
    decoder_ratios: Tuple[int, ...] = (8, 5, 5, 4, 2, 2)
    decoder_depths: Optional[Tuple[int, ...]] = None  # None -> reversed encoder depths
    # conv details
    kernel_size: int = 7
    last_kernel_size: int = 7
    conv_bias: bool = True
    causal: bool = True
    pad_mode: str = "constant"
    # norms / blocks
    layernorm: str = "RMSNorm"
    layernorm_eps: float = 1e-5
    layernorm_elementwise_affine: bool = True
    mixer_layer: str = "depthwise_conv"
    layer_scale_init_value: float = 1e-6
    disable_last_norm: bool = True
    ffn_expansion: int = 4
    weight_init_value: float = 0.01

    @property
    def hop_length(self) -> int:
        h = 1
        for r in self.encoder_ratios:
            h *= r
        return h

    @property
    def total_depths(self) -> Tuple[int, ...]:
        return self.encoder_depths

    def decoder_depths_resolved(self) -> Tuple[int, ...]:
        if self.decoder_depths is not None:
            return self.decoder_depths
        return tuple(reversed(self.encoder_depths))


@dataclass(frozen=True)
class SemanticTokenizerConfig:
    """Semantic encoder-only codec config (ref configuration_vibevoice.py:76-129)."""
    channels: int = 1
    vae_dim: int = 128
    fix_std: float = 0.0
    std_dist_type: str = "none"
    encoder_n_filters: int = 32
    encoder_ratios: Tuple[int, ...] = (8, 5, 5, 4, 2, 2)
    encoder_depths: Tuple[int, ...] = (3, 3, 3, 3, 3, 3, 8)
    kernel_size: int = 7
    last_kernel_size: int = 7
    conv_bias: bool = True
    causal: bool = True
    pad_mode: str = "constant"
    layernorm: str = "RMSNorm"
    layernorm_eps: float = 1e-5
    layernorm_elementwise_affine: bool = True
    mixer_layer: str = "depthwise_conv"
    layer_scale_init_value: float = 1e-6
    disable_last_norm: bool = True
    ffn_expansion: int = 4
    weight_init_value: float = 0.01

    @property
    def hop_length(self) -> int:
        h = 1
        for r in self.encoder_ratios:
            h *= r
        return h


@dataclass(frozen=True)
class DiffusionHeadConfig:
    """adaLN diffusion head config (ref configuration_vibevoice.py:130-163)."""
    hidden_size: int = 1536
    latent_size: int = 64
    head_layers: int = 4
    head_ffn_ratio: float = 3.0
    rms_norm_eps: float = 1e-5
    ddpm_num_steps: int = 1000
    ddpm_num_inference_steps: int = 20
    ddpm_beta_schedule: str = "cosine"
    ddpm_batch_mul: int = 4
    prediction_type: str = "v_prediction"
    diffusion_type: str = "ddpm"
    freq_embed_size: int = 256


@dataclass(frozen=True)
class Qwen2Config:
    """Qwen2 decoder config (ref vibevoice/configs/qwen2.5_1.5b_64k.json:43-64)."""
    vocab_size: int = 151936
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_hidden_layers: int = 28
    num_attention_heads: int = 12
    num_key_value_heads: int = 2
    max_position_embeddings: int = 65536
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    hidden_act: str = "silu"
    attention_bias: bool = True  # Qwen2 uses bias on q/k/v projections

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class VibeVoiceConfig:
    """Composite config (ref configuration_vibevoice.py:164-241)."""
    acoustic_tokenizer: AcousticTokenizerConfig = field(default_factory=AcousticTokenizerConfig)
    semantic_tokenizer: SemanticTokenizerConfig = field(default_factory=SemanticTokenizerConfig)
    diffusion_head: DiffusionHeadConfig = field(default_factory=DiffusionHeadConfig)
    decoder: Qwen2Config = field(default_factory=Qwen2Config)
    acoustic_vae_dim: int = 64
    semantic_vae_dim: int = 128

    @property
    def speech_compress_ratio(self) -> int:
        return self.acoustic_tokenizer.hop_length


def config_from_json(path: str) -> VibeVoiceConfig:
    """Load a reference-style JSON model config (HF layout) into the dataclasses."""
    with open(path) as f:
        return config_from_dict(json.load(f))


def config_from_dict(d: dict) -> VibeVoiceConfig:
    """The dataclasses of a reference-style config (HF layout); absent keys
    take the published 1.5B's values."""
    ac = d.get("acoustic_tokenizer_config", {})
    se = d.get("semantic_tokenizer_config", {})
    dh = d.get("diffusion_head_config", {})
    dec = d.get("decoder_config", {})

    def _depths(v):
        if v is None:
            return None
        if isinstance(v, str):
            return tuple(int(x) for x in v.split("-"))
        return tuple(v)

    return VibeVoiceConfig(
        acoustic_tokenizer=AcousticTokenizerConfig(
            channels=ac.get("channels", 1),
            vae_dim=ac.get("vae_dim", 64),
            fix_std=ac.get("fix_std", 0.5),
            std_dist_type=ac.get("std_dist_type", "gaussian"),
            encoder_n_filters=ac.get("encoder_n_filters", 32),
            encoder_ratios=tuple(ac.get("encoder_ratios", (8, 5, 5, 4, 2, 2))),
            encoder_depths=_depths(ac.get("encoder_depths", (3, 3, 3, 3, 3, 3, 8))),
            decoder_n_filters=ac.get("decoder_n_filters", 32),
            decoder_ratios=tuple(ac.get("decoder_ratios", (8, 5, 5, 4, 2, 2))),
            decoder_depths=_depths(ac.get("decoder_depths")),
            conv_bias=ac.get("conv_bias", True),
            causal=ac.get("causal", True),
            pad_mode=ac.get("pad_mode", "constant"),
            layernorm=ac.get("layernorm", "RMSNorm"),
            layernorm_eps=ac.get("layernorm_eps", 1e-5),
            layer_scale_init_value=ac.get("layer_scale_init_value", 1e-6),
            disable_last_norm=ac.get("disable_last_norm", True),
            mixer_layer=ac.get("mixer_layer", "depthwise_conv"),
            weight_init_value=ac.get("weight_init_value", 0.01),
        ),
        semantic_tokenizer=SemanticTokenizerConfig(
            channels=se.get("channels", 1),
            vae_dim=se.get("vae_dim", 128),
            fix_std=se.get("fix_std", 0.0),
            std_dist_type=se.get("std_dist_type", "none"),
            encoder_n_filters=se.get("encoder_n_filters", 32),
            encoder_ratios=tuple(se.get("encoder_ratios", (8, 5, 5, 4, 2, 2))),
            encoder_depths=_depths(se.get("encoder_depths", (3, 3, 3, 3, 3, 3, 8))),
            conv_bias=se.get("conv_bias", True),
            causal=se.get("causal", True),
            pad_mode=se.get("pad_mode", "constant"),
            layernorm=se.get("layernorm", "RMSNorm"),
            layernorm_eps=se.get("layernorm_eps", 1e-5),
            layer_scale_init_value=se.get("layer_scale_init_value", 1e-6),
            disable_last_norm=se.get("disable_last_norm", True),
            mixer_layer=se.get("mixer_layer", "depthwise_conv"),
            weight_init_value=se.get("weight_init_value", 0.01),
        ),
        diffusion_head=DiffusionHeadConfig(
            hidden_size=dh.get("hidden_size", 1536),
            latent_size=dh.get("latent_size", 64),
            head_layers=dh.get("head_layers", 4),
            head_ffn_ratio=dh.get("head_ffn_ratio", 3.0),
            rms_norm_eps=dh.get("rms_norm_eps", 1e-5),
            ddpm_num_steps=dh.get("ddpm_num_steps", 1000),
            ddpm_num_inference_steps=dh.get("ddpm_num_inference_steps", 20),
            ddpm_beta_schedule=dh.get("ddpm_beta_schedule", "cosine"),
            ddpm_batch_mul=dh.get("ddpm_batch_mul", 4),
            prediction_type=dh.get("prediction_type", "v_prediction"),
        ),
        decoder=Qwen2Config(
            vocab_size=dec.get("vocab_size", 151936),
            hidden_size=dec.get("hidden_size", 1536),
            intermediate_size=dec.get("intermediate_size", 8960),
            num_hidden_layers=dec.get("num_hidden_layers", 28),
            num_attention_heads=dec.get("num_attention_heads", 12),
            num_key_value_heads=dec.get("num_key_value_heads", 2),
            max_position_embeddings=dec.get("max_position_embeddings", 65536),
            rope_theta=dec.get("rope_theta", 1e6),
            rms_norm_eps=dec.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=dec.get("tie_word_embeddings", True),
        ),
        acoustic_vae_dim=d.get("acoustic_vae_dim", 64),
        semantic_vae_dim=d.get("semantic_vae_dim", 128),
    )


__all__ = [
    "AcousticTokenizerConfig",
    "SemanticTokenizerConfig",
    "DiffusionHeadConfig",
    "Qwen2Config",
    "VibeVoiceConfig",
    "config_from_json",
    "config_from_dict",
]
