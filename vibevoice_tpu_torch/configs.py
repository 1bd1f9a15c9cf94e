"""Configuration dataclasses of the PyTorch port.

The port's own copy of `vibevoice_tpu/configs.py` (the port imports nothing of
the JAX package): the four sub-configs of the reference
(`vibevoice/modular/configuration_vibevoice.py:13-241`) as frozen dataclasses.
Presets reproduce `vibevoice/configs/qwen2.5_1.5b_64k.json` and
`qwen2.5_7b_32k.json`.  The LM is Qwen2 (`Qwen2Config`) or DeepSeek-V2
(`DeepseekV2Config`: latent attention and a mixture of experts), chosen by the
`model_type` of the JSON config's `decoder_config`.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union


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
class DeepseekV2Config:
    """DeepSeek-V2 decoder config (huggingface.co/deepseek-ai/DeepSeek-V2-Lite
    config.json; the defaults are DeepSeek-V2-Lite's): multi-head latent
    attention without a q compression, YaRN RoPE on the rope part of q and k,
    and DeepSeekMoE (`first_k_dense_replace` dense SwiGLU layers, then routed
    experts with a softmax router, greedy top-k, and shared experts)."""
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    routed_scaling_factor: float = 1.0
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    max_position_embeddings: int = 163840
    rope_theta: float = 10000.0
    # rope_scaling {"type": "yarn", ...}
    rope_factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Width of a cache slot: the compressed kv and the roped k_pe."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace and layer % self.moe_layer_freq == 0


def deepseek_v2_from_dict(dec: dict) -> DeepseekV2Config:
    """The DeepSeek-V2 decoder of an HF-layout `config.json` dict; keys whose
    other values the port does not implement raise."""
    rs = dec.get("rope_scaling") or {}
    if rs and rs.get("type", "yarn") != "yarn":
        raise ValueError(f"rope_scaling type {rs.get('type')!r} is not supported")
    unsupported = {"q_lora_rank": None, "scoring_func": "softmax", "topk_method": "greedy",
                   "hidden_act": "silu", "attention_bias": False, "norm_topk_prob": False}
    for k, want in unsupported.items():
        if dec.get(k, want) != want:
            raise ValueError(f"DeepSeek-V2 {k}={dec[k]!r} is not supported (only {want!r})")
    d = DeepseekV2Config()
    kw = {f.name: dec[f.name] for f in dataclasses.fields(DeepseekV2Config) if f.name in dec}
    if rs:
        kw.update(rope_factor=rs.get("factor", d.rope_factor),
                  original_max_position_embeddings=rs.get(
                      "original_max_position_embeddings", d.original_max_position_embeddings),
                  beta_fast=rs.get("beta_fast", d.beta_fast),
                  beta_slow=rs.get("beta_slow", d.beta_slow),
                  mscale=rs.get("mscale", d.mscale),
                  mscale_all_dim=rs.get("mscale_all_dim", d.mscale_all_dim))
    else:
        kw.update(rope_factor=1.0)
    return DeepseekV2Config(**kw)


@dataclass(frozen=True)
class VibeVoiceConfig:
    """Composite config (ref configuration_vibevoice.py:164-241)."""
    acoustic_tokenizer: AcousticTokenizerConfig = field(default_factory=AcousticTokenizerConfig)
    semantic_tokenizer: SemanticTokenizerConfig = field(default_factory=SemanticTokenizerConfig)
    diffusion_head: DiffusionHeadConfig = field(default_factory=DiffusionHeadConfig)
    decoder: Union[Qwen2Config, DeepseekV2Config] = field(default_factory=Qwen2Config)
    acoustic_vae_dim: int = 64
    semantic_vae_dim: int = 128

    @property
    def speech_compress_ratio(self) -> int:
        return self.acoustic_tokenizer.hop_length


def vibevoice_1_5b() -> VibeVoiceConfig:
    """VibeVoice-1.5B, 64K context (ref configs/qwen2.5_1.5b_64k.json)."""
    return VibeVoiceConfig()


def vibevoice_7b() -> VibeVoiceConfig:
    """VibeVoice-Large (7B-class), 32K context (ref configs/qwen2.5_7b_32k.json)."""
    return VibeVoiceConfig(
        decoder=Qwen2Config(
            vocab_size=152064,
            hidden_size=3584,
            intermediate_size=18944,
            num_hidden_layers=28,
            num_attention_heads=28,
            num_key_value_heads=4,
            max_position_embeddings=32768,
            tie_word_embeddings=False,
        ),
        diffusion_head=DiffusionHeadConfig(hidden_size=3584),
    )


def tiny_config(
    hidden_size: int = 64,
    layers: int = 2,
    vocab_size: int = 256,
    n_filters: int = 4,
    ratios: Tuple[int, ...] = (4, 2, 2),
    depths: Tuple[int, ...] = (1, 1, 1, 2),
) -> VibeVoiceConfig:
    """Small config for tests: same topology, tiny dims (hop = prod(ratios))."""
    return VibeVoiceConfig(
        acoustic_tokenizer=AcousticTokenizerConfig(
            vae_dim=8, encoder_n_filters=n_filters, decoder_n_filters=n_filters,
            encoder_ratios=ratios, decoder_ratios=ratios, encoder_depths=depths,
        ),
        semantic_tokenizer=SemanticTokenizerConfig(
            vae_dim=16, encoder_n_filters=n_filters,
            encoder_ratios=ratios, encoder_depths=depths,
        ),
        diffusion_head=DiffusionHeadConfig(
            hidden_size=hidden_size, latent_size=8, head_layers=2,
            ddpm_num_steps=100, ddpm_num_inference_steps=4,
        ),
        decoder=Qwen2Config(
            vocab_size=vocab_size, hidden_size=hidden_size, intermediate_size=hidden_size * 2,
            num_hidden_layers=layers, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512,
        ),
        acoustic_vae_dim=8,
        semantic_vae_dim=16,
    )


def config_from_json(path: str) -> VibeVoiceConfig:
    """Load a reference-style JSON model config (HF layout) into our dataclasses."""
    with open(path) as f:
        d = json.load(f)
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

    if dec.get("model_type") == "deepseek_v2":
        decoder = deepseek_v2_from_dict(dec)
    else:
        decoder = Qwen2Config(
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
        )
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
        decoder=decoder,
        acoustic_vae_dim=d.get("acoustic_vae_dim", 64),
        semantic_vae_dim=d.get("semantic_vae_dim", 128),
    )


__all__ = [
    "AcousticTokenizerConfig",
    "SemanticTokenizerConfig",
    "DiffusionHeadConfig",
    "Qwen2Config",
    "DeepseekV2Config",
    "deepseek_v2_from_dict",
    "VibeVoiceConfig",
    "vibevoice_1_5b",
    "vibevoice_7b",
    "tiny_config",
    "config_from_json",
]
