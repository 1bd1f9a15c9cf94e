"""Bridge: live PyTorch modules in the reference's HF layout -> the port's
param trees.

The port's own copy of `vibevoice_tpu/utils/torch_bridge.py`.  The port keeps
the JAX package's public layouts, so the conversions are the same:

  torch Conv1d.weight          [Cout, Cin/g, K] -> ours [K, Cin/g, Cout]
  torch ConvTranspose1d.weight [Cin, Cout, K]   -> ours [Cin, K, Cout]
  torch Linear.weight          [Out, In]        -> ours [In, Out]

The name scheme follows the reference module tree (see
`vibevoice/scripts/convert_nnscaler_checkpoint_to_transformers.py:53` for the
reference's own name handling).  Every leaf is a detached, contiguous copy in
the module's dtype on `device`: CUDA unless `device="cpu"` is given.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..device import resolve_device


def _t(x, device) -> torch.Tensor:
    return x.detach().to(device)


def conv_w(w, device) -> torch.Tensor:
    return _t(w, device).permute(2, 1, 0).contiguous()


def convt_w(w, device) -> torch.Tensor:
    return _t(w, device).permute(0, 2, 1).contiguous()


def linear_w(w, device) -> torch.Tensor:
    return _t(w, device).t().contiguous()


def vec(w, device) -> torch.Tensor:
    return _t(w, device).clone()


def _opt(w, device):
    return None if w is None else vec(w, device)


def _sconv(m, device) -> Dict[str, Any]:
    conv = m.conv.conv  # SConv1d -> NormConv1d -> nn.Conv1d
    return {"w": conv_w(conv.weight, device), "b": _opt(conv.bias, device)}


def _sconvt(m, device) -> Dict[str, Any]:
    convtr = m.convtr.convtr
    return {"w": convt_w(convtr.weight, device), "b": _opt(convtr.bias, device)}


def _block(b, device) -> Dict[str, Any]:
    return {
        "norm_w": vec(b.norm.weight, device),
        "mixer": _sconv(b.mixer.conv, device),
        "gamma": vec(b.gamma, device),
        "ffn_norm_w": vec(b.ffn_norm.weight, device),
        "ffn1": {"w": linear_w(b.ffn.linear1.weight, device),
                 "b": _opt(b.ffn.linear1.bias, device)},
        "ffn2": {"w": linear_w(b.ffn.linear2.weight, device),
                 "b": _opt(b.ffn.linear2.bias, device)},
        "ffn_gamma": vec(b.ffn_gamma, device),
    }


def _final_norm(stack, device):
    return vec(stack.norm.weight, device) if hasattr(stack.norm, "weight") else None


def encoder_from_torch(enc, device="cuda") -> Dict[str, Any]:
    """reference TokenizerEncoder module -> the port's encoder params."""
    device = resolve_device(device)
    return {"down": [_sconv(seq[0], device) for seq in enc.downsample_layers],
            "stages": [[_block(b, device) for b in stage] for stage in enc.stages],
            "final_norm_w": _final_norm(enc, device), "head": _sconv(enc.head, device)}


def decoder_from_torch(dec, device="cuda") -> Dict[str, Any]:
    """reference TokenizerDecoder module -> the port's decoder params."""
    device = resolve_device(device)
    up = [_sconv(seq[0], device) if i == 0 else _sconvt(seq[0], device)
          for i, seq in enumerate(dec.upsample_layers)]
    return {"up": up, "stages": [[_block(b, device) for b in stage] for stage in dec.stages],
            "final_norm_w": _final_norm(dec, device), "head": _sconv(dec.head, device)}


def diffusion_head_from_torch(head, device="cuda") -> Dict[str, Any]:
    """reference VibeVoiceDiffusionHead -> the port's params
    (see models/diffusion_head.py)."""
    device = resolve_device(device)
    lw = lambda w: linear_w(w, device)  # noqa: E731
    return {
        "noisy_proj": lw(head.noisy_images_proj.weight),
        "cond_proj": lw(head.cond_proj.weight),
        "t_mlp1": lw(head.t_embedder.mlp[0].weight),
        "t_mlp2": lw(head.t_embedder.mlp[2].weight),
        "layers": [
            {
                "ada_w": lw(l.adaLN_modulation[1].weight),
                "norm_w": vec(l.norm.weight, device),
                "gate": lw(l.ffn.gate_proj.weight),
                "up": lw(l.ffn.up_proj.weight),
                "down": lw(l.ffn.down_proj.weight),
            }
            for l in head.layers
        ],
        "final_ada_w": lw(head.final_layer.adaLN_modulation[1].weight),
        "final_linear": lw(head.final_layer.linear.weight),
    }


def qwen2_from_torch(model, device="cuda") -> Dict[str, Any]:
    """transformers Qwen2Model -> the port's params (see models/qwen2.py)."""
    device = resolve_device(device)

    def proj(p, bias=True):
        return {"w": linear_w(p.weight, device),
                "b": _opt(p.bias, device) if bias else None}

    layers = []
    for l in model.layers:
        a = l.self_attn
        layers.append({
            "input_norm_w": vec(l.input_layernorm.weight, device),
            "q": proj(a.q_proj), "k": proj(a.k_proj), "v": proj(a.v_proj),
            "o": proj(a.o_proj, bias=False),
            "post_norm_w": vec(l.post_attention_layernorm.weight, device),
            "gate": linear_w(l.mlp.gate_proj.weight, device),
            "up": linear_w(l.mlp.up_proj.weight, device),
            "down": linear_w(l.mlp.down_proj.weight, device),
        })
    return {"embed": vec(model.embed_tokens.weight, device), "layers": layers,
            "final_norm_w": vec(model.norm.weight, device)}


def connector_from_torch(conn, device="cuda") -> Dict[str, Any]:
    """reference SpeechConnector (modeling_vibevoice.py:58-69) -> the port's params."""
    device = resolve_device(device)
    return {
        "fc1": {"w": linear_w(conn.fc1.weight, device), "b": vec(conn.fc1.bias, device)},
        "norm_w": vec(conn.norm.weight, device),
        "fc2": {"w": linear_w(conn.fc2.weight, device), "b": vec(conn.fc2.bias, device)},
    }


def vibevoice_params_from_torch(model, device="cuda") -> Dict[str, Any]:
    """Full reference model (`VibeVoiceForConditionalGeneration[Inference]`)
    -> the port's params tree (see models/vibevoice.py:init_model)."""
    device = resolve_device(device)
    core = model.model
    tied = bool(getattr(core.language_model.config, "tie_word_embeddings", False))
    return {
        "lm": qwen2_from_torch(core.language_model, device),
        "acoustic_encoder": encoder_from_torch(core.acoustic_tokenizer.encoder, device),
        "acoustic_decoder": decoder_from_torch(core.acoustic_tokenizer.decoder, device),
        "semantic_encoder": encoder_from_torch(core.semantic_tokenizer.encoder, device),
        "acoustic_connector": connector_from_torch(core.acoustic_connector, device),
        "semantic_connector": connector_from_torch(core.semantic_connector, device),
        "diffusion_head": diffusion_head_from_torch(core.prediction_head, device),
        "speech_scaling_factor": vec(core.speech_scaling_factor, device),
        "speech_bias_factor": vec(core.speech_bias_factor, device),
        "lm_head": None if tied else linear_w(model.lm_head.weight, device),
    }


__all__ = [
    "vibevoice_params_from_torch",
    "encoder_from_torch",
    "decoder_from_torch",
    "diffusion_head_from_torch",
    "qwen2_from_torch",
    "connector_from_torch",
    "conv_w",
    "convt_w",
    "linear_w",
    "vec",
]
