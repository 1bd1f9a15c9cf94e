"""Weight-only quantization of the decode path (A7).

Port of `vibevoice_tpu/utils/quantize.py`; the quantized values and scales
equal the JAX package's bit for bit, and the trees have its layout:

  * int8: symmetric per-output-channel, {"qint8": int8, "scale": bf16 [out]}
    (q is computed with the fp32 scale; the bf16 scale is what is stored);
  * int4: nibble-packed, {"qint4": int8 [K/2, N], "scale4": fp32 [1|G, N]}
    (`ops.int4_matmul`); `mm` sends a call of at most 128 rows to the CUDA
    kernel and dequantizes for larger ones (prefill).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..ops.int4_matmul import dequant_int4, int4_matmul, quantize_int4

_KERNEL_MAX_ROWS = 128
_RECIP_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def _quantize_weight_impl(w: torch.Tensor, axis: int):
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    # XLA folds the division by a constant into a product with its fp32
    # reciprocal; the same product keeps the scales bit-equal to the JAX package's
    scale = amax * _RECIP_127
    q = torch.clamp(torch.round(wf / torch.clamp_min(scale, 1e-12)), -127, 127)
    return q.to(torch.int8).contiguous(), scale.squeeze(axis).to(torch.bfloat16)


def quantize_weight(w: torch.Tensor, axis: int = 0) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8: w [in, out] -> int8 + bf16 scale [out]
    (`axis=1` gives per-row scales, for the embedding table)."""
    q, scale = _quantize_weight_impl(w, axis)
    return {"qint8": q, "scale": scale}


def quantize_weight_int4(w: torch.Tensor, group_size: Optional[int] = None):
    return quantize_int4(w, group_size=group_size)


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul that accepts plain, int8-quantized or int4-quantized weights."""
    if isinstance(w, dict):
        if "qint4" in w:
            k = x.shape[-1]
            lead = x.shape[:-1]
            m = 1
            for d in lead:
                m *= int(d)
            if m <= _KERNEL_MAX_ROWS:
                # decode GEMV / skinny matmul: the int4 kernel
                y = int4_matmul(x.reshape(m, k).contiguous(), w["qint4"], w["scale4"])
                return y.reshape(*lead, y.shape[-1])
            # prefill: the weight read amortizes over many rows, a
            # materialized dequantization is fine
            return x @ dequant_int4(w["qint4"], w["scale4"], x.dtype)
        y = x @ w["qint8"].to(x.dtype)
        return y * w["scale"].to(x.dtype)
    return x @ w


def _quant(w, mode: str, group_size: Optional[int]):
    if mode == "int4":
        return quantize_weight_int4(w, group_size=group_size)
    return quantize_weight(w)


def quantize_lm_layer(lp: Dict[str, Any], mode: str = "int8",
                      group_size: Optional[int] = None) -> Dict[str, Any]:
    """Quantize one decoder layer.  int4 fuses the projections that share an
    input: q/k/v into `qkv` and gate/up into `gateup`, one kernel call each.
    "int4f": int4 for the FFN only (gateup, down); attention stays int8."""
    nl = dict(lp)
    if mode in ("int4", "int4f"):
        qkv_w = torch.cat([lp["q"]["w"], lp["k"]["w"], lp["v"]["w"]], dim=1)
        qkv_b = None
        if lp["q"]["b"] is not None:
            qkv_b = torch.cat([lp["q"]["b"], lp["k"]["b"], lp["v"]["b"]])
        attn_mode = "int8" if mode == "int4f" else "int4"
        nl["qkv"] = {"w": _quant(qkv_w, attn_mode, group_size), "b": qkv_b}
        nl["gateup"] = _quant(torch.cat([lp["gate"], lp["up"]], dim=1), "int4", group_size)
        for name in ("q", "k", "v", "gate", "up"):  # superseded by the fused weights
            nl.pop(name)
        nl["o"] = {"w": _quant(lp["o"]["w"], attn_mode, group_size), "b": lp["o"]["b"]}
        nl["down"] = _quant(lp["down"], "int4", group_size)
    else:
        for name in ("q", "k", "v", "o"):
            proj = dict(lp[name])
            proj["w"] = _quant(lp[name]["w"], mode, group_size)
            nl[name] = proj
        for name in ("gate", "up", "down"):
            nl[name] = _quant(lp[name], mode, group_size)
    return nl


def quantize_lm(lm_params: Dict[str, Any], quantize_embed: bool = False,
                mode: str = "int8", group_size: Optional[int] = None) -> Dict[str, Any]:
    """Quantize the Qwen2 projections; `quantize_embed` also stores the
    embedding table as int8 with per-row scales (lookups dequantize the
    gathered rows)."""
    out = dict(lm_params)
    out["layers"] = [quantize_lm_layer(lp, mode=mode, group_size=group_size)
                     for lp in lm_params["layers"]]
    if quantize_embed:
        out["embed"] = quantize_weight(lm_params["embed"], axis=1)
    return out


def quantize_diffusion_head(head_params: Dict[str, Any], mode: str = "int8",
                            group_size: Optional[int] = None) -> Dict[str, Any]:
    """Quantize the head's per-solver-step FFN weights and its adaLN
    modulation weights; the latent-side projections stay in the model dtype."""
    out = dict(head_params)
    layers = []
    for lp in head_params["layers"]:
        nl = dict(lp)
        if mode == "int4":
            nl["gateup"] = _quant(torch.cat([lp["gate"], lp["up"]], dim=1), mode, group_size)
            nl.pop("gate")
            nl.pop("up")
            nl["ada_w"] = _quant(lp["ada_w"], mode, group_size)
            nl["down"] = _quant(lp["down"], mode, group_size)
        else:
            for name in ("ada_w", "gate", "up", "down"):
                nl[name] = _quant(lp[name], mode, group_size)
        layers.append(nl)
    out["layers"] = layers
    out["final_ada_w"] = _quant(head_params["final_ada_w"], mode, group_size)
    return out


def quantize_conv_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Downsampling conv [K, Cin, Cout] -> int8 {"qint8" [K*Cin, Cout],
    "scale" [Cout]} for the window-matmul path (k == 2*stride)."""
    return quantize_weight(w.reshape(-1, w.shape[-1]))


def quantize_convt_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Transposed conv [Cin, K, Cout] -> int8 3D + per-(tap, channel) scales
    [K, Cout]."""
    q, scale = _quantize_weight_impl(w, 0)
    return {"qint8": q, "scale": scale}


def quantize_tokenizer_stack(stack: Dict[str, Any], mode: str = "int8",
                             min_dim: int = 512,
                             group_size: Optional[int] = None,
                             conv_min_params: int = 2_000_000,
                             skip_stages=()) -> Dict[str, Any]:
    """Quantize the Block1D FFN weights (stages of dim >= `min_dim`) and the
    large stage-transition convs (>= `conv_min_params`, always int8) of one
    tokenizer stack.  Stages in `skip_stages` are left as they are (the int4
    chain packs cover them)."""
    out = dict(stack)
    stages = []
    for si, blocks in enumerate(stack["stages"]):
        if si in skip_stages:
            stages.append(blocks)
            continue
        nbs = []
        for bp in blocks:
            d = bp["norm_w"].shape[0]
            if d >= min_dim and not isinstance(bp["ffn1"]["w"], dict):
                nb = dict(bp)

                def _gs(w):  # group scales only where the group divides K
                    if group_size and w.shape[0] % group_size == 0:
                        return group_size
                    return None

                nb["ffn1"] = {"w": _quant(bp["ffn1"]["w"], mode, _gs(bp["ffn1"]["w"])),
                              "b": bp["ffn1"]["b"]}
                nb["ffn2"] = {"w": _quant(bp["ffn2"]["w"], mode, _gs(bp["ffn2"]["w"])),
                              "b": bp["ffn2"]["b"]}
                nbs.append(nb)
            else:
                nbs.append(bp)
        stages.append(nbs)
    out["stages"] = stages

    if "down" in out:  # encoder: down[0] is the k=7 stem, the rest are k=2r
        out["down"] = [
            dict(dp, w=quantize_conv_weight(dp["w"]))
            if (i > 0 and not isinstance(dp["w"], dict)
                and dp["w"].numel() >= conv_min_params and dp["w"].shape[0] % 2 == 0)
            else dp
            for i, dp in enumerate(stack["down"])]
    if "up" in out:  # decoder: up[0] is a plain k=7 conv, the rest transposed
        out["up"] = [
            dict(up, w=quantize_convt_weight(up["w"]))
            if (i > 0 and not isinstance(up["w"], dict)
                and up["w"].numel() >= conv_min_params)
            else up
            for i, up in enumerate(stack["up"])]
    return out


def quantize_tokenizers(params: Dict[str, Any], mode: str = "int8",
                        min_dim: int = 512,
                        group_size: Optional[int] = None,
                        conv_min_params: int = 2_000_000,
                        skip: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Quantize the two sigma-VAE stacks on the decode path: the acoustic
    decoder and the semantic encoder (the acoustic encoder runs only at
    prefill and stays in the model dtype).  `skip` maps a stack name to the
    stage indices the chain packs cover."""
    skip = skip or {}
    out = dict(params)
    for name in ("acoustic_decoder", "semantic_encoder"):
        out[name] = quantize_tokenizer_stack(
            params[name], mode=mode, min_dim=min_dim, group_size=group_size,
            conv_min_params=conv_min_params, skip_stages=skip.get(name, ()))
    return out


def quantize_model(params: Dict[str, Any], tie_word_embeddings: bool = True,
                   quantize_embed: bool = False, mode: str = "int8",
                   group_size: Optional[int] = None,
                   diffusion_mode: Optional[str] = None,
                   tokenizer_mode: Optional[str] = None,
                   tokenizer_min_dim: int = 512,
                   tokenizer_skip: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Quantize the LM (and the logits head) and the diffusion head; the
    tokenizer stacks too when `tokenizer_mode` is set.  The head defaults to
    int8 under the int4 LM modes, as in the JAX package."""
    if mode not in ("int8", "int4", "int4f"):
        raise ValueError(f"quantize mode must be 'int8', 'int4' or 'int4f', got {mode}")
    dmode = diffusion_mode or ("int8" if mode in ("int4", "int4f") else mode)
    out = dict(params)
    out["lm"] = quantize_lm(params["lm"], quantize_embed=quantize_embed,
                            mode=mode, group_size=group_size)
    out["diffusion_head"] = quantize_diffusion_head(params["diffusion_head"],
                                                    mode=dmode, group_size=group_size)
    head_mode = "int4" if mode == "int4f" else mode
    if params.get("lm_head") is not None:
        out["lm_head"] = _quant(params["lm_head"], head_mode, group_size)
    elif tie_word_embeddings:
        out["lm_head"] = _quant(params["lm"]["embed"].T, head_mode, group_size)
    if tokenizer_mode is not None:
        if tokenizer_mode not in ("int8", "int4"):
            raise ValueError(f"tokenizer_mode must be 'int8' or 'int4', got {tokenizer_mode}")
        out = quantize_tokenizers(out, mode=tokenizer_mode, min_dim=tokenizer_min_dim,
                                  group_size=group_size, skip=tokenizer_skip)
    return out


__all__ = ["quantize_weight", "quantize_weight_int4", "quantize_model", "quantize_lm",
           "quantize_lm_layer", "quantize_diffusion_head", "quantize_conv_weight",
           "quantize_convt_weight", "quantize_tokenizer_stack", "quantize_tokenizers", "mm"]
