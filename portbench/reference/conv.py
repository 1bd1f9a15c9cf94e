"""Causal 1-D convolutions, channel-last `[B, T, C]`, full and streaming.

The benchmark's frozen plain copy of the port's `ops/conv.py` (reference
SConv1d / SConvTranspose1d, `modular_vibevoice_tokenizer.py:258-576`), with
the quantized paths taken out.  Weight layouts: conv [K, Cin/groups, Cout],
transposed conv [Cin, K, Cout].  Streaming states carry the trailing input
context (`ConvState`) and the overlap partial sums past the emitted frames
(`ConvTState`), in the port's layout, so that a step can be followed from the
program's own state.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


def causal_pad_amount(kernel_size: int, stride: int = 1, dilation: int = 1) -> int:
    """Left padding of the reference's causal SConv1d (ref :282-285)."""
    return (kernel_size - 1) * dilation - (stride - 1)


def _conv(x: torch.Tensor, weight: torch.Tensor, bias, stride: int, dilation: int,
          groups: int) -> torch.Tensor:
    """VALID conv of [B, T, Cin] by a [K, Cin/g, Cout] weight -> [B, T', Cout]."""
    y = F.conv1d(x.transpose(1, 2), weight.permute(2, 1, 0), None,
                 stride=stride, dilation=dilation, groups=groups)
    y = y.transpose(1, 2)
    return y if bias is None else y + bias


def causal_conv1d(x: torch.Tensor, weight, bias: Optional[torch.Tensor],
                  stride: int = 1, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """Causal conv over [B, T, C]; output [B, ceil(T/stride), Cout] (ref
    SConv1d._forward_non_streaming :384-418)."""
    k = weight.shape[0]
    pad_left = causal_pad_amount(k, stride, dilation)
    t = x.shape[1]
    # right padding so every input sample lands in a complete output frame
    # (ref get_extra_padding_for_conv1d :127-133, with its undilated kernel size)
    n_frames = (t - k + pad_left) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (k - pad_left)
    pad_right = max(ideal - t, 0)
    x = F.pad(x, (0, 0, pad_left, pad_right))
    return _conv(x, weight, bias, stride, dilation, groups)


class ConvState(NamedTuple):
    """Streaming state for a causal conv: the trailing `ctx` input samples."""
    buf: torch.Tensor  # [B, ctx, Cin]


def conv_state_init(batch: int, cin: int, kernel_size: int, stride: int = 1,
                    dilation: int = 1, dtype=torch.float32, device="cpu") -> ConvState:
    ctx = causal_pad_amount(kernel_size, stride, dilation)
    return ConvState(buf=torch.zeros((batch, max(ctx, 0), cin), dtype=dtype, device=device))


def causal_conv1d_streaming(x: torch.Tensor, state: ConvState, weight,
                            bias: Optional[torch.Tensor], stride: int = 1,
                            dilation: int = 1,
                            groups: int = 1) -> Tuple[torch.Tensor, ConvState]:
    """One streaming chunk, [B, T, Cin] with T a multiple of `stride`: concat
    the carried context, VALID conv, keep the trailing `ctx` inputs.  From a
    zero state this equals `causal_conv1d` on the concatenated stream."""
    ctx = state.buf.shape[1]
    full = torch.cat([state.buf, x], dim=1) if ctx > 0 else x
    y = _conv(full, weight, bias, stride, dilation, groups)
    new_buf = full[:, full.shape[1] - ctx:, :] if ctx > 0 else state.buf
    return y, ConvState(buf=new_buf)


def _convt_project(x: torch.Tensor, weight) -> torch.Tensor:
    """The transposed conv's dense projection [B, T, Cin] -> [B, T, K*Cout]."""
    cin, k, cout = weight.shape
    return x @ weight.reshape(cin, k * cout)


def _convt_overlap_add(x: torch.Tensor, weight, stride: int) -> torch.Tensor:
    """[B, T, Cin] -> bias-free overlap-added [B, T + g - 1, stride, Cout]."""
    _, k, cout = weight.shape
    if k % stride:
        raise ValueError("transposed conv kernel must be a multiple of its stride")
    b, t, _ = x.shape
    g = k // stride  # frames each input sample touches
    y = _convt_project(x, weight).reshape(b, t, g, stride, cout)
    out = torch.zeros((b, t + g - 1, stride, cout), dtype=x.dtype, device=x.device)
    for gi in range(g):  # chunk gi of input frame t lands in output frame t + gi
        out[:, gi:gi + t] += y[:, :, gi]
    return out


def causal_conv_transpose1d(x: torch.Tensor, weight, bias: Optional[torch.Tensor],
                            stride: int) -> torch.Tensor:
    """Causal transposed conv [B, T, Cin] -> [B, T*stride, Cout]: the
    reference's full ConvTranspose1d trimmed by `k - stride` samples on the
    right (ref SConvTranspose1d :421-576)."""
    b, t, _ = x.shape
    out = _convt_overlap_add(x, weight, stride)
    out = out[:, :t].reshape(b, t * stride, -1)
    return out if bias is None else out + bias


class ConvTState(NamedTuple):
    """Streaming state for a transposed conv: the bias-free contributions past
    the emitted frames, [B, (K/stride - 1) * stride, Cout]."""
    tail: torch.Tensor


def conv_transpose_state_init(batch: int, cout: int, kernel_size: int, stride: int,
                              dtype=torch.float32, device="cpu") -> ConvTState:
    g = kernel_size // stride
    return ConvTState(tail=torch.zeros((batch, (g - 1) * stride, cout),
                                       dtype=dtype, device=device))


def causal_conv_transpose1d_streaming(
        x: torch.Tensor, state: ConvTState, weight, bias: Optional[torch.Tensor],
        stride: int) -> Tuple[torch.Tensor, ConvTState]:
    """One streaming chunk [B, T, Cin] -> [B, T*stride, Cout] + new state: the
    overlap-add of this chunk plus the carried tail of the previous one."""
    b, t, _ = x.shape
    acc = _convt_overlap_add(x, weight, stride)
    acc = acc.reshape(b, acc.shape[1] * stride, -1)
    tail_len = state.tail.shape[1]
    if tail_len > 0:
        acc[:, :tail_len] += state.tail
        out, new_tail = acc[:, : t * stride], acc[:, t * stride:]
    else:
        out, new_tail = acc, state.tail
    if bias is not None:
        out = out + bias
    return out, ConvTState(tail=new_tail)


__all__ = [
    "causal_pad_amount",
    "causal_conv1d",
    "causal_conv1d_streaming",
    "causal_conv_transpose1d",
    "causal_conv_transpose1d_streaming",
    "ConvState",
    "ConvTState",
    "conv_state_init",
    "conv_transpose_state_init",
]
