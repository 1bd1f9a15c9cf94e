"""Fused large-T sigma-VAE stage: CUDA kernels and plain versions.

Port of `vibevoice_tpu/ops/fused_stage.py`.  A large-T stage (decoder stages
at T = 200..3200 samples per 7.5 Hz frame, the encoder's mirror) is a chain
of N `Block1D`s (RMSNorm -> causal depthwise conv k=7 -> layer scale ->
residual -> RMSNorm -> GELU FFN -> layer scale -> residual, ref
modular_vibevoice_tokenizer.py:620-684) over all T rows, with every block's
6-row conv context carried across streaming chunks.  Optional folds run
inside the same launch:

* `conv` (`ConvPack`) — the transition conv in front of the stage: the
  decoder's stride-s transposed "up" conv (k = 2s; x is the pre-upsample
  [B, T/s, Cin] and `conv_state` its bias-free overlap tail [B, s, D]) or the
  encoder's strided "down" conv (k = 2s, or the s=1 stem; x is [B, T*s, Cin]
  and `conv_state` its input context [B, k-s, Cin]);
* `head` (`HeadPack`) — the decoder tail: final RMSNorm + head conv D -> 1;
  the output is the waveform [B, T, 1] and `head_state` the head conv's
  [B, k-1, D] post-norm context.  The scalar head bias is added outside the
  kernel, as in the JAX package.

`fused_stage_chain` replaces TPU kernel #4 (`fused_stage_chain`, Pallas
`_make_kernel`); `fused_stage_chain_rowlane` replaces #7
(`_fused_stage_chain_rowlane`, `_make_kernel_rowlane`): the same stage from a
row-lane pack, which the TPU kernel runs on a [G, T, R*D] layout (R batch
rows side by side in its vector lanes), with block-diagonal kron(I_R, W) FFN
weights and RMSNorm group means taken through the `avg` matmul.
`fused_stage_chain` dispatches to it for packs with a "rowlane" entry and no
folds, as the JAX package does.

On CUDA tensors each wrapper makes ONE launch of `csrc/fused_stage.cu`
(design and bound there: clusters over row tiles with one grid barrier per
block), with its scratch cached per device, stream and size (`scratch`).  The
row-lane form is the same kernel reading each batch item's own lane group
of the pack (`stage_layout`: its vectors and the diagonal blocks of w1, b1
and w2) on x and ctx as they are, with each row's norm over its own D
channels: no relayout, and bit-equal to the stage kernel on the pack without
its row-lane entry.  On CPU tensors each wrapper runs its plain version
(`fused_stage_chain_ref`, `fused_stage_chain_rowlane_ref`), which works over
the whole T at once with the TPU kernel's numerics: fp32 RMSNorm and
residuals, matmul inputs rounded to the pack dtype with fp32 accumulation,
the ffn1 bias through the augmented all-ones column (the row-lane form: the
[G, T, R*D] relayouts, its `avg` group means and block-diagonal weights, as
the TPU kernel).  Both use the exact `erf` GELU; the TPU kernel's rational
erf differs by < 1.5e-7.  The kernel's row-lane means (sum of squares times
1/D) and the plain version's `avg` product differ only in fp32 rounding.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from . import cuda_build
from .fused_blocks import CTX, pack_stage

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class ConvPack:
    """Folded transition conv: per-tap weights [K, Cin, D] and bias [1, D] in
    the pack dtype, with its static geometry (kind "up" or "down", stride s,
    kernel k, input channels cin)."""

    def __init__(self, kind: str, w, b, s: int, k: int, cin: int):
        self.kind, self.w, self.b = kind, w, b
        self.s, self.k, self.cin = s, k, cin

    def to(self, device) -> "ConvPack":
        return ConvPack(self.kind, self.w.to(device), self.b.to(device), self.s, self.k,
                        self.cin)


class HeadPack:
    """Folded decoder tail: `w` rows [norm_w; tap_0..tap_{k-1}] ([k+1, D],
    fp32 as the JAX package packs it) and `b` the scalar head bias ([1] fp32
    or None, added outside the kernel)."""

    def __init__(self, w, b, k: int, has_norm: bool):
        self.w, self.b, self.k, self.has_norm = w, b, k, has_norm

    def to(self, device) -> "HeadPack":
        return HeadPack(self.w.to(device), None if self.b is None else self.b.to(device),
                        self.k, self.has_norm)


def pack_head(head: Dict, final_norm_w, dtype=torch.float32) -> HeadPack:
    """Head conv [k, D, 1] (mono, k - 1 <= 8) and the final norm weight."""
    w = head["w"]
    if isinstance(w, dict):
        raise ValueError("folded head expects plain weights")
    k, d, cout = w.shape
    assert cout == 1, "head folding requires a mono waveform head"
    assert 0 < k - 1 <= 8, "head conv context must fit the ctx slot"
    norm = final_norm_w if final_norm_w is not None else torch.ones((d,), device=w.device)
    rows = torch.cat([norm.float()[None], w[:, :, 0].float()])  # [k+1, D]
    b = head["b"]
    return HeadPack(rows.to(dtype), None if b is None else b.reshape(1).float(), k,
                    final_norm_w is not None)


def pack_up_conv(up: Dict, stride: int, dtype=torch.float32) -> ConvPack:
    """Transposed conv [Cin, K=2s, D] -> per-tap stack [K, Cin, D] (tap g*s+j
    maps input frame i to output sample (i+g)*s + j); bias -> [1, D]."""
    w = up["w"]
    if isinstance(w, dict):
        raise ValueError("folded transition conv expects plain weights")
    cin, k, cout = w.shape
    assert k == 2 * stride, "transposed conv folding expects k == 2*stride"
    b = up["b"] if up["b"] is not None else torch.zeros((cout,), device=w.device)
    return ConvPack("up", w.permute(1, 0, 2).contiguous().to(dtype),
                    b.reshape(1, cout).to(dtype), stride, k, cin)


def pack_down_conv(dp: Dict, stride: int, dtype=torch.float32) -> ConvPack:
    """Strided causal conv [K, Cin, D] (k == 2s, or s == 1 with any k) kept as
    its per-tap stack; bias -> [1, D]."""
    w = dp["w"]
    if isinstance(w, dict):
        raise ValueError("folded transition conv expects plain weights")
    k, cin, cout = w.shape
    assert stride == 1 or k == 2 * stride, "down-conv folding expects s == 1 or k == 2*stride"
    assert 0 < k - stride <= 8, "conv context must fit the ctx slot"
    b = dp["b"] if dp["b"] is not None else torch.zeros((cout,), device=w.device)
    return ConvPack("down", w.contiguous().to(dtype), b.reshape(1, cout).to(dtype), stride, k,
                    cin)


def pack_stage_rowlane(blocks: List[Dict], r: int, dtype=torch.float32) -> Dict:
    """Row-lane pack for R rows: vecs/mixw tiled to [N, 8, R*D]; w1 [N, R*D,
    R*F] and w2 [N, R*F, R*D] block-diagonal kron(I_R, W); b1 [N, 1, R*F]
    (the bias is not folded); avg [R*D, R*D] fp32, block-diagonal ones/D."""
    base = pack_stage(blocks, dtype=dtype)
    d = base["vecs"].shape[2]
    dev = base["vecs"].device
    eye = torch.eye(r, dtype=dtype, device=dev)
    w1 = torch.stack([torch.kron(eye, w) for w in base["w1"][:, :d]])
    w2 = torch.stack([torch.kron(eye, w) for w in base["w2"]])
    avg = torch.kron(torch.eye(r, dtype=torch.float32, device=dev),
                     torch.full((d, d), 1.0 / d, dtype=torch.float32, device=dev))
    return {"vecs": base["vecs"].repeat(1, 1, r), "mixw": base["mixw"].repeat(1, 1, r),
            "w1": w1, "b1": base["w1"][:, d][:, None, :].repeat(1, 1, r), "w2": w2,
            "avg": avg}


def rowlane_rows(d: int, bsz: int) -> int:
    """Largest row group <= 128/D that divides the batch (1: not applicable)."""
    cap = max(1, 128 // d)
    for r in range(min(cap, bsz), 0, -1):
        if bsz % r == 0:
            return r
    return 1


def _stage_rows(packed, x: torch.Tensor) -> int:
    conv = packed.get("conv")
    if conv is None:
        return x.shape[1]
    return x.shape[1] * conv.s if conv.kind == "up" else x.shape[1] // conv.s


def _check_rows(packed, x):
    """What the kernel needs of T: more stage rows than any carried context
    (the blocks' 6, the folded head's k - 1) and, for a folded down conv,
    whole strides over at least its context."""
    conv, hp = packed.get("conv"), packed.get("head")
    t = _stage_rows(packed, x)
    assert t > CTX and (hp is None or t >= hp.k), f"stage T={t} is shorter than its context"
    if conv is not None and conv.kind == "down":
        assert x.shape[1] == t * conv.s and x.shape[1] >= conv.k - conv.s


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with a rounded to w's dtype and fp32 accumulation."""
    return a.to(w.dtype).float() @ w.float()


def _gelu(a: torch.Tensor) -> torch.Tensor:
    return F.gelu(a, approximate="none")


def _mixer(x, h, c, taps, vec):
    """Causal depthwise conv over [ctx; h] + layer-scale residual; returns
    (x, new ctx = the last 6 rows of [ctx; h])."""
    t = h.shape[1]
    hh = torch.cat([c, h], dim=1)
    m = vec[1].expand_as(h)
    for k in range(7):
        m = m + hh[:, k:k + t] * taps[k]
    return x + vec[2] * m, hh[:, t:]


def _blocks_ref(packed, x: torch.Tensor, ctx: torch.Tensor, eps: float):
    """The N-block chain on fp32 x [B, T, D] and fp32 ctx [B, N, 6, D]."""
    vecs, mixw = packed["vecs"].float(), packed["mixw"].float()
    aug = torch.zeros((*x.shape[:2], 8), dtype=torch.float32, device=x.device)
    aug[..., 0] = 1.0
    new_ctx = []
    for b in range(vecs.shape[0]):
        vec = vecs[b]
        x, c = _mixer(x, _rms(x, eps) * vec[0], ctx[:, b], mixw[b], vec)
        new_ctx.append(c)
        hn = torch.cat([_rms(x, eps) * vec[3], aug], dim=-1)  # [hn | 1 | 0 x 7]
        a = _gelu(_mm(hn, packed["w1"][b]))
        x = x + vec[4] * (_mm(a, packed["w2"][b]) + vec[5])
    return x, torch.stack(new_ctx, dim=1)


def _conv_ref(conv: ConvPack, x: torch.Tensor, state: torch.Tensor):
    """The folded transition conv on fp32 x; returns (stage input, new state)."""
    b = conv.b[0].float()
    if conv.kind == "up":
        s = conv.s
        taps = [_mm(x, conv.w[j]) for j in range(conv.k)]      # [B, Ti, D] each
        ya, yb = torch.stack(taps[:s], dim=2), torch.stack(taps[s:], dim=2)
        prev = torch.cat([state[:, None], yb[:, :-1]], dim=1)  # [B, Ti, s, D]
        out = (ya + prev).reshape(x.shape[0], -1, ya.shape[-1]) + b
        return out, yb[:, -1]
    s, k = conv.s, conv.k
    full = torch.cat([state, x], dim=1)                         # [B, k-s + T*s, Cin]
    t = x.shape[1] // s
    z = None
    for tau in range(k):
        yt = _mm(full[:, tau:tau + (t - 1) * s + 1:s], conv.w[tau])
        z = yt if z is None else z + yt
    return z + b, full[:, full.shape[1] - (k - s):]


def _head_ref(hp: HeadPack, x: torch.Tensor, state: torch.Tensor, eps: float):
    hw = hp.w.float()
    h = _rms(x, eps) * hw[0] if hp.has_norm else x
    t = x.shape[1]
    hh = torch.cat([state, h], dim=1)
    m = hh[:, 0:t] * hw[1]
    for tap in range(1, hp.k):
        m = m + hh[:, tap:tap + t] * hw[1 + tap]
    return m.sum(dim=-1, keepdim=True), hh[:, t:]


def fused_stage_chain_ref(packed, x: torch.Tensor, ctx: torch.Tensor, eps: float = 1e-5,
                          conv_state: Optional[torch.Tensor] = None,
                          head_state: Optional[torch.Tensor] = None):
    """Plain version of `fused_stage_chain` (no row-lane dispatch): the same
    arguments and returns."""
    conv, hp = packed.get("conv"), packed.get("head")
    h = x.float()
    if conv is not None:
        h, new_conv = _conv_ref(conv, h, conv_state.to(ctx.dtype).float())
    h, new_ctx = _blocks_ref(packed, h, ctx.float(), eps)
    if hp is not None:
        h, new_head = _head_ref(hp, h, head_state.to(ctx.dtype).float(), eps)
    y = h.to(x.dtype)
    if hp is not None and hp.b is not None:
        y = y + hp.b.to(y.dtype)
    out = (y, new_ctx.to(ctx.dtype))
    if conv is not None:
        out += (new_conv.to(ctx.dtype),)
    if hp is not None:
        out += (new_head.to(ctx.dtype),)
    return out


def _to_lanes(x, ctx, r):
    """[B, T, D], [B, N, 6, D] -> [G, T, R*D], [G, N, 6, R*D]."""
    bsz, t, d = x.shape
    g, n = bsz // r, ctx.shape[1]
    xr = x.reshape(g, r, t, d).permute(0, 2, 1, 3).reshape(g, t, r * d)
    cr = ctx.reshape(g, r, n, CTX, d).permute(0, 2, 3, 1, 4).reshape(g, n, CTX, r * d)
    return xr.contiguous(), cr.contiguous()


def _from_lanes(y, new_ctx, r):
    g, t, rd = y.shape
    d, n = rd // r, new_ctx.shape[1]
    yo = y.reshape(g, t, r, d).permute(0, 2, 1, 3).reshape(g * r, t, d)
    co = new_ctx.reshape(g, n, CTX, r, d).permute(0, 3, 1, 2, 4).reshape(g * r, n, CTX, d)
    return yo, co


def _rowlane_rows(packed) -> int:
    return packed["rowlane"]["vecs"].shape[2] // packed["vecs"].shape[2]


def fused_stage_chain_rowlane_ref(packed, x: torch.Tensor, ctx: torch.Tensor,
                                  eps: float = 1e-5):
    """Plain version of the row-lane stage: x [B, T, D], ctx [B, N, 6, D]
    (B a multiple of R) -> (y, new_ctx), computed on the [G, T, R*D] layout
    with the pack's block-diagonal weights and `avg` group means."""
    rl = packed["rowlane"]
    r = _rowlane_rows(packed)
    xr, cr = _to_lanes(x, ctx, r)
    h, c_all = xr.float(), cr.float()
    vecs, mixw, avg = rl["vecs"].float(), rl["mixw"].float(), rl["avg"].float()

    def norm(v, w):
        return v * torch.rsqrt((v * v) @ avg + eps) * w

    new_ctx = []
    for b in range(vecs.shape[0]):
        vec = vecs[b]
        h, c = _mixer(h, norm(h, vec[0]), c_all[:, b], mixw[b], vec)
        new_ctx.append(c)
        a = _gelu(_mm(norm(h, vec[3]), rl["w1"][b]) + rl["b1"][b, 0].float())
        h = h + vec[4] * (_mm(a, rl["w2"][b]) + vec[5])
    return _from_lanes(h.to(x.dtype), torch.stack(new_ctx, dim=1).to(ctx.dtype), r)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_PTRS = ("x", "ctx", "conv_state", "head_state", "vecs", "mixw", "w1", "b1", "w2", "conv_w",
         "conv_b", "head_w", "y", "ctx_out", "conv_out", "head_out", "xg", "yg", "xb", "bar")
_LAYOUT = ("w1_stride", "b1_stride", "w2_stride", "vec_ld", "w1_ld", "w2_ld", "lanes",
           "vec_lane", "w1_lane", "b1_lane", "w2_lane")
_INTS = ("B", "T", "W", "F", "NB", "conv_kind", "cs", "ck", "cin", "hk", "hnorm", "dtype",
         "C") + _LAYOUT
MAX_CLUSTER = 8  # CTAs per cluster of the stage kernel: the portable size
CLUSTER_COLS = 64  # fewest FFN columns a CTA of a cluster takes


def cluster_size(f: int, dtype: torch.dtype) -> int:
    """CTAs per cluster of the stage kernel for an FFN of width f: the most
    (at most 8) that split the FFN columns into slices of at least 64 columns
    and of whole 16-byte vectors.  The kernel adds the slices' shares in rank
    order, so the result depends on this (a function of the shape), never on
    the grid."""
    es = torch.finfo(dtype).bits // 8
    for c in (8, 4, 2):
        if f % c == 0 and f // c >= CLUSTER_COLS and (f // c * es) % 16 == 0:
            return c
    return 1


def stage_layout(d: int, f: int, r: int = 1) -> Dict[str, int]:
    """How the kernel finds a batch item's weights in a stage pack of width
    d and FFN width f, in elements: the block strides of w1, b1 and w2
    (`*_stride`), the row strides of vecs/mixw, w1 and w2 (`*_ld`) and the
    lane offsets (`*_lane`): batch item bb reads lane group g = bb % r, which
    starts g lane offsets after group 0.  A plain pack (r = 1): w1 [N, D+8,
    F] with b1 its row D, w2 [N, F, D].  A row-lane pack of r lanes:
    vecs/mixw [N, 8, r*D], w1 [N, r*D, r*F], b1 [N, 1, r*F], w2 [N, r*F,
    r*D], whose lane group g is columns g*D.. of the vectors, the diagonal
    block [g*D.., g*F..] of w1, columns g*F.. of b1 and the block [g*F..,
    g*D..] of w2."""
    if r == 1:
        return dict(w1_stride=(d + 8) * f, b1_stride=(d + 8) * f, w2_stride=f * d, vec_ld=d,
                    w1_ld=f, w2_ld=d, lanes=1, vec_lane=0, w1_lane=0, b1_lane=0, w2_lane=0)
    rd, rf = r * d, r * f
    return dict(w1_stride=rd * rf, b1_stride=rf, w2_stride=rf * rd, vec_ld=rd, w1_ld=rf,
                w2_ld=rd, lanes=r, vec_lane=d, w1_lane=d * rf + f, b1_lane=f, w2_lane=f * rd + d)


_SCRATCH: Dict[tuple, Dict[str, torch.Tensor]] = {}


def scratch(device, stream: int, n_el: int, n_conv: int):
    """The kernel's scratch, made once per device, stream and size: `xg`
    (the folded conv's product, n_conv floats), `xb` and `yg` (the blocks'
    fp32 outputs, alternating), `bar` (its grid barrier's counter: 0 at
    first, and every call leaves its low bits 0).  Calls on one stream run
    in order, so they share it safely."""
    key = (str(device), stream, n_el, n_conv)
    buf = _SCRATCH.get(key)
    if buf is None:
        f32 = dict(dtype=torch.float32, device=device)
        buf = {"yg": torch.empty(n_el, **f32), "xb": torch.empty(n_el, **f32),
               "xg": torch.empty(max(1, n_conv), **f32),
               "bar": torch.zeros(1, dtype=torch.int32, device=device)}
        _SCRATCH[key] = buf
    return buf


class _Params(ctypes.Structure):
    """`StageParams` of csrc/fused_stage.cu, field for field."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _PTRS] + [(k, ctypes.c_int) for k in _INTS]
                + [("eps", ctypes.c_float)])


def _launch(name, p, x, ctx, eps, conv=None, hp=None, conv_state=None, head_state=None, r=1):
    """One launch on x [B, T', *] whose stage rows have width W; `p` is a
    plain pack, or (r > 1) a row-lane pack of r lanes."""
    vecs, w1, w2 = p["vecs"], p["w1"], p["w2"]
    n, _, rw = vecs.shape
    w, f = rw // r, w2.shape[1] // r
    bsz = x.shape[0]
    t = _stage_rows({"conv": conv}, x)
    dt, dev = x.dtype, x.device
    if dt not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {dt}")
    want = {"vecs": (n, 8, r * w), "mixw": (n, 8, r * w), "w2": (n, r * f, r * w),
            "w1": (n, r * w, r * f) if r > 1 else (n, w + 8, f)}
    if r > 1:
        want["b1"] = (n, 1, r * f)
    head_w = None
    if hp is not None:
        head_w = hp.w.float().contiguous()
        if tuple(head_w.shape) != (hp.k + 1, w):
            raise ValueError(f"head pack {tuple(head_w.shape)} does not fit D={w}")
    tensors = {"x": x, "ctx": ctx, **{k: p[k] for k in want}}
    if (conv is not None and conv_state is None) or (hp is not None and head_state is None):
        raise ValueError(f"{name}: a folded conv or head needs its streaming state")
    if conv is not None:
        cdim = w if conv.kind == "up" else conv.cin
        crows = conv.s if conv.kind == "up" else conv.k - conv.s
        want.update(conv_w=(conv.k, conv.cin, w), conv_b=(1, w), conv_state=(bsz, crows, cdim))
        conv_state = conv_state.to(dt)
        tensors.update(conv_w=conv.w, conv_b=conv.b, conv_state=conv_state)
    if hp is not None:
        want["head_state"] = (bsz, hp.k - 1, w)
        head_state = head_state.to(dt)
        tensors.update(head_state=head_state)
    want["x"] = (bsz, x.shape[1], conv.cin if conv is not None else w)
    want["ctx"] = (bsz, n, CTX, w)
    for k, shape in want.items():
        if tuple(tensors[k].shape) != shape:
            raise ValueError(f"{name}: {k} has shape {tuple(tensors[k].shape)}, want {shape}")
    for k, tns in tensors.items():
        if tns.device != dev:
            raise ValueError(f"{name}: {k} is on {tns.device}, x on {dev}")
        if not tns.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
        if tns.dtype != dt:
            raise TypeError(f"{name}: {k} has dtype {tns.dtype}, want {dt}")
        if tns.data_ptr() % 16:
            raise ValueError(f"{name}: {k} must be 16-byte aligned")
    hk = hp.k if hp is not None else 0

    y = torch.empty((bsz, t, 1 if hp is not None else w), dtype=dt, device=dev)
    ctx_out = torch.empty_like(ctx)
    conv_out = head_out = None
    if conv is not None:
        conv_out = torch.empty_like(conv_state)
    if hp is not None:
        head_out = torch.empty_like(head_state)
    n_el = bsz * t * w
    # the folded conv's product: "up" every tap's channels per input frame
    n_conv = 0 if conv is None else (2 * n_el if conv.kind == "up" else n_el)
    stream = torch.cuda.current_stream(dev).cuda_stream
    buf = scratch(dev, stream, n_el, n_conv)
    ptr = lambda v: 0 if v is None else v.data_ptr()
    # a plain pack's b1 is row D of w1
    b1 = ptr(p["b1"]) if r > 1 else w1.data_ptr() + w * f * w1.element_size()
    args = _Params(
        x=ptr(x), ctx=ptr(ctx), conv_state=ptr(conv_state), head_state=ptr(head_state),
        vecs=ptr(vecs), mixw=ptr(p["mixw"]), w1=ptr(w1), b1=b1, w2=ptr(w2),
        conv_w=ptr(conv.w) if conv is not None else 0,
        conv_b=ptr(conv.b) if conv is not None else 0, head_w=ptr(head_w), y=ptr(y),
        ctx_out=ptr(ctx_out), conv_out=ptr(conv_out), head_out=ptr(head_out),
        **{k: ptr(v) for k, v in buf.items()},
        B=bsz, T=t, W=w, F=f, NB=n,
        conv_kind=0 if conv is None else (1 if conv.kind == "up" else 2),
        cs=conv.s if conv is not None else 0, ck=conv.k if conv is not None else 0,
        cin=conv.cin if conv is not None else 0, hk=hk,
        hnorm=int(hp is not None and hp.has_norm), dtype=_DTYPE_CODES[dt],
        C=cluster_size(f, dt), eps=float(eps), **stage_layout(w, f, r))
    with torch.cuda.device(dev):
        rc = _library().vv_fused_stage(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel failed with code {rc}")
    out = (y, ctx_out)
    if conv is not None:
        out += (conv_out,)
    if hp is not None:
        out += (head_out,)
    return out


def fused_stage_chain(packed, x: torch.Tensor, ctx: torch.Tensor, eps: float = 1e-5,
                      conv_state: Optional[torch.Tensor] = None,
                      head_state: Optional[torch.Tensor] = None):
    """Run one large-T stage for a batch.

    Without folds: x [B, T, D], ctx [B, N, 6, D] -> (y [B, T, D], new_ctx).
    With packed["conv"], x is the pre-transition tensor and `conv_state` the
    conv's streaming state; its successor is appended to the returns.  With
    packed["head"], y is the waveform [B, T, 1] and the head context's
    successor is appended last.  A pack with "rowlane" and no folds goes to
    `fused_stage_chain_rowlane` when B is a multiple of its row group.
    CUDA tensors launch the kernel (counted once per call); CPU tensors take
    `fused_stage_chain_ref`."""
    conv, hp = packed.get("conv"), packed.get("head")
    if "rowlane" in packed and conv is None and hp is None:
        r = _rowlane_rows(packed)
        if r > 1 and x.shape[0] % r == 0:
            return fused_stage_chain_rowlane(packed, x, ctx, eps)
    _check_rows(packed, x)
    if x.device.type == "cpu":
        return fused_stage_chain_ref(packed, x, ctx, eps, conv_state, head_state)
    if x.device.type != "cuda":
        raise ValueError(f"fused_stage_chain runs on cuda or cpu, not {x.device}")
    out = _launch("fused_stage_chain", packed, x.contiguous(), ctx.contiguous(), eps, conv, hp,
                  conv_state, head_state)
    fused_stage_chain.launches += 1
    if hp is not None and hp.b is not None:
        out = (out[0] + hp.b.to(out[0].dtype),) + out[1:]
    return out


fused_stage_chain.launches = 0


def fused_stage_chain_rowlane(packed, x: torch.Tensor, ctx: torch.Tensor, eps: float = 1e-5):
    """The row-lane stage (no folds): x [B, T, D], ctx [B, N, 6, D] with B a
    multiple of the pack's row group R -> (y, new_ctx).  CUDA tensors launch
    the kernel on x and ctx as they are (item bb reads lane group bb % R of
    the row-lane pack; counted once per call); CPU tensors take
    `fused_stage_chain_rowlane_ref`."""
    r = _rowlane_rows(packed)
    if r < 2 or x.shape[0] % r:
        raise ValueError(f"batch {x.shape[0]} does not split into row groups of {r}")
    _check_rows({}, x)
    if x.device.type == "cpu":
        return fused_stage_chain_rowlane_ref(packed, x, ctx, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_stage_chain_rowlane runs on cuda or cpu, not {x.device}")
    out = _launch("fused_stage_chain_rowlane", packed["rowlane"], x.contiguous(), ctx.contiguous(),
                  eps, r=r)
    fused_stage_chain_rowlane.launches += 1
    return out


fused_stage_chain_rowlane.launches = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_stage")
    fn = lib.vv_fused_stage
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def stage_work(packed, x: torch.Tensor):
    """(bytes, flops) a call must at least move and compute, whatever layout
    the kernel reads: the stage pack's weights, x and the states read once,
    every output written once; the FFN and conv products at 2 flops per
    multiply-add at the stage's own width D.  The row-lane pack's
    block-diagonal weights and `avg` products are not counted: the stage does
    not need them."""
    conv, hp = packed.get("conv"), packed.get("head")
    n, _, w = packed["vecs"].shape
    f = packed["w2"].shape[1]
    bsz = x.shape[0]
    t = _stage_rows(packed, x)
    es = x.element_size()
    nbytes = sum(packed[k].numel() * packed[k].element_size()
                 for k in ("vecs", "mixw", "w1", "w2"))
    nbytes += x.numel() * es + 2 * bsz * n * CTX * w * es        # x, ctx in and out
    flops = 2 * bsz * t * n * (w * f + f * w)
    out_w = w
    if conv is not None:
        nbytes += conv.w.numel() * conv.w.element_size() + conv.b.numel() * es
        crows, cdim = (conv.s, w) if conv.kind == "up" else (conv.k - conv.s, conv.cin)
        nbytes += 2 * bsz * crows * cdim * es
        flops += 2 * bsz * t * w * conv.cin * (2 if conv.kind == "up" else conv.k)
    if hp is not None:
        nbytes += hp.w.numel() * hp.w.element_size() + 2 * bsz * (hp.k - 1) * w * es
        flops += 2 * bsz * t * w * hp.k
        out_w = 1
    nbytes += bsz * t * out_w * es
    return nbytes, flops


__all__ = ["ConvPack", "HeadPack", "pack_stage", "pack_stage_rowlane", "pack_up_conv",
           "pack_down_conv", "pack_head", "rowlane_rows", "fused_stage_chain",
           "fused_stage_chain_ref", "fused_stage_chain_rowlane",
           "fused_stage_chain_rowlane_ref", "stage_work", "cluster_size", "stage_layout",
           "scratch"]
