#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vibevoice_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure stops the run with a non-zero exit:
  1. build every kernel of `vibevoice_tpu_torch/csrc/` (one nvcc per source,
     all started together), with ptxas's registers and spills of each;
  2. each kernel against its plain PyTorch version at the 1.5B shapes, with
     its time, the plain version's, the library yardstick's and the bound:
     decode attention (bf16 and int8 KV, layers 0 and 27, a partial and a full
     live length, a visibility mask with holes; then ~340 live slots of 4096,
     40 000 of 40 960 in bf16 and int8 KV and the 7B grouping H=28, KVH=4, each
     with its share of the bound and two calls bit-equal); int4_matmul at the four LM
     projections with M=2 (per channel and with 128-row groups) and at M=64
     and M=128; the int4 Block1D chain at the 1.5B stage shapes with B=1 and
     B=4, two calls bit-equal; the fused int4 head at N=2, two calls
     bit-equal; the large-T stage kernel at the eight folded B=1 stage
     calls of a 1.5B decode step (two chunks each, states carried), with
     the folded tail, and unfolded at B=2; the row-lane stage kernel at B=2,
     4 and 32, each followed by the plain stage kernel on the
     same rows; flash prefill (bf16, H=12, KVH=2, D=128) at B=1 with T=1024
     and 4096 and at B=2, T=1024 with one row left-padded by 333 tokens, and
     at the 7B shape (H=28, KVH=4) with B=1, T=4096, each query row against
     its own scale, at the CTA height it picks and at both (64 and 128
     rows), against its bound and SDPA; the plain-pack (bf16) chain at the
     four packed stages of a step, B=1 and B=2, two chunks with the context
     carried, two calls bit-equal, with its share of the bound;
  3. the long-cache engine as `bench.py` drives it (1.5B, bf16, B=1, prompt
     256, 3840 steps -> a 4096-slot cache, so decode attention runs on the
     kernel): prefill, a 16-step warm-up chunk and two timed 32-step chunks.
     Every engine run of phases 3-5 goes in turns eager, graph, graph, eager:
     `Engine(eager=True)` launches each step from the host, the default
     engine replays its decode step from the CUDA graph it captured in its
     first chunk (the second graph turn is a second request on the same
     graph); a graph turn also gives the capture's seconds, the graph's
     kernel nodes by kernel (held against one step's launches) and its
     device time per replay;
  4. the same engine with `kv_dtype="int8"` for 8 + 8 steps, then at B=2 with
     `use_fused_stages=True` for 8 + 16 steps, with
     `fused_stage_rowlane=False` (eight stage-kernel calls per step) and by
     default (4 + 4 row-lane), the codec half of a step of each kind also
     captured alone in a CUDA graph (nodes, device time per replay);
     then the long-prompt engine: a 4096-token prompt (flash prefill by the
     auto rule, 28 launches) with `use_fused_vocoder` / `use_fused_semantic`
     on plain bf16 packs (4 chain launches per step), prefill and 8 + 16
     steps; the same prompt's prefill through the dense path, its last hidden
     state held against the flash prefill's; and a 16 384-token flash prefill
     with its peak memory;
  5. the quantized engine, full width and depth: the same weights through
     `VibeVoiceTTS(quantize="int4", quantize_tokenizer="int4k",
     quantize_diffusion="int4k")`, prefill, a 16-step warm-up and two timed
     32-step chunks, every kernel's launches asserted per step; the same
     quantized weights with `use_fused_stages=True` (eight stage-kernel calls
     per step, the transition convs folded), as long; then `quantize="int4f"`
     for 8 + 8 steps;
  6. `VibeVoiceTTS.from_random(vibevoice_1_5b())` serving three scripts (one
     with two speakers) with a streamer, each stopped after 24 steps, in bf16
     and then in the quantized configuration, which also serves one script
     with `use_fused_stages=True`, every engine decoding through its graph;
  7. a tiny model on the card against the same model on the CPU (plain
     versions), as the reference on a small input: bf16-free fp32, plain and
     in the int4 modes (group scales, int8 tokenizer stages), and with
     `use_fused_stages=True` at B=1 (folds) and B=2 (row-lane, the default),
     and with flash prefill forced on (B=2, one row left-padded) and the
     plain chain, at head_dim 128 (`tiny_config(hidden_size=512)`).

Weights are random, made from a seed.  Prints one JSON line per measurement,
then the `kernels` line, the card's name and power limit, and as the last line
`{"ok": true, "device": {...}}`.  Exits non-zero without a GPU.
"""
import json
import os
import subprocess
import sys
import time
from typing import Any, NamedTuple

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12
KERNEL_TOL = 2e-3  # bf16 output (|out| < 0.5: one rounding step ~2e-3) + fp32 sum order
SEED = 0
L2_BYTES = 50e6
QUANT_MODES = dict(quantize="int4", quantize_tokenizer="int4k", quantize_diffusion="int4k")


def emit(tag, **kw):
    print(json.dumps({"phase": tag, **kw}), flush=True)


def ptxas_report(log: str):
    """[{kernel, registers, spill_stores, spill_loads}] of each entry function
    in one source's `nvcc -Xptxas -v` output."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"kernel": ln.split("'")[1]}
            out.append(cur)
        elif cur is not None and "spill stores" in ln:
            words = ln.replace(",", "").split()
            cur["spill_stores"] = int(words[words.index("spill") - 2])
            cur["spill_loads"] = int(words[-4])
        elif cur is not None and "Used" in ln and "registers" in ln:
            words = ln.replace(",", " ").split()
            cur["registers"] = int(words[words.index("registers") - 1])
    return out


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of `fn(i)` over `iters` calls, by CUDA events.  A
    sleep kernel holds the device while the host enqueues every call, so the
    events time the calls back to back on the device, not the host's pace of
    launching them."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000 * iters)  # ~0.5 ms per call: more than any call's host time
    e0.record()
    for i in range(iters):
        fn(i)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


# ---------------------------------------------------------------------------
# phase 2: decode attention against its plain version
# ---------------------------------------------------------------------------

def attention_inputs(s, lengths, quant, copies, gen, dev, n_layers=28, b=2, h=12, kvh=2, d=128):
    """q, `copies` stacked caches (so that a timing loop over copy x layer
    reads more than the 50 MB L2 holds, as a decode step finds it), the
    visibility mask with holes and the lengths."""
    from vibevoice_tpu_torch.models.qwen2 import _quantize_slots
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    caches = []
    for _ in range(copies):
        k = torch.randn((n_layers, b, s, kvh * d), generator=gen, device=dev)
        v = torch.randn((n_layers, b, s, kvh * d), generator=gen, device=dev)
        if quant:
            kq, ks = _quantize_slots(k.view(n_layers * b, s, -1))
            vq, vs = _quantize_slots(v.view(n_layers * b, s, -1))
            caches.append((kq.view(k.shape), vq.view(v.shape),
                           ks.view(n_layers, b, 1, s).expand(-1, -1, 8, -1).contiguous(),
                           vs.view(n_layers, b, 1, s).expand(-1, -1, 8, -1).contiguous()))
        else:
            caches.append((k.to(torch.bfloat16), v.to(torch.bfloat16), None, None))
        del k, v
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    vis = (torch.arange(s, device=dev)[None] < lengths[:, None]).to(torch.int32)
    # holes like those the negative stream's reset leaves
    vis[1, 1:min(40, s)] = 0
    vis[1, min(999, s - 1)] = 0
    return q, caches, vis.contiguous(), lengths


def bound_ms(q, k_full, lengths, quant: bool):
    """Least time for one call: the bytes it must move over HBM's rate, or
    its flops over the bf16 peak, whichever is larger."""
    from vibevoice_tpu_torch.ops.decode_attention import live_bytes
    nbytes = live_bytes(q, k_full, lengths, quant)
    _, h, d = q.shape
    live = int(lengths.clamp(0, k_full.shape[2]).sum())
    flops = 4 * live * h * d  # q.k and p.v: 2*D each, per live slot and query head
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure_attention(q, caches, vis, lengths, quant):
    """Error of the kernel against its plain version at the first and the
    last layer, and the times of the kernel, the plain version and (bf16
    only) SDPA over the layer slice."""
    import torch.nn.functional as F
    from vibevoice_tpu_torch.ops import decode_attention as da
    k, v, ks, vs = caches[0]
    n_layers = k.shape[0]
    err = 0.0
    for layer in (0, n_layers - 1):
        got = da.decode_attention(q, k, v, layer, vis, lengths, ks, vs)
        torch.cuda.synchronize()
        want = da.decode_attention_ref(q, k, v, layer, vis, lengths, ks, vs)
        if not torch.isfinite(got).all():
            raise RuntimeError("decode_attention kernel returned non-finite values")
        err = max(err, (got.float() - want.float()).abs().max().item())
    slots = [(c, l) for c in caches for l in range(n_layers)]

    def kern(i):
        kk, vv, kss, vss = slots[i % len(slots)][0]
        da.decode_attention(q, kk, vv, slots[i % len(slots)][1], vis, lengths, kss, vss)

    def plain(i):
        kk, vv, kss, vss = slots[i % len(slots)][0]
        da.decode_attention_ref(q, kk, vv, slots[i % len(slots)][1], vis, lengths, kss, vss)

    ms = cuda_ms(kern, len(slots))
    plain_ms = cuda_ms(plain, n_layers)
    lib_ms = None
    if not quant:
        b, h, d = q.shape
        s, f = k.shape[2], k.shape[3]
        mask = ((vis > 0) & (torch.arange(s, device=q.device)[None] < lengths[:, None]))
        mask = mask[:, None, None, :]
        q4 = q[:, :, None, :]

        def lib(i):
            kk, vv, _, _ = slots[i % len(slots)][0]
            layer = slots[i % len(slots)][1]
            kl = kk[layer].view(b, s, f // d, d).transpose(1, 2)
            vl = vv[layer].view(b, s, f // d, d).transpose(1, 2)
            F.scaled_dot_product_attention(q4, kl, vl, attn_mask=mask, enable_gqa=True)

        lib_ms = cuda_ms(lib, len(slots))
    bms, by = bound_ms(q, k, lengths, quant)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


# decode attention's phase-2 cases beyond the 1.5B S=4096/8192 grid of
# `phase_kernels`: (cache slots, live slots of both rows, int8 KV, H, KVH,
# layers, cache copies), each loop over copy x layer reading more than L2: the
# engine's own live length (~340 of a 4096-slot cache), a 90-minute request
# (40 000 live of 40 960) in bf16 and int8 KV, and the 7B grouping (G=7)
ATTN_CASES = ((4096, 340, False, 12, 2, 28, 4), (40960, 40000, False, 12, 2, 4, 1),
              (40960, 40000, True, 12, 2, 4, 1), (4096, 1500, False, 28, 4, 28, 1),
              (40960, 40000, False, 28, 4, 2, 1))


def phase_kernels(dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for s in (4096, 8192):
        for quant in (False, True):
            for live in (1500, s):
                q, caches, vis, lengths = attention_inputs(s, [live, live], quant, 4, gen, dev)
                r = measure_attention(q, caches, vis, lengths, quant)
                emit("kernel_vs_plain", kernel="decode_attention", S=s,
                     kv="int8" if quant else "bf16", live=live, tol=KERNEL_TOL, **r)
                if not r["max_abs_err"] <= KERNEL_TOL:
                    raise RuntimeError(f"decode_attention disagrees with its plain version: "
                                       f"{r['max_abs_err']} > {KERNEL_TOL}")
                del caches
    for s, live, quant, h, kvh, n_layers, copies in ATTN_CASES:
        q, caches, vis, lengths = attention_inputs(s, [live, live], quant, copies, gen, dev,
                                                   n_layers=n_layers, h=h, kvh=kvh)
        r = measure_attention(q, caches, vis, lengths, quant)
        k, v, ks, vs = caches[0]
        stable = torch.equal(*(da_call(q, k, v, vis, lengths, ks, vs) for _ in range(2)))
        emit("kernel_vs_plain", kernel="decode_attention", S=s, kv="int8" if quant else "bf16",
             live=live, H=h, KVH=kvh, layers=n_layers, copies=copies, bit_stable=stable,
             bound_share=r["bound_ms"] / r["ms"], tol=KERNEL_TOL, **r)
        if not (r["max_abs_err"] <= KERNEL_TOL and stable):
            raise RuntimeError(f"decode_attention at S={s} live={live}: error "
                               f"{r['max_abs_err']} > {KERNEL_TOL} or two calls differ")
        del caches, k, v, ks, vs
    torch.cuda.empty_cache()


def da_call(q, k, v, vis, lengths, ks, vs):
    from vibevoice_tpu_torch.ops import decode_attention as da
    return da.decode_attention(q, k, v, k.shape[0] - 1, vis, lengths, ks, vs)


# ---------------------------------------------------------------------------
# phase 2, the int4 kernels: int4_matmul, the Block1D chain, the fused head
# ---------------------------------------------------------------------------

def rel_tol(want) -> float:
    """bf16 outputs: one rounding step of the largest output (2^-7 of it),
    after fp32 sums taken in another order."""
    return 2 ** -7 * float(want.float().abs().max())


def agree(name, got, want):
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name} kernel returned non-finite values")
    err, tol = float((got.float() - want.float()).abs().max()), rel_tol(want)
    if not err <= tol:
        raise RuntimeError(f"{name} disagrees with its plain version: {err} > {tol}")
    return err, tol


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def copies_for(size: int) -> int:
    """Weight copies a timing loop rotates over so that it reads about twice
    what the 50 MB L2 holds, as a decode step finds its weights cold."""
    return max(2, -(-int(2 * L2_BYTES) // max(1, size)))


def measure_int4(x, weights):
    """int4_matmul on x [M, K] bf16 against weight copies of one shape: error
    against the plain version, kernel / plain / library (torch.matmul against
    the pre-dequantized bf16 weight) times, and the bound (per call)."""
    from vibevoice_tpu_torch.ops import int4_matmul as im
    w0 = weights[0]
    err, tol = agree("int4_matmul", im.int4_matmul(x, w0["qint4"], w0["scale4"]),
                     im.int4_matmul_ref(x, w0["qint4"], w0["scale4"]))
    n = len(weights)
    ms = cuda_ms(lambda i: im.int4_matmul(x, weights[i % n]["qint4"], weights[i % n]["scale4"]),
                 2 * n)
    plain_ms = cuda_ms(lambda i: im.int4_matmul_ref(x, weights[i % n]["qint4"],
                                                    weights[i % n]["scale4"]), min(n, 8))
    dense = [im.dequant_int4(w["qint4"], w["scale4"], x.dtype) for w in weights]
    lib_ms = cuda_ms(lambda i: torch.matmul(x, dense[i % n]), 2 * n)
    del dense
    bms, by = int4_bound(x, w0)
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def int4_bound(x, w):
    """x, the packed weight and its scales read once, y written once, or
    2*M*K*N flops."""
    m, k = x.shape
    cols = w["qint4"].shape[1]
    return bound(nbytes(x, w["qint4"], w["scale4"]) + m * cols * x.element_size(),
                 2 * m * k * cols)


# int4_matmul's phase-2 cases: the 1.5B projections (K, N) at M=2, per
# channel and per group of 128, then M=64 and 128
INT4_SHAPES = {"qkv": (1536, 2048), "o": (1536, 1536), "gateup": (1536, 17920),
               "down": (8960, 1536)}
INT4_CASES = ([(name, 2, gs) for name in INT4_SHAPES for gs in (None, 128)]
              + [("qkv", 64, None), ("qkv", 128, None), ("qkv", 128, 128)])


def int4_inputs(name, m, gs, gen, dev):
    """bf16 x [M, K] and copies of a random int4 weight of projection
    `name` (enough to read twice what L2 holds per timing loop)."""
    from vibevoice_tpu_torch.ops import int4_matmul as im
    k, n = INT4_SHAPES[name]
    weights = [im.quantize_int4(torch.randn((k, n), generator=gen, device=dev) * 0.02, gs)
               for _ in range(copies_for(k * n // 2))]
    return torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16), weights


def chain_inputs(pack, b, t, gen, dev):
    n, _, d = pack["vecs"].shape
    x = (0.5 * torch.randn((b, t, d), generator=gen, device=dev)).to(torch.bfloat16)
    ctx = (0.5 * torch.randn((b, n, 6, d), generator=gen, device=dev)).to(torch.bfloat16)
    return x, ctx


def measure_chain(packs, x, ctx):
    """A chain kernel over pack copies of one stage shape (per call): the int4
    chain for int4 packs, the plain-pack chain for plain ones; two calls on
    the same inputs must give the same bits (sums in a fixed order).  Its
    error, times, bound and share of the bound."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    plain = "w1q" not in packs[0]
    run = fb.fused_block_chain_plain if plain else fb.fused_block_chain_batched
    ref = fb.fused_block_chain_plain_ref if plain else fb.fused_block_chain_batched_ref
    name = "fused_block_chain" if plain else "fused_block_chain_batched"
    y, new_ctx = run(packs[0], x, ctx)
    y_ref, ctx_ref = ref(packs[0], x, ctx)
    err, tol = agree(name, y, y_ref)
    err_c, tol_c = agree(f"{name}[ctx]", new_ctx, ctx_ref)
    y2, ctx2 = run(packs[0], x, ctx)  # sums in a fixed order: a second call gives the same bits
    if not (torch.equal(y, y2) and torch.equal(new_ctx, ctx2)):
        raise RuntimeError(f"{name}: two calls on the same inputs differ")
    n = len(packs)
    ms = cuda_ms(lambda i: run(packs[i % n], x, ctx), 2 * n)
    plain_ms = cuda_ms(lambda i: ref(packs[i % n], x, ctx), min(n, 4))
    bms, by = chain_bound(packs[0], x, ctx)
    return dict(max_abs_err=max(err, err_c), tol=min(tol, tol_c), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None, bit_stable=True,
                bound_share=bms / ms)


def chain_bound(pack, x, ctx):
    """The pack, x and ctx read once, y and the new ctx written once, or
    4*rows*D*F flops per block."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    b, t, d = x.shape
    nb, f = pack["vecs"].shape[0], pack["w1" if "w1q" not in pack else "w1q"].shape[2]
    return bound(fb.pack_bytes(pack) + 2 * nbytes(x, ctx), 4 * b * t * d * f * nb)


def head_inputs(pack, n, lat, gen, dev):
    nl, _, h = pack["norms"].shape
    bf = torch.bfloat16
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return (r(n, h).to(bf), (0.3 * r(nl, n, 3 * h)).to(bf), (0.3 * r(n, 2 * h)).to(bf),
            (0.05 * r(h, lat)).to(bf))


def measure_head(packs, x, mods, fmod, fl, eps=1e-5):
    """The fused int4 head step over pack copies (per call); two calls on the
    same inputs must give the same bits (sums in a fixed order)."""
    from vibevoice_tpu_torch.ops import fused_head as fh
    got = fh.fused_head_solver_step(packs[0], x, mods, fmod, fl, eps)
    err, tol = agree("fused_head", got,
                     fh.fused_head_solver_step_ref(packs[0], x, mods, fmod, fl, eps))
    if not torch.equal(got, fh.fused_head_solver_step(packs[0], x, mods, fmod, fl, eps)):
        raise RuntimeError("fused_head: two calls on the same inputs differ")
    n = len(packs)
    ms = cuda_ms(lambda i: fh.fused_head_solver_step(packs[i % n], x, mods, fmod, fl, eps), 2 * n)
    plain_ms = cuda_ms(lambda i: fh.fused_head_solver_step_ref(packs[i % n], x, mods, fmod, fl,
                                                               eps), min(n, 4))
    bms, by = head_bound(packs[0], x, mods, fmod, fl)
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)


def head_bound(pack, x, mods, fmod, fl):
    """The pack, x, the modulations and the final linear read once, the
    output written once, or 6*N*H*F flops per layer and 2*N*H*latent."""
    from vibevoice_tpu_torch.ops import fused_head as fh
    rows, h = x.shape
    nl, f = pack["norms"].shape[0], pack["wgq"].shape[2]
    return bound(fh.pack_bytes(pack) + nbytes(x, mods, fmod, fl)
                 + rows * fl.shape[1] * x.element_size(),
                 6 * rows * h * f * nl + 2 * rows * h * fl.shape[1])


# the int4 chain's phase-2 cases (D, blocks, T, B): the four 1.5B stages are
# two shapes (decoder 0 / encoder 6: D=2048, 8 blocks, T=1; decoder 1 /
# encoder 5: D=1024, 3 blocks, T=8), plus B=4
CHAIN_CASES = ((2048, 8, 1, 1), (1024, 3, 8, 1), (1024, 3, 8, 4))


def random_stage(d, n, gen, dev):
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return [{"norm_w": 1 + 0.1 * r(d), "mixer": {"w": 0.2 * r(7, 1, d), "b": 0.1 * r(d)},
             "gamma": 0.3 * r(d), "ffn_norm_w": 1 + 0.1 * r(d),
             "ffn1": {"w": 0.02 * r(d, 4 * d), "b": 0.1 * r(4 * d)},
             "ffn2": {"w": 0.02 * r(4 * d, d), "b": 0.1 * r(d)}, "ffn_gamma": 0.3 * r(d)}
            for _ in range(n)]


def random_head(h, f, gen, dev):
    """A 4-layer head's FFN weights and norms at width h, FFN width f."""
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return {"layers": [{"norm_w": 1 + 0.1 * r(h), "gate": 0.03 * r(h, f), "up": 0.03 * r(h, f),
                        "down": 0.03 * r(f, h)} for _ in range(4)]}


def phase_int4_kernels(dev):
    """The three int4 kernels against their plain versions at the 1.5B
    shapes, on random weights made from the seed."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb, fused_head as fh
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for name, m, gs in INT4_CASES:
        x, weights = int4_inputs(name, m, gs, gen, dev)
        k, n = INT4_SHAPES[name]
        emit("kernel_vs_plain", kernel="int4_matmul", proj=name, M=m, K=k, N=n,
             group_size=gs, **measure_int4(x, weights))
        del weights
    for d, nblk, t, b in CHAIN_CASES:
        packs = [fb.pack_stage_q(random_stage(d, nblk, gen, dev))
                 for _ in range(copies_for(nblk * d * 4 * d))]
        x, ctx = chain_inputs(packs[0], b, t, gen, dev)
        emit("kernel_vs_plain", kernel="fused_block_chain_batched", D=d, blocks=nblk, T=t, B=b,
             **measure_chain(packs, x, ctx))
        del packs
    h, f = 1536, 4608
    packs = [fh.pack_head_solver_q(random_head(h, f, gen, dev))
             for _ in range(copies_for(6 * h * f))]
    emit("kernel_vs_plain", kernel="fused_head_solver_step", N=2, H=h, F=f, layers=4,
         **measure_head(packs, *head_inputs(packs[0], 2, 64, gen, dev)))
    del packs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 2, the large-T stage kernels: fused_stage_chain and its row-lane form
# ---------------------------------------------------------------------------

# (name, B, stage T, D, folded conv (kind, s, k, cin), folded tail, row-lane R);
# 3 blocks each, as every large-T stage of the 1.5B stacks
STAGE_CASES = [
    ("decoder 3", 1, 200, 256, ("up", 5, 10, 512), False, None),
    ("decoder 4", 1, 800, 128, ("up", 4, 8, 256), False, None),
    ("decoder 5", 1, 1600, 64, ("up", 2, 4, 128), False, None),
    ("decoder 6", 1, 3200, 32, ("up", 2, 4, 64), False, None),
    ("encoder 0", 1, 3200, 32, ("down", 1, 7, 1), False, None),
    ("encoder 1", 1, 1600, 64, ("down", 2, 4, 32), False, None),
    ("encoder 2", 1, 800, 128, ("down", 2, 4, 64), False, None),
    ("encoder 3", 1, 200, 256, ("down", 4, 8, 128), False, None),
    ("decoder 6 + tail", 1, 3200, 32, ("up", 2, 4, 64), True, None),
    ("decoder 4", 2, 800, 128, None, False, None),
    ("decoder 3", 2, 200, 256, None, False, None),
    ("decoder 6", 2, 3200, 32, None, False, 2),
    ("decoder 5", 2, 1600, 64, None, False, 2),
    ("decoder 6", 4, 3200, 32, None, False, 4),
    ("decoder 5", 4, 1600, 64, None, False, 2),
    ("decoder 6", 32, 3200, 32, None, False, 4),
    ("decoder 5", 32, 1600, 64, None, False, 2),
]


def stage_inputs(pack, b, t, gen, dev):
    """Two chunks of x, the block contexts and the folds' states of a stage
    pack at batch b and stage T (the activation dtype is the pack's)."""
    n, _, d = pack["vecs"].shape
    rnd = lambda *shape: (0.5 * torch.randn(shape, generator=gen, device=dev)).to(
        pack["vecs"].dtype)
    conv, states = pack.get("conv"), {}
    xshape = (b, t, d)
    if conv is not None and conv.kind == "up":
        xshape, states["conv_state"] = (b, t // conv.s, conv.cin), (b, conv.s, d)
    elif conv is not None:
        xshape, states["conv_state"] = (b, t * conv.s, conv.cin), (b, conv.k - conv.s, conv.cin)
    if "head" in pack:
        states["head_state"] = (b, pack["head"].k - 1, d)
    return ([rnd(*xshape) for _ in range(2)], rnd(b, n, 6, d),
            {k: rnd(*shape) for k, shape in states.items()})


def clone_pack(pack):
    from vibevoice_tpu_torch.ops import fused_stage as fs
    out = {}
    for k, v in pack.items():
        if isinstance(v, dict):
            out[k] = clone_pack(v)
        elif isinstance(v, fs.ConvPack):
            out[k] = fs.ConvPack(v.kind, v.w.clone(), v.b.clone(), v.s, v.k, v.cin)
        elif isinstance(v, fs.HeadPack):
            out[k] = fs.HeadPack(v.w.clone(), None if v.b is None else v.b.clone(), v.k,
                                 v.has_norm)
        else:
            out[k] = v.clone()
    return out


def uses_rowlane(pack, batch) -> bool:
    """Whether `fused_stage_chain` sends this pack to the row-lane kernel."""
    if "rowlane" not in pack or "conv" in pack or "head" in pack:
        return False
    r = pack["rowlane"]["vecs"].shape[2] // pack["vecs"].shape[2]
    return r > 1 and batch % r == 0


def measure_stage(pack, b, t, gen, dev, inputs=None):
    """A stage kernel over two chunks (each chunk's returned states feed the
    next call, on either side) against its plain version, then its time over
    pack copies that exceed L2, the plain version's and the bound (per call).
    `inputs` (`stage_inputs`'s) are drawn from `gen` unless given."""
    from vibevoice_tpu_torch.ops import fused_stage as fs
    rowlane = uses_rowlane(pack, b)
    plain = fs.fused_stage_chain_rowlane_ref if rowlane else fs.fused_stage_chain_ref
    xs, ctx, states = inputs or stage_inputs(pack, b, t, gen, dev)
    names = list(states)
    got_st = want_st = (ctx, *states.values())
    err, tol = 0.0, 1.0  # the output closest to its tolerance
    for x in xs:
        got = fs.fused_stage_chain(pack, x, got_st[0], **dict(zip(names, got_st[1:])))
        want = plain(pack, x, want_st[0], **dict(zip(names, want_st[1:])))
        for j, (g, w) in enumerate(zip(got, want)):
            e, tl = agree(f"fused_stage_chain{'_rowlane' if rowlane else ''}[{j}]", g, w)
            if e * tol >= err * tl:
                err, tol = e, tl
        got_st, want_st = got[1:], want[1:]
    nbytes, flops = fs.stage_work(pack, xs[0])
    copies = [pack] + [clone_pack(pack) for _ in range(min(63, copies_for(nbytes) - 1))]
    n = len(copies)
    ms = cuda_ms(lambda i: fs.fused_stage_chain(copies[i % n], xs[0], ctx, **states), 2 * n)
    plain_ms = cuda_ms(lambda i: plain(copies[i % n], xs[0], ctx, **states), min(n, 4))
    bms, by = bound(nbytes, flops)
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None)


def random_stage_pack(d, conv, head, r, gen, dev):
    """A bf16 pack of a random 3-block stage of width d, with a folded conv
    (kind, s, k, cin), the folded tail and a row-lane pack for r rows as
    asked."""
    from vibevoice_tpu_torch.ops import fused_stage as fs
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    bf = torch.bfloat16
    blocks = random_stage(d, 3, gen, dev)
    pack = fs.pack_stage(blocks, dtype=bf)
    if r:
        pack["rowlane"] = fs.pack_stage_rowlane(blocks, r, dtype=bf)
    if conv and conv[0] == "up":
        pack["conv"] = fs.pack_up_conv({"w": rnd(conv[3], conv[2], d) / conv[3] ** 0.5,
                                        "b": 0.1 * rnd(d)}, conv[1], bf)
    elif conv:
        pack["conv"] = fs.pack_down_conv({"w": rnd(conv[2], conv[3], d) / conv[3] ** 0.5,
                                          "b": 0.1 * rnd(d)}, conv[1], bf)
    if head:
        pack["head"] = fs.pack_head({"w": 0.1 * rnd(7, d, 1), "b": 0.1 * rnd(1)},
                                    1 + 0.1 * rnd(d))
    return pack


def phase_stage_kernels(dev):
    """Both stage kernels against their plain versions at the 1.5B stage
    shapes in bf16, on random weights made from the seed.  Each row-lane case
    is followed by the plain stage kernel on the same rows and inputs (the
    pack without its row-lane entry), the two readings the engine's row-lane
    policy rests on; the row-lane line says whether its outputs are bit-equal
    to the stage kernel's."""
    from vibevoice_tpu_torch.ops import fused_stage as fs
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for name, b, t, d, conv, head, r in STAGE_CASES:
        pack = random_stage_pack(d, conv, head, r, gen, dev)
        inputs = stage_inputs(pack, b, t, gen, dev)
        same_rows = {k: v for k, v in pack.items() if k != "rowlane"}
        extra = {}
        if r:
            xs, ctx, states = inputs
            got = fs.fused_stage_chain(pack, xs[0], ctx, **states)
            want = fs.fused_stage_chain(same_rows, xs[0], ctx, **states)
            extra["bit_equal_to_stage_kernel"] = all(torch.equal(g, w) for g, w in zip(got, want))
        emit("kernel_vs_plain",
             kernel="fused_stage_chain_rowlane" if uses_rowlane(pack, b) else "fused_stage_chain",
             stage=name, B=b, T=t, D=d, blocks=3, conv=conv, head=head, rows=r, **extra,
             **measure_stage(pack, b, t, gen, dev, inputs))
        if r:
            emit("kernel_vs_plain", kernel="fused_stage_chain", stage=name, B=b, T=t, D=d,
                 blocks=3, conv=conv, head=head, rows=None, same_rows_as_rowlane=r,
                 **measure_stage(same_rows, b, t, gen, dev, inputs))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 2, the kernels of the long-prompt path: flash prefill, the plain chain
# ---------------------------------------------------------------------------

# flash prefill's phase-2 cases: (B, T, left pad of the last row, H, KVH);
# the 1.5B attention shape, then the 7B one (seven query heads per KV head)
FLASH_CASES = ((1, 1024, 0, 12, 2), (1, 4096, 0, 12, 2), (2, 1024, 333, 12, 2),
               (1, 4096, 0, 28, 4))
ROW_REL_TOL = 2 ** -7  # one bf16 rounding step of a row's own largest output


def flash_inputs(b, t, pad, gen, dev, h=12, kvh=2, d=128):
    """bf16 q [B, T, H, D], k/v [B, T, KVH, D] and the pad mask, the last row
    left-padded by `pad` tokens."""
    rnd = lambda *shape: (0.5 * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)
    mask = torch.ones((b, t), dtype=torch.int32, device=dev)
    mask[b - 1, :pad] = 0
    return rnd(b, t, h, d), rnd(b, t, kvh, d), rnd(b, t, kvh, d), mask


def agree_rows(name, got, want, mask):
    """Flash prefill's output against its plain version, row by row: every
    row finite, each real query row (position, head) within one bf16 step of
    its own largest output (a late row averages over thousands of keys and is
    far smaller than the largest of all), the rows that see no key zero.
    Returns (max abs error, worst row's error over its scale, median |want|
    over the real rows)."""
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name} kernel returned non-finite values")
    real = mask > 0
    g, w = got[real].float(), want[real].float()          # [real positions, H, D]
    err_row = (g - w).abs().amax(dim=-1)
    scale_row = w.abs().amax(dim=-1)
    worst = float((err_row / scale_row.clamp_min(1e-30)).max())
    if not worst <= ROW_REL_TOL:
        raise RuntimeError(f"{name} disagrees with its plain version: a row is off by {worst} "
                           f"of its scale > {ROW_REL_TOL}")
    if bool(got[~real].any()):
        raise RuntimeError(f"{name}: a row that sees no key is not zero")
    return float(err_row.max()), worst, float(w.abs().median())


def flash_library(q, k, v, mask):
    """One SDPA call computing the same function (causal, GQA; with the pad
    mask where a row is padded)."""
    import torch.nn.functional as F
    t = q.shape[1]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    real = mask > 0
    if bool(real.all()):
        return lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                        enable_gqa=True)
    allowed = (torch.ones((t, t), dtype=torch.bool, device=q.device).tril()[None]
               & real[:, None, :])[:, None]
    return lambda i: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed,
                                                    enable_gqa=True)


def flash_bound(q, k, v, mask):
    """The real rows' causal (row, key) pairs at 4*D*H flops each, or q, k,
    v, the mask and the output once over HBM."""
    from vibevoice_tpu_torch.ops import flash_attention as fa
    _, t, h, d = q.shape
    return bound(nbytes(q, k, v, mask) + nbytes(q), 4 * d * h * fa.attended_pairs(mask, t))


def measure_flash(q, k, v, mask):
    """Flash prefill against its plain version (`agree_rows`), then the
    kernel's time at the CTA height it picks and at both heights, the plain
    version's and SDPA's times, and the bound."""
    from vibevoice_tpu_torch.ops import cuda_build, flash_attention as fa
    want = fa.flash_attention_prefill_ref(q, k, v, mask)
    err, worst, typical = agree_rows("flash_attention_prefill",
                                     fa.flash_attention_prefill(q, k, v, mask), want, mask)
    for rows in (64, 128):
        agree_rows(f"flash_attention_prefill[{rows} rows]",
                   fa.flash_attention_prefill_at(q, k, v, mask, rows), want, mask)
    del want
    ms = cuda_ms(lambda i: fa.flash_attention_prefill(q, k, v, mask), 20)
    ms_at = {str(rows): cuda_ms(lambda i: fa.flash_attention_prefill_at(q, k, v, mask, rows), 20)
             for rows in (64, 128)}
    plain_ms = cuda_ms(lambda i: fa.flash_attention_prefill_ref(q, k, v, mask), 3)
    lib_ms = cuda_ms(flash_library(q, k, v, mask), 20)
    bms, by = flash_bound(q, k, v, mask)
    b, t, h, _ = q.shape
    rows = fa.cta_rows(b, t, h, k.shape[2], cuda_build.sm_count(q.device))
    return dict(max_abs_err=err, worst_row_err_rel=worst, row_rel_tol=ROW_REL_TOL,
                median_abs_want=typical, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, cta_rows=rows, ms_at_cta_rows=ms_at)


def phase_flash_kernel(dev):
    """Flash prefill at the 1.5B attention shape (H=12, KVH=2, D=128), bf16,
    and at the 7B one (H=28, KVH=4: seven query heads per KV head)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    for b, t, pad, h, kvh in FLASH_CASES:
        r = measure_flash(*flash_inputs(b, t, pad, gen, dev, h, kvh))
        emit("kernel_vs_plain", kernel="flash_attention_prefill", B=b, T=t, H=h, KVH=kvh, D=128,
             left_pad=pad, model="7B" if h == 28 else "1.5B", **r)
    torch.cuda.empty_cache()


def phase_plain_chain(dev):
    """The plain-pack chain at the four packed stages of a 1.5B step (bf16
    packs of random weights; two per shape: decoder 0 / encoder 6 at D=2048,
    8 blocks, T=1; decoder 1 / encoder 5 at D=1024, 3 blocks, T=8), B=1 and
    B=2: each pack over two chunks with the context carried on both sides,
    then two calls bit-equal and the time per call rotating over the shape's
    two packs (each pair is over 100 MB, twice L2), with its share of the
    bound."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    for (d, nblk, t), stages in (((2048, 8, 1), ("decoder 0", "encoder 6")),
                                 ((1024, 3, 8), ("decoder 1", "encoder 5"))):
        packs = [fb.pack_stage(random_stage(d, nblk, gen, dev), dtype=torch.bfloat16)
                 for _ in stages]
        for b in (1, 2):
            worst = (0.0, 1.0)
            for pack in packs:
                got_c = want_c = chain_inputs(pack, b, t, gen, dev)[1]
                for _ in range(2):
                    x = chain_inputs(pack, b, t, gen, dev)[0]
                    y, got_c = fb.fused_block_chain_plain(pack, x, got_c)
                    y_ref, want_c = fb.fused_block_chain_plain_ref(pack, x, want_c)
                    for e in (agree("fused_block_chain", y, y_ref),
                              agree("fused_block_chain[ctx]", got_c, want_c)):
                        worst = max(worst, e, key=lambda et: et[0] / et[1])
            x, ctx = chain_inputs(packs[0], b, t, gen, dev)
            r = measure_chain(packs, x, ctx)
            r["max_abs_err"], r["tol"] = max(worst, (r["max_abs_err"], r["tol"]),
                                             key=lambda et: et[0] / et[1])
            emit("kernel_vs_plain", kernel="fused_block_chain", stages=stages, D=d, blocks=nblk,
                 T=t, B=b, chunks=2, **r)
        del packs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 3-5: the long-cache engine, bf16 and quantized
# ---------------------------------------------------------------------------

def bench_gen(G):
    # the reference's production serving setting (as bench.py drives it)
    return G.GenerationConfig(
        speech_start_id=151652, speech_end_id=151653, speech_diffusion_id=151654,
        eos_id=151643, cfg_scale=1.3, ddpm_steps=5, algorithm_type="sde-dpmsolver++",
        force_diffusion=True, max_length_times=64.0)


def kernel_counters():
    """name -> the wrapper whose `launches` counts that kernel's launches."""
    from vibevoice_tpu_torch.ops import decode_attention as da, flash_attention as fa
    from vibevoice_tpu_torch.ops import fused_blocks as fb, fused_head as fh
    from vibevoice_tpu_torch.ops import fused_stage as fs, int4_matmul as im
    return {"decode_attention": da.decode_attention, "int4_matmul": im.int4_matmul,
            "fused_block_chain_batched": fb.fused_block_chain_batched,
            "fused_head_solver_step": fh.fused_head_solver_step,
            "fused_stage_chain": fs.fused_stage_chain,
            "fused_stage_chain_rowlane": fs.fused_stage_chain_rowlane,
            "flash_attention_prefill": fa.flash_attention_prefill,
            "fused_block_chain": fb.fused_block_chain_plain}


def codec_launches(eng):
    """Launches per diffusing step of the streaming codecs' four kernels,
    walking each stage of the vocoder and the re-encode as the tokenizer
    does when the engine takes the fused path (`use_fused_vocoder` /
    `use_fused_semantic`, or `use_fused_stages`): a large-T pack with a
    folded conv runs the stage kernel; else a small-T chain pack runs its
    chain (int4 packs `fused_block_chain_batched`, plain ones
    `fused_block_chain`); else a large-T pack runs the stage kernel, in its
    row-lane form where `uses_rowlane` says so."""
    out = dict.fromkeys(("fused_stage_chain", "fused_stage_chain_rowlane",
                         "fused_block_chain_batched", "fused_block_chain"), 0)
    for flag, key in ((eng.use_fused_vocoder, "_vocoder_packs"),
                      (eng.use_fused_semantic, "_semantic_packs")):
        if not (flag or eng.use_fused_stages):
            continue
        chain, large = eng.params.get(key) or {}, eng.params.get(key + "_large") or {}
        for i in set(chain) | set(large):
            lp = large.get(i)
            if i in chain and not (lp is not None and "conv" in lp):
                out["fused_block_chain_batched" if "w1q" in chain[i] else "fused_block_chain"] += 1
            elif uses_rowlane(lp, eng.batch):
                out["fused_stage_chain_rowlane"] += 1
            else:
                out["fused_stage_chain"] += 1
    return out


def stage_launches(eng):
    """Launches of the two stage kernels per diffusing step (`codec_launches`)."""
    c = codec_launches(eng)
    return {k: c[k] for k in ("fused_stage_chain", "fused_stage_chain_rowlane")}


def expected_launches(cfg, quant, eng):
    """(prefill, per decode step) launches of each kernel of `eng` with
    force_diffusion: decode attention once per layer per decode step; flash
    prefill once per layer in the prompt's forward where the engine takes it
    (prompts of 1024 tokens or more), never in a step; the int4 GEMVs (qkv,
    o, gateup, down; only gateup and down under int4f) once per layer in the
    negative stream's M=B prefill forward and in every step (the 256-row
    prompt forward takes the dequantized route); the chains and the stage
    kernels as `codec_launches` counts them (at 1.5B: a chain on 2 stages of
    the vocoder and 2 of the re-encode) and the head once per solver step, on
    every diffusing step, step 0 (in prefill) included."""
    n_layers = cfg.decoder.num_hidden_layers
    gemv = {None: 0, "int4": 4, "int4f": 2}[quant] * n_layers
    head = 5 if quant else 0
    per_step = dict(codec_launches(eng), fused_head_solver_step=head)
    prefill = dict(per_step, decode_attention=0, int4_matmul=gemv,
                   flash_attention_prefill=n_layers if eng.use_flash_prefill else 0)
    step = dict(per_step, decode_attention=n_layers, int4_matmul=gemv,
                flash_attention_prefill=0)
    return prefill, step


# each engine run: an eager request, two requests on the graph engine (the
# first captures its step), an eager request again
TURNS = ("eager", "graph", "graph", "eager")


class Run(NamedTuple):
    """What `run_engine` hands on: the wrappers' launches by kernel in the
    graph engine's first turn (the prefill, the warm-up step and the
    captured step), the launches that ran on the device in that turn (the
    prefill's, then one step's per executed step), the last turn's final
    state and the graph engine."""
    launches: dict
    device_launches: dict
    state: Any
    eng: Any


def run_engine(params, cfg, dev, kv_dtype, warm_steps, timed_chunks, card, quant=None,
               batch=1, stages=False, want_stages=None, rowlane=None, prompt_len=256,
               max_steps=3840, chain=False):
    """The long-cache engine in TURNS: an eager engine (`Engine(eager=True)`:
    every step launched from the host) and a graph engine (the captured step,
    replayed; built on the eager engine's params and packs), each turn a
    request of its own: prefill, a warm-up chunk and the timed chunks.  A
    graph engine's second turn is a second request on the same graph.

    Launch checks against `expected_launches` (and, with `use_fused_stages`,
    the stage kernels' per-step counts against `want_stages`; `rowlane`
    turns the row-lane layout on or off, None leaves the engine's rule): an
    eager turn counts every kernel's launches per step; a graph turn counts
    the prefill's through the wrappers, plus the warm-up step's and the
    captured step's in the turn that captures, and nothing per replay, and
    the captured step's kernel nodes equal the per-step counts.  The small-T
    chains are on with `quant` (the pipeline's int4 packs in `params`) or
    `chain` (plain packs, built by the engine).  Emits one `engine` line per
    turn (a graph turn with its nodes by kernel and the device ms of one
    replay) and one `engine_turns` line."""
    from vibevoice_tpu_torch.engine import generate as G
    fused = quant is not None or chain
    kw = dict(max_steps=max_steps, batch=batch, prompt_len=prompt_len, dtype=torch.bfloat16,
              kv_dtype=kv_dtype, device=dev, use_fused_vocoder=fused, use_fused_semantic=fused,
              use_fused_stages=stages, fused_stage_rowlane=rowlane)
    eager = G.Engine(params, cfg, bench_gen(G), eager=True, **kw)
    eng = G.Engine(eager.params, cfg, bench_gen(G), **kw)  # the eager engine's packs
    engines = {"eager": eager, "graph": eng}
    if stages and stage_launches(eng) != want_stages:
        raise RuntimeError(f"stage packs give {stage_launches(eng)} launches per step, "
                           f"want {want_stages}")
    if not (eng.use_flash_decode and eng.cache_len >= 4096):
        raise RuntimeError(f"engine is off the long-cache path: cache {eng.cache_len}")
    want_prefill, want_step = expected_launches(cfg, quant, eng)
    steps = warm_steps + sum(timed_chunks)
    ids = np.random.default_rng(SEED).integers(0, 1000, (batch, prompt_len)).astype(np.int32)
    mask = np.ones((batch, prompt_len), np.int32)
    sim = np.zeros((batch, prompt_len), bool)
    hop = cfg.speech_compress_ratio
    counters = kernel_counters()
    summary = {mode: {"ms_per_frame": [], "audio_s_per_s": []} for mode in engines}
    run = None
    for mode in TURNS:
        e = engines[mode]
        captures = mode == "graph" and e.graph is None
        replays0 = e.replays
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        state, _ = e.prefill(ids, mask, sim, generator=gen)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = {k: c.launches for k, c in counters.items()}
        state, _ = e.decode_chunk(state, warm_steps)
        f_prev = int(state.frames.sum())
        chunks = []
        for n in timed_chunks:
            t0 = time.perf_counter()
            state, _ = e.decode_chunk(state, n)
            f_now = int(state.frames.sum())  # waits for the device
            dt = time.perf_counter() - t0
            chunks.append({"steps": n, "frames": f_now - f_prev, "wall_s": dt})
            f_prev = f_now
        launches = {k: c.launches for k, c in counters.items()}

        # through the wrappers: every step eagerly; with the graph the
        # warm-up step and the captured one, in the turn that captures
        wrapped = steps if mode == "eager" else (2 if captures else 0)
        want = {k: want_prefill[k] + wrapped * want_step[k] for k in counters}
        if prefill_launches != want_prefill or launches != want:
            raise RuntimeError(f"{mode} kernel launches: prefill {prefill_launches} (want "
                               f"{want_prefill}), run {launches} (want {want}) over {steps} "
                               "decode steps")
        graph_info = {}
        if mode == "graph":
            if e.replays - replays0 != steps - captures:
                raise RuntimeError(f"{e.replays - replays0} replays for {steps} steps")
            nodes, other = graph_launches(e.graph)
            if nodes != merge_stages(want_step):
                raise RuntimeError(f"the captured step's kernel nodes {nodes} differ from "
                                   f"the step's launches {merge_stages(want_step)}")
            graph_info = dict(graph_nodes=nodes, graph_other_nodes=other,
                              capture_s=e.capture_s if captures else None)
        emitted = state.emitted[:, : state.host_step]
        audio = state.audio[:, : state.host_step]
        if not bool(emitted.all()):
            raise RuntimeError("a forced-diffusion step emitted no frame")
        if not bool(torch.isfinite(audio).all()) or float(audio.abs().max()) == 0.0:
            raise RuntimeError("engine audio is not finite or is all zero")
        if mode == "graph":
            # after the checks: each replay advances the state by a step
            graph_info["device_ms_per_replay"] = cuda_ms(lambda i: e.graph.replay(), 10)
        frames = sum(c["frames"] for c in chunks)
        wall = sum(c["wall_s"] for c in chunks)
        ms = (1e3 * wall / frames) if frames else None
        aps = (frames * hop / 24000.0 / wall) if frames else None
        summary[mode]["ms_per_frame"].append(ms)
        summary[mode]["audio_s_per_s"].append(aps)
        if mode == "graph":
            for k in ("capture_s", "graph_nodes", "device_ms_per_replay"):
                if graph_info.get(k) is not None:
                    summary[mode].setdefault(k, []).append(graph_info[k])
        emit("engine", mode=mode, kv=kv_dtype, quant=quant, batch=batch, fused_stages=stages,
             rowlane=uses_rowlane_any(eng), prompt_len=prompt_len,
             flash_prefill=eng.use_flash_prefill,
             codec_launches=codec_launches(eng), cache_slots=eng.cache_len, prefill_s=prefill_s,
             decode_steps=steps, prefill_launches=prefill_launches, kernel_launches=launches,
             launches_per_step=want_step, chunks=chunks, ms_per_frame=ms, audio_s_per_s=aps,
             audio_absmax=float(audio.abs().max()), **graph_info, card=card)
        if captures:
            # executed on the device: the prefill's, the warm-up step's and
            # one step's per replay
            run = Run(launches, {k: want_prefill[k] + steps * want_step[k] for k in counters},
                      state, e)
        elif mode == "graph":
            run = run._replace(state=state)
    emit("engine_turns", kv=kv_dtype, quant=quant, batch=batch, fused_stages=stages,
         rowlane=uses_rowlane_any(eng), prompt_len=prompt_len, turns=TURNS, **summary,
         card=card)
    del eager, engines
    return run


def graph_kernels(graph):
    """The names of the nodes of a CUDA graph captured with keep_graph=True,
    read through libcuda: a kernel node by its function's name, any other
    node by its type."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL is 0
            names.append(f"graph node of type {kind.value}")
            continue
        params = (ctypes.c_byte * 256)()  # CUDA_KERNEL_NODE_PARAMS_v2: the function first
        name = ctypes.c_char_p()
        if (cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params)
                or cu.cuFuncGetName(ctypes.byref(name),
                                    ctypes.c_void_p(ctypes.c_void_p.from_buffer(params).value))):
            raise RuntimeError("reading a kernel node failed")
        names.append(name.value.decode())
    return names


# the kernels' entry functions (by the identifier in their mangled symbol,
# which carries its length) -> the wrapper whose counter counts their launches;
# the row-lane stage call is the stage kernel on the row-lane pack, so
# `cluster_kernel` nodes count under fused_stage_chain (see `merge_stages`)
NODE_KERNELS = (("flash_wgmma_kernel", "flash_attention_prefill"),
                ("flash_f32_kernel", "flash_attention_prefill"),
                ("mma_kernel", "decode_attention"), ("f32_kernel", "decode_attention"),
                ("int4_matmul_kernel", "int4_matmul"),
                ("chain_q_kernel", "fused_block_chain_batched"),
                ("chain_p_kernel", "fused_block_chain"),
                ("head_q_kernel", "fused_head_solver_step"),
                ("cluster_kernel", "fused_stage_chain"))


def graph_launches(graph):
    """{counter name: kernel nodes} of a graph captured with keep_graph=True
    (`graph_kernels`), every counter of `kernel_counters` present, the two
    stage counters merged (`merge_stages`); and the count of other nodes."""
    out = merge_stages(dict.fromkeys(kernel_counters(), 0))
    other = 0
    for name in graph_kernels(graph):
        key = next((k for fn, k in NODE_KERNELS if f"{len(fn)}{fn}" in name), None)
        if key is None:
            other += 1
        else:
            out[key] += 1
    return out, other


def merge_stages(launches):
    """Launch counts by wrapper with the row-lane stage calls added to the
    stage kernel's: one kernel function serves both."""
    out = dict(launches)
    out["fused_stage_chain"] += out.pop("fused_stage_chain_rowlane")
    return out


def codec_graph(eng, state, dev, card):
    """The codec half of one decode step of `eng` at its batch (the acoustic
    decoder on one latent frame a row and the semantic encoder on its
    samples, from `state`'s streaming states: every stage and chain call of
    the step) captured in a CUDA graph: its nodes and its device time per
    replay: the codec's share of the engine's captured step."""
    from vibevoice_tpu_torch.models import tokenizer as tok
    p, cfg = eng.params, eng.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    latent = torch.randn((eng.batch, 1, cfg.acoustic_vae_dim), generator=gen,
                         device=dev).to(torch.bfloat16)

    def codec():
        chunk, _ = tok.decoder_apply_streaming_fused(
            p["acoustic_decoder"], cfg.acoustic_tokenizer, latent, state.acoustic_state,
            fused_packs=p.get("_vocoder_packs"), large_packs=p.get("_vocoder_packs_large"))
        return tok.encoder_apply_streaming_fused(
            p["semantic_encoder"], cfg.semantic_tokenizer, chunk, state.semantic_state,
            fused_packs=p.get("_semantic_packs"), large_packs=p.get("_semantic_packs_large"))[0]

    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):  # the kernels' scratch of the capture stream
        want = codec()
    torch.cuda.current_stream(dev).wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        got = codec()
    names = graph_kernels(graph)
    graph.instantiate()
    ms = cuda_ms(lambda i: graph.replay(), 20)
    agree("codec graph replay", got, want)
    kinds = {}
    for nm in names:
        key = next((k for k in ("cluster_kernel", "chain_p_kernel", "chain_q_kernel")
                    if k in nm), "other")
        kinds[key] = kinds.get(key, 0) + 1
    emit("codec_graph", batch=eng.batch, rowlane=uses_rowlane_any(eng), nodes=len(names),
         nodes_by_kind=kinds, device_ms=ms, card=card)


def uses_rowlane_any(eng) -> bool:
    return any(uses_rowlane(pk, eng.batch) for key in ("_vocoder_packs_large",
                                                        "_semantic_packs_large")
               for pk in (eng.params.get(key) or {}).values())


def attention_operands(state, batch, dev):
    """The decode step's own visibility and lengths, for the kernels line."""
    wp = int(state.write_pos)
    lengths = torch.full((2 * batch,), wp + 1, dtype=torch.int32, device=dev)
    vis = state.visible.clone()
    vis[:, wp] = 1
    return vis, lengths


def stage_frames(cfg):
    """{(pack key, stage index): frames per call} of the sigma-VAE stages at
    streaming decode (one 7.5 Hz frame per call)."""
    ac, se = cfg.acoustic_tokenizer, cfg.semantic_tokenizer
    out, t = {}, 1
    for i in range(len(ac.decoder_depths_resolved())):
        t *= ac.decoder_ratios[i - 1] if i else 1
        out[("_vocoder_packs", i)] = t
    t = cfg.speech_compress_ratio
    for i, stride in enumerate([1] + list(reversed(se.encoder_ratios))):
        t //= stride
        out[("_semantic_packs", i)] = t
    return out


def quant_entries(params, cfg, launches, dev):
    """The kernels-line entries of the three int4 kernels, measured on the
    quantized engine's own weights and packs at its B=1 shapes: per launch,
    averaged over the launches of one decode step (the 28 layers' qkv / o /
    gateup / down GEMVs at M=2; the vocoder's and the re-encode's two packed
    stages; one solver step of the head at N=2).  Each timing loop rotates
    over copies of the weights (the layers', then clones) that exceed L2."""
    from vibevoice_tpu_torch.ops import fused_head as fh
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    layers = params["lm"]["layers"]
    per_shape = []
    for name in ("qkv", "o", "gateup", "down"):
        ws = [lp[name]["w"] if name in ("qkv", "o") else lp[name] for lp in layers]
        size = ws[0]["qint4"].numel()
        ws = ws + [{k: v.clone() for k, v in ws[i % len(ws)].items()}
                   for i in range(max(0, copies_for(size) - len(ws)))]
        x = torch.randn((2, 2 * ws[0]["qint4"].shape[0]), generator=gen,
                        device=dev).to(torch.bfloat16)
        per_shape.append(measure_int4(x, ws))
    stages = chain_results(params, cfg, gen, dev)
    head = params["_diffusion_head_packq"]
    heads = [head] + [{k: v.clone() for k, v in head.items()}
                      for _ in range(copies_for(fh.pack_bytes(head)) - 1)]
    fl = params["diffusion_head"]["final_linear"]
    x, mods, fmod, _ = head_inputs(head, 2, fl.shape[1], gen, dev)
    head_r = measure_head(heads, x, mods, fmod, fl.contiguous())
    del heads

    src = "vibevoice_tpu_torch/csrc/"
    return [
        {"name": "int4_matmul", "route": "cuda", "source": src + "int4_matmul.cu",
         "replaces": "vibevoice_tpu/ops/int4_matmul.py:101",
         "launches": launches["int4_matmul"], **mean_entry(per_shape),
         "per": "launch, mean over the decode step's qkv/o/gateup/down GEMVs at M=2"},
        {"name": "fused_block_chain_batched", "route": "cuda",
         "source": src + "fused_block_chain.cu",
         "replaces": "vibevoice_tpu/ops/fused_blocks.py:290",
         "launches": launches["fused_block_chain_batched"], **mean_entry(stages),
         "per": "launch, mean over the step's four packed stages at B=1"},
        {"name": "fused_head_solver_step", "route": "cuda", "source": src + "fused_head.cu",
         "replaces": "vibevoice_tpu/ops/fused_head.py:130",
         "launches": launches["fused_head_solver_step"], **head_r,
         "per": "launch: one solver step at N=2"},
    ]


def chain_results(params, cfg, gen, dev):
    """`measure_chain` on each packed small-T stage of `params` (the
    vocoder's two, then the re-encode's two) at B=1 and its frames per call,
    each timing loop rotating over clones of the pack that exceed L2."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    out = []
    frames = stage_frames(cfg)
    for key in ("_vocoder_packs", "_semantic_packs"):
        for i, pack in sorted(params[key].items()):
            x, ctx = chain_inputs(pack, 1, frames[(key, i)], gen, dev)
            clones = [pack] + [{k: v.clone() for k, v in pack.items()}
                               for _ in range(copies_for(fb.pack_bytes(pack)) - 1)]
            out.append(measure_chain(clones, x, ctx))
            del clones
    return out


def mean_entry(rs):
    """Per-launch means of several kernel_vs_plain results; the error and
    tolerance are those of the result closest to its tolerance."""
    out = {k: sum(r[k] for r in rs) / len(rs) for k in ("ms", "plain_ms", "bound_ms")}
    worst = max(rs, key=lambda r: r["max_abs_err"] / r["tol"] if r["tol"] else 0.0)
    out["max_abs_err"], out["tol"] = worst["max_abs_err"], worst["tol"]
    out["bound_by"] = rs[0]["bound_by"]
    lib = [r["library_ms"] for r in rs]
    out["library_ms"] = None if None in lib else sum(lib) / len(lib)
    return out


def stage_entries(runs, cfg, dev):
    """The kernels-line entries of the two stage kernels, measured on the
    packs the engines of the main path built, at their shapes: per launch,
    averaged over one decode step's calls.  `runs` maps each kernel to
    (engine, launches in its run)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    ac, se = cfg.acoustic_tokenizer, cfg.semantic_tokenizer
    src = "vibevoice_tpu_torch/csrc/fused_stage.cu"
    replaces = {"fused_stage_chain": "vibevoice_tpu/ops/fused_stage.py:516",
                "fused_stage_chain_rowlane": "vibevoice_tpu/ops/fused_stage.py:404"}
    entries = []
    for name, (eng, launches) in runs.items():
        rs = []
        t = 1
        for i in range(len(ac.decoder_depths_resolved())):
            t *= ac.decoder_ratios[i - 1] if i else 1
            pack = eng.params["_vocoder_packs_large"].get(i)
            if pack is not None and uses_rowlane(pack, eng.batch) == (name != "fused_stage_chain"):
                rs.append(measure_stage(pack, eng.batch, t, gen, dev))
        t = cfg.speech_compress_ratio
        for i, stride in enumerate([1] + list(reversed(se.encoder_ratios))):
            t //= stride
            pack = eng.params["_semantic_packs_large"].get(i)
            if pack is not None and uses_rowlane(pack, eng.batch) == (name != "fused_stage_chain"):
                rs.append(measure_stage(pack, eng.batch, t, gen, dev))
        entries.append({"name": name, "route": "cuda", "source": src, "replaces": replaces[name],
                        "launches": launches, **mean_entry(rs),
                        "per": f"launch, mean over the step's {len(rs)} calls at B={eng.batch}"})
    return entries


def kernel_entry(name, launches, cache, vis, lengths, quant, dev, dec):
    """The kernels-line entry of decode attention at the engine's own cache,
    visibility and lengths (the cache is cloned 3 times so that the timing
    loop reads more than L2 holds)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    q = torch.randn((vis.shape[0], dec.num_attention_heads, dec.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    base = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    caches = [base] + [tuple(None if x is None else x.clone() for x in base) for _ in range(3)]
    r = measure_attention(q, caches, vis, lengths, quant)
    if not r["max_abs_err"] <= KERNEL_TOL:
        raise RuntimeError(f"{name}: {r['max_abs_err']} > {KERNEL_TOL} at the engine's shapes")
    return {"name": name, "route": "cuda",
            "source": "vibevoice_tpu_torch/csrc/decode_attention.cu",
            "replaces": "vibevoice_tpu/ops/decode_attention.py:98",
            "launches": launches, **r, "tol": KERNEL_TOL,
            "shape": {"q": list(q.shape), "cache": list(cache.k.shape),
                      "live": int(lengths[0])}}


class PromptHidden:
    """Keeps the last position's final hidden state of every prompt forward
    (T > 1) the engine runs, which `Engine.prefill` does not return: wraps
    `qwen2.forward` while the context is open."""

    def __enter__(self):
        from vibevoice_tpu_torch.models import qwen2
        self.module, self.forward, self.rows = qwen2, qwen2.forward, []

        def spy(*args, **kw):
            hidden, cache = self.forward(*args, **kw)
            if hidden.shape[1] > 1:
                self.rows.append(hidden[:, -1].float().clone())
            return hidden, cache

        qwen2.forward = spy
        return self

    def __exit__(self, *exc):
        self.module.forward = self.forward


PROMPT_LONG, PROMPT_16K = 4096, 16384
# flash and dense prefills of one bf16 prompt: the last hidden state after 28
# layers, each of whose attention outputs may differ by a bf16 step (2^-8)
# where the two paths round P at different points and sum in another order
# (relative L2 error)
HIDDEN_REL_TOL = 0.05


def prompt_inputs(batch, prompt_len):
    ids = np.random.default_rng(SEED).integers(0, 1000, (batch, prompt_len)).astype(np.int32)
    return ids, np.ones((batch, prompt_len), np.int32), np.zeros((batch, prompt_len), bool)


def timed_prefill(eng, dev):
    """One prefill: its seconds, `torch.cuda.max_memory_allocated()` over it
    (`max_bytes`) and that peak above what was allocated before it (`peak`),
    the prompt's last hidden state and the launches by kernel."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    ids, mask, sim = prompt_inputs(eng.batch, eng.prompt_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with PromptHidden() as hid:
        t0 = time.perf_counter()
        state, _ = eng.prefill(ids, mask, sim, generator=gen)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    max_bytes = torch.cuda.max_memory_allocated()
    del state
    if len(hid.rows) != 1 or not bool(torch.isfinite(hid.rows[0]).all()):
        raise RuntimeError("prefill ran no single finite prompt forward")
    return dict(s=secs, max_bytes=max_bytes, peak=max_bytes - base, hidden=hid.rows[0],
                launches={k: c.launches for k, c in counters.items()})


def fp32_prompt_hidden(params, cfg, dev):
    """The 4096-token prompt's last hidden state from an fp32 copy of the LM
    (flash prefill in fp32, no cache): the yardstick both bf16 prefills are
    held against."""
    from vibevoice_tpu_torch.models import qwen2
    ids, mask, _ = prompt_inputs(1, PROMPT_LONG)
    as32 = lambda t: t.float() if torch.is_tensor(t) and t.is_floating_point() else t
    lm = {"embed": as32(params["lm"]["embed"]), "final_norm_w": as32(params["lm"]["final_norm_w"]),
          "layers": [{k: ({kk: as32(vv) for kk, vv in v.items()} if isinstance(v, dict)
                          else as32(v)) for k, v in lp.items()}
                     for lp in params["lm"]["layers"]]}
    ids, mask = torch.as_tensor(ids, device=dev).long(), torch.as_tensor(mask, device=dev)
    with torch.no_grad():
        hidden, _ = qwen2.forward(lm, cfg.decoder, qwen2.embed_rows(lm, ids),
                                  qwen2.positions_from_mask(mask), None, pad_mask=mask,
                                  use_flash=True)
    return hidden[:, -1].float()


def phase_long_prompt(params, cfg, dev, card):
    """The long-prompt path at 1.5B, bf16, B=1: a 4096-token prompt (flash
    prefill by the engine's auto rule) with the small-T chains on plain
    packs, prefill and 8 + 16 decode steps, every kernel's launches asserted
    (28 flash launches in the prefill, none per step; 4 plain-chain launches
    per step and 4 in the prefill).  Then the same prompt's prefill through
    the dense path beside the flash one, in turns (dense, flash, flash,
    dense): times, peak memory and the last hidden state; and a 16 384-token
    flash prefill with its peak memory.  Returns the main run (`Run`)."""
    from vibevoice_tpu_torch.engine import generate as G
    n_layers = cfg.decoder.num_hidden_layers
    run = run_engine(params, cfg, dev, "model", 8, (16,), card, prompt_len=PROMPT_LONG,
                     max_steps=64, chain=True)
    launches, eng = run.launches, run.eng
    if not (eng.use_flash_prefill and launches["flash_attention_prefill"] == n_layers
            and codec_launches(eng)["fused_block_chain"] == 4):
        raise RuntimeError(f"the long-prompt engine is off its path: {launches}")
    packed = dict(params, _vocoder_packs=eng.params["_vocoder_packs"],
                  _semantic_packs=eng.params["_semantic_packs"])
    engines = {flash: G.Engine(packed, cfg, bench_gen(G), max_steps=64, batch=1,
                               prompt_len=PROMPT_LONG, dtype=torch.bfloat16, device=dev,
                               use_flash_prefill=flash, use_fused_vocoder=True,
                               use_fused_semantic=True) for flash in (True, False)}
    runs = {True: [], False: []}
    for flash in (False, True, True, False):
        runs[flash].append(timed_prefill(engines[flash], dev))
    for flash, rs in runs.items():
        got = [r["launches"]["flash_attention_prefill"] for r in rs]
        if got != [n_layers if flash else 0] * 2:
            raise RuntimeError(f"flash={flash} prefills launched flash prefill {got} times")
    h_flash, h_dense = runs[True][0]["hidden"], runs[False][0]["hidden"]
    rel = float((h_flash - h_dense).norm() / h_dense.norm())
    h32 = fp32_prompt_hidden(params, cfg, dev)
    rel32 = {name: float((h - h32).norm() / h32.norm())
             for name, h in (("flash", h_flash), ("dense", h_dense))}
    emit("prefill_flash_vs_dense", prompt=PROMPT_LONG, batch=1, dtype="bf16",
         flash_s=[r["s"] for r in runs[True]], dense_s=[r["s"] for r in runs[False]],
         flash_peak_bytes=[r["peak"] for r in runs[True]],
         dense_peak_bytes=[r["peak"] for r in runs[False]],
         flash_max_memory_allocated=[r["max_bytes"] for r in runs[True]],
         dense_max_memory_allocated=[r["max_bytes"] for r in runs[False]],
         hidden_rel_err=rel, hidden_max_abs_err=float((h_flash - h_dense).abs().max()),
         hidden_absmax=float(h_dense.abs().max()), tol=HIDDEN_REL_TOL,
         hidden_rel_err_vs_fp32=rel32,
         flash_repeat_equal=bool(torch.equal(h_flash, runs[True][1]["hidden"])), card=card)
    if not rel <= HIDDEN_REL_TOL:
        raise RuntimeError(f"flash and dense prefills disagree: {rel} > {HIDDEN_REL_TOL}")
    # the flash path is no further from fp32 than twice the dense path's own
    # bf16 error
    if not rel32["flash"] <= max(2 * rel32["dense"], 0.01):
        raise RuntimeError(f"flash prefill is off the fp32 prefill: {rel32}")
    del engines, packed
    torch.cuda.empty_cache()
    e16 = G.Engine(params, cfg, bench_gen(G), max_steps=64, batch=1, prompt_len=PROMPT_16K,
                   dtype=torch.bfloat16, device=dev)
    r16 = timed_prefill(e16, dev)
    if not e16.use_flash_prefill or r16["launches"]["flash_attention_prefill"] != n_layers:
        raise RuntimeError(f"the 16K prefill is off the flash path: {r16['launches']}")
    emit("prefill_16k", prompt=PROMPT_16K, batch=1, dtype="bf16", cache_slots=e16.cache_len,
         prefill_s=r16["s"], max_memory_allocated=r16["max_bytes"], peak_bytes=r16["peak"],
         peak_vs_4096_flash=r16["peak"] / runs[True][0]["peak"], launches=r16["launches"],
         card=card)
    del e16
    torch.cuda.empty_cache()
    return run


def long_prompt_entries(eng, launches, cfg, dev):
    """The kernels-line entries of flash prefill (one layer's prompt attention
    at the engine's shape, B=1, T=4096, H=12, KVH=2, D=128, random bf16 q/k/v)
    and of the plain chain (measured on the engine's own four packs at B=1,
    per launch, averaged over the step's four stages)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    dec = cfg.decoder
    flash = measure_flash(*flash_inputs(1, eng.prompt_len, 0, gen, dev, dec.num_attention_heads,
                                        dec.num_key_value_heads, dec.head_dim))
    src = "vibevoice_tpu_torch/csrc/"
    return [
        {"name": "flash_attention_prefill", "route": "cuda", "source": src + "flash_prefill.cu",
         "replaces": "vibevoice_tpu/ops/flash_attention.py:84",
         "launches": launches["flash_attention_prefill"], **flash,
         "per": f"launch: one layer's prompt attention, B=1, T={eng.prompt_len}"},
        {"name": "fused_block_chain", "route": "cuda", "source": src + "fused_block_chain.cu",
         "replaces": "vibevoice_tpu/ops/fused_blocks.py:367",
         "launches": launches["fused_block_chain"],
         **mean_entry(chain_results(eng.params, cfg, gen, dev)),
         "per": "launch, mean over the step's four plain-pack stages at B=1"},
    ]


# ---------------------------------------------------------------------------
# phase 6: the pipeline
# ---------------------------------------------------------------------------

def register_forced_engine(tts, G, script, voices, max_new_tokens):
    """A force_diffusion engine under the key `generate` will ask for (random
    weights almost never pick the diffusion token by themselves), with the
    int4 chain on when the pipeline holds its packs, and the large-T stage
    kernels with the pipeline's `use_fused_stages`."""
    t0 = tts.processor(script, voices).input_ids.shape[1]
    bucket = max(tts.prompt_bucket, -(-t0 // tts.prompt_bucket) * tts.prompt_bucket)
    key = (1, bucket, max_new_tokens)
    if key not in tts._engines:
        gen = G.GenerationConfig(
            speech_start_id=tts.tokenizer.speech_start_id,
            speech_end_id=tts.tokenizer.speech_end_id,
            speech_diffusion_id=tts.tokenizer.speech_diffusion_id,
            eos_id=tts.tokenizer.eos_id, cfg_scale=tts.cfg_scale, ddpm_steps=tts.ddpm_steps,
            algorithm_type=tts.algorithm_type, force_diffusion=True, max_length_times=64.0)
        chain = tts._chain_packs is not None
        tts._engines[key] = G.Engine(tts.params, tts.cfg, gen, max_steps=max_new_tokens,
                                     batch=1, prompt_len=bucket, dtype=tts.dtype,
                                     device=tts.device, use_fused_vocoder=chain,
                                     use_fused_semantic=chain,
                                     use_fused_stages=tts.use_fused_stages)
    return tts._engines[key]


def phase_pipeline(dev, card, quant=None):
    """Three requests through `VibeVoiceTTS.generate` with a streamer; with
    `quant` in the quantized serving configuration (QUANT_MODES, or int4f),
    and then the first again with `use_fused_stages=True`."""
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.engine.streamer import AudioStreamer
    from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
    modes = dict(QUANT_MODES, quantize=quant) if quant else {}
    t0 = time.perf_counter()
    tts = VibeVoiceTTS.from_random(vibevoice_1_5b(), seed=SEED + 2, dtype=torch.bfloat16,
                                   ddpm_steps=5, cfg_scale=1.3,
                                   algorithm_type="sde-dpmsolver++", device=dev, **modes)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    voices = [rng.normal(0, 0.05, 48000).astype(np.float32),
              rng.normal(0, 0.05, 36000).astype(np.float32)]
    scripts = [("Speaker 1: Good morning, and welcome to the show.", voices[:1]),
               ("Speaker 1: Did you hear the news?\nSpeaker 2: I did, it is remarkable.\n"
                "Speaker 1: Tell me more.", voices),
               ("Speaker 1: " + "This is a longer passage read aloud. " * 6, voices[1:])]
    max_new, stop_after, hop = 3840, 24, tts.cfg.speech_compress_ratio
    counters = kernel_counters()
    requests = [(script, vs, False) for script, vs in scripts]
    if quant:
        requests.append((*scripts[0], True))
    for i, (script, vs, stages) in enumerate(requests):
        if stages:
            tts.use_fused_stages = True
            tts._engines.clear()
        eng = register_forced_engine(tts, G, script, vs, max_new)
        want_prefill, want_step = expected_launches(tts.cfg, quant, eng)
        if stages and want_step["fused_stage_chain"] != 8:
            raise RuntimeError(f"pipeline engine has {want_step} stage launches per step")
        if not (eng.use_flash_decode and eng.cache_len >= 4096):
            raise RuntimeError(f"pipeline engine is off the long-cache path: {eng.cache_len}")
        streamer = AudioStreamer(batch_size=1)
        seen = []
        captures = eng.graph is None
        for c in counters.values():
            c.launches = 0
        res, metrics = tts.generate(script, vs, max_new_tokens=max_new, seed=i,
                                    audio_streamer=streamer,
                                    stop_check_fn=lambda: len(seen) >= stop_after,
                                    on_step=seen.append)
        launches = {k: c.launches for k, c in counters.items()}
        chunks = list(streamer.get_stream(0))
        audio = res.audio[0]
        if audio is None or not np.isfinite(audio).all() or np.abs(audio).max() == 0:
            raise RuntimeError(f"request {i}: audio missing, non-finite or all zero")
        if len(chunks) != res.steps or not np.array_equal(np.concatenate(chunks), audio):
            raise RuntimeError(f"request {i}: streamed chunks differ from the buffered audio")
        if len(audio) != res.steps * hop or res.steps < stop_after:
            raise RuntimeError(f"request {i}: {res.steps} steps, {len(audio)} samples")
        # through the wrappers: the prefill, and the warm-up and captured
        # steps where this request captured the engine's step; the graph
        # holds one step's launches and the replays count nowhere
        want = {k: want_prefill[k] + (2 if captures else 0) * want_step[k] for k in counters}
        nodes, _ = graph_launches(eng.graph)
        if launches != want or nodes != merge_stages(want_step):
            raise RuntimeError(f"request {i}: launches {launches}, want {want}; graph nodes "
                               f"{nodes}, want {merge_stages(want_step)}")
        emit("pipeline", quant=quant, fused_stages=stages, request=i, speakers=len(vs),
             prompt_bucket=eng.prompt_len, captured=captures, capture_s=eng.capture_s,
             graph_nodes=nodes,
             cache_slots=eng.cache_len, steps=res.steps, kernel_launches=launches,
             setup_s=setup_s if i == 0 else None, wall_s=metrics["wall_s"],
             audio_sec=metrics["audio_sec"], rtf=metrics["rtf"], card=card)
    del tts
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: a small model on the card against the same model on the CPU
# ---------------------------------------------------------------------------

def _live_audio_path(params, gen):
    """Give a random tiny model an audio path that carries signal and depends
    on the LM: lift the tokenizers' 1e-6 layer scales, and replace the
    diffusion head's zero-initialised adaLN and final layers."""
    def boost(tree):
        if isinstance(tree, dict):
            return {k: (v * 0.5e6 if k in ("gamma", "ffn_gamma") else boost(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [boost(v) for v in tree]
        return tree

    for name in ("acoustic_decoder", "semantic_encoder"):
        params[name] = boost(params[name])
    head = params["diffusion_head"]
    for lp in head["layers"]:
        lp["ada_w"] = torch.randn(lp["ada_w"].shape, generator=gen) * 0.05
    for k in ("final_ada_w", "final_linear"):
        head[k] = torch.randn(head[k].shape, generator=gen) * 0.05
    params["speech_scaling_factor"] = torch.tensor(0.8)
    params["speech_bias_factor"] = torch.tensor(0.1)


def phase_reference(dev, quant=False, stages=False, b=2, flash_chain=False):
    """fp32 on both sides.  With `quant` the model is first put through
    `VibeVoiceTTS(quantize="int4", int4_group_size=32, quantize_tokenizer=
    "int4k", quantize_diffusion="int4k", tokenizer_min_dim=4)` on the CPU, so
    the card runs every int4 kernel (the tiny stacks' unpacked stages take int8
    FFNs) and the CPU their plain versions.  With `stages` the engines run
    `use_fused_stages=True, fused_stage_t_min=7` (the tiny stacks' T >= 7
    stages: folded convs at b=1, the row-lane layout, by default, at b=2).
    With `flash_chain` the model has head_dim 128 (hidden 512, 4 heads) and
    the engines run flash prefill, forced on, and the small-T chains on plain
    fp32 packs."""
    from vibevoice_tpu_torch.configs import tiny_config
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.models import vibevoice as V
    from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
    from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer
    # head_dim 64 (hidden 256), or 128 (hidden 512), as the kernels take it
    cfg = tiny_config(hidden_size=512 if flash_chain else 256, vocab_size=320)
    gen = torch.Generator().manual_seed(SEED)
    params = V.init_model(cfg, generator=gen)
    _live_audio_path(params, gen)
    if quant:
        params = VibeVoiceTTS(params, cfg, ByteFallbackTokenizer(), dtype=torch.float32,
                              device="cpu", int4_group_size=32, tokenizer_min_dim=4,
                              **QUANT_MODES).params
    rng = np.random.default_rng(SEED)
    # a 72-token prompt: the quantized prefill (144 rows) takes the dequantized route
    t, steps = (72 if quant else 40), 24
    ids = rng.integers(0, 250, (b, t)).astype(np.int32)
    ids[:, -1] = 258
    mask = np.ones((b, t), np.int32)
    mask[b - 1, :9] = 0
    sim = np.zeros((b, t), bool)
    noise = rng.normal(size=(steps, b, cfg.acoustic_vae_dim)).astype(np.float32)
    gcfg = G.GenerationConfig(speech_start_id=258, speech_end_id=259, speech_diffusion_id=260,
                             eos_id=256, cfg_scale=1.3, ddpm_steps=3, force_diffusion=True,
                             max_length_times=64.0)
    counters = kernel_counters()
    out = {}
    for where in ("cpu", dev):
        eng = G.Engine(params, cfg, gcfg, max_steps=steps, batch=b, prompt_len=t,
                       inject_latent_noise=True, use_flash_decode=True, device=where,
                       use_fused_vocoder=quant or flash_chain,
                       use_fused_semantic=quant or flash_chain,
                       use_fused_stages=stages, fused_stage_t_min=7,
                       use_flash_prefill=flash_chain)
        for c in counters.values():
            c.launches = 0
        out[str(where)] = (G.generate(eng, ids, mask, sim, latent_noise=noise),
                           {k: c.launches for k, c in counters.items()})
    (ref, cpu_launches), (got, gpu_launches) = out["cpu"], out[str(dev)]
    n_layers = cfg.decoder.num_hidden_layers
    # every step diffuses: 3 + 3 packed stages, 3 solver steps and the
    # stage kernels once per large-T pack each; flash prefill once per layer.
    # The card decodes through the captured step: the prefill's step 0, the
    # warm-up step and the captured one go through the wrappers, and the
    # graph holds one step
    step = {"decode_attention": n_layers,
            "int4_matmul": 4 * n_layers if quant else 0,
            "fused_block_chain_batched": 6 if quant else 0,
            "fused_head_solver_step": 3 if quant else 0,
            "flash_attention_prefill": 0,
            "fused_block_chain": 6 if flash_chain else 0,
            **stage_launches(eng)}
    pre = dict(step, decode_attention=0, flash_attention_prefill=n_layers if flash_chain else 0)
    want = {k: pre[k] + 2 * n for k, n in step.items()}
    if stages and sum(stage_launches(eng).values()) != 4:
        raise RuntimeError(f"tiny engine stage packs: {stage_launches(eng)}")
    nodes, _ = graph_launches(eng.graph)
    if any(cpu_launches.values()) or gpu_launches != want or nodes != merge_stages(step):
        raise RuntimeError(f"launches: cpu {cpu_launches}, gpu {gpu_launches}, want {want}; "
                           f"graph nodes {nodes}, want {merge_stages(step)}")
    if not np.array_equal(got.tokens, ref.tokens):
        raise RuntimeError(f"tokens differ: {got.tokens} vs {ref.tokens}")
    a, w = np.concatenate(got.audio), np.concatenate(ref.audio)
    if not (np.isfinite(a).all() and np.isfinite(w).all()):
        raise RuntimeError("tiny-model audio is not finite")
    err, scale = float(np.abs(a - w).max()), float(np.abs(w).max())
    tol = 1e-3 * scale  # fp32 on both; sums in another order on the card
    emit("reference", model=f"tiny_config(hidden_size={cfg.decoder.hidden_size})", batch=b,
         fused_stages=stages, flash_prefill_and_plain_chain=flash_chain,
         modes=dict(QUANT_MODES, int4_group_size=32) if quant else None, steps=steps,
         kernel_launches=gpu_launches, audio_max_abs_err=err, audio_absmax=scale, tol=tol)
    if not (scale > 0 and err <= tol):
        raise RuntimeError(f"card and CPU disagree: {err} > {tol}")


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU only",
              file=sys.stderr)
        return 2
    from vibevoice_tpu_torch.configs import vibevoice_1_5b
    from vibevoice_tpu_torch.engine.generate import resolve_device
    from vibevoice_tpu_torch.models import vibevoice as V
    from vibevoice_tpu_torch.ops import cuda_build
    from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
    from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = card_line()
    emit("setup", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    # 1. build
    build_s, logs = cuda_build.build_all()
    emit("build", seconds=build_s, sources=sorted(cuda_build.SOURCES.values()))
    # registers and spills of every entry function, as ptxas reports them
    for name, log in logs.items():
        emit("ptxas", source=cuda_build.SOURCES[name], entries=ptxas_report(log))

    # 2. kernel against plain
    phase_kernels(dev)
    phase_int4_kernels(dev)
    phase_stage_kernels(dev)
    phase_flash_kernel(dev)
    phase_plain_chain(dev)

    # 3-4. engine, bf16 then int8 KV
    cfg = vibevoice_1_5b()
    t0 = time.perf_counter()
    params = V.init_model(cfg, dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED))
    params["speech_scaling_factor"] = torch.tensor(1.0, device=dev)
    params["speech_bias_factor"] = torch.tensor(0.0, device=dev)
    torch.cuda.synchronize()
    emit("init", model="vibevoice_1_5b", dtype="bf16", seconds=time.perf_counter() - t0)
    runs, device_launches = {}, {}
    for kv, warm, chunks in (("model", 16, (32, 32)), ("int8", 8, (8,))):
        r = run_engine(params, cfg, dev, kv, warm, chunks, card)
        vis, lengths = attention_operands(r.state, 1, dev)
        runs[kv] = (r.launches["decode_attention"], r.state.cache, vis, lengths)
        device_launches["decode_attention" + ("[int8 KV]" if kv == "int8" else "")] = \
            r.device_launches["decode_attention"]
        del r
    entries = [kernel_entry("decode_attention", *runs["model"], False, dev, cfg.decoder),
               kernel_entry("decode_attention[int8 KV]", *runs["int8"], True, dev,
                            cfg.decoder)]
    del runs
    # the large-T stages at B=2: the row-lane layout turned off (8 stage calls
    # per step), then by default (the JAX engine's rule: 4 stage calls and 4
    # row-lane calls), each in turns eager, graph, graph, eager; each also
    # replays the codec half of a step from a CUDA graph of its own
    stage_runs = {}
    for rowlane in (False, None):
        want = ({"fused_stage_chain": 8, "fused_stage_chain_rowlane": 0} if rowlane is False
                else {"fused_stage_chain": 4, "fused_stage_chain_rowlane": 4})
        r = run_engine(params, cfg, dev, "model", 8, (16,), card, batch=2, stages=True,
                       want_stages=want, rowlane=rowlane)
        codec_graph(r.eng, r.state, dev, card)
        if rowlane is None:
            stage_runs["fused_stage_chain_rowlane"] = (
                r.eng, r.launches["fused_stage_chain_rowlane"])
            device_launches["fused_stage_chain_rowlane"] = \
                r.device_launches["fused_stage_chain_rowlane"]
        del r
    # the stage calls per step that the engine's packs give at B=4 and B=32,
    # by default and with the row-lane layout off (packed, not run)
    from vibevoice_tpu_torch.engine import generate as G
    for b in (4, 32):
        for rowlane in (None, False):
            eng = G.Engine(params, cfg, bench_gen(G), max_steps=16, batch=b, prompt_len=256,
                           dtype=torch.bfloat16, device=dev, use_fused_stages=True,
                           fused_stage_rowlane=rowlane)
            per_step = stage_launches(eng)
            if (per_step["fused_stage_chain_rowlane"] > 0) != (rowlane is None):
                raise RuntimeError(f"B={b}: the row-lane rule gives {per_step}")
            emit("stage_policy", batch=b, rowlane=uses_rowlane_any(eng),
                 launches_per_step=per_step)
            del eng
    # the long-prompt path: flash prefill and the plain-pack chains
    r = phase_long_prompt(params, cfg, dev, card)
    entries += long_prompt_entries(r.eng, r.launches, cfg, dev)
    for k in ("flash_attention_prefill", "fused_block_chain"):
        device_launches[k] = r.device_launches[k]
    del r
    torch.cuda.empty_cache()

    # 5. the quantized engine on the same weights: int4, int4 with the large-T
    # stage kernels (8 calls per step, transition convs folded), then int4f
    for quant, warm, chunks in (("int4", 16, (32, 32)), ("int4f", 8, (8,))):
        t0 = time.perf_counter()
        qparams = VibeVoiceTTS(params, cfg, ByteFallbackTokenizer(), dtype=torch.bfloat16,
                               device=dev, **dict(QUANT_MODES, quantize=quant)).params
        torch.cuda.synchronize()
        emit("quantize", modes=dict(QUANT_MODES, quantize=quant),
             seconds=time.perf_counter() - t0)
        r = run_engine(qparams, cfg, dev, "model", warm, chunks, card, quant)
        if quant == "int4":
            entries += quant_entries(qparams, cfg, r.launches, dev)
            for k in ("int4_matmul", "fused_block_chain_batched", "fused_head_solver_step"):
                device_launches[k] = r.device_launches[k]
            del r
            r = run_engine(
                qparams, cfg, dev, "model", warm, chunks, card, quant, stages=True,
                want_stages={"fused_stage_chain": 8, "fused_stage_chain_rowlane": 0})
            stage_runs["fused_stage_chain"] = (r.eng, r.launches["fused_stage_chain"])
            device_launches["fused_stage_chain"] = r.device_launches["fused_stage_chain"]
            entries += stage_entries(stage_runs, cfg, dev)
            del stage_runs
        del r
        del qparams
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()

    # 6. pipeline, bf16 then quantized
    phase_pipeline(dev, card)
    phase_pipeline(dev, card, quant="int4")

    # 7. reference on a small input: plain, quantized, large-T stage kernels
    phase_reference(dev)
    phase_reference(dev, quant=True)
    phase_reference(dev, stages=True, b=1)
    phase_reference(dev, stages=True, b=2)
    phase_reference(dev, flash_chain=True)

    emit("done", seconds=time.perf_counter() - t_start)
    # beside the wrappers' count of the main path's run (the prefill, the
    # warm-up step and the captured one), the launches that ran on the device
    for e in entries:
        e["device_launches"] = device_launches[e["name"]]
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
