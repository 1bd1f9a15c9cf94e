#!/usr/bin/env python3
"""Times this checkout's flash prefill, int4_matmul, decode attention,
large-T stage, int4 and plain-pack small-T chain and int4 diffusion-head
kernels beside those of another checkout of the port, in one process on one
NVIDIA GPU, at the shapes of `chip_smoke.py` phase 2.

    python3 scripts/torch_kernel_compare.py OTHER_CHECKOUT [KERNEL ...]

OTHER_CHECKOUT is the root of another checkout (for example the parent
commit, unpacked with `git archive`); its kernels build into its own
`vibevoice_tpu_torch/_build/`.  KERNEL names a subset of flash, int4,
attention, stage, chain, plain and head (all by default); head runs the
solver step at the 1.5B head with N=2 and N=8 and at the 7B head with N=2;
plain runs the plain-pack (bf16) chain at `PLAIN_CASES`.  The cases, inputs, checks, library
yardstick (SDPA; `torch.matmul` on the dequantized bf16 weight) and bound are
`chip_smoke.py`'s own; a stage case times the first of its two chunks, and
a row-lane case also both checkouts' stage kernels on the same rows.  Each
case checks both kernels against this checkout's plain version on the same
inputs, then times them in turns (other, this, this, other).  One JSON line per case, then the card's name and power limit.
"""
import importlib
import importlib.util
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from vibevoice_tpu_torch.ops import cuda_build  # noqa: E402
from vibevoice_tpu_torch.ops import decode_attention as da  # noqa: E402
from vibevoice_tpu_torch.ops import flash_attention as fa  # noqa: E402
from vibevoice_tpu_torch.ops import fused_stage as fs  # noqa: E402
from vibevoice_tpu_torch.ops import int4_matmul as im  # noqa: E402

MODULES = {"flash": "flash_attention", "int4": "int4_matmul",
           "attention": "decode_attention", "stage": "fused_stage", "chain": "fused_blocks",
           "plain": "fused_blocks", "head": "fused_head"}
SOURCES = {"flash": "flash_prefill", "int4": "int4_matmul",
           "attention": "decode_attention", "stage": "fused_stage", "chain": "fused_block_chain",
           "plain": "fused_block_chain", "head": "fused_head"}


def load_other(root: str, modules=None):
    """The other checkout's ops modules ({name: module}; by default those of
    MODULES, by kernel), as a package of another name."""
    name = "other_vibevoice_tpu_torch"
    pkg = os.path.join(os.path.abspath(root), "vibevoice_tpu_torch")
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    if modules is not None:
        return {m: importlib.import_module(f"{name}.ops.{m}") for m in modules}
    return {k: importlib.import_module(f"{name}.ops.{m}") for k, m in MODULES.items()}


def in_turns(other, this, iters):
    """(other's two times, this checkout's two times), taken other, this,
    this, other."""
    a = cs.cuda_ms(other, iters)
    b = cs.cuda_ms(this, iters)
    c = cs.cuda_ms(this, iters)
    d = cs.cuda_ms(other, iters)
    return [a, d], [b, c]


def compare_flash(ofa, dev, card):
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    for b, t, pad, h, kvh in cs.FLASH_CASES:
        q, k, v, mask = cs.flash_inputs(b, t, pad, gen, dev, h, kvh)
        want = fa.flash_attention_prefill_ref(q, k, v, mask)
        errs = {"this": cs.agree_rows("flash_attention_prefill",
                                      fa.flash_attention_prefill(q, k, v, mask), want, mask)[:2]}
        try:  # the other checkout's kernel is reported, not held to this one's check
            errs["other"] = cs.agree_rows("flash_attention_prefill[other]",
                                          ofa.flash_attention_prefill(q, k, v, mask), want,
                                          mask)[:2]
        except RuntimeError as e:
            errs["other"] = str(e)
        del want
        other_ms, this_ms = in_turns(lambda i: ofa.flash_attention_prefill(q, k, v, mask),
                                     lambda i: fa.flash_attention_prefill(q, k, v, mask), 20)
        bms, by = cs.flash_bound(q, k, v, mask)
        print(json.dumps({"kernel": "flash_attention_prefill", "B": b, "T": t, "H": h, "KVH": kvh,
                          "D": q.shape[3], "left_pad": pad,
                          "max_abs_err_and_worst_row_rel": errs, "other_ms": other_ms,
                          "this_ms": this_ms,
                          "library_ms": cs.cuda_ms(cs.flash_library(q, k, v, mask), 20),
                          "bound_ms": bms, "bound_by": by, "card": card}), flush=True)
        del q, k, v, mask
    torch.cuda.empty_cache()


def compare_int4(oim, dev, card):
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    for name, m, gs in cs.INT4_CASES:
        x, ws = cs.int4_inputs(name, m, gs, gen, dev)
        w0 = ws[0]
        want = im.int4_matmul_ref(x, w0["qint4"], w0["scale4"])
        errs = {nm: cs.agree(f"int4_matmul[{nm}]", mod.int4_matmul(x, w0["qint4"], w0["scale4"]),
                             want)[0] for nm, mod in (("other", oim), ("this", im))}
        cnt = len(ws)
        run = lambda mod: (lambda i: mod.int4_matmul(x, ws[i % cnt]["qint4"],
                                                     ws[i % cnt]["scale4"]))
        other_ms, this_ms = in_turns(run(oim), run(im), 2 * cnt)
        dense = [im.dequant_int4(w["qint4"], w["scale4"], x.dtype) for w in ws]
        lib_ms = cs.cuda_ms(lambda i: torch.matmul(x, dense[i % cnt]), 2 * cnt)
        del dense
        bms, by = cs.int4_bound(x, w0)
        k, n = cs.INT4_SHAPES[name]
        print(json.dumps({"kernel": "int4_matmul", "proj": name, "M": m, "K": k, "N": n,
                          "group_size": gs, "max_abs_err": errs, "other_ms": other_ms,
                          "this_ms": this_ms, "library_ms": lib_ms, "bound_ms": bms,
                          "bound_by": by, "card": card}), flush=True)
        del ws
    torch.cuda.empty_cache()


def attention_cases():
    """chip_smoke's decode-attention cases: its S=4096/8192 grid at two live
    lengths, then `ATTN_CASES`; (S, live, int8 KV, H, KVH, layers, copies)."""
    grid = [(s, live, quant, 12, 2, 28, 4) for s in (4096, 8192) for quant in (False, True)
            for live in (1500, s)]
    return grid + list(cs.ATTN_CASES)


def compare_attention(oda, dev, card):
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for s, live, quant, h, kvh, n_layers, copies in attention_cases():
        q, caches, vis, lengths = cs.attention_inputs(s, [live, live], quant, copies, gen, dev,
                                                      n_layers=n_layers, h=h, kvh=kvh)
        k, v, ks, vs = caches[0]
        want = da.decode_attention_ref(q, k, v, 0, vis, lengths, ks, vs)
        errs = {nm: float((mod.decode_attention(q, k, v, 0, vis, lengths, ks, vs).float()
                           - want.float()).abs().max())
                for nm, mod in (("other", oda), ("this", da))}
        if not errs["this"] <= cs.KERNEL_TOL:
            raise RuntimeError(f"decode_attention disagrees with its plain version: {errs}")
        slots = [(c, layer) for c in caches for layer in range(n_layers)]
        run = lambda mod: (lambda i: mod.decode_attention(
            q, *slots[i % len(slots)][0][:2], slots[i % len(slots)][1], vis, lengths,
            *slots[i % len(slots)][0][2:]))
        other_ms, this_ms = in_turns(run(oda), run(da), len(slots))
        bms, by = cs.bound_ms(q, k, lengths, quant)
        print(json.dumps({"kernel": "decode_attention", "S": s, "live": live,
                          "kv": "int8" if quant else "bf16", "H": h, "KVH": kvh,
                          "max_abs_err": errs, "other_ms": other_ms, "this_ms": this_ms,
                          "bound_ms": bms, "bound_by": by, "card": card}), flush=True)
        del caches, k, v, ks, vs, want
    torch.cuda.empty_cache()


def compare_stage(ofs, dev, card):
    """The stage kernels at `chip_smoke.STAGE_CASES`, over pack copies that
    exceed L2, both checkouts checked against this checkout's plain version
    and their outputs compared bit for bit.  A row-lane case also runs this
    checkout's stage kernel on the same rows (the pack without its row-lane
    entry) and the other checkout's: this checkout's outputs against the
    row-lane kernel's, bit for bit, and the four kernels' times in turns
    (row-lane other, this, stage kernel this, other, then back)."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
    for name, b, t, d, conv, head, r in cs.STAGE_CASES:
        pack = cs.random_stage_pack(d, conv, head, r, gen, dev)
        rowlane = cs.uses_rowlane(pack, b)
        plain = fs.fused_stage_chain_rowlane_ref if rowlane else fs.fused_stage_chain_ref
        xs, ctx, states = cs.stage_inputs(pack, b, t, gen, dev)
        want = plain(pack, xs[0], ctx, **states)
        errs, outs = {}, {}
        for nm, mod in (("other", ofs), ("this", fs)):
            outs[nm] = got = mod.fused_stage_chain(pack, xs[0], ctx, **states)
            errs[nm] = max(cs.agree(f"fused_stage_chain[{nm}][{j}]", g, w)[0]
                           for j, (g, w) in enumerate(zip(got, want)))
        same = all(torch.equal(g, o) for g, o in zip(outs["this"], outs["other"]))
        nbytes, flops = fs.stage_work(pack, xs[0])
        copies = [pack] + [cs.clone_pack(pack) for _ in range(min(63, cs.copies_for(nbytes) - 1))]
        n = len(copies)
        run = lambda mod, cp=copies: (
            lambda i: mod.fused_stage_chain(cp[i % n], xs[0], ctx, **states))
        line = {}
        if rowlane:
            rows = [{k: v for k, v in c.items() if k != "rowlane"} for c in copies]
            line["equal_to_stage_kernel"] = all(
                torch.equal(g, w) for g, w in zip(outs["this"], fs.fused_stage_chain(
                    rows[0], xs[0], ctx, **states)))
            # in turns: row-lane other, this; stage kernel this, other; and back
            order = [run(ofs), run(fs), run(fs, rows), run(ofs, rows)]
            ms = [cs.cuda_ms(f, 2 * n) for f in order + order[::-1]]
            other_ms, this_ms = [ms[0], ms[7]], [ms[1], ms[6]]
            line["stage_kernel_ms"], line["other_stage_kernel_ms"] = [ms[2], ms[5]], [ms[3], ms[4]]
        else:
            other_ms, this_ms = in_turns(run(ofs), run(fs), 2 * n)
        bms, by = cs.bound(nbytes, flops)
        print(json.dumps({"kernel": "fused_stage_chain" + ("_rowlane" if rowlane else ""),
                          "stage": name, "B": b, "T": t, "D": d, "conv": conv, "head": head,
                          "rows": r, "max_abs_err": errs, "equal_to_other": same,
                          "other_ms": other_ms, "this_ms": this_ms, **line, "bound_ms": bms,
                          "bound_by": by, "card": card}), flush=True)
        del copies, pack
    torch.cuda.empty_cache()


def compare_chain(ofb, dev, card):
    """The int4 Block1D chain at chip_smoke's chain cases, each over pack
    copies that exceed L2, both kernels checked against this checkout's
    plain version and for two calls bit-equal, and the two checkouts'
    outputs compared bit for bit."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    for d, nblk, t, b in cs.CHAIN_CASES:
        packs = [fb.pack_stage_q(cs.random_stage(d, nblk, gen, dev))
                 for _ in range(cs.copies_for(nblk * d * 4 * d))]
        x, ctx = cs.chain_inputs(packs[0], b, t, gen, dev)
        want = fb.fused_block_chain_batched_ref(packs[0], x, ctx)
        errs, equal, outs = {}, {}, {}
        for nm, mod in (("other", ofb), ("this", fb)):
            outs[nm] = got = mod.fused_block_chain_batched(packs[0], x, ctx)
            again = mod.fused_block_chain_batched(packs[0], x, ctx)
            errs[nm] = max(cs.agree(f"fused_block_chain_batched[{nm}]", g, w)[0]
                           for g, w in zip(got, want))
            equal[nm] = all(torch.equal(g, a) for g, a in zip(got, again))
        same = all(torch.equal(g, o) for g, o in zip(outs["this"], outs["other"]))
        n = len(packs)
        run = lambda mod: (lambda i: mod.fused_block_chain_batched(packs[i % n], x, ctx))
        other_ms, this_ms = in_turns(run(ofb), run(fb), 2 * n)
        bms, by = cs.chain_bound(packs[0], x, ctx)
        print(json.dumps({"kernel": "fused_block_chain_batched", "D": d, "F": 4 * d,
                          "blocks": nblk, "T": t, "B": b, "max_abs_err": errs,
                          "two_calls_equal": equal, "equal_to_other": same, "other_ms": other_ms,
                          "this_ms": this_ms, "bound_ms": bms, "bound_by": by, "card": card}),
              flush=True)
        del packs, want, outs
    torch.cuda.empty_cache()


# the plain chain's cases (D, blocks, T, B): the step's two stage shapes
# (decoder 0 / encoder 6; decoder 1 / encoder 5) at B=1 and B=2, bf16 packs
PLAIN_CASES = ((2048, 8, 1, 1), (2048, 8, 1, 2), (1024, 3, 8, 1), (1024, 3, 8, 2))


def compare_plain(ofb, dev, card):
    """The plain-pack (bf16) chain at PLAIN_CASES, each over pack copies that
    exceed L2, both kernels checked against this checkout's plain version and
    for two calls bit-equal, and the two checkouts' outputs compared bit for
    bit."""
    from vibevoice_tpu_torch.ops import fused_blocks as fb
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 8)
    for d, nblk, t, b in PLAIN_CASES:
        packs = [fb.pack_stage(cs.random_stage(d, nblk, gen, dev), dtype=torch.bfloat16)
                 for _ in range(cs.copies_for(2 * nblk * d * 4 * d * 2))]
        x, ctx = cs.chain_inputs(packs[0], b, t, gen, dev)
        want = fb.fused_block_chain_plain_ref(packs[0], x, ctx)
        errs, equal, outs = {}, {}, {}
        for nm, mod in (("other", ofb), ("this", fb)):
            outs[nm] = got = mod.fused_block_chain_plain(packs[0], x, ctx)
            again = mod.fused_block_chain_plain(packs[0], x, ctx)
            errs[nm] = max(cs.agree(f"fused_block_chain[{nm}]", g, w)[0]
                           for g, w in zip(got, want))
            equal[nm] = all(torch.equal(g, a) for g, a in zip(got, again))
        same = all(torch.equal(g, o) for g, o in zip(outs["this"], outs["other"]))
        n = len(packs)
        run = lambda mod: (lambda i: mod.fused_block_chain_plain(packs[i % n], x, ctx))
        other_ms, this_ms = in_turns(run(ofb), run(fb), 2 * n)
        bms, by = cs.chain_bound(packs[0], x, ctx)
        print(json.dumps({"kernel": "fused_block_chain", "pack": "bf16", "D": d, "F": 4 * d,
                          "blocks": nblk, "T": t, "B": b, "max_abs_err": errs,
                          "two_calls_equal": equal, "equal_to_other": same, "other_ms": other_ms,
                          "this_ms": this_ms, "bound_ms": bms, "bound_by": by,
                          "bound_share": [bms / ms for ms in this_ms], "card": card}), flush=True)
        del packs, want, outs
    torch.cuda.empty_cache()


# (N, H, F) of the head cases: the 1.5B head at B=1 and B=4, the 7B head at B=1
HEAD_CASES = ((2, 1536, 4608), (8, 1536, 4608), (2, 3584, 10752))


def compare_head(ofh, dev, card):
    """The int4 head solver step at HEAD_CASES on chip_smoke's inputs (4
    layers, latent 64, bf16), over pack copies that exceed L2, both kernels
    checked against this checkout's plain version and for two calls
    bit-equal."""
    from vibevoice_tpu_torch.ops import fused_head as fh
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    for n, h, f in HEAD_CASES:
        packs = [fh.pack_head_solver_q(cs.random_head(h, f, gen, dev))
                 for _ in range(cs.copies_for(6 * h * f))]
        x, mods, fmod, fl = cs.head_inputs(packs[0], n, 64, gen, dev)
        want = fh.fused_head_solver_step_ref(packs[0], x, mods, fmod, fl, 1e-5)
        errs, equal = {}, {}
        for nm, mod in (("other", ofh), ("this", fh)):
            got = mod.fused_head_solver_step(packs[0], x, mods, fmod, fl, 1e-5)
            errs[nm] = cs.agree(f"fused_head_solver_step[{nm}]", got, want)[0]
            equal[nm] = torch.equal(got, mod.fused_head_solver_step(packs[0], x, mods, fmod, fl,
                                                                    1e-5))
        k = len(packs)
        run = lambda mod: (lambda i: mod.fused_head_solver_step(packs[i % k], x, mods, fmod, fl,
                                                                1e-5))
        other_ms, this_ms = in_turns(run(ofh), run(fh), 2 * k)
        bms, by = cs.head_bound(packs[0], x, mods, fmod, fl)
        print(json.dumps({"kernel": "fused_head_solver_step", "N": n, "H": h, "F": f, "layers": 4,
                          "max_abs_err": errs, "two_calls_equal": equal, "other_ms": other_ms,
                          "this_ms": this_ms, "bound_ms": bms, "bound_by": by, "card": card}),
              flush=True)
        del packs, want
    torch.cuda.empty_cache()


def main() -> int:
    if len(sys.argv) < 2 or not set(sys.argv[2:]) <= set(MODULES):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_compare: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    kernels = sys.argv[2:] or list(MODULES)
    other = load_other(sys.argv[1])
    names = list(dict.fromkeys(SOURCES[k] for k in kernels))
    cuda_build.build_all(names)
    other["flash"].cuda_build.build_all(names)
    dev = torch.device("cuda")
    card = cs.card_line()
    run = {"flash": lambda: compare_flash(other["flash"], dev, card),
           "int4": lambda: compare_int4(other["int4"], dev, card),
           "attention": lambda: compare_attention(other["attention"], dev, card),
           "stage": lambda: compare_stage(other["stage"], dev, card),
           "chain": lambda: compare_chain(other["chain"], dev, card),
           "plain": lambda: compare_plain(other["plain"], dev, card),
           "head": lambda: compare_head(other["head"], dev, card)}
    for k in kernels:
        run[k]()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
