#!/usr/bin/env python3
"""Times this checkout's flash prefill and int4_matmul kernels beside those of
another checkout of the port, in one process on one NVIDIA GPU, at the shapes
of `chip_smoke.py` phase 2.

    python3 scripts/torch_kernel_compare.py OTHER_CHECKOUT

OTHER_CHECKOUT is the root of another checkout (for example the parent
commit, unpacked with `git archive`); its kernels build into its own
`vibevoice_tpu_torch/_build/`.  The cases, inputs, checks, library yardstick
(SDPA; `torch.matmul` on the dequantized bf16 weight) and bound are
`chip_smoke.py`'s own.  Each case checks both kernels against this checkout's
plain version on the same inputs, then times them in turns (other, this,
this, other).  One JSON line per case, then the card's name and power limit.
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
from vibevoice_tpu_torch.ops import flash_attention as fa  # noqa: E402
from vibevoice_tpu_torch.ops import int4_matmul as im  # noqa: E402


def load_other(root: str):
    """The other checkout's `ops.flash_attention` and `ops.int4_matmul`, as a
    package of another name."""
    name = "other_vibevoice_tpu_torch"
    pkg = os.path.join(os.path.abspath(root), "vibevoice_tpu_torch")
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(name + ".ops.flash_attention"),
            importlib.import_module(name + ".ops.int4_matmul"))


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


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_kernel_compare: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    ofa, oim = load_other(sys.argv[1])
    cuda_build.build_all(["flash_prefill", "int4_matmul"])
    ofa.cuda_build.build_all(["flash_prefill", "int4_matmul"])
    dev = torch.device("cuda")
    card = cs.card_line()
    compare_flash(ofa, dev, card)
    compare_int4(oim, dev, card)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
