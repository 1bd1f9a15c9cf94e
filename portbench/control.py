"""Readings for the limits of a cell's compared numbers, over several seeds
in one process.

    python portbench/control.py --workload <cell> --mode program|int8 \
        --seeds 1 2 3 --seconds 3 [--fp8-seeds 4]

`program` runs the cell as the benchmark does and reads its compared numbers
(the lower readings); on the first `--fp8-seeds` seeds (default: all) it
reads besides them the reference with its weights in float8 e4m3
(`check.fp8_weights`), put in the program's place at the same inputs and
from the same state (the upper readings).  `int8` runs the program's own
int8 path instead (`utils.quantize.quantize_model(mode="int8",
tokenizer_mode="int8")`: the LM, the logits head, the diffusion head and the
sigma-VAE stacks from 512 channels in int8), the control that the limits
are held against where it separates.  One JSON line per seed with the
compared numbers, the float8 reference's, and the run's end-to-end metrics.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def int8_params(params, pcfg):
    from vibevoice_tpu_torch.utils import quantize as Q
    return Q.quantize_model(params, pcfg.decoder.tie_word_embeddings, mode="int8",
                            tokenizer_mode="int8")


MODES = {"program": None, "int8": int8_params}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=sorted(MODES), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fp8-seeds", type=int, default=None,
                    help="read the float8 reference on the first N seeds only (default: all)")
    args = ap.parse_args(argv)
    import torch
    from portbench.harness import Run, execute, forbidden_modules, resolve
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = resolve(args.workload)
    n_fp8 = len(args.seeds) if args.fp8_seeds is None else args.fp8_seeds
    for i, seed in enumerate(args.seeds):
        hooks = {"t0": time.perf_counter(),
                 "fp8_reference": args.mode == "program" and i < n_fp8}
        if MODES[args.mode] is not None:
            hooks["params"] = MODES[args.mode]
        out = execute(Run(cell, seed, args.seconds, False, torch.device("cuda", 0), hooks))
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "compared": out.compared, "fp8_reference": out.fp8_reference,
                          "end_to_end": out.end_to_end,
                          "failed": out.failed, "notes": out.notes}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        print(f"control: loaded {bad}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from portbench.run import cache_env
    cache_env()
    sys.exit(main())
