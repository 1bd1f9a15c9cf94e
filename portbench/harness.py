"""The benchmark's frame: finds a cell's files by name, checks the card,
runs the cell's driver, judges the compared numbers against their limits and
prints the result line.

Everything that belongs to one cell lives in files found by name:
  BENCHMARK.json                      the cell, its metrics and bounds
  portbench/configs/<config>.json     the model (`file` of the configuration)
  portbench/traffic/<traffic>.json    the traffic parameters; its `kind`
                                      names the driver
  portbench/drivers/<kind>.py         the driver: set-up, window, check
  portbench/limits/<workload>.json    each compared number's limit
  portbench/metrics/<metric>.py       one per-layer metric's reader
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
from typing import Any, Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "portbench")
# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "vibevoice_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with everything found by its names."""
    workload: dict
    config: dict          # the configurations entry
    config_file: dict     # its file's content
    traffic: dict         # traffic/<traffic>.json
    limits: dict          # limits/<workload>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether `cell` reports `metric`: listed in its `workloads`, or, without
    that key, an end-to-end metric or one that moves a metric the cell reports."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def resolve(name: str, root: str = ROOT) -> Cell:
    b = benchmark(root)
    w = next((x for x in b["workloads"] if x["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    c = next(x for x in b["configs"] if x["name"] == w["config"])
    e2e = [m for m in b["end_to_end"] if reports(m, name, ())]
    names = {m["name"] for m in e2e}
    layer = [m for m in b["per_layer"] if reports(m, name, names)]
    return Cell(w, c, load_json(os.path.join(root, c["file"])),
                load_json(os.path.join(root, "portbench", "traffic", w["traffic"] + ".json")),
                load_json(os.path.join(root, "portbench", "limits", name + ".json")), e2e, layer)


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """`read` of portbench/metrics/<metric>.py."""
    path = os.path.join(BENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell, the run's arguments and the hooks that
    tests use to break the timed path."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    hooks: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def read_layers(self, sources: dict) -> Dict[str, float]:
        """Each per-layer metric of the cell read from `sources`, in
        BENCHMARK.json's order (a reader sees the values read before it under
        sources["metrics"]); a reader that finds nothing is left out."""
        out: Dict[str, float] = {}
        sources = dict(sources, metrics=out)
        for m in self.cell.per_layer:
            v = reader(m["name"])(sources)
            if v is not None:
                out[m["name"]] = v
        return out


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""
    end_to_end: Dict[str, float]
    per_layer: Dict[str, float]
    attempted: int
    failed: int
    compared: Dict[str, float]        # each compared number, by its limit's name
    memory_peak_bytes: int
    fp8_reference: Dict[str, float] = dataclasses.field(default_factory=dict)
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    notes: List[str] = dataclasses.field(default_factory=list)


def judge(compared: Dict[str, float], limits: Dict[str, float]):
    """[(name, value, limit, ok)] for every limit; a number missing or not
    finite fails."""
    out = []
    for name, limit in limits.items():
        v = compared.get(name, math.inf)
        ok = v == v and v <= limit
        out.append((name, v, limit, ok))
    return out


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def result_line(cell: Cell, out: Outcome, checks, trace: bool, device_kind: str,
                chips: int) -> dict:
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    values = out.per_layer if trace else out.end_to_end
    wanted = [m["name"] for m in (cell.per_layer if trace else cell.end_to_end)]
    device = {"platform": "gpu", "kind": device_kind, "count": chips,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    if trace:
        device.update(busy_s=out.busy_s, window_s=out.window_s)
    line = {"correct": all(ok for *_, ok in checks) and out.failed == 0,
            "attempted": out.attempted, "failed": out.failed,
            "metrics": {k: {"value": values[k], "unit": units[k]} for k in wanted if k in values},
            "device": device}
    if trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim, _ in checks}
    return line


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(run: Run) -> Outcome:
    kind = run.cell.traffic["kind"]
    return importlib.import_module(f"portbench.drivers.{kind}").run(run)


def main(argv, t0: float) -> int:
    args = parse(argv)
    cell = resolve(args.workload)
    import torch
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    run = Run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
              hooks={"t0": t0})
    out = execute(run)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    checks = judge(out.compared, cell.limits)
    line = result_line(cell, out, checks, run.trace, torch.cuda.get_device_name(0), chips)
    for note in out.notes:
        print(note, file=sys.stderr)
    for n, v, lim, ok in checks:
        print(f"check {n} = {v!r} (limit {lim!r}): {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


__all__ = ["ROOT", "FORBIDDEN", "Cell", "Run", "Outcome", "resolve", "reader", "reports",
           "judge", "forbidden_modules", "result_line", "execute", "main"]
