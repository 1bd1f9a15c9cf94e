"""BENCHMARK.json and the files its names lead to."""
import json
import os
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    return harness.benchmark()


def test_portbench_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert all(w in {x["name"] for x in b["workloads"]} for w in m["workloads"])


@pytest.mark.parametrize("workload", [w["name"] for w in harness.benchmark()["workloads"]])
def test_portbench_cell_resolves(workload):
    """Every cell finds its configuration, traffic, driver, limits and
    metric readers by name."""
    cell = harness.resolve(workload)
    assert cell.config_file["name"] == cell.workload["config"]
    assert os.path.exists(os.path.join(ROOT, "portbench", "drivers",
                                       cell.traffic["kind"] + ".py"))
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("name,preset", [("vibevoice-1.5b", "vibevoice_1_5b"),
                                         ("vibevoice-large", "vibevoice_7b")])
def test_portbench_configs_are_the_published_models(name, preset):
    """Each configuration file reads, in the port and in the reference, as
    the port's preset of the published model (`reduced` is empty)."""
    from vibevoice_tpu_torch import configs as port
    from portbench.reference import configs as ref
    path = os.path.join(ROOT, "portbench", "configs", name + ".json")
    assert port.config_from_json(path) == getattr(port, preset)()
    r = ref.config_from_json(path)
    assert r.decoder == ref.Qwen2Config(**vars(getattr(port, preset)().decoder))


def test_portbench_result_line_keys():
    cell = harness.resolve("vv1.5b-podcast-b8")
    out = harness.Outcome(end_to_end={"audio_s_per_s": 1.5, "setup_s": 2.0},
                          per_layer={"step_ms.offline": 3.0}, attempted=8, failed=0,
                          compared={k: 0.0 for k in cell.limits}, memory_peak_bytes=5,
                          busy_s=1.0, window_s=2.0,
                          breakdown={"device_ops": [["a", 1.0]], "idle_gaps": [["b", 1.0]]})
    checks = harness.judge(out.compared, cell.limits)
    line = harness.result_line(cell, out, checks, False, "card", 1)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"} and line["correct"]
    traced = harness.result_line(cell, out, checks, True, "card", 1)
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                            "checks"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert json.loads(json.dumps(traced)) == traced


def test_portbench_judge_fails_missing_and_nan():
    checks = harness.judge({"a": 0.1, "b": float("nan")}, {"a": 0.2, "b": 1.0, "c": 1.0})
    assert [ok for *_, ok in checks] == [True, False, False]
