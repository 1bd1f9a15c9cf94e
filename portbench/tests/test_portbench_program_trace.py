"""The readers of the program's own spans (`portbench/program_trace.py`):
each returns nothing, and raises nothing, where the program has no tracer (an
older checkout) or the device is not a card, and the helper runs once per
sources dict, whatever the number of readers."""
import types

import pytest

from portbench import harness, program_trace

SPANS = ["lm_ms.spans", "head_ms.spans", "acoustic_decoder_ms.spans",
         "semantic_encoder_ms.spans", "step_rest_ms.spans", "device_idle_pct.spans"]


def _src(engine, kind):
    return {"engine": engine, "state": None, "device": types.SimpleNamespace(type=kind),
            "notes": [], "metrics": {}}


@pytest.mark.parametrize("case", ["no tracer", "cpu"])
def test_portbench_span_readers_find_nothing_without_a_traced_card(case):
    engine = types.SimpleNamespace() if case == "no tracer" else \
        types.SimpleNamespace(set_tracer=lambda tr: pytest.fail("traced off the card"))
    src = _src(engine, "cuda" if case == "no tracer" else "cpu")
    assert [harness.reader(m)(src) for m in SPANS] == [None] * len(SPANS)
    assert src[program_trace.KEY] is None and src["notes"] == []


def test_portbench_span_readers_share_one_trace(monkeypatch):
    runs = []

    def run(src):
        runs.append(1)
        return {"tracer": types.SimpleNamespace(sampled_ns={"lm": 4e6, "rest": 2e6}),
                "samples": 2, "idle_ns": 5, "wall_ns": 1000}
    monkeypatch.setattr(program_trace, "_run", run)
    src = _src(None, "cuda")
    assert harness.reader("lm_ms.spans")(src) == 2.0
    assert harness.reader("step_rest_ms.spans")(src) == 1.0
    assert harness.reader("device_idle_pct.spans")(src) == 0.5
    assert runs == [1]
