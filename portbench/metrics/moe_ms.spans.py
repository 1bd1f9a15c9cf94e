"""moe_ms.spans: mean device ms a decode step of the program's own sub-part
"lm.moe" (each expert layer's router, routed and shared experts, summed over
the layers), over the replays of the captured step that the program's tracer
sampled in a continuation of the cell's episodes
(`portbench/program_trace.py`).  None where the program records no such
sub-part."""
from portbench import program_trace

PART = "lm.moe"


def read(src):
    t = program_trace.traced(src)
    sub = getattr(t["tracer"], "sub_sampled_ns", {}) if t is not None else {}
    if PART not in sub:
        return None
    return sub[PART] / t["samples"] / 1e6
