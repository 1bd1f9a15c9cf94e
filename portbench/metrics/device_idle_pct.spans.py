"""device_idle_pct.spans: 100 x (1 - busy / wall) over the continuation of
`portbench/program_trace.py`, busy the union of the program's own
"engine.chunk" and "engine.prefill" device spans, on the tracer's shared
clock (CUDA events put on the host clock by its anchor)."""
from portbench import program_trace


def read(src):
    return program_trace.idle_pct(src)
