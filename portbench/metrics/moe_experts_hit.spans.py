"""moe_experts_hit.spans: the distinct experts an expert layer reads in a
decode step, on average: the program's counter "moe.experts_hit" (a device
tally of each expert layer's distinct experts over its 2B rows, read a chunk
later) over "moe.layer_steps", over the continuation of
`portbench/program_trace.py`.  None where the program keeps no such
counter."""
from portbench import program_trace


def read(src):
    t = program_trace.traced(src)
    if t is None:
        return None
    c = t["tracer"].counters
    steps = c.get("moe.layer_steps", 0)
    if not steps:
        return None
    src["notes"].append(f"moe: {c.get('moe.experts_hit', 0)} experts hit over {steps} "
                        f"expert-layer steps")
    return c.get("moe.experts_hit", 0) / steps
