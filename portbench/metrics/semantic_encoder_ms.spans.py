"""semantic_encoder_ms.spans: mean device ms a decode step of the program's own span
"semantic_encoder", over the replays of the captured step that the program's tracer
sampled in a continuation of the cell's episodes (`portbench/program_trace.py`)."""
from portbench import program_trace


def read(src):
    return program_trace.part_ms(src, "semantic_encoder")
