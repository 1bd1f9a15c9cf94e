"""step_ms.offline: device ms of one decode step, from CUDA events around
`Engine.decode_chunk(state, n)` of back-to-back replays that continue the
cell's own episodes after the window, over n."""
import torch

STEPS = 32


def read(src):
    eng, st, dev = src["engine"], src["state"], src["device"]
    if dev.type != "cuda" or eng.graph is None:
        return None
    n = min(STEPS, eng.max_steps - st.host_step - 1)
    if n < 1:
        return None
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    eng.decode_chunk(st, n)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n
