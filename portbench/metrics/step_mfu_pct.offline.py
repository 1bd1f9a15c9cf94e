"""step_mfu_pct.offline: the whole decode step's share of the chip's peak:
the least time of its work (the larger of its operations over the bf16 peak
and its bytes over HBM's rate, counted from the configuration's shapes by
`portbench/work.py`, at the live slots the window left) over
step_ms.offline."""
from portbench import work


def read(src):
    ms = src["metrics"].get("step_ms.offline")
    if ms is None:
        return None
    st, tr = src["state"], src["traffic"]
    b = st.cur_embeds.shape[0]
    wp = int(st.write_pos)
    visible = (st.visible[:, :wp].sum(dim=1) + 1).tolist()  # the new slot included
    w = work.step_work(src["cfg"], b, visible[:b], visible[b:], tr["ddpm_steps"],
                       st.cache.k.element_size())
    least, kind = work.least_seconds(w["flops"], w["bytes"])
    src["notes"].append(f"step: {w['flops'] / 1e9:.3f} GFLOP, {w['bytes'] / 1e9:.3f} GB, least "
                        f"{least * 1e3:.4f} ms ({kind}-bound) against {ms:.4f} ms; parts "
                        + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in w.items()
                                    if k not in ("flops", "bytes")))
    return 100.0 * least / (ms / 1e3)
