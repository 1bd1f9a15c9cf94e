"""device_idle_pct.offline: 100 x (1 - busy / window), busy being the spans
of the CUDA events recorded on the stream around each prefill and each
`decode_chunk` of the window."""


def read(src):
    busy, window = src.get("busy_s"), src.get("window_s")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)
