"""decode_attention_roofline: the decode-attention kernel's least time
over its measured time per launch, at the cell's own operands as the window
left them (its cache, each row's live length and visibility, the next
step's slot included).  The least time is the larger of the bytes the call
needs over HBM's rate and its operations over the bf16 peak
(`portbench/work.py`); the time comes from CUDA events around back-to-back
launches over the 28 layers of the engine's cache (each layer's K/V is
larger than the 50 MB L2), with a sleep kernel holding the device while the
host enqueues them."""
import torch

from portbench import work

ROUNDS = 4


def read(src):
    eng, st, dev, cfg = src["engine"], src["state"], src["device"], src["cfg"]
    if dev.type != "cuda" or not eng.use_flash_decode or st.cache.k_scale is not None:
        return None
    from vibevoice_tpu_torch.ops.decode_attention import decode_attention
    dec = cfg.decoder
    wp = int(st.write_pos)
    rows = st.visible.shape[0]
    vis = st.visible.clone()
    vis[:, wp] = 1
    lengths = torch.full((rows,), wp + 1, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((rows, dec.num_attention_heads, dec.head_dim), generator=gen,
                    device=dev).to(st.cache.k.dtype)
    layers = st.cache.k.shape[0]

    def call(i):
        decode_attention(q, st.cache.k, st.cache.v, i % layers, vis, lengths)

    for i in range(layers):
        call(i)
    torch.cuda.synchronize(dev)
    iters = ROUNDS * layers
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000 * iters)
    e0.record()
    for i in range(iters):
        call(i)
    e1.record()
    e1.synchronize()
    t = e0.elapsed_time(e1) / 1e3 / iters
    visible = vis[:, :wp + 1].sum(dim=1).tolist()
    flops, nbytes = work.decode_attention_work(dec.num_attention_heads, dec.head_dim,
                                               dec.num_key_value_heads, visible,
                                               [wp + 1] * rows, st.cache.k.element_size())
    least, kind = work.least_seconds(flops, nbytes)
    src["notes"].append(f"decode_attention: {t * 1e6:.3f} us a launch, least "
                        f"{least * 1e6:.3f} us ({kind}-bound), {sum(visible)} visible slots")
    return 100.0 * least / t
