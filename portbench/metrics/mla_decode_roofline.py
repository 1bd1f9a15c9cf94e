"""mla_decode_roofline: the latent-attention decode kernel's least time over
its measured time per launch, at the cell's own operands as the window left
them (its latent cache, each row's live length and visibility, the next
step's slot included).  The least time is the larger of the bytes the call
needs over HBM's rate and its operations over the bf16 peak
(`portbench/work_dsv2.py`); the time comes from CUDA events around
back-to-back launches over the layers of the engine's cache (each layer's
visible latents are larger than the 50 MB L2), with a sleep kernel holding
the device while the host enqueues them.  None where the program has no such
kernel or cache."""
import torch

from portbench import work, work_dsv2

ROUNDS = 4


def read(src):
    eng, st, dev, cfg = src["engine"], src["state"], src["device"], src["cfg"]
    if dev.type != "cuda" or not eng.use_flash_decode or not hasattr(st.cache, "latent"):
        return None
    try:
        from vibevoice_tpu_torch.ops.mla_decode_attention import mla_decode_attention
    except ImportError:
        return None
    dec = cfg.decoder
    cache = st.cache.latent
    wp = int(st.write_pos)
    rows = st.visible.shape[0]
    vis = st.visible.clone()
    vis[:, wp] = 1
    lengths = torch.full((rows,), wp + 1, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    width = cache.shape[-1]
    q = torch.randn((rows, dec.num_attention_heads, width), generator=gen,
                    device=dev).to(cache.dtype)
    layers = cache.shape[0]
    scale = (dec.qk_nope_head_dim + dec.qk_rope_head_dim) ** -0.5

    def call(i):
        mla_decode_attention(q, cache, i % layers, vis, lengths, scale)

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
    flops, nbytes = work_dsv2.mla_decode_work(dec.num_attention_heads, width, dec.kv_lora_rank,
                                              visible, [wp + 1] * rows, cache.element_size())
    least, kind = work.least_seconds(flops, nbytes)
    src["notes"].append(f"mla_decode_attention: {t * 1e6:.3f} us a launch, least "
                        f"{least * 1e6:.3f} us ({kind}-bound), {sum(visible)} visible slots")
    return 100.0 * least / t
