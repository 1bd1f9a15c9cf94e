"""The latent-attention decode kernel (`ops.mla_decode_attention`,
`csrc/mla_decode_attention.cu`) on an NVIDIA GPU against its plain PyTorch
version, at the DeepSeek-V2-Lite cell's shapes (16 heads over 576-wide latent
slots, 27 layers, 8 cache rows of 53 248 slots).  Each test skips on a host
without a card: a CUDA kernel has no CPU mode.  This file imports neither JAX
nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mla_decode.py
"""
import pytest
import torch

from vibevoice_tpu_torch.ops import mla_decode_attention as mla

pytestmark = pytest.mark.cuda

SLOTS = 53248
SCALE = 192 ** -0.5 * (0.1 * 0.707 * 3.6888794541139363 + 1) ** 2  # DeepSeek-V2-Lite's


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _operands(dev, lengths, layers=2, seed=0):
    """q [B, 16, 576], a cache [layers, B, S, 576] and the visibility of the
    cell's rows: the first half of the rows see their whole prefix but a few
    holes (left pads), the second half (CFG-negative streams) slot 0 and a
    run of decoded slots after the prompt."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(lengths)
    q = (0.3 * torch.randn((b, 16, 576), generator=gen, device=dev)).to(torch.bfloat16)
    cache = torch.randn((layers, b, SLOTS, 576), generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    slots = torch.arange(SLOTS, device=dev)
    vis = (slots[None] < lengths[:, None]).to(torch.int32)
    half = b // 2
    vis[:half, 3:40] = 0
    for r in range(half, b):
        vis[r] = 0
        vis[r, 0] = 1
        lo = min(45056, int(lengths[r]) - 1)
        vis[r, lo:int(lengths[r])] = 1
    return q, cache, vis.contiguous(), lengths


def _close(got, want):
    """bf16 output after fp32 sums in another order and P rounded to bf16:
    within two bf16 steps of the largest output."""
    err = (got.float() - want.float()).abs().max().item()
    return err <= 2 ** -6 * want.float().abs().max().item(), err


@pytest.mark.parametrize("lengths", [
    [49057] * 4 + [49057] * 4,                     # the cell four thousand steps in
    [1, 33, 2048, SLOTS, 1, 64, 4097, SLOTS],      # one slot up to the whole cache
])
def test_mla_kernel_matches_plain(cuda_device, lengths):
    q, cache, vis, lengths = _operands(cuda_device, lengths)
    for layer in range(cache.shape[0]):
        got = mla.mla_decode_attention(q, cache, layer, vis, lengths, SCALE)
        want = mla.mla_decode_attention_ref(q, cache, layer, vis, lengths, SCALE)
        ok, err = _close(got, want)
        assert ok, f"layer {layer}: max abs error {err}"


def test_mla_kernel_row_without_slots_is_zero(cuda_device):
    q, cache, vis, lengths = _operands(cuda_device, [4096, 4096], layers=1)
    vis[1] = 0
    got = mla.mla_decode_attention(q, cache, 0, vis, lengths, SCALE)
    assert torch.count_nonzero(got[1]) == 0 and torch.isfinite(got).all()


def test_mla_kernel_two_calls_equal_bits(cuda_device):
    q, cache, vis, lengths = _operands(cuda_device, [49057] * 8, layers=1, seed=1)
    a = mla.mla_decode_attention(q, cache, 0, vis, lengths, SCALE)
    b = mla.mla_decode_attention(q, cache, 0, vis, lengths, SCALE)
    assert torch.equal(a, b)


def test_mla_kernel_in_a_cuda_graph(cuda_device):
    """Captured and replayed, as in the engine's step: the replay's output
    equals an eager call's bit for bit, and the workspace's counters come
    back to 0 (a second replay agrees too)."""
    q, cache, vis, lengths = _operands(cuda_device, [20000] * 4, layers=1, seed=2)
    want = mla.mla_decode_attention(q, cache, 0, vis, lengths, SCALE)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        mla.mla_decode_attention(q, cache, 0, vis, lengths, SCALE)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = mla.mla_decode_attention(q, cache, 0, vis, lengths, SCALE)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def test_mla_kernel_refuses_what_it_cannot_read(cuda_device):
    q, cache, vis, lengths = _operands(cuda_device, [100, 100], layers=1)
    shifted = torch.empty(q.numel() + 8, dtype=torch.bfloat16, device=cuda_device)
    q_off = shifted[1:1 + q.numel()].view(q.shape)  # 2 bytes into a 16-byte unit
    q_off.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        mla.mla_decode_attention(q_off, cache, 0, vis, lengths, SCALE)
    with pytest.raises(ValueError):  # 8 heads, not 16
        mla.mla_decode_attention(q[:, :8].contiguous(), cache, 0, vis, lengths, SCALE)
    with pytest.raises(ValueError):  # a 512-wide cache
        mla.mla_decode_attention(q, cache[..., :512].contiguous(), 0, vis, lengths, SCALE)
    with pytest.raises(TypeError):  # an fp32 query
        mla.mla_decode_attention(q.float(), cache, 0, vis, lengths, SCALE)
    with pytest.raises(ValueError):  # a layer past the cache
        mla.mla_decode_attention(q, cache, 1, vis, lengths, SCALE)
    with pytest.raises(TypeError):  # int64 lengths
        mla.mla_decode_attention(q, cache, 0, vis, lengths.long(), SCALE)
