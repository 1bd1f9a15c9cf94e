"""The port on an NVIDIA GPU: the hand-written kernels against their plain
PyTorch versions, and a small engine on the card against the same engine on
the CPU.  Each test skips on a host without a card.  This file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from vibevoice_tpu_torch.configs import tiny_config
from vibevoice_tpu_torch.engine import generate as G
from vibevoice_tpu_torch.models import vibevoice as V
from vibevoice_tpu_torch.models.qwen2 import _quantize_slots
from vibevoice_tpu_torch.ops import decode_attention as da

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return G.resolve_device("cuda")


def _cache(n_layers, b, s, f, quant, gen, dev):
    k = torch.randn((n_layers, b, s, f), generator=gen, device=dev)
    v = torch.randn((n_layers, b, s, f), generator=gen, device=dev)
    if not quant:
        return k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    kq, ks = _quantize_slots(k.view(n_layers * b, s, f))
    vq, vs = _quantize_slots(v.view(n_layers * b, s, f))
    wide = lambda x: x.view(n_layers, b, 1, s).expand(-1, -1, 8, -1).contiguous()
    return kq.view(k.shape), vq.view(v.shape), wide(ks), wide(vs)


@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_kernel_matches_plain(cuda_device, quant):
    """1.5B shapes: H=12, KVH=2, D=128, L=28, S=4096; layers 0 and 27; one
    partial and one full row; holes like a negative-stream reset leaves."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(0)
    s = 4096
    q = torch.randn((2, 12, 128), generator=gen, device=dev).to(torch.bfloat16)
    k, v, ks, vs = _cache(28, 2, s, 256, quant, gen, dev)
    lengths = torch.tensor([1500, s], dtype=torch.int32, device=dev)
    vis = (torch.arange(s, device=dev)[None] < lengths[:, None]).to(torch.int32)
    vis[1, 1:40] = 0
    vis[1, 999] = 0
    before = da.decode_attention.launches
    for layer in (0, 27):
        got = da.decode_attention(q, k, v, layer, vis, lengths, ks, vs)
        torch.cuda.synchronize()
        want = da.decode_attention_ref(q, k, v, layer, vis, lengths, ks, vs)
        # both round to bf16 (|out| < 0.5: one step ~2e-3) after fp32 sums
        # taken in another order
        torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=0)
    assert da.decode_attention.launches == before + 2


def test_engine_on_card_matches_cpu(cuda_device):
    """A small fp32 engine on the long-cache path (head_dim 64, the kernel
    on the card, the plain version on the CPU): equal tokens, audio within
    1e-3 of its scale."""
    cfg = tiny_config(hidden_size=256, vocab_size=320)
    gen = torch.Generator().manual_seed(0)
    params = V.init_model(cfg, generator=gen)
    head = params["diffusion_head"]
    for lp in head["layers"]:
        lp["ada_w"] = torch.randn(lp["ada_w"].shape, generator=gen) * 0.05
    for name in ("final_ada_w", "final_linear"):
        head[name] = torch.randn(head[name].shape, generator=gen) * 0.05
    params["speech_scaling_factor"] = torch.tensor(0.8)
    params["speech_bias_factor"] = torch.tensor(0.1)
    rng = np.random.default_rng(0)
    b, t, steps = 2, 40, 12
    ids = rng.integers(0, 250, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[1, :9] = 0
    sim = np.zeros((b, t), bool)
    noise = rng.normal(size=(steps, b, cfg.acoustic_vae_dim)).astype(np.float32)
    gcfg = G.GenerationConfig(speech_start_id=258, speech_end_id=259, speech_diffusion_id=260,
                              eos_id=256, ddpm_steps=3, force_diffusion=True,
                              max_length_times=64.0)
    runs = {}
    for name, where in (("cpu", "cpu"), ("card", cuda_device)):
        eng = G.Engine(params, cfg, gcfg, max_steps=steps, batch=b, prompt_len=t,
                       inject_latent_noise=True, use_flash_decode=True, device=where)
        before = da.decode_attention.launches
        runs[name] = (G.generate(eng, ids, mask, sim, latent_noise=noise),
                      da.decode_attention.launches - before)
    (ref, cpu_launches), (got, card_launches) = runs["cpu"], runs["card"]
    assert cpu_launches == 0
    assert card_launches == cfg.decoder.num_hidden_layers * (steps - 1)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    a, w = np.concatenate(got.audio), np.concatenate(ref.audio)
    assert np.isfinite(a).all() and np.abs(w).max() > 0
    np.testing.assert_allclose(a, w, atol=1e-3 * np.abs(w).max(), rtol=0)
