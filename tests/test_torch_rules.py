"""Rules of the PyTorch port: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless the caller asks for the CPU."""
import subprocess
import sys
import textwrap

import pytest
import torch

from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.engine import generate as TG
from vibevoice_tpu_torch.pipeline import VibeVoiceTTS


def test_port_imports_neither_jax_nor_the_jax_package():
    # a subprocess: this test process has JAX loaded already (tests/conftest.py)
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import vibevoice_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "vibevoice_tpu" or m.startswith("vibevoice_tpu."))
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every module of the port was imported


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def kw_engine(tts):
    chain = tts._chain_packs is not None
    return dict(use_fused_vocoder=chain, use_fused_semantic=chain,
                use_fused_stages=tts.use_fused_stages)


def _gen():
    return TG.GenerationConfig(speech_start_id=258, speech_end_id=259,
                               speech_diffusion_id=260, eos_id=256)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    cfg = TC.tiny_config(vocab_size=320)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.Engine({}, cfg, _gen(), max_steps=4, batch=1, prompt_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VibeVoiceTTS.from_random(cfg)


def test_entry_points_pin_fp32_matmuls_to_full_precision():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    VibeVoiceTTS.from_random(TC.tiny_config(vocab_size=320), dtype=torch.float32,
                             device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("kw", [dict(quantize="int8"), dict(quantize_tokenizer="int4k"),
                                dict(quantize_diffusion="int4k"), dict()])
def test_pipeline_modes_outside_the_slice_raise(kw):
    """The large-T fused stages (ROADMAP B4/B7) compose with every quantized
    mode, and so does flash prefill (B5), which no longer raises: an engine
    built with `use_flash_prefill=True` over each mode's params runs a
    left-padded prefill to the dense prefill's first token and next embeds."""
    tts = VibeVoiceTTS.from_random(TC.tiny_config(vocab_size=320), dtype=torch.float32,
                                   device="cpu", use_fused_stages=True, **kw)
    eng = tts._engine(1, 8, 4)
    assert eng.use_fused_stages and "_vocoder_packs_large" in eng.params
    ids = torch.arange(20, 36, dtype=torch.int64).reshape(2, 8)
    mask = torch.ones((2, 8), dtype=torch.int32)
    mask[1, :3] = 0
    sim = torch.zeros((2, 8), dtype=torch.bool)
    outs = []
    for flash in (True, False):
        e = TG.Engine(tts.params, tts.cfg, _gen(), max_steps=4, batch=2, prompt_len=8,
                      device="cpu", use_flash_prefill=flash, **kw_engine(tts))
        assert e.use_flash_prefill == flash
        state, out = e.prefill(ids, mask, sim, generator=torch.Generator().manual_seed(0))
        outs.append((state.cur_embeds, out.token))
    (emb_f, tok_f), (emb_d, tok_d) = outs
    assert torch.isfinite(emb_f).all() and torch.equal(tok_f, tok_d)
    torch.testing.assert_close(emb_f, emb_d, atol=1e-5, rtol=1e-5)
