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
                                dict(quantize_diffusion="int4k"),
                                dict(use_fused_stages=True)])
def test_pipeline_modes_outside_the_slice_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VibeVoiceTTS.from_random(TC.tiny_config(vocab_size=320), dtype=torch.float32,
                                 device="cpu", **kw)
