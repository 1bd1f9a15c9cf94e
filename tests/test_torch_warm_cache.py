"""The port's warm CLI (`vibevoice_tpu_torch/scripts/warm_serving_cache.py`)
against the JAX script (`scripts/warm_serving_cache.py`) on the CPU: the same
grid warms the same engines, and each prints one line per engine, the
same lines.  The JAX script fills its compilation cache; the port's builds
its kernel libraries (nothing to build on the CPU, which it says) and leaves
the CUDA graphs, which die with the process, to `tts.warm`."""
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from vibevoice_tpu.pipeline import VibeVoiceTTS as JTTS
from vibevoice_tpu.processor.text_tokenizer import ByteFallbackTokenizer as JTok
from vibevoice_tpu_torch.scripts import warm_serving_cache as TW

from tests._torch_parity import tiny_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = ["--batch_sizes", "1", "--max_new_tokens", "2", "4", "--prompt_buckets", "256"]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_warm_serving_cache", os.path.join(ROOT, "scripts", "warm_serving_cache.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _engine_lines(text):
    return [l for l in text.splitlines() if l.startswith("warmed engine")]


def test_warm_cli_matches_jax_script(monkeypatch, capsys, tmp_path):
    """`--tiny --device cpu` on the port's side, the JAX script's
    `from_random` made tiny (it has no such flag) and its cache settings
    left alone: the engine lines are equal, one per grid point."""
    cfg, jp = tiny_params(0)
    monkeypatch.setattr(JTTS, "from_random", classmethod(
        lambda cls, **kw: cls(jp, cfg, JTok(), **dict(kw, dtype=jnp.float32))))
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["warm_serving_cache.py", *GRID, "--cache_dir",
                                      str(tmp_path / "cache")])
    _jax_script().main()
    want = capsys.readouterr().out
    out = TW.main([*GRID, "--tiny", "--device", "cpu"])
    got = capsys.readouterr().out
    assert _engine_lines(got) == _engine_lines(want) == [
        "warmed engine (batch=1, prompt=256, max_new=2)",
        "warmed engine (batch=1, prompt=256, max_new=4)"]
    assert got.splitlines()[0] == ("no kernel libraries to build on the CPU: the kernels' "
                                   "plain versions run there")
    assert got.splitlines()[-1].startswith("2 engines warmed in ")
    assert out["build"] is None and out["warmed"] == [(1, 256, 2), (1, 256, 4)]
    assert all(e.captures == 0 and e.device.type == "cpu" for e in out["tts"]._engines.values())


def test_warm_cli_passes_the_serving_modes(monkeypatch):
    """The quantized modes, the fused stages and the KV dtype reach
    `VibeVoiceTTS` as the JAX script passes them (with `quantize_diffusion`
    beside them), on the device asked for."""
    seen = {}

    def record(cls, **kw):
        seen.update(kw)
        raise RuntimeError("stop")

    from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
    monkeypatch.setattr(VibeVoiceTTS, "from_random", classmethod(record))
    with pytest.raises(RuntimeError, match="stop"):
        TW.main(["--device", "cpu", "--quantize", "int4", "--quantize_tokenizer", "int4k",
                 "--quantize_diffusion", "int4k", "--use_fused_stages", "--kv_dtype", "int8"])
    assert seen == dict(ddpm_steps=5, algorithm_type="sde-dpmsolver++", quantize="int4",
                        quantize_tokenizer="int4k", quantize_diffusion="int4k",
                        use_fused_stages=True, kv_dtype="int8", device=torch.device("cpu"))
