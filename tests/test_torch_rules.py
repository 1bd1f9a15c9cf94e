"""Rules of the PyTorch port: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless the caller asks for the CPU."""
import os
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


def test_parallel_package_and_rank_harness_import_neither_jax_nor_the_jax_package():
    """`vibevoice_tpu_torch.parallel` and the ranks of the parallel tests
    (`tests/_torch_ranks.py`, every rank program's imports included) load
    torch, numpy and the port only."""
    code = textwrap.dedent("""
        import sys
        import vibevoice_tpu_torch.parallel.mesh, vibevoice_tpu_torch.parallel.multihost
        import vibevoice_tpu_torch.parallel.context_parallel
        import vibevoice_tpu_torch.parallel.ring_attention
        import tests._torch_ranks
        import vibevoice_tpu_torch.engine.generate, vibevoice_tpu_torch.models.vibevoice
        import vibevoice_tpu_torch.weights, vibevoice_tpu_torch.configs
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "vibevoice_tpu" or m.startswith("vibevoice_tpu."))
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr


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



def test_training_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    """`make_train_step` and `init_scaling_stats` run on CUDA unless asked for
    the CPU, and raise without a card."""
    from vibevoice_tpu_torch import train as TT
    cfg = TC.tiny_config(vocab_size=320)
    params = {"w": torch.zeros(2, 2)}
    opt = TT.make_optimizer(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.make_train_step(cfg, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_scaling_stats(params, cfg, None, None)
    TT.make_train_step(cfg, opt, device="cpu")

def _init_model():
    from vibevoice_tpu_torch.models import vibevoice as TV
    TV.init_model(TC.tiny_config(vocab_size=320))


def _from_jax():
    import numpy as np
    from vibevoice_tpu_torch.weights import from_jax
    from_jax({"w": np.zeros((2, 2), np.float32)})


def _load_native(tmp_path):
    from vibevoice_tpu_torch.utils import checkpoint
    path = checkpoint.save_native({"w": torch.zeros(2)}, str(tmp_path / "tree"))
    checkpoint.load_native(path)


@pytest.mark.parametrize("call", ["init_model", "from_jax", "load_native"])
def test_builders_and_loaders_default_to_cuda_and_raise_without_it(no_cuda, tmp_path, call):
    """`vibevoice.init_model`, `weights.from_jax` and `checkpoint.load_native`
    called without `device=` run on CUDA, and raise without a card rather
    than falling back to the CPU."""
    fn = {"init_model": _init_model, "from_jax": _from_jax,
          "load_native": lambda: _load_native(tmp_path)}[call]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()


def test_module_inits_take_their_callers_device():
    """The per-module parameter inits have no device of their own: the
    caller (`init_model`) passes one."""
    from vibevoice_tpu_torch.models import connectors, diffusion_head, qwen2, tokenizer
    cfg = TC.tiny_config(vocab_size=320)
    for fn, args in ((qwen2.init, (cfg.decoder,)), (diffusion_head.init, (cfg.diffusion_head,)),
                     (tokenizer.init_encoder, (cfg.semantic_tokenizer,)),
                     (tokenizer.init_decoder, (cfg.acoustic_tokenizer,)),
                     (connectors.init, (8, 64))):
        with pytest.raises(TypeError, match="device"):
            fn(*args)


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
                      device="cpu", use_flash_prefill=flash,
                      use_fused_stages=tts.use_fused_stages)
        assert e.use_flash_prefill == flash
        state, out = e.prefill(ids, mask, sim, generator=torch.Generator().manual_seed(0))
        outs.append((state.cur_embeds, out.token))
    (emb_f, tok_f), (emb_d, tok_d) = outs
    assert torch.isfinite(emb_f).all() and torch.equal(tok_f, tok_d)
    torch.testing.assert_close(emb_f, emb_d, atol=1e-5, rtol=1e-5)


def test_serving_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    """`from_pretrained` and the serving CLI's `main` run on CUDA unless asked
    for the CPU, and raise without a card (before reading any file)."""
    from vibevoice_tpu_torch.serving.__main__ import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VibeVoiceTTS.from_pretrained(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model_path", str(tmp_path), "--no_warm"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--no_warm"])


def test_serving_cli_help_runs_without_jax():
    """`python -m vibevoice_tpu_torch.serving --help` prints its usage and
    imports no JAX."""
    code = textwrap.dedent("""
        import runpy, sys
        sys.argv = ["vibevoice_tpu_torch.serving", "--help"]
        try:
            runpy.run_module("vibevoice_tpu_torch.serving", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "vibevoice_tpu" or m.startswith("vibevoice_tpu."))
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--model_path" in out.stdout and "--device" in out.stdout


# the port's command-line entry points beside the package, each with
# arguments that would otherwise run it
CLI_ENTRY_POINTS = {
    "demo.inference_from_file": ["--txt_path", "missing.txt", "--tiny"],
    "demo.inference_simple_captions": ["--txt_path", "missing.txt", "--tiny"],
    "demo.inference_with_captions": ["--txt_path", "missing.txt", "--tiny"],
    "demo.batch_inference_simple_captions": ["--txt_path", "missing.txt", "--tiny"],
    "demo.generate_captions_for_existing_audio": ["--audio_path", "missing.wav",
                                                  "--txt_path", "missing.txt"],
    "scripts.quality_eval": [],
    "scripts.convert_nnscaler_checkpoint": ["--checkpoint", "missing.pt", "--config",
                                            "missing.json", "--output", "out"],
    "scripts.warm_serving_cache": ["--model_path", "missing_dir"],
    "demo.gradio_demo": ["--model_path", "missing_dir"],
    "demo.gradio_demo_with_captions": ["--model_path", "missing_dir"],
}
# the web demos need gradio: without it, with `--device cpu`, they stop
# there, before reading a file
WEB_DEMOS = ("demo.gradio_demo", "demo.gradio_demo_with_captions")


@pytest.mark.parametrize("name", sorted(CLI_ENTRY_POINTS))
def test_cli_entry_points_default_to_cuda_and_raise_without_it(no_cuda, name, tmp_path,
                                                               monkeypatch, capsys):
    """Every CLI of the port runs on CUDA unless `--device cpu` is given, and
    raises without a card before it reads a file; with `--device cpu` it goes
    on to its first file (missing here: the batch CLI reports it and saves
    nothing; a web demo without gradio exits 1 with the JAX demo's
    message)."""
    import importlib
    monkeypatch.chdir(tmp_path)
    main = importlib.import_module(f"vibevoice_tpu_torch.{name}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(CLI_ENTRY_POINTS[name])
    on_cpu = CLI_ENTRY_POINTS[name] + ["--device", "cpu"]
    if name == "demo.batch_inference_simple_captions":
        assert main(on_cpu) == []
    elif name in WEB_DEMOS:
        monkeypatch.setitem(sys.modules, "gradio", None)  # absent, wherever this runs
        with pytest.raises(SystemExit) as exc:
            main(on_cpu)
        assert exc.value.code == 1
        assert capsys.readouterr().out.strip().endswith(
            "gradio is not installed; `pip install gradio` to run the web demo.")
    elif name != "scripts.quality_eval":  # on the CPU it runs the tiny harness
        with pytest.raises(FileNotFoundError):
            main(on_cpu)


def test_cli_help_runs_without_jax():
    """`python -m vibevoice_tpu_torch.<cli> --help` prints each CLI's usage with
    its `--device` flag and imports no JAX."""
    code = textwrap.dedent("""
        import contextlib, io, runpy, sys
        for name in NAMES:
            sys.argv = [name, "--help"]
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    runpy.run_module("vibevoice_tpu_torch." + name, run_name="__main__")
            except SystemExit as e:
                assert e.code == 0, (name, e.code)
            assert "--device" in out.getvalue(), name
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "vibevoice_tpu" or m.startswith("vibevoice_tpu."))
        assert not bad, bad
    """).replace("NAMES", repr(sorted(CLI_ENTRY_POINTS)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
