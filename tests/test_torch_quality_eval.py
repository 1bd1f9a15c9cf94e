"""`vibevoice_tpu_torch/scripts/quality_eval.py` against `scripts/quality_eval.py`:
the decision rule on every case of `tests/test_quality_verdict.py`, and the
tiny plumbing run of both harnesses on one weight set with the same injected
diffusion noise (dpmsolver++): the same keys, metrics and verdicts.  A
candidate whose audio is the baseline's within fp32 rounding (SNR above
EXACT_DB) is held above EXACT_DB in both: that SNR measures rounding noise."""
import dataclasses
import functools
import importlib.util
import inspect
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibevoice_tpu.engine import generate as JG
from vibevoice_tpu.pipeline import VibeVoiceTTS as JTTS
from vibevoice_tpu.processor.text_tokenizer import ByteFallbackTokenizer as JTok
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.engine import generate as TG
from vibevoice_tpu_torch.pipeline import VibeVoiceTTS as TTTS
from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer as TTok
from vibevoice_tpu_torch.scripts import quality_eval as TQ
from vibevoice_tpu_torch.weights import from_jax

from tests import test_quality_verdict as VERDICT_TESTS
from tests._torch_parity import tiny_params, to_np

_SPEC = importlib.util.spec_from_file_location(
    "jax_quality_eval", os.path.join(os.path.dirname(__file__), "..", "scripts",
                                     "quality_eval.py"))
JQ = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(JQ)

VERDICT_CASES = sorted(n for n, f in inspect.getmembers(VERDICT_TESTS, inspect.isfunction)
                       if n.startswith("test_"))


@pytest.mark.parametrize("case", VERDICT_CASES)
def test_decision_rule_case_on_the_port(monkeypatch, case):
    """Each case of the JAX harness's verdict tests, run on the port's module."""
    monkeypatch.setattr(VERDICT_TESTS, "QE", TQ)
    getattr(VERDICT_TESTS, case)()


def test_tables_are_the_jax_harness_tables():
    for name in ("CANDIDATES", "THRESHOLDS", "LADDER_B1", "LADDER_BATCH", "LADDER_TOKENIZER",
                 "CANONICAL_CANDIDATES"):
        assert getattr(TQ, name) == getattr(JQ, name), name


def test_tiny_weights_are_fixed(monkeypatch):
    """The port's tiny harness model is the same in every call (fixed seeds,
    where the JAX harness seeds two head layers with `hash(name)`), with a
    live diffusion head."""
    args = type("A", (), dict(model_path=None, ddpm_steps=3, cfg_scale=1.3,
                              device=torch.device("cpu")))()
    a, b = TQ._build_tts(args), TQ._build_tts(args)
    for k in ("final_ada_w", "final_linear"):
        assert torch.equal(a.params["diffusion_head"][k], b.params["diffusion_head"][k])
        assert a.params["diffusion_head"][k].abs().max() > 0
    assert torch.equal(a.params["lm"]["embed"], b.params["lm"]["embed"])


CANDS = ["int8", "int4f+int4k", "dh4", "fs"]
MAX_NEW = 8
# the packages' audio agree within ~1e-5 of its scale (fp32, sums in another
# order): an SNR above this many dB is below what the packages share
EXACT_DB = 80.0


def _cfg(cfg):
    # the acoustic VAE at fix_std 0: the voice prompt's latent is its mean in
    # both packages, whose random streams differ
    return dataclasses.replace(cfg, acoustic_tokenizer=dataclasses.replace(
        cfg.acoustic_tokenizer, fix_std=0.0))


def _tts_maker(make):
    def build(args, quantize=None, kv_dtype="model", algorithm_type="dpmsolver++",
              ddpm_steps=None, quantize_tokenizer=None, int4_group_size=None,
              use_fused_stages=False, quantize_diffusion=None):
        return make(ddpm_steps=ddpm_steps or args.ddpm_steps, cfg_scale=args.cfg_scale,
                    quantize=quantize, kv_dtype=kv_dtype, algorithm_type=algorithm_type,
                    quantize_tokenizer=quantize_tokenizer,
                    quantize_diffusion=quantize_diffusion,
                    use_fused_stages=use_fused_stages, tokenizer_min_dim=1,
                    int4_group_size=int4_group_size)
    return build


def test_tiny_run_matches_jax_harness(monkeypatch, tmp_path):
    cfg, jp = tiny_params(0)
    noise = np.random.default_rng(5).normal(size=(MAX_NEW + 1, 1, 8)).astype(np.float32)
    tcfg = _cfg(TC.tiny_config(vocab_size=320))
    monkeypatch.setattr(JQ, "_build_tts", _tts_maker(lambda **kw: JTTS(
        jp, _cfg(cfg), JTok(), dtype=jnp.float32, **kw)))
    monkeypatch.setattr(TQ, "_build_tts", _tts_maker(lambda **kw: TTTS(
        from_jax(to_np(jp), device="cpu"), tcfg, TTok(), dtype=torch.float32, device="cpu",
        **kw)))
    for G in (JG, TG):
        monkeypatch.setattr(G, "Engine", functools.partial(G.Engine, inject_latent_noise=True))
        monkeypatch.setattr(G, "generate", functools.partial(G.generate, latent_noise=noise))
    argv = ["--candidates", *CANDS, "--ddpm_steps", "3", "--max_new_tokens", str(MAX_NEW)]
    monkeypatch.setattr(sys, "argv", ["quality_eval.py", *argv, "--platform", "cpu",
                                      "--output_dir", str(tmp_path / "jax")])
    JQ.main()
    with open(tmp_path / "jax" / "quality_eval.json") as f:
        want = json.load(f)
    got = TQ.main([*argv, "--device", "cpu", "--output_dir", str(tmp_path / "torch")])
    with open(tmp_path / "torch" / "quality_eval.json") as f:
        assert json.load(f) == json.loads(json.dumps(got))
    assert sorted(got) == sorted(want)
    gv, wv = got["verdict"], want["verdict"]
    assert gv["recommended"] == wv["recommended"] and gv["note"] == wv["note"]
    assert gv["thresholds"] == wv["thresholds"] and sorted(gv["verdicts"]) == sorted(CANDS)
    for c, v in wv["verdicts"].items():
        # the same checks fail; their messages carry the metrics, held below
        assert gv["verdicts"][c]["pass"] == v["pass"], c
        assert ([f.split(" ")[:2] for f in gv["verdicts"][c]["fails"]]
                == [f.split(" ")[:2] for f in v["fails"]]), c
    for key, w in want.items():
        if key == "verdict":
            continue
        g = got[key]
        assert sorted(g) == sorted(w), key
        for m in ("mel_l2", "lsd_db", "snr_db", "len_ref_s", "len_test_s", "audio_sec"):
            if m not in w:
                continue
            if m == "snr_db" and w[m] != "inf" and w[m] >= EXACT_DB:
                # a candidate within fp32 rounding of the baseline (fs): its
                # SNR measures rounding noise, which the packages do not share
                assert g[m] == "inf" or g[m] >= EXACT_DB, (key, g[m], w[m])
            elif w[m] == "inf":
                assert g[m] == "inf", (key, m)
            else:
                # both rounded to 4 decimals
                assert abs(g[m] - w[m]) <= 1e-4 * max(1.0, abs(w[m])) + 1e-4, (key, m)
    for c in CANDS:
        assert np.isfinite(got[f"{c}/builtin_smoke"]["mel_l2"])
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
