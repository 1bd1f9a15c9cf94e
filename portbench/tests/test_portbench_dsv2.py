"""The DeepSeek-V2-Lite cell (`vvdsv2lite-podcast-45k`): its configuration
against the published one, its plain reference against the port on the CPU
at a tiny size, and faults planted in the port's DeepSeek-V2 decoder, each of
which the cell's own limits must catch."""
import dataclasses
import json
import os

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import DATA

CELL = "vvdsv2lite-podcast-45k"

# DeepSeek-V2-Lite's config.json
# (huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json), the
# keys that say something about its shape
PUBLISHED = {
    "attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "model_type": "deepseek_v2",
    "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": False, "num_attention_heads": 16,
    "num_experts_per_tok": 6, "num_hidden_layers": 27, "num_key_value_heads": 16,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func": "softmax", "seq_aux": True,
    "tie_word_embeddings": False, "topk_group": 1, "topk_method": "greedy", "v_head_dim": 128,
    "vocab_size": 102400}


def test_portbench_dsv2_config_is_the_published_model():
    """The decoder keys, at the file's top level and in its decoder_config,
    are the published ones; nothing is reduced; the speech parts are the
    1.5B's with the head as wide as the LM; port and reference read it."""
    from vibevoice_tpu_torch import configs as port
    from portbench.reference import deepseek_v2 as RD
    cell = harness.resolve(CELL)
    f = cell.config_file
    assert cell.config["reduced"] == [] and cell.config["source"].endswith(
        "DeepSeek-V2-Lite/blob/main/config.json")
    for k, v in PUBLISHED.items():
        assert f[k] == v, k
        assert f["decoder_config"][k] == v, k
    base = harness.load_json(os.path.join(harness.ROOT, "portbench", "configs",
                                          "vibevoice-1.5b.json"))
    for k in ("acoustic_tokenizer_config", "semantic_tokenizer_config"):
        assert f[k] == base[k]
    assert f["diffusion_head_config"] == dict(base["diffusion_head_config"], hidden_size=2048)
    cfg = port.config_from_json(os.path.join(harness.ROOT, cell.config["file"]))
    assert cfg.decoder == port.DeepseekV2Config()
    ref = RD.config_from_dict(f).decoder
    assert ref == RD.DeepseekV2Config()
    ids = f["token_ids"]
    assert all(ids["text_max"] <= i < PUBLISHED["vocab_size"] for k, i in ids.items()
               if k != "text_max")


def tiny_cell() -> harness.Cell:
    """The tiny DeepSeek-V2 configuration under the tiny podcast traffic,
    judged by the cell's own limits."""
    with open(os.path.join(DATA, "tiny-dsv2.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(DATA, "tiny-podcast-dsv2.json")) as f:
        tr = json.load(f)
    return harness.Cell({"name": "tiny-dsv2", "config": "tiny-dsv2", "traffic": "tiny-podcast-dsv2",
                         "chips": 1}, {"name": "tiny-dsv2", "file": os.path.join(DATA, "tiny-dsv2.json")},
                        cfg, tr, harness.resolve(CELL).limits,
                        [{"name": "audio_s_per_s", "unit": "audio-s/s"},
                         {"name": "setup_s", "unit": "s"}], [])


def sharpen(p, pcfg, seen=None):
    """The tiny model's weights widened in place (the program and the
    reference share the tensors), so that its attention is as peaked and its
    experts carry as much of each layer as the published widths make them:
    q and kv_b by 6, kv_a by 12 (the compressed kv's RMS well off 1), the
    routed experts' by 5, the shared experts' by 3.  `seen` keeps the
    weights."""
    for lp in p["lm"]["layers"]:
        for keys, f in ((("q", "kv_b"), 6), (("kv_a",), 12),
                        (("experts_gate", "experts_up", "experts_down"), 5),
                        (("shared_gate", "shared_up", "shared_down"), 3)):
            for k in keys:
                if k in lp:
                    lp[k].mul_(f)
    if seen is not None:
        seen["p"] = p
    return p


def run_tiny(seed, hooks=None):
    cell = tiny_cell()
    hooks = dict(hooks or {})
    hooks.setdefault("params", sharpen)
    out = harness.execute(harness.Run(cell, seed, 0.3, False, torch.device("cpu"), hooks))
    return out, harness.judge(out.compared, cell.limits)


def test_portbench_dsv2_reference_matches_the_port():
    """Every compared number of a whole tiny run near float32 rounding, and
    the run correct under the cell's limits."""
    out, checks = run_tiny(seed=31)
    assert set(harness.resolve(CELL).limits) <= set(out.compared)
    assert all(v < 1e-5 for v in out.compared.values()), out.compared
    assert all(ok for *_, ok in checks) and out.failed == 0
    assert out.end_to_end["audio_s_per_s"] > 0


def _fault(monkeypatch, name, seen):
    from vibevoice_tpu_torch.models import deepseek_v2 as D
    if name == "shared_experts_dropped":
        real = D.moe
        monkeypatch.setattr(D, "moe", lambda lp, cfg, h, tally=None: real(
            dict(lp, shared_down=torch.zeros_like(lp["shared_down"])), cfg, h, tally))
    elif name == "one_expert_fewer":  # top-5 in place of top-6: here top-1 of 2
        real = D.route
        monkeypatch.setattr(D, "route", lambda lp, cfg, h: real(
            lp, dataclasses.replace(cfg, num_experts_per_tok=cfg.num_experts_per_tok - 1), h))
    elif name == "no_rope_on_k_pe":
        real = D.apply_rope
        monkeypatch.setattr(D, "apply_rope",
                            lambda x, cos, sin: x if x.shape[2] == 1 else real(x, cos, sin))
    elif name == "no_mscale_in_the_scale":
        monkeypatch.setattr(D, "softmax_scale", lambda cfg: cfg.q_head_dim ** -0.5)
    elif name == "latent_norm_skipped_in_one_layer":
        real = D.rms_norm

        def norm(x, w, eps):
            if w is seen["p"]["lm"]["layers"][1]["kv_norm_w"]:
                return x * w
            return real(x, w, eps)
        monkeypatch.setattr(D, "rms_norm", norm)


@pytest.mark.parametrize("name", ["shared_experts_dropped", "one_expert_fewer",
                                  "no_rope_on_k_pe", "no_mscale_in_the_scale",
                                  "latent_norm_skipped_in_one_layer"])
def test_portbench_dsv2_planted_fault_fails_the_limits(monkeypatch, name):
    seen = {}
    _fault(monkeypatch, name, seen)
    out, checks = run_tiny(seed=32, hooks={"params": lambda p, c: sharpen(p, c, seen)})
    assert out.failed > 0 or not all(ok for *_, ok in checks), out.compared


@pytest.mark.parametrize("name,number", [("shared_experts_dropped", "end_moe_rel"),
                                         ("one_expert_fewer", "end_routed_rel")])
def test_portbench_dsv2_expert_fault_fails_unsharpened(monkeypatch, name, number):
    """The expert numbers read each expert layer from the program's own input
    to it, so an expert fault fails them at the tiny model's own weights,
    with nothing widened."""
    seen = {}
    _fault(monkeypatch, name, seen)

    def keep(p, c):
        seen["p"] = p
        return p
    out, checks = run_tiny(seed=33, hooks={"params": keep})
    assert number in [n for n, *_, ok in checks if not ok], out.compared
