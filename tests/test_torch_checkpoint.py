"""The port's checkpoint import and export (`vibevoice_tpu_torch.utils.checkpoint`)
against the JAX package's loader on the same files, `VibeVoiceTTS.from_pretrained`
on the CPU."""
import dataclasses
import json
import os
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as save_np
from safetensors.torch import save_file as save_pt

from vibevoice_tpu import configs as JC
from vibevoice_tpu.models import vibevoice as JV
from vibevoice_tpu.utils import checkpoint as jckpt
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch import weights
from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer
from vibevoice_tpu_torch.utils import checkpoint as tckpt


# ---------------------------------------------------------------------------
# the test's own inverse of `params_from_flat`: a params tree -> flat
# reference-named arrays in the reference's layouts
# ---------------------------------------------------------------------------

def _put_wb(out, name, node, kind):
    w = np.asarray(node["w"])
    out[f"{name}.weight"] = w.transpose({"lin": (1, 0), "conv": (2, 1, 0),
                                         "convt": (0, 2, 1)}[kind])
    if node.get("b") is not None:
        out[f"{name}.bias"] = np.asarray(node["b"])


def _flat_stack(out, prefix, stack, decoder):
    if decoder:
        for i, c in enumerate(stack["up"]):
            if i == 0:
                _put_wb(out, f"{prefix}.upsample_layers.0.0.conv.conv", c, "conv")
            else:
                _put_wb(out, f"{prefix}.upsample_layers.{i}.0.convtr.convtr", c, "convt")
    else:
        for i, c in enumerate(stack["down"]):
            _put_wb(out, f"{prefix}.downsample_layers.{i}.0.conv.conv", c, "conv")
    for i, blocks in enumerate(stack["stages"]):
        for j, bp in enumerate(blocks):
            base = f"{prefix}.stages.{i}.{j}"
            out[f"{base}.norm.weight"] = np.asarray(bp["norm_w"])
            _put_wb(out, f"{base}.mixer.conv.conv.conv", bp["mixer"], "conv")
            out[f"{base}.gamma"] = np.asarray(bp["gamma"])
            out[f"{base}.ffn_norm.weight"] = np.asarray(bp["ffn_norm_w"])
            _put_wb(out, f"{base}.ffn.linear1", bp["ffn1"], "lin")
            _put_wb(out, f"{base}.ffn.linear2", bp["ffn2"], "lin")
            out[f"{base}.ffn_gamma"] = np.asarray(bp["ffn_gamma"])
    if stack["final_norm_w"] is not None:
        out[f"{prefix}.norm.weight"] = np.asarray(stack["final_norm_w"])
    _put_wb(out, f"{prefix}.head.conv.conv", stack["head"], "conv")


def flat_from_params(p, lm_head_too=False):
    out = {}
    lm = "model.language_model"
    out[f"{lm}.embed_tokens.weight"] = np.asarray(p["lm"]["embed"])
    out[f"{lm}.norm.weight"] = np.asarray(p["lm"]["final_norm_w"])
    for i, lp in enumerate(p["lm"]["layers"]):
        b = f"{lm}.layers.{i}"
        out[f"{b}.input_layernorm.weight"] = np.asarray(lp["input_norm_w"])
        out[f"{b}.post_attention_layernorm.weight"] = np.asarray(lp["post_norm_w"])
        for n in "qkvo":
            _put_wb(out, f"{b}.self_attn.{n}_proj", lp[n], "lin")
        for n in ("gate", "up", "down"):
            out[f"{b}.mlp.{n}_proj.weight"] = np.asarray(lp[n]).T
    _flat_stack(out, "model.acoustic_tokenizer.encoder", p["acoustic_encoder"], False)
    _flat_stack(out, "model.acoustic_tokenizer.decoder", p["acoustic_decoder"], True)
    _flat_stack(out, "model.semantic_tokenizer.encoder", p["semantic_encoder"], False)
    for name in ("acoustic_connector", "semantic_connector"):
        c = p[name]
        _put_wb(out, f"model.{name}.fc1", c["fc1"], "lin")
        _put_wb(out, f"model.{name}.fc2", c["fc2"], "lin")
        out[f"model.{name}.norm.weight"] = np.asarray(c["norm_w"])
    h, hp = "model.prediction_head", p["diffusion_head"]
    for ref, ours in (("noisy_images_proj", "noisy_proj"), ("cond_proj", "cond_proj"),
                      ("t_embedder.mlp.0", "t_mlp1"), ("t_embedder.mlp.2", "t_mlp2"),
                      ("final_layer.adaLN_modulation.1", "final_ada_w"),
                      ("final_layer.linear", "final_linear")):
        out[f"{h}.{ref}.weight"] = np.asarray(hp[ours]).T
    for i, lp in enumerate(hp["layers"]):
        out[f"{h}.layers.{i}.adaLN_modulation.1.weight"] = np.asarray(lp["ada_w"]).T
        out[f"{h}.layers.{i}.norm.weight"] = np.asarray(lp["norm_w"])
        for n in ("gate", "up", "down"):
            out[f"{h}.layers.{i}.ffn.{n}_proj.weight"] = np.asarray(lp[n]).T
    for n in ("speech_scaling_factor", "speech_bias_factor"):
        if p.get(n) is not None:
            out[f"model.{n}"] = np.asarray(p[n])
    if p.get("lm_head") is not None:
        out["lm_head.weight"] = np.asarray(p["lm_head"]).T
    elif lm_head_too:  # a tied checkpoint that carries the head anyway
        out["lm_head.weight"] = np.asarray(p["lm"]["embed"])
    return {k: np.array(v, order="C") for k, v in out.items()}


def hf_config(cfg) -> dict:
    """A VibeVoiceConfig in the HF schema that `config_from_json` reads."""
    d = dataclasses.asdict(cfg)
    return {"acoustic_tokenizer_config": d["acoustic_tokenizer"],
            "semantic_tokenizer_config": d["semantic_tokenizer"],
            "diffusion_head_config": d["diffusion_head"],
            "decoder_config": d["decoder"],
            "acoustic_vae_dim": d["acoustic_vae_dim"],
            "semantic_vae_dim": d["semantic_vae_dim"]}


def _jax_tree(tied=True, factors=True):
    cfg = JC.tiny_config()
    if not tied:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                  tie_word_embeddings=False))
    p = JV.init_model(jax.random.PRNGKey(3), cfg)
    # a live final norm where the reference may carry one
    p["acoustic_decoder"]["final_norm_w"] = jnp.linspace(0.5, 1.5, 4)
    if factors:
        p["speech_scaling_factor"] = jnp.asarray(0.7, jnp.float32)
        p["speech_bias_factor"] = jnp.asarray(-0.1, jnp.float32)
    return p, cfg


def write_checkpoint(path, flat, cfg, shards=1, np_dtype=None):
    """Reference-named arrays as one safetensors file or `shards` files with
    an index, beside `config.json`."""
    os.makedirs(path, exist_ok=True)
    if np_dtype is not None:
        flat = {k: v.astype(np_dtype) if v.dtype.kind == "f" else v for k, v in flat.items()}
    if shards == 1:
        save_np(flat, os.path.join(path, "model.safetensors"))
    else:
        names = sorted(flat)
        weight_map = {}
        for s in range(shards):
            part = names[s::shards]
            fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
            save_np({k: flat[k] for k in part}, os.path.join(path, fname))
            weight_map.update({k: fname for k in part})
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f)


def assert_trees_bit_equal(got, want, path="params"):
    assert type(got) is type(want) or (isinstance(got, (list, tuple))
                                       and isinstance(want, (list, tuple))), path
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_trees_bit_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_bit_equal(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True, msg=path)


# (single file or shards, stored dtype, load dtype, tied head carried in the
# file, untied head, speech factors present)
CASES = {
    "single-fp32": (1, None, None, False, False, True),
    "sharded-fp16": (2, np.float16, None, False, False, True),
    "sharded-to-bf16": (2, None, "bfloat16", True, False, True),
    "untied-no-factors": (1, None, "float16", False, True, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_load_hf_checkpoint_matches_jax_loader(tmp_path, case):
    """The port's loader is bit-equal, leaf by leaf, to the JAX loader's tree
    (through `weights.from_jax`) on the same files: the transposes, absent
    biases and norms as None, absent speech factors as NaN, `lm_head` only
    untied, and the floating leaves recast to the load dtype."""
    shards, np_dt, load_dt, lm_head_too, untied, factors = CASES[case]
    p, cfg = _jax_tree(tied=not untied, factors=factors)
    write_checkpoint(str(tmp_path), flat_from_params(p, lm_head_too), cfg, shards, np_dt)
    want, jcfg = jckpt.load_hf_checkpoint(str(tmp_path), dtype=None if load_dt is None
                                          else getattr(jnp, load_dt))
    got, tcfg = tckpt.load_hf_checkpoint(str(tmp_path), device="cpu", dtype=None
                                         if load_dt is None else getattr(torch, load_dt))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (got["lm_head"] is None) == (not untied)
    assert_trees_bit_equal(got, weights.from_jax(jax.tree_util.tree_map(np.asarray, want),
                                                 device="cpu"))


def test_from_jax_keeps_bf16_scalars_0d():
    """A 0-d bf16 leaf (a speech factor loaded in bf16) stays 0-d."""
    got = weights.from_jax({"s": np.asarray(jnp.asarray(-0.1, jnp.bfloat16))}, device="cpu")["s"]
    assert got.shape == () and got.dtype == torch.bfloat16
    assert float(got) == float(jnp.asarray(-0.1, jnp.bfloat16))


def test_params_from_flat_matches_jax(tmp_path):
    p, cfg = _jax_tree()
    flat = flat_from_params(p)
    want = jckpt.params_from_flat(flat, cfg)
    got = tckpt.params_from_flat({k: torch.from_numpy(v.copy()) for k, v in flat.items()},
                                 TC.tiny_config())
    assert_trees_bit_equal(got, weights.from_jax(jax.tree_util.tree_map(np.asarray, want),
                                                 device="cpu"))


def test_config_json_round_trip(tmp_path):
    for jcfg, tcfg in ((JC.tiny_config(), TC.tiny_config()),
                       (JC.vibevoice_1_5b(), TC.vibevoice_1_5b()),
                       (JC.vibevoice_7b(), TC.vibevoice_7b())):
        path = tmp_path / "config.json"
        path.write_text(json.dumps(hf_config(jcfg)))
        assert TC.config_from_json(str(path)) == tcfg


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int64,
                                   torch.int32, torch.int8, torch.uint8, torch.bool])
def test_reader_agrees_with_safetensors(tmp_path, dtype):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((5, 7), generator=gen) * 50
    tensors = {"x": x.to(dtype), "scalar": torch.tensor(3).to(dtype),
               "empty": torch.zeros((0, 4), dtype=dtype), "odd": (x[:3, :3] > 0).to(dtype)}
    path = str(tmp_path / "t.safetensors")
    save_pt(tensors, path, metadata={"format": "pt"})
    got = tckpt.read_safetensors(path)
    with safe_open(path, framework="pt") as f:
        assert set(f.keys()) == set(got)
        for k in f.keys():
            want = f.get_tensor(k)
            assert got[k].dtype == want.dtype and torch.equal(got[k], want), k


def _raw(header: dict, data: bytes, n=None) -> bytes:
    h = json.dumps(header).encode()
    return struct.pack("<Q", len(h) if n is None else n) + h + data


@pytest.mark.parametrize("case,match", [
    ("header-past-file", "runs past the file"),
    ("unknown-dtype", "unknown dtype"),
    ("offsets-out-of-range", "data offsets"),
    ("offsets-overlap", "overlap"),
    ("size-mismatch", "data offsets"),
])
def test_reader_rejects_malformed_files(tmp_path, case, match):
    f32 = lambda a, b: {"dtype": "F32", "shape": [(b - a) // 4], "data_offsets": [a, b]}
    data = bytes(32)
    header = {"a": f32(0, 16), "b": f32(16, 32)}
    n = None
    if case == "header-past-file":
        n = 10 ** 6
    elif case == "unknown-dtype":
        header["a"]["dtype"] = "F8_E9"
    elif case == "offsets-out-of-range":
        header["b"] = f32(16, 48)
    elif case == "offsets-overlap":
        header["b"] = f32(8, 24)
    else:
        header["a"]["shape"] = [5]
    path = tmp_path / "bad.safetensors"
    path.write_bytes(_raw(header, data, n))
    with pytest.raises(ValueError, match=match):
        tckpt.read_safetensors(str(path))


def test_native_round_trip_is_bit_equal(tmp_path):
    p, _ = _jax_tree()
    tree = weights.from_jax(jax.tree_util.tree_map(np.asarray, p), device="cpu")
    tree["lm"]["embed"] = tree["lm"]["embed"].to(torch.bfloat16)
    tree["_packs"] = {3: {"q": torch.arange(6, dtype=torch.int8)}, 5: (torch.ones(2), None)}
    out = tckpt.save_native(tree, str(tmp_path / "params"))
    assert out.endswith(".npz")
    assert_trees_bit_equal(tckpt.load_native(out, device="cpu"), tree)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_load_native_reads_the_jax_npz_fallback(tmp_path, monkeypatch, dtype):
    """The JAX package's `save_native` without orbax writes leaves arr_0.. in
    its flattening order; `load_native(like=...)` puts them back."""
    p, _ = _jax_tree()
    p = jax.tree_util.tree_map(lambda x: x.astype(dtype), p)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)  # the npz fallback
    path = str(tmp_path / "jax_params")
    jckpt.save_native(p, path)
    assert os.path.exists(path + ".npz")
    want = weights.from_jax(jax.tree_util.tree_map(np.asarray, p), device="cpu")
    like = jax.tree_util.tree_map(lambda x: torch.zeros(1), want)
    assert_trees_bit_equal(tckpt.load_native(path, like=like, device="cpu"), want)
    with pytest.raises(ValueError, match="like"):
        tckpt.load_native(path, device="cpu")


def test_from_pretrained_falls_back_to_bytes_and_generates(tmp_path):
    """No tokenizer files: the byte tokenizer; the processor from
    `preprocessor_config.json`; the loaded weights generate audio."""
    cfg = JC.tiny_config(vocab_size=320)
    p = JV.init_model(jax.random.PRNGKey(3), cfg)
    p["speech_scaling_factor"] = jnp.asarray(1.0)
    p["speech_bias_factor"] = jnp.asarray(0.0)
    write_checkpoint(str(tmp_path), flat_from_params(p), cfg)
    (tmp_path / "preprocessor_config.json").write_text(json.dumps(
        {"speech_tok_compress_ratio": 3200, "db_normalize": False}))
    tts = VibeVoiceTTS.from_pretrained(str(tmp_path), dtype=torch.float32, device="cpu",
                                       ddpm_steps=2, prompt_bucket=64)
    assert isinstance(tts.tokenizer, ByteFallbackTokenizer)
    assert tts.processor.db_normalize is False
    assert_trees_bit_equal(tts.params, weights.from_jax(jax.tree_util.tree_map(np.asarray, p),
                                                        device="cpu"))
    from tests.test_torch_pipeline import force_diffusion_engine
    script = "Speaker 1: Loaded from a checkpoint."
    voice = [np.random.default_rng(0).normal(0, 0.05, 4800).astype(np.float32)]
    force_diffusion_engine(tts, script, voice, 4)
    res, metrics = tts.generate(script, voice, max_new_tokens=4, seed=0)
    audio = res.audio[0]
    assert audio is not None and len(audio) == 4 * cfg.speech_compress_ratio
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0
