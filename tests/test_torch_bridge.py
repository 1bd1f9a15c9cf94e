"""`utils/torch_bridge.py`: live torch modules in the reference's HF layout
(built here, small) walked into the port's param trees, bit-equal to the JAX
bridge's trees, on the CPU when asked and on CUDA by default."""
import types

import numpy as np
import pytest
import torch
from torch import nn

from vibevoice_tpu.utils import torch_bridge as JB
from vibevoice_tpu_torch.utils import torch_bridge as TB

GEN = torch.Generator().manual_seed(0)


def _rand(*shape):
    return torch.randn(*shape, generator=GEN)


def _mod(**children):
    m = nn.Module()
    for k, v in children.items():
        setattr(m, k, v)
    return m


def _param(*shape):
    return nn.Parameter(_rand(*shape))


def _norm(d):
    return _mod(weight=_param(d))


def _linear(i, o, bias=True):
    lin = nn.Linear(i, o, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(_rand(o, i))
        if bias:
            lin.bias.copy_(_rand(o))
    return lin


def _sconv(cin, cout, k, groups=1, bias=True):
    conv = nn.Conv1d(cin, cout, k, groups=groups, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(_rand(*conv.weight.shape))
        if bias:
            conv.bias.copy_(_rand(cout))
    return _mod(conv=_mod(conv=conv))


def _sconvt(cin, cout, k):
    convtr = nn.ConvTranspose1d(cin, cout, k)
    with torch.no_grad():
        convtr.weight.copy_(_rand(*convtr.weight.shape))
        convtr.bias.copy_(_rand(cout))
    return _mod(convtr=_mod(convtr=convtr))


def _block(d, ffn_bias):
    return _mod(norm=_norm(d), mixer=_mod(conv=_sconv(d, d, 7, groups=d)),
                gamma=_param(d), ffn_norm=_norm(d),
                ffn=_mod(linear1=_linear(d, 4 * d, ffn_bias), linear2=_linear(4 * d, d, ffn_bias)),
                ffn_gamma=_param(d))


def _encoder(final_norm=True):
    dims = [4, 8, 16]
    down = nn.ModuleList([nn.Sequential(_sconv(1, 4, 7))] +
                         [nn.Sequential(_sconv(dims[i], dims[i + 1], 4)) for i in range(2)])
    stages = nn.ModuleList([nn.ModuleList([_block(d, bias) for bias in (True, False)])
                            for d in dims])
    return _mod(downsample_layers=down, stages=stages,
                norm=_norm(16) if final_norm else nn.Identity(), head=_sconv(16, 6, 7))


def _decoder():
    dims = [16, 8, 4]
    up = nn.ModuleList([nn.Sequential(_sconv(6, 16, 7))] +
                       [nn.Sequential(_sconvt(dims[i], dims[i + 1], 4)) for i in range(2)])
    stages = nn.ModuleList([nn.ModuleList([_block(d, True)]) for d in dims])
    return _mod(upsample_layers=up, stages=stages, norm=nn.Identity(), head=_sconv(4, 1, 7))


def _head(h=12, lat=6, layers=2):
    return _mod(noisy_images_proj=_linear(lat, h, False), cond_proj=_linear(h, h, False),
                t_embedder=_mod(mlp=nn.Sequential(_linear(8, h, False), nn.SiLU(),
                                                  _linear(h, h, False))),
                layers=nn.ModuleList([_mod(adaLN_modulation=nn.Sequential(
                    nn.SiLU(), _linear(h, 3 * h, False)), norm=_norm(h),
                    ffn=_mod(gate_proj=_linear(h, 20, False), up_proj=_linear(h, 20, False),
                             down_proj=_linear(20, h, False))) for _ in range(layers)]),
                final_layer=_mod(adaLN_modulation=nn.Sequential(nn.SiLU(),
                                                                _linear(h, 2 * h, False)),
                                 linear=_linear(h, lat, False)))


def _qwen2(h=16, layers=2, vocab=40, tied=True):
    def layer():
        attn = _mod(q_proj=_linear(h, h), k_proj=_linear(h, 8), v_proj=_linear(h, 8),
                    o_proj=_linear(h, h, False))
        return _mod(input_layernorm=_norm(h), self_attn=attn, post_attention_layernorm=_norm(h),
                    mlp=_mod(gate_proj=_linear(h, 24, False), up_proj=_linear(h, 24, False),
                             down_proj=_linear(24, h, False)))
    emb = nn.Embedding(vocab, h)
    with torch.no_grad():
        emb.weight.copy_(_rand(vocab, h))
    return _mod(embed_tokens=emb, layers=nn.ModuleList([layer() for _ in range(layers)]),
                norm=_norm(h), config=types.SimpleNamespace(tie_word_embeddings=tied))


def _connector(i, o):
    return _mod(fc1=_linear(i, o), norm=_norm(o), fc2=_linear(o, o))


def _model(tied):
    core = _mod(language_model=_qwen2(tied=tied),
                acoustic_tokenizer=_mod(encoder=_encoder(), decoder=_decoder()),
                semantic_tokenizer=_mod(encoder=_encoder(final_norm=False)),
                acoustic_connector=_connector(6, 16), semantic_connector=_connector(6, 16),
                prediction_head=_head(), speech_scaling_factor=nn.Parameter(torch.tensor(0.7)),
                speech_bias_factor=nn.Parameter(torch.tensor(-0.2)))
    return _mod(model=core, lm_head=_linear(16, 40, False))


def _assert_bit_equal(got, want, path="params"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_bit_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_bit_equal(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu", path
        w = np.asarray(want)
        assert tuple(got.shape) == w.shape and got.dtype == torch.float32, path
        np.testing.assert_array_equal(got.numpy(), w, err_msg=path)


@pytest.mark.parametrize("tied", [True, False])
def test_full_model_matches_jax_bridge(tied):
    m = _model(tied)
    got = TB.vibevoice_params_from_torch(m, device="cpu")
    _assert_bit_equal(got, JB.vibevoice_params_from_torch(m))
    assert (got["lm_head"] is None) == tied


@pytest.mark.parametrize("part", ["encoder", "decoder", "head", "qwen2", "connector"])
def test_parts_match_jax_bridge(part):
    fn, mod = {"encoder": ("encoder_from_torch", _encoder()),
               "decoder": ("decoder_from_torch", _decoder()),
               "head": ("diffusion_head_from_torch", _head()),
               "qwen2": ("qwen2_from_torch", _qwen2()),
               "connector": ("connector_from_torch", _connector(6, 16))}[part]
    _assert_bit_equal(getattr(TB, fn)(mod, device="cpu"), getattr(JB, fn)(mod))


def test_layout_helpers_match_jax_bridge():
    conv, convt, lin = _rand(5, 3, 7), _rand(3, 5, 4), _rand(6, 9)
    for name, w in (("conv_w", conv), ("convt_w", convt), ("linear_w", lin), ("vec", lin)):
        got = getattr(TB, name)(w, "cpu")
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(JB, name)(w)))


def test_bridge_keeps_the_modules_dtype():
    m = _qwen2()
    m.to(torch.bfloat16)
    got = TB.qwen2_from_torch(m, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    assert torch.equal(got["layers"][0]["q"]["w"], m.layers[0].self_attn.q_proj.weight.t())


def test_bridge_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.vibevoice_params_from_torch(_model(True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.encoder_from_torch(_encoder())
