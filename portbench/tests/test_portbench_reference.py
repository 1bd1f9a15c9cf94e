"""The plain reference against the port on the tiny configuration, on the
CPU, both in float32: every compared number of a whole run near rounding,
and the pieces one by one."""
import torch

from portbench import check, weights
from portbench.reference import configs, model as R
from portbench.tests.conftest import run_tiny, tiny_cell


def test_portbench_tiny_run_agrees_with_the_reference():
    out, checks = run_tiny(seed=11, seconds=0.5)
    assert set(tiny_cell().limits) <= set(out.compared)
    assert all(v < 1e-5 for v in out.compared.values()), out.compared
    assert all(ok for *_, ok in checks) and out.failed == 0
    assert out.end_to_end["audio_s_per_s"] > 0 and out.attempted >= 2


def test_portbench_reference_lm_matches_the_port():
    from vibevoice_tpu_torch.configs import config_from_json
    from vibevoice_tpu_torch.models import qwen2
    from portbench.tests.conftest import DATA
    import os
    cfg = configs.config_from_json(os.path.join(DATA, "tiny.json"))
    pcfg = config_from_json(os.path.join(DATA, "tiny.json"))
    p = weights.make_weights(cfg, 3, "cpu", torch.float32)
    x = torch.randn(1, 9, 64, generator=torch.Generator().manual_seed(0))
    mask = torch.ones(1, 9, dtype=torch.int32)
    pos = qwen2.positions_from_mask(mask)
    want, _ = qwen2.forward(p["lm"], pcfg.decoder, x, pos, qwen2.causal_bias(mask, 9))
    h, k, v = R.lm_prompt(p["lm"], cfg.decoder, [x[0]])
    assert torch.allclose(h, want[:, -1], atol=1e-5, rtol=1e-5)
    # one decode step over the prompt's k, v against the port's cache path
    cache = qwen2.kv_cache_init(pcfg.decoder, 1, 10)
    _, cache = qwen2.forward(p["lm"], pcfg.decoder, x, pos, qwen2.causal_bias(mask, 9).new_full(
        (1, 1, 9, 10), -1e9).index_copy_(3, torch.arange(9), qwen2.causal_bias(mask, 9)),
        cache=cache, write_pos=0)
    y = torch.randn(1, 1, 64, generator=torch.Generator().manual_seed(1))
    vis = torch.ones(1, 10, dtype=torch.int32)
    got, _ = qwen2.forward(p["lm"], pcfg.decoder, y, torch.full((1, 1), 9), qwen2.decode_bias(vis),
                           cache=cache, write_pos=9)
    hs, nk, nv = R.lm_step(p["lm"], cfg.decoder, y[0], [9], lambda li, j: (k[0][li], v[0][li]))
    assert torch.allclose(hs, got[:, 0], atol=1e-5, rtol=1e-5)
    assert torch.allclose(nk[:, 0], cache.k[:, 0, 9], atol=1e-5, rtol=1e-5)


def test_portbench_attend_blocks_match_one_softmax():
    g = torch.Generator().manual_seed(2)
    q, k, v = torch.randn(37, 4, 8, generator=g), torch.randn(37, 16, generator=g), \
        torch.randn(37, 16, generator=g)
    got = R.attend(q, k, v, causal=True, block=5)
    kh = k.reshape(37, 2, 8).repeat_interleave(2, dim=1)
    vh = v.reshape(37, 2, 8).repeat_interleave(2, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, kh) / 8 ** 0.5
    s = s.masked_fill(torch.ones(37, 37).triu(1).bool(), float("-inf"))
    want = torch.einsum("hqk,khd->qhd", s.softmax(-1), vh).reshape(37, 32)
    assert torch.allclose(got, want, atol=1e-6)


def test_portbench_fp8_weights_round_matrices_only():
    w = {"m": torch.randn(16, 8), "b": torch.randn(8), "s": torch.tensor(0.5)}
    r = check.fp8_weights(w)
    assert torch.equal(r["b"], w["b"]) and torch.equal(r["s"], w["s"])
    err = (r["m"] - w["m"]).norm() / w["m"].norm()
    assert 0.005 < err < 0.1
    assert torch.equal(check.fp8_weights(r)["m"], r["m"])  # idempotent on the grid
