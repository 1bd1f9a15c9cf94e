"""The decode step that a CUDA graph captures, run eagerly on the CPU.

The port's engine keeps `write_pos` and `step` on the device and runs the
diffusion branch on every step, merged per row (the captured form of the JAX
engine's `lax.cond`), so the step reads nothing back from the device.  These
tests hold that step against the JAX engine's compiled `decode_chunk`, chunk by
chunk, and check that no host read happens inside it."""
import numpy as np
import pytest
import torch

from vibevoice_tpu.engine import generate as JG
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.engine import generate as TG
from vibevoice_tpu_torch.models import qwen2 as tq

from tests._torch_parity import DIFF, EOS
from tests.test_torch_engine import B, GEN, STEPS, T, _inputs, _params

DEC = TC.tiny_config(vocab_size=320).decoder
CHUNK = 5  # three chunks after the prefill's step 0 make STEPS


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("quant", [False, True])
def test_forward_with_a_device_write_pos_equals_the_host_int(quant, t):
    """bf16 (or int8 KV) cache, 2B rows: a prefill at slot 0, then T-token
    writes at slots 9, 10, ... through a 0-d int32 tensor and through a host
    int give bit-equal hidden states and caches; a tensor past the end clamps
    the write to the last T slots, as dynamic_update_slice does."""
    b, t0, s, h = 2, 9, 32, DEC.hidden_size
    gen = torch.Generator().manual_seed(5)
    params = tq.init(DEC, dtype=torch.bfloat16, device="cpu", generator=gen)
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(size=(b, t0, h)), dtype=torch.bfloat16)
    mask = torch.ones((b, t0), dtype=torch.int32)
    bias = torch.full((b, 1, t0, s), -1e9)
    bias[..., :t0] = tq.causal_bias(mask, t0)
    pos = tq.positions_from_mask(mask)
    caches = []
    for _ in range(2):
        c = tq.kv_cache_init(DEC, 2 * b, s, torch.bfloat16, quantized=quant)
        tq.forward(params, DEC, x, pos, bias, cache=c, write_pos=0)
        caches.append(c)
    for wp in (t0, t0 + t, s):  # the last one lies past the cache's end
        xd = torch.tensor(rng.normal(size=(2 * b, t, h)), dtype=torch.bfloat16)
        pd = torch.arange(wp, wp + t, dtype=torch.int32).expand(2 * b, t)
        host = min(wp, s - t)
        vis = torch.zeros((2 * b, s), dtype=torch.int32)
        vis[:, : host + t] = 1
        db = torch.where(vis.bool(), 0.0, -1e9)[:, None, None, :].expand(2 * b, 1, t, s)
        got, _ = tq.forward(params, DEC, xd, pd, db, cache=caches[0],
                            write_pos=torch.tensor(wp, dtype=torch.int32))
        want, _ = tq.forward(params, DEC, xd, pd, db, cache=caches[1], write_pos=host)
        assert torch.equal(got, want)
        for a, w in zip(caches[0], caches[1]):
            if w is not None:
                assert torch.equal(a, w)
    assert caches[0].k[:, :, s - t:].abs().sum() > 0  # the clamped write landed


def test_forward_refuses_a_float_or_batched_write_pos():
    c = tq.kv_cache_init(DEC, 1, 8)
    x = torch.zeros((1, 1, DEC.hidden_size))
    pos = torch.zeros((1, 1), dtype=torch.int32)
    bias = torch.zeros((1, 1, 1, 8))
    for bad in (torch.tensor(1.0), torch.tensor([1]), 1.0):
        with pytest.raises(ValueError, match="write_pos"):
            tq.forward({"layers": [], "final_norm_w": torch.ones(DEC.hidden_size)}, DEC, x,
                       pos, bias, cache=c, write_pos=bad)


def _engines(**extra):
    cfg, jp, tp = _params()
    kw = dict(max_steps=STEPS, batch=B, prompt_len=T, inject_latent_noise=True,
              use_flash_decode=True, **extra)
    je = JG.Engine(jp, cfg, JG.GenerationConfig(**GEN), **kw)
    te = TG.Engine(tp, TC.tiny_config(vocab_size=320), TG.GenerationConfig(**GEN),
                   device="cpu", **kw)
    return je, te


def _prefill(engine, ids, mask, sim, fmask, vl, noise):
    return engine.prefill(ids, mask, sim, None, fmask, None, vl, noise)


def _chunks(engine, state, step_fn=None):
    """Three CHUNK-step chunks: the stacked outputs as numpy, and the state."""
    outs = []
    for _ in range(3):
        if step_fn is None:
            state, o = engine.decode_chunk(state, CHUNK)
        else:
            state, o = step_fn(state, CHUNK)
        outs.append([np.asarray(x).astype(np.float32) for x in o])
    return state, [np.concatenate(x) for x in zip(*outs)]


@pytest.fixture(scope="module")
def jax_run():
    je, _ = _engines()
    args = _inputs()
    state, _ = _prefill(je, *args)
    return _chunks(je, state)


def _assert_matches(got, want, tstate, jstate):
    (ttok, tchunk, temit, tfin), (jtok, jchunk, jemit, jfin) = got, want
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(temit, jemit)
    np.testing.assert_array_equal(tfin, jfin)
    np.testing.assert_allclose(tchunk, jchunk, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tstate.tokens.numpy(), np.asarray(jstate.tokens))
    np.testing.assert_array_equal(tstate.emitted.numpy(), np.asarray(jstate.emitted))
    np.testing.assert_array_equal(tstate.reach_max.numpy(), np.asarray(jstate.reach_max))
    np.testing.assert_array_equal(tstate.frames.numpy(), np.asarray(jstate.frames))
    np.testing.assert_allclose(tstate.audio.numpy(), np.asarray(jstate.audio), atol=1e-4,
                               rtol=0)


def test_capture_safe_step_matches_the_jax_chunks(jax_run):
    """The port's decode_chunk (on the CPU: the capture-safe step, eagerly)
    against the JAX engine's compiled decode_chunk, three chunks of CHUNK
    steps after the prefill.  The inputs reach a step where one row has
    finished while the other still diffuses, and a step where no row
    diffuses: there the always-run branch must merge to lax.cond's result."""
    jstate, want = jax_run
    _, te = _engines()
    tstate, _ = _prefill(te, *_inputs())
    tstate, got = _chunks(te, tstate)
    _assert_matches(got, want, tstate, jstate)
    tok, _, emit, fin = want
    live = ~fin.astype(bool)
    assert (live.any(axis=1) & ~emit.astype(bool).any(axis=1)).any()  # no row diffuses
    assert (fin.astype(bool).any(axis=1) & emit.astype(bool).any(axis=1)).any()
    assert (tok == DIFF).any() and (tok == EOS).any()


def test_counters_stay_on_the_device():
    """write_pos and step are 0-d int32 device tensors after prefill and after
    a chunk; the host mirror tracks the step count without reading it."""
    _, te = _engines()
    state, _ = _prefill(te, *_inputs())
    for n in (0, 4):
        if n:
            state, _ = te.decode_chunk(state, n)
        for x in (state.write_pos, state.step):
            assert torch.is_tensor(x) and x.dim() == 0 and x.dtype == torch.int32
            assert x.device == te.device
        assert state.host_step == 1 + n == int(state.step)
        assert int(state.write_pos) == T + n


def test_step_reads_nothing_from_the_device(monkeypatch):
    """No host read inside the step: the tensor conversions a Python `if`, an
    int() or a slice by a tensor would make raise while two steps run."""
    _, te = _engines()
    state, _ = _prefill(te, *_inputs())

    def refuse(*_a, **_k):
        raise AssertionError("the decode step read a tensor on the host")

    for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist",
                 "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for _ in range(2):
        state, _ = te._step(state)
    monkeypatch.undo()
    assert state.host_step == 3 == int(state.step)


def test_static_buffers_take_a_second_request(jax_run):
    """The graph's body eagerly on the CPU: a first request's state becomes
    the engine's static buffers (`_bind`), every step is `_step_into` (the
    step with its new state copied back into them); a second request's
    prefill reuses the static KV cache and is copied into the rest.  Both
    requests match the JAX engine's chunks."""
    jstate, want = jax_run
    _, te = _engines()

    def graph_body(state, n):
        static = te._bind(state)
        outs = [te._step_into(static) for _ in range(n)]
        return (static._replace(host_step=state.host_step + n),
                TG.StepOutput(*(torch.stack(x) for x in zip(*outs))))

    args = _inputs()
    for request in range(2):
        state, _ = _prefill(te, *args)
        if request:
            assert state.cache is te._static.cache
        state, got = _chunks(te, state, graph_body)
        assert state.visible is te._static.visible and state.rng is te._rng
        _assert_matches(got, want, state, jstate)
