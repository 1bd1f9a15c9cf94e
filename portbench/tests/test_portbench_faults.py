"""A run with the timed path broken underneath comes out not correct, once
for each fault a podcast cell can have, judged by the 1.5B podcast cell's
own limits at the tiny size on the CPU (the harness's look for a chip is
left out).  The cells run on one chip, so there is no exchange between chips
to leave out."""
import pytest
import torch

from portbench.tests.conftest import run_tiny


def _not_correct(out, checks):
    return out.failed > 0 or not all(ok for *_, ok in checks)


def test_portbench_sound_run_is_correct():
    out, checks = run_tiny(seed=21)
    assert not _not_correct(out, checks)


def test_portbench_step_returning_its_state_unchanged(monkeypatch):
    from vibevoice_tpu_torch.engine import generate as G
    real = G.Engine._step

    def step(self, state):
        _, out = real(self, state)
        return state._replace(host_step=state.host_step + 1), out
    monkeypatch.setattr(G.Engine, "_step", step)
    assert _not_correct(*run_tiny(seed=22))


def test_portbench_half_the_batch_left_out(monkeypatch):
    """The decoder's chunk of the second half of the rows is never made."""
    from vibevoice_tpu_torch.models import tokenizer
    real = tokenizer.decoder_apply_streaming

    def decode(params, cfg, z, states):
        chunk, new = real(params, cfg, z, states)
        keep = torch.arange(chunk.shape[0]) < (chunk.shape[0] + 1) // 2
        return torch.where(keep[:, None, None], chunk, torch.zeros_like(chunk)), new
    monkeypatch.setattr(tokenizer, "decoder_apply_streaming", decode)
    assert _not_correct(*run_tiny(seed=23))


@pytest.mark.parametrize("where", ["latent", "audio"])
def test_portbench_answer_altered_where_it_is_produced(monkeypatch, where):
    """The latent altered as the head returns it, or the audio as the
    decoder returns it, by 5%."""
    from vibevoice_tpu_torch.models import tokenizer, vibevoice
    if where == "latent":
        real = vibevoice.sample_speech_latents
        monkeypatch.setattr(vibevoice, "sample_speech_latents",
                            lambda *a, **k: -real(*a, **k))
    else:
        real = tokenizer.decoder_apply_streaming

        def decode(*a, **k):
            chunk, new = real(*a, **k)
            return chunk * 1.05, new
        monkeypatch.setattr(tokenizer, "decoder_apply_streaming", decode)
    assert _not_correct(*run_tiny(seed=24))


@pytest.mark.parametrize("fault", ["x_T_dropped", "fewer_solver_steps"])
def test_portbench_head_fault_in_the_decode_step_only(monkeypatch, fault):
    """The CFG head broken in the decode step alone, the prefill's frame left
    sound: the solver started from zeros instead of x_T, or one solver step
    fewer."""
    from vibevoice_tpu_torch.engine import generate as G
    from vibevoice_tpu_torch.models import vibevoice
    from vibevoice_tpu_torch.schedule import dpm_solver as ds
    real_step, real_head = G.Engine._step, vibevoice.sample_speech_latents
    inside = []

    def step(self, state):
        inside.append(True)
        try:
            return real_step(self, state)
        finally:
            inside.pop()

    def head(*a, **k):
        if inside:
            a = list(a)
            if fault == "x_T_dropped":
                a[7] = torch.zeros_like(a[7])
            else:
                sched = a[3]
                a[3] = ds.set_timesteps(a[2], ds.make_tables(a[2]), sched.num_steps - 1)
                k = dict(k, timesteps=None)
        return real_head(*a, **k)
    monkeypatch.setattr(G.Engine, "_step", step)
    monkeypatch.setattr(vibevoice, "sample_speech_latents", head)
    out, checks = run_tiny(seed=25)
    assert out.compared["start_audio0_rel"] < 1e-4
    assert _not_correct(out, checks)
