"""The port's web demos (`vibevoice_tpu_torch/demo/gradio_demo*.py`) on the
CPU: every case of `tests/test_gradio_demo.py` on the port's demos (the UI
graph's control set on the gradio stub, the captions UI, example loading and
its 15-minute skip, speaker counting, streaming end to end), then the port's
demos against the JAX demos on one tiny fp32 weight set, both engines forced
to diffuse with the same injected noise (dpmsolver++): the same yields (their
count, logs and visibility flags), the complete audio within the engine
parity tolerance, the same UI graphs; and where a stop ends the stream."""
import math
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests import _gradio_stub as gr_stub

# the JAX demos, imported at collection time as tests/test_gradio_demo.py does
import demo.gradio_demo as jdemo  # noqa: E402
import demo.gradio_demo_with_captions as jcap  # noqa: E402

from vibevoice_tpu.engine import generate as JG  # noqa: E402
from vibevoice_tpu.pipeline import VibeVoiceTTS as JTTS  # noqa: E402
from vibevoice_tpu.processor.text_tokenizer import ByteFallbackTokenizer as JTok  # noqa: E402
from vibevoice_tpu_torch import configs as TC  # noqa: E402
from vibevoice_tpu_torch.demo import gradio_demo as tdemo  # noqa: E402
from vibevoice_tpu_torch.demo import gradio_demo_with_captions as tcap  # noqa: E402
from vibevoice_tpu_torch.engine import generate as TG  # noqa: E402
from vibevoice_tpu_torch.pipeline import VibeVoiceTTS as TTTS  # noqa: E402
from vibevoice_tpu_torch.processor.text_tokenizer import ByteFallbackTokenizer as TTok  # noqa: E402
from vibevoice_tpu_torch.weights import from_jax  # noqa: E402

from tests._torch_parity import tiny_params, to_np  # noqa: E402
from tests.test_torch_cli import MAX_NEW, _cfg, _forced_engine, _noise_generate  # noqa: E402

SCRIPT = "Speaker 1: Hello world this is a test.\nSpeaker 2: And a second speaker answers."


def _demo(cls, tts):
    d = cls.__new__(cls)
    d.tts = tts
    d.stop_flag = False
    d.is_generating = False
    d.setup_voice_presets()
    d.load_example_scripts()
    return d


def _torch_tts(**kw):
    _, jp = tiny_params(0)
    return TTTS(from_jax(to_np(jp), device="cpu"), _cfg(TC.tiny_config(vocab_size=320)),
                TTok(), dtype=torch.float32, device="cpu", **kw)


@pytest.fixture(scope="module")
def demo_obj():
    return _demo(tdemo.VibeVoiceDemo, _torch_tts(ddpm_steps=2))


def test_ui_graph_has_reference_control_set(demo_obj):
    ui = tdemo.create_demo_interface(demo_obj, gr=gr_stub)
    dropdowns = ui.by_kind("Dropdown")
    assert len(dropdowns) == 4
    assert [d.kw["visible"] for d in dropdowns] == [True, True, False, False]
    sliders = ui.by_kind("Slider")
    assert len(sliders) == 2
    assert sliders[0].kw["maximum"] == 4
    audios = ui.by_kind("Audio")
    assert len(audios) == 2
    assert any(a.kw.get("streaming") for a in audios)
    textboxes = ui.by_kind("Textbox")
    assert any(t.kw.get("label") == "Generation log" for t in textboxes)
    buttons = {b.kw.get("args", ("",))[0]: b for b in ui.by_kind("Button")}
    assert {"Generate", "Stop", "Random example"} <= set(buttons)
    assert buttons["Generate"].events and buttons["Stop"].events
    assert sliders[0].events and sliders[0].events[0]["trigger"] == "change"


def test_ui_graph_with_captions(demo_obj):
    d = tcap.VibeVoiceDemoWithCaptions.__new__(tcap.VibeVoiceDemoWithCaptions)
    d.__dict__.update(demo_obj.__dict__)
    ui = tcap.create_demo_interface_with_captions(d, gr=gr_stub)
    assert len(ui.by_kind("Dropdown")) == 4
    labels = [t.kw.get("label") for t in ui.by_kind("Textbox")]
    assert "Live caption" in labels
    assert ui.by_kind("File")


def test_example_scripts_skip_long(demo_obj):
    # the repo's examples hold a 90-minute script, which must be skipped
    assert demo_obj.example_scripts, "no example scripts loaded"
    assert len(demo_obj.example_scripts) == len(
        [f for f in os.listdir(tdemo.EXAMPLES_DIR) if f.endswith(".txt")]) - 1
    for n, script in demo_obj.example_scripts:
        assert 1 <= n <= 4


def test_example_loader_skips_over_15min(tmp_path):
    d = tdemo.VibeVoiceDemo.__new__(tdemo.VibeVoiceDemo)
    exdir = tmp_path / "text_examples"
    exdir.mkdir()
    (exdir / "2p_short.txt").write_text("Speaker 1: hi\nSpeaker 2: yo")
    (exdir / "4p_long_45min.txt").write_text("Speaker 1: way too long")
    (exdir / "1p_ok_10min.txt").write_text("Speaker 1: fine")
    d.load_example_scripts(str(exdir))
    names = [s for _, s in d.example_scripts]
    assert "Speaker 1: way too long" not in names
    assert len(d.example_scripts) == 2


def test_speaker_count_detection(demo_obj):
    f = demo_obj._get_num_speakers_from_script
    assert f("Speaker 1: a\nSpeaker 2: b") == 2
    assert f("Speaker 0: a\nSpeaker 1: b") == 2
    assert f("no labels here") == 1
    assert f("Speaker 1: a\nSpeaker 4: d") >= 2


def _force(monkeypatch, tts, G, extra=None):
    monkeypatch.setattr(type(tts), "_engine", _forced_engine(G, **(extra or {})))
    monkeypatch.setattr(G, "generate", _noise_generate(G))


def test_streaming_generator_end_to_end(demo_obj, monkeypatch):
    """Forced-diffusion tiny engine: the generator yields one complete-audio
    artifact (16-bit, 24 kHz) and a finished log."""
    _force(monkeypatch, demo_obj.tts, TG, dict(device="device"))
    outs = list(demo_obj.generate_podcast_streaming(
        1, "Speaker 1: Hello world this is a test.", max_new_tokens=MAX_NEW))
    completes = [c for _s, c, _l, _v in outs if c is not None]
    assert len(completes) == 1
    sr, wav = completes[0]
    assert sr == 24000 and wav.dtype == np.int16 and len(wav) > 0
    assert "Done" in outs[-1][2]


def _graph(ui):
    """The UI graph as data: each component's kind and keyword arguments
    (a Markdown's text aside), and each event's trigger, function position
    and inputs and outputs by component index."""
    index = {id(c): i for i, c in enumerate(ui.components)}
    comps = [(c.kind, {k: v for k, v in c.kw.items() if c.kind != "Markdown" or k != "args"})
             for c in ui.components]
    events = [(index[id(c)], e.get("trigger"), [index[id(x)] for x in e["inputs"] or []],
               [index[id(x)] for x in e["outputs"] or []])
              for c in ui.components for e in c.events]
    return comps, events


@pytest.fixture(scope="module")
def both():
    """The JAX and the port's demos (plain and with captions) on one tiny
    weight set, 2 solver steps of dpmsolver++."""
    cfg, jp = tiny_params(0)
    jtts = JTTS(jp, _cfg(cfg), JTok(), dtype=jnp.float32, ddpm_steps=2,
                algorithm_type="dpmsolver++")
    ttts = _torch_tts(ddpm_steps=2, algorithm_type="dpmsolver++")
    return dict(jax=_demo(jcap.VibeVoiceDemoWithCaptions, jtts),
                torch=_demo(tcap.VibeVoiceDemoWithCaptions, ttts))


def test_ui_graphs_match_jax(both):
    """Both UI graphs, built on the stub: the same component kinds, labels,
    settings and events, for the plain demo and the captions demo."""
    for jmake, tmake in ((jdemo.create_demo_interface, tdemo.create_demo_interface),
                         (jcap.create_demo_interface_with_captions,
                          tcap.create_demo_interface_with_captions)):
        assert _graph(tmake(both["torch"], gr=gr_stub)) == _graph(jmake(both["jax"],
                                                                        gr=gr_stub))


@pytest.mark.parametrize("captions", [False, True])
def test_streams_match_jax(both, monkeypatch, captions):
    """The same request through both demos' generators: the same number of
    yields with the same logs and visibility flags (the captions demo: the
    same live captions and caption files' contents), each streamed chunk
    within the engine parity tolerance of the JAX one, and the streamed
    chunks concatenated are the complete audio."""
    _force(monkeypatch, both["jax"].tts, JG)
    _force(monkeypatch, both["torch"].tts, TG, dict(device="device"))
    # a stopped clock: no yield on the UI loop's 15 s cadence, which a slow
    # first (compiling) run would reach and the other not
    for mod in (jdemo, tdemo):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda: 0.0))
    runs = {}
    for name, d in both.items():
        gen = (d.generate_with_captions if captions else d.generate_podcast_streaming)
        runs[name] = list(gen(2, SCRIPT, None, None, max_new_tokens=MAX_NEW))
    got, want = runs["torch"], runs["jax"]
    assert len(got) == len(want) >= 3
    streamed = []
    for g, w in zip(got, want):
        assert (g[2], g[3]) == (w[2], w[3])  # log, streaming visibility
        for gi, wi in ((g[0], w[0]), (g[1], w[1])):
            assert (gi is None) == (wi is None)
            if gi is not None:
                assert gi[0] == wi[0] == 24000
                a, b = np.asarray(gi[1], np.float64), np.asarray(wi[1], np.float64)
                scale = 32767 if gi[1].dtype == np.int16 else 1
                np.testing.assert_allclose(a / scale, b / scale, atol=1e-4 + 1 / 32767, rtol=0)
        if g[0] is not None:
            streamed.append(g[0][1])
        if captions:
            assert g[4] == w[4]
            assert (g[5] is None) == (w[5] is None)
            if g[5] is not None:
                for gf, wf in zip(g[5], w[5]):
                    assert os.path.splitext(gf)[1] == os.path.splitext(wf)[1]
                    with open(gf, "rb") as a, open(wf, "rb") as b:
                        assert a.read() == b.read()
    assert got[-1][2].startswith("Done") and got[-1][1] is not None
    complete = got[-1][1][1]
    np.testing.assert_array_equal(tdemo.convert_to_16_bit_wav(np.concatenate(streamed)),
                                  complete)
    assert len(complete) == MAX_NEW * both["torch"].tts.cfg.speech_compress_ratio


@pytest.mark.parametrize("flag_at", [1, 2, 6, 9])
def test_stop_ends_the_stream_within_one_chunk(monkeypatch, flag_at):
    """A stop raised while step `flag_at` is handed out: `generate` decodes
    `stream_chunk` (4) steps between its stop checks, so it ends with the
    chunk that step was in, 3 steps after the flag at most (1 + 4 k steps in
    all: the prefill's, then whole chunks), and no step after it; the UI
    loop stops at the next chunk it reads and ends with "Generation
    stopped."."""
    d = _demo(tdemo.VibeVoiceDemo, _torch_tts(ddpm_steps=2))
    monkeypatch.setattr(type(d.tts), "_engine", _forced_engine(TG, device="device"))
    orig = TG.generate
    noise = np.random.default_rng(5).normal(size=(41, 1, 8)).astype(np.float32)
    monkeypatch.setattr(TG, "generate", lambda eng, *a, **kw: orig(eng, *a, latent_noise=noise,
                                                                   **kw))
    seen = []

    def on_step(out):
        seen.append(out)
        if len(seen) == flag_at:
            d.stop_audio_generation()

    outs = list(d.generate_podcast_streaming(1, SCRIPT, max_new_tokens=40, on_step=on_step))
    want = 1 + 4 * math.ceil((flag_at - 1) / 4)
    assert len(seen) == want and want - flag_at <= 3
    assert outs[-1] == (None, None, "Generation stopped.", False)
    assert not d.is_generating
