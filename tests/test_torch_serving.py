"""The port's serving layer (`vibevoice_tpu_torch.serving`) on the CPU: every
case of tests/test_serving.py on the port's server, its responses byte-equal to
the JAX server's over the same deterministic engine stand-in, and the real
tiny torch pipeline served over HTTP, its PCM equal to `tts.generate`'s."""
import io
import json
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from tests.test_serving import FakeTTS, _read_stream
from vibevoice_tpu.serving import server as jserver
from vibevoice_tpu_torch import configs as TC
from vibevoice_tpu_torch.engine import generate as TG
from vibevoice_tpu_torch.pipeline import VibeVoiceTTS
from vibevoice_tpu_torch.serving.server import BatchingFrontend, TTSServer, wav_bytes

SILENCE = np.zeros(64, np.float32)  # the server's voice for a request without one


def _post(port, path, obj, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return json.load(r)


def test_wav_bytes_roundtrip():
    audio = np.sin(np.linspace(0, 20, 2400)).astype(np.float32) * 0.5
    data = wav_bytes(audio)
    with wave.open(io.BytesIO(data)) as w:
        assert w.getframerate() == 24000 and w.getnchannels() == 1
        assert w.getsampwidth() == 2
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    np.testing.assert_allclose(pcm / 32767.0, audio, atol=1e-4)
    assert data == jserver.wav_bytes(audio)


def test_frontend_batches_concurrent_requests():
    tts = FakeTTS()
    fe = BatchingFrontend(tts, max_batch=4, max_wait_ms=200)
    try:
        futs = [fe.submit(f"Speaker 1: req {i}", max_new_tokens=64) for i in range(4)]
        results = [f.result(timeout=30) for f in futs]
        assert all(a is not None for a, _ in results)
        assert max(tts.calls) == 4  # all four rode one dispatch
        assert results[0][1]["batch_size"] == 4
        assert fe.metrics["batched_requests_max"] == 4
    finally:
        fe.stop()


def test_frontend_groups_by_token_bucket():
    tts = FakeTTS()
    fe = BatchingFrontend(tts, max_batch=8, max_wait_ms=150)
    try:
        f1 = fe.submit("Speaker 1: a", max_new_tokens=64)
        f2 = fe.submit("Speaker 1: b", max_new_tokens=128)
        f3 = fe.submit("Speaker 1: c", max_new_tokens=64)
        for f in (f1, f2, f3):
            f.result(timeout=30)
        # the 64-token requests batched together; the 128 one ran separately
        assert sorted(tts.calls) == [1, 2]
    finally:
        fe.stop()


def test_http_server_end_to_end():
    tts = FakeTTS()
    srv = TTSServer(tts, port=0, max_batch=4, max_wait_ms=100,
                    voice_presets={"alice": np.zeros(64, np.float32)}).start()
    try:
        assert _get(srv.port, "/healthz")["ok"] is True
        status, headers, data = _post(srv.port, "/tts", {
            "script": "Speaker 1: hello", "voice": "alice", "max_new_tokens": 32})
        assert status == 200 and headers["Content-Type"] == "audio/wav"
        with wave.open(io.BytesIO(data)) as w:
            assert w.getnframes() == 2400
        m = _get(srv.port, "/metrics")
        assert m["requests"] == 1 and m["batches"] == 1
        with pytest.raises(urllib.error.HTTPError) as ei:  # missing field -> 400
            _post(srv.port, "/tts", {})
        assert ei.value.code == 400
    finally:
        srv.stop()


def test_http_stream_first_chunk_before_completion():
    """The first streamed bytes reach the client while generation still runs:
    the stand-in emits one piece, then blocks until released."""
    tts = FakeTTS()
    tts.hold_event = threading.Event()
    srv = TTSServer(tts, port=0, max_batch=1, max_wait_ms=10).start()
    try:
        got_first = threading.Event()
        result = {}

        def client():
            result["pcm"], _ = _read_stream(
                "127.0.0.1", srv.port,
                {"script": "Speaker 1: hi", "max_new_tokens": 32, "buffer_sec": 0.0},
                lambda t: got_first.set())

        th = threading.Thread(target=client, daemon=True)
        th.start()
        assert got_first.wait(timeout=30)
        assert tts.t_generate_done is None  # generation has not completed
        tts.hold_event.set()
        th.join(timeout=30)
        assert not th.is_alive()
        np.testing.assert_allclose(result["pcm"] / 32767.0, np.full(2400, 0.25), atol=1e-4)
        m = _get(srv.port, "/metrics")
        assert m["stream_requests"] == 1
        assert m["ttfb_s_last"] is not None and m["ttfb_s_mean"] > 0
    finally:
        tts.hold_event.set()
        srv.stop()


def test_voice_list_names_one_preset_per_speaker():
    """The port's addition: "voice" as a list of preset names gives the
    request one voice per speaker; an unknown name is a 400."""
    seen = []

    class Recording(FakeTTS):
        def generate(self, scripts, voices, **kw):
            seen.append(voices)
            return super().generate(scripts, voices, **kw)

    presets = {"a": np.full(64, 0.1, np.float32), "b": np.full(80, 0.2, np.float32)}
    srv = TTSServer(Recording(), port=0, max_batch=1, max_wait_ms=10,
                    voice_presets=presets).start()
    try:
        status, _, _ = _post(srv.port, "/tts", {"script": "Speaker 1: x\nSpeaker 2: y",
                                                 "voice": ["a", "b"]})
        assert status == 200
        (voices,), = seen
        assert [v.tolist() for v in voices] == [presets["a"].tolist(), presets["b"].tolist()]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, "/tts", {"script": "Speaker 1: x", "voice": ["a", "nobody"]})
        assert ei.value.code == 400
    finally:
        srv.stop()


def test_worker_failure_reaches_the_client_as_500():
    """An exception in the worker (a failed capture, say) fails the request
    with a 500 and counts in /metrics; the worker goes on serving."""
    class Failing(FakeTTS):
        fail = True

        def generate(self, *a, **kw):
            if self.fail:
                self.fail = False
                raise RuntimeError("capture failed")
            return super().generate(*a, **kw)

    srv = TTSServer(Failing(), port=0, max_batch=1, max_wait_ms=10).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, "/tts", {"script": "Speaker 1: x"})
        assert ei.value.code == 500
        assert "capture failed" in json.loads(ei.value.read())["error"]
        assert _post(srv.port, "/tts", {"script": "Speaker 1: x"})[0] == 200
        assert _get(srv.port, "/metrics")["errors"] == 1
    finally:
        srv.stop()


@pytest.mark.parametrize("stream", [False, True])
def test_responses_byte_equal_to_the_jax_server(stream):
    """The JAX server and the port's, each over the same deterministic
    stand-in, give byte-equal /tts and /tts/stream bodies and the same
    /metrics keys."""
    body = {"script": "Speaker 1: parity", "voice": "alice", "max_new_tokens": 32,
            "seed": 3, "buffer_sec": 0.05}
    out = []
    for mod in (jserver, __import__("vibevoice_tpu_torch.serving.server",
                                    fromlist=["TTSServer"])):
        srv = mod.TTSServer(FakeTTS(), port=0, max_batch=2, max_wait_ms=10,
                            voice_presets={"alice": np.zeros(64, np.float32)}).start()
        try:
            if stream:
                pcm, _ = _read_stream("127.0.0.1", srv.port, body)
                data = pcm.tobytes()
            else:
                _, headers, data = _post(srv.port, "/tts", body)
                data = (headers["Content-Type"], headers["X-Batch-Size"], data)
            out.append((data, set(_get(srv.port, "/metrics")), _get(srv.port, "/healthz")))
        finally:
            srv.stop()
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the real tiny torch pipeline behind the server
# ---------------------------------------------------------------------------

def _tiny_tts():
    return VibeVoiceTTS.from_random(TC.tiny_config(vocab_size=320), dtype=torch.float32,
                                    ddpm_steps=2, prompt_bucket=256, device="cpu",
                                    algorithm_type="sde-dpmsolver++")


def register_forced(tts, scripts, voices, max_new_tokens):
    """A force_diffusion engine under the key a batch of `scripts` (each with
    its `voices`) asks `generate` for: random weights almost never pick the
    diffusion token by themselves."""
    t0 = tts.processor(scripts, voices).input_ids.shape[1]
    bucket = max(tts.prompt_bucket, -(-t0 // tts.prompt_bucket) * tts.prompt_bucket)
    gen = TG.GenerationConfig(
        speech_start_id=tts.tokenizer.speech_start_id,
        speech_end_id=tts.tokenizer.speech_end_id,
        speech_diffusion_id=tts.tokenizer.speech_diffusion_id,
        eos_id=tts.tokenizer.eos_id, ddpm_steps=tts.ddpm_steps, force_diffusion=True,
        max_length_times=64.0, algorithm_type=tts.algorithm_type)
    tts._engines[(len(scripts), bucket, max_new_tokens)] = TG.Engine(
        tts.params, tts.cfg, gen, max_steps=max_new_tokens, batch=len(scripts),
        prompt_len=bucket, dtype=tts.dtype, device=tts.device)


def test_http_stream_real_tiny_pipeline():
    """Full stack over the real tiny engine: the streamed PCM is the engine's
    emitted audio, and the first chunk arrives before generate() returns."""
    tts = _tiny_tts()
    script, steps = "Speaker 1: hello world", 16
    register_forced(tts, [script], [[SILENCE]], steps)
    done = {}
    real_gen = tts.generate

    def gen(*a, **k):
        try:
            return real_gen(*a, **k)
        finally:
            done["t"] = time.perf_counter()

    tts.generate = gen
    srv = TTSServer(tts, port=0, max_batch=1, max_wait_ms=10).start()
    try:
        pcm, t_first = _read_stream("127.0.0.1", srv.port, {
            "script": script, "max_new_tokens": steps, "buffer_sec": 0.0, "seed": 2})
        assert len(pcm) == steps * tts.cfg.speech_compress_ratio
        deadline = time.perf_counter() + 10
        while "t" not in done and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert "t" in done and t_first < done["t"], (
            "first streamed bytes should precede generation completion")
        _, _, body = _post(srv.port, "/tts", {"script": script, "max_new_tokens": steps,
                                               "seed": 2})
    finally:
        srv.stop()
    # the stream and the buffered response of the same request carry the same PCM
    assert body[44:] == pcm.tobytes()


def test_http_server_real_tiny_pipeline():
    """HTTP -> frontend -> the real tiny engine -> WAV, the PCM equal to
    `wav_bytes` of `tts.generate`'s audio for the same script and seed, at B=1
    and in a batch of two (each row against the same batch called directly)."""
    tts = _tiny_tts()
    steps, hop = 6, tts.cfg.speech_compress_ratio
    scripts = ["Speaker 1: hello world", "Speaker 1: a second, longer request."]
    register_forced(tts, scripts[:1], [[SILENCE]], steps)
    register_forced(tts, scripts, [[SILENCE]] * 2, steps)
    srv = TTSServer(tts, port=0, max_batch=2, max_wait_ms=400).start()
    try:
        _, headers, alone = _post(srv.port, "/tts", {"script": scripts[0],
                                                     "max_new_tokens": steps, "seed": 4})
        assert headers["X-Batch-Size"] == "1"
        got = {}

        def client(i):
            got[i] = _post(srv.port, "/tts", {"script": scripts[i], "max_new_tokens": steps,
                                              "seed": 9})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for th in threads:  # staggered: the queue holds them in this order
            th.start()
            time.sleep(0.1)
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        assert _get(srv.port, "/metrics")["batched_requests_max"] == 2
    finally:
        srv.stop()
    with wave.open(io.BytesIO(alone)) as w:
        assert w.getnframes() == steps * hop
    res, _ = tts.generate(scripts[0], [SILENCE], max_new_tokens=steps, seed=4)
    assert alone == wav_bytes(res.audio[0])
    res, _ = tts.generate(scripts, [[SILENCE]] * 2, max_new_tokens=steps, seed=9)
    for i in range(2):
        assert got[i][1]["X-Batch-Size"] == "2"
        assert got[i][2] == wav_bytes(res.audio[i])
