"""Production serving layer: dynamic-batching HTTP frontend (stdlib only).

The reference serves through gradio demos only; production deployment wants
a headless endpoint that (a) batches concurrent requests into ONE engine
dispatch, since a batch of B decodes B requests in one step, and (b) warms
each engine before traffic (`VibeVoiceTTS.warm`: on the card, its decode
step captured in a CUDA graph) so no request pays for a capture.

Design:
  * one generation WORKER thread owns the card: every CUDA call (prefill,
    graph capture and replay, the reads of the outputs) runs on it, so
    requests never touch the device concurrently and a capture is never
    broken by a CUDA call of another thread; HTTP handler threads touch only
    numpy and the `AudioStreamer`'s queues;
  * a `BatchingFrontend` queue groups requests into batches of at most
    `max_batch`, waiting up to `max_wait_ms` for co-riders (classic dynamic
    batching); one engine per (batch, prompt bucket, max steps) serves them;
  * stdlib `ThreadingHTTPServer` handles transport — no web-framework
    dependency, JSON in, WAV (or JSON metrics) out.

Endpoints:
  POST /tts        {"script": str, "voice"?: [float...] | preset name |
                    [preset name, ...] (one per speaker),
                    "max_new_tokens"?: int, "seed"?: int}
                   -> audio/wav bytes (mono 24 kHz PCM16)
  POST /tts/stream same body (+"buffer_sec"?, "cadence_s"?) -> chunked
                   audio/wav: the engine's per-frame chunks forwarded through
                   AudioStreamer under the reference gradio buffering policy
                   (flush at >=30 audio-sec buffered OR a 15 s cadence,
                   demo/gradio_demo.py:314-393) — first bytes arrive while
                   generation is still running; TTFB recorded in /metrics
  GET  /healthz    -> {"ok": true}
  GET  /metrics    -> JSON counters (requests, batches, audio-sec, RTF, TTFB)

The PyTorch port's own copy of `vibevoice_tpu/serving/server.py`: the same
responses and counters; a list of preset names, one voice per speaker, is
the port's addition (the JAX server takes one voice per request).
"""
from __future__ import annotations

import io
import json
import struct
import threading
import time
import traceback
import wave
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from ..engine.streamer import AudioStreamer


def wav_bytes(audio: np.ndarray, sr: int = 24000) -> bytes:
    """float32 [-1, 1] -> in-memory PCM16 WAV."""
    pcm = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm16.tobytes())
    return buf.getvalue()


def wav_stream_header(sr: int = 24000) -> bytes:
    """WAV header for a stream of unknown length (RIFF/data sizes maxed —
    the convention streaming decoders accept; mono PCM16)."""
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


def pcm16_bytes(audio: np.ndarray) -> bytes:
    pcm = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    return (pcm * 32767.0).astype("<i2").tobytes()


class _Request:
    __slots__ = ("script", "voices", "max_new_tokens", "seed", "future",
                 "t_enqueue", "stream", "streamer", "sample_idx", "ready")

    def __init__(self, script, voices, max_new_tokens, seed, stream=False):
        self.script = script
        self.voices = voices
        self.max_new_tokens = max_new_tokens
        self.seed = seed
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()
        self.stream = stream
        self.streamer: Optional[AudioStreamer] = None  # set by the worker
        self.sample_idx: Optional[int] = None
        self.ready = threading.Event()  # streamer attached (or failed)


class BatchingFrontend:
    """Groups concurrent requests into one padded engine dispatch.

    Requests with the same (max_new_tokens bucket) ride together; the worker
    serializes all device work.  `submit` returns a Future resolving to
    (audio float32 ndarray, metrics dict).
    """

    def __init__(self, tts, max_batch: int = 8, max_wait_ms: float = 50.0,
                 default_max_new_tokens: int = 256):
        self.tts = tts
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.default_max_new_tokens = default_max_new_tokens
        self._queue: List[_Request] = []
        self._cv = threading.Condition()
        self._stop = False
        self.metrics: Dict[str, Any] = {
            "requests": 0, "batches": 0, "batched_requests_max": 0,
            "audio_sec_total": 0.0, "wall_sec_total": 0.0, "errors": 0,
            "stream_requests": 0, "ttfb_s_last": None, "ttfb_s_sum": 0.0,
            "ttfb_count": 0}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, script: str, voices=None,
               max_new_tokens: Optional[int] = None, seed: int = 0) -> Future:
        return self.submit_request(script, voices, max_new_tokens, seed).future

    def submit_request(self, script: str, voices=None,
                       max_new_tokens: Optional[int] = None, seed: int = 0,
                       stream: bool = False) -> _Request:
        """Enqueue and return the request object (streaming consumers need
        the attached streamer + sample index, not just the final Future)."""
        req = _Request(script, voices, max_new_tokens or self.default_max_new_tokens,
                       seed, stream=stream)
        with self._cv:
            if self._stop:
                raise RuntimeError("frontend stopped")
            self._queue.append(req)
            self.metrics["requests"] += 1
            if stream:
                self.metrics["stream_requests"] += 1
            self._cv.notify()
        return req

    def note_ttfb(self, seconds: float):
        with self._cv:
            self.metrics["ttfb_s_last"] = round(seconds, 4)
            self.metrics["ttfb_s_sum"] += seconds
            self.metrics["ttfb_count"] += 1

    def stop(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._worker.join(timeout=30)

    # -- worker --------------------------------------------------------
    def _take_batch(self) -> List[_Request]:
        with self._cv:
            while not self._queue and not self._stop:
                self._cv.wait(timeout=0.1)
            if not self._queue:
                return []
            # dynamic batching: wait briefly for co-riders
            deadline = time.perf_counter() + self.max_wait_ms / 1000.0
            while (len(self._queue) < self.max_batch
                   and time.perf_counter() < deadline and not self._stop):
                self._cv.wait(timeout=max(0.0, deadline - time.perf_counter()))
            # group by max_new_tokens so one engine bucket serves the batch
            key = self._queue[0].max_new_tokens
            batch, rest = [], []
            for r in self._queue:
                (batch if r.max_new_tokens == key and len(batch) < self.max_batch
                 else rest).append(r)
            self._queue = rest
            return batch

    def _run(self):
        while True:
            batch = self._take_batch()
            if not batch:
                if self._stop:
                    return
                continue
            t0 = time.perf_counter()
            streamer = None
            if any(r.stream for r in batch):
                # one streamer spans the whole engine dispatch; each streaming
                # request reads its own per-sample queue while the worker is
                # still generating
                streamer = AudioStreamer(batch_size=len(batch))
                for i, r in enumerate(batch):
                    r.streamer, r.sample_idx = streamer, i
                    r.ready.set()
            try:
                scripts = [r.script for r in batch]
                voices = [r.voices if r.voices is not None
                          else [np.zeros(64, np.float32)] for r in batch]
                kw = {} if streamer is None else {"audio_streamer": streamer}
                res, metrics = self.tts.generate(
                    scripts, voices, max_new_tokens=batch[0].max_new_tokens,
                    seed=batch[0].seed, **kw)
                wall = time.perf_counter() - t0
                self.metrics["batches"] += 1
                self.metrics["batched_requests_max"] = max(
                    self.metrics["batched_requests_max"], len(batch))
                self.metrics["audio_sec_total"] += metrics["audio_sec"]
                self.metrics["wall_sec_total"] += wall
                for i, r in enumerate(batch):
                    audio = res.audio[i]
                    r.future.set_result(
                        (audio, {"wall_s": wall, "batch_size": len(batch),
                                 "queue_s": t0 - r.t_enqueue}))
            except Exception as e:  # pragma: no cover - surfaced to clients
                traceback.print_exc()
                self.metrics["errors"] += 1
                if streamer is not None:
                    streamer.end()  # unblock stream readers
                for r in batch:
                    r.ready.set()
                    if not r.future.done():
                        r.future.set_exception(e)


class TTSServer:
    """stdlib HTTP server over a BatchingFrontend."""

    def __init__(self, tts, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 8, max_wait_ms: float = 50.0,
                 default_max_new_tokens: int = 256,
                 voice_presets: Optional[Dict[str, Any]] = None,
                 stream_buffer_sec: float = 30.0,
                 stream_cadence_s: float = 15.0,
                 sample_rate: int = 24000):
        self.frontend = BatchingFrontend(
            tts, max_batch=max_batch, max_wait_ms=max_wait_ms,
            default_max_new_tokens=default_max_new_tokens)
        self.voice_presets = voice_presets or {}
        front = self.frontend
        presets = self.voice_presets
        # reference gradio buffering policy defaults: first flush at >=30
        # audio-sec buffered, else on a 15 s cadence (gradio_demo.py:156-168)
        policy = {"buffer_sec": stream_buffer_sec, "cadence_s": stream_cadence_s,
                  "sr": sample_rate}

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # chunked transfer needs 1.1

            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    return self._json(200, {"ok": True})
                if self.path == "/metrics":
                    m = dict(front.metrics)
                    w = m.get("wall_sec_total") or 0.0
                    m["rtf"] = (m["audio_sec_total"] / w) if w else 0.0
                    m["ttfb_s_mean"] = (m["ttfb_s_sum"] / m["ttfb_count"]
                                        if m.get("ttfb_count") else None)
                    return self._json(200, m)
                return self._json(404, {"error": "not found"})

            def _parse_tts_body(self):
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                script = req["script"]
                voice = req.get("voice")
                if isinstance(voice, str):
                    voice = presets[voice]
                voices = None
                if (isinstance(voice, list) and voice
                        and all(isinstance(v, str) for v in voice)):
                    voices = [presets[v] for v in voice]  # one per speaker
                elif voice is not None:
                    v = (np.asarray(voice, np.float32)
                         if not isinstance(voice, str) else voice)
                    voices = [v]
                return req, script, voices

            def _chunk(self, data: bytes):
                if data:
                    self.wfile.write(f"{len(data):X}\r\n".encode())
                    self.wfile.write(data)
                    self.wfile.write(b"\r\n")

            def do_POST(self):
                if self.path == "/tts":
                    return self._tts()
                if self.path == "/tts/stream":
                    return self._tts_stream()
                return self._json(404, {"error": "not found"})

            def _tts(self):
                try:
                    req, script, voices = self._parse_tts_body()
                    fut = front.submit(script, voices,
                                       req.get("max_new_tokens"),
                                       int(req.get("seed", 0)))
                    audio, m = fut.result(timeout=600)
                    if audio is None:
                        return self._json(200, {"audio": None, "metrics": m})
                    body = wav_bytes(audio)
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("X-Batch-Size", str(m["batch_size"]))
                    self.end_headers()
                    self.wfile.write(body)
                except KeyError as e:
                    self._json(400, {"error": f"missing field {e}"})
                except Exception as e:
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})

            def _tts_stream(self):
                """Chunked-transfer streaming: WAV header + PCM16 chunks as
                the engine emits frames, flushed per the buffering policy.
                First bytes reach the client while generation is running."""
                try:
                    req, script, voices = self._parse_tts_body()
                    buffer_sec = float(req.get("buffer_sec", policy["buffer_sec"]))
                    cadence_s = float(req.get("cadence_s", policy["cadence_s"]))
                    r = front.submit_request(script, voices,
                                             req.get("max_new_tokens"),
                                             int(req.get("seed", 0)), stream=True)
                    if not r.ready.wait(timeout=600) or r.streamer is None:
                        return self._json(500, {"error": "stream never started"})
                except KeyError as e:
                    return self._json(400, {"error": f"missing field {e}"})
                except Exception as e:
                    return self._json(500, {"error": f"{type(e).__name__}: {e}"})

                sr = policy["sr"]
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("X-Sample-Rate", str(sr))
                self.end_headers()
                self._chunk(wav_stream_header(sr))
                buf: List[np.ndarray] = []
                min_samples = int(sr * buffer_sec)
                last_flush = time.perf_counter()
                first = True
                try:
                    for piece in r.streamer.get_stream(r.sample_idx):
                        buf.append(piece)
                        n = sum(len(c) for c in buf)
                        if n >= min_samples or (
                                n > 0 and time.perf_counter() - last_flush > cadence_s):
                            self._chunk(pcm16_bytes(np.concatenate(buf)))
                            if first:
                                front.note_ttfb(time.perf_counter() - r.t_enqueue)
                                first = False
                            buf, last_flush = [], time.perf_counter()
                    if buf:
                        self._chunk(pcm16_bytes(np.concatenate(buf)))
                        if first:
                            front.note_ttfb(time.perf_counter() - r.t_enqueue)
                    self.wfile.write(b"0\r\n\r\n")  # end of chunked body
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client hung up mid-stream; generation finishes anyway
                try:  # drain the final result so worker errors are not lost
                    r.future.result(timeout=600)
                except Exception:
                    pass

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.frontend.stop()
        if self._thread:
            self._thread.join(timeout=10)


def serve(tts, host: str = "0.0.0.0", port: int = 8000, **kw) -> TTSServer:
    """Start serving (CLI entry: `python -m vibevoice_tpu_torch.serving`)."""
    srv = TTSServer(tts, host=host, port=port, **kw)
    srv.start()
    return srv


__all__ = ["BatchingFrontend", "TTSServer", "serve", "wav_bytes"]
