"""Audio streaming transport (host side).

Behavioural port of `vibevoice/modular/streamer.py:13-263`: per-sample queues
of audio chunks with batch/single iterators, plus an asyncio variant.  The
device side hands numpy chunks to `put()`; consumers iterate.  The PyTorch
port's own copy of `vibevoice_tpu/engine/streamer.py`.
"""
from __future__ import annotations

import asyncio
import queue
from typing import Iterable, List, Optional, Sequence

import numpy as np


class AudioStreamer:
    """Per-sample chunk queues (ref AudioStreamer :13-87)."""

    def __init__(self, batch_size: int, stop_signal=None, timeout: Optional[float] = None):
        self.batch_size = batch_size
        self.stop_signal = stop_signal
        self.timeout = timeout
        self.audio_queues = [queue.Queue() for _ in range(batch_size)]
        self.finished_flags = [False] * batch_size

    def put(self, audio_chunks: Sequence[np.ndarray], sample_indices: Iterable[int]):
        for chunk, idx in zip(audio_chunks, sample_indices):
            idx = int(idx)
            if 0 <= idx < self.batch_size and not self.finished_flags[idx]:
                self.audio_queues[idx].put(np.asarray(chunk).reshape(-1))

    def end(self, sample_indices: Optional[Iterable[int]] = None):
        indices = range(self.batch_size) if sample_indices is None else sample_indices
        for idx in indices:
            idx = int(idx)
            if 0 <= idx < self.batch_size and not self.finished_flags[idx]:
                self.finished_flags[idx] = True
                self.audio_queues[idx].put(self.stop_signal)

    def get_stream(self, sample_idx: int):
        """Yield chunks for one sample until its stop signal."""
        q = self.audio_queues[sample_idx]
        while True:
            try:
                item = q.get(timeout=self.timeout) if self.timeout else q.get()
            except queue.Empty:
                return
            if item is self.stop_signal:
                return
            yield item

    def __iter__(self):
        """Batch iterator: yields (sample_idx, chunk) pairs until all end."""
        active = set(range(self.batch_size))
        while active:
            for idx in list(active):
                try:
                    item = self.audio_queues[idx].get_nowait()
                except queue.Empty:
                    continue
                if item is self.stop_signal:
                    active.discard(idx)
                else:
                    yield idx, item


class AsyncAudioStreamer:
    """asyncio variant (ref AsyncAudioStreamer :150-263)."""

    def __init__(self, batch_size: int, stop_signal=None):
        self.batch_size = batch_size
        self.stop_signal = stop_signal
        self.loop = asyncio.get_event_loop()
        self.audio_queues = [asyncio.Queue() for _ in range(batch_size)]
        self.finished_flags = [False] * batch_size

    def put(self, audio_chunks: Sequence[np.ndarray], sample_indices: Iterable[int]):
        for chunk, idx in zip(audio_chunks, sample_indices):
            idx = int(idx)
            if 0 <= idx < self.batch_size and not self.finished_flags[idx]:
                arr = np.asarray(chunk).reshape(-1)
                self.loop.call_soon_threadsafe(self.audio_queues[idx].put_nowait, arr)

    def end(self, sample_indices: Optional[Iterable[int]] = None):
        indices = range(self.batch_size) if sample_indices is None else sample_indices
        for idx in indices:
            idx = int(idx)
            if 0 <= idx < self.batch_size and not self.finished_flags[idx]:
                self.finished_flags[idx] = True
                self.loop.call_soon_threadsafe(
                    self.audio_queues[idx].put_nowait, self.stop_signal)

    async def get_stream(self, sample_idx: int):
        q = self.audio_queues[sample_idx]
        while True:
            item = await q.get()
            if item is self.stop_signal:
                return
            yield item


__all__ = ["AudioStreamer", "AsyncAudioStreamer"]
