"""Structured JSONL event logging (the reference has only raw prints; serving
needs machine-readable logs).  The PyTorch port's own copy of
`vibevoice_tpu/utils/logging.py`."""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Optional


class EventLogger:
    """Append-only JSONL logger with wall-clock timestamps."""

    def __init__(self, path: Optional[str] = None, also_stderr: bool = False):
        self.path = path
        self.also_stderr = also_stderr
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
            self._fh = open(path, "a", encoding="utf-8")

    def log(self, event: str, **fields: Any) -> None:
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        line = json.dumps(rec, default=str)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.also_stderr or not self._fh:
            print(line, file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


__all__ = ["EventLogger"]
