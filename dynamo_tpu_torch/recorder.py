"""Event recorder: JSONL record/replay for router + KV event streams (the
port's copy of the JAX package's recorder.py; the file format is the JAX
package's, so either package replays the other's recording).

Parity: reference lib/llm/src/recorder.rs:37 ``Recorder<T>`` (JSONL files,
rotation by line count) and kv_router/recorder.rs:20 ``KvRecorder =
Recorder<RouterEvent>`` — record the KV-event stream feeding a router's
indexer, replay it later to reconstruct identical routing state for
debugging ("why did this prefix route there?").

Format: one JSON object per line: {"ts": unix_s, "event": <payload>}.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Iterator, Optional

from dynamo_tpu_torch.kv_router.protocols import KvCacheEvent

log = logging.getLogger(__name__)


class Recorder:
    """Append-only JSONL event log with size-based rotation.

    Rotation keeps the newest ``max_lines`` per file and at most
    ``max_files`` rotated files (oldest deleted), mirroring the reference's
    rotation/max-count knobs (recorder.rs:37)."""

    def __init__(
        self,
        path: str,
        *,
        max_lines: int = 100_000,
        max_files: int = 4,
        clock: Callable[[], float] = time.time,
    ):
        self.path = path
        self.max_lines = max_lines
        self.max_files = max_files
        self._clock = clock
        self._lines = 0
        self._fh = None
        self.recorded = 0

    def _open(self) -> None:
        if self._fh is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
            # continuing an existing file: count its lines toward rotation
            if os.path.getsize(self.path) and self._lines == 0:
                with open(self.path, encoding="utf-8") as f:
                    self._lines = sum(1 for _ in f)

    def record(self, event: Any) -> None:
        """Append one event (any JSON-serializable payload)."""
        self._open()
        self._fh.write(json.dumps(
            {"ts": self._clock(), "event": event}, separators=(",", ":")
        ) + "\n")
        self._fh.flush()
        self._lines += 1
        self.recorded += 1
        if self._lines >= self.max_lines:
            self._rotate()

    def _rotate(self) -> None:
        self._fh.close()
        self._fh = None
        self._lines = 0
        if self.max_files <= 1:
            os.remove(self.path)  # budget of one file: discard, start fresh
            return
        for i in range(self.max_files - 1, 0, -1):
            src = f"{self.path}.{i}"
            dst = f"{self.path}.{i + 1}"
            if os.path.exists(src):
                if i + 1 >= self.max_files:
                    os.remove(src)
                else:
                    os.replace(src, dst)
        os.replace(self.path, f"{self.path}.1")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    @staticmethod
    def iter_events(path: str) -> Iterator[tuple[float, Any]]:
        """Yield (ts, event) from a recording (skips corrupt lines)."""
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    yield float(rec["ts"]), rec["event"]
                except (ValueError, KeyError, TypeError):
                    log.warning("skipping corrupt recorder line: %.120r", line)


class KvRecorder:
    """Recorder for the KV-event plane (kv_router/recorder.rs:20): a sink
    compatible with allocator ``on_event``/indexer feeds; replays into any
    indexer with ``apply_event``."""

    def __init__(self, path: str, **kw):
        self.recorder = Recorder(path, **kw)

    def __call__(self, event: KvCacheEvent) -> None:
        self.recorder.record(event.to_dict())

    def close(self) -> None:
        self.recorder.close()

    @staticmethod
    def replay(path: str, indexer: Any, *, speed: Optional[float] = None) -> int:
        """Apply a recorded event stream to an indexer. ``speed`` (events
        replayed per original second, None = as fast as possible) is for
        live-debugging dashboards. Returns events applied."""
        n = 0
        prev_ts: Optional[float] = None
        for ts, payload in Recorder.iter_events(path):
            if speed and prev_ts is not None and ts > prev_ts:
                time.sleep(min((ts - prev_ts) / speed, 1.0))
            prev_ts = ts
            try:
                indexer.apply_event(KvCacheEvent.from_dict(payload))
                n += 1
            except (KeyError, ValueError, TypeError):
                log.warning("skipping unreplayable event: %.120r", payload)
        return n
