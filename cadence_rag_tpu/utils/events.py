"""In-process operational event log (bounded ring buffer).

Serving stalls that no isolated measurement reproduces come from the
INTERACTION of concurrent operational events, so the index/prewarm/vocab
paths record what they do and how long it took; harnesses
(evals/soak.py) drain the ring next to their latency samples and the
worst batch can be aligned with whatever overlapped it.

Zero-cost when disabled (one bool check); never used for control flow.
SURVEY.md §5 tracing: the reference logs event-style messages
(retrieve.complete, ingest_job.*) — this is the index-side analogue with
durations, queryable instead of grep-able.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

_MAX = 8192
_events: "deque[Dict]" = deque(maxlen=_MAX)
_enabled = False
_lock = threading.Lock()


def enable() -> None:
    global _enabled
    with _lock:
        _events.clear()
        _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def record(tag: str, dur_s: Optional[float] = None, **kw) -> None:
    if not _enabled:
        return
    ev = {"t": time.monotonic(), "tag": tag}
    if dur_s is not None:
        ev["s"] = round(float(dur_s), 4)
    if kw:
        ev.update(kw)
    with _lock:
        _events.append(ev)


@contextmanager
def timed(tag: str, **kw):
    if not _enabled:
        yield
        return
    t0 = time.monotonic()
    try:
        yield
    finally:
        record(tag, time.monotonic() - t0, **kw)


def drain(*, t0: Optional[float] = None,
          min_s: Optional[float] = None) -> List[Dict]:
    """Snapshot+clear. ``t0`` rebases timestamps; ``min_s`` keeps only
    events at least that long (un-timed events always pass)."""
    with _lock:
        evs = list(_events)
        _events.clear()
    if t0 is not None:
        for ev in evs:
            ev["t"] = round(ev["t"] - t0, 3)
    if min_s is not None:
        evs = [ev for ev in evs if "s" not in ev or ev["s"] >= min_s]
    return evs
