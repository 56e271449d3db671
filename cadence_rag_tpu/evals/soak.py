"""Operational soak: the full serving envelope at once, for N minutes.

Every operational behavior was measured in isolation
(growth prewarm, mixed read/write, compaction, vocab rebuild) but nothing
ran them TOGETHER long enough to see decay or leaks. This harness drives,
concurrently, over a live index:

- continuous retrieve batches (default batch 128 = the serve batcher's
  max_batch; all-unique query texts so request coalescing never fires and
  every per-request host cost is paid);
- a THROTTLED background writer (serve_bench._start_writer) sized to
  cross ONE capacity growth mid-run (the AOT growth prewarmer turns the
  doubling into a buffer copy instead of a mid-serving recompile);
- periodic tombstone deletes + one compaction;
- one online lex-vocab rebuild (core/vocab.auto_rebuild_if_needed via the
  bootstrap trigger — the same entry the store-syncer loop calls), in its
  own thread: it re-featurizes every stored doc (minutes at soak scale on
  a 1-core host) while queries keep serving. The first 480k-doc capture
  ran it synchronously in the ops scheduler — it blocked compaction for
  368 s and competed with the serving core through the last quarter,
  which the decay gate correctly flagged; the corpus default (240k) sizes
  the rebuild to finish mid-run so the final windows measure steady
  state.

Reports per-window QPS/p50/p99 and asserts (a) the last quarter's median
window QPS has not decayed below --decay-floor x the first quarter's and
(b) host RSS growth stays bounded (leak tripwire; the corpus lives on
device, host mirrors are ~17 B/row).

Usage (on the accelerator):
  timeout 1800 python -m cadence_rag_tpu.evals.soak --minutes 10

Prints ONE JSON line. CPU test: tests/integration/test_soak.py runs a
seconds-long configuration of the same machinery.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

_TEMPLATES = (
    "ECONNRESET rollback on the object store gateway build {}",
    "tiering latency cluster retry budget shard {}",
    "lenovo bake-off azure rollout phase {}",
    "v2.3.{} gateway retry",
)


def evaluate_decay(
    windows: List[Dict], decay_floor: float
) -> "tuple[float, float, Optional[str]]":
    """Quarter-median scan-rate decay check. Returns (first_q, last_q,
    failure_or_None). With fewer than two populated windows there is
    nothing to compare — report an EXPLICIT failure instead of letting
    np.median([]) yield NaN, whose comparisons are always False and
    silently pass the gate (ADVICE r4)."""
    if len(windows) < 2:
        return float("nan"), float("nan"), (
            f"only {len(windows)} populated sample window(s) — "
            "the run was too short/slow to evaluate decay"
        )
    q = max(len(windows) // 4, 1)
    first_q = float(np.median([w["scan_mrows_s"] for w in windows[:q]]))
    last_q = float(np.median([w["scan_mrows_s"] for w in windows[-q:]]))
    if last_q < decay_floor * first_q:
        return first_q, last_q, (
            f"scan throughput decayed: last-quarter "
            f"{last_q:.0f} Mrows/s < {decay_floor} x "
            f"first-quarter {first_q:.0f} Mrows/s"
        )
    return first_q, last_q, None


def _rss_mb() -> float:
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def _ops_thread(
    stop: threading.Event, t0: float, run_s: float, state: Dict,
    *, delete_every_s: float, n_delete: int, compact_at_frac: float,
    vocab_at_frac: float,
) -> None:
    """Scheduled mutations: periodic deletes, one compaction, one vocab
    rebuild — run off the query thread so serving never waits on them
    (the realistic shape: the store-syncer thread does this work)."""
    from ..core.index import INT32_MIN, get_index
    from ..core.vocab import auto_rebuild_if_needed
    from ..store.db import get_store

    index = get_index()
    rng = np.random.default_rng(5)
    next_delete = delete_every_s
    vocab_done = compact_done = False

    def rebuild_vocab():
        # own thread: the rebuild re-featurizes every stored doc (minutes
        # at soak scale on this 1-core host) — it must not starve the
        # delete/compaction schedule, and queries keep serving throughout
        t1 = time.monotonic()
        summary = auto_rebuild_if_needed(get_store(), index,
                                         force_check=True)
        state["vocab_rebuild"] = {
            "ran": summary is not None,
            "seconds": round(time.monotonic() - t1, 1),
            "version": (summary or {}).get("version"),
        }

    vocab_thread: Optional[threading.Thread] = None
    while not stop.is_set():
        elapsed = time.monotonic() - t0
        if elapsed >= run_s:
            break
        if not vocab_done and elapsed >= vocab_at_frac * run_s:
            vocab_done = True
            vocab_thread = threading.Thread(target=rebuild_vocab,
                                            daemon=True)
            vocab_thread.start()
            continue
        if not compact_done and elapsed >= compact_at_frac * run_s:
            compact_done = True
            t1 = time.monotonic()
            index.chunks.compact()
            state["compactions"] = state.get("compactions", 0) + 1
            state["compact_seconds"] = round(time.monotonic() - t1, 1)
            continue
        if elapsed >= next_delete:
            next_delete += delete_every_s
            with index.chunks.lock:
                n = index.chunks.count
                live = np.flatnonzero(
                    index.chunks.h_started[:n] != INT32_MIN
                )
                if live.size > n_delete * 4:
                    pick = rng.choice(live, size=n_delete, replace=False)
                    doomed = index.chunks.h_ids[pick].tolist()
                else:
                    doomed = []
            if doomed:
                index.chunks.delete_ids(doomed)
                state["deleted"] = state.get("deleted", 0) + len(doomed)
            continue
        stop.wait(0.25)
    if vocab_thread is not None:
        vocab_thread.join(timeout=600)


def run_soak(
    *,
    minutes: float = 10.0,
    chunks: int = 240_000,
    batch: int = 128,
    writer_rows_s: float = 500.0,
    delete_every_s: float = 60.0,
    n_delete: int = 2_000,
    compact_at_frac: float = 0.55,
    vocab_at_frac: float = 0.15,
    window_s: float = 30.0,
    decay_floor: float = 0.70,
    max_rss_growth_mb: float = 1_500.0,
    max_batch_ms: float = 0.0,
    check: bool = True,
) -> Dict:
    from ..config import settings
    from ..core.index import get_index, reset_index
    from ..store.db import get_store, reset_store
    from ..utils import events
    from .serve_bench import _populate, _start_writer

    workdir = Path(tempfile.mkdtemp(prefix="cadence_soak_"))
    saved = {k: getattr(settings, k) for k in (
        "store_path", "embeddings_provider", "embeddings_base_url",
        "index_initial_capacity", "lex_vocab_auto_rebuild",
        "lex_vocab_bootstrap_docs",
    )}
    settings.store_path = str(workdir / "soak.db")
    settings.embeddings_provider = "stub"
    settings.embeddings_base_url = ""
    settings.index_initial_capacity = 4096
    # the mid-run rebuild fires through the production auto trigger
    # (bootstrap path: no vocab yet + live docs past the floor)
    settings.lex_vocab_auto_rebuild = True
    settings.lex_vocab_bootstrap_docs = min(1_000, chunks)
    reset_store()
    reset_index()
    try:
        from ..engine.retrieve import retrieve_evidence_batch
        from ..schemas import RetrieveRequest

        t_setup = time.perf_counter()
        _populate(chunks)
        index = get_index()
        cap_start = index.chunks.capacity

        def reqs_for(i: int) -> List:
            return [
                RetrieveRequest(
                    query=_TEMPLATES[j % 4].format(i * batch + j),
                    return_style="ids_only",
                )
                for j in range(batch)
            ]

        retrieve_evidence_batch(reqs_for(0))  # compile + warm
        retrieve_evidence_batch(reqs_for(1))
        setup_s = time.perf_counter() - t_setup
        # leak baseline AFTER setup+warmup: corpus population and the
        # first compile are one-time costs, not run-time growth
        rss_start = _rss_mb()

        run_s = minutes * 60.0
        stop = threading.Event()
        inserted = [0]
        state: Dict = {}
        events.enable()
        # GC pauses are a stall suspect on a heap holding device-buffer
        # host mirrors: record every collection >50 ms as an event
        import gc as _gc

        gc_t0 = [0.0]

        def _gc_cb(phase, info):
            if phase == "start":
                gc_t0[0] = time.monotonic()
            else:
                dur = time.monotonic() - gc_t0[0]
                if dur > 0.05:
                    events.record("gc.collect", dur,
                                  gen=info.get("generation"))

        _gc.callbacks.append(_gc_cb)
        writer = _start_writer(stop, inserted, writer_rows_s)
        t0 = time.monotonic()
        ops = threading.Thread(
            target=_ops_thread,
            args=(stop, t0, run_s, state),
            kwargs=dict(
                delete_every_s=delete_every_s, n_delete=n_delete,
                compact_at_frac=compact_at_frac,
                vocab_at_frac=vocab_at_frac,
            ),
            daemon=True,
        )
        ops.start()
        # (elapsed_at_end, batch_latency_s, rss_mb, live_rows)
        samples: List = []
        i = 2
        while time.monotonic() - t0 < run_s:
            reqs = reqs_for(i)
            t1 = time.perf_counter()
            retrieve_evidence_batch(reqs)
            samples.append(
                (time.monotonic() - t0, time.perf_counter() - t1,
                 _rss_mb(), index.chunks.live_count)
            )
            i += 1
        stop.set()
        writer.join(timeout=60)
        ops.join(timeout=120)

        lat = np.array([s[1] for s in samples])
        ends = np.array([s[0] for s in samples])
        rss = np.array([s[2] for s in samples])
        rows = np.array([s[3] for s in samples])
        windows = []
        for w in range(int(np.ceil(run_s / window_s))):
            m = (ends >= w * window_s) & (ends < (w + 1) * window_s)
            if m.sum() < 2:
                continue
            wl = lat[m]
            qps = batch * int(m.sum()) / float(wl.sum())
            med_rows = float(np.median(rows[m]))
            windows.append({
                "t_s": int(w * window_s),
                "qps": round(qps, 1),
                "p50_ms": round(float(np.percentile(wl, 50)) * 1e3, 1),
                "p99_ms": round(float(np.percentile(wl, 99)) * 1e3, 1),
                "rss_mb": int(rss[m].max()),
                "rows": int(med_rows),
                # scan-bound invariant: the fused program streams the
                # whole corpus per batch, so rows-scanned/s (qps x rows)
                # is the throughput measure that stays comparable while
                # the writer grows the corpus — raw QPS falls ~1/rows by
                # construction, which is not decay
                "scan_mrows_s": round(qps * med_rows / 1e6, 1),
            })
        first_q, last_q, decay_failure = evaluate_decay(windows, decay_floor)
        rss_end = _rss_mb()
        out = {
            "minutes": minutes, "chunks_start": chunks, "batch": batch,
            "setup_s": round(setup_s, 1),
            "queries": int(len(samples)) * batch,
            "qps_overall": round(batch * len(samples) / float(lat.sum()), 1),
            "p50_batch_ms": round(float(np.percentile(lat, 50)) * 1e3, 1),
            "p99_batch_ms": round(float(np.percentile(lat, 99)) * 1e3, 1),
            "max_batch_ms": round(float(lat.max()) * 1e3, 1),
            "max_batch_t_s": round(float(ends[int(lat.argmax())]), 1),
            "p50_per_query_ms": round(
                float(np.percentile(lat, 50)) * 1e3 / batch, 3
            ),
            "scan_mrows_s_first_quarter": round(first_q, 1),
            "scan_mrows_s_last_quarter": round(last_q, 1),
            "inserted_rows": inserted[0],
            "deleted_rows": state.get("deleted", 0),
            "compactions": state.get("compactions", 0),
            "compact_seconds": state.get("compact_seconds"),
            "vocab_rebuild": state.get("vocab_rebuild"),
            "capacity_growths": int(index.chunks.capacity != cap_start),
            "capacity_start": int(cap_start),
            "capacity_end": int(index.chunks.capacity),
            "count_end": int(index.chunks.count),
            "rss_start_mb": round(rss_start, 0),
            "rss_end_mb": round(rss_end, 0),
            "windows": windows,
            # operational event log (utils/events.py), rebased to run
            # start, >=250ms only — aligns the worst batch with whatever
            # overlapped it (growth, compaction, vocab apply, prewarm)
            "events": events.drain(t0=t0, min_s=0.25),
        }
        events.disable()
        _gc.callbacks.remove(_gc_cb)
        failures = []
        if check:
            if decay_failure is not None:
                failures.append(decay_failure)
            if max_batch_ms > 0 and out["max_batch_ms"] > max_batch_ms:
                failures.append(
                    f"worst batch {out['max_batch_ms']:.0f} ms > "
                    f"{max_batch_ms:.0f} ms stall gate (capacity growth "
                    "must stay interactive)"
                )
            if rss_end - rss_start > max_rss_growth_mb:
                failures.append(
                    f"rss grew {rss_end - rss_start:.0f} MB > "
                    f"{max_rss_growth_mb} MB"
                )
        out["failures"] = failures
        return out
    finally:
        for k, v in saved.items():
            setattr(settings, k, v)
        reset_store()
        reset_index()
        shutil.rmtree(workdir, ignore_errors=True)


def main() -> None:
    parser = argparse.ArgumentParser(description="operational soak")
    parser.add_argument("--minutes", type=float, default=10.0)
    parser.add_argument("--chunks", type=int, default=240_000)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--writer-rows-s", type=float, default=500.0)
    parser.add_argument("--delete-every-s", type=float, default=60.0)
    parser.add_argument("--n-delete", type=int, default=2_000)
    parser.add_argument("--window-s", type=float, default=30.0)
    parser.add_argument("--decay-floor", type=float, default=0.70)
    parser.add_argument("--compact-at-frac", type=float, default=0.55)
    parser.add_argument(
        "--vocab-at-frac", type=float, default=0.15,
        help=">1 disables the mid-run vocab rebuild",
    )
    parser.add_argument(
        "--max-batch-ms", type=float, default=0.0,
        help="fail if any batch exceeds this (growth-stall gate); 0=off",
    )
    parser.add_argument("--no-check", action="store_true")
    args = parser.parse_args()
    out = run_soak(
        minutes=args.minutes, chunks=args.chunks, batch=args.batch,
        writer_rows_s=args.writer_rows_s,
        delete_every_s=args.delete_every_s, n_delete=args.n_delete,
        compact_at_frac=args.compact_at_frac,
        vocab_at_frac=args.vocab_at_frac,
        window_s=args.window_s, decay_floor=args.decay_floor,
        max_batch_ms=args.max_batch_ms,
        check=not args.no_check,
    )
    print(json.dumps(out))
    if out["failures"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
