"""Lexical vocab head: learn collision-free buckets for frequent features.

pg_search's BM25 index keeps exact per-term postings — collision-free by
construction (reference: alembic/versions/0005:17-37). The device signature
lane trades that for fixed-width hashed buckets (ops/hashing.py), and the
fidelity cost is dominated by collisions BETWEEN frequent features, which
carry most of the score mass. This module learns the corpus's top-T
document-frequent feature hashes and gives them dedicated buckets ``[0, T)``
(ops/hashing.apply_vocab); the hashed tail keeps covering the long tail of
rare features. Measured on the fidelity harness (evals/lexical_fidelity.py):
top-10 overlap vs collision-free feature BM25 at D=4096 goes 0.87 -> ~0.96
with T=2048.

Operational contract (scripts/build_lex_vocab.py):
- the vocab is persisted per store (``lex_vocab`` table, highest version
  active) and every featurizer in a process follows the registry in
  ingest/featurize (set at startup via :func:`activate_from_store`);
- applying a new vocab RE-FEATURIZES every stored document (store
  ``lex_sig`` blobs + device rows + df table), so it must run offline —
  a serving process started before the rebuild would score new-layout
  signatures with old-layout query vectors.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import settings
from ..ingest import featurize
from ..logging_utils import get_logger

logger = get_logger(__name__)

# (table, id column, text column) for both indexed corpora
CORPUS_COLUMNS = (
    ("chunks", "chunk_id", "text"),
    ("artifact_chunks", "artifact_chunk_id", "content"),
)


def vocab_digest(hashes: Optional[np.ndarray]) -> str:
    """Content digest of a vocab head — version counters alone cannot
    distinguish two stores that each built their own v1."""
    if hashes is None or hashes.size == 0:
        return ""
    import hashlib

    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(hashes, dtype=np.uint64)).tobytes()
    ).hexdigest()[:32]


def save_vocab(store, hashes: np.ndarray, dim: int, *,
               applied: bool = False, built_docs: int = 0) -> int:
    """Persist a new vocab version (unapplied by default — see
    mark_applied); returns the version number. ``built_docs`` records the
    corpus size at build time (the growth input to auto-rebuild)."""
    hashes = np.unique(np.asarray(hashes, dtype=np.uint64))
    with store.tx() as conn:
        cur = conn.execute(
            "INSERT INTO lex_vocab (head, dim, created_at, applied, hashes, "
            "built_docs) VALUES (?,?,?,?,?,?)",
            (
                int(hashes.size),
                int(dim),
                _dt.datetime.now(_dt.timezone.utc).isoformat(),
                1 if applied else 0,
                hashes.tobytes(),
                int(built_docs),
            ),
        )
        return int(cur.lastrowid)


def mark_applied(store, version: int) -> None:
    with store.tx() as conn:
        conn.execute(
            "UPDATE lex_vocab SET applied=1 WHERE version=?", (int(version),)
        )


def load_vocab(store) -> Optional[Tuple[np.ndarray, int, int]]:
    """-> (sorted uint64 hashes, version, dim) of the active (highest
    APPLIED version) vocab, or None. Raises if an interrupted
    build_lex_vocab left a newer unapplied row: the store's lex_sig
    blobs may be a mix of two layouts (undetectable per row), so the
    only safe paths are re-running the apply or deleting the row."""
    with store.read() as conn:
        row = conn.execute(
            "SELECT version, dim, hashes FROM lex_vocab WHERE applied=1 "
            "ORDER BY version DESC LIMIT 1"
        ).fetchone()
        pending = conn.execute(
            "SELECT MAX(version) AS v FROM lex_vocab WHERE applied=0"
        ).fetchone()
    applied_version = int(row["version"]) if row is not None else 0
    if pending and pending["v"] and int(pending["v"]) > applied_version:
        raise RuntimeError(
            f"lex vocab v{pending['v']} exists but its re-featurize never "
            "completed (interrupted build_lex_vocab): stored lex_sig blobs "
            "may mix two layouts. Re-run scripts/build_lex_vocab to "
            "rebuild+reapply, or DELETE FROM lex_vocab WHERE applied=0 to "
            "keep the previous layout — then re-featurize via the script."
        )
    if row is None:
        return None
    hashes = np.frombuffer(row["hashes"], dtype=np.uint64).copy()
    return hashes, applied_version, int(row["dim"])


def activate_from_store(store) -> int:
    """Point the process's featurizers at the store's active vocab
    (no-op when none is built). Returns the active version (0 = none).
    Must run BEFORE any featurization against this store's index."""
    loaded = load_vocab(store)
    if loaded is None:
        featurize.set_active_vocab(None, 0)
        return 0
    hashes, version, dim = loaded
    if dim != int(settings.lexical_dim):
        raise RuntimeError(
            f"lex vocab v{version} was built for LEXICAL_DIM={dim} but this "
            f"process runs LEXICAL_DIM={settings.lexical_dim}; rebuild the "
            "vocab (scripts/build_lex_vocab.py) or restore the setting"
        )
    featurize.set_active_vocab(hashes, version)
    logger.info("lex_vocab.activated version=%s head=%s", version, hashes.size)
    return version


def refresh_if_changed(store) -> Optional[int]:
    """Cheap per-cycle re-check for long-lived writer processes
    (scripts/ingest_worker.py): if the store's applied vocab version
    moved since activation (an offline build_lex_vocab ran), re-activate
    so newly ingested docs are featurized under the current layout.
    Returns the new version when a switch happened, else None."""
    with store.read() as conn:
        row = conn.execute(
            "SELECT MAX(version) AS v FROM lex_vocab WHERE applied=1"
        ).fetchone()
    current = int(row["v"]) if row and row["v"] else 0
    _, active = featurize.active_vocab()
    if current == active:
        return None
    return activate_from_store(store)


def adopt_store_layout(store, index, *, batch: int = 4096) -> Optional[int]:
    """Serving-process repair for an EXTERNAL vocab rebuild: when this
    process's active layout lags the store's applied vocab (another
    process ran build_lex_vocab/auto-rebuild against the shared store),
    activate the store's vocab and refresh every live device row's
    lexical signature FROM THE STORE BLOBS — the rebuilding process
    already rewrote them, so no re-featurization is needed except for
    straggler rows still stamped with an older version (those are
    re-featurized from text and written back). Rebuilds each corpus's
    bucket df table and persists index meta. Returns the adopted
    version, or None when the layouts already match (one cheap SELECT).

    Called from the StoreSyncer poll loop, closing the layout-coherence
    hole for the multi-serving-process topology: without it, new-layout
    rows reaching a lagging process's syncer were inserted into an
    old-layout index and scored wrong silently (review finding r3)."""
    prev_hashes, prev_version = featurize.active_vocab()
    new_version = refresh_if_changed(store)
    if new_version is None:
        return None
    logger.warning(
        "lex_vocab.adopting_store_layout version=%s (external rebuild "
        "detected; refreshing device signatures from store)", new_version,
    )
    try:
        _adopt_scatter(store, index, new_version)
    except Exception:
        # revert the activation so the next poll tick retries the FULL
        # adoption (a partially refreshed index under the new layout
        # would otherwise look "done" to the version check)
        featurize.set_active_vocab(prev_hashes, prev_version)
        raise
    return new_version


def _adopt_scatter(store, index, new_version: int, *,
                   batch: int = 4096) -> None:
    from ..ingest.ingest import persist_lexical_meta

    for table, id_col, text_col in CORPUS_COLUMNS:
        corpus = index.corpus(table)
        df_acc = np.zeros(corpus.lex_dim, dtype=np.int64)
        avgdl = corpus.avgdl or 400.0
        after = -1
        n_live = 0
        n_refeat = 0
        while True:
            with store.read() as conn:
                rows = conn.execute(
                    f"SELECT {id_col} AS id, lex_sig, lex_vocab_version, "
                    f"{text_col} AS txt FROM {table} "
                    f"WHERE {id_col} > ? ORDER BY {id_col} LIMIT ?",
                    (after, batch),
                ).fetchall()
            if not rows:
                break
            ids = [int(r["id"]) for r in rows]
            sig_rows = np.zeros((len(rows), corpus.lex_dim), np.int8)
            stale_updates = []
            for i, r in enumerate(rows):
                blob = r["lex_sig"]
                if (int(r["lex_vocab_version"] or 0) == new_version
                        and blob and len(blob) == corpus.lex_dim):
                    sig_rows[i] = np.frombuffer(blob, np.int8)
                elif r["txt"] is not None:
                    sig, _touched, dl = featurize.lexical_signatures_batch(
                        [r["txt"]], avgdl
                    )[0]
                    sig_rows[i] = sig
                    stale_updates.append(
                        (sig.tobytes(), int(dl), new_version, ids[i])
                    )
                    n_refeat += 1
            if stale_updates:
                with store.tx() as conn:
                    conn.executemany(
                        f"UPDATE {table} SET lex_sig=?, lex_dl=?, "
                        f"lex_vocab_version=? WHERE {id_col}=?",
                        stale_updates,
                    )
            live = corpus.set_lex_ids(ids, sig_rows)
            if live.any():
                nz = sig_rows[live] != 0
                df_acc += nz.sum(axis=0)
                n_live += int(live.sum())
            after = ids[-1]
        corpus.replace_doc_freq(df_acc)
        persist_lexical_meta(store, corpus)
        logger.info(
            "lex_vocab.adopted corpus=%s live_rows=%s refeaturized=%s "
            "version=%s", table, n_live, n_refeat, new_version,
        )


def _merge_counts(
    keys: np.ndarray, cnts: np.ndarray,
    new_keys: np.ndarray, new_cnts: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    merged_k = np.concatenate([keys, new_keys])
    merged_c = np.concatenate([cnts, new_cnts])
    order = np.argsort(merged_k, kind="stable")
    k = merged_k[order]
    c = merged_c[order]
    starts = np.flatnonzero(np.concatenate(([True], k[1:] != k[:-1])))
    return k[starts], np.add.reduceat(c, starts)


def build_vocab_from_store(
    store, head: int, *, batch: int = 2048, max_counter: int = 4_000_000,
    limit_docs: int = 0,
) -> np.ndarray:
    """Scan stored texts and return the sorted top-``head`` feature hashes
    by document frequency.

    The counter is a numpy merge-reduce (no per-feature Python dict ops);
    when it exceeds ``max_counter`` distinct features, singleton counts are
    pruned (space-saving-lite — top-df features are orders of magnitude
    above the prune floor, so the selection is unaffected in practice).
    ``limit_docs`` > 0 caps the scan per corpus for very large stores (df
    ranking of frequent features is robust under prefix sampling).
    """
    if head <= 0 or head >= int(settings.lexical_dim):
        raise ValueError(
            f"head must be in (0, lexical_dim): got {head} vs "
            f"dim {settings.lexical_dim}"
        )
    keys = np.zeros(0, dtype=np.uint64)
    cnts = np.zeros(0, dtype=np.int64)
    prune_floor = 1
    # Batches buffer until ~1M pending hashes, then merge once into the
    # sorted accumulator — merging per 2048-doc batch re-sorted the full
    # multi-million-key counter hundreds of times over a large store.
    pend_k: List[np.ndarray] = []
    pend_c: List[np.ndarray] = []
    pend_total = 0

    def _flush():
        nonlocal keys, cnts, pend_total, prune_floor
        if not pend_k:
            return
        keys, cnts = _merge_counts(
            keys, cnts, np.concatenate(pend_k), np.concatenate(pend_c)
        )
        pend_k.clear()
        pend_c.clear()
        pend_total = 0
        if keys.size > max_counter:
            keep = cnts > prune_floor
            # escalate the floor until the counter actually shrinks
            while keep.sum() > max_counter // 2:
                prune_floor += 1
                keep = cnts > prune_floor
            keys, cnts = keys[keep], cnts[keep]

    for table, id_col, text_col in CORPUS_COLUMNS:
        after = -1
        scanned = 0
        while True:
            with store.read() as conn:
                rows = conn.execute(
                    f"SELECT {id_col} AS id, {text_col} AS txt FROM {table} "
                    f"WHERE {id_col} > ? ORDER BY {id_col} LIMIT ?",
                    (after, batch),
                ).fetchall()
            if not rows:
                break
            raws = featurize.raw_lexical_features_batch(
                [r["txt"] for r in rows]
            )
            batch_hashes = (
                np.concatenate([h for h, _ in raws])
                if raws else np.zeros(0, dtype=np.uint64)
            )
            if batch_hashes.size:
                uniq, cnt = np.unique(batch_hashes, return_counts=True)
                pend_k.append(uniq)
                pend_c.append(cnt)
                pend_total += uniq.size
                if pend_total >= 1_000_000:
                    _flush()
            after = int(rows[-1]["id"])
            scanned += len(rows)
            if limit_docs and scanned >= limit_docs:
                break
    _flush()
    if keys.size == 0:
        return np.zeros(0, dtype=np.uint64)
    take = min(head, keys.size)
    # top-`head` by count, ties broken by hash for determinism
    order = np.lexsort((keys, -cnts))[:take]
    return np.sort(keys[order])


def apply_vocab_to_store(
    store, index, *, batch: int = 1024,
) -> Dict[str, Dict[str, int]]:
    """Re-featurize every stored document under the ACTIVE vocab: update
    store ``lex_sig``/``lex_dl``, scatter live device rows, rebuild each
    corpus's bucket df table, and persist index_meta. Doc lengths are
    layout-independent, so avgdl/dl_sum stand."""
    from ..ingest.ingest import persist_lexical_meta

    stats: Dict[str, Dict[str, int]] = {}
    for table, id_col, text_col in CORPUS_COLUMNS:
        corpus = index.corpus(table)
        df_acc = np.zeros(corpus.lex_dim, dtype=np.int64)
        # same fallback the ingest path uses before any stats exist
        avgdl = corpus.avgdl or 400.0
        after = -1
        n_store = 0
        n_live = 0
        while True:
            with store.read() as conn:
                rows = conn.execute(
                    f"SELECT {id_col} AS id, {text_col} AS txt FROM {table} "
                    f"WHERE {id_col} > ? ORDER BY {id_col} LIMIT ?",
                    (after, batch),
                ).fetchall()
            if not rows:
                break
            ids = [int(r["id"]) for r in rows]
            sigs = featurize.lexical_signatures_batch(
                [r["txt"] for r in rows], avgdl
            )
            version = featurize.active_vocab()[1]
            with store.tx() as conn:
                conn.executemany(
                    f"UPDATE {table} SET lex_sig=?, lex_dl=?, "
                    f"lex_vocab_version=? WHERE {id_col}=?",
                    [
                        (sig.tobytes(), int(dl), version, doc_id)
                        for (sig, _t, dl), doc_id in zip(sigs, ids)
                    ],
                )
            sig_rows = np.stack([s for s, _t, _dl in sigs])
            # routes hot (device scatter) and cold (host write) rows;
            # the returned mask covers BOTH tiers so df rebuilds over
            # every live row
            live = corpus.set_lex_ids(ids, sig_rows)
            if live.any():
                touched: List[np.ndarray] = [
                    t for (s, t, _dl), ok in zip(sigs, live) if ok
                ]
                if touched:
                    np.add.at(df_acc, np.concatenate(touched), 1)
                n_live += int(live.sum())
            n_store += len(ids)
            after = ids[-1]
        corpus.replace_doc_freq(df_acc)
        persist_lexical_meta(store, corpus)
        stats[table] = {"store_rows": n_store, "live_rows": n_live}
        logger.info(
            "lex_vocab.refeaturized corpus=%s store_rows=%s live_rows=%s",
            table, n_store, n_live,
        )
    return stats


def _stored_doc_count(store) -> int:
    total = 0
    with store.read() as conn:
        for table, _id, _txt in CORPUS_COLUMNS:
            total += int(
                conn.execute(f"SELECT COUNT(*) FROM {table}").fetchone()[0]
            )
    return total


def build_and_apply(
    store, index, *, head: Optional[int] = None, batch: int = 2048,
    limit_docs: int = 0,
) -> Dict:
    """The full operator flow: learn the vocab, persist it (unapplied),
    activate it, re-featurize the corpus, then mark it applied — so a
    crash mid-apply is DETECTED at the next activation (load_vocab
    refuses the dangling unapplied row) instead of silently serving
    mixed-layout signatures. Re-running this script is always the fix:
    it clears unapplied rows and re-featurizes everything.

    The activate+re-featurize window holds the vocab WRITE gate
    (featurize.vocab_gate): concurrent ingest/delete in this process
    blocks until the new layout is fully landed (queries keep serving —
    lexical scores are transiently mixed-layout while rows migrate);
    the learning scan runs gate-free (read-only)."""
    from ..utils import events

    with store.tx() as conn:
        conn.execute("DELETE FROM lex_vocab WHERE applied=0")
    head = int(head or settings.lex_vocab_head)
    with events.timed("vocab.learn"):
        hashes = build_vocab_from_store(
            store, head, batch=batch, limit_docs=limit_docs
        )
    if hashes.size == 0:
        return {"version": 0, "head": 0, "note": "no stored documents"}
    with featurize.vocab_gate.write():
        version = save_vocab(
            store, hashes, int(settings.lexical_dim),
            built_docs=_stored_doc_count(store),
        )
        featurize.set_active_vocab(hashes, version)
        with events.timed("vocab.apply"):
            stats = apply_vocab_to_store(
                store, index, batch=max(batch // 2, 256)
            )
        mark_applied(store, version)
    return {"version": version, "head": int(hashes.size), "corpora": stats}


# ------------------------------------------------------- auto-rebuild ----

def drift_stats(corpus, vocab: Optional[np.ndarray]) -> Dict[str, float]:
    """Head-vs-tail df drift: tail buckets hotter than the head's median
    mean frequent NEW features are hashing into the collision tail — the
    signal that the learned head no longer covers where the score mass
    lives (also surfaced per corpus in GET /index/stats)."""
    if vocab is None or vocab.size == 0:
        return {"hot_tail_buckets": 0, "head_median_df": 0.0}
    head = int(vocab.size)
    head_df = corpus.doc_freq[:head]
    tail_df = corpus.doc_freq[head:]
    nz = head_df[head_df > 0]
    if nz.size == 0 or tail_df.size == 0:
        return {"hot_tail_buckets": 0, "head_median_df": 0.0}
    median = float(np.median(nz))
    return {
        "hot_tail_buckets": int((tail_df > median).sum()),
        "head_median_df": median,
    }


_last_rebuild_check = 0.0


def auto_rebuild_if_needed(store, index, *, force_check: bool = False,
                           now: Optional[float] = None) -> Optional[Dict]:
    """Drift-triggered online vocab rebuild (LEX_VOCAB_AUTO_REBUILD).

    Called from the serving process's store-syncer loop (ingest/sync.py)
    — the one long-lived thread every serving process already runs.
    Fires when ALL hold:

    - a vocab exists, its drift signal (``drift_stats``) exceeds
      LEX_VOCAB_DRIFT_BUCKETS on the chunks corpus, AND live docs grew
      >= LEX_VOCAB_REBUILD_MIN_GROWTH x the active build's built_docs;
      or NO vocab exists and live docs >= LEX_VOCAB_BOOTSTRAP_DOCS > 0;
    - the last applied build is older than LEX_VOCAB_REBUILD_COOLDOWN_S;
    - the process is a single-process mesh (multi-process gangs stand
      down like prewarm/IVF — parallel/oplog.py).

    Returns the build summary when a rebuild ran, else None.
    """
    import time as _time

    global _last_rebuild_check
    if not settings.lex_vocab_auto_rebuild:
        return None
    now = _time.time() if now is None else now
    if not force_check and (
        now - _last_rebuild_check < float(settings.lex_vocab_rebuild_check_s)
    ):
        return None
    _last_rebuild_check = now
    if int(settings.dist_num_processes or 0) > 1:
        logger.warning(
            "lex_vocab.auto_rebuild_standdown multi-process gang — run "
            "scripts/build_lex_vocab offline across the fleet instead"
        )
        return None

    vocab, active = featurize.active_vocab()
    live_docs = int(index.chunks.live_count) + int(index.artifacts.live_count)
    if vocab is None:
        boot = int(settings.lex_vocab_bootstrap_docs)
        if boot <= 0 or live_docs < boot:
            return None
        reason = f"bootstrap live_docs={live_docs}>={boot}"
    else:
        drift = drift_stats(index.chunks, vocab)
        if drift["hot_tail_buckets"] < int(settings.lex_vocab_drift_buckets):
            return None
        with store.read() as conn:
            row = conn.execute(
                "SELECT built_docs, created_at FROM lex_vocab "
                "WHERE version=?", (active,),
            ).fetchone()
        built_docs = int(row["built_docs"]) if row else 0
        if built_docs and live_docs < built_docs * float(
            settings.lex_vocab_rebuild_min_growth
        ):
            return None
        if row:
            try:
                built_at = _dt.datetime.fromisoformat(
                    row["created_at"]
                ).timestamp()
            except ValueError:
                built_at = 0.0
            if now - built_at < float(settings.lex_vocab_rebuild_cooldown_s):
                return None
        reason = (
            f"drift hot_tail_buckets={drift['hot_tail_buckets']} "
            f"live_docs={live_docs} built_docs={built_docs}"
        )

    logger.warning("lex_vocab.auto_rebuild_start %s", reason)
    t0 = _time.time()
    # clamp: the head must leave a hashed tail (operator CLI refuses
    # instead, but an unattended trigger should do the sane thing)
    head = min(int(settings.lex_vocab_head), int(settings.lexical_dim) // 2)
    summary = build_and_apply(store, index, head=head)
    summary["trigger"] = reason
    summary["seconds"] = round(_time.time() - t0, 3)
    logger.warning("lex_vocab.auto_rebuild_done %s", summary)
    return summary
