"""Store -> device-index live sync (ingest/sync.py).

The gap this closes: a standalone worker's store writes were invisible
to a serving process until restart. These tests drive the
mutation log + StoreSyncer in one process by flipping store-only mode
(exactly what the worker daemon does); the true cross-process topology is
covered by test_worker_api_coherence.py.
"""

import numpy as np
import pytest

from cadence_rag_tpu.core.index import get_index
from cadence_rag_tpu.embed.pipeline import run_embedding_backfill
from cadence_rag_tpu.engine.retrieve import retrieve_evidence
from cadence_rag_tpu.ingest.ingest import (
    delete_call,
    ingest_analysis,
    ingest_transcript,
    set_store_only,
)
from cadence_rag_tpu.ingest.sync import StoreSyncer, get_syncer
from cadence_rag_tpu.schemas import (
    AnalysisArtifactIn,
    CallRef,
    ChunkingOptions,
    RetrieveRequest,
    UtteranceIn,
)
from cadence_rag_tpu.store.db import get_store

OPTS = ChunkingOptions(target_tokens=10, max_tokens=30, overlap_tokens=2)


def _ingest_one(external_id: str, text: str) -> str:
    call_id, _, n_chunks = ingest_transcript(
        CallRef(external_id=external_id),
        [UtteranceIn(speaker="W", start_ts_ms=0, end_ts_ms=900, text=text)],
        OPTS,
    )
    assert n_chunks >= 1
    return call_id


class TestStoreOnlyIngest:
    def test_store_only_skips_device_insert(self, tmp_store):
        set_store_only(True)
        _ingest_one("so-1", "kafka consumer lag after the rebalance")
        index = get_index()
        assert index.chunks.count == 0  # device untouched
        with get_store().read() as conn:
            n = conn.execute("SELECT COUNT(*) FROM chunks").fetchone()[0]
            muts = conn.execute(
                "SELECT COUNT(*) FROM index_mutations WHERE op='insert'"
            ).fetchone()[0]
        assert n >= 1 and muts >= n

    def test_poll_makes_worker_rows_retrievable(self, tmp_store):
        set_store_only(True)  # "worker process" writes
        _ingest_one("so-2", "the ECONNRESET fix landed in v2.3.1")
        ingest_analysis(
            CallRef(external_id="so-2"),
            [AnalysisArtifactIn(kind="summary",
                                content="ECONNRESET fixed by rollback")],
        )
        set_store_only(False)  # back to the "serving process"
        req = RetrieveRequest(query="ECONNRESET v2.3.1",
                              return_style="ids_only")
        assert retrieve_evidence(req)["retrieved_ids"] == []

        counts = get_syncer().poll_once()
        assert counts["inserted"] >= 2
        ids = retrieve_evidence(req)["retrieved_ids"]
        assert any(i.startswith("chunk:") for i in ids)
        assert any(i.startswith("artifact_chunk:") for i in ids)
        # second poll is a no-op (watermark advanced)
        assert get_syncer().poll_once() == {}

    def test_poll_applies_external_embedding_backfill(self, tmp_store):
        set_store_only(True)
        _ingest_one("so-3", "object store tiering to SSD approved")
        run_embedding_backfill(batch_size=8)  # store-only: blobs + log only
        set_store_only(False)
        counts = get_syncer().poll_once()
        assert counts["inserted"] >= 1
        index = get_index()
        # embedding arrived with the insert (current row state)
        assert index.chunks.emb_rows >= 1
        resp = retrieve_evidence(
            RetrieveRequest(query="tiering to SSD", debug=True)
        )
        assert resp["notes"]["retrieval"]["lanes"]["dense"] is True

    def test_backfill_after_insert_scatters(self, tmp_store):
        # row synced first WITHOUT embedding, then an external backfill
        # updates it -> the update mutation re-scatters
        set_store_only(True)
        _ingest_one("so-4", "certificate expiry caused the outage window")
        set_store_only(False)
        assert get_syncer().poll_once()["inserted"] >= 1
        index = get_index()
        assert index.chunks.emb_rows == 0

        set_store_only(True)
        run_embedding_backfill(batch_size=8)
        set_store_only(False)
        counts = get_syncer().poll_once()
        assert counts["updated"] >= 1
        assert index.chunks.emb_rows >= 1

    def test_poll_applies_external_delete(self, tmp_store):
        call_a = _ingest_one("so-5", "quota exhaustion throttled the export")
        _ingest_one("so-6", "postgres vacuum stalls on the ledger table")
        index = get_index()
        before_df = index.chunks.doc_freq.sum()
        get_syncer().poll_once()  # drain local-ingest entries
        with get_store().read() as conn:
            dead = {
                f"chunk:{r[0]}" for r in conn.execute(
                    "SELECT chunk_id FROM chunks WHERE call_id = ?",
                    (call_a,),
                )
            }
        req = RetrieveRequest(query="quota exhaustion export",
                              return_style="ids_only")
        assert dead & set(retrieve_evidence(req)["retrieved_ids"])

        set_store_only(True)  # delete from a "worker"-like process
        delete_call(call_a)
        set_store_only(False)
        counts = get_syncer().poll_once()
        assert counts["deleted"] >= 1
        ids = set(retrieve_evidence(req)["retrieved_ids"])
        assert not (dead & ids)  # tombstoned rows invisible to every lane
        # df mass shed using the lex_sig captured by the delete trigger
        assert index.chunks.doc_freq.sum() < before_df

    def test_poll_mid_delete_does_not_resurrect(self, tmp_store):
        """delete_call tombstones the device BEFORE its store commit; a
        poll landing in that window (insert entries unconsumed, store
        rows still present, device rows already tombstoned) must NOT
        re-insert the rows. Caught live as a flaky count divergence in
        the multihost gang test (oracle 120 vs gang 96: the oracle's
        background syncer resurrected the 24 just-deleted chunks)."""
        call_a = _ingest_one("mid-1", "kafka timeout incident on svc zero")
        index = get_index()
        with get_store().read() as conn:
            ids = [int(r[0]) for r in conn.execute(
                "SELECT chunk_id FROM chunks WHERE call_id = ?", (call_a,),
            )]
        assert ids
        # open the window: device tombstoned, store delete not yet
        # committed, insert mutations not yet consumed (fresh syncer)
        index.chunks.delete_ids(ids)
        n = index.chunks.count
        fresh = StoreSyncer()
        assert fresh.poll_once().get("inserted", 0) == 0
        assert index.chunks.count == n
        assert not index.chunks.contains(ids).any()
        # reconcile in the same window must not resurrect either
        assert fresh.reconcile().get("inserted", 0) == 0
        assert not index.chunks.contains(ids).any()

    def test_local_ingest_not_reapplied(self, tmp_store):
        """The serving process's own writes hit the log too; the poll
        must skip them (dedupe by doc_id, no re-scatter for pure
        inserts)."""
        _ingest_one("so-7", "lenovo BOM finalized for the bake-off")
        index = get_index()
        n = index.chunks.count
        counts = get_syncer().poll_once()
        assert counts.get("inserted", 0) == 0
        assert counts.get("updated", 0) == 0
        assert index.chunks.count == n

    def test_insert_dedupe_under_race_order(self, tmp_store):
        """Syncer inserts first, local path inserts second: the second
        corpus.insert must be a no-op (doc_id dedupe in
        _insert_locked)."""
        from cadence_rag_tpu.ingest.ingest import (
            DOC_ROW_SELECT,
            doc_row_from_store_row,
        )

        _ingest_one("so-8", "gateway upgrade caused the ECONNRESET storm")
        index = get_index()
        n = index.chunks.count
        with get_store().read() as conn:
            rows = conn.execute(
                DOC_ROW_SELECT.format(id_col="chunk_id", table="chunks",
                                      text_col="text")
            ).fetchall()
        index.chunks.insert([doc_row_from_store_row(r) for r in rows])
        assert index.chunks.count == n  # all duplicates dropped


class TestReconcile:
    def test_reconcile_inserts_missing_and_deletes_extra(self, tmp_store):
        call_a = _ingest_one("rc-1", "kafka consumer lag after rebalance")
        syncer = get_syncer()
        syncer.poll_once()
        index = get_index()
        with get_store().read() as conn:
            dead = {
                f"chunk:{r[0]}" for r in conn.execute(
                    "SELECT chunk_id FROM chunks WHERE call_id = ?",
                    (call_a,),
                )
            }

        # simulate a stale restore: a row the store no longer has ...
        set_store_only(True)
        delete_call(call_a)
        # ... and a store row the index doesn't have
        _ingest_one("rc-2", "object store tiering cut checkout latency")
        run_embedding_backfill(batch_size=8)
        set_store_only(False)

        counts = syncer.reconcile()
        assert counts["inserted"] >= 1
        assert counts["deleted"] >= 1
        ids = retrieve_evidence(
            RetrieveRequest(query="tiering checkout latency",
                            return_style="ids_only")
        )["retrieved_ids"]
        assert ids
        gone = set(retrieve_evidence(
            RetrieveRequest(query="kafka consumer lag",
                            return_style="ids_only")
        )["retrieved_ids"])
        assert not (dead & gone)
        assert index.chunks.emb_rows >= 1

    def test_prune_respects_slowest_consumer(self, tmp_store):
        fast = get_syncer()
        slow = StoreSyncer()
        slow._heartbeat()  # registers at seq 0
        _ingest_one("pr-1", "certificate expiry outage window")
        fast.poll_once()
        with get_store().read() as conn:
            remaining = conn.execute(
                "SELECT COUNT(*) FROM index_mutations"
            ).fetchone()[0]
        assert remaining > 0  # slow consumer still needs them
        slow.poll_once()
        fast.poll_once()
        with get_store().read() as conn:
            remaining = conn.execute(
                "SELECT COUNT(*) FROM index_mutations"
            ).fetchone()[0]
        assert remaining == 0


class TestBackgroundLoop:
    def test_background_thread_applies_within_interval(self, tmp_store):
        import time

        syncer = get_syncer()
        syncer.start(0.05)
        try:
            set_store_only(True)
            _ingest_one("bg-1", "vacuum stalls on the ledger table")
            set_store_only(False)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                ids = retrieve_evidence(
                    RetrieveRequest(query="vacuum ledger table",
                                    return_style="ids_only")
                )["retrieved_ids"]
                if ids:
                    break
                time.sleep(0.05)
            assert ids
        finally:
            syncer.stop()


class TestSyncRobustness:
    def test_poison_embedding_blob_does_not_wedge(self, tmp_store, caplog):
        """A writer with a mismatched EMBEDDINGS_DIM (or a truncated
        blob) logs an update mutation whose vector cannot be applied;
        the syncer must skip it and keep advancing the watermark — one
        poison row must not stall ALL sync progress forever."""
        call_a = _ingest_one("poison-1", "grpc deadline exceeded in auth")
        syncer = get_syncer()
        syncer.poll_once()
        index = get_index()
        with get_store().read() as conn:
            cid = int(conn.execute(
                "SELECT chunk_id FROM chunks WHERE call_id=?", (call_a,)
            ).fetchone()[0])
        # wrong-length embedding blob, written store-side (triggers log
        # an update mutation)
        with get_store().tx() as conn:
            conn.execute(
                "UPDATE chunks SET embedding=? WHERE chunk_id=?",
                (np.ones(7, np.float32).tobytes(), cid),
            )
        counts = syncer.poll_once()  # must not raise
        assert any("bad_embedding_blob" in r.message
                   for r in caplog.records)
        # watermark advanced: a subsequent good mutation still applies
        _ingest_one("poison-2", "redis eviction spike on cache nine")
        set_store_only(True)
        _ingest_one("poison-3", "dns resolution flap in the edge pop")
        set_store_only(False)
        counts = syncer.poll_once()
        assert counts.get("inserted", 0) >= 1

    def test_deleted_blacklist_pruned_after_log_consumed(self, tmp_store):
        """deleted_ids exists to close the mid-delete resurrection
        window; once the delete's log entry is behind the watermark the
        id can never resurrect, so the blacklist is pruned (it would
        otherwise grow forever on churn-heavy corpora)."""
        call_a = _ingest_one("prune-1", "s3 multipart upload checksum bug")
        index = get_index()
        syncer = get_syncer()
        syncer.poll_once()
        delete_call(call_a)
        assert index.chunks.deleted_ids  # window open: blacklisted
        syncer.poll_once()  # consumes the delete log entries
        assert not index.chunks.deleted_ids  # pruned once durable
