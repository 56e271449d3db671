"""Delete path + compaction (tombstones, periodic rewrite, filters still
correct afterwards). No reference counterpart —
the reference has no delete either; this is new framework surface."""

import numpy as np
import pytest

from cadence_rag_tpu.core.index import get_index
from cadence_rag_tpu.embed.pipeline import run_embedding_backfill
from cadence_rag_tpu.engine.retrieve import retrieve_evidence
from cadence_rag_tpu.ingest.ingest import (
    delete_call,
    ingest_analysis,
    ingest_transcript,
)
from cadence_rag_tpu.schemas import (
    AnalysisArtifactIn,
    CallRef,
    ChunkingOptions,
    RetrieveFilters,
    RetrieveRequest,
    UtteranceIn,
)
from cadence_rag_tpu.utils.errors import ApiError

OPTS = ChunkingOptions(target_tokens=10, max_tokens=30, overlap_tokens=0)


def _call(ext, texts, tags=None, artifacts=()):
    cid, _, _ = ingest_transcript(
        CallRef(external_id=ext, tags=tags),
        [UtteranceIn(speaker="A", start_ts_ms=i * 1000,
                     end_ts_ms=i * 1000 + 900, text=t)
         for i, t in enumerate(texts)],
        OPTS,
    )
    if artifacts:
        ingest_analysis(
            CallRef(call_id=cid),
            [AnalysisArtifactIn(kind=k, content=c) for k, c in artifacts],
        )
    return cid


@pytest.fixture()
def corpus(tmp_store):
    a = _call("del-a", ["the ECONNRESET storm hit the object store gateway",
                        "rolling back to v2.3.1 stopped the resets"],
              tags=["infra"],
              artifacts=[("summary", "ECONNRESET traced to the upgrade.")])
    b = _call("del-b", ["lenovo BOM for the bake-off against dell",
                        "supermicro is the incumbent on density"],
              tags=["sales"])
    run_embedding_backfill(batch_size=8)
    return {"a": a, "b": b}


class TestDelete:
    def test_deleted_call_invisible_everywhere(self, corpus):
        req = RetrieveRequest(query="ECONNRESET object store gateway")
        before = retrieve_evidence(req)
        assert any(q["call_id"] == corpus["a"] for q in before["quotes"])

        out = delete_call(corpus["a"])
        assert out["chunks_deleted"] >= 1
        assert out["artifact_chunks_deleted"] >= 1

        after = retrieve_evidence(req)
        assert all(q["call_id"] != corpus["a"] for q in after["quotes"])
        assert all(a["call_id"] != corpus["a"] for a in after["artifacts"])
        # other call still retrievable
        resp = retrieve_evidence(RetrieveRequest(query="lenovo BOM bake-off"))
        assert any(q["call_id"] == corpus["b"] for q in resp["quotes"])

    def test_unknown_call_404(self, corpus):
        with pytest.raises(ApiError) as err:
            delete_call("00000000-0000-4000-8000-000000000000")
        assert err.value.status == 404

    def test_store_rows_gone_and_tag_index_cleaned(self, corpus, tmp_store):
        from cadence_rag_tpu.store.db import get_store

        delete_call(corpus["a"])
        with get_store().read() as conn:
            for table in ("calls", "chunks", "artifact_chunks", "utterances"):
                n = conn.execute(
                    f"SELECT COUNT(*) FROM {table} WHERE call_id = ?",
                    (corpus["a"],),
                ).fetchone()[0]
                assert n == 0, table
        resp = retrieve_evidence(
            RetrieveRequest(query="ECONNRESET gateway",
                            filters=RetrieveFilters(call_tags=["infra"]))
        )
        assert resp["quotes"] == []

    def test_delete_via_http(self, corpus):
        from cadence_rag_tpu.serve.testing import TestClient

        client = TestClient()
        resp = client.delete(f"/calls/{corpus['a']}")
        assert resp.status_code == 200
        assert resp.json()["chunks_deleted"] >= 1
        resp = client.delete(f"/calls/{corpus['a']}")
        assert resp.status_code == 404
        resp = client.delete("/calls/not-a-uuid")
        assert resp.status_code == 422


class TestCompaction:
    def test_compaction_preserves_results_and_filters(self, tmp_store):
        keep_ids, drop_ids = [], []
        for i in range(12):
            cid = _call(
                f"cmp-{i}",
                [f"call {i} about the {'tiering SSD latency' if i % 2 else 'azure migration runbook'} topic",
                 f"second utterance {i} with ECONNRESET v2.{i % 9}.1"],
                tags=["even" if i % 2 == 0 else "odd"],
            )
            (keep_ids if i % 2 else drop_ids).append(cid)
        run_embedding_backfill(batch_size=16)
        index = get_index()
        count_before = index.chunks.count

        for cid in drop_ids:
            delete_call(cid)
        assert index.chunks.tombstones > 0
        index.chunks.compact()
        index.artifacts.compact()
        assert index.chunks.tombstones == 0
        assert index.chunks.count < count_before
        assert index.chunks.count == index.chunks.live_count

        # retrieval + tag filters still correct after row positions moved
        resp = retrieve_evidence(
            RetrieveRequest(query="tiering SSD latency",
                            filters=RetrieveFilters(call_tags=["odd"]))
        )
        assert resp["quotes"]
        for q in resp["quotes"]:
            assert q["call_id"] in keep_ids
        resp = retrieve_evidence(
            RetrieveRequest(query="azure migration runbook")
        )
        for q in resp["quotes"]:
            assert q["call_id"] in keep_ids

    def test_insert_after_compact(self, tmp_store):
        cids = [
            _call(f"ic-{i}", [f"utterance {i} about the object store"])
            for i in range(4)
        ]
        run_embedding_backfill(batch_size=8)
        for cid in cids[:2]:
            delete_call(cid)
        index = get_index()
        index.chunks.compact()
        new_cid = _call("ic-new", ["fresh call about SSD tiering economics"])
        run_embedding_backfill(batch_size=8)
        resp = retrieve_evidence(
            RetrieveRequest(query="SSD tiering economics")
        )
        assert any(q["call_id"] == new_cid for q in resp["quotes"])

    def test_maybe_compact_threshold(self, tmp_store):
        index = get_index()
        cid = _call("th-1", ["threshold call about the gateway"])
        run_embedding_backfill(batch_size=8)
        assert index.chunks.maybe_compact() is False  # below floor
        delete_call(cid)
        # tombstones small: still below the 64-row floor
        assert index.chunks.maybe_compact() is False
