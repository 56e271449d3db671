"""IVF as a serving dense mode: planner selection, freshness via the
overflow tail, and result parity with the exact scan."""

import numpy as np
import pytest

from cadence_rag_tpu.embed.pipeline import run_embedding_backfill
from cadence_rag_tpu.engine.planner import choose_dense_mode
from cadence_rag_tpu.engine.retrieve import retrieve_evidence
from cadence_rag_tpu.ingest.ingest import ingest_transcript
from cadence_rag_tpu.schemas import CallRef, ChunkingOptions, RetrieveRequest, UtteranceIn

OPTS = ChunkingOptions(target_tokens=8, max_tokens=20, overlap_tokens=0)

TOPICS = [
    "object store ECONNRESET retries on the gateway",
    "lenovo BOM pricing for the bake-off",
    "azure migration cutover runbook details",
    "SSD tiering latency improvements",
]


@pytest.fixture()
def ivf_corpus(tmp_store, monkeypatch):
    from cadence_rag_tpu.ingest.ingest import ingest_analysis
    from cadence_rag_tpu.schemas import AnalysisArtifactIn

    monkeypatch.setattr(tmp_store, "dense_ivf_enabled", True)
    monkeypatch.setattr(tmp_store, "ivf_min_rows", 8)  # tiny for tests
    for i in range(12):
        cid, _, _ = ingest_transcript(
            CallRef(external_id=f"ivf-{i}"),
            [UtteranceIn(speaker="A", start_ts_ms=0, end_ts_ms=900,
                         text=f"{TOPICS[i % len(TOPICS)]} variation {i}")],
            OPTS,
        )
    # BOTH corpora must be populated: an empty artifacts corpus routes
    # dispatch through the cold-start fallback, which serves a planner
    # "ivf" choice as ann — these tests must exercise the real packed
    # IVF dispatch (and the served-mode label that comes back from it)
    ingest_analysis(
        CallRef(external_id="ivf-0"),
        [AnalysisArtifactIn(kind="summary",
                            content="object store incident summary")],
    )
    run_embedding_backfill(batch_size=8)
    return tmp_store


class TestPlannerIvf:
    def test_mode_table_with_ivf(self, tmp_store, monkeypatch):
        monkeypatch.setattr(tmp_store, "dense_ivf_enabled", True)
        monkeypatch.setattr(tmp_store, "ivf_min_rows", 1000)
        # reference decision table unchanged when ivf not available
        assert choose_dense_mode(5000, scoped=False) == "ann"
        assert choose_dense_mode(500, scoped=True) == "exact"
        # ivf only above the row floor and when an index exists
        assert choose_dense_mode(5000, scoped=False, ivf_available=True) == "ivf"
        assert choose_dense_mode(500, scoped=False, ivf_available=True) == "ann"
        monkeypatch.setattr(tmp_store, "dense_ivf_enabled", False)
        assert choose_dense_mode(5000, scoped=False, ivf_available=True) == "ann"


class TestIvfServing:
    def test_ivf_mode_selected_and_results_match_ann(self, ivf_corpus):
        from cadence_rag_tpu.core.index import get_index

        index = get_index()
        req = RetrieveRequest(query="ECONNRESET object store gateway",
                              return_style="ids_only")
        baseline = retrieve_evidence(req)["retrieved_ids"]

        state = index.chunks.build_ivf(n_clusters=4, nprobe=4)
        assert state.built_count == index.chunks.count
        resp = retrieve_evidence(RetrieveRequest(
            query="ECONNRESET object store gateway", debug=True))
        assert resp["notes"]["retrieval"]["dense_modes"]["chunks"] == "ivf"
        # nprobe == n_clusters -> IVF scans every bucket: identical results
        ivf_ids = retrieve_evidence(req)["retrieved_ids"]
        assert ivf_ids == baseline

    def test_overflow_tail_keeps_new_rows_visible(self, ivf_corpus):
        from cadence_rag_tpu.core.index import get_index

        index = get_index()
        index.chunks.build_ivf(n_clusters=4, nprobe=4)
        ingest_transcript(
            CallRef(external_id="ivf-new"),
            [UtteranceIn(speaker="A", start_ts_ms=0, end_ts_ms=900,
                         text="freshly ingested zeppelin maintenance log")],
            OPTS,
        )
        run_embedding_backfill(batch_size=8)
        assert index.chunks.ivf.overflow_count >= 1
        resp = retrieve_evidence(RetrieveRequest(
            query="zeppelin maintenance log", debug=True))
        assert resp["notes"]["retrieval"]["dense_modes"]["chunks"] == "ivf"
        dense = resp["debug"]["lanes"]["chunks"]["dense"]
        assert dense, "post-build row must be reachable via the overflow tail"
        hit_ids = {row["chunk_id"] for row in dense}
        # the new chunk is the only zeppelin doc; dense lane must surface it
        from cadence_rag_tpu.store.db import get_store

        with get_store().read() as conn:
            row = conn.execute(
                "SELECT chunk_id FROM chunks WHERE text LIKE '%zeppelin%'"
            ).fetchone()
        assert int(row["chunk_id"]) in hit_ids

    def test_stale_ivf_falls_back_to_ann(self, ivf_corpus):
        from cadence_rag_tpu.core.index import get_index

        index = get_index()
        index.chunks.build_ivf(n_clusters=4, nprobe=2)
        # suppress the background auto-rebuild so staleness can accumulate
        index.chunks._ivf_rebuilding = True
        # flood the overflow past the built count -> ivf_usable() False
        for i in range(14):
            ingest_transcript(
                CallRef(external_id=f"flood-{i}"),
                [UtteranceIn(speaker="A", start_ts_ms=0, end_ts_ms=900,
                             text=f"flood row {i} about nothing in particular")],
                OPTS,
            )
        run_embedding_backfill(batch_size=8)
        assert not index.chunks.ivf_usable()
        resp = retrieve_evidence(RetrieveRequest(query="flood row", debug=True))
        assert resp["notes"]["retrieval"]["dense_modes"]["chunks"] == "ann"


class TestStartupBuild:
    def test_startup_builds_ivf_when_enabled(self, ivf_corpus, monkeypatch):
        from cadence_rag_tpu.core.index import get_index
        from cadence_rag_tpu.serve.api import startup

        assert get_index().chunks.ivf is None
        startup()
        index = get_index()
        assert index.chunks.ivf is not None
        assert index.chunks.ivf_usable()


class TestAutoRebuild:
    def test_background_rebuild_refreshes_index(self, ivf_corpus):
        import time

        from cadence_rag_tpu.core.index import get_index

        index = get_index()
        index.chunks.build_ivf(n_clusters=4, nprobe=4)
        built_before = index.chunks.ivf.built_count
        # push overflow past built/2 -> triggers the background rebuild
        for i in range(10):
            ingest_transcript(
                CallRef(external_id=f"auto-{i}"),
                [UtteranceIn(speaker="A", start_ts_ms=0, end_ts_ms=900,
                             text=f"auto rebuild filler row {i}")],
                OPTS,
            )
        run_embedding_backfill(batch_size=8)
        deadline = time.time() + 60
        while time.time() < deadline:
            state = index.chunks.ivf
            if state and state.built_count > built_before:
                break
            time.sleep(0.2)
        state = index.chunks.ivf
        assert state.built_count > built_before, (
            state.built_count, built_before, state.overflow_count
        )
        # serving still correct after the swap
        resp = retrieve_evidence(RetrieveRequest(
            query="auto rebuild filler", return_style="ids_only"))
        assert resp["retrieved_ids"]


class TestDiagnosticsSurface:
    def test_diagnostics_reports_ivf(self, ivf_corpus):
        from cadence_rag_tpu.core.index import get_index
        from cadence_rag_tpu.serve.testing import TestClient

        get_index().chunks.build_ivf(n_clusters=4, nprobe=2)
        client = TestClient(run_startup=False)
        body = client.get("/diagnostics").json()
        ivf = body["index"]["ivf"]
        assert ivf["n_clusters"] == 4 and ivf["usable"] is True
        assert body["index"]["mesh"] is None


class TestMidFlightInvalidation:
    def test_notes_report_served_mode_after_downgrade(self, ivf_corpus):
        """Planner picks ivf; a compaction invalidates the index before
        dispatch; the response notes must report the mode that actually
        SERVED (ann), not the planned label (review finding)."""
        from cadence_rag_tpu.core.index import get_index
        from cadence_rag_tpu.engine import retrieve as eng

        index = get_index()
        index.chunks.build_ivf(n_clusters=4, nprobe=4)
        req = RetrieveRequest(query="ECONNRESET object store gateway",
                              return_style="ids_only", debug=True)
        plans = eng._prepare_plans([req])
        assert plans[0].chunk_mode == "ivf"
        index.chunks.ivf = None  # what a mid-flight compaction does
        responses = eng._finish_plans(plans, eng._dispatch_plans(plans))
        modes = responses[0]["debug"]["dense"]["modes"]
        assert modes["chunks"] == "ann"
        assert responses[0]["retrieved_ids"]

    def test_build_aborts_when_compaction_renumbers_rows(
            self, ivf_corpus, monkeypatch):
        """A compaction/restore that renumbers rows while k-means runs
        outside the lock must abort the build — installing buckets built
        from pre-compact positions would silently return wrong doc_ids
        from the dense lane (review finding)."""
        import cadence_rag_tpu.core.index as index_mod
        from cadence_rag_tpu.core.index import get_index

        corpus = get_index().chunks
        real_kmeans = index_mod.kmeans

        def racing_kmeans(*args, **kwargs):
            corpus._pos_gen += 1  # a compaction landed mid-clustering
            return real_kmeans(*args, **kwargs)

        monkeypatch.setattr(index_mod, "kmeans", racing_kmeans)
        with pytest.raises(RuntimeError, match="row positions changed"):
            corpus.build_ivf(n_clusters=4, nprobe=4)
        assert corpus.ivf is None  # nothing stale installed


@pytest.fixture()
def ivf_corpus_int8(tmp_store, monkeypatch):
    """Same corpus as ivf_corpus but with int8 embedding storage —
    the IVF probed path must work under quantized rows (k-means runs on
    the DEQUANTIZED snapshot, probed scores rescale by 1/127)."""
    from cadence_rag_tpu.ingest.ingest import ingest_analysis
    from cadence_rag_tpu.schemas import AnalysisArtifactIn

    monkeypatch.setattr(tmp_store, "index_embedding_dtype", "int8")
    monkeypatch.setattr(tmp_store, "dense_ivf_enabled", True)
    monkeypatch.setattr(tmp_store, "ivf_min_rows", 8)
    for i in range(12):
        ingest_transcript(
            CallRef(external_id=f"ivf8-{i}"),
            [UtteranceIn(speaker="A", start_ts_ms=0, end_ts_ms=900,
                         text=f"{TOPICS[i % len(TOPICS)]} variation {i}")],
            OPTS,
        )
    ingest_analysis(
        CallRef(external_id="ivf8-0"),
        [AnalysisArtifactIn(kind="summary",
                            content="object store incident summary")],
    )
    run_embedding_backfill(batch_size=8)
    return tmp_store


class TestIvfInt8:
    def test_int8_storage_active(self, ivf_corpus_int8):
        import jax.numpy as jnp

        from cadence_rag_tpu.core.index import get_index

        assert get_index().chunks.emb.dtype == jnp.int8

    def test_ivf_parity_under_int8(self, ivf_corpus_int8):
        """nprobe == n_clusters scans every bucket: results must match
        the (int8) exact path exactly — the probed gather + 1/127
        rescale is ranking-neutral."""
        from cadence_rag_tpu.core.index import get_index

        index = get_index()
        req = RetrieveRequest(query="ECONNRESET object store gateway",
                              return_style="ids_only")
        baseline = retrieve_evidence(req)["retrieved_ids"]
        state = index.chunks.build_ivf(n_clusters=4, nprobe=4)
        assert state.built_count == index.chunks.count
        resp = retrieve_evidence(RetrieveRequest(
            query="ECONNRESET object store gateway", debug=True))
        assert resp["notes"]["retrieval"]["dense_modes"]["chunks"] == "ivf"
        assert retrieve_evidence(req)["retrieved_ids"] == baseline

    def test_overflow_visibility_under_int8(self, ivf_corpus_int8):
        from cadence_rag_tpu.core.index import get_index

        index = get_index()
        index.chunks.build_ivf(n_clusters=4, nprobe=4)
        ingest_transcript(
            CallRef(external_id="ivf8-new"),
            [UtteranceIn(speaker="A", start_ts_ms=0, end_ts_ms=900,
                         text="freshly ingested zeppelin maintenance log")],
            OPTS,
        )
        run_embedding_backfill(batch_size=8)
        assert index.chunks.ivf.overflow_count >= 1
        resp = retrieve_evidence(RetrieveRequest(
            query="zeppelin maintenance log", debug=True))
        dense = resp["debug"]["lanes"]["chunks"]["dense"]
        assert dense, "overflow row must stay reachable under int8"
