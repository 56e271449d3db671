"""End-to-end engine tests: ingest -> device index -> retrieve_evidence.

Coverage model: reference tests/integration/test_ingest_retrieve.py
(evidence pack, filter scoping, ids_only determinism, budget enforcement,
lexical_only degradation, transcript idempotency) — exercised here at the
Python engine level; HTTP-level versions live in test_api.py.
"""

import numpy as np
import pytest

from cadence_rag_tpu.embed.pipeline import run_embedding_backfill
from cadence_rag_tpu.engine.retrieve import retrieve_evidence
from cadence_rag_tpu.ingest.ingest import (
    ingest_analysis,
    ingest_call,
    ingest_transcript,
    rebuild_index_from_store,
)
from cadence_rag_tpu.schemas import (
    AnalysisArtifactIn,
    Budget,
    CallRef,
    ChunkingOptions,
    RetrieveFilters,
    RetrieveRequest,
    UtteranceIn,
)

OPTS = ChunkingOptions(target_tokens=30, max_tokens=60, overlap_tokens=5)


def _mk_call(tmp_store, title, texts, external_id=None, tags=None,
             started_at=None, artifacts=()):
    ref = CallRef(
        title=title, external_id=external_id, tags=tags, started_at=started_at
    )
    utts = [
        UtteranceIn(
            speaker=["Ana", "Raj"][i % 2],
            start_ts_ms=i * 5000,
            end_ts_ms=i * 5000 + 4500,
            text=t,
        )
        for i, t in enumerate(texts)
    ]
    call_id, n_utt, n_chunks = ingest_transcript(ref, utts, OPTS)
    if artifacts:
        ingest_analysis(
            CallRef(call_id=call_id),
            [AnalysisArtifactIn(kind=k, content=c) for k, c in artifacts],
        )
    return call_id, n_utt, n_chunks


CALL_A_TEXTS = [
    "we saw ECONNRESET errors from the object store gateway last night",
    "the lenovo build needs a new BOM before the bake-off with dell",
    "tiering to SSD fixed the latency spike on the ingest path",
    "let's schedule the azure migration review for next sprint",
]
CALL_B_TEXTS = [
    "quarterly pipeline review went well, acme is moving to stage four",
    "the customer asked about pricing for the supermicro variant",
    "legal needs the updated msa before we can countersign",
    "renewal forecast looks strong for the emea region this quarter",
]


@pytest.fixture()
def corpus(tmp_store):
    call_a, _, _ = _mk_call(
        tmp_store, "infra debrief", CALL_A_TEXTS, external_id="ext-A",
        artifacts=[
            ("action_items", "- send BOM to lenovo\n- verify ECONNRESET fix\n"),
            ("summary", "Team debugged object store resets and agreed on SSD tiering."),
        ],
    )
    call_b, _, _ = _mk_call(
        tmp_store, "sales sync", CALL_B_TEXTS, external_id="ext-B",
        tags=["sales"],
    )
    run_embedding_backfill(batch_size=8)
    return {"a": call_a, "b": call_b}


class TestRetrieveEvidencePack:
    def test_pack_shape_and_relevance(self, corpus):
        resp = retrieve_evidence(
            RetrieveRequest(query="ECONNRESET object store errors")
        )
        assert resp["intent"] == "auto"
        assert resp["quotes"], "expected transcript quotes"
        top_quote = resp["quotes"][0]
        assert "ECONNRESET" in top_quote["snippet"] or "object store" in top_quote["snippet"]
        assert top_quote["evidence_id"].startswith("Q-")
        assert resp["notes"]["retrieval"]["planner"] in ("exact", "ann")
        assert "ECONNRESET" in resp["notes"]["retrieval"]["tech_tokens"]
        # artifacts mention the fix too
        assert any("ECONNRESET" in a["snippet"] for a in resp["artifacts"])

    def test_many_query_identifiers_still_match(self, tmp_store):
        """The old fixed-Q layout silently truncated queries at 8
        identifiers; the slot-addressed structure
        matches well beyond that, and any residual overflow is surfaced
        in notes.retrieval.tech_tokens_dropped instead of silent."""
        from cadence_rag_tpu.ingest.ingest import ingest_transcript
        from cadence_rag_tpu.schemas import CallRef, ChunkingOptions, UtteranceIn

        ingest_transcript(
            CallRef(external_id="manytok"),
            [UtteranceIn(speaker="A", start_ts_ms=0, end_ts_ms=900,
                         text="the fix shipped in JIRA-7749 yesterday")],
            ChunkingOptions(target_tokens=10, max_tokens=30,
                            overlap_tokens=0),
        )
        # 14 extractable decoys + the real identifier LAST — position 15
        # was beyond the old cap
        decoys = " ".join(f"SVC-{1000 + i}" for i in range(14))
        resp = retrieve_evidence(RetrieveRequest(
            query=f"status of {decoys} JIRA-7749", debug=True,
        ))
        tech_lane = resp["debug"]["lanes"]["chunks"]["tech_tokens"]
        assert tech_lane, "identifier past position 8 must still match"
        notes = resp["notes"]["retrieval"]
        assert len(notes["tech_tokens"]) >= 15
        assert notes["tech_tokens_dropped"] == 0

    def test_filter_scoping_by_call(self, corpus):
        resp = retrieve_evidence(
            RetrieveRequest(
                query="ECONNRESET object store",
                filters=RetrieveFilters(call_ids=[corpus["b"]]),
            )
        )
        for q in resp["quotes"]:
            assert q["call_id"] == corpus["b"]

    def test_filter_by_external_id(self, corpus):
        resp = retrieve_evidence(
            RetrieveRequest(
                query="pipeline review quarterly",
                filters=RetrieveFilters(external_id="ext-B"),
            )
        )
        assert resp["quotes"]
        for q in resp["quotes"]:
            assert q["call_id"] == corpus["b"]

    def test_filter_by_tags(self, corpus):
        resp = retrieve_evidence(
            RetrieveRequest(
                query="supermicro pricing",
                filters=RetrieveFilters(call_tags=["sales"]),
            )
        )
        assert resp["quotes"]
        for q in resp["quotes"]:
            assert q["call_id"] == corpus["b"]

    def test_budget_enforcement(self, corpus):
        resp = retrieve_evidence(
            RetrieveRequest(
                query="ECONNRESET lenovo BOM SSD tiering azure",
                budget=Budget(max_evidence_items=3, max_total_chars=200),
            )
        )
        total_items = len(resp["artifacts"]) + len(resp["quotes"])
        assert total_items <= 3
        total_chars = sum(len(a["snippet"]) for a in resp["artifacts"]) + sum(
            len(q["snippet"]) for q in resp["quotes"]
        )
        assert total_chars <= 200 + 3  # ellipsis slack

    def test_max_two_artifacts_and_quotes_per_call(self, corpus):
        resp = retrieve_evidence(
            RetrieveRequest(query="ECONNRESET BOM lenovo object store SSD")
        )
        assert len(resp["artifacts"]) <= 2
        per_call = {}
        for q in resp["quotes"]:
            per_call[q["call_id"]] = per_call.get(q["call_id"], 0) + 1
        assert all(v <= 2 for v in per_call.values())


class TestIdsOnlyAndDebug:
    def test_ids_only_deterministic(self, corpus):
        req = RetrieveRequest(
            query="object store tiering SSD", return_style="ids_only"
        )
        first = retrieve_evidence(req)["retrieved_ids"]
        second = retrieve_evidence(req)["retrieved_ids"]
        assert first == second
        assert first, "expected hits"
        assert all(":" in rid for rid in first)

    def test_ids_only_fast_path_matches_per_plan_assembly(
        self, corpus, monkeypatch
    ):
        """The batched native ids_only assembler must return EXACTLY the
        per-plan ``_assemble`` output (same ids, same order) on a mixed
        batch including an empty query and a filtered query."""
        from cadence_rag_tpu.engine import retrieve as retrieve_mod
        from cadence_rag_tpu.native import rrf as native_rrf

        if not native_rrf.available():
            pytest.skip("native rrf core unavailable")
        reqs = [
            RetrieveRequest(query="object store tiering SSD",
                            return_style="ids_only"),
            RetrieveRequest(query="", return_style="ids_only"),
            RetrieveRequest(
                query="pipeline review acme", return_style="ids_only",
                filters=RetrieveFilters(call_ids=[corpus["b"]]),
            ),
            RetrieveRequest(query="ECONNRESET rollback",
                            return_style="ids_only"),
        ]
        fast = retrieve_mod.retrieve_evidence_batch(reqs)
        assert any(r["retrieved_ids"] for r in fast)
        monkeypatch.setattr(native_rrf, "ids_only_format",
                            lambda *a, **k: None)
        slow = retrieve_mod.retrieve_evidence_batch(reqs)
        for f, s in zip(fast, slow):
            assert f["retrieved_ids"] == s["retrieved_ids"]

    def test_debug_lanes_present(self, corpus):
        resp = retrieve_evidence(
            RetrieveRequest(query="ECONNRESET errors", debug=True)
        )
        dbg = resp["debug"]
        assert set(dbg["lanes"]) == {"chunks", "artifacts"}
        assert "bm25" in dbg["lanes"]["chunks"]
        assert "dense" in dbg["lanes"]["chunks"]
        assert dbg["dense"]["enabled"] is True
        assert dbg["timings_ms"]["device_ms"] >= 0
        for row in dbg["lanes"]["chunks"]["bm25"]:
            assert set(row) == {"chunk_id", "rank", "score"}


class TestDegradeLadder:
    def test_lexical_only_when_no_provider(self, corpus, monkeypatch):
        from cadence_rag_tpu.config import settings

        monkeypatch.setattr(settings, "embeddings_provider", "")
        monkeypatch.setattr(settings, "embeddings_base_url", "")
        resp = retrieve_evidence(RetrieveRequest(query="ECONNRESET object store"))
        assert resp["notes"]["retrieval"]["planner"] == "lexical_only"
        assert resp["quotes"], "lexical lanes must still serve"

    def test_dense_error_degrades(self, corpus, monkeypatch):
        import cadence_rag_tpu.engine.retrieve as eng
        from cadence_rag_tpu.embed import EmbeddingError

        def boom(texts):
            raise EmbeddingError("max batch size <= 8")

        monkeypatch.setattr(eng, "embed_texts", boom)
        resp = retrieve_evidence(RetrieveRequest(query="ECONNRESET object store"))
        assert resp["notes"]["retrieval"]["planner"] == "lexical_only"
        assert resp["notes"]["retrieval"]["dense_error"]

    def test_empty_query(self, corpus):
        resp = retrieve_evidence(RetrieveRequest(query="   "))
        assert resp["notes"] == {"error": "empty query"}
        resp = retrieve_evidence(
            RetrieveRequest(query="", return_style="ids_only")
        )
        assert resp["retrieved_ids"] == []


class TestIdempotencyAndRebuild:
    def test_transcript_idempotent(self, tmp_store):
        ref = CallRef(external_id="dup-1")
        utts = [
            UtteranceIn(speaker="A", start_ts_ms=0, end_ts_ms=5, text="hello world")
        ]
        call_id, n1, c1 = ingest_transcript(ref, utts, OPTS)
        call_id2, n2, c2 = ingest_transcript(ref, utts, OPTS)
        assert call_id == call_id2
        assert (n2, c2) == (0, 0)
        assert n1 == 1 and c1 >= 1

    def test_rebuild_matches_live_index(self, corpus):
        from cadence_rag_tpu.core.index import get_index, reset_index

        live = get_index()
        live_count = live.chunks.count
        req = RetrieveRequest(query="object store tiering", return_style="ids_only")
        before = retrieve_evidence(req)["retrieved_ids"]
        reset_index()
        rebuilt_counts = rebuild_index_from_store()
        assert rebuilt_counts[0] == live_count
        after = retrieve_evidence(req)["retrieved_ids"]
        assert before == after

    def test_ingest_call_upsert(self, tmp_store):
        ref = CallRef(external_id="up-1", title="first")
        call_id, created = ingest_call(ref)
        assert created
        call_id2, created2 = ingest_call(CallRef(external_id="up-1"))
        assert call_id2 == call_id and not created2


class TestDenseRequiresEmbedding:
    def test_unembedded_rows_excluded_from_dense_lane(self, tmp_store):
        """Parity: dense lane scopes to `embedding IS NOT NULL`
        (app/retrieve.py:347); un-backfilled rows serve lexical only."""
        call_id, _, _ = _mk_call(
            tmp_store, "no-embed", ["ECONNRESET appears exactly here"]
        )
        resp = retrieve_evidence(
            RetrieveRequest(query="ECONNRESET appears exactly", debug=True)
        )
        dbg = resp["debug"]["lanes"]["chunks"]
        assert dbg["bm25"], "lexical lane must hit"
        assert dbg["dense"] == []  # nothing embedded yet
        run_embedding_backfill(batch_size=4)
        resp = retrieve_evidence(
            RetrieveRequest(query="ECONNRESET appears exactly", debug=True)
        )
        assert resp["debug"]["lanes"]["chunks"]["dense"]
