"""Batched retrieval: many queries, one device dispatch per mode group,
identical results to serial requests."""

import numpy as np
import pytest

from cadence_rag_tpu.embed.pipeline import run_embedding_backfill
from cadence_rag_tpu.engine.retrieve import (
    retrieve_evidence,
    retrieve_evidence_batch,
)
from cadence_rag_tpu.ingest.ingest import ingest_transcript
from cadence_rag_tpu.schemas import (
    CallRef,
    ChunkingOptions,
    RetrieveFilters,
    RetrieveRequest,
    UtteranceIn,
)


@pytest.fixture()
def corpus(tmp_store):
    texts = [
        "ECONNRESET errors flooded the object store gateway",
        "lenovo BOM review for the dell bake-off next week",
        "azure migration cutover runbook approved by finance",
        "SSD tiering cut p99 latency on the ingest cluster",
    ]
    call_ids = []
    for i, t in enumerate(texts):
        cid, _, _ = ingest_transcript(
            CallRef(external_id=f"batch-{i}"),
            [UtteranceIn(speaker="A", start_ts_ms=0, end_ts_ms=900, text=t)],
            ChunkingOptions(target_tokens=10, max_tokens=30, overlap_tokens=0),
        )
        call_ids.append(cid)
    run_embedding_backfill(batch_size=8)
    return call_ids


class TestBatchRetrieve:
    def test_batch_matches_serial(self, corpus):
        queries = [
            "ECONNRESET object store",
            "lenovo BOM bake-off",
            "azure migration runbook",
        ]
        reqs = [
            RetrieveRequest(query=q, return_style="ids_only") for q in queries
        ]
        serial = [retrieve_evidence(r)["retrieved_ids"] for r in reqs]
        batched = [
            resp["retrieved_ids"] for resp in retrieve_evidence_batch(reqs)
        ]
        assert batched == serial

    def test_readback_prefetch_parity(self, corpus, monkeypatch):
        """READBACK_PREFETCH_ENABLED only changes WHEN the D2H request is
        issued (dispatch vs collect) — results must be identical."""
        from cadence_rag_tpu.config import settings

        reqs = [
            RetrieveRequest(query=q, return_style="ids_only")
            for q in ("ECONNRESET object store", "azure migration runbook")
        ]
        monkeypatch.setattr(settings, "readback_prefetch_enabled", False)
        off = [r["retrieved_ids"] for r in retrieve_evidence_batch(reqs)]
        monkeypatch.setattr(settings, "readback_prefetch_enabled", True)
        on = [r["retrieved_ids"] for r in retrieve_evidence_batch(reqs)]
        assert on == off
        assert off[0]  # non-empty: the corpus matches the first query

    def test_pipelined_matches_batched(self, corpus):
        """The single-thread pipelined stream (depth 2/3 in flight on
        device) must produce exactly the per-batch responses of the
        blocking path, in order."""
        from cadence_rag_tpu.engine.retrieve import (
            retrieve_evidence_pipelined,
        )

        queries = [
            "ECONNRESET object store",
            "lenovo BOM bake-off",
            "azure migration runbook",
            "SSD tiering latency",
        ]
        batches = [
            [RetrieveRequest(query=q, return_style="ids_only")
             for q in queries[i:] + queries[:i]]
            for i in range(4)
        ]
        expected = [
            [r["retrieved_ids"] for r in retrieve_evidence_batch(b)]
            for b in batches
        ]
        for depth in (1, 2, 3):
            got = [
                [r["retrieved_ids"] for r in responses]
                for responses in retrieve_evidence_pipelined(
                    iter(batches), depth=depth
                )
            ]
            assert got == expected, depth

    def test_two_phase_api_matches_batched(self, corpus):
        """dispatch_evidence_batch + finish_evidence_batch (the serve
        batcher's two-phase path) == retrieve_evidence_batch."""
        from cadence_rag_tpu.engine.retrieve import (
            dispatch_evidence_batch,
            finish_evidence_batch,
        )

        reqs = [RetrieveRequest(query="ECONNRESET object store",
                                return_style="ids_only"),
                RetrieveRequest(query="azure migration runbook")]
        expected = retrieve_evidence_batch(reqs)
        # interleave: dispatch both batches before finishing either
        h1 = dispatch_evidence_batch(reqs)
        h2 = dispatch_evidence_batch(reqs)
        got1 = finish_evidence_batch(h1)
        got2 = finish_evidence_batch(h2)
        for got in (got1, got2):
            assert [r.get("retrieved_ids") for r in got] == [
                r.get("retrieved_ids") for r in expected
            ]
            assert got[1]["quotes"] == expected[1]["quotes"]

    def test_batch_one_device_dispatch(self, corpus):
        reqs = [
            RetrieveRequest(query=q)
            for q in ["ECONNRESET", "SSD tiering", "azure cutover"]
        ]
        responses = retrieve_evidence_batch(reqs)
        batches = {
            r["notes"]["retrieval"]["timings_ms"].get("device_batch")
            for r in responses
        }
        assert batches == {3.0}, batches  # all three shared one dispatch

    def test_mixed_modes_grouped(self, corpus):
        # a scoped query (exact mode) and an unscoped one (ann) still both
        # return correct results from separate dispatch groups
        scoped = RetrieveRequest(
            query="ECONNRESET object store",
            filters=RetrieveFilters(call_ids=[corpus[0]]),
            return_style="ids_only",
        )
        unscoped = RetrieveRequest(
            query="ECONNRESET object store", return_style="ids_only"
        )
        batch = retrieve_evidence_batch([scoped, unscoped])
        assert batch[0]["retrieved_ids"]
        assert batch[1]["retrieved_ids"]
        serial = retrieve_evidence(scoped)["retrieved_ids"]
        assert batch[0]["retrieved_ids"] == serial

    def test_empty_query_in_batch(self, corpus):
        batch = retrieve_evidence_batch([
            RetrieveRequest(query="  ", return_style="ids_only"),
            RetrieveRequest(query="ECONNRESET", return_style="ids_only"),
        ])
        assert batch[0]["retrieved_ids"] == []
        assert batch[1]["retrieved_ids"]

    def test_duplicate_requests_coalesce(self, corpus):
        """Identical payloads in one batch execute ONE plan: the device
        batch shrinks to the unique-request count, every caller still
        gets a response, duplicates share results but not query_ids."""
        from cadence_rag_tpu.engine.retrieve import (
            dispatch_evidence_batch,
            finish_evidence_batch,
        )

        hot = RetrieveRequest(query="ECONNRESET object store",
                              return_style="ids_only")
        cold = RetrieveRequest(query="azure migration runbook",
                               return_style="ids_only")
        reqs = [hot, cold, hot.model_copy(deep=True), hot, cold]
        handle = dispatch_evidence_batch(reqs)
        plans = handle[0]
        assert len(plans) == 2  # two unique payloads planned
        responses = finish_evidence_batch(handle)
        assert len(responses) == 5
        assert (responses[0]["retrieved_ids"] == responses[2]["retrieved_ids"]
                == responses[3]["retrieved_ids"])
        assert responses[1]["retrieved_ids"] == responses[4]["retrieved_ids"]
        assert responses[0]["retrieved_ids"] != responses[1]["retrieved_ids"]
        assert len({r["query_id"] for r in responses}) == 5

    def test_coalesced_matches_uncoalesced(self, corpus, monkeypatch):
        reqs = [
            RetrieveRequest(query="SSD tiering latency"),
            RetrieveRequest(query="lenovo BOM bake-off"),
            RetrieveRequest(query="SSD tiering latency"),
        ]
        from cadence_rag_tpu.config import settings

        monkeypatch.setattr(settings, "retrieve_coalesce_enabled", False)
        plain = retrieve_evidence_batch(
            [r.model_copy(deep=True) for r in reqs]
        )
        monkeypatch.setattr(settings, "retrieve_coalesce_enabled", True)
        coalesced = retrieve_evidence_batch(reqs)
        for a, b in zip(plain, coalesced):
            assert a["quotes"] == b["quotes"]
            assert a["artifacts"] == b["artifacts"]
            assert (a["notes"]["retrieval"]["tech_tokens"]
                    == b["notes"]["retrieval"]["tech_tokens"])

    def test_same_query_different_filters_not_coalesced(self, corpus):
        from cadence_rag_tpu.engine.retrieve import dispatch_evidence_batch

        reqs = [
            RetrieveRequest(
                query="ECONNRESET object store",
                filters=RetrieveFilters(call_ids=[corpus[0]]),
                return_style="ids_only",
            ),
            RetrieveRequest(query="ECONNRESET object store",
                            return_style="ids_only"),
        ]
        plans = dispatch_evidence_batch(reqs)[0]
        assert len(plans) == 2
        scoped, unscoped = retrieve_evidence_batch(reqs)
        assert scoped["retrieved_ids"]
        # the scoped result must differ (only corpus[0]'s chunks allowed)
        assert scoped["retrieved_ids"] != unscoped["retrieved_ids"]

    def test_coalesced_pipelined_stream(self, corpus):
        """Duplicate-heavy micro-batches through the pipelined path fan
        out correctly in order."""
        from cadence_rag_tpu.engine.retrieve import (
            retrieve_evidence_pipelined,
        )

        batch = [RetrieveRequest(query="ECONNRESET object store",
                                 return_style="ids_only")] * 4
        outs = list(retrieve_evidence_pipelined(
            iter([batch, batch]), depth=2
        ))
        assert [len(o) for o in outs] == [4, 4]
        ids = outs[0][0]["retrieved_ids"]
        assert ids
        for responses in outs:
            for r in responses:
                assert r["retrieved_ids"] == ids

    def test_poisoned_provider_trips_circuit_breaker(self, corpus,
                                                     monkeypatch):
        """A provider failing EVERY call must not cost B serial retries:
        after 3 consecutive individual failures the rest of the batch
        degrades immediately."""
        import cadence_rag_tpu.engine.retrieve as eng
        from cadence_rag_tpu.embed import EmbeddingError

        calls = []

        def dead(texts):
            calls.append(len(texts))
            raise EmbeddingError("connection refused")

        monkeypatch.setattr(eng, "embed_texts", dead)
        batch = retrieve_evidence_batch([
            RetrieveRequest(query=f"query number {i}") for i in range(12)
        ])
        # one batched attempt + exactly 3 individual probes, not 12
        assert calls == [12, 1, 1, 1], calls
        for resp in batch:
            assert resp["notes"]["retrieval"]["planner"] == "lexical_only"
            assert resp["quotes"] is not None
        opened = [r for r in batch
                  if "circuit open" in r["notes"]["retrieval"]["dense_error"]]
        assert len(opened) == 9

    def test_poisoned_query_degrades_alone(self, corpus, monkeypatch):
        """Per-request ladder parity (reference app/retrieve.py:425-431):
        when the batched embed call fails, each query retries individually
        so only the actually-failing one loses its dense lane."""
        import cadence_rag_tpu.engine.retrieve as eng
        from cadence_rag_tpu.embed import EmbeddingError
        from cadence_rag_tpu.embed.provider import embed_texts as real_embed

        def selective(texts):
            if len(texts) > 1:
                raise EmbeddingError("max batch size exceeded")
            if "POISON" in texts[0]:
                raise EmbeddingError("token limit exceeded for this input")
            return real_embed(texts)

        monkeypatch.setattr(eng, "embed_texts", selective)
        batch = retrieve_evidence_batch([
            RetrieveRequest(query="ECONNRESET object store"),
            RetrieveRequest(query="POISON azure migration"),
        ])
        healthy, poisoned = batch
        assert healthy["notes"]["retrieval"]["planner"] != "lexical_only"
        assert healthy["notes"]["retrieval"]["dense_error"] is None
        assert poisoned["notes"]["retrieval"]["planner"] == "lexical_only"
        assert "token limit" in poisoned["notes"]["retrieval"]["dense_error"]
        assert poisoned["quotes"], "lexical lanes must still serve"


class TestCallCapacityGrowthMidBatch:
    def test_bitmap_widths_pad_to_dispatch_capacity(self, tmp_store):
        """The background syncer can grow call capacity between planning
        and dispatch; plans in one micro-batch then hold different
        bitmap widths. Dispatch must pad to the dispatch-time width
        (np.stack over mixed widths failed the whole batch; review
        finding). Unscoped plans keep new calls visible; seq-scoped
        plans exclude them."""
        from cadence_rag_tpu.core.index import get_index
        from cadence_rag_tpu.engine import retrieve as eng

        def _one(ext, text):
            cid, _, _ = ingest_transcript(
                CallRef(external_id=ext),
                [UtteranceIn(speaker="A", start_ts_ms=0, end_ts_ms=900,
                             text=text)],
                ChunkingOptions(target_tokens=10, max_tokens=30,
                                overlap_tokens=0),
            )
            return cid

        call_a = _one("width-1", "nginx 502 storm at the edge tier")
        _one("width-2", "cassandra compaction backlog on ring two")
        index = get_index()

        reqs = [
            RetrieveRequest(query="nginx 502 storm edge",
                            return_style="ids_only"),
            RetrieveRequest(query="nginx 502 storm edge",
                            filters=RetrieveFilters(call_ids=[call_a]),
                            return_style="ids_only"),
        ]
        plans = eng._prepare_plans(reqs)
        widths = {p.resolved.allowed_calls.shape[0] for p in plans}
        # capacity doubles mid-flight (what a syncer poll does when a
        # worker creates many calls)
        index.ensure_call_capacity(index.call_capacity * 2 + 1)
        responses = eng._finish_plans(plans, eng._dispatch_plans(plans))
        assert responses[0]["retrieved_ids"]
        assert responses[1]["retrieved_ids"]
        # scoped result stays scoped to call_a
        from cadence_rag_tpu.store.db import get_store

        with get_store().read() as conn:
            a_ids = {
                f"chunk:{r[0]}" for r in conn.execute(
                    "SELECT chunk_id FROM chunks WHERE call_id=?",
                    (call_a,),
                )
            }
        assert set(responses[1]["retrieved_ids"]) <= a_ids
        # padded bitmaps: unscoped pads True, scoped pads False
        cap = index.call_capacity
        un = plans[0].resolved.allowed_at(cap)
        sc = plans[1].resolved.allowed_at(cap)
        assert un.shape == (cap,) and un.all()
        assert sc.shape == (cap,) and not sc[-1]
