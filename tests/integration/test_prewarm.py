"""Growth-compile prewarm (core/prewarm.py): once a corpus fills past the
threshold, the NEXT capacity's fused program compiles in the background,
and the first post-growth query hits the warm jit cache (no new compile).

Motivation: without it the mid-serving capacity-doubling recompile lands
in the query tail under a steady writer.
"""

import numpy as np
import pytest

from cadence_rag_tpu.core.index import DocRow, get_index
from cadence_rag_tpu.ops.pack import dual_corpus_retrieve_packed
from cadence_rag_tpu.schemas import RetrieveRequest


def _rows(start, n, dim=64, lex_dim=1024, slots=16):
    rng = np.random.default_rng(start)
    out = []
    for i in range(start, start + n):
        emb = rng.standard_normal(dim).astype(np.float32)
        emb /= np.linalg.norm(emb)
        sig = rng.integers(-3, 4, size=lex_dim).astype(np.int8)
        out.append(DocRow(
            doc_id=i, call_seq=0, started_sec=1_700_000_000 + i,
            lex_sig=sig, lex_dl=10,
            lex_touched=np.flatnonzero(sig)[:32].astype(np.int32),
            tech=np.zeros(slots, dtype=np.int32),
            embedding=emb,
        ))
    return out


@pytest.fixture()
def prewarm_env(tmp_store, monkeypatch):
    monkeypatch.setattr(tmp_store, "prewarm_growth_enabled", True)
    monkeypatch.setattr(tmp_store, "prewarm_min_capacity", 256)
    monkeypatch.setattr(tmp_store, "prewarm_fill_fraction", 0.75)
    return tmp_store


class TestGrowthPrewarm:
    def test_post_growth_query_hits_warm_cache(self, prewarm_env):
        from cadence_rag_tpu.engine.retrieve import retrieve_evidence_batch

        index = get_index()
        index.chunks.insert(_rows(1, 100))
        index.artifacts.insert(_rows(1, 16))

        reqs = [RetrieveRequest(query="object store gateway retry",
                                return_style="ids_only")
                for _ in range(4)]
        retrieve_evidence_batch(reqs)  # compiles at capacity 256, notes sig
        assert not index.prewarmer.maybe_prewarm()  # below fill threshold

        # fill chunks past 75% of 256 -> prewarm fires on insert
        index.chunks.insert(_rows(101, 100))
        assert index.chunks.capacity == 256
        assert index.chunks.count == 200
        index.prewarmer.wait(timeout=120)
        assert len(index.prewarmer._compiled) >= 1  # AOT executable ready
        size_after_prewarm = dual_corpus_retrieve_packed._cache_size()

        # grow for real; the first post-growth query must run the prewarmed
        # AOT executable and add NO jit cache entry (no recompile)
        index.chunks.insert(_rows(201, 100))
        assert index.chunks.capacity == 512
        warm = retrieve_evidence_batch(reqs)
        assert dual_corpus_retrieve_packed._cache_size() == size_after_prewarm

        # equivalence: the AOT executable and a fresh jit compile of the
        # same program must produce identical responses
        index.prewarmer._compiled.clear()
        cold = retrieve_evidence_batch(reqs)
        assert dual_corpus_retrieve_packed._cache_size() > size_after_prewarm
        for a, b in zip(warm, cold):
            assert a["retrieved_ids"] == b["retrieved_ids"]

    def test_prewarm_skips_when_next_capacity_cannot_fit(
        self, prewarm_env, monkeypatch
    ):
        """The doubled-capacity compile is skipped (not attempted and
        failed) when it would blow the device-memory budget — the AOT
        compile would run out of memory and its lowering would compete
        with serving."""
        from cadence_rag_tpu.engine.retrieve import retrieve_evidence_batch

        index = get_index()
        index.chunks.insert(_rows(1, 220))   # past 75% of 256
        index.artifacts.insert(_rows(1, 16))
        reqs = [RetrieveRequest(query="object store gateway retry",
                                return_style="ids_only")]
        monkeypatch.setattr(prewarm_env, "prewarm_hbm_budget_gb", 1e-6)
        retrieve_evidence_batch(reqs)
        assert not index.prewarmer.maybe_prewarm()
        assert not index.prewarmer._compiled
        monkeypatch.setattr(prewarm_env, "prewarm_hbm_budget_gb", 12.0)
        assert index.prewarmer.maybe_prewarm()
        index.prewarmer.wait(timeout=120)
        assert index.prewarmer._compiled

    def test_fractional_growth_when_doubling_cannot_fit(self, prewarm_env):
        """Near the top of device memory a doubling cannot fit (old+new
        coexist), but a fractional step does —
        growth (and its prewarm) must degrade instead of standing down."""
        import types

        from cadence_rag_tpu.core.prewarm import (
            _corpus_row_bytes,
            plan_next_capacity,
        )

        fake = types.SimpleNamespace(
            capacity=1_048_576, dim=1024, emb_dtype=np.dtype(np.float16),
            lex_dim=4096, tech_slots=16, row_sharding=None,
        )
        row = _corpus_row_bytes(fake)
        # free HBM fits ~1.3M rows of NEW buffers but not a 2M doubling
        free = int(1_350_000 * row / 0.85)
        cap = plan_next_capacity(fake, fake.capacity + 1, free=free)
        assert fake.capacity < cap < 2 * fake.capacity
        assert cap % (fake.capacity // 8) == 0
        # plenty of room -> classic doubling
        cap2 = plan_next_capacity(fake, fake.capacity + 1,
                                  free=int(64e9))
        assert cap2 == 2 * fake.capacity
        # nothing fits -> doubling contract kept (caller warns/OOMs)
        cap3 = plan_next_capacity(fake, fake.capacity + 1, free=1024)
        assert cap3 == 2 * fake.capacity
        # sharded corpora never take fractional steps
        fake.row_sharding = object()
        assert plan_next_capacity(fake, fake.capacity + 1,
                                  free=free) == 2 * fake.capacity

    def test_growth_lands_on_planned_capacity(self, prewarm_env,
                                              monkeypatch):
        """The capacity growth allocates must be the one the prewarmer
        planned (and compiled for) — otherwise the first post-growth
        query recompiles anyway."""
        index = get_index()
        index.chunks.insert(_rows(1, 100))
        # force a fractional plan for the next chunks growth (insert
        # slabs pad to pow2: 200 rows -> 256-slab -> need 356)
        index.prewarmer._planned[("chunks", 256)] = 384
        index.chunks.insert(_rows(101, 200))
        assert index.chunks.capacity == 384  # planned cap honored
        # a need beyond the stale plan falls back to a fresh plan
        index.prewarmer._planned[("chunks", 384)] = 390
        index.chunks.insert(_rows(301, 100))  # need 428 > 390
        assert index.chunks.capacity == 768

    def test_degrades_to_single_corpus_prewarm(self, prewarm_env,
                                               monkeypatch):
        """When BOTH corpora are near growth and the joint old+new
        buffer pairs exceed the budget, the prewarmer must compile the
        nearest-growth corpus's program (other corpus held at current
        capacity) instead of standing down — the 1M headline regression
        where a 76%-full artifacts corpus's speculative doubling
        blocked the chunks prewarm."""
        from cadence_rag_tpu.core.prewarm import _corpus_row_bytes
        from cadence_rag_tpu.engine.retrieve import retrieve_evidence_batch

        index = get_index()
        index.chunks.insert(_rows(1, 220))     # 86% of 256
        index.artifacts.insert(_rows(1, 200))  # 78% of 256 (lower fill)
        row = _corpus_row_bytes(index.chunks)
        # budget between the worst-case single-corpus need (batch<=128)
        # and the best-case joint need (batch>=1), so the joint plan
        # fails and the single-corpus degrade fits for any noted batch
        single_worst = (256 + 512) * row + 256 * row + 3 * 128 * 256 * 4
        joint_best = (256 + 512) * row * 2 + 2 * 3 * 1 * 256 * 4
        assert single_worst < joint_best
        monkeypatch.setattr(prewarm_env, "prewarm_hbm_budget_gb",
                            (single_worst + joint_best) / 2 / (1 << 30))
        reqs = [RetrieveRequest(query="object store gateway retry",
                                return_style="ids_only")]
        retrieve_evidence_batch(reqs)  # notes the sig; dispatch triggers
        index.prewarmer.maybe_prewarm()  # idempotent if already started
        index.prewarmer.wait(timeout=120)
        caps = {(c, a) for _, c, a in index.prewarmer._compiled}
        # both REACHABLE single-growth pairs compile (growths land one
        # corpus at a time — round-5 fix: the joint-only prewarm left
        # the actually-reachable pair cold and the first post-growth
        # query paid a fresh compile on the hot path); the joint pair
        # exceeds the budget and is skipped
        assert (512, 256) in caps and (256, 512) in caps
        assert (512, 512) not in caps

    def test_reachable_pairs_compiled(self, prewarm_env):
        """Both corpora near growth, ample budget: the prewarmer must
        compile the two single-growth pairs (the states the next growth
        actually lands in — growths are per-corpus) AND the joint pair.
        Round-4 compiled ONLY the joint, so the first post-growth query
        paid a fresh compile on the hot path (the soak's 15.5 s / 51 s
        worst batches)."""
        from cadence_rag_tpu.engine.retrieve import retrieve_evidence_batch

        index = get_index()
        index.chunks.insert(_rows(1, 220))
        index.artifacts.insert(_rows(1, 200))
        reqs = [RetrieveRequest(query="object store gateway retry",
                                return_style="ids_only")]
        retrieve_evidence_batch(reqs)
        index.prewarmer.maybe_prewarm()
        index.prewarmer.wait(timeout=120)
        caps = {(c, a) for _, c, a in index.prewarmer._compiled}
        assert {(512, 256), (256, 512), (512, 512)} <= caps

    def test_prewarm_disabled_is_inert(self, prewarm_env, monkeypatch):
        monkeypatch.setattr(prewarm_env, "prewarm_growth_enabled", False)
        index = get_index()
        index.chunks.insert(_rows(1, 250))
        assert not index.prewarmer.maybe_prewarm()

    def test_signature_dedupe(self, prewarm_env):
        from cadence_rag_tpu.core.prewarm import QuerySignature

        index = get_index()
        sig = QuerySignature(
            batch=2, emb_dim=64, q_feats=16, tech_q=8, n_calls=256,
            chunk_ks=(5, 5, 5), artifact_ks=(2, 2, 5),
            chunk_mode="exact", artifact_mode="exact",
            recall_target=0.95, dense_enabled=True, packed_bytes=1024,
            dim=64, lex_dim=1024, tech_slots=16, emb_dtype="bfloat16",
        )
        index.prewarmer.note_signature(sig)
        index.prewarmer.note_signature(sig)
        assert len(index.prewarmer._sigs) == 1


class TestMeshPrewarm:
    def test_sharded_prewarm_and_post_growth_dispatch(
        self, tmp_store, monkeypatch
    ):
        """Single-process mesh (8 virtual devices): the prewarmer lowers
        with the live arrays' GSPMD shardings and the post-growth query
        runs the AOT executable with results identical to a fresh jit
        compile — the round-2 'stands down when mesh-sharded' limitation
        is gone for single-process meshes."""
        from cadence_rag_tpu.core.index import reset_index
        from cadence_rag_tpu.engine.retrieve import retrieve_evidence_batch

        monkeypatch.setattr(tmp_store, "mesh_shape", "data:8")
        monkeypatch.setattr(tmp_store, "prewarm_growth_enabled", True)
        monkeypatch.setattr(tmp_store, "prewarm_min_capacity", 256)
        monkeypatch.setattr(tmp_store, "prewarm_fill_fraction", 0.75)
        reset_index()
        index = get_index()
        assert index.chunks.row_sharding is not None

        index.chunks.insert(_rows(1, 100))
        index.artifacts.insert(_rows(1, 16))
        reqs = [RetrieveRequest(query="object store gateway retry",
                                return_style="ids_only")
                for _ in range(4)]
        retrieve_evidence_batch(reqs)  # compile current capacity, note sig

        index.chunks.insert(_rows(101, 100))  # cross 75% fill
        index.prewarmer.wait(timeout=180)
        assert len(index.prewarmer._compiled) >= 1
        size_after_prewarm = dual_corpus_retrieve_packed._cache_size()

        index.chunks.insert(_rows(201, 100))  # force growth
        assert index.chunks.capacity == 512
        warm = retrieve_evidence_batch(reqs)
        # no fresh jit compile: the sharded AOT executable served it
        assert dual_corpus_retrieve_packed._cache_size() == size_after_prewarm

        index.prewarmer._compiled.clear()
        cold = retrieve_evidence_batch(reqs)
        assert dual_corpus_retrieve_packed._cache_size() > size_after_prewarm
        for a, b in zip(warm, cold):
            assert a["retrieved_ids"] == b["retrieved_ids"]
        reset_index()
