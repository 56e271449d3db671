"""Kernel-vs-oracle parity tests (SURVEY.md §4: "kernel-vs-reference
numerical parity tests" — the reference has no counterpart; this is new
coverage)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cadence_rag_tpu.ops import fusion, hashing, lexical, masks, techlane, topk
from cadence_rag_tpu.ops.fused import multi_lane_retrieve


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


class TestHashing:
    def test_fnv1a64_known_vectors(self):
        # Published FNV-1a 64 test vectors.
        assert hashing.fnv1a64(b"") == 0xCBF29CE484222325
        assert hashing.fnv1a64(b"a") == 0xAF63DC4C8601EC8C
        assert hashing.fnv1a64(b"foobar") == 0x85944171F73967E8

    def test_lexical_features_words_and_trigrams(self):
        feats = hashing.lexical_features("Hello  WORLD")
        # normalized "hello world": 2 words + 9 trigrams, all unique
        assert sum(feats.values()) == 2 + 9

    def test_doc_signature_deterministic(self):
        a, touched_a, dl_a = hashing.doc_signature("ECONNRESET on v1.2.3", 512, 100.0)
        b, touched_b, dl_b = hashing.doc_signature("ECONNRESET on v1.2.3", 512, 100.0)
        assert np.array_equal(a, b) and dl_a == dl_b
        assert len(touched_a) > 0

    def test_tech_token_hashes_dedupe_case_insensitive(self):
        h = hashing.tech_token_hashes(["BOM", "bom", "SSD"], slots=8)
        assert (h != 0).sum() == 2
        assert np.all(h[h != 0] > 0)


class TestDenseTopk:
    def test_exact_matches_numpy_oracle(self):
        rng = np.random.default_rng(0)
        docs = _unit_rows(rng, 200, 64)
        qs = _unit_rows(rng, 4, 64)
        mask = np.ones((4, 200), dtype=bool)
        mask[:, 100:] = False
        ref_scores, ref_idx = topk.reference_topk_numpy(qs, docs, mask, 10)
        got_scores, got_idx = topk.cosine_topk(
            jnp.asarray(qs), jnp.asarray(docs), jnp.asarray(mask), 10
        )
        np.testing.assert_array_equal(np.asarray(got_idx), ref_idx)
        np.testing.assert_allclose(np.asarray(got_scores), ref_scores, rtol=1e-5)

    def test_bf16_storage_preserves_topk_order_with_margin(self):
        rng = np.random.default_rng(1)
        docs = _unit_rows(rng, 500, 128)
        qs = _unit_rows(rng, 2, 128)
        mask = np.ones((2, 500), dtype=bool)
        _, ref_idx = topk.reference_topk_numpy(qs, docs, mask, 5)
        _, got_idx = topk.cosine_topk(
            jnp.asarray(qs),
            jnp.asarray(docs, dtype=jnp.bfloat16),
            jnp.asarray(mask),
            5,
        )
        # bf16 rounding may swap near-ties; require >= 4/5 agreement per query
        agree = [
            len(set(map(int, got_idx[i])) & set(map(int, ref_idx[i])))
            for i in range(2)
        ]
        assert min(agree) >= 4

    def test_approx_mode_high_recall(self):
        rng = np.random.default_rng(2)
        docs = _unit_rows(rng, 2048, 64)
        qs = _unit_rows(rng, 3, 64)
        mask = np.ones((3, 2048), dtype=bool)
        _, ref_idx = topk.reference_topk_numpy(qs, docs, mask, 10)
        _, got_idx = topk.cosine_topk(
            jnp.asarray(qs), jnp.asarray(docs), jnp.asarray(mask), 10,
            mode="ann", recall_target=0.95,
        )
        for i in range(3):
            overlap = len(set(map(int, got_idx[i])) & set(map(int, ref_idx[i])))
            assert overlap >= 8


class TestLexicalLane:
    def test_shared_terms_rank_higher(self):
        dim = 1024
        texts = [
            "the deployment failed with ECONNRESET on the lenovo build",
            "quarterly sales pipeline review with acme corp",
            "object storage tiering benchmark results for ssd cluster",
        ]
        sigs = np.stack(
            [hashing.doc_signature(t, dim, 40.0)[0] for t in texts]
        )
        df = np.zeros(dim, dtype=np.int32)
        for t in texts:
            _, touched, _ = hashing.doc_signature(t, dim, 40.0)
            df[touched] += 1
        q = hashing.query_vector("ECONNRESET lenovo build failure", dim, df, 3)
        scores, pos = lexical.lexical_topk(
            jnp.asarray(q[None, :]),
            jnp.asarray(sigs),
            jnp.ones((1, 3), dtype=bool),
            3,
        )
        assert int(pos[0, 0]) == 0
        assert float(scores[0, 0]) > float(scores[0, 1])

    def test_no_match_scores_filtered(self):
        dim = 2048
        sig, _, _ = hashing.doc_signature("alpha beta gamma", dim, 10.0)
        df = np.ones(dim, dtype=np.int32)
        q = hashing.query_vector("zzzzqqqq xxyyzz", dim, df, 1)
        scores, _ = lexical.lexical_topk(
            jnp.asarray(q[None, :]),
            jnp.asarray(sig[None, :]),
            jnp.ones((1, 1), dtype=bool),
            1,
        )
        # unrelated doc must not be a confident match
        assert float(scores[0, 0]) < 0.5 or np.isneginf(float(scores[0, 0]))


class TestTechLane:
    def test_match_and_recency_order(self):
        from cadence_rag_tpu.ops.hashing import (
            tech_query_structure_from_hashes as qs,
            tech_slot_choices,
        )

        # slot-addressed doc storage: token 7 lives at one of its two
        # choice slots; the query structure covers both
        s7 = tech_slot_choices(7, 4)[0]
        s9 = tech_slot_choices(9, 4)[0]
        doc_tokens = np.zeros((4, 4), dtype=np.int32)
        doc_tokens[0, s7] = 7
        doc_tokens[1, s7] = 7
        doc_tokens[2, s9] = 9
        started = np.array([100, 300, 200, 400], dtype=np.int32)
        q = qs([7], 4)[None, :]
        keys, pos = techlane.tech_topk(
            jnp.asarray(doc_tokens),
            jnp.asarray(started),
            jnp.asarray(q),
            jnp.ones((1, 4), dtype=bool),
            4,
        )
        # doc1 (ts=300) before doc0 (ts=100); non-matches carry -inf
        assert int(pos[0, 0]) == 1 and int(pos[0, 1]) == 0
        assert np.isneginf(float(keys[0, 2]))

    def test_tie_break_prefers_lower_position(self):
        from cadence_rag_tpu.ops.hashing import (
            tech_query_structure_from_hashes as qs,
        )

        doc_tokens = np.full((3, 2), 5, dtype=np.int32)
        started = np.array([50, 50, 50], dtype=np.int32)
        q = qs([5], 2)[None, :]
        _, pos = techlane.tech_topk(
            jnp.asarray(doc_tokens),
            jnp.asarray(started),
            jnp.asarray(q),
            jnp.ones((1, 3), dtype=bool),
            3,
        )
        assert list(map(int, pos[0])) == [0, 1, 2]


class TestMasks:
    def test_call_and_date_scoping(self):
        call_idx = np.array([0, 1, 2, 0], dtype=np.int32)
        started = np.array([100, 200, 300, np.iinfo(np.int32).min], dtype=np.int32)
        allowed = np.zeros((1, 4), dtype=bool)
        allowed[0, [0, 2]] = True
        m = masks.filter_mask(
            jnp.asarray(call_idx),
            jnp.asarray(started),
            jnp.asarray(allowed),
            jnp.asarray([150], dtype=jnp.int32),
            jnp.asarray([np.iinfo(np.int32).max], dtype=jnp.int32),
        )
        # doc0: allowed call but ts<150 -> False; doc2: allowed+in-range -> True
        # doc3: invalid row -> False
        assert list(map(bool, np.asarray(m)[0])) == [False, False, True, False]


class TestFusion:
    def test_host_rrf_matches_reference_semantics(self):
        lanes = {"bm25": ["a", "b", "c"], "dense": ["b", "a"], "tech": ["c"]}
        ranked = fusion.rrf_merge(lanes, k=60)
        keys = [k for k, _, _ in ranked]
        scores = {k: s for k, _, s in ranked}
        assert set(keys) == {"a", "b", "c"}
        np.testing.assert_allclose(scores["a"], 1 / 61 + 1 / 62)
        np.testing.assert_allclose(scores["b"], 1 / 62 + 1 / 61)
        np.testing.assert_allclose(scores["c"], 1 / 63 + 1 / 61)
        # a and b tie -> first-inserted (a, from bm25 lane) wins
        assert keys[0] == "a" and keys[1] == "b"
        assert ranked[0][1] == {"bm25", "dense"}

    def test_vectorized_rrf_matches_reference_merge(self):
        """rrf_merge_arrays and rrf_merge_batch must reproduce rrf_merge's
        ordering (score desc, first-seen tiebreak), scores bitwise, and
        lane-hit sets — across random lane shapes including empties."""
        rng = np.random.default_rng(7)
        plans = []
        refs = []
        for _ in range(40):
            lanes = {}
            n_lanes = int(rng.integers(1, 4))
            for name in ["bm25", "tech_tokens", "dense"][:n_lanes]:
                n = int(rng.integers(0, 40))
                lanes[name] = rng.integers(0, 50, size=n).astype(np.int64)
            plans.append(lanes)
            refs.append(fusion.rrf_merge(
                {k: v.tolist() for k, v in lanes.items()}
            ))
        # single-plan variant
        for lanes, ref in zip(plans, refs):
            ids, scores, masks, names = fusion.rrf_merge_arrays(lanes)
            assert ids.tolist() == [r[0] for r in ref]
            assert scores.tolist() == [r[2] for r in ref]  # bitwise equal
            for (_, rset, _), m in zip(ref, masks):
                assert fusion.lane_mask_names(int(m), names) == rset
        # batched variant
        merged = fusion.rrf_merge_batch(plans)
        for (ids, scores, masks, names), ref in zip(merged, refs):
            assert ids.tolist() == [r[0] for r in ref]
            assert scores.tolist() == [r[2] for r in ref]
            for (_, rset, _), m in zip(ref, masks):
                assert fusion.lane_mask_names(int(m), names) == rset

    def test_rect_rrf_matches_per_plan_batch(self):
        """rrf_merge_rect (rectangular blocks + counts, the device output
        shape) must be bitwise identical to rrf_merge_batch on the
        equivalent ragged per-plan dicts — ordering, f64 scores, masks."""
        rng = np.random.default_rng(3)
        B, k = 17, 12
        lanes_rect = {}
        for name in ("bm25", "tech_tokens", "dense"):
            ids = rng.integers(0, 30, size=(B, k)).astype(np.int64)
            counts = rng.integers(0, k + 1, size=B).astype(np.int32)
            scores = rng.random((B, k)).astype(np.float32)
            lanes_rect[name] = (ids, scores, counts)
        per_plan = []
        for b in range(B):
            per_plan.append({
                name: ids[b, :counts[b]]
                for name, (ids, _s, counts) in lanes_rect.items()
            })
        rect = fusion.rrf_merge_rect(lanes_rect)
        ragged = fusion.rrf_merge_batch(per_plan)
        assert len(rect) == len(ragged) == B
        for (r_ids, r_s, r_m, r_n), (g_ids, g_s, g_m, g_n) in zip(
            rect, ragged
        ):
            np.testing.assert_array_equal(r_ids, g_ids)
            assert r_s.tolist() == g_s.tolist()  # bitwise f64
            np.testing.assert_array_equal(r_m, g_m)
            assert r_n == g_n

    def test_native_rrf_matches_numpy_fallback(self, monkeypatch):
        """The C++ core (native/rrf.cpp) and the numpy fallback inside
        rrf_merge_batch must be BITWISE identical — ordering, f64 scores
        (same accumulation order), masks — on random plans including
        in-lane duplicate ids and empty lanes."""
        from cadence_rag_tpu.native import rrf as native_rrf

        if not native_rrf.available():
            pytest.skip("native rrf core unavailable")
        rng = np.random.default_rng(11)
        plans = []
        for _ in range(60):
            lanes = {}
            for name in ["bm25", "tech_tokens", "dense"][
                : int(rng.integers(1, 4))
            ]:
                n = int(rng.integers(0, 60))
                lanes[name] = rng.integers(0, 40, size=n).astype(np.int64)
            plans.append(lanes)
        native_out = fusion.rrf_merge_batch(plans)
        monkeypatch.setattr(native_rrf, "merge_groups",
                            lambda *a, **k: None)
        numpy_out = fusion.rrf_merge_batch(plans)
        for (n_ids, n_s, n_m, n_names), (p_ids, p_s, p_m, p_names) in zip(
            native_out, numpy_out
        ):
            np.testing.assert_array_equal(n_ids, p_ids)
            assert n_s.tolist() == p_s.tolist()  # bitwise f64
            np.testing.assert_array_equal(n_m, p_m)
            assert n_names == p_names

    def test_native_ids_only_format_matches_lexsort(self):
        """The batched C++ ids_only formatter must reproduce the engine's
        per-plan ordering contract (np.lexsort((ids, kinds, -scores)) —
        score desc, artifacts before chunks on ties, id asc; reference:
        app/retrieve.py:552-573) including exact-score ties and empty
        plans."""
        from cadence_rag_tpu.native import rrf as native_rrf

        if not native_rrf.available():
            pytest.skip("native rrf core unavailable")
        rng = np.random.default_rng(23)
        # scores drawn from a tiny set of exact f64 values forces heavy
        # cross-kind / cross-id ties
        tie_pool = np.array([1 / 61, 1 / 61 + 1 / 62, 1 / 63, 2 / 61])
        n_plans = 19
        a_parts, c_parts = [], []
        expected: list = []
        for p in range(n_plans):
            na = int(rng.integers(0, 9))
            nc = int(rng.integers(0, 13))
            a_ids = rng.choice(40, size=na, replace=False).astype(np.int64)
            c_ids = rng.choice(40, size=nc, replace=False).astype(np.int64)
            a_sc = rng.choice(tie_pool, size=na)
            c_sc = rng.choice(tie_pool, size=nc)
            a_parts.append((np.full(na, p, np.int32), a_ids, a_sc))
            c_parts.append((np.full(nc, p, np.int32), c_ids, c_sc))
            ids_all = np.concatenate([a_ids, c_ids])
            scores_all = np.concatenate([a_sc, c_sc])
            kinds_all = np.concatenate([
                np.zeros(na, dtype=np.int8), np.ones(nc, dtype=np.int8)
            ])
            order = np.lexsort((ids_all, kinds_all, -scores_all))
            kind_name = ("artifact_chunk", "chunk")
            expected.append([
                f"{kind_name[k]}:{d}"
                for k, d in zip(kinds_all[order], ids_all[order])
            ])
        cat = lambda i, parts: np.concatenate([t[i] for t in parts])  # noqa: E731
        counts, strings = native_rrf.ids_only_format(
            cat(0, a_parts), cat(1, a_parts), cat(2, a_parts),
            cat(0, c_parts), cat(1, c_parts), cat(2, c_parts), n_plans,
        )
        offset = 0
        for p in range(n_plans):
            got = strings[offset:offset + int(counts[p])]
            offset += int(counts[p])
            assert got == expected[p], f"plan {p}"
        assert offset == len(strings)

    def test_native_ids_only_format_rejects_unsorted_plans(self):
        """Non-plan-major input must return None (fallback), not garbage."""
        from cadence_rag_tpu.native import rrf as native_rrf

        if not native_rrf.available():
            pytest.skip("native rrf core unavailable")
        plan = np.array([1, 0], dtype=np.int32)
        doc = np.array([5, 6], dtype=np.int64)
        score = np.array([0.5, 0.4])
        empty_p = np.zeros(0, np.int32)
        empty_d = np.zeros(0, np.int64)
        empty_s = np.zeros(0, np.float64)
        assert native_rrf.ids_only_format(
            plan, doc, score, empty_p, empty_d, empty_s, 2
        ) is None

    def test_device_rrf_matches_host(self):
        lane_pos = np.array(
            [[[0, 1, 2]], [[1, 0, -1]]], dtype=np.int32
        )  # (L=2, B=1, K=3)
        dev = np.asarray(fusion.rrf_scores_device(jnp.asarray(lane_pos), 4))
        host = fusion.rrf_merge({"l0": [0, 1, 2], "l1": [1, 0]})
        host_scores = {k: s for k, _, s in host}
        for key, score in host_scores.items():
            np.testing.assert_allclose(dev[0, key], score, rtol=1e-6)
        assert dev[0, 3] == 0.0


class TestFusedProgram:
    def test_all_lanes_one_call(self):
        rng = np.random.default_rng(3)
        n, dim, dlex = 64, 32, 256
        emb = _unit_rows(rng, n, dim)
        lex_w = rng.integers(-5, 6, size=(n, dlex)).astype(np.int8)
        from cadence_rag_tpu.ops.hashing import (
            tech_query_structure_from_hashes as _qs,
            tech_slot_choices as _choices,
        )

        tech = np.zeros((n, 4), dtype=np.int32)
        tech[5, _choices(42, 4)[0]] = 42
        call_idx = np.zeros(n, dtype=np.int32)
        started = np.full(n, 1000, dtype=np.int32)
        q_emb = emb[[7]] + 0.0
        q_lex = rng.standard_normal((1, dlex)).astype(np.float32)
        q_tech = _qs([42], 4)[None, :]
        allowed = np.ones((1, 8), dtype=bool)
        out = multi_lane_retrieve(
            jnp.asarray(emb), jnp.asarray(lex_w), jnp.asarray(tech),
            jnp.asarray(call_idx), jnp.asarray(started),
            jnp.ones(n, dtype=bool),
            jnp.asarray(q_emb), jnp.asarray(q_lex), jnp.asarray(q_tech),
            jnp.asarray(allowed),
            jnp.asarray([0], dtype=jnp.int32),
            jnp.asarray([2**31 - 1], dtype=jnp.int32),
            k_dense=5, k_lex=5, k_tech=5,
        )
        assert set(out) == {"dense", "lex", "tech"}
        assert int(out["dense"][1][0, 0]) == 7  # self-match wins dense lane
        assert int(out["tech"][1][0, 0]) == 5   # only tech match

    def test_lexical_only_degradation(self):
        """Dense lane disabled -> program still serves lex+tech
        (parity: retrieve.py:425-431 degrade ladder)."""
        n, dim, dlex = 16, 8, 64
        out = multi_lane_retrieve(
            jnp.zeros((n, dim), jnp.bfloat16),
            jnp.zeros((n, dlex), jnp.int8),
            jnp.zeros((n, 2), jnp.int32),
            jnp.zeros(n, jnp.int32),
            jnp.full(n, 10, jnp.int32),
            jnp.ones(n, dtype=bool),
            jnp.zeros((1, dim), jnp.float32),
            jnp.zeros((1, dlex), jnp.float32),
            jnp.zeros((1, 2), jnp.int32),
            jnp.ones((1, 4), bool),
            jnp.asarray([0], jnp.int32),
            jnp.asarray([2**31 - 1], jnp.int32),
            k_dense=5, k_lex=5, k_tech=5, dense_enabled=False,
        )
        assert "dense" not in out and "lex" in out and "tech" in out


class TestAsrNoiseRobustness:
    """The lexical lane's contract: 'rank by lexical relevance, robust to
    ASR noise via char 3-grams' (SURVEY.md §2.3). Misspelled queries must
    still rank the right document first through trigram overlap."""

    def test_typo_query_still_ranks_target_first(self):
        dim = 2048
        texts = [
            "the ECONNRESET errors came from the object store gateway",
            "quarterly forecast review with the sales team",
            "kubernetes upgrade plan for the staging cluster",
        ]
        sigs = np.stack([hashing.doc_signature(t, dim, 40.0)[0] for t in texts])
        df = np.zeros(dim, dtype=np.int64)
        for t in texts:
            _, touched, _ = hashing.doc_signature(t, dim, 40.0)
            df[touched] += 1
        # ASR-style corruption: dropped letters, merged words
        q = hashing.query_vector("ECONRESET objct stor gatway", dim, df, 3)
        scores, pos = lexical.lexical_topk(
            jnp.asarray(q[None, :]), jnp.asarray(sigs),
            jnp.ones((1, 3), dtype=bool), 3,
        )
        assert int(pos[0, 0]) == 0, np.asarray(scores)
