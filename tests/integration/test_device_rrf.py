"""Device-side RRF: kernel parity vs the host merge
oracle, and end-to-end response parity with DEVICE_RRF on vs off."""

import jax.numpy as jnp
import numpy as np
import pytest

from cadence_rag_tpu.config import settings
from cadence_rag_tpu.embed.pipeline import run_embedding_backfill
from cadence_rag_tpu.engine.retrieve import retrieve_evidence
from cadence_rag_tpu.ingest.ingest import ingest_transcript
from cadence_rag_tpu.ops.fusion import rrf_fuse_lanes_device, rrf_merge_rect
from cadence_rag_tpu.schemas import (
    CallRef,
    ChunkingOptions,
    RetrieveRequest,
    UtteranceIn,
)

LANE_ORDER = ("lex", "tech", "dense")
API_NAMES = {"lex": "bm25", "tech": "tech_tokens", "dense": "dense"}


def _mk_lane(rng, batch, k, n_docs, n_valid_range=(0, None)):
    """Synthetic lane output: scores sorted desc, -inf sentinels after a
    random valid prefix, positions unique per row."""
    lo, hi = n_valid_range
    hi = k if hi is None else hi
    vals = np.full((batch, k), -np.inf, dtype=np.float32)
    pos = np.zeros((batch, k), dtype=np.int32)
    for b in range(batch):
        n = int(rng.integers(lo, hi + 1))
        vals[b, :n] = np.sort(
            rng.standard_normal(n).astype(np.float32)
        )[::-1]
        pos[b, :n] = rng.choice(n_docs, size=n, replace=False)
        pos[b, n:] = rng.integers(0, n_docs, size=k - n)  # garbage after
    return vals, pos


def _host_merge(outs, batch):
    """Host oracle on the same lane outputs (ids = positions)."""
    rect = {}
    for lane in LANE_ORDER:
        if lane not in outs:
            continue
        vals, pos = outs[lane]
        keep = np.isfinite(vals)
        counts = keep.sum(axis=1).astype(np.int32)
        rect[API_NAMES[lane]] = (
            pos.astype(np.int64), vals.astype(np.float32), counts
        )
    return rrf_merge_rect(rect)


class TestDeviceRrfKernel:
    def _check(self, outs, batch):
        host = _host_merge(outs, batch)
        dev_outs = {
            lane: (jnp.asarray(v), jnp.asarray(p))
            for lane, (v, p) in outs.items()
        }
        pos_s, fused_s, masks_s, counts = (
            np.asarray(x)
            for x in rrf_fuse_lanes_device(dev_outs, LANE_ORDER)
        )
        for b in range(batch):
            h_ids, h_scores, h_masks, _names = host[b]
            n = int(counts[b])
            assert n == h_ids.size, (b, n, h_ids.size)
            np.testing.assert_array_equal(pos_s[b, :n], h_ids)
            np.testing.assert_array_equal(masks_s[b, :n], h_masks)
            np.testing.assert_allclose(
                fused_s[b, :n], h_scores, atol=1e-6
            )

    def test_parity_three_lanes_overlapping(self):
        rng = np.random.default_rng(0)
        # small doc space forces heavy cross-lane overlap
        outs = {
            "lex": _mk_lane(rng, 6, 8, 20, (1, 8)),
            "tech": _mk_lane(rng, 6, 5, 20, (0, 5)),
            "dense": _mk_lane(rng, 6, 8, 20, (1, 8)),
        }
        self._check(outs, 6)

    def test_parity_two_lanes_no_dense(self):
        rng = np.random.default_rng(1)
        outs = {
            "lex": _mk_lane(rng, 4, 6, 15, (0, 6)),
            "tech": _mk_lane(rng, 4, 6, 15, (0, 6)),
        }
        self._check(outs, 4)

    def test_empty_rows(self):
        rng = np.random.default_rng(2)
        outs = {
            "lex": _mk_lane(rng, 3, 5, 10, (0, 0)),   # all invalid
            "tech": _mk_lane(rng, 3, 5, 10, (0, 0)),
            "dense": _mk_lane(rng, 3, 5, 10, (0, 0)),
        }
        dev_outs = {
            lane: (jnp.asarray(v), jnp.asarray(p))
            for lane, (v, p) in outs.items()
        }
        _pos, _fused, _masks, counts = rrf_fuse_lanes_device(
            dev_outs, LANE_ORDER
        )
        np.testing.assert_array_equal(np.asarray(counts), [0, 0, 0])

    def test_doc_in_all_lanes_gets_summed_score_and_full_mask(self):
        vals = np.array([[0.9, 0.5]], dtype=np.float32)
        pos = np.array([[7, 3]], dtype=np.int32)
        outs = {
            "lex": (jnp.asarray(vals), jnp.asarray(pos)),
            "tech": (jnp.asarray(vals), jnp.asarray(pos)),
            "dense": (jnp.asarray(vals), jnp.asarray(pos)),
        }
        pos_s, fused_s, masks_s, counts = (
            np.asarray(x) for x in rrf_fuse_lanes_device(outs, LANE_ORDER)
        )
        assert counts[0] == 2
        np.testing.assert_array_equal(pos_s[0, :2], [7, 3])
        assert masks_s[0, 0] == 0b111
        np.testing.assert_allclose(fused_s[0, 0], 3 / 61.0, rtol=1e-6)
        np.testing.assert_allclose(fused_s[0, 1], 3 / 62.0, rtol=1e-6)


OPTS = ChunkingOptions(target_tokens=30, max_tokens=60, overlap_tokens=5)


@pytest.fixture()
def small_corpus(tmp_store):
    texts = [
        "we saw ECONNRESET errors from the object store gateway last night",
        "tiering to SSD fixed the latency spike on the ingest path",
        "the lenovo build needs a new BOM before the bake-off",
        "quarterly pipeline review went well, acme is in stage four",
        "rolling back to v2.3.1 stopped the gateway resets",
    ]
    utts = [
        UtteranceIn(
            speaker=["Ana", "Raj"][i % 2], start_ts_ms=i * 5000,
            end_ts_ms=i * 5000 + 4500, text=t,
        )
        for i, t in enumerate(texts)
    ]
    ingest_transcript(CallRef(title="device rrf fixture"), utts, OPTS)
    run_embedding_backfill(batch_size=8)


class TestDeviceRrfEndToEnd:
    def _responses(self, enabled, monkeypatch):
        monkeypatch.setattr(settings, "device_rrf_enabled", enabled)
        out = []
        for query in (
            "ECONNRESET object store gateway",
            "what fixed the latency spike",
            "v2.3.1 rollback",
        ):
            for style in ("ids_only", "evidence_pack_json"):
                resp = retrieve_evidence(
                    RetrieveRequest(query=query, return_style=style)
                )
                resp.pop("query_id", None)
                # wall-clock timings are the one legitimately
                # non-deterministic field
                resp.get("notes", {}).get("retrieval", {}).pop(
                    "timings_ms", None
                )
                out.append(resp)
        return out

    def test_fused_matches_host_oracle(self, small_corpus, monkeypatch):
        fused = self._responses(True, monkeypatch)
        host = self._responses(False, monkeypatch)
        assert fused == host

    def test_debug_mode_still_serves_lanes(self, small_corpus, monkeypatch):
        monkeypatch.setattr(settings, "device_rrf_enabled", True)
        resp = retrieve_evidence(
            RetrieveRequest(
                query="ECONNRESET gateway", return_style="ids_only",
                debug=True,
            )
        )
        lanes = resp["debug"]["lanes"]["chunks"]
        assert set(lanes) >= {"bm25", "tech_tokens"}
        assert resp["retrieved_ids"]
