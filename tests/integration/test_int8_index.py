"""INDEX_EMBEDDING_DTYPE=int8: quantized embedding storage.

Halves the dense lane's memory traffic and checkpoint bytes vs bf16 (the
dense scan streams the whole matrix per batch); rows are unit vectors stored as
round(x*127) int8 and widened in-register at score time
(ops/topk.dense_scores). Quantization noise must not materially change
dense rankings, and every write path (insert, backfill scatter,
checkpoint restore) must quantize identically.
"""

import numpy as np
import pytest

from cadence_rag_tpu.embed.pipeline import run_embedding_backfill
from cadence_rag_tpu.ingest.ingest import ingest_transcript
from cadence_rag_tpu.schemas import CallRef, ChunkingOptions, RetrieveRequest, UtteranceIn

TOPICS = [
    "object store tiering cut the checkout latency",
    "ECONNRESET storm traced to the gateway upgrade",
    "certificate expiry caused the outage window",
    "quota exhaustion throttled the export pipeline",
    "kafka consumer lag after the rebalance",
    "postgres vacuum stalls on the ledger table",
]


class TestInt8Kernel:
    def test_int8_topk_matches_f32_ordering(self):
        import jax.numpy as jnp

        from cadence_rag_tpu.ops.topk import dense_scores

        rng = np.random.default_rng(0)
        docs = rng.standard_normal((2000, 64)).astype(np.float32)
        docs /= np.linalg.norm(docs, axis=1, keepdims=True)
        qs = rng.standard_normal((8, 64)).astype(np.float32)
        qs /= np.linalg.norm(qs, axis=1, keepdims=True)

        exact = np.asarray(dense_scores(jnp.asarray(qs), jnp.asarray(docs)))
        q8 = np.clip(np.rint(docs * 127.0), -127, 127).astype(np.int8)
        quant = np.asarray(dense_scores(jnp.asarray(qs), jnp.asarray(q8)))
        # cosine units preserved (scale restored)
        assert np.allclose(exact, quant, atol=0.05)
        for b in range(qs.shape[0]):
            top_f = set(np.argsort(-exact[b])[:10].tolist())
            top_q = set(np.argsort(-quant[b])[:10].tolist())
            assert len(top_f & top_q) >= 9, (b, top_f, top_q)


@pytest.fixture()
def int8_store(tmp_store, monkeypatch):
    from cadence_rag_tpu.core.index import reset_index

    monkeypatch.setattr(tmp_store, "index_embedding_dtype", "int8")
    reset_index()
    for c in range(4):
        ingest_transcript(
            CallRef(external_id=f"i8-{c}"),
            [UtteranceIn(speaker="A", start_ts_ms=j * 1000,
                         end_ts_ms=j * 1000 + 900,
                         text=f"{TOPICS[(c + j) % len(TOPICS)]} detail {c}-{j}")
             for j in range(4)],
            ChunkingOptions(target_tokens=12, max_tokens=30, overlap_tokens=0),
        )
    run_embedding_backfill(batch_size=8)
    yield tmp_store
    reset_index()


class TestInt8Index:
    def test_storage_dtype_and_dense_retrieval(self, int8_store):
        import jax.numpy as jnp

        from cadence_rag_tpu.core.index import get_index
        from cadence_rag_tpu.engine.retrieve import retrieve_evidence_batch

        index = get_index()
        assert index.chunks.emb.dtype == jnp.int8
        assert index.chunks.emb_rows > 0
        # stored rows are genuinely quantized (not truncated-to-zero)
        emb_np = np.asarray(index.chunks.emb[: index.chunks.count])
        assert np.abs(emb_np.astype(np.int32)).max() > 10

        out = retrieve_evidence_batch([
            RetrieveRequest(query="gateway upgrade connection resets",
                            return_style="ids_only")
        ])[0]
        assert out["retrieved_ids"]

    def test_checkpoint_roundtrip_preserves_int8(self, int8_store, tmp_path):
        import jax.numpy as jnp

        from cadence_rag_tpu.core.checkpoint import restore_index, save_index
        from cadence_rag_tpu.core.index import get_index
        from cadence_rag_tpu.engine.retrieve import retrieve_evidence_batch

        def ids():
            return retrieve_evidence_batch([
                RetrieveRequest(query="certificate expiry outage",
                                return_style="ids_only")
            ])[0]["retrieved_ids"]

        index = get_index()
        before = ids()
        emb_before = np.asarray(index.chunks.emb[: index.chunks.count])
        save_index(str(tmp_path / "ck"))
        restore_index(str(tmp_path / "ck"), index)
        assert index.chunks.emb.dtype == jnp.int8
        emb_after = np.asarray(index.chunks.emb[: index.chunks.count])
        np.testing.assert_array_equal(emb_before, emb_after)
        assert ids() == before

    def test_ivf_build_under_int8(self, int8_store):
        """build_ivf no longer refuses int8 storage: k-means runs on the
        dequantized snapshot and the probed dense mode serves."""
        from cadence_rag_tpu.core.index import get_index

        index = get_index()
        state = index.chunks.build_ivf(n_clusters=4, nprobe=4)
        assert state.built_count == index.chunks.count
        assert index.chunks.ivf_usable()
        # centroids live in float space with sane magnitudes
        cents = np.asarray(state.centroids)
        assert cents.dtype == np.float32
        assert 0.5 < np.linalg.norm(cents, axis=1).max() < 2.0
