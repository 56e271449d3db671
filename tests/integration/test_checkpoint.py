"""Index checkpoint/restore roundtrip (SURVEY.md §5: the on-device index
needs real checkpointing — no reference counterpart)."""

import numpy as np
import pytest

from cadence_rag_tpu.core.checkpoint import restore_index, save_index
from cadence_rag_tpu.core.index import get_index, reset_index
from cadence_rag_tpu.embed.pipeline import run_embedding_backfill
from cadence_rag_tpu.engine.retrieve import retrieve_evidence
from cadence_rag_tpu.ingest.ingest import ingest_analysis, ingest_transcript
from cadence_rag_tpu.schemas import (
    AnalysisArtifactIn,
    CallRef,
    ChunkingOptions,
    RetrieveRequest,
    UtteranceIn,
)


@pytest.fixture()
def populated(tmp_store):
    ref = CallRef(external_id="ckpt-1", title="checkpoint test")
    utts = [
        UtteranceIn(speaker="Ana", start_ts_ms=i * 1000, end_ts_ms=i * 1000 + 900,
                    text=t)
        for i, t in enumerate([
            "the ECONNRESET fix landed in v2.3.1",
            "object store tiering to SSD approved",
            "lenovo BOM finalized for the bake-off",
        ])
    ]
    call_id, _, _ = ingest_transcript(
        ref, utts, ChunkingOptions(target_tokens=10, max_tokens=30, overlap_tokens=2)
    )
    ingest_analysis(
        CallRef(call_id=call_id),
        [AnalysisArtifactIn(kind="summary", content="ECONNRESET fixed by rollback.")],
    )
    run_embedding_backfill(batch_size=8)
    return call_id


class TestCheckpoint:
    def test_roundtrip_preserves_results(self, populated, tmp_path):
        req = RetrieveRequest(query="ECONNRESET v2.3.1", return_style="ids_only")
        before = retrieve_evidence(req)["retrieved_ids"]
        assert before

        index = get_index()
        counts_before = (index.chunks.count, index.artifacts.count)
        meta = save_index(str(tmp_path / "snap"))
        assert meta["counts"]["chunks"] == counts_before[0]

        reset_index()
        restore_index(str(tmp_path / "snap"))
        index2 = get_index()
        assert (index2.chunks.count, index2.artifacts.count) == counts_before
        np.testing.assert_array_equal(
            index2.chunks.h_ids[: index2.chunks.count],
            index.chunks.h_ids[: index.chunks.count],
        )
        after = retrieve_evidence(req)["retrieved_ids"]
        assert after == before

    def test_dimension_mismatch_rejected(self, populated, tmp_path, tmp_store,
                                         monkeypatch):
        save_index(str(tmp_path / "snap"))
        reset_index()
        monkeypatch.setattr(tmp_store, "embeddings_dim", 32)
        with pytest.raises(ValueError, match="embeddings_dim"):
            restore_index(str(tmp_path / "snap"))

    def test_bf16_storage_halves_emb_bytes(self, populated, tmp_path):
        """Format v2 stores embeddings in the index storage dtype (bf16 as
        uint16 bits): the embedding half of a 1M-doc checkpoint drops from
        ~4 GB as f32 to ~2 GB."""
        save_index(str(tmp_path / "snap"))
        import numpy as _np

        with _np.load(tmp_path / "snap" / "chunks.g0000.0000.npz") as data:
            assert str(data["_kind"][0]) == "bf16"
            assert data["emb"].dtype == _np.uint16  # 2 bytes/component

    def test_async_save_does_not_block_and_roundtrips(self, populated, tmp_path):
        req = RetrieveRequest(query="ECONNRESET v2.3.1", return_style="ids_only")
        before = retrieve_evidence(req)["retrieved_ids"]
        meta = save_index(str(tmp_path / "snap"), block=False)
        writer = meta["_writer"]
        # serving proceeds while files are written
        assert retrieve_evidence(req)["retrieved_ids"] == before
        writer.join(timeout=30)
        assert not writer.is_alive()
        reset_index()
        restore_index(str(tmp_path / "snap"))
        assert retrieve_evidence(req)["retrieved_ids"] == before

    def test_multi_shard_files_roundtrip(self, populated, tmp_path, monkeypatch):
        import cadence_rag_tpu.core.checkpoint as ckpt

        # force tiny shards: one row of 64-dim bf16 = 128 bytes
        monkeypatch.setattr(ckpt, "SHARD_EMB_BYTES", 256)
        req = RetrieveRequest(query="object store tiering", return_style="ids_only")
        before = retrieve_evidence(req)["retrieved_ids"]
        meta = save_index(str(tmp_path / "snap"))
        assert meta["shards"]["chunks"] > 1
        shard_files = sorted(
            p.name for p in (tmp_path / "snap").glob("chunks.g*.[0-9]*.npz")
        )
        assert len(shard_files) == meta["shards"]["chunks"]
        reset_index()
        restore_index(str(tmp_path / "snap"))
        assert retrieve_evidence(req)["retrieved_ids"] == before

    def test_generation_flip_survives_crash_mid_save(self, populated,
                                                     tmp_path):
        """A save that dies before the meta flip must leave the previous
        checkpoint fully restorable (old unlink-meta-first behavior
        destroyed it)."""
        import json

        req = RetrieveRequest(query="ECONNRESET v2.3.1",
                              return_style="ids_only")
        before = retrieve_evidence(req)["retrieved_ids"]
        snap = tmp_path / "snap"
        save_index(str(snap))  # generation 0
        meta0 = json.loads((snap / "meta.json").read_text())
        assert meta0["generation"] == 0

        # simulate a crash mid-second-save: generation-1 shard files appear
        # but meta.json was never flipped
        (snap / "chunks.g0001.0000.npz").write_bytes(b"garbage partial")
        reset_index()
        restore_index(str(snap))  # must read the complete g0000 files
        assert retrieve_evidence(req)["retrieved_ids"] == before

        # a completed second save flips generation and prunes g0000
        save_index(str(snap))
        meta1 = json.loads((snap / "meta.json").read_text())
        assert meta1["generation"] == 1
        assert not list(snap.glob("*.g0000.*"))
        reset_index()
        restore_index(str(snap))
        assert retrieve_evidence(req)["retrieved_ids"] == before

    def test_v1_checkpoint_restores(self, populated, tmp_path):
        """Back-compat: v1 (single .npz per corpus, f32 emb) still loads."""
        import json

        import numpy as _np

        index = get_index()
        out = tmp_path / "v1snap"
        out.mkdir()
        meta = {
            "format_version": 1,
            # the arrays below are freshly featurized with the CURRENT
            # slot layout; a true legacy (layout-1) checkpoint is
            # refused instead — see test_old_tech_layout_refused
            "tech_layout": 2,
            "embeddings_dim": index.chunks.dim,
            "lexical_dim": index.chunks.lex_dim,
            "tech_hash_slots": index.chunks.tech_slots,
            "call_capacity": index.call_capacity,
            "counts": {},
        }
        for corpus in (index.chunks, index.artifacts):
            arrays = corpus.state_arrays()
            arrays["emb"] = _np.asarray(arrays["emb"], dtype=_np.float32)
            _np.savez(out / f"{corpus.name}.npz", **arrays)
            meta["counts"][corpus.name] = corpus.count
        (out / "meta.json").write_text(json.dumps(meta))

        req = RetrieveRequest(query="ECONNRESET v2.3.1", return_style="ids_only")
        before = retrieve_evidence(req)["retrieved_ids"]
        reset_index()
        restore_index(str(out))
        assert retrieve_evidence(req)["retrieved_ids"] == before

    def test_int8_checkpoint_restores_under_float_dtype(
        self, populated, tmp_path, tmp_store, monkeypatch
    ):
        """ADVICE r2 (medium): an int8 checkpoint restored under a float
        INDEX_EMBEDDING_DTYPE must dequantize (x/127) — an astype cast
        would leave rows scoring ~127x hotter than fresh unit rows."""
        import json

        from cadence_rag_tpu.core.index import reset_index

        req = RetrieveRequest(query="ECONNRESET v2.3.1",
                              return_style="ids_only")
        before = retrieve_evidence(req)["retrieved_ids"]

        # re-ingest the same corpus under int8 storage and checkpoint it
        monkeypatch.setattr(tmp_store, "index_embedding_dtype", "int8")
        reset_index()
        from cadence_rag_tpu.ingest.ingest import rebuild_index_from_store

        rebuild_index_from_store()
        run_embedding_backfill(batch_size=8)
        save_index(str(tmp_path / "snap8"))
        meta = json.loads((tmp_path / "snap8" / "meta.json").read_text())
        assert meta["emb_storage_dtype"] == "int8"

        # restore under the bf16 default
        monkeypatch.setattr(tmp_store, "index_embedding_dtype", "bfloat16")
        reset_index()
        restore_index(str(tmp_path / "snap8"))
        index = get_index()
        assert index.chunks.emb.dtype != np.int8
        # restored rows must be ~unit-norm (dequantized), not ~127-norm
        emb = np.asarray(index.chunks.emb[: index.chunks.count],
                         dtype=np.float32)
        norms = np.linalg.norm(emb[index.chunks.h_has_emb[: index.chunks.count]],
                               axis=1)
        assert norms.size and np.all(norms < 1.1), norms.max()
        assert retrieve_evidence(req)["retrieved_ids"] == before

    def test_old_tech_layout_refused(self, populated, tmp_path):
        """A checkpoint whose tech slots predate the slot-addressed
        layout must refuse to restore (its slots would silently never
        match queries) with operator guidance."""
        import json

        save_index(str(tmp_path / "snap"))
        meta_path = tmp_path / "snap" / "meta.json"
        meta = json.loads(meta_path.read_text())
        del meta["tech_layout"]  # legacy checkpoints carry no key
        meta_path.write_text(json.dumps(meta))
        reset_index()
        with pytest.raises(ValueError, match="tech slot layout"):
            restore_index(str(tmp_path / "snap"))

    def test_insert_after_restore(self, populated, tmp_path):
        save_index(str(tmp_path / "snap"))
        reset_index()
        restore_index(str(tmp_path / "snap"))
        call_id, n_utt, n_chunks = ingest_transcript(
            CallRef(external_id="ckpt-2"),
            [UtteranceIn(speaker="Raj", start_ts_ms=0, end_ts_ms=900,
                         text="new call about azure migration")],
            ChunkingOptions(target_tokens=10, max_tokens=30, overlap_tokens=2),
        )
        assert n_chunks >= 1
        resp = retrieve_evidence(
            RetrieveRequest(query="azure migration", return_style="ids_only")
        )
        assert resp["retrieved_ids"]


class TestConcurrentSaves:
    def test_async_saves_serialize_and_generations_advance(
            self, populated, tmp_path):
        """Two overlapping save_index calls must not pick the same
        generation and interleave writes on the same filenames (review
        finding: generation derives from re-reading meta.json, and an
        in-flight block=False writer hasn't flipped it yet). The
        per-path save lock serializes them."""
        snap = str(tmp_path / "snap")
        m1 = save_index(snap, block=False)
        m2 = save_index(snap, block=False)  # blocks until writer 1 done
        m1["_writer"].join(timeout=60)
        m2["_writer"].join(timeout=60)
        assert m2["generation"] == m1["generation"] + 1
        # the surviving (latest) generation restores cleanly
        from cadence_rag_tpu.core.index import get_index, reset_index

        reset_index()
        restore_index(snap)
        assert get_index().chunks.count > 0
