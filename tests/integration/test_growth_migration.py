"""Background growth migration (core/index.GrowthMigration): growth must
become an atomic pointer swap — bit-identical to synchronous growth —
with every mutation kind that lands mid-migration replayed onto the new
buffers (serving must never wait on the alloc+copy window)."""

import time

import numpy as np
import pytest

from cadence_rag_tpu.core.index import CorpusIndex, DocRow


def _row(doc_id, dim=16, lex_dim=64, slots=4, started=1000,
         with_emb=True):
    rng = np.random.default_rng(doc_id)
    emb = rng.standard_normal(dim).astype(np.float32)
    emb /= np.linalg.norm(emb)
    sig = rng.integers(-3, 4, size=lex_dim).astype(np.int8)
    return DocRow(
        doc_id=doc_id,
        call_seq=doc_id % 4,
        started_sec=started + doc_id,
        lex_sig=sig,
        lex_dl=10,
        lex_touched=np.flatnonzero(sig).astype(np.int32),
        tech=np.full(slots, doc_id % 97 + 1, dtype=np.int32),
        embedding=emb if with_emb else None,
    )


def _corpus(capacity=64):
    return CorpusIndex(
        "chunks", dim=16, lex_dim=64, tech_slots=4, capacity=capacity,
        emb_dtype="float32",
    )


def _device_state(corpus):
    return {
        "emb": np.asarray(corpus.emb[: corpus.count]),
        "lex": np.asarray(corpus.lex[: corpus.count]),
        "tech": np.asarray(corpus.tech[: corpus.count]),
        "call": np.asarray(corpus.call_idx[: corpus.count]),
        "started": np.asarray(corpus.started[: corpus.count]),
        "has": np.asarray(corpus.has_emb[: corpus.count]),
    }


def _wait_ready(corpus, timeout=30.0):
    mig = corpus._migration
    assert mig is not None
    assert mig.ready.wait(timeout), "migration never became ready"
    return mig


class TestGrowthMigration:
    def test_swap_matches_synchronous_growth(self, tmp_store):
        """Same inserts through migration vs sync growth -> identical
        device state."""
        a, b = _corpus(), _corpus()
        rows = [_row(i) for i in range(1, 61)]
        a.insert(rows)
        b.insert(rows)
        assert a.start_migration(128)
        _wait_ready(a)
        late = [_row(i) for i in range(61, 101)]  # forces growth
        a.insert(late)
        b.insert(late)
        assert a.capacity == 128 and a._migration is None
        sa, sb = _device_state(a), _device_state(b)
        for key in sa:
            np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)

    def test_mid_migration_mutations_replay(self, tmp_store):
        """Every journaled op kind lands after the bulk copy: insert,
        embedding/tech/lex scatter, tombstone."""
        a, b = _corpus(), _corpus()
        rows = [_row(i, with_emb=(i % 3 != 0)) for i in range(1, 61)]
        a.insert(rows)
        b.insert(rows)
        assert a.start_migration(128)
        _wait_ready(a)

        # mutations recorded while the migration is live
        def mutate(c):
            c.insert([_row(200), _row(201)])
            c.set_embeddings([3, 6], np.stack(
                [np.full(16, 0.25, np.float32)] * 2
            ))
            c.set_tech([10, 11], np.full((2, 4), 7, np.int32))
            c.set_lex([12], np.full((1, 64), 2, np.int8))
            c.delete_ids([20, 21])

        mutate(a)
        mutate(b)
        # trigger the swap with a growth-forcing insert (padded slab 64:
        # need 62+64=126 <= the 128 migration target)
        late = [_row(i) for i in range(300, 340)]
        a.insert(late)
        b.insert(late)
        assert a.capacity == 128 and a._migration is None
        sa, sb = _device_state(a), _device_state(b)
        for key in sa:
            np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)
        assert a.tombstones == b.tombstones == 2

    def test_not_ready_falls_back_to_sync(self, tmp_store, monkeypatch):
        c = _corpus()
        c.insert([_row(i) for i in range(1, 61)])
        assert c.start_migration(128)
        # make the migration permanently "not ready"
        mig = c._migration
        monkeypatch.setattr(mig.ready, "is_set", lambda: False)
        c.insert([_row(i) for i in range(100, 140)])
        assert c.capacity == 128  # sync fallback grew
        assert c._migration is None and mig.cancelled

    def test_compaction_cancels_migration(self, tmp_store):
        c = _corpus()
        c.insert([_row(i) for i in range(1, 61)])
        assert c.start_migration(128)
        _wait_ready(c)
        c.delete_ids(list(range(1, 31)))
        c.compact()
        assert c._migration is None
        # growth after the cancelled migration still works (sync path)
        c.insert([_row(i) for i in range(500, 620)])
        assert c.count == 30 + 120

    def test_too_small_target_falls_back(self, tmp_store):
        c = _corpus()
        c.insert([_row(i) for i in range(1, 61)])
        assert c.start_migration(128)
        _wait_ready(c)
        # one insert needing MORE than the migration target
        c.insert([_row(i) for i in range(1000, 1200)])
        assert c.capacity >= 260 and c._migration is None
        assert c.count == 60 + 200

    def test_idempotent_start(self, tmp_store):
        c = _corpus()
        c.insert([_row(i) for i in range(1, 61)])
        assert c.start_migration(128)
        assert not c.start_migration(128)  # already migrating there
        assert not c.start_migration(64)   # below current capacity? no-op
        _wait_ready(c)

    def test_queries_correct_through_migration_window(self, tmp_store):
        """Queries served while a migration is live read the old buffers
        and stay correct; post-swap queries see everything."""
        c = _corpus()
        rows = [_row(i) for i in range(1, 61)]
        c.insert(rows)
        assert c.start_migration(128)
        probe = np.asarray(c.emb[41])[None].astype(np.float32)

        def q():
            out = c.query(
                probe, np.zeros((1, 64), np.float32),
                np.zeros((1, 4), np.int32), np.ones((1, 8), bool),
                np.zeros(1, np.int32), np.full(1, 2**31 - 1, np.int32),
                k_dense=3, k_lex=3, k_tech=3,
            )
            ids, _s, counts = out["dense"]
            return int(ids[0][0])

        assert q() == 42
        _wait_ready(c)
        assert q() == 42
        c.insert([_row(i) for i in range(700, 740)])  # swap (need 124)
        assert c._migration is None and c.capacity == 128
        assert q() == 42
