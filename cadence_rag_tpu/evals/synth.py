"""Synthetic corpus installer for large-scale benchmarks.

Populating a 1M-row index through the ingest path would move ~6 GB of
host-generated arrays host->device and spend minutes in per-row Python. For
benchmarking, the corpus content is irrelevant — only its shapes and
distributions matter — so this generates the document arrays DIRECTLY ON
DEVICE (jax.random inside one jit) at the index's padded capacity and
installs them into a live ``CorpusIndex``, syncing the cheap host-side
mirrors. The resulting index serves the exact production path
(engine/retrieve.py -> ops/fused.py).

Optionally bulk-inserts matching metadata rows into the SQLite store
(executemany) so evidence-pack serving (store prefetch) is measurable too.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.index import INT32_MIN, CorpusIndex, _next_pow2

_WORDS = [
    "object", "store", "tiering", "latency", "rollback", "gateway",
    "cluster", "retry", "budget", "bake-off", "lenovo", "azure",
]


def install_synthetic_corpus(
    corpus: CorpusIndex,
    n: int,
    n_calls: int,
    seed: int = 0,
) -> None:
    """Fill ``corpus`` with n synthetic rows (doc ids 1..n), on device."""
    import jax
    import jax.numpy as jnp

    cap = max(corpus.capacity, _next_pow2(max(n, 8)))
    dim, lex_dim, slots = corpus.dim, corpus.lex_dim, corpus.tech_slots
    key = jax.random.PRNGKey(seed)
    k_emb, k_lex, k_tech, k_call, k_ts = jax.random.split(key, 5)

    def place(arr, spec_all=True):
        if corpus.row_sharding is None:
            return arr
        if spec_all:
            return jax.device_put(arr, corpus.row_sharding)
        from jax.sharding import NamedSharding, PartitionSpec

        return jax.device_put(arr, NamedSharding(
            corpus.row_sharding.mesh,
            PartitionSpec(corpus.row_sharding.spec[0]),
        ))

    # Two generation programs keep peak HBM below (f32 emb + int8 lex) at
    # 1M x 4k shapes; padding rows beyond n get started=INT32_MIN and
    # has_emb=False so every lane's filter mask excludes them.
    @jax.jit
    def gen_emb():
        emb = jax.random.normal(k_emb, (cap, dim), dtype=jnp.float32)
        emb = emb / jnp.linalg.norm(emb, axis=1, keepdims=True)
        if corpus.emb_dtype == jnp.int8:
            # quantize like core/index._encode_emb (a plain cast would
            # truncate unit vectors to all-zero rows)
            return jnp.clip(
                jnp.round(emb * 127.0), -127, 127
            ).astype(jnp.int8)
        return emb.astype(corpus.emb_dtype)

    @jax.jit
    def gen_rest():
        lex = jax.random.randint(k_lex, (cap, lex_dim), -4, 5, dtype=jnp.int8)
        tech = jax.random.randint(k_tech, (cap, slots), 1, 5000, dtype=jnp.int32)
        call_idx = jax.random.randint(k_call, (cap,), 0, n_calls, dtype=jnp.int32)
        rows = jnp.arange(cap, dtype=jnp.int32)
        started = jnp.where(
            rows < n,
            jax.random.randint(
                k_ts, (cap,), 1_600_000_000, 1_750_000_000, dtype=jnp.int32
            ),
            jnp.int32(INT32_MIN),
        )
        has_emb = rows < n
        return lex, tech, call_idx, started, has_emb

    with corpus.lock:
        emb = place(gen_emb())
        lex, tech, call_idx, started, has_emb = gen_rest()
        corpus.capacity = cap
        corpus.emb = emb
        corpus.lex = place(lex)
        corpus.tech = place(tech)
        corpus.call_idx = place(call_idx, spec_all=False)
        corpus.started = place(started, spec_all=False)
        corpus.has_emb = place(has_emb, spec_all=False)
        jax.block_until_ready(corpus.emb)

        host = jax.device_get((corpus.call_idx, corpus.started))
        corpus.h_ids = np.zeros(cap, dtype=np.int64)
        corpus.h_ids[:n] = np.arange(1, n + 1)
        # np.array (copy): device_get returns read-only buffers, and the
        # mirrors must stay writable for subsequent inserts/deletes
        corpus.h_call = np.array(host[0])
        corpus.h_started = np.array(host[1])
        corpus.h_has_emb = np.zeros(cap, dtype=bool)
        corpus.h_has_emb[:n] = True
        corpus._id_to_pos = {i + 1: i for i in range(n)}
        rng = np.random.default_rng(seed)
        corpus.doc_freq = rng.integers(
            1, max(n // 4, 2), size=lex_dim
        ).astype(np.int64)
        corpus.dl_sum = 12 * n
        corpus.emb_rows = n
        corpus.count = n
        corpus.ivf = None
        corpus._ivf_overflow_host = np.zeros(0, dtype=np.int32)


def install_synthetic_cold(
    corpus: CorpusIndex, n: int, n_calls: int, seed: int = 2,
    block: int = 262144,
) -> None:
    """Fill ``corpus``'s HOST cold tier with n synthetic rows (doc ids
    continue after the hot tier), vectorized — the DocRow insert path is
    ~minutes at millions of rows. Updates tier arrays + tier df/dl
    deltas AND the corpus-wide lexical stats, exactly like
    _cold_insert_locked does per row."""
    import jax.numpy as jnp

    tier = corpus._cold_tier()
    rng = np.random.default_rng(seed)
    with corpus.lock:
        start = tier.count
        need = start + n
        if need > tier.capacity:
            tier._alloc(_next_pow2(need, lo=1024))
        first_id = int(corpus.h_ids[: corpus.count].max(initial=0)) + 1
        if tier.count:
            first_id = max(first_id, int(tier.ids[: tier.count].max()) + 1)
        for b0 in range(0, n, block):
            b = min(block, n - b0)
            emb = rng.standard_normal((b, corpus.dim)).astype(np.float32)
            emb /= np.linalg.norm(emb, axis=1, keepdims=True)
            sl = slice(start + b0, start + b0 + b)
            tier.emb[sl] = corpus._encode_emb(emb)
            tier.lex[sl] = rng.integers(
                -4, 5, size=(b, corpus.lex_dim)
            ).astype(np.int8)
            tier.tech[sl] = rng.integers(
                1, 5000, size=(b, corpus.tech_slots)
            ).astype(np.int32)
            tier.call_idx[sl] = rng.integers(
                0, n_calls, size=b
            ).astype(np.int32)
            tier.started[sl] = rng.integers(
                1_600_000_000, 1_750_000_000, size=b
            ).astype(np.int32)
            tier.has_emb[sl] = True
        ids = np.arange(first_id, first_id + n, dtype=np.int64)
        tier.ids[start:start + n] = ids
        tier._id_to_pos.update(
            (int(d), start + i) for i, d in enumerate(ids)
        )
        tier.count += n
        tier.emb_rows += n
        # lexical stats: tier delta + corpus-wide totals (scoring uses
        # the corpus totals so hot and cold rows weight identically)
        df_add = (tier.lex[start:start + n] != 0).sum(axis=0)
        dl_add = int(np.abs(
            tier.lex[start:start + n].astype(np.int32)
        ).sum())
        tier.df += df_add
        tier.dl_sum += dl_add
        corpus.doc_freq += df_add
        corpus.dl_sum += dl_add


def synth_text(i: int) -> str:
    return (
        f"chunk {i} discussing {_WORDS[i % len(_WORDS)]} and "
        f"{_WORDS[(i * 7) % len(_WORDS)]} with ECONNRESET v2.{i % 9}.1"
    )


def bulk_store_rows(
    store,
    n_chunks: int,
    n_artifacts: int,
    n_calls: int,
    call_ids: Optional[List[str]] = None,
) -> List[str]:
    """Matching metadata rows (chunk_id/artifact_chunk_id = 1..n) via
    executemany — seconds at 1M rows instead of minutes row-at-a-time."""
    from ..utils.timeutil import now_utc, to_iso

    now = to_iso(now_utc())
    if call_ids is None:
        call_ids = [f"00000000-0000-4000-8000-{s:012d}" for s in range(n_calls)]
        with store.tx() as conn:
            conn.executemany(
                "INSERT INTO calls (call_id, call_seq, started_at, title) "
                "VALUES (?,?,?,?)",
                [(call_ids[s], s, now, f"bench call {s}")
                 for s in range(n_calls)],
            )
    with store.tx() as conn:
        conn.executemany(
            "INSERT INTO chunks (chunk_id, call_id, call_started_at, speaker,"
            " start_ts_ms, end_ts_ms, token_count, text, tech_tokens, lex_dl)"
            " VALUES (?,?,?,?,?,?,?,?,?,?)",
            (
                (i + 1, call_ids[i % n_calls], now, "A", 0, 1000, 12,
                 synth_text(i), "[]", 10)
                for i in range(n_chunks)
            ),
        )
        conn.executemany(
            "INSERT INTO analysis_artifacts (artifact_id, call_id, "
            "call_started_at, kind, content, token_count, tech_tokens) "
            "VALUES (?,?,?,?,?,?,?)",
            (
                (i + 1, call_ids[i % n_calls], now, "summary",
                 f"artifact {i} about the rollout", 6, "[]")
                for i in range(n_artifacts)
            ),
        )
        conn.executemany(
            "INSERT INTO artifact_chunks (artifact_chunk_id, artifact_id, "
            "call_id, call_started_at, kind, ordinal, content, token_count, "
            "tech_tokens, lex_dl) VALUES (?,?,?,?,?,?,?,?,?,?)",
            (
                (i + 1, i + 1, call_ids[i % n_calls], now, "summary", 0,
                 f"artifact {i} about the rollout", 6, "[]", 6)
                for i in range(n_artifacts)
            ),
        )
    return call_ids
