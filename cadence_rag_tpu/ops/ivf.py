"""IVF (inverted-file) ANN index: device k-means build + probed query.

The large-corpus ANN path. pgvector's HNSW is a pointer-chasing graph —
hostile to a vector machine: each hop gathers ef*M full embedding rows, so
at ef_search=80 a 1M-doc traversal moves as many bytes as the brute-force
matmul, which streams the rows at memory bandwidth. The dense-hardware
alternative is IVF (Faiss's workhorse; PAPERS.md "The Faiss library"):

- build: spherical k-means ON DEVICE — assignment is a (N,dim)x(dim,C)
  matmul + argmax, update is a scatter-add; O(iters) passes;
- query: score C centroids (tiny matmul), probe the top-``nprobe``
  clusters, gather only those buckets' rows, exact-score the gathered
  subset. Per query it reads nprobe*bucket_cap rows instead of N — the win
  grows with corpus size (at 1M docs, ~15x less HBM traffic per query).

``nprobe`` is the recall knob (ef_search analogue). Padded fixed-size
buckets keep shapes static; bucket overflow spills to the always-scanned
tail bucket so results stay exact-over-probed-set.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .topk import NEG_INF


def _kmeans_body(
    emb: jax.Array, key: jax.Array, n_clusters: int, iters: int
) -> Tuple[jax.Array, jax.Array]:
    n, dim = emb.shape
    init_idx = jax.random.choice(key, n, shape=(n_clusters,), replace=False)
    centroids = emb[init_idx].astype(jnp.float32)

    def step(centroids, _):
        scores = jax.lax.dot_general(
            emb, centroids.astype(emb.dtype),
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )                                            # (N, C)
        assign = jnp.argmax(scores, axis=1)          # (N,)
        sums = jnp.zeros((n_clusters, dim), jnp.float32).at[assign].add(
            emb.astype(jnp.float32)
        )
        counts = jnp.zeros((n_clusters,), jnp.float32).at[assign].add(1.0)
        norms = jnp.linalg.norm(sums, axis=1, keepdims=True)
        fresh = sums / jnp.maximum(norms, 1e-6)
        keep_old = (counts == 0)[:, None]
        new_centroids = jnp.where(keep_old, centroids, fresh)
        return new_centroids, None

    centroids, _ = jax.lax.scan(step, centroids, None, length=iters)
    final_scores = jax.lax.dot_general(
        emb, centroids.astype(emb.dtype),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return centroids, jnp.argmax(final_scores, axis=1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("n_clusters", "iters"))
def kmeans(
    emb: jax.Array, key: jax.Array, *, n_clusters: int, iters: int = 10
) -> Tuple[jax.Array, jax.Array]:
    """Spherical k-means over unit vectors. Returns (centroids (C, dim) f32,
    assignments (N,) int32). Empty clusters keep their previous centroid."""
    return _kmeans_body(emb, key, n_clusters, iters)


@partial(
    jax.jit,
    static_argnames=("n", "n_clusters", "iters", "seed", "dequant"),
)
def ivf_build(
    emb: jax.Array, *, n: int, n_clusters: int, iters: int = 10,
    seed: int = 0, dequant: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Slice + (optional int8) dequantize + k-means as ONE program.

    This is the multi-host gang build (parallel/oplog.py): the leader
    mirrors {n, n_clusters, iters, seed, dequant} over the op-log and
    every process runs this identical deterministic program over the
    global sharded embeddings — replicated outputs let each process read
    the assignments back and pack identical buckets host-side, with no
    (C, dim) centroid shipping over TCP."""
    snap = jax.lax.slice_in_dim(emb, 0, n, axis=0)
    if dequant:
        # int8 rows store round(x*127); k-means must run in float space
        # (casting float centroids back to int8 degenerates them)
        snap = snap.astype(jnp.float32) / 127.0
    return _kmeans_body(snap, jax.random.PRNGKey(seed), n_clusters, iters)


def build_buckets(
    assignments: np.ndarray, n_clusters: int, bucket_cap: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack document positions into padded per-cluster buckets (host side;
    runs once per build/compaction). Returns (buckets (C, cap) int32 with
    -1 padding, overflow (V,) int32 positions that exceeded their bucket)."""
    buckets = np.full((n_clusters, bucket_cap), -1, dtype=np.int32)
    fill = np.zeros(n_clusters, dtype=np.int64)
    overflow = []
    for pos, cluster in enumerate(np.asarray(assignments)):
        c = int(cluster)
        if fill[c] < bucket_cap:
            buckets[c, fill[c]] = pos
            fill[c] += 1
        else:
            overflow.append(pos)
    return buckets, np.asarray(overflow, dtype=np.int32)


@partial(jax.jit, static_argnames=("k", "nprobe"))
def ivf_topk(
    q_emb: jax.Array,       # (B, dim) f32
    emb: jax.Array,         # (N, dim) storage dtype
    centroids: jax.Array,   # (C, dim) f32
    buckets: jax.Array,     # (C, cap) int32, -1 padded
    overflow: jax.Array,    # (V,) int32, -1 padded (always scanned)
    mask: jax.Array,        # (B, N) bool
    *,
    k: int,
    nprobe: int,
) -> Tuple[jax.Array, jax.Array]:
    """-> (scores (B, k), positions (B, k)); positions -1 where no hit."""
    c_scores = q_emb @ centroids.T                   # (B, C)
    nprobe = min(nprobe, centroids.shape[0])
    _, probe = jax.lax.top_k(c_scores, nprobe)       # (B, nprobe)
    # With a tiny IVF config (few clusters / small bucket_cap) the probed
    # candidate axis can be shorter than k; clamp and pad back so callers
    # always get (B, k) and the trace never fails.
    n_cand = nprobe * buckets.shape[1] + overflow.shape[0]
    k_eff = min(k, n_cand)

    def one_query(q, probed, row_mask):
        cand = buckets[probed].reshape(-1)           # (nprobe*cap,)
        cand = jnp.concatenate([cand, overflow])     # + spill tail
        valid = cand >= 0
        safe = jnp.where(valid, cand, 0)
        rows = emb[safe]                             # (L, dim) gather
        scores = rows.astype(jnp.float32) @ q.astype(jnp.float32)
        if emb.dtype == jnp.int8:
            # int8 rows store round(x*127): rescale so reported scores
            # share the exact/ann lanes' cosine scale (ranking-neutral)
            scores = scores * (1.0 / 127.0)
        keep = valid & row_mask[safe]
        scores = jnp.where(keep, scores, NEG_INF)
        top_scores, top_i = jax.lax.top_k(scores, k_eff)
        top_pos = jnp.where(
            jnp.isfinite(top_scores), safe[top_i], -1
        )
        if k_eff < k:
            pad = k - k_eff
            top_scores = jnp.concatenate(
                [top_scores, jnp.full((pad,), NEG_INF, top_scores.dtype)]
            )
            top_pos = jnp.concatenate(
                [top_pos, jnp.full((pad,), -1, top_pos.dtype)]
            )
        return top_scores, top_pos

    # The per-query gather materializes (group, n_cand, dim); at 1M docs
    # with nprobe=80 a full batch-64 vmap wants ~20 GB. Process the batch
    # in groups sized to ~1 GB of gathered rows (vmap whole batch when it
    # fits). Note the batched-IVF tension this implies: large batches
    # probe most clusters collectively, so IVF's traffic win is greatest
    # at small batch / low latency — the planner keeps ann for bulk loads.
    batch = q_emb.shape[0]
    bytes_per_query = n_cand * emb.shape[1] * emb.dtype.itemsize
    group = max(1, min(batch, (1 << 30) // max(bytes_per_query, 1)))
    if group >= batch:
        return jax.vmap(one_query)(q_emb, probe, mask)
    n_groups = -(-batch // group)
    padded_b = n_groups * group

    def pad_b(arr):
        if arr.shape[0] == padded_b:
            return arr
        reps = jnp.broadcast_to(
            arr[:1], (padded_b - arr.shape[0],) + arr.shape[1:]
        )
        return jnp.concatenate([arr, reps], axis=0)

    gq = pad_b(q_emb).reshape(n_groups, group, -1)
    gp = pad_b(probe).reshape(n_groups, group, -1)
    gm = pad_b(mask).reshape(n_groups, group, -1)
    scores, pos = jax.lax.map(
        lambda args: jax.vmap(one_query)(*args), (gq, gp, gm)
    )
    return (scores.reshape(padded_b, -1)[:batch],
            pos.reshape(padded_b, -1)[:batch])
