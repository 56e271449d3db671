"""ANN recall gate: recall@k of the ANN dense path vs exact scan.

BASELINE.md gate config 2: "HNSW index build + ef_search=80 query lane at
100k chunks, recall@10 vs exact scan". The ANN lane is
``lax.approx_max_k`` with ef_search mapped to its recall_target
(engine/planner.py); this gate measures the achieved recall against the
f32 exact scan at the reference's operating point and fails below
threshold — the same quality contract pgvector's ef_search=80 is held to.
On a backend without a native approx_max_k lowering (CPU, GPU) the call
is an exact sort, so ``ann`` recall is 1.0 by construction there; the
``ivf`` and ``hnsw`` modes are the approximate paths this gate measures
everywhere.

Filtered-ANN guarantee: pgvector holds this quality bar UNDER FILTERS too
(`hnsw.iterative_scan=relaxed_order`, reference app/retrieve.py:290-300).
``--densities`` gates recall at selective mask densities, with the
worst-case CONTIGUOUS mask shape (date windows / call filters select
insertion-contiguous rows).

Usage: python -m cadence_rag_tpu.evals.ann_recall_gate [--n 100000]
       [--queries 64] [--k 10] [--min-recall 0.95] [--mode ann|ivf|hnsw]
       [--densities 1.0,0.05,0.003] [--mask-shape contiguous|random]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np


def measure_recall(
    n: int = 100_000,
    n_queries: int = 64,
    k: int = 10,
    mode: str = "ann",
    ef_search: int = 80,
    seed: int = 0,
    batch: int = 16,
    density: float = 1.0,
    mask_shape: str = "contiguous",
) -> Dict:
    import jax
    import jax.numpy as jnp

    from ..engine.planner import recall_target_for_ef_search
    from ..ops import topk

    key = jax.random.PRNGKey(seed)
    k_docs, k_q = jax.random.split(key)

    # Clustered synthetic corpus: text embeddings are not uniform on the
    # sphere — they concentrate around topic directions. A mixture of
    # n/64 unit centers with ~1/sqrt(dim)-sigma spread approximates that; queries
    # are perturbed documents (how retrieval queries actually behave).
    n_centers = max(64, n // 64)

    @jax.jit
    def gen_docs():
        kc, ka, kn = jax.random.split(k_docs, 3)
        centers = jax.random.normal(kc, (n_centers, 1024), dtype=jnp.float32)
        centers = centers / jnp.linalg.norm(centers, axis=1, keepdims=True)
        assign = jax.random.randint(ka, (n,), 0, n_centers)
        # sigma ~ 1/sqrt(dim): keeps cos(doc, center) ~ 0.85 so the corpus
        # has the topical concentration real embeddings exhibit
        docs = centers[assign] + 0.02 * jax.random.normal(
            kn, (n, 1024), dtype=jnp.float32
        )
        return (docs / jnp.linalg.norm(docs, axis=1, keepdims=True)).astype(
            jnp.bfloat16
        )

    docs = jax.block_until_ready(gen_docs())
    rng = np.random.default_rng(seed + 1)
    from .filtered_recall_sweep import _make_mask

    mask_row = _make_mask(n, density, mask_shape, rng)
    valid = np.flatnonzero(mask_row)
    # filtered queries look for documents INSIDE the filtered set
    base = np.asarray(
        docs[rng.choice(valid, size=n_queries, replace=len(valid) < n_queries)],
        dtype=np.float32,
    )
    queries = base + 0.012 * rng.standard_normal((n_queries, 1024)).astype(
        np.float32
    )
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)

    recall_target = recall_target_for_ef_search(ef_search)

    exact_fn = jax.jit(
        lambda q, e, m: topk.masked_topk_exact(topk.dense_scores(q, e), m, k)
    )
    if mode == "ivf":
        from ..ops.ivf import build_buckets, ivf_topk, kmeans

        n_clusters = max(16, int(np.sqrt(n)))
        centroids, assign = kmeans(
            docs, jax.random.PRNGKey(7), n_clusters=n_clusters, iters=10
        )
        bucket_cap = int(2.0 * n / n_clusters)
        buckets_np, overflow_np = build_buckets(
            np.asarray(assign), n_clusters, bucket_cap
        )
        if len(overflow_np) == 0:
            overflow_np = np.full(8, -1, dtype=np.int32)
        buckets = jnp.asarray(buckets_np)
        overflow = jnp.asarray(overflow_np)
        nprobe = max(4, int(n_clusters * 0.08))
        ann_fn = jax.jit(
            lambda q, e, m: ivf_topk(
                q, e, centroids, buckets, overflow, m, k=k, nprobe=nprobe
            )
        )
    elif mode == "hnsw":
        if density < 1.0:
            raise ValueError(
                "hnsw mode is the unfiltered CPU cross-check; its search "
                "has no mask plumbing — gate filtered recall with ann/ivf"
            )
        from ..native.hnsw import HnswIndex

        docs_f32 = np.asarray(docs, dtype=np.float32)
        index = HnswIndex(docs_f32, m=16, ef_construction=64)

        def ann_fn(q, e, m):
            sims, idx = index.search(np.asarray(q), k=k, ef_search=ef_search)
            return jnp.asarray(sims), jnp.asarray(idx)
    else:
        ann_fn = jax.jit(
            lambda q, e, m: topk.masked_topk_approx(
                topk.dense_scores(q, e), m, k, recall_target
            )
        )

    hits = total = 0
    kk = min(k, len(valid))
    for start in range(0, n_queries, batch):
        q = jnp.asarray(queries[start : start + batch])
        mask = jnp.asarray(np.broadcast_to(mask_row, (q.shape[0], n)).copy())
        _, exact_idx = jax.block_until_ready(exact_fn(q, docs, mask))
        _, ann_idx = jax.block_until_ready(ann_fn(q, docs, mask))
        exact_idx = np.asarray(exact_idx)
        ann_idx = np.asarray(ann_idx)
        for row in range(exact_idx.shape[0]):
            hits += len(
                set(map(int, exact_idx[row, :kk]))
                & set(map(int, ann_idx[row, :kk]))
            )
            total += kk
    return {
        "n": n, "k": k, "queries": n_queries, "mode": mode,
        "ef_search": ef_search, "recall_target": round(recall_target, 4),
        "density": density, "mask_shape": mask_shape,
        "recall_at_k": round(hits / max(total, 1), 4),
    }


def main() -> None:
    parser = argparse.ArgumentParser(description="ANN recall gate")
    parser.add_argument("--n", type=int, default=100_000)
    parser.add_argument("--queries", type=int, default=64)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--min-recall", type=float, default=0.95)
    parser.add_argument("--mode", choices=["ann", "ivf", "hnsw"], default="ann")
    parser.add_argument("--ef-search", type=int, default=80)
    parser.add_argument(
        "--densities", default="1.0",
        help="comma list of mask densities to gate (1.0 = unfiltered)",
    )
    parser.add_argument(
        "--mask-shape", choices=["contiguous", "random"], default="contiguous",
        help="contiguous = the worst case (date/call filters)",
    )
    args = parser.parse_args()
    failed = False
    for density in (float(x) for x in args.densities.split(",")):
        result = measure_recall(
            n=args.n, n_queries=args.queries, k=args.k,
            mode=args.mode, ef_search=args.ef_search,
            density=density, mask_shape=args.mask_shape,
        )
        print(json.dumps(result))
        if result["recall_at_k"] < args.min_recall:
            failed = True
            print(
                f"GATE FAILED: recall@{args.k} {result['recall_at_k']} < "
                f"{args.min_recall} at density {density}",
                file=sys.stderr,
            )
    if failed:
        sys.exit(1)
    print("GATE PASSED")


if __name__ == "__main__":
    main()
