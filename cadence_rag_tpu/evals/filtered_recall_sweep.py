"""Filtered-ANN recall sweep: approx_max_k recall under selective masks.

pgvector guarantees the ANN lane keeps returning k good results under
filters (`hnsw.iterative_scan = relaxed_order` + ef_search; reference:
app/retrieve.py:290-300). Our ANN primitive is ``lax.approx_max_k``; where
the backend lowers it natively as a partial reduce over contiguous
windows (on CPU and GPU it is an exact sort, and recall is 1.0), a
selective filter mask changes its statistics two ways:

- RANDOM masks (valid rows scattered): the true top-k land in random
  windows; the collision probability among k winners is ~C(k,2)/L and
  does NOT depend on density — recall should hold.
- CONTIGUOUS masks (date windows; call filters — a call's rows are
  inserted contiguously): all valid rows concentrate in ~density*L
  windows, so top-k collisions scale as 1/density and recall collapses
  at low density.

This sweep measures recall@k vs the masked exact scan across
(density x mask-shape x recall_target) on the live backend, at the same
(B, N) shapes the serving path uses. One compile per recall_target
(masks are inputs). The results calibrate:

  1. the density-aware planner escalation (engine/planner.py);
  2. the ef_search -> recall_target map.

Usage:
  python -m cadence_rag_tpu.evals.filtered_recall_sweep
      [--n 1048576] [--batch 32] [--k 10]
      [--densities 0.003,0.01,0.05,0.25,1.0]
      [--targets 0.8,0.9,0.95,0.99,0.998]
      [--mask-shapes contiguous,random]
"""

from __future__ import annotations

import argparse
import json
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = np.float32(-np.inf)


@partial(jax.jit, static_argnames=("n", "dim", "n_centers"))
def _gen_docs(key, *, n, dim=1024, n_centers=4096):
    """Clustered unit vectors (same geometry as ann_recall_gate)."""
    kc, ka, kn = jax.random.split(key, 3)
    centers = jax.random.normal(kc, (n_centers, dim), dtype=jnp.float32)
    centers = centers / jnp.linalg.norm(centers, axis=1, keepdims=True)
    assign = jax.random.randint(ka, (n,), 0, n_centers)
    docs = centers[assign] + 0.02 * jax.random.normal(
        kn, (n, dim), dtype=jnp.float32
    )
    return (docs / jnp.linalg.norm(docs, axis=1, keepdims=True)).astype(
        jnp.bfloat16
    )


# masks ship as ONE (N,) bool row and broadcast on device: a (B, N)
# host mask would be B x N bytes of H2D per call
@partial(jax.jit, static_argnames=("k",))
def _exact(q, docs, mask_row, *, k):
    scores = jax.lax.dot_general(
        q.astype(docs.dtype), docs, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return jax.lax.top_k(
        jnp.where(mask_row[None, :], scores, NEG_INF), k
    )


@partial(jax.jit, static_argnames=("k", "recall_target"))
def _approx(q, docs, mask_row, *, k, recall_target):
    scores = jax.lax.dot_general(
        q.astype(docs.dtype), docs, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    masked = jnp.where(mask_row[None, :], scores, NEG_INF)
    vals, idx = jax.lax.approx_max_k(
        masked, k, recall_target=recall_target, aggregate_to_topk=True
    )
    svals, order = jax.lax.top_k(vals, k)
    return svals, jnp.take_along_axis(idx, order, axis=-1)


@jax.jit
def _pick_queries(docs, pick, noise):
    base = docs[pick].astype(jnp.float32) + noise
    return base / jnp.linalg.norm(base, axis=1, keepdims=True)


def _make_mask(n: int, density: float, shape: str, rng) -> np.ndarray:
    """One (N,) validity row; every query in a batch shares the
    span/selection so the exact/approx comparison is apples-to-apples."""
    if density >= 1.0:
        return np.ones(n, dtype=bool)
    m = max(1, int(round(n * density)))
    row = np.zeros(n, dtype=bool)
    if shape == "contiguous":
        start = int(rng.integers(0, n - m + 1))
        row[start : start + m] = True
    else:
        row[rng.choice(n, size=m, replace=False)] = True
    return row


def run_sweep(
    n: int,
    batch: int,
    k: int,
    densities,
    targets,
    mask_shapes,
    seed: int = 0,
    rounds: int = 4,
):
    docs = jax.block_until_ready(_gen_docs(jax.random.PRNGKey(seed), n=n))
    rng = np.random.default_rng(seed + 1)
    results = []
    for shape in mask_shapes:
        for density in densities:
            hits = {t: 0 for t in targets}
            total = 0
            t_exact = 0.0
            t_approx = {t: 0.0 for t in targets}
            for r in range(rounds):
                mask_np = _make_mask(n, density, shape, rng)
                valid = np.flatnonzero(mask_np)
                # queries perturbed from docs INSIDE the mask — a filtered
                # retrieval looks for documents in the filtered set
                pick = rng.choice(valid, size=batch, replace=len(valid) < batch)
                noise = 0.012 * rng.standard_normal(
                    (batch, 1024)
                ).astype(np.float32)
                q = _pick_queries(
                    docs, jnp.asarray(pick.astype(np.int32)),
                    jnp.asarray(noise),
                )
                mask = jnp.asarray(mask_np)
                if r == 0:
                    # warm every program OUTSIDE the timed window: the
                    # first call per (target) jit-compiles and would swamp
                    # approx_ms
                    np.asarray(_exact(q, docs, mask, k=k)[1])
                    for t in targets:
                        np.asarray(
                            _approx(q, docs, mask, k=k, recall_target=t)[1]
                        )
                # time THROUGH the host readback (the result the caller
                # consumes)
                t0 = time.perf_counter()
                exact_idx = np.asarray(_exact(q, docs, mask, k=k)[1])
                t_exact += time.perf_counter() - t0
                kk = min(k, len(valid))
                for t in targets:
                    t0 = time.perf_counter()
                    idx = np.asarray(
                        _approx(q, docs, mask, k=k, recall_target=t)[1]
                    )
                    t_approx[t] += time.perf_counter() - t0
                    for row in range(batch):
                        hits[t] += len(
                            set(map(int, exact_idx[row, :kk]))
                            & set(map(int, idx[row, :kk]))
                        )
                total += batch * kk
            for t in targets:
                rec = {
                    "n": n, "k": k, "batch": batch, "mask": shape,
                    "density": density,
                    "recall_target": t,
                    "recall_at_k": round(hits[t] / max(total, 1), 4),
                    "approx_ms": round(t_approx[t] / rounds * 1e3, 2),
                    "exact_ms": round(t_exact / rounds * 1e3, 2),
                }
                results.append(rec)
                print(json.dumps(rec), flush=True)
    return results


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=1_048_576)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--densities", default="0.003,0.01,0.05,0.25,1.0")
    p.add_argument("--targets", default="0.95")
    p.add_argument("--mask-shapes", default="contiguous,random")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    run_sweep(
        n=args.n, batch=args.batch, k=args.k,
        densities=[float(x) for x in args.densities.split(",")],
        targets=[float(x) for x in args.targets.split(",")],
        mask_shapes=args.mask_shapes.split(","),
        seed=args.seed, rounds=args.rounds,
    )


if __name__ == "__main__":
    main()
