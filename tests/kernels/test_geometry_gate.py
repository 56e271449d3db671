"""Realistic-geometry gate harness at CPU-test scale.

The 1M run is the CLI (python -m cadence_rag_tpu.evals.geometry_gate);
here we exercise run_gates() end-to-end on a small clustered corpus and
check the eps-recall semantics that make the int8 gate honest: id-recall
can dip on near-tie-saturated geometry while every retrieved doc stays
within quantization noise of the true top-k.
"""

import numpy as np

from cadence_rag_tpu.evals.geometry_gate import run_gates


def _clustered_corpus(n=4096, dim=128, clusters=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, clusters, n)
    docs = centers[assign] + 0.05 * rng.standard_normal((n, dim)).astype(
        np.float32
    )
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    pick = rng.choice(n, 32, replace=False)
    queries = docs[pick] + 0.02 * rng.standard_normal((32, dim)).astype(
        np.float32
    )
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return docs.astype(np.float32), queries.astype(np.float32)


class TestGeometryGate:
    def test_run_gates_small(self):
        docs, queries = _clustered_corpus()
        out = run_gates(docs, queries, k=10, recall_target=0.95,
                        skip_ivf=True)
        assert out["n"] == docs.shape[0]
        assert out["ann_recall"] >= 0.9, out
        # eps-recall dominates id-recall by construction and must be
        # ~perfect at eps=1e-2 (quantization noise band)
        assert out["int8_eps_recall"] >= out["int8_recall"] - 1e-9, out
        assert out["int8_eps_recall"] >= 0.99, out
        assert out["int8_score_loss_p99"] <= 2e-2, out

    def test_eps_recall_tightens_with_smaller_eps(self):
        docs, queries = _clustered_corpus(seed=1)
        wide = run_gates(docs, queries, k=10, recall_target=0.95,
                         skip_ivf=True, int8_eps=1e-2)
        tight = run_gates(docs, queries, k=10, recall_target=0.95,
                          skip_ivf=True, int8_eps=1e-6)
        assert tight["int8_eps_recall"] <= wide["int8_eps_recall"] + 1e-9
