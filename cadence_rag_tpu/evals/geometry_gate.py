"""Recall/quantization gates on REALISTIC embedding geometry.

The synthetic gates (ann_recall_gate, int8 worst-case tests) run on random
or mixture-of-gaussian vectors; this asks whether approx_max_k recall
targets, int8 quantization, and the IVF regime hold on real embedding-model
geometry at scale. This harness runs the same three gates on either:

- ``--npz PATH``: any external (N, dim) f32 dump (e.g. vectors exported
  from the production Qwen3-Embedding-4B service; pass ``--query-npz``
  for real query vectors, else queries are held-out perturbations), or
- the default: the TUNED in-process embedder
  (artifacts/embedder/tuned_small_v1.npz) encoding a generated
  domain-style corpus — transformer-embedding geometry (topic clusters,
  anisotropic spectrum), not synthetic gaussians. Queries are encoded
  PARAPHRASES (different template, same topic), which is how retrieval
  queries actually relate to documents.

Gates (each prints measured vs floor; exit 1 on failure):
- ann:  approx_max_k recall@k vs the exact f32 scan at the production
        recall_target
- int8: recall@k of int8-quantized-storage scoring vs the exact f32
        ranking (the INDEX_EMBEDDING_DTYPE=int8 contract). Reported two
        ways, because clustered real-geometry corpora are saturated with
        near-ties (measured at 1M rows: median f32 score margin between
        rank 10 and rank 11 is 3.8e-4, far below quantization noise):
          int8_recall      — plain id overlap with the true f32 top-k
          int8_eps_recall  — fraction of int8-retrieved docs whose TRUE
                             f32 score >= (kth true score - eps)
        eps defaults to 1e-2: storage error per component is <= 0.5/127,
        so a unit-query dot perturbs with std ~ (0.5/127)/sqrt(3) ~
        2.3e-3 per doc and a two-doc comparison ~3.2e-3 — eps=1e-2 is a
        ~3-sigma bound. Docs swapped inside that band are equally good
        answers whose order the quantizer cannot represent; docs pushed
        OUT of the band are real quality loss. Quantization swaps many
        ids inside the band while losing almost no true score, so the
        gate passes int8 on id-recall OR eps-recall (floors --min-int8 /
        --min-int8-eps).
- ivf:  probed-cluster recall@k + candidate fraction (skipped below
        --ivf-min rows; IVF is documented clustered-corpora-only)

Usage:
  python -m cadence_rag_tpu.evals.geometry_gate [--n 1000000]
      [--queries 256] [--k 10] [--npz PATH] [--query-npz PATH]
      [--min-ann 0.95] [--min-int8 0.90] [--min-int8-eps 0.99]
      [--int8-eps 1e-2] [--skip-ivf]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Tuple

import numpy as np

from .train_corpus import EVENTS, FILLER, SERVICES


def _corpus_texts(n: int, seed: int) -> Tuple[List[str], List[str]]:
    """(doc_texts, paraphrase_pool) — domain-style sentences with varied
    identifiers so the embedder produces clustered-but-distinct rows."""
    rng = np.random.default_rng(seed)
    events = list(EVENTS)
    docs: List[str] = []
    paras: List[str] = []
    for i in range(n):
        svc = SERVICES[int(rng.integers(0, len(SERVICES)))]
        event = events[int(rng.integers(0, len(events)))]
        spec = EVENTS[event]
        t_lines = spec["transcript"]
        line = t_lines[int(rng.integers(0, len(t_lines)))].format(svc=svc)
        filler = FILLER[int(rng.integers(0, len(FILLER)))]
        docs.append(f"{line} {filler} ref-{int(rng.integers(0, 99999))}")
        if len(paras) < n:
            alt = spec["summary"][int(rng.integers(0, len(spec["summary"])))]
            paras.append(alt.format(svc=svc))
    return docs, paras


def _encode_corpus(texts: List[str], batch: int = 8192) -> np.ndarray:
    """Encode with the tuned in-process embedder, batched on device
    (big batches amortize per-call dispatch + D2H copies)."""
    import jax.numpy as jnp

    from ..models.embedder import NeuralEmbeddingProvider, batch_tokenize

    provider = NeuralEmbeddingProvider.shared()
    out = np.empty((len(texts), provider.cfg.embed_dim), dtype=np.float32)
    t0 = time.time()
    for lo in range(0, len(texts), batch):
        chunk = texts[lo:lo + batch]
        if len(chunk) < batch:  # pad: one compiled shape end to end
            chunk = chunk + [""] * (batch - len(chunk))
        tokens = jnp.asarray(batch_tokenize(chunk, provider.cfg))
        vecs = np.asarray(provider._encode(provider.params, tokens))
        out[lo:lo + min(batch, len(texts) - lo)] = vecs[
            : min(batch, len(texts) - lo)
        ]
        if lo and lo % (batch * 16) == 0:
            rate = lo / max(time.time() - t0, 1e-9)
            print(json.dumps({"phase": "encode", "done": lo,
                              "texts_per_s": round(rate)}),
                  file=sys.stderr, flush=True)
    return out


def _topk_ids(scores: np.ndarray, k: int) -> np.ndarray:
    part = np.argpartition(-scores, k, axis=1)[:, :k]
    order = np.take_along_axis(scores, part, axis=1).argsort(axis=1)[:, ::-1]
    return np.take_along_axis(part, order, axis=1)


def _gate_jits():
    """Jitted lane probes taking the corpus as an ARGUMENT — a closure
    over a 4 GB device array is baked into the program as a compile-time
    CONSTANT (GB-scale captured constants bloat and stall the compile),
    so the arrays must flow through the signature."""
    import jax
    from functools import partial

    from ..ops import topk as topk_ops

    @partial(jax.jit, static_argnames=("k",))
    def exact(q, docs, k):
        return jax.lax.top_k(topk_ops.dense_scores(q, docs), k)

    @partial(jax.jit, static_argnames=("k", "recall_target"))
    def ann(q, docs, k, recall_target):
        return jax.lax.approx_max_k(
            topk_ops.dense_scores(q, docs), k, recall_target=recall_target
        )

    @jax.jit
    def scores_at(q, docs, idx):
        """TRUE f32 scores of already-retrieved ids — a (B,k,dim) row
        gather + einsum, cheap next to the full scans."""
        import jax.numpy as jnp

        rows = jnp.take(docs, idx, axis=0)
        return jnp.einsum("bd,bkd->bk", q, rows.astype(jnp.float32))

    return exact, ann, scores_at


def run_gates(
    docs: np.ndarray,
    queries: np.ndarray,
    k: int,
    recall_target: float,
    batch: int = 64,
    skip_ivf: bool = False,
    ivf_min: int = 200_000,
    int8_eps: float = 1e-2,
) -> Dict:
    import jax
    import jax.numpy as jnp

    n, dim = docs.shape
    t0 = time.time()
    d_docs = jax.device_put(docs)                 # f32 on device
    q8 = np.clip(np.rint(docs * 127.0), -127, 127).astype(np.int8)
    d_docs8 = jax.device_put(q8)
    jax.block_until_ready((d_docs, d_docs8))
    print(json.dumps({"phase": "staged", "h2d_s": round(time.time() - t0, 1),
                      "gb": round((docs.nbytes + q8.nbytes) / 2**30, 2)}),
          file=sys.stderr, flush=True)
    exact_fn, ann_fn, scores_at_fn = _gate_jits()

    recalls = {"ann": [], "int8": [], "int8_eps": []}
    losses: List[float] = []
    print(json.dumps({"phase": "gates_compile_start"}), file=sys.stderr,
          flush=True)
    for lo in range(0, queries.shape[0], batch):
        q = jnp.asarray(queries[lo:lo + batch])
        exact_scores, exact_idx = jax.device_get(exact_fn(q, d_docs, k))
        _, ann_idx = jax.device_get(
            ann_fn(q, d_docs, k, float(recall_target))
        )
        _, i8_idx = jax.device_get(exact_fn(q, d_docs8, k))
        # true f32 scores of the int8-retrieved ids (device gather)
        i8_true = jax.device_get(
            scores_at_fn(q, d_docs, jnp.asarray(i8_idx))
        )
        kth = exact_scores[:, -1]
        for row in range(exact_idx.shape[0]):
            truth = set(exact_idx[row].tolist())
            recalls["ann"].append(
                len(truth & set(ann_idx[row].tolist())) / k
            )
            recalls["int8"].append(
                len(truth & set(i8_idx[row].tolist())) / k
            )
            recalls["int8_eps"].append(
                float(np.mean(i8_true[row] >= kth[row] - int8_eps))
            )
            losses.append(
                max(0.0, float(kth[row]) - float(i8_true[row].min()))
            )
    out: Dict = {
        "n": int(n), "dim": int(dim), "k": k,
        "queries": int(queries.shape[0]),
        "recall_target": recall_target,
        "ann_recall": round(float(np.mean(recalls["ann"])), 4),
        "int8_recall": round(float(np.mean(recalls["int8"])), 4),
        "int8_eps": int8_eps,
        "int8_eps_recall": round(float(np.mean(recalls["int8_eps"])), 4),
        "int8_score_loss_mean": round(float(np.mean(losses)), 6),
        "int8_score_loss_p99": round(float(np.percentile(losses, 99)), 6),
    }

    if not skip_ivf and n >= ivf_min:
        from ..ops.ivf import build_buckets, ivf_topk, kmeans

        t0 = time.time()
        clusters = max(64, int(np.sqrt(n)))
        centroids, assign = kmeans(
            d_docs, jax.random.PRNGKey(0), n_clusters=clusters, iters=10
        )
        bucket_cap = max(8, int(2.0 * n / clusters))
        buckets_np, overflow_np = build_buckets(
            np.asarray(assign), clusters, bucket_cap
        )
        nprobe = max(4, int(clusters * 0.08))
        overflow = np.full(max(8, len(overflow_np)), -1, np.int32)
        overflow[: len(overflow_np)] = overflow_np
        ivf_recall = []
        for lo in range(0, min(queries.shape[0], 128), batch):
            q_np = queries[lo:lo + batch]
            if q_np.shape[0] < batch:  # pad to ONE compiled shape
                q_np = np.concatenate(
                    [q_np, np.zeros((batch - q_np.shape[0], dim), np.float32)]
                )
            q = jnp.asarray(q_np)
            mask = jnp.ones((batch, n), dtype=bool)
            _, exact_idx = jax.device_get(exact_fn(q, d_docs, k))
            _, ivf_idx = jax.device_get(ivf_topk(
                q, d_docs, centroids, jnp.asarray(buckets_np),
                jnp.asarray(overflow), mask, k=k, nprobe=nprobe,
            ))
            for row in range(min(batch, queries.shape[0] - lo)):
                truth = set(exact_idx[row].tolist())
                ivf_recall.append(
                    len(truth & set(ivf_idx[row].tolist())) / k
                )
        out["ivf_recall"] = round(float(np.mean(ivf_recall)), 4)
        out["ivf_clusters"] = int(clusters)
        out["ivf_nprobe"] = int(nprobe)
        out["ivf_candidate_frac"] = round(nprobe * bucket_cap / n, 4)
        out["ivf_build_s"] = round(time.time() - t0, 1)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description="realistic-geometry gates")
    parser.add_argument("--n", type=int, default=1_000_000)
    parser.add_argument("--queries", type=int, default=256)
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--npz", type=str, default="")
    parser.add_argument("--query-npz", type=str, default="")
    parser.add_argument("--min-ann", type=float, default=0.95)
    parser.add_argument("--min-int8", type=float, default=0.90)
    parser.add_argument("--min-int8-eps", type=float, default=0.99)
    parser.add_argument("--int8-eps", type=float, default=1e-2)
    parser.add_argument("--skip-ivf", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    from ..config import settings
    from ..engine.planner import recall_target_for_ef_search

    if args.npz:
        docs = np.load(args.npz)["emb"].astype(np.float32)
        docs /= np.maximum(
            np.linalg.norm(docs, axis=1, keepdims=True), 1e-9
        )
        if args.query_npz:
            queries = np.load(args.query_npz)["emb"].astype(np.float32)
        else:  # perturbed held-out docs
            rng = np.random.default_rng(args.seed)
            pick = rng.choice(docs.shape[0], args.queries, replace=False)
            queries = docs[pick] + 0.05 * rng.standard_normal(
                (args.queries, docs.shape[1])
            ).astype(np.float32)
        queries /= np.maximum(
            np.linalg.norm(queries, axis=1, keepdims=True), 1e-9
        )
        source = args.npz
    else:
        if not settings.embedder_params_path.strip():
            settings.embedder_params_path = (
                "artifacts/embedder/tuned_small_v1.npz"
            )
        import os

        cache = f"/tmp/geometry_gate_{args.n}_{args.seed}.npz"
        if os.path.exists(cache):
            with np.load(cache) as data:
                docs, queries = data["docs"], data["queries"]
            print(json.dumps({"phase": "cache_hit", "path": cache}),
                  file=sys.stderr, flush=True)
        else:
            doc_texts, para_pool = _corpus_texts(args.n, args.seed)
            t0 = time.time()
            docs = _encode_corpus(doc_texts)
            queries = _encode_corpus(para_pool[: args.queries])
            print(json.dumps({
                "encode_s": round(time.time() - t0, 1),
                "model": "tuned_small_v1",
            }), file=sys.stderr, flush=True)
            np.savez(cache, docs=docs, queries=queries)
        source = "tuned-embedder-synthetic-domain"

    result = run_gates(
        docs, queries, args.k,
        recall_target_for_ef_search(settings.embeddings_hnsw_ef_search),
        skip_ivf=args.skip_ivf,
        int8_eps=args.int8_eps,
    )
    result["source"] = source
    int8_ok = (
        result["int8_recall"] >= args.min_int8
        or result["int8_eps_recall"] >= args.min_int8_eps
    )
    result["pass"] = bool(result["ann_recall"] >= args.min_ann and int8_ok)
    print(json.dumps(result))
    sys.exit(0 if result["pass"] else 1)


if __name__ == "__main__":
    main()
