"""The reference's production topology on ONE device: Qwen3-4B encoder
and the 1M-chunk index co-resident, embed latency INSIDE the /retrieve
hot path (the reference calls the embedding service per retrieve —
app/retrieve.py:427 → the P620 Triton runbook — so embed time IS
retrieval time).

Device-memory budget: Qwen3-4B bf16 weights 8.04 GB + 1M-row int8 index
~5.2 GB + batch-B score planes (2 × B×N f32) + encoder activations.

Usage (on the accelerator):
  timeout 3600 python -m cadence_rag_tpu.evals.qwen3_coresident_bench \
      [--n 1000000] [--batch 64] [--iters 10] [--preset 4b]
Prints ONE JSON line (driver format).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

N_CALLS = 1024

_TEMPLATES = (
    "ECONNRESET rollback on the object store gateway build {}",
    "tiering latency cluster retry budget shard {}",
    "lenovo bake-off azure rollout phase {}",
    "v2.3.{} gateway retry",
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--preset", default="4b")
    ap.add_argument("--emb-dtype", default="int8")
    ap.add_argument("--lex-dim", type=int, default=4096)
    args = ap.parse_args()

    import jax

    from ..config import settings
    from ..core.index import get_index, reset_index
    from ..schemas import RetrieveRequest
    from .synth import install_synthetic_corpus

    settings.embeddings_provider = "qwen3"
    settings.embeddings_base_url = ""
    settings.qwen3_preset = args.preset
    if args.preset == "tiny":  # CPU smoke shape
        settings.embeddings_dim = 32
    settings.index_embedding_dtype = args.emb_dtype
    settings.lexical_dim = args.lex_dim
    settings.index_initial_capacity = 4096
    settings.prewarm_growth_enabled = False
    settings.rerank_enabled = False

    # encoder FIRST (the big resident); then the index beside it
    from ..models.qwen3 import Qwen3EmbeddingProvider

    t0 = time.perf_counter()
    provider = Qwen3EmbeddingProvider.shared()
    params_gb = round(
        sum(int(np.prod(p.shape)) * p.dtype.itemsize
            for p in provider.params.values()) / 2**30, 2
    )
    init_s = round(time.perf_counter() - t0, 1)
    print(json.dumps({"phase": "qwen3_init", "s": init_s,
                      "params_gb": params_gb,
                      "model": provider.model_id}))

    reset_index()
    index = get_index()
    index.ensure_call_capacity(N_CALLS)
    t0 = time.perf_counter()
    install_synthetic_corpus(index.chunks, args.n, N_CALLS, seed=0)
    install_synthetic_corpus(
        index.artifacts, max(args.n // 10, 1024), N_CALLS, seed=1
    )
    print(json.dumps({"phase": "index_populate",
                      "s": round(time.perf_counter() - t0, 1)}))
    row_bytes = (
        index.chunks.dim * index.chunks.emb.dtype.itemsize
        + index.chunks.lex_dim + index.chunks.tech_slots * 4 + 12
    )
    index_gb = round(
        (index.chunks.capacity + index.artifacts.capacity)
        * row_bytes / 2**30, 2
    )

    from ..engine.retrieve import retrieve_evidence_batch

    def reqs(salt: int):
        return [
            RetrieveRequest(
                query=_TEMPLATES[j % 4].format(salt * 997 + j),
                return_style="ids_only",
            )
            for j in range(args.batch)
        ]

    t0 = time.perf_counter()
    retrieve_evidence_batch(reqs(0))  # encode + fused compiles
    print(json.dumps({"phase": "first_batch_incl_compiles",
                      "s": round(time.perf_counter() - t0, 1)}))
    retrieve_evidence_batch(reqs(1))  # warm

    lat = []
    embed_ms = []
    for i in range(args.iters):
        batch_reqs = reqs(2 + i)
        t0 = time.perf_counter()
        out = retrieve_evidence_batch(batch_reqs)
        lat.append(time.perf_counter() - t0)
        assert len(out) == args.batch and out[0]["retrieved_ids"]
    # embed share measured separately on identical queries
    from ..embed.provider import embed_texts

    for i in range(max(args.iters // 2, 3)):
        texts = [r.query for r in reqs(50 + i)]
        t0 = time.perf_counter()
        embed_texts(texts)
        embed_ms.append((time.perf_counter() - t0) * 1e3)

    p50 = float(np.percentile(lat, 50))
    out = {
        "metric": (
            f"co-resident /retrieve QPS @ {args.n} chunks + Qwen3-"
            f"{args.preset} embed in the hot path (batch={args.batch}, "
            f"{args.emb_dtype} index)"
        ),
        "value": round(args.batch / p50, 1),
        "unit": "qps",
        "p50_batch_ms": round(p50 * 1e3, 1),
        "p50_per_query_ms": round(p50 * 1e3 / args.batch, 2),
        "embed_ms_per_batch_p50": round(float(np.median(embed_ms)), 1),
        "encoder_gb": params_gb,
        "index_gb": index_gb,
        "hbm_resident_gb": round(params_gb + index_gb, 2),
        "iters": args.iters,
        "qps_spread": [
            round(args.batch / max(lat), 1), round(args.batch / min(lat), 1)
        ],
        "device": str(jax.devices()[0]),
        "model": provider.model_id,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
