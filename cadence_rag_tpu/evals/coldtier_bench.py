"""Beyond-device-memory capture: N total rows = hot device tier + host
cold tier, measured through the REAL dispatch/merge path.

Default shape: 4M rows int8 (2.5M hot ≈ 13 GB device memory, 1.5M cold
≈ 7.8 GB host RAM). Every query batch
streams the cold rows through the device in COLD_BLOCK_ROWS blocks via
the same fused program and merges lanes before RRF; the dominating cost
is host->device bytes, so the capture reports bytes/batch and the
achieved H2D bandwidth alongside latency (a PCIe-attached production
host divides the block time by its own bandwidth).

Usage (on the accelerator):
  timeout 5400 python -m cadence_rag_tpu.evals.coldtier_bench \
      [--hot 2500000] [--cold 1500000] [--batch 128] [--iters 3]
Prints ONE JSON line (driver format: metric/value/unit).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

N_CALLS = 1024


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hot", type=int, default=2_500_000)
    ap.add_argument("--cold", type=int, default=1_500_000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--lex-dim", type=int, default=4096)
    ap.add_argument("--emb-dtype", default="int8")
    args = ap.parse_args()

    import jax

    from ..config import settings
    from ..core.index import get_index, reset_index
    from .synth import install_synthetic_cold, install_synthetic_corpus

    settings.index_embedding_dtype = args.emb_dtype
    settings.lexical_dim = args.lex_dim
    settings.index_initial_capacity = 4096
    settings.index_max_device_rows = args.hot
    settings.prewarm_growth_enabled = False
    reset_index()
    index = get_index()
    index.ensure_call_capacity(N_CALLS)

    t0 = time.perf_counter()
    install_synthetic_corpus(index.chunks, args.hot, N_CALLS, seed=0)
    install_synthetic_corpus(
        index.artifacts, max(args.hot // 10, 1024), N_CALLS, seed=1
    )
    hot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    install_synthetic_cold(index.chunks, args.cold, N_CALLS, seed=2)
    cold_s = time.perf_counter() - t0
    print(json.dumps({"phase": "populate", "hot_s": round(hot_s, 1),
                      "cold_s": round(cold_s, 1)}))

    row_bytes = (
        index.chunks.dim * index.chunks.emb.dtype.itemsize
        + index.chunks.lex_dim + index.chunks.tech_slots * 4 + 12
    )
    cold_bytes = args.cold * row_bytes

    dim = index.chunks.dim
    F = int(settings.query_lex_features)
    tech_q = int(settings.tech_hash_slots) * int(settings.tech_slot_capacity)
    rng = np.random.default_rng(7)
    q_emb = rng.standard_normal((args.batch, dim)).astype(np.float32)
    q_emb /= np.linalg.norm(q_emb, axis=1, keepdims=True)
    feats = [
        (
            rng.integers(0, args.lex_dim, F).astype(np.int64),
            np.ones(F, np.float32),
            np.ones(F, np.float32),
        )
        for _ in range(args.batch)
    ]
    q_tech = rng.integers(1, 5000, (args.batch, tech_q)).astype(np.int32)
    allowed = np.ones((args.batch, N_CALLS), dtype=bool)
    dmin = np.full(args.batch, -2147483647, np.int32)
    dmax = np.full(args.batch, 2**31 - 1, np.int32)

    def one_batch():
        return index.query_both_packed(
            q_emb, feats, q_tech, allowed, dmin, dmax,
            chunk_ks=(50, 50, 50), artifact_ks=(10, 10, 50),
            chunk_mode="ann", artifact_mode="ann", recall_target=0.95,
        )

    t0 = time.perf_counter()
    one_batch()   # compile + first cold stream
    warm_s = time.perf_counter() - t0
    print(json.dumps({"phase": "first_batch_incl_compile",
                      "s": round(warm_s, 1)}))

    lat = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        one_batch()
        lat.append(time.perf_counter() - t0)
    p50 = float(np.percentile(lat, 50))
    out = {
        "metric": (
            f"beyond-HBM /retrieve p50 @ {args.hot + args.cold} rows "
            f"({args.hot} hot + {args.cold} cold, {args.emb_dtype}, "
            f"batch={args.batch})"
        ),
        "value": round(p50 * 1e3, 1),
        "unit": "ms_per_batch",
        "qps": round(args.batch / p50, 1),
        "p50_per_query_ms": round(p50 * 1e3 / args.batch, 2),
        "cold_bytes_per_batch_gb": round(cold_bytes / 2**30, 2),
        "h2d_gbps_effective": round(cold_bytes / p50 / 2**30, 3),
        "iters": args.iters,
        "lat_s": [round(x, 2) for x in lat],
        "row_bytes": int(row_bytes),
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
