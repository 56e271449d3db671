"""Contrastive fine-tuning of the in-process embedder on the corpus.

The reference consumes a frozen external embedding model; this framework
can adapt its own. Training pairs come from structure that needs no labels
(pair-curation recipe):

- **cross-register pairs**: an analysis-artifact chunk (summary register)
  with a transcript chunk of the same call — summaries paraphrase the
  transcript, so these pairs teach synonym/paraphrase matching, the one
  thing the lexical lanes cannot do;
- **adjacent transcript chunks** of the same call (topical similarity);
- **pseudo-query anchors**: a random subset of a chunk's content words as
  the anchor (what terse user queries look like) with the chunk as the
  positive;
- **hard negatives mined from lexical near-misses**: for each positive,
  the highest-lexical-scoring chunk from a DIFFERENT call (via the stored
  BM25 signatures) joins the InfoNCE denominator — the model is pushed to
  separate exactly the candidates the lexical lanes confuse.

Runs dp+tp over a mesh when MESH_SHAPE is set.

Usage: python -m cadence_rag_tpu.scripts.train_embedder --out params.npz
       [--steps 200] [--batch 32] [--d-model 256] [--n-layers 4]
       [--no-hard-negatives] [--pairs adjacent,cross,query]

Afterwards set EMBEDDER_PARAMS_PATH=<out> and EMBEDDINGS_PROVIDER=neural,
then re-run the embedding backfill to refresh the dense index.
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import settings
from ..logging_utils import configure_logging, get_logger
from ..store.db import get_store

logger = get_logger(__name__)

_WORD_RE = re.compile(r"[A-Za-z0-9_.\-]+")
_STOP = {
    "the", "a", "an", "and", "or", "to", "of", "in", "on", "for", "we",
    "is", "are", "was", "were", "it", "this", "that", "with", "at", "by",
}


def _rows(conn, sql, args=()):
    return conn.execute(sql, args).fetchall()


def corpus_pairs(
    modes: Sequence[str] = ("adjacent", "cross", "query"),
    max_pairs: int = 50_000,
    seed: int = 0,
) -> List[Tuple[str, str]]:
    """(anchor, positive) text pairs curated from the store."""
    store = get_store()
    rng = np.random.default_rng(seed)
    pairs: List[Tuple[str, str]] = []
    with store.read() as conn:
        chunks = _rows(
            conn, "SELECT call_id, chunk_id, text FROM chunks "
                  "ORDER BY call_id, chunk_id"
        )
        artifacts = _rows(
            conn, "SELECT call_id, content FROM artifact_chunks"
        )
    if "adjacent" in modes:
        prev = None
        for row in chunks:
            if prev is not None and prev["call_id"] == row["call_id"]:
                pairs.append((prev["text"], row["text"]))
            prev = row
    if "cross" in modes:
        by_call: Dict[str, List[str]] = {}
        for row in chunks:
            by_call.setdefault(row["call_id"], []).append(row["text"])
        for art in artifacts:
            for text in by_call.get(art["call_id"], []):
                pairs.append((art["content"], text))
    if "query" in modes:
        for row in chunks:
            words = [w for w in _WORD_RE.findall(row["text"])
                     if w.lower() not in _STOP]
            if len(words) < 3:
                continue
            k = max(2, len(words) // 3)
            picked = rng.choice(len(words), size=min(k, len(words)),
                                replace=False)
            query = " ".join(words[i] for i in sorted(picked))
            pairs.append((query, row["text"]))
    rng.shuffle(pairs)
    return pairs[:max_pairs]


def mine_hard_negatives(
    pairs: Sequence[Tuple[str, str]], seed: int = 0
) -> List[Optional[str]]:
    """Per pair: the most lexically-similar chunk text from a DIFFERENT
    call than the positive (BM25-signature dot product over the stored
    signatures — the exact scoring the lexical lane uses)."""
    from ..ingest import featurize

    store = get_store()
    with store.read() as conn:
        rows = _rows(
            conn, "SELECT call_id, text, lex_sig FROM chunks WHERE lex_sig "
                  "IS NOT NULL"
        )
    if len(rows) < 4:
        return [None] * len(pairs)
    dim = int(settings.lexical_dim)
    sigs = np.zeros((len(rows), dim), dtype=np.float32)
    for i, row in enumerate(rows):
        sig = np.frombuffer(row["lex_sig"], dtype=np.int8)
        if sig.shape[0] == dim:
            sigs[i] = sig
    texts = [row["text"] for row in rows]
    calls = [row["call_id"] for row in rows]
    text_to_call = {t: c for t, c in zip(texts, calls)}
    # one df snapshot is fine for mining
    from ..core.index import get_index

    doc_freq = get_index().chunks.doc_freq
    n_docs = max(get_index().chunks.count, len(rows))
    out: List[Optional[str]] = []
    for anchor, positive in pairs:
        q = featurize.query_lexical_vector(anchor, doc_freq, n_docs)
        scores = sigs @ q
        pos_call = text_to_call.get(positive)
        order = np.argsort(-scores)
        neg = None
        for idx in order[:16]:
            if calls[idx] != pos_call and texts[idx] != positive:
                neg = texts[idx]
                break
        out.append(neg)
    return out


# Entity identifiers for swap augmentation: hyphen/underscore-joined
# lowercase names (service/system identifiers) + extracted tech tokens.
_IDENT_RE = re.compile(r"\b[a-z][a-z0-9]*[-_][a-z0-9_-]+\b")


def identifier_pool(pairs: Sequence[Tuple[str, str]]) -> List[str]:
    from ..ingest.chunking import extract_tech_tokens

    pool = set()
    for anchor, positive in pairs:
        for text in (anchor, positive):
            pool.update(_IDENT_RE.findall(text))
            pool.update(t for t in extract_tech_tokens(text)
                        if len(t) >= 3)
    return sorted(pool)


def swap_identifiers(
    anchor: str, positive: str, pool: Sequence[str], rng,
    negative: Optional[str] = None,
) -> Tuple[str, str, Optional[str]]:
    """Consistently rename identifiers across an (anchor, positive[,
    negative]) example.

    A retrieval pair's relationship is invariant to renaming the entities
    it mentions; training on renamed copies forces the model to learn the
    COMPOSITION (entity token + phrasing) instead of memorizing specific
    (entity, phrasing) combinations — the failure mode observed on
    held-out combos without this augmentation. The hard negative gets the
    SAME mapping: a lexical near-miss usually shares the entity, and
    leaving it unrenamed would turn it into an easy negative."""
    if not pool:
        return anchor, positive, negative
    idents = [t for t in _IDENT_RE.findall(anchor) if t in positive]
    if not idents:
        return anchor, positive, negative
    out_a, out_p, out_n = anchor, positive, negative
    for ident in set(idents):
        repl = pool[int(rng.integers(0, len(pool)))]
        if repl == ident:
            continue
        out_a = out_a.replace(ident, repl)
        out_p = out_p.replace(ident, repl)
        if out_n is not None:
            out_n = out_n.replace(ident, repl)
    return out_a, out_p, out_n


def train(
    pairs: Sequence[Tuple[str, str]],
    negatives: Optional[Sequence[Optional[str]]],
    *,
    out_path: str,
    steps: int,
    batch: int,
    lr: float,
    d_model: int,
    n_layers: int,
    vocab_buckets: int = 32768,
    max_len: int = 64,
    seed: int = 0,
    entity_swap_p: float = 0.5,
) -> float:
    import jax
    import jax.numpy as jnp

    from ..models.embedder import (
        EmbedderConfig,
        adamw_init,
        batch_tokenize,
        init_params,
        save_params,
        train_step,
    )

    cfg = EmbedderConfig(
        vocab_buckets=vocab_buckets,
        d_model=d_model,
        n_layers=n_layers,
        n_heads=max(4, d_model // 32),
        d_ff=4 * d_model,
        max_len=max_len,
        embed_dim=int(settings.embeddings_dim),
    )
    logger.info("train_embedder.start pairs=%s cfg=%s", len(pairs), cfg)
    params = init_params(cfg, jax.random.PRNGKey(seed))
    opt_state = adamw_init(params)
    use_negs = negatives is not None and any(n for n in negatives)
    if use_negs:
        step_fn = jax.jit(
            lambda p, o, a, b, n: train_step(
                p, o, a, b, cfg, negatives=n, lr=lr
            ),
            donate_argnums=(0, 1),
        )
    else:
        step_fn = jax.jit(
            lambda p, o, a, b: train_step(p, o, a, b, cfg, lr=lr),
            donate_argnums=(0, 1),
        )
    rng = np.random.default_rng(seed)
    pool = identifier_pool(pairs) if entity_swap_p > 0 else []
    loss = None
    for step in range(steps):
        idx = rng.choice(len(pairs), size=batch,
                         replace=len(pairs) < batch)
        batch_examples = []
        for i in idx:
            anchor, positive = pairs[i]
            negative = negatives[i] if use_negs else None
            if negative is None and use_negs:
                # rare (mining coverage ~98%): fall back to the positive,
                # which only dampens that example's gradient slightly
                negative = positive
            if pool and rng.random() < entity_swap_p:
                anchor, positive, negative = swap_identifiers(
                    anchor, positive, pool, rng, negative
                )
            batch_examples.append((anchor, positive, negative))
        anchors = jnp.asarray(
            batch_tokenize([a for a, _, _ in batch_examples], cfg)
        )
        positives = jnp.asarray(
            batch_tokenize([p for _, p, _ in batch_examples], cfg)
        )
        if use_negs:
            negs = jnp.asarray(batch_tokenize(
                [n for _, _, n in batch_examples], cfg
            ))
            params, opt_state, loss = step_fn(
                params, opt_state, anchors, positives, negs
            )
        else:
            params, opt_state, loss = step_fn(
                params, opt_state, anchors, positives
            )
        if step % 50 == 0:
            logger.info("train_embedder.step step=%s loss=%.4f",
                        step, float(loss))
    save_params(out_path, params, cfg, init_seed=seed)
    logger.info(
        "train_embedder.done steps=%s final_loss=%.4f out=%s",
        steps, float(loss), out_path,
    )
    return float(loss)


def main() -> None:
    parser = argparse.ArgumentParser(description="train the neural embedder")
    parser.add_argument("--out", required=True)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--d-model", type=int, default=256)
    parser.add_argument("--n-layers", type=int, default=4)
    parser.add_argument("--vocab-buckets", type=int, default=32768)
    parser.add_argument("--max-len", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pairs", default="adjacent,cross,query")
    parser.add_argument("--no-hard-negatives", action="store_true")
    parser.add_argument("--entity-swap-p", type=float, default=0.5)
    args = parser.parse_args()
    configure_logging(settings.log_level)

    modes = tuple(m.strip() for m in args.pairs.split(",") if m.strip())
    pairs = corpus_pairs(modes=modes, seed=args.seed)
    if len(pairs) < args.batch:
        raise SystemExit(
            f"not enough training pairs ({len(pairs)}); ingest more calls"
        )
    negatives = (
        None if args.no_hard_negatives else mine_hard_negatives(pairs)
    )
    train(
        pairs, negatives,
        out_path=args.out, steps=args.steps, batch=args.batch, lr=args.lr,
        d_model=args.d_model, n_layers=args.n_layers,
        vocab_buckets=args.vocab_buckets, max_len=args.max_len,
        seed=args.seed, entity_swap_p=args.entity_swap_p,
    )


if __name__ == "__main__":
    main()
