"""Lexical BM25-style lane as a matmul over int8 signatures.

Replaces pg_search's `text @@@ :query ORDER BY pdb.score(...)` (reference:
app/retrieve.py:123-180). Exact score parity with tantivy's BM25 is
infeasible (and pointless); the behavioral contract is "rank by lexical
relevance, robust to ASR noise via char 3-grams" (SURVEY.md §2.3). Documents
carry quantized signed-hash BM25 signatures (ops/hashing.py); the query
carries idf weights, so the whole lane is one (B, D) x (D, N) matmul that
XLA fuses with the dense lane's pass over HBM.

Rows that share no feature with the query score ~0 (collision noise), so a
positive-score cutoff reproduces "only matching rows are returned".
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .topk import NEG_INF, approx_topk_sorted

# Minimum lexical score to count as a "match" (reference returns only rows
# matching >= 1 ngram). Signed hashing keeps non-match noise near zero.
LEX_MATCH_THRESHOLD = 1e-3


def lexical_scores(q_lex: jax.Array, lex_w: jax.Array) -> jax.Array:
    """(B, D) f32 x (N, D) int8 -> (B, N) f32 BM25 scores."""
    return jax.lax.dot_general(
        q_lex,
        lex_w.astype(jnp.bfloat16),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def lexical_topk(
    q_lex: jax.Array, lex_w: jax.Array, mask: jax.Array, k: int,
    recall_target: float = 0.95,
) -> Tuple[jax.Array, jax.Array]:
    scores = lexical_scores(q_lex, lex_w)
    matched = scores > LEX_MATCH_THRESHOLD
    masked = jnp.where(mask & matched, scores, NEG_INF)
    # approx_max_k: the lexical contract is ranking QUALITY (eval-gated),
    # not bit-exact order, so the lane may take an approximate top-k
    # where the backend has one (on CPU and GPU it is an exact sort).
    return approx_topk_sorted(masked, k, recall_target=recall_target)
