"""The fused multi-lane retrieval program.

Where the reference issues five sequential SQL round-trips per /retrieve
(bm25 chunks/artifacts, tech chunks/artifacts, dense chunks/artifacts;
reference: app/retrieve.py:445-487), this is ONE jitted XLA program per
corpus: the dense and lexical matmuls and the tech-token intersection share
a single pass over the HBM-resident document arrays, filters are fused as
masks, and each lane ends in an on-device top-k. XLA fuses the elementwise
mask/threshold work into the matmul epilogues.

Compiled once per (capacity, batch, k, mode) signature; capacities grow by
doubling (core/index.py) so recompiles are logarithmic in corpus growth.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax

from .lexical import lexical_topk
from .masks import filter_mask
from .techlane import tech_topk
from .topk import masked_topk_approx, masked_topk_exact, dense_scores

LaneResult = Tuple[jax.Array, jax.Array]


def _lanes_one_corpus(
    emb, lex_w, tech, call_idx, started_sec, has_emb,
    q_emb, q_lex, q_tech, allowed_calls, date_min, date_max,
    *, k_dense, k_lex, k_tech, dense_mode, recall_target, dense_enabled,
) -> Dict[str, LaneResult]:
    mask = filter_mask(call_idx, started_sec, allowed_calls, date_min, date_max)
    out: Dict[str, LaneResult] = {}
    # the ef_search->recall_target knob governs the dense and lexical
    # approx lanes (ANN_RECALL_TARGET contract in docs/CONFIG.md); the
    # tech lane's order is a contract, so it takes the exact top-k
    out["lex"] = lexical_topk(q_lex, lex_w, mask, k_lex,
                              recall_target=recall_target)
    out["tech"] = tech_topk(tech, started_sec, q_tech, mask, k_tech)
    if dense_enabled and dense_mode != "none":
        # rows without embeddings are excluded from the dense lane only
        # (reference: `embedding IS NOT NULL`, app/retrieve.py:347)
        dense_mask = mask & has_emb[None, :]
        scores = dense_scores(q_emb, emb)
        if dense_mode == "exact":
            out["dense"] = masked_topk_exact(scores, dense_mask, k_dense)
        else:
            out["dense"] = masked_topk_approx(
                scores, dense_mask, k_dense, recall_target
            )
    return out


@partial(
    jax.jit,
    static_argnames=(
        "k_dense", "k_lex", "k_tech", "dense_mode", "recall_target",
        "dense_enabled",
    ),
)
def multi_lane_retrieve(
    emb: jax.Array,          # (N, dim) storage dtype
    lex_w: jax.Array,        # (N, D) int8
    tech: jax.Array,         # (N, S) int32
    call_idx: jax.Array,     # (N,) int32
    started_sec: jax.Array,  # (N,) int32
    has_emb: jax.Array,      # (N,) bool
    q_emb: jax.Array,        # (B, dim) f32
    q_lex: jax.Array,        # (B, D) f32
    q_tech: jax.Array,       # (B, Q) int32
    allowed_calls: jax.Array,  # (B, C) bool
    date_min: jax.Array,     # (B,) int32
    date_max: jax.Array,     # (B,) int32
    *,
    k_dense: int,
    k_lex: int,
    k_tech: int,
    dense_mode: str = "exact",
    recall_target: float = 0.95,
    dense_enabled: bool = True,
) -> Dict[str, LaneResult]:
    return _lanes_one_corpus(
        emb, lex_w, tech, call_idx, started_sec, has_emb,
        q_emb, q_lex, q_tech, allowed_calls, date_min, date_max,
        k_dense=k_dense, k_lex=k_lex, k_tech=k_tech,
        dense_mode=dense_mode, recall_target=recall_target,
        dense_enabled=dense_enabled,
    )


@partial(
    jax.jit,
    static_argnames=(
        "chunk_ks", "artifact_ks", "chunk_mode", "artifact_mode",
        "recall_target", "dense_enabled",
    ),
)
def dual_corpus_retrieve(
    chunk_arrays: Tuple[jax.Array, ...],     # (emb, lex, tech, call_idx, started, has_emb)
    artifact_arrays: Tuple[jax.Array, ...],
    q_emb: jax.Array,
    chunk_q_lex: jax.Array,
    artifact_q_lex: jax.Array,
    q_tech: jax.Array,
    allowed_calls: jax.Array,
    date_min: jax.Array,
    date_max: jax.Array,
    *,
    chunk_ks: Tuple[int, int, int],          # (k_dense, k_lex, k_tech)
    artifact_ks: Tuple[int, int, int],
    chunk_mode: str = "exact",
    artifact_mode: str = "exact",
    recall_target: float = 0.95,
    dense_enabled: bool = True,
) -> Tuple[Dict[str, LaneResult], Dict[str, LaneResult]]:
    """Both corpora's six lanes in ONE device program — one dispatch per
    /retrieve instead of the reference's five SQL round-trips (and instead
    of two separate device calls, each paying its own dispatch)."""
    chunks_out = _lanes_one_corpus(
        *chunk_arrays, q_emb, chunk_q_lex, q_tech,
        allowed_calls, date_min, date_max,
        k_dense=chunk_ks[0], k_lex=chunk_ks[1], k_tech=chunk_ks[2],
        dense_mode=chunk_mode, recall_target=recall_target,
        dense_enabled=dense_enabled,
    )
    artifacts_out = _lanes_one_corpus(
        *artifact_arrays, q_emb, artifact_q_lex, q_tech,
        allowed_calls, date_min, date_max,
        k_dense=artifact_ks[0], k_lex=artifact_ks[1], k_tech=artifact_ks[2],
        dense_mode=artifact_mode, recall_target=recall_target,
        dense_enabled=dense_enabled,
    )
    return chunks_out, artifacts_out
