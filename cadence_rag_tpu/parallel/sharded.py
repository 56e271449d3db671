"""Corpus-sharded retrieval: shard_map over the "data" mesh axis.

When the chunk matrix outgrows one device's memory, document rows shard
across devices; each device scans its shard with the same fused-lane math
and the per-shard top-k candidates are merged with an all_gather followed
by a local re-top-k — O(devices * k) merge traffic instead of moving
scores (SURVEY.md §2.4). Queries are replicated across "data".
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.lexical import lexical_topk
from ..ops.masks import filter_mask
from ..ops.techlane import tech_topk
from ..ops.topk import dense_scores, masked_topk_exact


def _local_dense_topk(
    emb: jax.Array,          # (N/d, dim) local shard
    call_idx: jax.Array,     # (N/d,)
    started_sec: jax.Array,  # (N/d,)
    has_emb: jax.Array,      # (N/d,) bool
    q_emb: jax.Array,        # (B, dim) replicated
    allowed_calls: jax.Array,
    date_min: jax.Array,
    date_max: jax.Array,
    k: int,
    axis: str,
) -> Tuple[jax.Array, jax.Array]:
    shard_rows = emb.shape[0]
    mask = filter_mask(call_idx, started_sec, allowed_calls, date_min, date_max)
    scores = dense_scores(q_emb, emb)
    # `embedding IS NOT NULL` parity like every other dense lane:
    # without it, backfill-pending rows (zero vectors, score 0.0) can
    # outrank real matches whose cosine is negative
    local_scores, local_pos = masked_topk_exact(
        scores, mask & has_emb[None, :], min(k, shard_rows)
    )
    return _merge_gathered(local_scores, local_pos, shard_rows, k, axis)


def sharded_dense_topk(
    mesh: Mesh,
    emb: jax.Array,
    call_idx: jax.Array,
    started_sec: jax.Array,
    q_emb: jax.Array,
    allowed_calls: jax.Array,
    date_min: jax.Array,
    date_max: jax.Array,
    k: int,
    axis: str = "data",
    has_emb: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Global top-k over a corpus sharded on ``axis``. Returns
    (scores (B,k), global positions (B,k)). ``has_emb`` marks rows with
    a present embedding (None = all rows embedded)."""
    if has_emb is None:
        has_emb = jnp.ones(emb.shape[0], dtype=bool)
    fn = shard_map(
        partial(_local_dense_topk, k=k, axis=axis),
        mesh=mesh,
        in_specs=(
            P(axis, None),   # emb rows sharded
            P(axis),         # call_idx
            P(axis),         # started_sec
            P(axis),         # has_emb
            P(),             # queries replicated
            P(), P(), P(),   # filters replicated
        ),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(emb, call_idx, started_sec, has_emb, q_emb, allowed_calls,
              date_min, date_max)


def _merge_gathered(local_scores, local_pos, shard_rows, k, axis):
    my_shard = jax.lax.axis_index(axis)
    global_pos = local_pos + my_shard * shard_rows
    all_scores = jax.lax.all_gather(local_scores, axis, axis=0)
    all_pos = jax.lax.all_gather(global_pos, axis, axis=0)
    d, batch, kk = all_scores.shape
    flat_scores = all_scores.transpose(1, 0, 2).reshape(batch, d * kk)
    flat_pos = all_pos.transpose(1, 0, 2).reshape(batch, d * kk)
    top_scores, top_idx = jax.lax.top_k(flat_scores, k)
    return top_scores, jnp.take_along_axis(flat_pos, top_idx, axis=1)


def _local_all_lanes(
    emb, lex_w, tech, call_idx, started_sec, has_emb,
    q_emb, q_lex, q_tech, allowed_calls, date_min, date_max,
    *, k_dense, k_lex, k_tech, axis,
):
    shard_rows = emb.shape[0]
    mask = filter_mask(call_idx, started_sec, allowed_calls, date_min, date_max)

    # dense lane additionally requires a present embedding (`embedding IS
    # NOT NULL` parity, matching ops/fused.py's dense_mask)
    d_scores, d_pos = masked_topk_exact(
        dense_scores(q_emb, emb), mask & has_emb[None, :],
        min(k_dense, shard_rows)
    )
    l_scores, l_pos = lexical_topk(q_lex, lex_w, mask, min(k_lex, shard_rows))
    t_keys, t_pos = tech_topk(
        tech, started_sec, q_tech, mask, min(k_tech, shard_rows)
    )
    return (
        *_merge_gathered(d_scores, d_pos, shard_rows, k_dense, axis),
        *_merge_gathered(l_scores, l_pos, shard_rows, k_lex, axis),
        *_merge_gathered(t_keys, t_pos, shard_rows, k_tech, axis),
    )


def sharded_multi_lane(
    mesh: Mesh,
    emb: jax.Array,
    lex_w: jax.Array,
    tech: jax.Array,
    call_idx: jax.Array,
    started_sec: jax.Array,
    has_emb: jax.Array,
    q_emb: jax.Array,
    q_lex: jax.Array,
    q_tech: jax.Array,
    allowed_calls: jax.Array,
    date_min: jax.Array,
    date_max: jax.Array,
    *,
    k_dense: int,
    k_lex: int,
    k_tech: int,
    axis: str = "data",
):
    """All three lanes over a row-sharded corpus: each shard runs the fused
    lane math locally, per-lane top-k candidates all_gather across the mesh and
    re-select locally. Returns {"dense"|"lex"|"tech": (scores, positions)}
    with GLOBAL document positions."""
    fn = shard_map(
        partial(_local_all_lanes, k_dense=k_dense, k_lex=k_lex,
                k_tech=k_tech, axis=axis),
        mesh=mesh,
        in_specs=(
            P(axis, None), P(axis, None), P(axis, None),
            P(axis), P(axis), P(axis),
            P(), P(), P(), P(), P(), P(),
        ),
        out_specs=tuple(P() for _ in range(6)),
        check_vma=False,
    )
    d_s, d_p, l_s, l_p, t_s, t_p = fn(
        emb, lex_w, tech, call_idx, started_sec, has_emb,
        q_emb, q_lex, q_tech, allowed_calls, date_min, date_max,
    )
    return {"dense": (d_s, d_p), "lex": (l_s, l_p), "tech": (t_s, t_p)}
