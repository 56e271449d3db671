"""Exact tech-token lane: hash-set intersection + recency ordering.

Replaces the GIN array-overlap query `tech_tokens && :arr ORDER BY
call_started_at DESC, id ASC` (reference: app/retrieve.py:183-242).

Each document carries S int32 token-hash slots (0 = empty). A query carries
Q hashed tokens. Match = any slot equals any query hash. Ordering is by
recency: exact ``lax.top_k`` over call-start seconds, whose documented
lowest-index-wins tie-break reproduces the reference's secondary
``id ASC`` order because documents are appended in id order. (An
approximate top-k would not do: its fallback lowering is a sort that
need not keep equal keys in position order, and calls share one
started_sec across all their chunks, so ties are the common case.)
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# plain numpy: a module-level jnp value would initialize the XLA backend
# at import, breaking jax.distributed.initialize on multi-host startup
INT32_MIN = np.int32(-2147483648)


def tech_match(doc_tokens: jax.Array, q_tokens: jax.Array) -> jax.Array:
    """(N, S) slot-addressed doc hashes vs (B, S*C) query structure ->
    (B, N) bool any-intersection.

    Docs store token h at slot h%S or (h>>8)%S (2-choice,
    ops/hashing.tech_token_hashes); the query structure holds, per slot,
    up to C hashes that could live there (ops/hashing.
    tech_query_structure). The compare unrolls into C*S per-slot-COLUMN
    (B, N) passes that XLA fuses into one elementwise pass over the
    (N, S) slot table. The query token budget is ~S*C with per-slot
    overflow surfaced in debug payloads."""
    n_cols = q_tokens.shape[1]
    slots = doc_tokens.shape[1]
    capacity = n_cols // slots
    assert capacity * slots == n_cols, (n_cols, slots)
    match = None
    for c in range(capacity):
        for s in range(slots):
            q_col = q_tokens[:, c * slots + s]          # (B,)
            hit = ((q_col[:, None] == doc_tokens[None, :, s])
                   & (q_col[:, None] != 0))              # (B, N)
            match = hit if match is None else (match | hit)
    return match


def tech_topk(
    doc_tokens: jax.Array,
    started_sec: jax.Array,
    q_tokens: jax.Array,
    mask: jax.Array,
    k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Returns (f32 recency keys, positions) in (started_sec desc,
    position asc) order; non-matches carry -inf.

    Recency keys are the int32 epoch-seconds BITCAST to f32: IEEE floats
    with the same sign compare exactly like their integer bit patterns, so
    ordering is preserved bit-exactly for non-negative seconds (valid until
    epoch 2139095041 ~ year 2037) and the lane shares the f32 top-k path
    of the other lanes."""
    match = tech_match(doc_tokens, q_tokens)
    recency = jax.lax.bitcast_convert_type(started_sec, jnp.float32)
    keys = jnp.where(match & mask, recency[None, :], -jnp.inf)
    return jax.lax.top_k(keys, k)
