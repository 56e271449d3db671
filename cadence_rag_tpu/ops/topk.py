"""Batched cosine top-k over the device-resident embedding matrix.

Replaces pgvector's two scan modes (reference: app/retrieve.py:326-389):

- exact scan (`ORDER BY embedding <=> q` with index scans disabled) becomes
  a matmul + exact ``jax.lax.top_k``;
- the HNSW ANN path (`hnsw.ef_search`) becomes ``jax.lax.approx_max_k``,
  with ``ef_search`` mapped onto its recall_target knob
  (engine/planner.py). Only a backend with a native approx_max_k lowering
  trades recall for speed; on the CPU and GPU backends the call lowers to
  a sort and a slice, so the ANN lane returns the exact top-k.

Embeddings are unit-normalized (the embedding contract truncates to 1024-d
and L2-normalizes: reference P620_..RUNBOOK.md:703-715), so cosine ≡ dot and
distance 1-cos maps to score = dot.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# plain numpy: a module-level jnp value would initialize the XLA backend
# at import, breaking jax.distributed.initialize on multi-host startup
NEG_INF = np.float32(-np.inf)


def dense_scores(
    q_emb: jax.Array, emb: jax.Array
) -> jax.Array:
    """(B, dim) x (N, dim) -> (B, N) cosine scores, f32 accumulation.

    int8 storage (INDEX_EMBEDDING_DTYPE=int8): rows are unit vectors
    quantized as round(x*127) at insert (core/index._encode_emb); they
    are widened to bf16 in-register (integers <= 127 are exact in bf16,
    and HBM reads stay 1 byte/dim — the whole point) and the 1/127 scale
    restores cosine units. The query keeps bf16 precision — only the
    stored side pays quantization error."""
    if emb.dtype == jnp.int8:
        scores = jax.lax.dot_general(
            q_emb.astype(jnp.bfloat16),
            emb.astype(jnp.bfloat16),
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return scores * jnp.float32(1.0 / 127.0)
    return jax.lax.dot_general(
        q_emb.astype(emb.dtype),
        emb,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def masked_topk_exact(
    scores: jax.Array, mask: jax.Array, k: int
) -> Tuple[jax.Array, jax.Array]:
    """Exact top-k of (B, N) scores under a (B, N) validity mask."""
    masked = jnp.where(mask, scores, NEG_INF)
    return jax.lax.top_k(masked, k)


def approx_topk_sorted(
    keys: jax.Array, k: int, recall_target: float
) -> Tuple[jax.Array, jax.Array]:
    """approx_max_k + an exact descending sort of the k winners.

    aggregate_to_topk does not guarantee sorted output on every backend
    (observed unsorted on CPU); sorting k=50 values costs nothing next to
    the (B, N) reduction and keeps ordering semantics identical across
    exact and approx paths."""
    vals, idx = jax.lax.approx_max_k(
        keys, k, recall_target=recall_target, aggregate_to_topk=True
    )
    sorted_vals, order = jax.lax.top_k(vals, k)
    return sorted_vals, jnp.take_along_axis(idx, order, axis=-1)


def masked_topk_approx(
    scores: jax.Array, mask: jax.Array, k: int, recall_target: float
) -> Tuple[jax.Array, jax.Array]:
    """ANN top-k via lax.approx_max_k (exact where the backend has no
    native lowering)."""
    masked = jnp.where(mask, scores, NEG_INF)
    return approx_topk_sorted(masked, k, recall_target)


def cosine_topk(
    q_emb: jax.Array,
    emb: jax.Array,
    mask: jax.Array,
    k: int,
    *,
    mode: str = "exact",
    recall_target: float = 0.95,
) -> Tuple[jax.Array, jax.Array]:
    """Full dense lane: scores + masked top-k. Returns (scores_k, positions_k)."""
    scores = dense_scores(q_emb, emb)
    if mode == "exact":
        return masked_topk_exact(scores, mask, k)
    return masked_topk_approx(scores, mask, k, recall_target)


def reference_topk_numpy(q_emb, emb, mask, k):
    """Pure-numpy oracle used by kernel parity tests (f32 throughout)."""
    import numpy as np

    scores = np.asarray(q_emb, dtype=np.float32) @ np.asarray(
        emb, dtype=np.float32
    ).T
    scores = np.where(np.asarray(mask), scores, -np.inf)
    idx = np.argsort(-scores, axis=-1, kind="stable")[:, :k]
    return np.take_along_axis(scores, idx, axis=-1), idx
