"""Reciprocal Rank Fusion (RRF).

Parity target: the reference fuses lanes with score = sum over lanes of
1/(k + rank), k=60, then sorts by score descending (reference:
app/retrieve.py:245-260). Two implementations:

- ``rrf_merge``: host-side, exact reference semantics including insertion
  -order stability for equal scores; operates on the <=170 per-lane
  candidates so Python cost is irrelevant.
- ``rrf_scores_device``: vectorized scatter-add over document positions for
  bulk ids_only evaluation on device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Set, Tuple

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_RRF_K = 60


def rrf_merge(
    lanes: Dict[str, Sequence[Any]], k: int = DEFAULT_RRF_K
) -> List[Tuple[Any, Set[str], float]]:
    """lanes: {lane_name: [doc_key, ...] ranked best-first} ->
    [(doc_key, {lanes hit}, fused_score)] sorted by score desc, first-seen
    order breaking ties (Python sort stability over insertion order)."""
    scores: Dict[Any, float] = {}
    hits: Dict[Any, Set[str]] = {}
    for lane_name, keys in lanes.items():
        for rank, key in enumerate(keys, start=1):
            scores[key] = scores.get(key, 0.0) + 1.0 / (k + rank)
            hits.setdefault(key, set()).add(lane_name)
    ordered = sorted(scores.items(), key=lambda item: item[1], reverse=True)
    return [(key, hits[key], score) for key, score in ordered]


def rrf_merge_arrays(
    lanes: Dict[str, np.ndarray], k: int = DEFAULT_RRF_K
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[str, ...]]:
    """Vectorized ``rrf_merge`` for the serving hot path.

    lanes: {lane_name: int64 doc-id array, ranked best-first} ->
    (doc_ids, fused_scores, lane_bitmasks, lane_names), sorted by score
    descending with first-occurrence order breaking ties — the EXACT
    ordering of ``rrf_merge`` (Python dict insertion + stable sort), which
    is the reference contract (app/retrieve.py:245-260). lane_bitmasks bit
    i set = doc appeared in lane_names[i]. The per-plan dict/loop version
    cost ~16 ms per 64-query batch on the 1-core serving host (profiled).
    """
    lane_names = tuple(lanes.keys())
    if len(lane_names) > 8:
        # lane provenance rides a uint8 bitmask (bit = 1 << lane index);
        # a 9th lane would overflow under numpy 2 — widen the mask dtype
        # before adding lanes (serving uses 3)
        raise ValueError(
            f"rrf merge supports at most 8 lanes, got {len(lane_names)}"
        )
    parts = []
    contribs = []
    bits = []
    for i, name in enumerate(lane_names):
        ids = np.asarray(lanes[name], dtype=np.int64)
        if ids.size == 0:
            continue
        parts.append(ids)
        # float64 like the Python accumulation (scores must match bit-wise)
        contribs.append(1.0 / (k + np.arange(1, ids.size + 1, dtype=np.float64)))
        bits.append(np.full(ids.size, 1 << i, dtype=np.uint8))
    if not parts:
        empty_i = np.zeros(0, dtype=np.int64)
        return (empty_i, np.zeros(0, dtype=np.float64),
                np.zeros(0, dtype=np.uint8), lane_names)
    all_ids = np.concatenate(parts)
    all_contrib = np.concatenate(contribs)
    all_bits = np.concatenate(bits)
    uniq, first, inv = np.unique(
        all_ids, return_index=True, return_inverse=True
    )
    scores = np.zeros(uniq.size, dtype=np.float64)
    # np.add.at accumulates in array order = lane insertion order, the same
    # FP addition order as the dict loop
    np.add.at(scores, inv, all_contrib)
    masks = np.zeros(uniq.size, dtype=np.uint8)
    np.bitwise_or.at(masks, inv, all_bits)
    # primary: score desc; tie: first occurrence across the lane concat
    # (= dict insertion order under Python's stable sort)
    order = np.lexsort((first, -scores))
    return uniq[order], scores[order], masks[order], lane_names


def lane_mask_names(mask: int, lane_names: Sequence[str]) -> Set[str]:
    return {name for i, name in enumerate(lane_names) if mask & (1 << i)}


_contrib_cache: Dict[Tuple[int, int], np.ndarray] = {}


def _contrib(k: int, n: int) -> np.ndarray:
    cached = _contrib_cache.get((k, n))
    if cached is None:
        cached = 1.0 / (k + np.arange(1, n + 1, dtype=np.float64))
        if len(_contrib_cache) < 4096:
            _contrib_cache[(k, n)] = cached
    return cached


def rrf_merge_batch(
    per_plan_lanes: Sequence[Dict[str, np.ndarray]], k: int = DEFAULT_RRF_K
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[str, ...]]]:
    """``rrf_merge_arrays`` for MANY queries in ONE numpy pass.

    Per-plan numpy merges cost ~110 us each in small-array overhead
    (profiled: 14 ms per 64-query batch just fusing lanes); this runs one
    unique/scatter-add/lexsort over every plan's candidates at once, keyed
    by (plan, doc). Output list is ordering- and score-bitwise-identical
    to calling ``rrf_merge_arrays`` per plan (tested)."""
    n_plans = len(per_plan_lanes)
    parts_ids: List[np.ndarray] = []
    parts_contrib: List[np.ndarray] = []
    parts_bits: List[np.ndarray] = []
    parts_plan: List[np.ndarray] = []
    names_per_plan: List[Tuple[str, ...]] = []
    for p, lanes in enumerate(per_plan_lanes):
        names = tuple(lanes.keys())
        if len(names) > 8:
            raise ValueError(
                f"rrf merge supports at most 8 lanes, got {len(names)}"
            )
        names_per_plan.append(names)
        for i, name in enumerate(names):
            ids = np.asarray(lanes[name], dtype=np.int64)
            if ids.size == 0:
                continue
            parts_ids.append(ids)
            parts_contrib.append(_contrib(k, ids.size))
            parts_bits.append(np.full(ids.size, 1 << i, dtype=np.uint8))
            parts_plan.append(np.full(ids.size, p, dtype=np.int64))

    empty = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64),
             np.zeros(0, dtype=np.uint8))
    if not parts_ids:
        return [empty + (names_per_plan[p],) for p in range(n_plans)]

    return _merge_flat(
        np.concatenate(parts_plan), np.concatenate(parts_ids),
        np.concatenate(parts_contrib), np.concatenate(parts_bits),
        n_plans, names_per_plan,
    )


def _merge_flat(
    all_plan: np.ndarray, all_ids: np.ndarray, all_contrib: np.ndarray,
    all_bits: np.ndarray, n_plans: int, names_per_plan,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[str, ...]]]:
    """Shared merge core: group flat (plan, doc) entries, accumulate f64
    scores in input order, OR masks, sort (plan, -score, first), split
    by plan. Native C++ core when available (<1 ms vs ~8 ms of
    unique + add.at + lexsort; bitwise-parity tested — native/rrf.cpp)."""
    from ..native import rrf as native_rrf

    empty = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64),
             np.zeros(0, dtype=np.uint8))
    native = native_rrf.merge_groups(
        all_plan.astype(np.int32, copy=False), all_ids, all_contrib,
        all_bits, n_plans,
    )
    if native is not None:
        plan_sorted, doc_sorted, score_sorted, mask_sorted = native
        plan_sorted = plan_sorted.astype(np.int64, copy=False)
    else:
        base = int(all_ids.max()) + 1  # doc ids are non-negative
        key = all_plan * base + all_ids
        uniq, first, inv = np.unique(
            key, return_index=True, return_inverse=True
        )
        scores = np.zeros(uniq.size, dtype=np.float64)
        # accumulation order = lane order
        np.add.at(scores, inv, all_contrib)
        masks = np.zeros(uniq.size, dtype=np.uint8)
        np.bitwise_or.at(masks, inv, all_bits)
        uniq_plan = uniq // base
        uniq_doc = uniq - uniq_plan * base
        # plan-major; within a plan: score desc, first-occurrence tiebreak
        order = np.lexsort((first, -scores, uniq_plan))
        plan_sorted = uniq_plan[order]
        doc_sorted = uniq_doc[order]
        score_sorted = scores[order]
        mask_sorted = masks[order]
    return _split_plans(plan_sorted, doc_sorted, score_sorted, mask_sorted,
                        n_plans, names_per_plan)


def _split_plans(
    plan_sorted: np.ndarray, doc_sorted: np.ndarray,
    score_sorted: np.ndarray, mask_sorted: np.ndarray,
    n_plans: int, names_per_plan,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[str, ...]]]:
    empty = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64),
             np.zeros(0, dtype=np.uint8))
    bounds = np.searchsorted(plan_sorted, np.arange(n_plans + 1))
    out = []
    for p in range(n_plans):
        s, e = int(bounds[p]), int(bounds[p + 1])
        if s == e:
            out.append(empty + (names_per_plan[p],))
        else:
            out.append((doc_sorted[s:e], score_sorted[s:e], mask_sorted[s:e],
                        names_per_plan[p]))
    return out


def rrf_merge_rect(
    lanes: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]],
    k: int = DEFAULT_RRF_K,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[str, ...]]]:
    """``rrf_merge_batch`` over RECTANGULAR lane blocks — the shape the
    device actually returns ({lane: (ids (B,k) i64, scores (B,k) f32,
    counts (B,) — valid prefix length per row)}) — with no per-plan
    Python loop. Ordering/score parity with the per-plan path is exact:
    the flat entry order is lane-major here vs plan-major there, but
    within any (plan, doc) group the relative entry order (lane
    declaration order, then rank) is identical, so the f64 accumulation
    sequence and the first-occurrence tiebreak are unchanged (tested
    bitwise against rrf_merge_batch)."""
    names = tuple(lanes.keys())
    if len(names) > 8:
        raise ValueError(
            f"rrf merge supports at most 8 lanes, got {len(names)}"
        )
    n_plans = next(iter(lanes.values()))[0].shape[0] if lanes else 0

    from ..native import rrf as native_rrf

    native = native_rrf.merge_rect_groups(
        [(ids2d, counts) for ids2d, _s, counts in lanes.values()],
        n_plans, k,
    )
    if native is not None:
        plan_sorted, doc_sorted, score_sorted, mask_sorted = native
        return _split_plans(
            plan_sorted.astype(np.int64, copy=False), doc_sorted,
            score_sorted, mask_sorted, n_plans, [names] * n_plans,
        )

    parts_ids: List[np.ndarray] = []
    parts_contrib: List[np.ndarray] = []
    parts_bits: List[np.ndarray] = []
    parts_plan: List[np.ndarray] = []
    for i, name in enumerate(names):
        ids2d, _scores, counts = lanes[name]
        batch, width = ids2d.shape
        if width == 0:
            continue
        valid = np.arange(width)[None, :] < np.asarray(counts)[:, None]
        flat_ids = np.asarray(ids2d, dtype=np.int64)[valid]
        if flat_ids.size == 0:
            continue
        parts_ids.append(flat_ids)
        parts_contrib.append(
            np.broadcast_to(_contrib(k, width), (batch, width))[valid]
        )
        parts_bits.append(np.full(flat_ids.size, 1 << i, dtype=np.uint8))
        parts_plan.append(
            np.broadcast_to(
                np.arange(batch, dtype=np.int64)[:, None], (batch, width)
            )[valid]
        )

    empty = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64),
             np.zeros(0, dtype=np.uint8))
    if not parts_ids:
        return [empty + (names,) for _ in range(n_plans)]
    return _merge_flat(
        np.concatenate(parts_plan), np.concatenate(parts_ids),
        np.concatenate(parts_contrib), np.concatenate(parts_bits),
        n_plans, [names] * n_plans,
    )


def rrf_fuse_lanes_device(
    outs: Dict[str, Tuple[jax.Array, jax.Array]],
    lane_order: Sequence[str],
    k: int = DEFAULT_RRF_K,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """RRF merge INSIDE the fused device program.

    outs: {lane: (vals (B, k_lane) sorted desc w/ -inf sentinels,
    positions (B, k_lane))} in ``lane_order``. Returns
    (positions (B, K) i32, fused (B, K) f32, lane_masks (B, K) i32,
    counts (B,) i32) sorted by (fused desc, first-occurrence slot asc) —
    the reference RRF ordering (app/retrieve.py:245-260: score = sum of
    1/(60+rank), dict-insertion tiebreak). K = sum of lane widths.

    Parity with the host merge (rrf_merge_rect): identical candidate
    sets, lane masks and tie handling; scores accumulate in f32 here vs
    f64 on host, so candidates whose f64 scores differ by less than f32
    resolution (~1e-8 — distinct RRF sums are >= ~6e-13 apart but almost
    always >> 1e-6) may swap. The host path remains the oracle
    (DEVICE_RRF_ENABLED=0) and debug-mode queries always use it.

    Cost: an (B, K, K) equality plane + einsum, K <= ~170 — microseconds
    next to the (B, N) lane scans; saves the host's postprocess+merge."""
    vals_parts, pos_parts = [], []
    contrib_np, bits_np = [], []
    for i, name in enumerate(lane_order):
        if name not in outs:
            continue
        v, p = outs[name]
        width = v.shape[1]
        vals_parts.append(v.astype(jnp.float32))
        pos_parts.append(p.astype(jnp.int32))
        contrib_np.append(
            1.0 / (k + np.arange(1, width + 1, dtype=np.float32))
        )
        bits_np.append(np.full(width, 1 << i, dtype=np.int32))
    vals = jnp.concatenate(vals_parts, axis=1)          # (B, K)
    pos = jnp.concatenate(pos_parts, axis=1)            # (B, K)
    contrib = jnp.asarray(np.concatenate(contrib_np))   # (K,)
    bits = jnp.asarray(np.concatenate(bits_np))         # (K,)
    K = pos.shape[1]
    valid = jnp.isfinite(vals)
    slot = jnp.arange(K, dtype=jnp.int32)
    # unique negative keys for invalid slots so they never aggregate
    keyed = jnp.where(valid, pos, -1 - slot[None, :])
    eq = keyed[:, :, None] == keyed[:, None, :]          # (B, K, K)
    contrib_v = jnp.where(valid, contrib[None, :], 0.0)
    fused = jnp.einsum(
        "bij,bj->bi", eq.astype(jnp.float32), contrib_v
    )                                                    # (B, K)
    # each lane contributes at most one slot per doc, so sum == OR
    masks = jnp.einsum(
        "bij,j->bi", eq.astype(jnp.int32), bits
    )
    dup = jnp.any(eq & (slot[None, :, None] > slot[None, None, :]), axis=-1)
    keep = valid & ~dup
    sort_primary = jnp.where(keep, -fused, jnp.inf)
    slot_b = jnp.broadcast_to(slot[None, :], pos.shape)
    _, _, pos_s, fused_s, masks_s = jax.lax.sort(
        (sort_primary, slot_b, pos, fused, masks),
        num_keys=2, dimension=1,
    )
    counts = keep.sum(axis=1).astype(jnp.int32)
    return pos_s, fused_s, masks_s, counts


def rrf_scores_device(
    lane_positions: jax.Array,  # (L, B, K) int32 positions; -1 = padding
    n_docs: int,
    k: int = DEFAULT_RRF_K,
) -> jax.Array:
    """-> (B, n_docs) fused RRF scores (0 where no lane hit)."""
    num_lanes, batch, topk = lane_positions.shape
    ranks = jnp.arange(1, topk + 1, dtype=jnp.float32)
    contrib = 1.0 / (k + ranks)  # (K,)
    contrib = jnp.broadcast_to(contrib, (num_lanes, batch, topk))
    valid = lane_positions >= 0
    # Scatter-add along the doc axis; padded entries scatter weight 0 into 0.
    safe_pos = jnp.where(valid, lane_positions, 0)
    out = jnp.zeros((batch, n_docs), dtype=jnp.float32)
    for lane in range(num_lanes):
        out = out.at[
            jnp.arange(batch)[:, None], safe_pos[lane]
        ].add(jnp.where(valid[lane], contrib[lane], 0.0))
    return out
