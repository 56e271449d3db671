"""Dense-lane planner: exact scan vs ANN per query.

Decision-table parity with the reference planner (reference:
app/retrieve.py:267-287): zero candidates -> exact; scoped filters with a
masked candidate count at or under the exact-scan threshold -> exact;
otherwise ANN. "exact" is a full matmul + lax.top_k and "ann" is
lax.approx_max_k, with ``ef_search`` mapped to its recall_target (ef 80 on
an m=16 HNSW graph operates around 0.95 recall@10 — the knob the reference
exposes is recall-vs-speed, and so is ours). Only a backend with a native
approx_max_k lowering trades recall for speed; on the CPU and GPU backends
the call lowers to an exact sort-and-slice, so "ann" returns the exact
top-k and the recall_target is not read.
"""

from __future__ import annotations

from ..config import settings


def has_scoping(scoped: bool) -> bool:
    return scoped


def choose_dense_mode(
    estimated_rows: int, scoped: bool, ivf_available: bool = False
) -> str:
    if estimated_rows <= 0:
        return "exact"
    if scoped and estimated_rows <= max(
        int(settings.embeddings_exact_scan_threshold), 0
    ):
        return "exact"
    if (
        ivf_available
        and settings.dense_ivf_enabled
        and estimated_rows >= int(settings.ivf_min_rows)
    ):
        return "ivf"
    return "ann"


def recall_target_for_ef_search(ef_search: int) -> float:
    """Map the reference's ef_search knob onto approx_max_k recall_target.

    Saturating map anchored at (80 -> settings.ann_recall_target), so
    callers tuning EMBEDDINGS_HNSW_EF_SEARCH get the same recall direction
    they had with pgvector: ef above the anchor asks for more recall,
    ef at or below it asks for the anchor's. This is the knob's mapping,
    not a measurement; what recall a target delivers depends on the
    backend's approx_max_k (exact on CPU and GPU)."""
    base = float(settings.ann_recall_target)
    anchor = 80.0
    ef = max(1, int(ef_search))
    if ef <= anchor:
        return float(min(0.999, base))
    scaled = 1.0 - (1.0 - base) * (anchor / ef) ** 0.5
    return float(min(0.999, max(0.5, scaled)))
