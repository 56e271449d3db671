"""Cold tier: host-RAM document rows beyond the device-row cap.

One device's memory bounds the hot corpus (~6.2 KB per row at bf16 +
lex_dim 4096). The usual scale-out is the data mesh (`MESH_SHAPE`,
SURVEY.md §2.4), but a single-device deployment can
still hold a larger corpus by spilling rows past
``INDEX_MAX_DEVICE_ROWS`` into host memory: the cold rows keep the exact
hot-tier layout (encoded embeddings, int8 lexical signatures, tech
slots, call/date scalars) and are scanned by the SAME fused lane program
(ops/fused.multi_lane_retrieve) in fixed-shape blocks streamed through
the device per query batch, then lane-merged with the hot results before
RRF. Scoring is identical by construction — same formulas, corpus-wide
df/avgdl/idf stats — so results match an uncapped index bit-for-bit
(tested); the trade is bandwidth: each batch re-ships cold blocks over
PCIe, so cold QPS scales with host→device bandwidth, not HBM.

Not supported with multi-process gangs or a sharded mesh (those ARE the
scale-out path); CorpusIndex refuses the combination at startup.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..logging_utils import get_logger

logger = get_logger(__name__)

INT32_MIN = np.iinfo(np.int32).min


def _next_pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


class ColdTier:
    """Host-side row arrays for one corpus, layout-identical to the hot
    tier. All mutation happens under the owning CorpusIndex's lock."""

    def __init__(self, *, dim: int, lex_dim: int, tech_slots: int,
                 emb_dtype) -> None:
        self.dim = dim
        self.lex_dim = lex_dim
        self.tech_slots = tech_slots
        # the storage dtype as a numpy dtype (ml_dtypes bf16 works in
        # numpy arrays; int8 is int8) — blocks ship to device unconverted
        self.emb_dtype = np.dtype(emb_dtype)
        self.capacity = 0
        self.count = 0
        self.tombstones = 0
        self.emb_rows = 0
        # This tier's share of the corpus-wide lexical stats. Query-time
        # scoring uses the corpus totals (hot+cold agree on idf/avgdl);
        # checkpoints snapshot the HOT tier only, so the save subtracts
        # these deltas and the startup reconcile re-adds them when the
        # cold rows re-insert from the store.
        self.df = np.zeros(lex_dim, dtype=np.int64)
        self.dl_sum = 0
        self._id_to_pos: Dict[int, int] = {}
        self._alloc(1024)

    def _alloc(self, cap: int) -> None:
        def grow(name, shape, dtype, fill=0):
            old = getattr(self, name, None)
            arr = np.full(shape, fill, dtype=dtype)
            if old is not None and self.count:
                arr[: self.count] = old[: self.count]
            setattr(self, name, arr)

        grow("emb", (cap, self.dim), self.emb_dtype)
        grow("lex", (cap, self.lex_dim), np.int8)
        grow("tech", (cap, self.tech_slots), np.int32)
        grow("call_idx", (cap,), np.int32)
        grow("started", (cap,), np.int32, fill=INT32_MIN)
        grow("has_emb", (cap,), bool)
        grow("ids", (cap,), np.int64)
        self.capacity = cap

    @property
    def live_count(self) -> int:
        return self.count - self.tombstones

    def contains(self, doc_id: int) -> bool:
        return int(doc_id) in self._id_to_pos

    def positions(self, doc_ids: Sequence[int]) -> np.ndarray:
        return np.array(
            [self._id_to_pos.get(int(d), -1) for d in doc_ids],
            dtype=np.int64,
        )

    # -- mutation (caller holds the corpus lock) ------------------------

    def insert(self, rows, encode_emb) -> None:
        n = len(rows)
        if self.count + n > self.capacity:
            self._alloc(_next_pow2(self.count + n, lo=1024))
        start = self.count
        emb = np.zeros((n, self.dim), dtype=np.float32)
        for i, r in enumerate(rows):
            pos = start + i
            if r.embedding is not None:
                emb[i] = r.embedding
                self.has_emb[pos] = True
                self.emb_rows += 1
            self.lex[pos] = r.lex_sig
            self.tech[pos] = r.tech
            self.call_idx[pos] = r.call_seq
            self.started[pos] = r.started_sec
            self.ids[pos] = r.doc_id
            self._id_to_pos[int(r.doc_id)] = pos
            self.df[r.lex_touched] += 1
            self.dl_sum += r.lex_dl
        self.emb[start:start + n] = encode_emb(emb)
        self.count += n

    def set_embeddings(self, pos: np.ndarray, vals: np.ndarray,
                       encode_emb) -> int:
        self.emb[pos] = encode_emb(np.asarray(vals, dtype=np.float32))
        fresh = int((~self.has_emb[pos]).sum())
        self.has_emb[pos] = True
        self.emb_rows += fresh
        return int(pos.shape[0])

    def set_tech(self, pos: np.ndarray, vals: np.ndarray) -> int:
        self.tech[pos] = np.asarray(vals, dtype=np.int32)
        return int(pos.shape[0])

    def set_lex(self, pos: np.ndarray, vals: np.ndarray) -> int:
        vals = np.asarray(vals, dtype=np.int8)
        self.df -= (self.lex[pos] != 0).sum(axis=0)
        self.lex[pos] = vals
        self.df += (vals != 0).sum(axis=0)
        return int(pos.shape[0])

    def tombstone(self, pos: np.ndarray,
                  lex_sigs: Optional[Sequence] = None,
                  lex_dls: Optional[Sequence] = None) -> int:
        """``lex_sigs``/``lex_dls`` (aligned with ``pos``) shed this
        tier's share of the corpus lexical stats, mirroring the hot
        tier's delete contract."""
        self.emb_rows -= int(self.has_emb[pos].sum())
        self.started[pos] = INT32_MIN
        self.has_emb[pos] = False
        for doc_id in self.ids[pos]:
            self._id_to_pos.pop(int(doc_id), None)
        if lex_sigs is not None:
            for i, sig in enumerate(lex_sigs):
                if sig is not None:
                    touched = np.flatnonzero(sig)
                    self.df[touched] = np.maximum(self.df[touched] - 1, 0)
        if lex_dls is not None:
            self.dl_sum = max(
                self.dl_sum - int(sum(int(d or 0) for d in lex_dls)), 0
            )
        self.tombstones += int(pos.shape[0])
        return int(pos.shape[0])

    def compact(self) -> None:
        """Drop tombstoned rows (host memmove — cheap next to the hot
        tier's device gather)."""
        n = self.count
        live = np.flatnonzero(self.started[:n] != INT32_MIN)
        m = int(live.shape[0])
        for name in ("emb", "lex", "tech", "call_idx", "started",
                     "has_emb", "ids"):
            arr = getattr(self, name)
            arr[:m] = arr[live]
            if name == "started":
                arr[m:n] = INT32_MIN
            elif name != "emb":
                arr[m:n] = 0
        self.count = m
        self.tombstones = 0
        self._id_to_pos = {
            int(d): p for p, d in enumerate(self.ids[:m])
        }

    def estimate(self, allowed_calls: Optional[np.ndarray], date_min: int,
                 date_max: int, require_embedding: bool,
                 unfiltered: bool) -> int:
        n = self.count
        if n == 0:
            return 0
        if unfiltered:
            return self.emb_rows if require_embedding else self.live_count
        mask = (self.started[:n] >= date_min) & (self.started[:n] <= date_max)
        if allowed_calls is not None:
            mask &= allowed_calls[self.call_idx[:n]]
        if require_embedding:
            mask &= self.has_emb[:n]
        return int(mask.sum())

    # -- query -----------------------------------------------------------

    def dispatch(
        self,
        q_emb: Optional[np.ndarray],
        q_lex: np.ndarray,                # (B, lex_dim) f32 DENSE
        q_tech: np.ndarray,
        allowed_calls: np.ndarray,
        date_min: np.ndarray,
        date_max: np.ndarray,
        *,
        ks: Tuple[int, int, int],
        dense_mode: str,
        recall_target: float,
        block_rows: int,
    ) -> List[Tuple[dict, np.ndarray, int]]:
        """Enqueue one fused-lane program per cold block (fixed padded
        shapes — one compile per block geometry) and return
        [(lane_futures, ids_snapshot, block_n)] without blocking. Must be
        called under the corpus lock; every block ships a SNAPSHOT of
        the host arrays, so mutations after the lock is released cannot
        corrupt an in-flight scan."""
        from ..ops.fused import multi_lane_retrieve

        n = self.count
        if n == 0:
            return []
        batch = q_tech.shape[0]
        dense_enabled = q_emb is not None
        if q_emb is None:
            q_emb = np.zeros((batch, self.dim), np.float32)
        # IVF never covers the cold tier; any non-exact mode scans approx
        mode = "exact" if dense_mode == "exact" else "ann"
        block = min(block_rows, _next_pow2(n, lo=1024))
        k_dense, k_lex, k_tech = (min(k, block) for k in ks)
        out: List[Tuple[dict, np.ndarray, int]] = []
        for start in range(0, n, block):
            stop = min(start + block, n)
            bn = stop - start
            if bn == block:
                # SNAPSHOT the block (host memcpy, trivial next to the
                # H2D transfer): jax gives no guarantee the host buffer
                # is consumed before the call returns (CPU backend can
                # zero-copy alias it), so a set_*/compact by the syncer
                # thread after the corpus lock is released must not be
                # able to corrupt an in-flight scan
                emb_b = self.emb[start:stop].copy()
                lex_b = self.lex[start:stop].copy()
                tech_b = self.tech[start:stop].copy()
                call_b = self.call_idx[start:stop].copy()
                started_b = self.started[start:stop].copy()
                has_b = self.has_emb[start:stop].copy()
            else:
                # pad the tail block to the fixed shape; padding rows
                # carry started=INT32_MIN so every lane masks them out
                def pad(arr, fill=0):
                    padded = np.full((block, *arr.shape[1:]), fill,
                                     dtype=arr.dtype)
                    padded[:bn] = arr[start:stop]
                    return padded

                emb_b = pad(self.emb)
                lex_b = pad(self.lex)
                tech_b = pad(self.tech)
                call_b = pad(self.call_idx)
                started_b = pad(self.started, fill=INT32_MIN)
                has_b = pad(self.has_emb, fill=False)
            lanes = multi_lane_retrieve(
                emb_b, lex_b, tech_b, call_b, started_b, has_b,
                q_emb.astype(np.float32, copy=False),
                q_lex.astype(np.float32, copy=False),
                q_tech, allowed_calls, date_min, date_max,
                k_dense=k_dense, k_lex=k_lex, k_tech=k_tech,
                dense_mode=mode, recall_target=float(recall_target),
                dense_enabled=dense_enabled,
            )
            out.append((lanes, self.ids[start:stop].copy(), bn))
        return out


def merge_rect_lanes(
    base: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]],
    extras: Sequence[Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]],
    ks: Dict[str, int],
) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Merge per-lane rectangular blocks (ids (B,k), scores (B,k) sorted
    desc, counts (B,)) from the hot tier and cold blocks into one top-k
    per lane. Entries beyond each row's count are forced to -inf so only
    valid rows compete; ties keep source order (hot first) via stable
    sort — deterministic for deterministic inputs."""
    if not extras:
        return base
    merged: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    for lane, (ids0, scores0, counts0) in base.items():
        parts = [(ids0, scores0, counts0)] + [
            e[lane] for e in extras if lane in e
        ]
        ids_cat = np.concatenate([p[0] for p in parts], axis=1)
        scores_cat = np.concatenate(
            [p[1].astype(np.float32, copy=True) for p in parts], axis=1
        )
        col = 0
        for p_ids, p_scores, p_counts in parts:
            w = p_ids.shape[1]
            if w:
                valid = np.arange(w)[None, :] < p_counts[:, None]
                scores_cat[:, col:col + w][~valid] = -np.inf
            col += w
        k = min(int(ks[lane]), ids_cat.shape[1])
        order = np.argsort(-scores_cat, axis=1, kind="stable")[:, :k]
        ids_out = np.take_along_axis(ids_cat, order, axis=1)
        scores_out = np.take_along_axis(scores_cat, order, axis=1)
        counts_out = np.isfinite(scores_out).sum(axis=1).astype(np.int32)
        merged[lane] = (ids_out, scores_out, counts_out)
    return merged


def collect_cold(
    corpus, pending: Sequence[Tuple[dict, np.ndarray, int]], batch: int,
) -> List[Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]]:
    """Block on dispatched cold blocks and map block positions to doc
    ids (reuses the hot tier's rectangularizing postprocess with the
    block's id snapshot)."""
    import jax

    out = []
    for lanes, ids_snap, block_n in pending:
        lanes_np = jax.device_get(lanes)
        out.append(
            corpus.postprocess_lanes(lanes_np, batch, ids_snap, block_n)
        )
    return out


__all__ = ["ColdTier", "merge_rect_lanes", "collect_cold"]
