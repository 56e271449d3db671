"""Lane checks: the fused /retrieve program against plain numpy references.

Each lane of ``ops/pack.dual_corpus_retrieve_packed`` (the production
program) is compared with an independent numpy computation of the same
contract over the same corpus arrays:

- dense: f32 products of the query (rounded as the program's contract
  rounds it: f16 transport, then the storage dtype) with the stored rows,
  top-k over the filter mask — scored as recall@k;
- lexical: f32 products of the densified sparse query with the int8
  signatures, the match threshold, top-k — scored as top-k overlap;
- tech: a set intersection of the query's token hashes with each row's
  slot-addressed tokens, ordered (started_sec desc, position asc) —
  ids and order must be identical;
- RRF: the device merge (``fuse_rrf=True``) against the host oracle
  (``ops/fusion.rrf_merge_rect``) on the same lane outputs — ids must be
  identical.

``chip_smoke.py`` runs these at full width on a GPU; the tests run them at
small widths on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..ops.hashing import tech_query_structure_from_hashes, tech_slot_choices
from ..ops.lexical import LEX_MATCH_THRESHOLD
from ..ops.pack import LANE_ORDER, pack_queries, unflatten_lanes, unflatten_merged

API_LANE = {"lex": "bm25", "tech": "tech_tokens", "dense": "dense"}
INT32_MIN = np.int32(-2147483648)


@dataclasses.dataclass
class HostCorpus:
    """Host copies of one corpus's device arrays (capacity rows)."""

    emb: np.ndarray        # (N, dim) storage dtype (bf16 / f32 / int8)
    lex: np.ndarray        # (N, D) int8
    tech: np.ndarray       # (N, S) int32
    call_idx: np.ndarray   # (N,) int32
    started: np.ndarray    # (N,) int32
    has_emb: np.ndarray    # (N,) bool

    @classmethod
    def from_device(cls, arrays) -> "HostCorpus":
        import jax

        return cls(*(np.asarray(a) for a in jax.device_get(tuple(arrays))))


@dataclasses.dataclass
class QueryBatch:
    """One packed batch of queries plus the host-side facts the
    references need (the tech hashes before slot placement)."""

    q_emb: np.ndarray                          # (B, dim) f32
    chunk_lex: Tuple[np.ndarray, np.ndarray]   # (B, F) u16, (B, F) f16
    artifact_lex: Tuple[np.ndarray, np.ndarray]
    tech_hashes: List[List[int]]
    q_tech: np.ndarray                         # (B, S*C) int32
    allowed: np.ndarray                        # (B, n_calls) bool
    date_min: np.ndarray                       # (B,) int32
    date_max: np.ndarray                       # (B,) int32

    @property
    def batch(self) -> int:
        return self.q_tech.shape[0]

    def packed(self) -> np.ndarray:
        return pack_queries(
            self.q_emb, self.chunk_lex, self.artifact_lex, self.q_tech,
            self.allowed, self.date_min, self.date_max,
        )


def home_slot_tokens(corpus: HostCorpus, rows: int = 4096,
                     seed: int = 0) -> np.ndarray:
    """Token hashes stored at one of their own choice slots (the only
    placements the slot-addressed compare can see), from a row sample."""
    rng = np.random.default_rng(seed)
    live = np.flatnonzero(corpus.started != INT32_MIN)
    sample = corpus.tech[rng.choice(live, size=min(rows, live.size),
                                    replace=False)]
    slots = corpus.tech.shape[1]
    out = set()
    for s in range(slots):
        for h in np.unique(sample[:, s]):
            if h != 0 and s in tech_slot_choices(int(h), slots):
                out.add(int(h))
    return np.array(sorted(out), dtype=np.int64)


def make_queries(
    chunks: HostCorpus, *, batch: int, n_calls: int, q_feats: int,
    tech_capacity: int, filtered_rows: Sequence[int], seed: int = 0,
) -> QueryBatch:
    """Random unit queries, random sparse lexical features, one or two
    tech hashes that occur in the corpus (on disjoint slots, so none is
    dropped at capacity 1), and call + date filters on ``filtered_rows``."""
    rng = np.random.default_rng(seed)
    dim = chunks.emb.shape[1]
    lex_dim = chunks.lex.shape[1]
    slots = chunks.tech.shape[1]
    q_emb = rng.standard_normal((batch, dim)).astype(np.float32)
    q_emb /= np.linalg.norm(q_emb, axis=1, keepdims=True)

    def sparse():
        buckets = rng.integers(0, lex_dim, (batch, q_feats)).astype(np.uint16)
        values = (rng.standard_normal((batch, q_feats)) * 0.05).astype(
            np.float16
        )
        return buckets, values

    pool = home_slot_tokens(chunks, seed=seed)
    hashes: List[List[int]] = []
    for _ in range(batch):
        first = int(rng.choice(pool))
        chosen = [first]
        used = set(tech_slot_choices(first, slots))
        second = int(rng.choice(pool))
        if rng.random() < 0.5 and not used & set(
            tech_slot_choices(second, slots)
        ):
            chosen.append(second)
        hashes.append(chosen)
    q_tech = np.stack([
        tech_query_structure_from_hashes(h, slots, tech_capacity)
        for h in hashes
    ])
    allowed = np.ones((batch, n_calls), dtype=bool)
    date_min = np.full(batch, -2147483647, dtype=np.int32)
    date_max = np.full(batch, 2**31 - 1, dtype=np.int32)
    live = chunks.started[chunks.started != INT32_MIN]
    lo, hi = np.quantile(live, [0.2, 0.8]).astype(np.int64)
    for b in filtered_rows:
        allowed[b] = rng.random(n_calls) < 0.4
        date_min[b] = lo
        date_max[b] = hi
    return QueryBatch(q_emb, sparse(), sparse(), hashes, q_tech, allowed,
                      date_min, date_max)


def run_packed(chunk_arrays, artifact_arrays, qb: QueryBatch, *,
               chunk_ks, artifact_ks, mode: str, fuse_rrf: bool,
               d_packed=None) -> np.ndarray:
    """One call of the production program; returns its flat output."""
    import jax

    from ..ops.pack import dual_corpus_retrieve_packed

    if d_packed is None:
        d_packed = jax.numpy.asarray(qb.packed())
    flat = dual_corpus_retrieve_packed(
        tuple(chunk_arrays), tuple(artifact_arrays), d_packed,
        **program_kwargs(qb, chunk_arrays, chunk_ks=chunk_ks,
                         artifact_ks=artifact_ks, mode=mode,
                         fuse_rrf=fuse_rrf),
    )
    return np.asarray(jax.device_get(flat))


def program_kwargs(qb: QueryBatch, chunk_arrays, *, chunk_ks, artifact_ks,
                   mode: str, fuse_rrf: bool) -> Dict:
    return dict(
        batch=qb.batch, emb_dim=chunk_arrays[0].shape[1],
        q_feats=qb.chunk_lex[0].shape[1], tech_q=qb.q_tech.shape[1],
        n_calls=qb.allowed.shape[1], chunk_ks=tuple(chunk_ks),
        artifact_ks=tuple(artifact_ks), chunk_mode=mode, artifact_mode=mode,
        recall_target=0.95, dense_enabled=True, fuse_rrf=fuse_rrf,
    )


def split_lanes(flat, *, chunk_ks, artifact_ks, mode):
    return unflatten_lanes(
        flat, chunk_ks=tuple(chunk_ks), artifact_ks=tuple(artifact_ks),
        chunk_mode=mode, artifact_mode=mode, dense_enabled=True,
    )


# ---------------------------------------------------------------- references

def host_filter_mask(corpus: HostCorpus, qb: QueryBatch,
                     rows: Sequence[int]) -> np.ndarray:
    """(len(rows), N) bool: the filter contract of ops/masks.filter_mask."""
    valid = corpus.started != INT32_MIN
    out = np.empty((len(rows), corpus.started.shape[0]), dtype=bool)
    for i, b in enumerate(rows):
        out[i] = (
            qb.allowed[b][corpus.call_idx]
            & (corpus.started >= qb.date_min[b])
            & (corpus.started <= qb.date_max[b])
            & valid
        )
    return out


def _storage_as_f32(block: np.ndarray) -> np.ndarray:
    if block.dtype == np.int8:
        return block.astype(np.float32) / np.float32(127.0)
    return block.astype(np.float32)


def query_as_program_sees_it(q_emb: np.ndarray, storage) -> np.ndarray:
    """The dense query after the program's documented rounding: f16 on
    the wire (ops/pack.py), then the storage dtype — bf16 for bf16 and
    int8 storage (ops/topk.dense_scores), unchanged for f32 storage."""
    import ml_dtypes

    q = q_emb.astype(np.float16).astype(np.float32)
    if np.dtype(storage) != np.float32:
        q = q.astype(ml_dtypes.bfloat16).astype(np.float32)
    return q


def _blocked_scores(q: np.ndarray, table: np.ndarray,
                    block: int = 65536) -> np.ndarray:
    """q @ table.T in f32, converting the table a row block at a time."""
    out = np.empty((q.shape[0], table.shape[0]), dtype=np.float32)
    for start in range(0, table.shape[0], block):
        part = table[start:start + block].astype(np.float32)
        out[:, start:start + block] = q @ part.T
    return out


def _topk_sets(scores: np.ndarray, k: int) -> List[np.ndarray]:
    """Per row: positions of the top-k finite scores."""
    out = []
    for row in scores:
        finite = np.flatnonzero(np.isfinite(row))
        kk = min(k, finite.size)
        if kk == 0:
            out.append(np.zeros(0, dtype=np.int64))
            continue
        part = finite[np.argpartition(-row[finite], kk - 1)[:kk]]
        out.append(part)
    return out


def dense_reference(corpus: HostCorpus, qb: QueryBatch, rows, k: int):
    from ..ops.topk import reference_topk_numpy

    q = query_as_program_sees_it(qb.q_emb[list(rows)], corpus.emb.dtype)
    mask = host_filter_mask(corpus, qb, rows) & corpus.has_emb[None, :]
    scores, idx = reference_topk_numpy(q, _storage_as_f32(corpus.emb),
                                       mask, k)
    return [i[np.isfinite(v)] for v, i in zip(scores, idx)]


def densify(sparse: Tuple[np.ndarray, np.ndarray], lex_dim: int,
            rows) -> np.ndarray:
    """Host twin of ops/pack._densify for the given batch rows."""
    buckets, values = sparse
    rows = list(rows)
    out = np.zeros((len(rows), lex_dim), dtype=np.float32)
    for i, b in enumerate(rows):
        np.add.at(out[i], buckets[b].astype(np.int64),
                  values[b].astype(np.float32))
    return out


def lexical_reference(corpus: HostCorpus, sparse, qb: QueryBatch, rows,
                      k: int):
    q = densify(sparse, corpus.lex.shape[1], rows)
    scores = _blocked_scores(q, corpus.lex)
    keep = host_filter_mask(corpus, qb, rows) & (scores > LEX_MATCH_THRESHOLD)
    return _topk_sets(np.where(keep, scores, -np.inf), k)


def tech_reference(corpus: HostCorpus, qb: QueryBatch, rows,
                   k: int) -> List[np.ndarray]:
    """Positions in (started_sec desc, position asc) order: rows whose
    slot-addressed token set intersects the query's hashes."""
    slots = corpus.tech.shape[1]
    mask = host_filter_mask(corpus, qb, rows)
    out = []
    for i, b in enumerate(rows):
        match = np.zeros(corpus.tech.shape[0], dtype=bool)
        for h in qb.tech_hashes[b]:
            for s in set(tech_slot_choices(int(h), slots)):
                match |= corpus.tech[:, s] == h
        pos = np.flatnonzero(match & mask[i])
        order = np.lexsort((pos, -corpus.started[pos].astype(np.int64)))
        out.append(pos[order][:k])
    return out


# ---------------------------------------------------------------- comparisons

def _finite_positions(lane, b) -> np.ndarray:
    scores, pos = lane
    return pos[b][np.isfinite(scores[b])].astype(np.int64)


def set_recall(dev_lane, ref_sets: List[np.ndarray], rows) -> Dict:
    """recall@k = |device ∩ reference| / |reference| per query row."""
    recalls = []
    for i, b in enumerate(rows):
        ref = set(ref_sets[i].tolist())
        got = set(_finite_positions(dev_lane, b).tolist())
        if not ref:
            recalls.append(1.0 if not got else 0.0)
            continue
        recalls.append(len(ref & got) / len(ref))
    return {"min": float(min(recalls)), "mean": float(np.mean(recalls)),
            "rows": len(recalls)}


def ordered_equal(dev_lane, ref_lists: List[np.ndarray], rows) -> Dict:
    """Tech lane: device positions and order identical to the reference."""
    bad = []
    hits = 0
    for i, b in enumerate(rows):
        got = _finite_positions(dev_lane, b)
        hits += got.size
        if not np.array_equal(got, ref_lists[i]):
            bad.append(int(b))
    return {"identical": not bad, "mismatched_rows": bad, "rows": len(rows),
            "matches": hits}


def rrf_equal(lanes_flat, merged_flat, *, chunk_ks, artifact_ks,
              mode) -> Dict:
    """Device RRF vs the host oracle applied to the same lane outputs."""
    from ..ops.fusion import rrf_merge_rect

    per_corpus = split_lanes(lanes_flat, chunk_ks=chunk_ks,
                             artifact_ks=artifact_ks, mode=mode)
    merged = unflatten_merged(
        merged_flat, chunk_ks=tuple(chunk_ks), artifact_ks=tuple(artifact_ks),
        chunk_mode=mode, artifact_mode=mode, dense_enabled=True,
    )
    bad = []
    for name, lanes, (_fused, pos, _masks, counts) in zip(
        ("chunks", "artifacts"), per_corpus, merged
    ):
        rect = {}
        for lane in LANE_ORDER:
            if lane not in lanes:
                continue
            vals, p = lanes[lane]
            rect[API_LANE[lane]] = (
                p.astype(np.int64), vals.astype(np.float32),
                np.isfinite(vals).sum(axis=1).astype(np.int32),
            )
        host = rrf_merge_rect(rect)
        for b in range(pos.shape[0]):
            n = int(counts[b])
            if not np.array_equal(pos[b, :n].astype(np.int64), host[b][0]):
                bad.append((name, b))
    return {"identical": not bad, "mismatched": bad[:8],
            "rows": int(merged[0][1].shape[0])}


def lane_references(chunks: HostCorpus, artifacts: HostCorpus,
                    qb: QueryBatch, rows, *, chunk_ks, artifact_ks) -> Dict:
    """The numpy answer of every lane of both corpora for ``rows``."""
    refs = {}
    for name, corpus, ks, sparse in (
        ("chunks", chunks, chunk_ks, qb.chunk_lex),
        ("artifacts", artifacts, artifact_ks, qb.artifact_lex),
    ):
        refs[f"{name}.dense"] = dense_reference(corpus, qb, rows, ks[0])
        refs[f"{name}.lex"] = lexical_reference(corpus, sparse, qb, rows,
                                                ks[1])
        refs[f"{name}.tech"] = tech_reference(corpus, qb, rows, ks[2])
    return refs


def compare_lanes(flat, merged, refs: Dict, rows, *, chunk_ks, artifact_ks,
                  mode: str) -> Dict:
    """One packed batch's device output (``flat`` per lane, ``merged``
    with device RRF) against ``lane_references`` for the sampled rows,
    plus device RRF against the host oracle for the whole batch."""
    dev = dict(zip(("chunks", "artifacts"), split_lanes(
        flat, chunk_ks=chunk_ks, artifact_ks=artifact_ks, mode=mode
    )))
    out: Dict[str, Dict] = {}
    for key, ref in refs.items():
        corpus, lane = key.split(".")
        if lane == "tech":
            out[key] = ordered_equal(dev[corpus][lane], ref, rows)
        else:
            out[key] = set_recall(dev[corpus][lane], ref, rows)
    out["rrf"] = rrf_equal(flat, merged, chunk_ks=chunk_ks,
                           artifact_ks=artifact_ks, mode=mode)
    return out


def check_lanes(chunk_arrays, artifact_arrays, chunks: HostCorpus,
                artifacts: HostCorpus, qb: QueryBatch, rows, *,
                chunk_ks, artifact_ks, mode: str) -> Dict:
    """``compare_lanes`` for one mode through the jitted program."""
    kw = dict(chunk_ks=chunk_ks, artifact_ks=artifact_ks, mode=mode)
    flat = run_packed(chunk_arrays, artifact_arrays, qb, fuse_rrf=False,
                      **kw)
    merged = run_packed(chunk_arrays, artifact_arrays, qb, fuse_rrf=True,
                        **kw)
    refs = lane_references(chunks, artifacts, qb, rows, chunk_ks=chunk_ks,
                           artifact_ks=artifact_ks)
    return compare_lanes(flat, merged, refs, rows, **kw)


# Targets a lane check is held to (chip_smoke.py states their reasons).
DENSE_MIN_RECALL = 0.99
LEX_MIN_OVERLAP = 0.99


def failures(results: Dict) -> List[str]:
    """Every sampled row is held to its target: one bad filtered query
    fails the check even when the mean over the sample would pass."""
    bad = []
    for key, res in results.items():
        if key.endswith(".dense") and res["min"] < DENSE_MIN_RECALL:
            bad.append(f"{key} recall {res['min']:.4f} < {DENSE_MIN_RECALL}")
        elif key.endswith(".lex") and res["min"] < LEX_MIN_OVERLAP:
            bad.append(f"{key} overlap {res['min']:.4f} < {LEX_MIN_OVERLAP}")
        elif key.endswith(".tech") and not res["identical"]:
            bad.append(f"{key} order differs on rows {res['mismatched_rows']}")
        elif key == "rrf" and not res["identical"]:
            bad.append(f"rrf ids differ: {res['mismatched']}")
    return bad
