"""Packed query transfer: ONE small H2D buffer per /retrieve dispatch.

Every host->device transfer is a separate copy with its own fixed cost,
and the dense (B, 4096) f32 lexical query vectors alone would be 4 MB
per batch of 128 for the two corpora, so the engine sends ONE uint8
buffer holding:

- q_emb as f16 (the index stores bf16; f16 transport loses nothing),
- the lexical query SPARSELY — (bucket, value) pairs per corpus, F slots
  wide — instead of (B, D) f32 dense: a query touches ~60 of 4096 buckets,
  so this is ~50x fewer bytes; the dense vector is rebuilt on device by a
  scatter-add that costs microseconds,
- tech hashes (i32), the call-bitmap filter (u8), date bounds (i32),

and the jitted program bitcasts slices back into typed arrays before
running the same fused lanes (ops/fused.py): a few hundred KB in one copy
instead of several MB in seven.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .fused import _lanes_one_corpus

# fixed sparse width for query lexical features (word + trigram buckets);
# queries beyond F features drop the lowest-|value| tail
DEFAULT_F = 256

# flat-output lane order per corpus (must match the dict insertion order
# of fused._lanes_one_corpus)
LANE_ORDER = ("lex", "tech", "dense")


def lane_layout(
    chunk_ks: Tuple[int, int, int],
    artifact_ks: Tuple[int, int, int],
    chunk_mode: str,
    artifact_mode: str,
    dense_enabled: bool,
):
    """[(corpus, lane, k)] in the flat-buffer column order produced by
    ``_flatten_lanes`` (each lane contributes k score cols + k position
    cols). The dense lane is present iff it actually ran in-program
    (dense enabled and the mode isn't "none" — "none" means a separate
    IVF dispatch served it)."""
    layout = []
    for corpus, ks, mode in (
        ("chunks", chunk_ks, chunk_mode),
        ("artifacts", artifact_ks, artifact_mode),
    ):
        layout.append((corpus, "lex", ks[1]))
        layout.append((corpus, "tech", ks[2]))
        if dense_enabled and mode != "none":
            layout.append((corpus, "dense", ks[0]))
    return layout


def _flatten_lanes(chunks_out, artifacts_out) -> jax.Array:
    """All lane outputs -> ONE (B, total) int32 array (f32 scores bitcast
    to i32). Each device array fetched is its own device->host copy, so
    the program concatenates all 12 lane arrays into a single transfer."""
    parts = []
    for out in (chunks_out, artifacts_out):
        for name in LANE_ORDER:
            if name not in out:
                continue
            scores, pos = out[name]
            parts.append(jax.lax.bitcast_convert_type(
                scores.astype(jnp.float32), jnp.int32
            ))
            parts.append(pos.astype(jnp.int32))
    return jnp.concatenate(parts, axis=1)


def unflatten_lanes(
    flat: np.ndarray,
    *,
    chunk_ks: Tuple[int, int, int],
    artifact_ks: Tuple[int, int, int],
    chunk_mode: str,
    artifact_mode: str,
    dense_enabled: bool,
) -> Tuple[Dict[str, Tuple[np.ndarray, np.ndarray]],
           Dict[str, Tuple[np.ndarray, np.ndarray]]]:
    """Host inverse of ``_flatten_lanes``: zero-copy views back into
    per-lane {name: (f32 scores, i32 positions)} dicts per corpus."""
    flat = np.ascontiguousarray(flat)
    flat_f = flat.view(np.float32)
    chunks: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    artifacts: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    off = 0
    for corpus, lane, k in lane_layout(
        chunk_ks, artifact_ks, chunk_mode, artifact_mode, dense_enabled
    ):
        scores = flat_f[:, off:off + k]
        pos = flat[:, off + k:off + 2 * k]
        off += 2 * k
        (chunks if corpus == "chunks" else artifacts)[lane] = (scores, pos)
    if off != flat.shape[1]:
        raise ValueError(
            f"flat lane buffer has {flat.shape[1]} cols, layout expects {off}"
        )
    return chunks, artifacts


def merged_width(ks: Tuple[int, int, int], mode: str, dense_enabled: bool) -> int:
    """Total RRF candidate slots per corpus row (sum of lane widths)."""
    k = ks[1] + ks[2]
    if dense_enabled and mode != "none":
        k += ks[0]
    return k


def _flatten_merged(chunks_merged, artifacts_merged) -> jax.Array:
    """Device-fused RRF outputs -> ONE (B, total) int32 buffer per the
    same single-transfer rationale as ``_flatten_lanes``. Per corpus:
    [fused-scores bitcast (B,K) | positions (B,K) | lane-masks (B,K) |
    count (B,1)]."""
    parts = []
    for pos, fused, masks, counts in (chunks_merged, artifacts_merged):
        parts.append(jax.lax.bitcast_convert_type(fused, jnp.int32))
        parts.append(pos)
        parts.append(masks)
        parts.append(counts[:, None])
    return jnp.concatenate(parts, axis=1)


def unflatten_merged(
    flat: np.ndarray,
    *,
    chunk_ks: Tuple[int, int, int],
    artifact_ks: Tuple[int, int, int],
    chunk_mode: str,
    artifact_mode: str,
    dense_enabled: bool,
) -> Tuple[Tuple[np.ndarray, ...], Tuple[np.ndarray, ...]]:
    """Host inverse of ``_flatten_merged``: per corpus
    (fused f32 (B,K), positions i32 (B,K), masks i32 (B,K), counts (B,))."""
    flat = np.ascontiguousarray(flat)
    flat_f = flat.view(np.float32)
    out = []
    off = 0
    for ks, mode in ((chunk_ks, chunk_mode), (artifact_ks, artifact_mode)):
        K = merged_width(ks, mode, dense_enabled)
        fused = flat_f[:, off:off + K]
        pos = flat[:, off + K:off + 2 * K]
        masks = flat[:, off + 2 * K:off + 3 * K]
        counts = flat[:, off + 3 * K]
        off += 3 * K + 1
        out.append((fused, pos, masks, counts))
    if off != flat.shape[1]:
        raise ValueError(
            f"flat merged buffer has {flat.shape[1]} cols, layout expects {off}"
        )
    return out[0], out[1]


def sparse_lex_rows(
    feats_list, doc_freq: np.ndarray, n_docs: int, F: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-plan (buckets, signs, tfs) feature tuples -> padded (B, F)
    uint16 buckets + (B, F) f16 values with each corpus's idf applied
    (host side; same math as hashing.query_vector_from_features).
    Vectorized over the whole batch: one flat gather/log/scatter instead
    of 128 small-array passes (~4 ms/batch of numpy call overhead on the
    1-core serving host); only the rare >F overflow row falls back to a
    per-row tail-drop."""
    from .hashing import LEX_QUANT_SCALE

    if doc_freq.shape[0] > 65536:
        raise ValueError(
            f"lexical_dim {doc_freq.shape[0]} exceeds the uint16 sparse "
            "transport (max 65536); widen ops/pack.py bucket dtype first"
        )
    batch = len(feats_list)
    buckets_out = np.zeros((batch, F), dtype=np.uint16)
    values_out = np.zeros((batch, F), dtype=np.float16)
    if n_docs <= 0 or batch == 0:
        return buckets_out, values_out
    sizes = np.fromiter(
        (f[0].size for f in feats_list), dtype=np.int64, count=batch
    )
    if not sizes.any():
        return buckets_out, values_out
    flat_b = np.concatenate([f[0] for f in feats_list])
    flat_s = np.concatenate([f[1] for f in feats_list])
    flat_t = np.concatenate([f[2] for f in feats_list])
    df = doc_freq[flat_b].astype(np.float32)
    idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    flat_v = (flat_s * idf * flat_t) / LEX_QUANT_SCALE

    starts = np.concatenate(([0], np.cumsum(sizes)))
    if not (sizes > F).any():
        rows = np.repeat(np.arange(batch), sizes)
        cols = np.arange(int(sizes.sum())) - np.repeat(starts[:-1], sizes)
        buckets_out[rows, cols] = flat_b.astype(np.uint16)
        values_out[rows, cols] = flat_v.astype(np.float16)
    else:
        # at least one row overflows F: keep the largest-|value| F feats
        # for those rows (same semantics as the per-row path)
        for i in np.flatnonzero(sizes > F):
            s, e = starts[i], starts[i + 1]
            keep = np.argsort(-np.abs(flat_v[s:e]))[:F]
            buckets_out[i] = flat_b[s:e][keep].astype(np.uint16)
            values_out[i] = flat_v[s:e][keep].astype(np.float16)
        ok = np.flatnonzero(sizes <= F)
        for i in ok:
            s = starts[i]
            k = sizes[i]
            buckets_out[i, :k] = flat_b[s:s + k].astype(np.uint16)
            values_out[i, :k] = flat_v[s:s + k].astype(np.float16)
    return buckets_out, values_out


def pack_queries(
    q_emb: Optional[np.ndarray],        # (B, dim) f32 or None
    chunk_lex: Tuple[np.ndarray, np.ndarray],     # (B,F) u16, (B,F) f16
    artifact_lex: Tuple[np.ndarray, np.ndarray],
    q_tech: np.ndarray,                 # (B, Q) int32
    allowed: np.ndarray,                # (B, C) bool
    date_min: np.ndarray,               # (B,) int32
    date_max: np.ndarray,               # (B,) int32
) -> np.ndarray:
    """-> one contiguous uint8 buffer (layout mirrored by _unpack)."""
    batch = q_tech.shape[0]
    if q_emb is None:
        q_emb = np.zeros((batch, 1), dtype=np.float32)
    parts = [
        np.ascontiguousarray(q_emb.astype(np.float16)).view(np.uint8).ravel(),
        np.ascontiguousarray(chunk_lex[0]).view(np.uint8).ravel(),
        np.ascontiguousarray(chunk_lex[1]).view(np.uint8).ravel(),
        np.ascontiguousarray(artifact_lex[0]).view(np.uint8).ravel(),
        np.ascontiguousarray(artifact_lex[1]).view(np.uint8).ravel(),
        np.ascontiguousarray(q_tech.astype(np.int32)).view(np.uint8).ravel(),
        np.ascontiguousarray(allowed).view(np.uint8).ravel(),
        np.ascontiguousarray(date_min.astype(np.int32)).view(np.uint8).ravel(),
        np.ascontiguousarray(date_max.astype(np.int32)).view(np.uint8).ravel(),
    ]
    return np.concatenate(parts)


def _bitcast(view: jax.Array, shape, dtype) -> jax.Array:
    width = jnp.dtype(dtype).itemsize
    return jax.lax.bitcast_convert_type(
        view.reshape(*shape, width), dtype
    )


def _unpack(packed, *, batch, dim, q_feats, tech_q, n_calls):
    """Static-offset slicing of the pack_queries layout."""
    sizes = {
        "q_emb": batch * dim * 2,
        "cb": batch * q_feats * 2, "cv": batch * q_feats * 2,
        "ab": batch * q_feats * 2, "av": batch * q_feats * 2,
        "tech": batch * tech_q * 4,
        "allowed": batch * n_calls,
        "dmin": batch * 4, "dmax": batch * 4,
    }
    off = 0
    views = {}
    for name, size in sizes.items():
        views[name] = jax.lax.slice_in_dim(packed, off, off + size)
        off += size
    out = {
        "q_emb": _bitcast(views["q_emb"], (batch, dim), jnp.float16)
        .astype(jnp.float32),
        "cb": _bitcast(views["cb"], (batch, q_feats), jnp.uint16)
        .astype(jnp.int32),
        "cv": _bitcast(views["cv"], (batch, q_feats), jnp.float16)
        .astype(jnp.float32),
        "ab": _bitcast(views["ab"], (batch, q_feats), jnp.uint16)
        .astype(jnp.int32),
        "av": _bitcast(views["av"], (batch, q_feats), jnp.float16)
        .astype(jnp.float32),
        "tech": _bitcast(views["tech"], (batch, tech_q), jnp.int32),
        "allowed": views["allowed"].reshape(batch, n_calls) != 0,
        "dmin": _bitcast(views["dmin"], (batch,), jnp.int32),
        "dmax": _bitcast(views["dmax"], (batch,), jnp.int32),
    }
    return out


def _densify(buckets: jax.Array, values: jax.Array, lex_dim: int) -> jax.Array:
    """(B, F) sparse -> (B, lex_dim) f32 via scatter-add (padding slots
    carry value 0, an additive no-op)."""
    batch = buckets.shape[0]
    dense = jnp.zeros((batch, lex_dim), jnp.float32)
    rows = jnp.arange(batch)[:, None]
    return dense.at[rows, buckets].add(values)


@partial(
    jax.jit,
    static_argnames=(
        "batch", "emb_dim", "q_feats", "tech_q", "n_calls",
        "chunk_ks", "artifact_ks",
        "chunk_mode", "artifact_mode", "recall_target", "dense_enabled",
        "fuse_rrf",
    ),
)
def dual_corpus_retrieve_packed(
    chunk_arrays: Tuple[jax.Array, ...],
    artifact_arrays: Tuple[jax.Array, ...],
    packed: jax.Array,                   # (bytes,) uint8
    *,
    batch: int,
    emb_dim: int,                        # 1 when dense disabled (zeros slot)
    q_feats: int,
    tech_q: int,
    n_calls: int,
    chunk_ks: Tuple[int, int, int],
    artifact_ks: Tuple[int, int, int],
    chunk_mode: str = "exact",
    artifact_mode: str = "exact",
    recall_target: float = 0.95,
    dense_enabled: bool = True,
    fuse_rrf: bool = False,
) -> jax.Array:
    """The production /retrieve program: unpack + both corpora's six lanes,
    one H2D buffer, one dispatch, ONE flat output buffer (see
    ops/fused.dual_corpus_retrieve for the lane math; this wrapper only
    changes the transfer shapes — ``unflatten_lanes`` recovers the
    per-lane dicts host-side).

    fuse_rrf=True additionally runs the RRF merge ON DEVICE
    (ops/fusion.rrf_fuse_lanes_device) and returns the merged
    (scores, positions, lane-masks, counts) buffer instead of per-lane
    outputs — ``unflatten_merged`` is the host inverse. Matches the
    reference's fusion step (app/retrieve.py:245-260) without the host
    postprocess+merge cost."""
    q = _unpack(
        packed, batch=batch, dim=emb_dim, q_feats=q_feats,
        tech_q=tech_q, n_calls=n_calls,
    )
    q_emb = q["q_emb"]
    if dense_enabled:
        dim = chunk_arrays[0].shape[1]
        assert emb_dim == dim, (emb_dim, dim)
    else:
        # zeros of the corpus dim so lane shapes stay consistent
        q_emb = jnp.zeros((batch, chunk_arrays[0].shape[1]), jnp.float32)
    chunk_q_lex = _densify(q["cb"], q["cv"], chunk_arrays[1].shape[1])
    artifact_q_lex = _densify(q["ab"], q["av"], artifact_arrays[1].shape[1])
    chunks_out = _lanes_one_corpus(
        *chunk_arrays, q_emb, chunk_q_lex, q["tech"],
        q["allowed"], q["dmin"], q["dmax"],
        k_dense=chunk_ks[0], k_lex=chunk_ks[1], k_tech=chunk_ks[2],
        dense_mode=chunk_mode, recall_target=recall_target,
        dense_enabled=dense_enabled,
    )
    artifacts_out = _lanes_one_corpus(
        *artifact_arrays, q_emb, artifact_q_lex, q["tech"],
        q["allowed"], q["dmin"], q["dmax"],
        k_dense=artifact_ks[0], k_lex=artifact_ks[1], k_tech=artifact_ks[2],
        dense_mode=artifact_mode, recall_target=recall_target,
        dense_enabled=dense_enabled,
    )
    if fuse_rrf:
        from .fusion import rrf_fuse_lanes_device

        chunks_merged = rrf_fuse_lanes_device(chunks_out, LANE_ORDER)
        artifacts_merged = rrf_fuse_lanes_device(artifacts_out, LANE_ORDER)
        return _flatten_merged(chunks_merged, artifacts_merged)
    return _flatten_lanes(chunks_out, artifacts_out)
