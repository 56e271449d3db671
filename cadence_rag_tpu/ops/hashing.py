"""Feature hashing for the lexical and tech-token lanes.

The reference's lexical lane is pg_search BM25 over an ngram(3,3) tokenizer
(reference: alembic/versions/0005:17-37) and its exact-token lane is a GIN
array-overlap over extracted tech tokens (reference: app/retrieve.py:183-242).
On the device both become fixed-width hashed representations:

- lexical: signed feature hashing of word tokens + char trigrams into
  ``D`` buckets (signed hashing decorrelates collisions, Weinberger et al.),
  BM25 term weights folded in at ingest so query scoring is an int8 matmul.
- tech tokens: one 64-bit FNV-1a hash per token, reduced to a positive int32
  slot value (0 is the empty sentinel).

The hash (FNV-1a 64) and the feature extraction rules here are the canonical
contract; the optional C++ featurizer (native/lexhash.cpp) must match them
bit-for-bit and is verified by tests.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1

_WORD_RE = re.compile(r"[a-z0-9_]+")
_WS_RE = re.compile(r"\s+")

# BM25 parameters (Robertson/Sparck-Jones defaults, matching pg_search's
# tantivy scorer family).
BM25_K1 = 1.2
BM25_B = 0.75
# Term weights tf*(k1+1)/(tf+k1*norm) are bounded by k1+1=2.2; bucket sums of
# colliding terms can exceed it, so quantize with headroom.
LEX_QUANT_SCALE = 127.0 / 4.0


def fnv1a64(data: bytes) -> int:
    h = FNV_OFFSET
    for byte in data:
        h ^= byte
        h = (h * FNV_PRIME) & _MASK64
    return h


def normalize_text(text: str) -> str:
    return _WS_RE.sub(" ", text.lower()).strip()


def lexical_features(text: str) -> Dict[int, int]:
    """Map text -> {feature_hash64: term_frequency}.

    Features are word tokens (prefix ``w:``) and char trigrams of the
    normalized text (prefix ``g:``), mirroring the reference's "token +
    ngram(3,3) alias field" dual indexing (alembic 0005).
    """
    norm = normalize_text(text)
    counts: Dict[int, int] = {}
    for word in _WORD_RE.findall(norm):
        h = fnv1a64(b"w:" + word.encode("utf-8"))
        counts[h] = counts.get(h, 0) + 1
    data = norm.encode("utf-8")
    for i in range(len(data) - 2):
        h = fnv1a64(b"g:" + data[i : i + 3])
        counts[h] = counts.get(h, 0) + 1
    return counts


def bucket_and_sign(h: int, dim: int) -> Tuple[int, int]:
    """Bucket uses the low hash bits; sign a decoupled high bit."""
    bucket = h % dim
    sign = 1 if (h >> 33) & 1 else -1
    return bucket, sign


# ------------------------------------------------------ vocab-head layout ----
#
# Hashed signatures lose top-k fidelity to bucket collisions — measured
# top-10 overlap vs collision-free feature-BM25 is ~0.87 at D=4096
# (evals/lexical_fidelity.py). Most of that loss is collisions *between
# frequent features*, which carry the bulk of the score mass. The vocab
# head removes them: the T most document-frequent features (learned from
# the corpus, core/vocab.py) get DEDICATED buckets [0, T) — collision-free
# by construction, so their bucket-granularity df is exact per-feature df —
# and everything else hashes into the remaining [T, dim) tail. Measured:
# overlap 0.87 -> 0.96 at D=4096 with T=2048 on the fidelity harness.
#
# The head mapping is a sorted uint64 hash array; bucket(h) = its rank
# (searchsorted index). Signs are +1 in the head (no collisions to
# decorrelate) and the usual decoupled hash bit in the tail.

def apply_vocab(
    hashes: np.ndarray, dim: int, vocab: Optional[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized feature-hash -> (bucket int64, sign f32) placement under
    an optional vocab head. ``vocab`` is a SORTED uint64 array (or None
    for the plain single-hash layout)."""
    hashes = np.asarray(hashes, dtype=np.uint64)
    if vocab is None or vocab.size == 0:
        buckets = (hashes % np.uint64(dim)).astype(np.int64)
        signs = np.where(
            (hashes >> np.uint64(33)) & np.uint64(1), 1.0, -1.0
        ).astype(np.float32)
        return buckets, signs
    head = int(vocab.size)
    tail = dim - head
    if tail < 1:
        raise ValueError(f"vocab head {head} leaves no tail buckets of {dim}")
    idx = np.searchsorted(vocab, hashes)
    idx_c = np.minimum(idx, head - 1)
    in_head = vocab[idx_c] == hashes
    buckets = np.where(
        in_head,
        idx_c.astype(np.int64),
        np.int64(head) + (hashes % np.uint64(tail)).astype(np.int64),
    )
    signs = np.where(
        in_head,
        np.float32(1.0),
        np.where((hashes >> np.uint64(33)) & np.uint64(1), 1.0, -1.0),
    ).astype(np.float32)
    return buckets, signs


def raw_feature_arrays(text: str) -> Tuple[np.ndarray, np.ndarray]:
    """(fnv1a64 hashes uint64, tfs f32) in first-occurrence order — the
    pure-Python mirror of native/lexhash.raw_features."""
    counts = lexical_features(text)
    if not counts:
        return (np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.float32))
    hashes = np.fromiter(counts.keys(), dtype=np.uint64, count=len(counts))
    tfs = np.fromiter(counts.values(), dtype=np.float32, count=len(counts))
    return hashes, tfs


def doc_signature_from_raw(
    hashes: np.ndarray, tfs: np.ndarray, dim: int, avgdl: float,
    vocab: Optional[np.ndarray],
    k1: float = BM25_K1, b: float = BM25_B,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """doc_signature over pre-extracted raw features (native or Python),
    with optional vocab-head placement. The weighting/quantization math is
    identical to doc_signature; both host featurizers produce raw features
    in first-occurrence order, so the accumulation is deterministic."""
    dl = int(tfs.sum())
    norm = 1.0 - b + b * (dl / max(avgdl, 1.0))
    acc = np.zeros(dim, dtype=np.float32)
    if hashes.size:
        buckets, signs = apply_vocab(hashes, dim, vocab)
        tfs = tfs.astype(np.float64)
        w = (signs.astype(np.float64)
             * (tfs * (k1 + 1.0)) / (tfs + k1 * norm)).astype(np.float32)
        np.add.at(acc, buckets, w)
    quant = np.clip(np.rint(acc * LEX_QUANT_SCALE), -127, 127).astype(np.int8)
    touched = np.flatnonzero(acc).astype(np.int32)
    return quant, touched, dl


def query_feature_arrays_from_raw(
    hashes: np.ndarray, tfs: np.ndarray, dim: int,
    vocab: Optional[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(buckets, signs, clipped tfs) from raw features under an optional
    vocab head — mirrors query_feature_arrays."""
    if hashes.size == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty.astype(np.float32), empty.astype(np.float32)
    buckets, signs = apply_vocab(hashes, dim, vocab)
    return buckets, signs, np.minimum(tfs.astype(np.float32), 3.0)


def doc_signature(
    text: str, dim: int, avgdl: float, k1: float = BM25_K1, b: float = BM25_B
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Build one document's quantized BM25 signature row.

    Returns ``(weights_int8[dim], touched_buckets[int32], doc_len)``.
    BM25's per-term document factor tf*(k1+1)/(tf + k1*(1-b+b*dl/avgdl)) is
    folded in here; the query side contributes idf (see query_vector), so
    score(q, d) = q . w_d is BM25 over hashed buckets.
    """
    counts = lexical_features(text)
    dl = sum(counts.values())
    norm = 1.0 - b + b * (dl / max(avgdl, 1.0))
    acc = np.zeros(dim, dtype=np.float32)
    for h, tf in counts.items():
        bucket, sign = bucket_and_sign(h, dim)
        acc[bucket] += sign * (tf * (k1 + 1.0)) / (tf + k1 * norm)
    quant = np.clip(np.rint(acc * LEX_QUANT_SCALE), -127, 127).astype(np.int8)
    touched = np.flatnonzero(acc).astype(np.int32)
    return quant, touched, dl


def query_feature_arrays(text: str, dim: int):
    """Hash a query once into vectorized (buckets, signs, clipped tfs) —
    reusable across corpora (each corpus applies its own idf)."""
    counts = lexical_features(text)
    if not counts:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty.astype(np.float32), empty.astype(np.float32)
    hashes = np.fromiter(counts.keys(), dtype=np.uint64, count=len(counts))
    tfs = np.fromiter(counts.values(), dtype=np.float32, count=len(counts))
    buckets = (hashes % np.uint64(dim)).astype(np.int64)
    signs = np.where((hashes >> np.uint64(33)) & np.uint64(1), 1.0, -1.0).astype(
        np.float32
    )
    return buckets, signs, np.minimum(tfs, 3.0)


def query_vector_from_features(
    buckets: np.ndarray, signs: np.ndarray, tfs: np.ndarray,
    dim: int, doc_freq: np.ndarray, n_docs: int,
) -> np.ndarray:
    q = np.zeros(dim, dtype=np.float32)
    if buckets.size == 0 or n_docs <= 0:
        return q
    df = doc_freq[buckets].astype(np.float32)
    idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    np.add.at(q, buckets, signs * idf * tfs)
    return q / LEX_QUANT_SCALE


def query_vector(
    text: str, dim: int, doc_freq: np.ndarray, n_docs: int
) -> np.ndarray:
    """Build the idf-weighted signed query vector (float32[dim]).

    idf uses bucket-granularity document frequencies maintained by the index
    (an upper bound on true per-term df; collisions only dampen weights).
    """
    buckets, signs, tfs = query_feature_arrays(text, dim)
    return query_vector_from_features(buckets, signs, tfs, dim, doc_freq, n_docs)


@functools.lru_cache(maxsize=65536)
def _tech_hash(key: str) -> int:
    # Pure/deterministic, so memoizable: identifiers repeat heavily across
    # queries and documents, and the per-byte Python FNV loop is the cost.
    return (fnv1a64(b"t:" + key.encode("utf-8")) % 0x7FFFFFFE) + 1


def tech_slot_choices(h: int, slots: int) -> Tuple[int, int]:
    """The two candidate slots for a token hash (2-choice placement):
    low bits and decoupled higher bits."""
    return h % slots, (h >> 8) % slots


def tech_token_hashes(tokens: Sequence[str], slots: int) -> np.ndarray:
    """Hash tech tokens into SLOT-ADDRESSED positive int32 values
    (0 = empty sentinel): token h lives at slot h%S, or (h>>8)%S if
    taken (2-choice; both taken -> dropped, rare at <=8 tokens over 16
    slots). Slot addressing is what lets the device compare check TWO
    positions per query token instead of all S (B*N*S compares instead
    of B*N*Q*S).

    Matching is case-insensitive, like the reference's normalization of
    extracted tokens (reference: app/ingest.py:150-160).

    TECH LAYOUT VERSION 2 — checkpoints record it; restoring a layout-1
    checkpoint must re-featurize (tech_tokens_backfill) instead of
    silently never matching.
    """
    out = np.zeros(slots, dtype=np.int32)
    seen = set()
    for token in tokens:
        key = token.strip().lower()
        if not key or key in seen:
            continue
        seen.add(key)
        h = _tech_hash(key)
        s1, s2 = tech_slot_choices(h, slots)
        if out[s1] == 0:
            out[s1] = np.int32(h)
        elif out[s2] == 0:
            out[s2] = np.int32(h)
        # else dropped (both choices occupied)
    return out


TECH_LAYOUT_VERSION = 2


def tech_query_structure_from_hashes(
    hashes: Sequence[int], slots: int, capacity: int = 2,
) -> np.ndarray:
    """Slot structure straight from hash values (tests/synthetic data)."""
    out = np.zeros(slots * capacity, dtype=np.int32)
    for h in hashes:
        for s in set(tech_slot_choices(int(h), slots)):
            for c in range(capacity):
                pos = c * slots + s
                if out[pos] == 0 or out[pos] == np.int32(h):
                    out[pos] = np.int32(h)
                    break
    return out


def tech_query_structure(
    tokens: Sequence[str], slots: int, capacity: int,
    max_capacity: int = 0,
) -> Tuple[np.ndarray, int]:
    """Query-side slot structure: (slots*capacity,) int32 laid out as
    ``capacity`` blocks of ``slots`` columns — block c, column s holds
    the c-th query hash that could live in doc slot s. A token must
    occupy BOTH its choice slots (the doc stored it in one of them), so
    a token missing EITHER column counts as dropped.

    If tokens drop at ``capacity`` and ``max_capacity`` allows, the
    structure escalates (capacity doubles, one extra jit variant — zero
    blocks never match, so narrower structures zero-pad into wider
    programs). Returns (structure, dropped); any residual drop is
    surfaced in debug payloads — the old fixed-Q layout silently
    truncated at 8 tokens)."""
    if max_capacity <= 0:
        max_capacity = capacity * 2
    # Hash/dedupe once (placement retries only re-run the slot loop).
    # Plain Python ints/lists throughout: per-element numpy scalar boxing
    # made this ~85 us per query on the 1-core serving host (profiled);
    # the list version is ~15 us for typical 1-3 token queries.
    seen = set()
    entries = []  # (h, s1, s2); s1 == s2 collapses to one placement
    for token in tokens:
        key = token.strip().lower()
        if not key or key in seen:
            continue
        seen.add(key)
        h = _tech_hash(key)
        s1, s2 = tech_slot_choices(h, slots)
        entries.append((h, s1, s2))
    while True:
        out = [0] * (slots * capacity)
        dropped = 0
        for h, s1, s2 in entries:
            fully_placed = True
            # placements into distinct columns are independent, so the
            # visit order of (s1, s2) cannot change the result
            for s in ((s1,) if s1 == s2 else (s1, s2)):
                ok = False
                for c in range(capacity):
                    pos = c * slots + s
                    v = out[pos]
                    if v == 0 or v == h:
                        out[pos] = h
                        ok = True
                        break
                fully_placed = fully_placed and ok
            if not fully_placed:
                dropped += 1
        if dropped == 0 or capacity * 2 > max_capacity:
            return np.array(out, dtype=np.int32), dropped
        capacity *= 2
