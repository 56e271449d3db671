"""Document featurization: text -> device-index row features.

Bridges host text to the device representation (lexical signature, tech
hash slots). Dispatches to the native C++ featurizer (native/lexhash.cpp)
when built, falling back to the pure-Python reference implementation in
ops/hashing.py — both produce bit-identical features (tested).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..config import settings
from ..ops import hashing
from ..utils.locks import RWLock

# Vocab-layout gate: ingest/delete paths hold the READ side across
# featurize -> store write -> device insert; an online vocab rebuild
# (core/vocab.build_and_apply) holds the WRITE side for the activate +
# re-featurize window, so no document can land half in the old layout
# and half unscanned by the re-featurize pass. Uncontended read
# acquisition is two condvar ops (~1 us) per ingest call.
vocab_gate = RWLock()


def _native():
    try:
        from ..native import lexhash  # noqa: PLC0415

        return lexhash if lexhash.available() else None
    except Exception:
        return None


# Active lexical vocab head (ops/hashing.apply_vocab): the T most
# document-frequent features get dedicated collision-free buckets [0, T).
# Learned per store by `python -m cadence_rag_tpu.scripts.build_lex_vocab`
# (core/vocab.py) and activated at startup/restore; None = plain
# single-hash layout (the default, bit-compatible with old checkpoints).
# Every featurizer in the process must agree with the layout the device
# signatures were built with, hence one module-level registry.
_ACTIVE_VOCAB: Optional[np.ndarray] = None
_ACTIVE_VOCAB_VERSION: int = 0


def set_active_vocab(vocab: Optional[np.ndarray], version: int) -> None:
    global _ACTIVE_VOCAB, _ACTIVE_VOCAB_VERSION
    if vocab is not None:
        vocab = np.asarray(vocab, dtype=np.uint64)
        if vocab.size > 1 and not np.all(vocab[1:] > vocab[:-1]):
            vocab = np.unique(vocab)
        if vocab.size >= int(settings.lexical_dim):
            raise ValueError(
                f"lex vocab head {vocab.size} must be smaller than "
                f"lexical_dim {settings.lexical_dim}"
            )
    _ACTIVE_VOCAB = vocab if (vocab is not None and vocab.size) else None
    _ACTIVE_VOCAB_VERSION = int(version) if _ACTIVE_VOCAB is not None else 0


def active_vocab() -> Tuple[Optional[np.ndarray], int]:
    return _ACTIVE_VOCAB, _ACTIVE_VOCAB_VERSION


def lexical_signature(
    text: str, avgdl: float
) -> Tuple[np.ndarray, np.ndarray, int]:
    """-> (int8 signature[lexical_dim], touched buckets, doc length)."""
    dim = int(settings.lexical_dim)
    native = _native()
    if _ACTIVE_VOCAB is not None:
        # native raw features + the vectorized numpy vocab placement:
        # both host paths share ops/hashing.doc_signature_from_raw, so
        # native/Python parity holds by construction
        raw = (native.raw_features(text) if native is not None
               else hashing.raw_feature_arrays(text))
        return hashing.doc_signature_from_raw(
            raw[0], raw[1], dim, avgdl, _ACTIVE_VOCAB
        )
    if native is not None:
        return native.doc_signature(text, dim, avgdl)
    return hashing.doc_signature(text, dim, avgdl)


def lexical_signatures_batch(texts: Sequence[str], avgdl: float):
    """Batch doc signatures in ONE native raw-features crossing (vocab
    re-featurize, scripts/build_lex_vocab.py). Honors the active vocab;
    bit-identical to per-text lexical_signature."""
    dim = int(settings.lexical_dim)
    raws = raw_lexical_features_batch(texts)
    return [
        hashing.doc_signature_from_raw(h, t, dim, avgdl, _ACTIVE_VOCAB)
        for h, t in raws
    ]


def raw_lexical_features_batch(texts: Sequence[str]):
    """Per-text (uint64 hashes, f32 tfs) raw features, native when built."""
    native = _native()
    if native is not None:
        return native.raw_features_batch(list(texts))
    return [hashing.raw_feature_arrays(t) for t in texts]


def query_lexical_vector(
    text: str, doc_freq: np.ndarray, n_docs: int
) -> np.ndarray:
    feats = query_lexical_features(text)
    return hashing.query_vector_from_features(
        feats[0], feats[1], feats[2], int(settings.lexical_dim),
        doc_freq, n_docs,
    )


def query_lexical_features(text: str):
    """Hash once; reuse across corpora via query_lexical_vector_from.
    Native path: ~15 ms/64-query batch of pure-Python FNV loops (profiled
    on the 1-core serving host) drops to microseconds in C++."""
    dim = int(settings.lexical_dim)
    native = _native()
    if _ACTIVE_VOCAB is not None:
        raw = (native.raw_features(text) if native is not None
               else hashing.raw_feature_arrays(text))
        return hashing.query_feature_arrays_from_raw(
            raw[0], raw[1], dim, _ACTIVE_VOCAB
        )
    if native is not None:
        return native.query_features(text, dim)
    return hashing.query_feature_arrays(text, dim)


def query_lexical_features_batch(texts):
    """Per-text feature triples for a request batch in ONE native call
    (native/lexhash.query_features_batch); falls back to per-text
    hashing when the native featurizer is unavailable."""
    dim = int(settings.lexical_dim)
    native = _native()
    if _ACTIVE_VOCAB is not None:
        if native is not None:
            raws = native.raw_features_batch(texts)
        else:
            raws = [hashing.raw_feature_arrays(t) for t in texts]
        return [
            hashing.query_feature_arrays_from_raw(h, t, dim, _ACTIVE_VOCAB)
            for h, t in raws
        ]
    if native is not None:
        return native.query_features_batch(texts, dim)
    return [hashing.query_feature_arrays(text, dim) for text in texts]


def query_lexical_vector_from(
    feats, doc_freq: np.ndarray, n_docs: int
) -> np.ndarray:
    buckets, signs, tfs = feats
    return hashing.query_vector_from_features(
        buckets, signs, tfs, int(settings.lexical_dim), doc_freq, n_docs
    )


def tech_slots(tokens: Sequence[str]) -> np.ndarray:
    return hashing.tech_token_hashes(tokens, int(settings.tech_hash_slots))


def query_tech_hashes(
    tokens: Sequence[str], max_q: Optional[int] = None
) -> np.ndarray:
    """Query-side SLOT-ADDRESSED structure, (S*C,) int32 (see
    ops/hashing.tech_query_structure). The compare costs C slot-aligned
    passes instead of one (B,N,Q,S) broadcast, and the query token budget
    is ~S*C (32 at defaults) instead of a silent cap of 8; any
    overflow is counted and surfaced in debug payloads."""
    structure, _ = query_tech_structure(tokens)
    return structure


def query_tech_structure(
    tokens: Sequence[str],
) -> tuple:
    """(structure (S*C,) int32, dropped_count); C escalates (one doubling)
    for identifier-heavy queries — batches pad narrower structures with
    zero blocks, which never match."""
    cap = int(settings.tech_slot_capacity)
    return hashing.tech_query_structure(
        tokens, int(settings.tech_hash_slots), cap,
        max_capacity=max(8, 4 * cap),
    )


def query_tech_structures_batch(token_lists: Sequence[Sequence[str]]):
    """Per-query tech slot structures for a whole batch — one native
    crossing when built (native/lexhash.tech_structures_batch), identical
    per query to :func:`query_tech_structure` (parity-tested)."""
    slots = int(settings.tech_hash_slots)
    cap = int(settings.tech_slot_capacity)
    max_cap = max(8, 4 * cap)
    native = _native()
    if native is not None:
        try:
            return native.tech_structures_batch(
                token_lists, slots, cap, max_cap
            )
        except (RuntimeError, AttributeError):
            pass
    return [
        hashing.tech_query_structure(t, slots, cap, max_capacity=max_cap)
        for t in token_lists
    ]
