"""Device-index checkpoint/restore.

The reference's durable search state IS Postgres; ours is device arrays, so
real checkpointing is required (SURVEY.md §5 checkpoint/resume): serialize
both corpora's arrays + id maps + lexical stats to host storage, restore on
start without replaying the ingest log. SQLite remains the source of truth
(ingest.rebuild_index_from_store is the slow-path recovery); a checkpoint
is the fast path for large corpora.

Format v2 (one directory):
- ``meta.json`` — replaced ATOMICALLY (os.replace) as the LAST step; the
  existing checkpoint stays valid until the instant the new one is.
- per corpus: GENERATION-stamped row-range shard files
  ``{name}.g{G:04d}.{i:04d}.npz`` (embeddings in the index storage dtype —
  bf16 stored as its uint16 bit pattern, halving checkpoint size vs the v1
  f32 format — plus lex/tech/ids/call/started/has_emb slices) and
  ``{name}.g{G:04d}.stats.npz`` (doc_freq, dl_sum). A save writes the next
  generation's files alongside the old ones and flips meta last, so a
  crash mid-save (including mid-background-write) never destroys the
  previous complete checkpoint; superseded generations are pruned after
  the flip. Row-range shards cap per-file size (~256 MB of embeddings),
  let restore stream instead of materializing one giant buffer, and give
  each host of a multi-host deployment a byte-range it can fetch
  independently.

``save_index(..., block=False)`` snapshots under the corpus lock (a device
-> host copy) and then writes files on a background thread — serving never
blocks on disk I/O. v1 and generation-less v2 checkpoints restore
transparently.

The IVF dense index is derived state and is NOT checkpointed; when
DENSE_IVF_ENABLED is on, serve startup rebuilds it from the restored
embeddings (serve/api.py:startup, scripts/build_ivf.py).
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..config import settings
from .index import DeviceIndexManager, get_index

FORMAT_VERSION = 2
MULTIHOST_FORMAT_VERSION = 3
ROW_KEYS = ("emb", "lex", "tech", "ids", "call", "started", "has_emb")
# v3 (multi-host) splits rows: heavy device arrays are written by the
# process that owns them; per-row scalars live in leader host mirrors
HEAVY_KEYS = ("emb", "lex", "tech")
SCALAR_KEYS = ("ids", "call", "started", "has_emb")
SHARD_EMB_BYTES = 256 * 1024 * 1024

# One save at a time per target directory: generation is derived by
# re-reading meta.json, so two concurrent saves (e.g. an in-flight
# block=False writer plus a second call) would pick the SAME generation,
# interleave writes on the same filenames, and prune each other's
# in-progress files.
_save_locks: Dict[str, threading.Lock] = {}
_save_locks_guard = threading.Lock()


def _save_lock(path) -> threading.Lock:
    key = str(Path(path).resolve())
    with _save_locks_guard:
        return _save_locks.setdefault(key, threading.Lock())


def _active_vocab():
    from ..ingest import featurize

    return featurize.active_vocab()


def _vocab_digest(vocab) -> str:
    from .vocab import vocab_digest

    return vocab_digest(vocab)


def _encode_emb(emb: np.ndarray) -> Dict[str, np.ndarray]:
    if emb.dtype == np.float32:
        return {"emb": emb, "_kind": np.array(["f32"])}
    if emb.dtype == np.int8:  # INDEX_EMBEDDING_DTYPE=int8 quantized rows
        return {"emb": emb, "_kind": np.array(["i8"])}
    # ml_dtypes.bfloat16 (or any 2-byte float) -> raw bit pattern
    return {"emb": emb.view(np.uint16), "_kind": np.array(["bf16"])}


def _decode_emb(raw: np.ndarray, kind: str, target_dtype) -> np.ndarray:
    """Decode stored rows AND bridge a storage-dtype change across the
    checkpoint boundary (ADVICE r2): int8 rows restored under a float
    INDEX_EMBEDDING_DTYPE must be dequantized (x/127) — a plain cast
    would score them ~127x hot; float rows restored under int8 pass
    through and CorpusIndex._encode_emb quantizes them."""
    if kind == "i8":
        if np.dtype(target_dtype) == np.int8:
            return raw
        return raw.astype(np.float32) / 127.0
    if kind == "f32":
        return raw
    import ml_dtypes

    return raw.view(ml_dtypes.bfloat16)


# ---------------------------------------------------------- v3 multihost ----

def _heavy_layout(corpus) -> list:
    """Global row blocks [(start, rows_live)] of the sharded device
    arrays, trimmed to the live count — every process derives the same
    layout independently, so leader (expected files) and followers
    (their own files) agree without negotiation."""
    import jax

    sharding = corpus.emb.sharding
    idx_map = sharding.devices_indices_map(
        (corpus.capacity, corpus.dim)
    )
    starts = sorted({
        (idx[0].start or 0) for idx in idx_map.values()
    })
    blocks = []
    for i, start in enumerate(starts):
        stop = starts[i + 1] if i + 1 < len(starts) else corpus.capacity
        rows = max(0, min(stop, corpus.count) - start)
        if rows:
            blocks.append((start, rows))
    return blocks


def _heavy_name(corpus_name: str, gen: str, start: int) -> str:
    return f"{corpus_name}.{gen}.r{start:010d}.npz"


def write_local_heavy_shards(
    corpus, path: str, generation: int, count: int
) -> list:
    """Write THIS process's addressable row blocks of the heavy arrays
    (emb/lex/tech), trimmed to ``count``. Called on the leader directly
    and on followers via the op-log 'checkpoint_shards' op. Files land
    atomically (tmp + rename) so the leader can poll for completion.
    Assumes a shared filesystem across the gang (documented in
    OPERATIONS.md)."""
    import os

    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    gen = f"g{generation:04d}"
    by_start: Dict[int, Dict[str, np.ndarray]] = {}
    for name, arr in (("emb", corpus.emb), ("lex", corpus.lex),
                      ("tech", corpus.tech)):
        for shard in arr.addressable_shards:
            start = shard.index[0].start or 0
            rows = max(0, min(
                (shard.index[0].stop or corpus.capacity), count
            ) - start)
            if rows <= 0:
                continue
            by_start.setdefault(start, {})[name] = np.asarray(
                shard.data
            )[:rows]
    written = []
    for start, arrays in sorted(by_start.items()):
        payload = dict(arrays)
        payload.update(_encode_emb(payload.pop("emb")))
        payload["start"] = np.array([start], dtype=np.int64)
        final = out / _heavy_name(corpus.name, gen, start)
        tmp = out / (final.name + f".tmp{os.getpid()}")
        with open(tmp, "wb") as fh:  # np.savez appends .npz to paths
            np.savez(fh, **payload)
        os.replace(tmp, final)
        written.append(final.name)
    return written


def _save_index_multihost(path: str, index, timeout_s: float = 600.0) -> Dict:
    """Leader-side gang save (format v3): every process writes the heavy
    row blocks it owns; the leader writes per-row scalars (ids/call/
    started/has_emb — host mirrors exist only on the leader), lexical
    stats and, LAST, the atomic meta flip. The op-log 'checkpoint_shards'
    mirror inside the corpus lock pins the save to a consistent point in
    the op stream (multi-host SAVE)."""
    import os
    import time as _time

    from ..core import index as index_mod

    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    save_lock = _save_lock(out)
    save_lock.acquire()  # released before every return/raise below
    generation = 0
    meta_path = out / "meta.json"
    if meta_path.exists():
        try:
            generation = int(
                json.loads(meta_path.read_text()).get("generation", 0)
            ) + 1
        except (ValueError, OSError):
            generation = 1
    from ..ops.hashing import TECH_LAYOUT_VERSION

    gen = f"g{generation:04d}"
    # a previous save at this generation may have CRASHED after
    # followers wrote their shard files but before the meta flip (no
    # prune ran, meta still names the prior generation) — the
    # completion poll below checks file EXISTENCE, so stale same-name
    # files would let the leader flip meta while followers are still
    # writing fresh content. Remove them before any follower starts
    # (follower writes are ordered after the leader's op-log emit).
    for stale in out.glob(f"*.{gen}.*"):
        try:
            stale.unlink()
        except OSError:
            pass
    meta: Dict = {
        "format_version": MULTIHOST_FORMAT_VERSION,
        "generation": generation,
        "emb_storage_dtype": str(index.chunks.emb_dtype),
        "tech_layout": TECH_LAYOUT_VERSION,
        "embeddings_dim": int(settings.embeddings_dim),
        "lexical_dim": int(settings.lexical_dim),
        "tech_hash_slots": int(settings.tech_hash_slots),
        "call_capacity": index.call_capacity,
        "counts": {},
        "heavy_files": {},
    }
    vocab, vocab_version = _active_vocab()
    meta["lex_vocab_version"] = vocab_version
    meta["lex_vocab_head"] = int(vocab.size) if vocab is not None else 0
    meta["lex_vocab_sha"] = _vocab_digest(vocab)
    if vocab is not None:
        np.savez(
            out / f"lex_vocab.{gen}.npz",
            hashes=vocab, version=np.array([vocab_version]),
        )
    log = index_mod._oplog
    expected: list = []
    for corpus in (index.chunks, index.artifacts):
        with corpus.lock:
            count = corpus.count
            if log is not None:
                log.emit(
                    "checkpoint_shards",
                    {"path": str(out), "corpus": corpus.name,
                     "generation": generation, "count": int(count)},
                )
            scalars = {
                "ids": corpus.h_ids[:count].copy(),
                "call": corpus.h_call[:count].copy(),
                "started": corpus.h_started[:count].copy(),
                "has_emb": corpus.h_has_emb[:count].copy(),
            }
            stats = (corpus.doc_freq.copy(), int(corpus.dl_sum))
            layout = _heavy_layout(corpus)
            write_local_heavy_shards(corpus, str(out), generation, count)
        np.savez(out / f"{corpus.name}.{gen}.scalars.npz", **scalars)
        np.savez(
            out / f"{corpus.name}.{gen}.stats.npz",
            doc_freq=stats[0], dl_sum=np.array([stats[1]]),
        )
        names = [_heavy_name(corpus.name, gen, s) for s, _ in layout]
        meta["counts"][corpus.name] = count
        meta["heavy_files"][corpus.name] = names
        expected.extend(names)
    deadline = _time.monotonic() + timeout_s
    missing = [n for n in expected if not (out / n).exists()]
    while missing:
        if _time.monotonic() > deadline:
            save_lock.release()
            raise TimeoutError(
                f"multi-host checkpoint: {len(missing)} shard file(s) "
                f"never appeared (shared filesystem required): "
                f"{missing[:4]}"
            )
        _time.sleep(0.1)
        missing = [n for n in expected if not (out / n).exists()]
    tmp = out / f".meta.{generation}.tmp"
    tmp.write_text(json.dumps(meta, indent=2))
    os.replace(tmp, out / "meta.json")
    keep = {f".{gen}."}
    for stale in out.glob("*.npz"):
        if not any(marker in stale.name for marker in keep):
            try:
                stale.unlink()
            except OSError:
                pass
    save_lock.release()
    return meta


def _restore_corpus_v3(
    src: Path, corpus, n_rows: int, heavy_files: list, generation: int
) -> None:
    gen = f"g{generation:04d}"
    with np.load(src / f"{corpus.name}.{gen}.stats.npz") as stats:
        doc_freq = stats["doc_freq"]
        dl_sum = int(stats["dl_sum"][0])
    with np.load(src / f"{corpus.name}.{gen}.scalars.npz") as data:
        scalars = {k: data[k] for k in SCALAR_KEYS}

    def stream():
        off = 0
        for name in sorted(heavy_files):
            with np.load(src / name, allow_pickle=False) as data:
                kind = str(data["_kind"][0])
                start = int(data["start"][0])
                if start != off:
                    raise ValueError(
                        f"{corpus.name}: v3 heavy shards not contiguous "
                        f"(expected row {off}, file starts at {start})"
                    )
                shard = {
                    "emb": _decode_emb(data["emb"], kind, corpus.emb_dtype),
                    "lex": data["lex"],
                    "tech": data["tech"],
                }
            m = shard["lex"].shape[0]
            for k in SCALAR_KEYS:
                shard[k] = scalars[k][off:off + m]
            off += m
            yield shard

    corpus.load_state_streaming(stream(), doc_freq, dl_sum, n_rows)


def save_index(
    path: str,
    index: Optional[DeviceIndexManager] = None,
    block: bool = True,
) -> Dict:
    """Snapshot both corpora. With ``block=False`` the device->host snapshot
    is taken synchronously (consistent view) but file writes happen on a
    daemon thread; the returned meta carries the thread under "_writer"
    (join it to wait, e.g. in tests)."""
    index = index or get_index()
    import jax

    if jax.process_count() > 1:
        # gang save (format v3): per-process heavy shards + leader
        # scalars + leader meta-last; synchronous (the leader polls for
        # follower files before the meta flip)
        return _save_index_multihost(path, index)
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    save_lock = _save_lock(out)
    save_lock.acquire()  # released by write() below
    generation = 0
    meta_path = out / "meta.json"
    if meta_path.exists():
        try:
            generation = int(
                json.loads(meta_path.read_text()).get("generation", 0)
            ) + 1
        except (ValueError, OSError):
            generation = 1
    from ..ops.hashing import TECH_LAYOUT_VERSION

    meta: Dict = {
        "format_version": FORMAT_VERSION,
        "generation": generation,
        # informational (per-shard _kind drives decode): lets operators
        # see a storage-dtype switch across a checkpoint boundary
        "emb_storage_dtype": str(index.chunks.emb_dtype),
        "tech_layout": TECH_LAYOUT_VERSION,
        "embeddings_dim": int(settings.embeddings_dim),
        "lexical_dim": int(settings.lexical_dim),
        "tech_hash_slots": int(settings.tech_hash_slots),
        "call_capacity": index.call_capacity,
        "counts": {},
        "shards": {},
    }
    vocab, vocab_version = _active_vocab()
    meta["lex_vocab_version"] = vocab_version
    meta["lex_vocab_head"] = int(vocab.size) if vocab is not None else 0
    meta["lex_vocab_sha"] = _vocab_digest(vocab)
    snapshots = {}
    try:
        for corpus in (index.chunks, index.artifacts):
            arrays = corpus.state_arrays()  # locked device->host copy
            n = int(arrays["ids"].shape[0])
            # the SNAPSHOT's row count, not corpus.count re-read after
            # the lock released: a concurrent ingest between the two
            # would make meta disagree with the shard rows and fail
            # every restore of this generation
            meta["counts"][corpus.name] = n
            emb_row_bytes = max(arrays["emb"][:1].nbytes, 1) if n else 1
            rows_per_shard = max(1, SHARD_EMB_BYTES // emb_row_bytes)
            n_shards = max(1, -(-n // rows_per_shard)) if n else 1
            meta["shards"][corpus.name] = n_shards
            snapshots[corpus.name] = (arrays, n, rows_per_shard, n_shards)
    except BaseException:
        save_lock.release()  # write() never starts; don't leak the lock
        raise

    def write() -> None:
      try:
        import os

        gen = f"g{generation:04d}"
        if vocab is not None:
            np.savez(
                out / f"lex_vocab.{gen}.npz",
                hashes=vocab, version=np.array([vocab_version]),
            )
        for name, (arrays, n, rows_per_shard, n_shards) in snapshots.items():
            np.savez(
                out / f"{name}.{gen}.stats.npz",
                doc_freq=arrays["doc_freq"], dl_sum=arrays["dl_sum"],
            )
            for i in range(n_shards):
                lo = i * rows_per_shard
                hi = min(n, lo + rows_per_shard)
                shard = {k: arrays[k][lo:hi] for k in ROW_KEYS}
                shard.update(_encode_emb(shard.pop("emb")))
                np.savez(out / f"{name}.{gen}.{i:04d}.npz", **shard)
        tmp = out / f".meta.{generation}.tmp"
        tmp.write_text(json.dumps(meta, indent=2))
        os.replace(tmp, out / "meta.json")  # the atomic validity flip
        # prune superseded generations (and legacy generation-less files)
        keep = {f".{gen}."}
        for stale in out.glob("*.npz"):
            if not any(marker in stale.name for marker in keep):
                try:
                    stale.unlink()
                except OSError:
                    pass
      finally:
        save_lock.release()

    if block:
        write()
        return meta
    writer = threading.Thread(target=write, daemon=True)
    writer.start()
    result = dict(meta)
    result["_writer"] = writer
    return result


def _read_shard(
    src: Path, prefix: str, i: int, target_dtype
) -> Dict[str, np.ndarray]:
    with np.load(src / f"{prefix}.{i:04d}.npz", allow_pickle=False) as data:
        kind = str(data["_kind"][0])
        shard = {k: data[k] for k in ROW_KEYS if k != "emb"}
        shard["emb"] = _decode_emb(data["emb"], kind, target_dtype)
    return shard


def _shard_stream(src: Path, prefix: str, n_shards: int, target_dtype):
    """Yield shards in row order, prefetching the next file on a reader
    thread so disk I/O overlaps the (async) H2D transfer of the previous
    shard (restore streaming). If the consumer
    abandons the generator mid-restore (device error, shard-count
    mismatch), close() signals the reader to stop — without it the
    reader would block forever on q.put and pin up to two decoded
    shards (~512 MB) for the process lifetime (ADVICE r2)."""
    import queue

    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()

    def reader() -> None:
        try:
            for i in range(n_shards):
                item = ("shard", _read_shard(src, prefix, i, target_dtype))
                while not stop.is_set():
                    try:
                        q.put(item, timeout=1.0)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(("done", None))
        except Exception as exc:  # surface on the consumer side
            if not stop.is_set():
                q.put(("error", exc))

    threading.Thread(target=reader, daemon=True).start()
    try:
        while True:
            kind, payload = q.get()
            if kind == "error":
                raise payload
            if kind == "done":
                return
            yield payload
    finally:
        stop.set()


def _restore_corpus_v2(
    src: Path, corpus, n_rows: int, n_shards: int, generation: Optional[int]
) -> None:
    name = corpus.name
    prefix = f"{name}.g{generation:04d}" if generation is not None else name
    with np.load(src / f"{prefix}.stats.npz") as stats:
        doc_freq = stats["doc_freq"]
        dl_sum = int(stats["dl_sum"][0])
    corpus.load_state_streaming(
        _shard_stream(src, prefix, n_shards, corpus.emb_dtype),
        doc_freq, dl_sum, n_rows,
    )


def restore_index(path: str, index: Optional[DeviceIndexManager] = None) -> Dict:
    index = index or get_index()
    src = Path(path)
    meta = json.loads((src / "meta.json").read_text())
    version = meta.get("format_version")
    if version not in (1, FORMAT_VERSION, MULTIHOST_FORMAT_VERSION):
        raise ValueError(
            f"index checkpoint format {version} not in "
            f"(1, {FORMAT_VERSION}, {MULTIHOST_FORMAT_VERSION})"
        )
    for key, expected in (
        ("embeddings_dim", int(settings.embeddings_dim)),
        ("lexical_dim", int(settings.lexical_dim)),
        ("tech_hash_slots", int(settings.tech_hash_slots)),
    ):
        if meta[key] != expected:
            raise ValueError(
                f"checkpoint {key}={meta[key]} does not match settings "
                f"{key}={expected}"
            )
    from ..ops.hashing import TECH_LAYOUT_VERSION

    ckpt_layout = int(meta.get("tech_layout", 1))
    if ckpt_layout != TECH_LAYOUT_VERSION:
        raise ValueError(
            f"checkpoint tech slot layout v{ckpt_layout} != runtime "
            f"v{TECH_LAYOUT_VERSION}: restored tech slots would never "
            "match queries. Rebuild from the store (delete the "
            "checkpoint and restart) or re-snapshot after "
            "scripts/tech_tokens_backfill."
        )
    # The vocab head RIDES WITH the signature rows it produced: activate
    # the checkpoint's vocab (or clear any active one for a pre-vocab
    # checkpoint) so query featurization matches the restored layout.
    # serve startup cross-checks this version against the store's active
    # vocab and refuses a divergence (serve/api.py).
    from ..ingest import featurize as _featurize

    ckpt_vocab_version = int(meta.get("lex_vocab_version", 0))
    if ckpt_vocab_version > 0:
        gen_tag = f"g{int(meta['generation']):04d}"
        with np.load(src / f"lex_vocab.{gen_tag}.npz") as data:
            hashes = data["hashes"].astype(np.uint64)
        expected_sha = meta.get("lex_vocab_sha")
        if expected_sha and _vocab_digest(hashes) != expected_sha:
            raise RuntimeError(
                f"checkpoint lex_vocab.{gen_tag}.npz does not match "
                "meta.json's lex_vocab_sha (mixed checkpoint generations "
                "in one directory?); re-snapshot"
            )
        _featurize.set_active_vocab(hashes, ckpt_vocab_version)
    else:
        _featurize.set_active_vocab(None, 0)
    generation = meta.get("generation")  # None = generation-less v2
    for corpus in (index.chunks, index.artifacts):
        if version == MULTIHOST_FORMAT_VERSION:
            _restore_corpus_v3(
                src, corpus, int(meta["counts"][corpus.name]),
                list(meta["heavy_files"][corpus.name]), int(generation),
            )
            continue
        if version == 1:
            with np.load(src / f"{corpus.name}.npz") as data:
                arrays = {k: data[k] for k in data.files}
            if (arrays["emb"].dtype == np.int8
                    and np.dtype(corpus.emb_dtype) != np.int8):
                arrays["emb"] = arrays["emb"].astype(np.float32) / 127.0
            corpus.load_state(arrays)
        else:
            _restore_corpus_v2(
                src, corpus, int(meta["counts"][corpus.name]),
                int(meta["shards"][corpus.name]),
                int(generation) if generation is not None else None,
            )
    index.ensure_call_capacity(int(meta["call_capacity"]))
    return meta
