"""HBM-resident retrieval index.

The reference's search state lives in Postgres tables + native extension
indexes (HNSW graph, BM25 postings, GIN arrays). Here it is six device
arrays per corpus (embeddings, int8 lexical signatures, tech-token hash
slots, call index, start seconds, embedding-presence flags) plus an
optional IVF cluster index, capacity-padded so shapes stay static under
jit (and, when MESH_SHAPE is set, row-sharded over the device mesh):

- inserts are donated ``dynamic_update_slice`` calls (in-place buffer reuse,
  no O(capacity) copies); insert batches are padded to power-of-two sizes so
  the number of compiled insert variants is logarithmic;
- growth doubles capacity (re-jit once per doubling, amortized O(log N));
- queries run the fused multi-lane program (ops/fused.py).

Incremental ingest vs static shapes is the central tension called out in
SURVEY.md §7 "hard parts"; this module is the answer.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import settings
from ..logging_utils import get_logger
from ..ops.fused import dual_corpus_retrieve, multi_lane_retrieve
from ..ops.ivf import build_buckets, ivf_topk, kmeans
from ..ops.masks import filter_mask
from ..utils import events

logger = get_logger(__name__)

INT32_MIN = np.int32(-2147483648)
INT32_MAX = np.int32(2147483647)

# Multi-host serving (parallel/oplog.py): when the mesh spans OS
# processes, every device-touching op below is mirrored to follower
# processes so the gang enqueues identical XLA programs. set_oplog is
# called on the LEADER only; followers replay via oplog._apply.
_oplog = None


def set_oplog(log) -> None:
    global _oplog
    _oplog = log


# sentinel: the multi-process path already ran the dispatch
_MULTIPROCESS_DISPATCHED = object()


def _multiprocess() -> bool:
    """True when the device mesh spans OS processes — host->device inputs
    must then stay uncommitted numpy (jit stages them replicated on every
    process; a committed process-local jnp.asarray poisons the global
    dispatch), and leader-read outputs need replicated out_shardings."""
    return jax.process_count() > 1


def _stage(arr, dtype=None):
    """Host->device staging for jit inputs: eager transfer single-process
    (overlaps the H2D copy with other host work), raw numpy when the
    mesh spans processes (see _multiprocess). Transfers stay asynchronous:
    serializing them behind a lock + block_until_ready makes every insert
    slab wait on its copies in turn."""
    if _multiprocess():
        return np.asarray(arr, dtype=dtype) if dtype is not None else arr
    return (jnp.asarray(arr, dtype=dtype) if dtype is not None
            else jnp.asarray(arr))


@dataclasses.dataclass
class DocRow:
    doc_id: int
    call_seq: int
    started_sec: int
    lex_sig: np.ndarray            # (lex_dim,) int8
    lex_dl: int
    lex_touched: np.ndarray        # (t,) int32 buckets, for df updates
    tech: np.ndarray               # (tech_slots,) int32
    embedding: Optional[np.ndarray]  # (dim,) f32 unit vector or None


@dataclasses.dataclass
class IvfState:
    """Probed-cluster dense index (ops/ivf.py) over the rows present at
    build time; rows inserted later live in the exact-scanned overflow tail
    until the next build (freshness contract: no row is ever invisible)."""

    centroids: jax.Array        # (C, dim) f32
    buckets: jax.Array          # (C, cap) int32
    overflow: jax.Array         # (Vcap,) int32, -1 padded
    overflow_count: int
    built_count: int
    n_clusters: int
    nprobe: int


@partial(jax.jit, static_argnames=("k", "nprobe"))
def _ivf_dense_query(
    emb, call_idx, started, has_emb, centroids, buckets, overflow,
    q_emb, allowed, date_min, date_max, *, k: int, nprobe: int,
):
    mask = filter_mask(call_idx, started, allowed, date_min, date_max)
    mask = mask & has_emb[None, :]
    return ivf_topk(
        q_emb, emb, centroids, buckets, overflow, mask, k=k, nprobe=nprobe
    )


@partial(jax.jit, donate_argnums=(0,))
def _write_slab(buf: jax.Array, slab: jax.Array, start) -> jax.Array:
    start_idx = (start,) + (0,) * (buf.ndim - 1)
    return jax.lax.dynamic_update_slice(buf, slab, start_idx)


@partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4, 5))
def _write_all_slabs(
    emb, lex, tech, call_idx, started, has_emb,
    emb_slab, lex_slab, tech_slab, call_slab, started_slab, has_slab,
    start,
):
    """All six buffers updated in ONE device program — host->device dispatch
    latency dominates incremental ingest, so one call instead of six."""
    def upd(buf, slab):
        start_idx = (start,) + (0,) * (buf.ndim - 1)
        return jax.lax.dynamic_update_slice(buf, slab, start_idx)

    return (
        upd(emb, emb_slab), upd(lex, lex_slab), upd(tech, tech_slab),
        upd(call_idx, call_slab), upd(started, started_slab),
        upd(has_emb, has_slab),
    )


@partial(jax.jit, donate_argnums=(0,))
def _scatter_rows(buf: jax.Array, pos: jax.Array, rows: jax.Array) -> jax.Array:
    return buf.at[pos].set(rows)


@partial(jax.jit, donate_argnums=(0, 1))
def _scatter_emb_and_flags(emb, has_emb, pos, rows, flags):
    return emb.at[pos].set(rows), has_emb.at[pos].set(flags)


@partial(jax.jit, donate_argnums=(0, 1))
def _tombstone_rows(started, has_emb, pos):
    """Invalidate rows in ONE device program: started=INT32_MIN removes
    them from every lane's filter mask (ops/masks.py treats it as the
    invalid sentinel); has_emb=False removes them from the dense lane."""
    return (
        started.at[pos].set(jnp.int32(INT32_MIN)),
        has_emb.at[pos].set(False),
    )


@partial(jax.jit, static_argnames=("out_rows",))
def _gather_live(emb, lex, tech, call_idx, started, has_emb, live_pos,
                 valid_rows, *, out_rows: int):
    """Compaction gather: pack live rows to the front. Rows past
    ``valid_rows`` (the pow2 padding duplicated live row 0) are stamped
    invalid ON DEVICE so the whole compaction is one mirrorable device
    program — no host read-back, which is what lets multi-host gangs
    compact in lockstep (the round-2 stand-down)."""
    take = live_pos[:out_rows]
    idx = jnp.arange(out_rows, dtype=jnp.int32)
    started_g = jnp.where(
        idx < valid_rows, started[take], jnp.int32(INT32_MIN)
    )
    has_g = jnp.where(idx < valid_rows, has_emb[take], False)
    return (
        emb[take], lex[take], tech[take],
        call_idx[take], started_g, has_g,
    )


def _pad_rows(arr: np.ndarray, padded: int) -> np.ndarray:
    if arr.shape[0] == padded:
        return arr
    pad = np.zeros((padded - arr.shape[0],) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


from .coldtier import _next_pow2  # canonical pow2 rounding, one definition


def _clamp_ks(ks: Tuple[int, int, int], cap: int) -> Tuple[int, int, int]:
    return tuple(min(k, cap) for k in ks)  # type: ignore[return-value]


class GrowthMigration:
    """Background capacity growth with an atomic swap.

    The synchronous ``_grow_to`` holds the corpus lock for alloc + six
    slab copies (mostly fresh-shape compiles when cold), during which
    every query waits. The
    reference never blocks reads while an index grows (Postgres MVCC),
    so neither do we: once the prewarmer has the next capacity's query
    program warm it starts one of these — a daemon thread that

    1. allocates the target buffers OFF the serving path (the
       fresh-shape alloc/copy compiles land here),
    2. enqueues whole-buffer copies of the live arrays (reads are
       device-FIFO-ordered before any later donating mutation; a
       mutation that donated the source handle before our enqueue
       surfaces as a deleted-array error and the copy retries with the
       fresh handle),
    3. replays the mutation journal — every device mutation since the
       migration started, recorded at the existing mutation sites under
       the corpus lock — onto the new buffers until the swap.

    ``ensure_capacity`` then swaps pointers under the lock in
    milliseconds (drain-the-tail + six handle assignments). All journal
    ops are idempotent row writes (slab DUS, scatters, tombstones), so
    copy/replay interleavings converge. Compaction and restore renumber
    rows and CANCEL the migration. Single-process only — multi-process
    gangs replay 'grow' synchronously over the op-log."""

    def __init__(self, corpus: "CorpusIndex", new_cap: int,
                 warmup=None):
        self.corpus = corpus
        self.new_cap = int(new_cap)
        self.journal: "deque" = deque()
        self.ready = threading.Event()
        self.cancelled = False
        self.swapped = False
        self._apply_lock = threading.Lock()
        self.bufs: Optional[Tuple[jax.Array, ...]] = None
        # best-effort: run the prewarmed query executable once over the
        # new buffers BEFORE the swap — the first execution of a freshly
        # compiled executable pays its load onto the device; paying it
        # here keeps it off the serving thread
        self.warmup = warmup
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"growth-migrate-{corpus.name}",
        )

    def start(self) -> None:
        self._thread.start()

    def cancel(self) -> None:
        self.cancelled = True

    # -- journal (called under corpus.lock at each mutation site) -------
    def journal_op(self, op: str, arrays: Tuple) -> None:
        if not self.cancelled:
            self.journal.append((op, arrays))

    # -- background thread ----------------------------------------------
    def _run(self) -> None:
        c = self.corpus
        try:
            with events.timed("index.migration_alloc", corpus=c.name,
                              cap=self.new_cap):
                bufs = c._alloc_arrays(self.new_cap)
            with events.timed("index.migration_copy", corpus=c.name):
                bufs = self._bulk_copy(bufs)
            if bufs is None:
                return
            self.bufs = bufs
            if self.warmup is not None:
                try:
                    with events.timed("index.migration_warmup",
                                      corpus=c.name):
                        self.warmup(bufs)
                except Exception:  # pragma: no cover - best effort
                    logger.exception(
                        "index.migration_warmup_failed corpus=%s", c.name
                    )
            self.ready.set()
            events.record("index.migration_ready", corpus=c.name,
                          cap=self.new_cap)
            while not self.cancelled and not self.swapped:
                applied = self._apply_some(limit=32)
                if not applied:
                    time.sleep(0.02)
        except Exception:  # pragma: no cover - logged, growth falls back
            logger.exception("index.migration_failed corpus=%s", c.name)
            self.cancelled = True

    def _bulk_copy(self, bufs):
        """Copy each live array into its target buffer; retry per array
        when a concurrent donating mutation deleted the source handle
        between snapshot and enqueue."""
        c = self.corpus
        names = ("emb", "lex", "tech", "call_idx", "started", "has_emb")
        out = list(bufs)
        for i, name in enumerate(names):
            for _ in range(64):
                if self.cancelled:
                    return None
                src = getattr(c, name)
                try:
                    out[i] = _write_slab(out[i], src, 0)
                    break
                except RuntimeError as exc:
                    if "delete" not in str(exc).lower():
                        raise
            else:
                raise RuntimeError(
                    f"{c.name}: migration copy of {name} kept losing its "
                    "source to donating mutations"
                )
        return tuple(out)

    def _apply_some(self, limit: int) -> int:
        n = 0
        with self._apply_lock:
            while self.journal and n < limit and not self.swapped:
                op, arrays = self.journal.popleft()
                self._apply(op, arrays)
                n += 1
        return n

    def _apply(self, op: str, arrays: Tuple) -> None:
        emb, lex, tech, call_idx, started, has_emb = self.bufs
        if op == "write_slabs":
            emb_p, lex_p, tech_p, call_p, started_p, has_p, start = arrays
            (emb, lex, tech, call_idx, started, has_emb) = _write_all_slabs(
                emb, lex, tech, call_idx, started, has_emb,
                _stage(emb_p), _stage(lex_p), _stage(tech_p),
                _stage(call_p), _stage(started_p), _stage(has_p), start,
            )
        elif op == "scatter_emb":
            pos, vals, flags = arrays
            emb, has_emb = _scatter_emb_and_flags(
                emb, has_emb, _stage(pos), _stage(vals), _stage(flags)
            )
        elif op == "scatter_tech":
            pos, vals = arrays
            tech = _scatter_rows(tech, _stage(pos), _stage(vals))
        elif op == "scatter_lex":
            pos, vals = arrays
            lex = _scatter_rows(lex, _stage(pos), _stage(vals))
        elif op == "tombstone":
            (pos,) = arrays
            started, has_emb = _tombstone_rows(
                started, has_emb, _stage(pos)
            )
        else:  # pragma: no cover - journal sites are fixed
            raise ValueError(f"unknown migration op {op!r}")
        self.bufs = (emb, lex, tech, call_idx, started, has_emb)

    # -- swap (called under corpus.lock) ---------------------------------
    def finalize(self) -> Tuple[jax.Array, ...]:
        """Drain the journal tail and hand over the buffers. The caller
        holds the corpus lock, so no new journal entries can appear."""
        with self._apply_lock:
            self.swapped = True
            while self.journal:
                op, arrays = self.journal.popleft()
                self._apply(op, arrays)
            return self.bufs


class CorpusIndex:
    """One document class (chunks or artifact_chunks) on device."""

    def __init__(
        self,
        name: str,
        *,
        dim: int,
        lex_dim: int,
        tech_slots: int,
        capacity: int,
        emb_dtype: str = "bfloat16",
        row_sharding: Optional["jax.sharding.NamedSharding"] = None,
    ):
        # When a mesh is configured, document rows shard across it and the
        # SAME fused program runs SPMD — GSPMD partitions the matmuls and
        # inserts the cross-shard top-k collectives (SURVEY.md §2.4).
        self.row_sharding = row_sharding
        self.name = name
        self.dim = dim
        self.lex_dim = lex_dim
        self.tech_slots = tech_slots
        self.capacity = max(8, capacity)
        self.emb_dtype = jnp.dtype(emb_dtype)
        self.count = 0
        # Single-writer concurrency contract (SURVEY.md §5 race detection:
        # ingest funnels through one writer); the lock makes the array-set
        # swap atomic so concurrent queries never see a half-updated corpus.
        self.lock = threading.RLock()
        self._alloc_device(self.capacity)
        # host mirrors (cheap per-doc scalars) for id mapping + planning
        self.h_ids = np.zeros(self.capacity, dtype=np.int64)
        self.h_call = np.zeros(self.capacity, dtype=np.int32)
        self.h_started = np.full(self.capacity, INT32_MIN, dtype=np.int32)
        self.h_has_emb = np.zeros(self.capacity, dtype=bool)
        # lexical corpus stats (df at bucket granularity, running avgdl)
        self.doc_freq = np.zeros(lex_dim, dtype=np.int64)
        self.dl_sum = 0
        # persistent doc_id -> row position map; rebuilt only on load_state.
        # A 1M-row embedding backfill calls position_of per batch — an
        # on-demand dict rebuild there is O(N^2/batch) over the whole run.
        self._id_to_pos: Dict[int, int] = {}
        # cached count of rows with embeddings: the planner estimates
        # candidates per plan per corpus; h_has_emb.sum() at 1M rows x 128
        # calls per batch was ~8 ms of pure counting (profiled)
        self.emb_rows = 0
        # tombstoned (deleted-but-not-compacted) rows within [:count]
        self.tombstones = 0
        # every doc_id ever tombstoned in this process. Store ids are
        # AUTOINCREMENT (never reused), so a deleted id can never be
        # legitimately re-inserted — this set lets the store syncer and
        # any racing insert path refuse to resurrect a row mid-delete
        # (delete_call tombstones the device BEFORE the store commit;
        # a sync poll in that window sees store-present/device-absent).
        self.deleted_ids: set = set()
        # optional probed-cluster dense index (settings.dense_ivf_enabled)
        self.ivf: Optional[IvfState] = None
        self._ivf_overflow_host = np.zeros(0, dtype=np.int32)
        self._ivf_rebuilding = False
        self._ivf_rebuild_warned = False
        # bumped whenever row POSITIONS are renumbered or reloaded
        # (compaction, checkpoint restore): an IVF build that started
        # before the bump must not install its position-based buckets
        self._pos_gen = 0
        # Beyond-HBM cold tier (core/coldtier.py): rows past
        # max_device_rows spill to host RAM, scanned in streamed blocks
        # by the same fused program and lane-merged before RRF.
        self.max_device_rows = int(settings.index_max_device_rows or 0)
        self.cold = None
        if self.max_device_rows:
            if row_sharding is not None:
                raise RuntimeError(
                    "INDEX_MAX_DEVICE_ROWS and MESH_SHAPE are mutually "
                    "exclusive: shard the corpus over the mesh OR spill "
                    "to the host cold tier, not both"
                )
            if _multiprocess():
                raise RuntimeError(
                    "INDEX_MAX_DEVICE_ROWS is single-process only (cold-"
                    "tier ops are not mirrored over the op-log); use the "
                    "data mesh for multi-host scale"
                )
        # active background growth (GrowthMigration) or None; started by
        # the prewarmer once the next capacity's query program is warm
        self._migration: Optional[GrowthMigration] = None
        # set by DeviceIndexManager: fires after each insert (prewarm hook)
        self._on_insert = None
        # set by DeviceIndexManager: (corpus, need) -> next capacity.
        # HBM-aware: a doubling when it fits the chip, a fractional step
        # when only that does (core/prewarm.plan_next_capacity) — and the
        # SAME capacity the prewarmer compiled for, so growth lands on a
        # warm program.
        self._grow_planner = None

    def _alloc_device(self, cap: int) -> None:
        (self.emb, self.lex, self.tech, self.call_idx, self.started,
         self.has_emb) = self._alloc_arrays(cap)

    def _alloc_arrays(self, cap: int) -> Tuple[jax.Array, ...]:
        """Fresh zero/default buffers at ``cap`` (not installed — growth
        migration allocates its target buffers off to the side)."""
        if self.row_sharding is None:
            return (
                jnp.zeros((cap, self.dim), dtype=self.emb_dtype),
                jnp.zeros((cap, self.lex_dim), dtype=jnp.int8),
                jnp.zeros((cap, self.tech_slots), dtype=jnp.int32),
                jnp.zeros((cap,), dtype=jnp.int32),
                jnp.full((cap,), int(INT32_MIN), dtype=jnp.int32),
                jnp.zeros((cap,), dtype=jnp.bool_),
            )
        # Sharded: build from per-shard callbacks — each process
        # materializes only its addressable shards, which is both the
        # multi-process-legal construction (device_put to non-addressable
        # devices is not) and avoids a full-capacity host buffer.
        from jax.sharding import NamedSharding, PartitionSpec

        sharding_2d = self.row_sharding
        sharding_1d = NamedSharding(
            sharding_2d.mesh, PartitionSpec(sharding_2d.spec[0])
        )

        def alloc(shape, dtype, fill, sharding):
            def cb(idx):
                shard_shape = tuple(
                    len(range(*s.indices(dim)))
                    for s, dim in zip(idx, shape)
                )
                return np.full(shard_shape, fill, dtype=dtype)

            return jax.make_array_from_callback(shape, sharding, cb)

        return (
            alloc((cap, self.dim), self.emb_dtype, 0, sharding_2d),
            alloc((cap, self.lex_dim), np.int8, 0, sharding_2d),
            alloc((cap, self.tech_slots), np.int32, 0, sharding_2d),
            alloc((cap,), np.int32, 0, sharding_1d),
            alloc((cap,), np.int32, int(INT32_MIN), sharding_1d),
            alloc((cap,), bool, False, sharding_1d),
        )

    @property
    def avgdl(self) -> float:
        return (self.dl_sum / self.count) if self.count else 0.0

    def _encode_emb(self, rows: np.ndarray) -> np.ndarray:
        """Host-side encode to the storage dtype. int8 storage quantizes
        unit vectors as round(x*127) (ops/topk.dense_scores restores the
        scale); a plain cast would truncate [-1,1] floats to zero. Rows
        already in the storage dtype pass through (checkpoint restore)."""
        rows = np.asarray(rows)
        if rows.dtype == self.emb_dtype:
            return rows
        if self.emb_dtype == jnp.int8:
            return np.clip(
                np.rint(rows.astype(np.float32) * 127.0), -127, 127
            ).astype(np.int8)
        return rows.astype(self.emb_dtype)

    # -- growth ---------------------------------------------------------
    def _grow_to(self, cap: int) -> None:
        with events.timed("index.grow", corpus=self.name,
                          old_cap=int(self.capacity), cap=int(cap)):
            if _oplog is not None:
                _oplog.emit("grow", {"corpus": self.name, "cap": int(cap)})
            old = (self.emb, self.lex, self.tech, self.call_idx,
                   self.started, self.has_emb)
            self.capacity = cap
            self._alloc_device(cap)
            self.emb = _write_slab(self.emb, old[0], 0)
            self.lex = _write_slab(self.lex, old[1], 0)
            self.tech = _write_slab(self.tech, old[2], 0)
            self.call_idx = _write_slab(self.call_idx, old[3], 0)
            self.started = _write_slab(self.started, old[4], 0)
            self.has_emb = _write_slab(self.has_emb, old[5], 0)
            self._grow_host_mirrors(cap)

    def _grow_host_mirrors(self, cap: int) -> None:
        for attr in ("h_ids", "h_call", "h_started", "h_has_emb"):
            mirror = getattr(self, attr)
            grown = np.zeros(cap, dtype=mirror.dtype)
            if mirror.dtype == np.int32 and attr == "h_started":
                grown[:] = INT32_MIN
            grown[: mirror.shape[0]] = mirror
            setattr(self, attr, grown)

    def ensure_capacity(self, extra: int) -> None:
        need = self.count + extra
        if need <= self.capacity:
            return
        mig = self._migration
        if mig is not None:
            if (mig.ready.is_set() and not mig.cancelled
                    and mig.new_cap >= need):
                with events.timed("index.growth_swap", corpus=self.name,
                                  cap=mig.new_cap):
                    (self.emb, self.lex, self.tech, self.call_idx,
                     self.started, self.has_emb) = mig.finalize()
                    self.capacity = mig.new_cap
                    self._grow_host_mirrors(mig.new_cap)
                self._migration = None
                logger.info(
                    "index.growth_swapped corpus=%s cap=%s (background "
                    "migration; serving never waited on the copy)",
                    self.name, mig.new_cap,
                )
                return
            # not ready / target too small: pay the synchronous growth
            mig.cancel()
            self._migration = None
            logger.warning(
                "index.migration_not_ready corpus=%s need=%s target=%s "
                "ready=%s — falling back to synchronous growth",
                self.name, need, mig.new_cap, mig.ready.is_set(),
            )
        if self._grow_planner is not None:
            cap = int(self._grow_planner(self, need))
        else:
            cap = self.capacity
            while cap < need:
                cap *= 2
        self._grow_to(max(cap, need))

    def start_migration(self, new_cap: int, warmup=None) -> bool:
        """Begin background growth toward ``new_cap`` (idempotent; called
        by the prewarmer once the target's query program is compiled).
        Single-process hot tier only — gangs mirror 'grow' synchronously
        and cold-tier corpora cap their device rows."""
        if (
            _multiprocess()
            or self.max_device_rows
            or not settings.growth_migration_enabled
        ):
            return False
        with self.lock:
            if new_cap <= self.capacity:
                return False
            mig = self._migration
            if mig is not None:
                if mig.new_cap >= new_cap and not mig.cancelled:
                    return False  # already migrating there
                mig.cancel()
            self._migration = GrowthMigration(self, new_cap,
                                              warmup=warmup)
            self._migration.start()
            events.record("index.migration_start", corpus=self.name,
                          cap=int(new_cap))
            return True

    def _cancel_migration_locked(self) -> None:
        """Row positions are being renumbered/reloaded (compaction,
        restore): a migration's copied rows and journal are stale."""
        if self._migration is not None:
            self._migration.cancel()
            self._migration = None

    def _journal(self, op: str, arrays: Tuple) -> None:
        mig = self._migration
        if mig is not None:
            mig.journal_op(op, arrays)

    # -- ingest -----------------------------------------------------------
    def insert(self, rows: Sequence[DocRow]) -> None:
        if not rows:
            return
        with self.lock:
            with events.timed("index.insert", corpus=self.name,
                              rows=len(rows)):
                self._insert_locked(rows)
        self._maybe_schedule_ivf_rebuild()
        if self._on_insert is not None:
            self._on_insert()

    def _cold_tier(self):
        if self.cold is None:
            from .coldtier import ColdTier

            self.cold = ColdTier(
                dim=self.dim, lex_dim=self.lex_dim,
                tech_slots=self.tech_slots, emb_dtype=self.emb_dtype,
            )
            logger.warning(
                "%s: device-row cap %s reached — new rows spill to the "
                "host cold tier (core/coldtier.py; scanned per batch in "
                "%s-row blocks)",
                self.name, self.max_device_rows,
                int(settings.cold_block_rows),
            )
        return self.cold

    def _present(self, doc_id: int) -> bool:
        if int(doc_id) in self._id_to_pos:
            return True
        return self.cold is not None and self.cold.contains(doc_id)

    def contains(self, doc_ids: Sequence[int]) -> np.ndarray:
        """Presence of each id in EITHER tier (syncer/reconcile use this
        instead of position_of, which is hot-tier positional)."""
        with self.lock:
            return np.array([self._present(d) for d in doc_ids], dtype=bool)

    def _cold_insert_locked(self, rows: Sequence[DocRow]) -> None:
        tier = self._cold_tier()
        tier.insert(rows, self._encode_emb)
        for r in rows:
            self.doc_freq[r.lex_touched] += 1
            self.dl_sum += r.lex_dl

    def _insert_locked(self, rows: Sequence[DocRow]) -> None:
        # Drop rows already present (same doc_id): the live store->index
        # syncer (ingest/sync.py) and a local ingest can race to insert
        # the same committed row — whichever arrives second must be a
        # no-op, not a duplicate index row.
        if any(self._present(r.doc_id) for r in rows):
            rows = [r for r in rows if not self._present(r.doc_id)]
        if self.deleted_ids:
            # a row tombstoned here can only reappear via a stale sync/
            # rebuild read that raced the store delete — refuse it
            rows = [r for r in rows
                    if int(r.doc_id) not in self.deleted_ids]
        if not rows:
            return
        if self.max_device_rows:
            take = min(len(rows), max(0, self.max_device_rows - self.count))
            # ensure_capacity reserves the POW2-PADDED slab: at a cap
            # that equals the allocated capacity, a padded tail slab
            # would otherwise DOUBLE the device arrays past
            # max_device_rows — the limit that exists because HBM is
            # full. Shrink the hot intake until its padding fits the
            # existing allocation; the remainder spills to the cold
            # tier like any over-cap rows. (While capacity is still
            # below the cap, growth stays within budget — no shrink.)
            if self.capacity >= self.max_device_rows:
                while take and self.count + _next_pow2(take) > self.capacity:
                    take = min(take - 1, _next_pow2(take) // 2)
            if len(rows) > take:
                self._cold_insert_locked(rows[take:])
                rows = rows[:take]
                if not rows:
                    return
        n = len(rows)
        padded = _next_pow2(n)
        # Reserve room for the PADDED slab: dynamic_update_slice silently
        # clamps an out-of-bounds start, which would corrupt the index.
        self.ensure_capacity(padded)
        start = self.count

        emb = np.zeros((n, self.dim), dtype=np.float32)
        has = np.zeros(n, dtype=bool)
        for i, r in enumerate(rows):
            if r.embedding is not None:
                emb[i] = r.embedding
                has[i] = True
        lex = np.stack([r.lex_sig for r in rows]).astype(np.int8)
        tech = np.stack([r.tech for r in rows]).astype(np.int32)
        call = np.array([r.call_seq for r in rows], dtype=np.int32)
        started = np.array([r.started_sec for r in rows], dtype=np.int32)

        # Pad the slab; padding rows land beyond count and their
        # started_sec stays valid-looking, so clamp pad rows to invalid.
        pad_started = np.full(padded, INT32_MIN, dtype=np.int32)
        pad_started[:n] = started

        emb_p = self._encode_emb(_pad_rows(emb, padded))
        lex_p = _pad_rows(lex, padded)
        tech_p = _pad_rows(tech, padded)
        call_p = _pad_rows(call, padded)
        has_p = _pad_rows(has, padded)
        if _oplog is not None:
            _oplog.emit(
                "write_slabs",
                {"corpus": self.name, "start": int(start),
                 "count_after": int(start + n)},
                {"emb": emb_p, "lex": lex_p, "tech": tech_p, "call": call_p,
                 "started": pad_started, "has": has_p},
            )
        self._journal("write_slabs",
                      (emb_p, lex_p, tech_p, call_p, pad_started, has_p,
                       start))
        (self.emb, self.lex, self.tech, self.call_idx, self.started,
         self.has_emb) = _write_all_slabs(
            self.emb, self.lex, self.tech, self.call_idx, self.started,
            self.has_emb,
            _stage(emb_p),
            _stage(lex_p),
            _stage(tech_p),
            _stage(call_p),
            _stage(pad_started),
            _stage(has_p),
            start,
        )

        for i, r in enumerate(rows):
            pos = start + i
            self.h_ids[pos] = r.doc_id
            self.h_call[pos] = r.call_seq
            self.h_started[pos] = r.started_sec
            self.h_has_emb[pos] = has[i]
            self._id_to_pos[int(r.doc_id)] = pos
            self.doc_freq[r.lex_touched] += 1
            self.dl_sum += r.lex_dl
        self.emb_rows += int(has.sum())
        self.count += n
        if self.ivf is not None:
            self._ivf_append_overflow(np.arange(start, start + n, dtype=np.int32))

    def set_embeddings(
        self, doc_ids: Sequence[int], vectors: np.ndarray
    ) -> int:
        """Backfill embeddings for existing rows (reference analogue:
        UPDATE ... SET embedding, app/embedding_pipeline.py:149-168)."""
        with self.lock:
            return self._set_embeddings_locked(doc_ids, vectors)

    def _set_embeddings_locked(
        self, doc_ids: Sequence[int], vectors: np.ndarray
    ) -> int:
        cold_n = 0
        if self.cold is not None:
            cold_pos = self.cold.positions(doc_ids)
            cmask = cold_pos >= 0
            if cmask.any():
                cold_n = self.cold.set_embeddings(
                    cold_pos[cmask],
                    np.asarray(vectors, dtype=np.float32)[cmask],
                    self._encode_emb,
                )
        id_to_pos = self.position_of(doc_ids)
        mask = id_to_pos >= 0
        if not mask.any():
            return cold_n
        pos = id_to_pos[mask]
        vals = np.asarray(vectors, dtype=np.float32)[mask]
        n = pos.shape[0]
        padded = _next_pow2(n)
        pad_pos = np.full(padded, pos[0], dtype=np.int32)
        pad_pos[:n] = pos
        pad_vals = np.zeros((padded, self.dim), dtype=np.float32)
        pad_vals[:n] = vals
        pad_vals[n:] = vals[0] if n else 0.0
        pad_vals = self._encode_emb(pad_vals)
        flags = np.ones(padded, dtype=bool)
        if _oplog is not None:
            _oplog.emit(
                "scatter_emb", {"corpus": self.name},
                {"pos": pad_pos, "vals": pad_vals, "flags": flags},
            )
        self._journal("scatter_emb", (pad_pos, pad_vals, flags))
        self.emb, self.has_emb = _scatter_emb_and_flags(
            self.emb, self.has_emb, _stage(pad_pos),
            _stage(pad_vals),
            _stage(flags),
        )
        self.emb_rows += int((~self.h_has_emb[pos]).sum())
        self.h_has_emb[pos] = True
        return int(n) + cold_n

    def set_tech(self, doc_ids: Sequence[int], tech_rows: np.ndarray) -> int:
        """Replace tech-token slots for existing rows (tech-token backfill
        after lexicon changes; reference analogue:
        app/scripts/tech_tokens_backfill.py)."""
        with self.lock:
            return self._set_tech_locked(doc_ids, tech_rows)

    def _set_tech_locked(self, doc_ids: Sequence[int], tech_rows: np.ndarray) -> int:
        cold_n = 0
        if self.cold is not None:
            cold_pos = self.cold.positions(doc_ids)
            cmask = cold_pos >= 0
            if cmask.any():
                cold_n = self.cold.set_tech(
                    cold_pos[cmask],
                    np.asarray(tech_rows, dtype=np.int32)[cmask],
                )
        id_to_pos = self.position_of(doc_ids)
        mask = id_to_pos >= 0
        if not mask.any():
            return cold_n
        pos = id_to_pos[mask]
        vals = np.asarray(tech_rows, dtype=np.int32)[mask]
        n = pos.shape[0]
        padded = _next_pow2(n)
        pad_pos = np.full(padded, pos[0], dtype=np.int32)
        pad_pos[:n] = pos
        pad_vals = np.zeros((padded, self.tech_slots), dtype=np.int32)
        pad_vals[:n] = vals
        pad_vals[n:] = vals[0] if n else 0
        if _oplog is not None:
            _oplog.emit("scatter_tech", {"corpus": self.name},
                        {"pos": pad_pos, "vals": pad_vals})
        self._journal("scatter_tech", (pad_pos, pad_vals))
        self.tech = _scatter_rows(
            self.tech, _stage(pad_pos), _stage(pad_vals)
        )
        return int(n) + cold_n

    def set_lex(
        self, doc_ids: Sequence[int], lex_rows: np.ndarray,
        positions: Optional[np.ndarray] = None,
    ) -> int:
        """Replace lexical signatures for existing rows (vocab-head
        re-featurize, scripts/build_lex_vocab.py). Pure row scatter —
        corpus df stats are rebuilt by the caller via replace_doc_freq
        once every row is re-featurized (a full-layout change invalidates
        incremental df deltas). ``positions`` skips the id lookup when
        the caller already resolved it (−1 = not live)."""
        with self.lock:
            return self._set_lex_locked(doc_ids, lex_rows, positions)

    def _set_lex_locked(
        self, doc_ids: Sequence[int], lex_rows: np.ndarray,
        positions: Optional[np.ndarray] = None,
    ) -> int:
        id_to_pos = (
            positions if positions is not None else self.position_of(doc_ids)
        )
        mask = id_to_pos >= 0
        if not mask.any():
            return 0
        pos = id_to_pos[mask]
        vals = np.asarray(lex_rows, dtype=np.int8)[mask]
        n = pos.shape[0]
        padded = _next_pow2(n)
        pad_pos = np.full(padded, pos[0], dtype=np.int32)
        pad_pos[:n] = pos
        pad_vals = np.zeros((padded, self.lex_dim), dtype=np.int8)
        pad_vals[:n] = vals
        pad_vals[n:] = vals[0] if n else 0
        if _oplog is not None:
            _oplog.emit("scatter_lex", {"corpus": self.name},
                        {"pos": pad_pos, "vals": pad_vals})
        self._journal("scatter_lex", (pad_pos, pad_vals))
        self.lex = _scatter_rows(
            self.lex, _stage(pad_pos), _stage(pad_vals)
        )
        return int(n)

    def set_lex_ids(
        self, doc_ids: Sequence[int], lex_rows: np.ndarray
    ) -> np.ndarray:
        """Replace lexical signatures by doc id across BOTH tiers;
        returns the per-row live mask (vocab re-featurize uses it to
        rebuild df over every live row, hot or cold)."""
        with self.lock, events.timed("index.set_lex_ids",
                                     corpus=self.name,
                                     rows=len(doc_ids)):
            pos = self.position_of(doc_ids)
            live = pos >= 0
            if live.any():
                self._set_lex_locked(
                    np.asarray(doc_ids)[live],
                    np.asarray(lex_rows, dtype=np.int8)[live],
                    positions=pos[live],
                )
            if self.cold is not None:
                cold_pos = self.cold.positions(doc_ids)
                cmask = cold_pos >= 0
                if cmask.any():
                    self.cold.set_lex(
                        cold_pos[cmask],
                        np.asarray(lex_rows, dtype=np.int8)[cmask],
                    )
                live = live | cmask
            return live

    def replace_doc_freq(self, doc_freq: np.ndarray) -> None:
        """Swap the bucket-granularity df table after a full lexical
        re-featurize (doc lengths are layout-independent, so dl_sum/avgdl
        stand)."""
        with self.lock:
            self.doc_freq = np.asarray(doc_freq, dtype=np.int64).copy()

    def position_of(self, doc_ids: Sequence[int]) -> np.ndarray:
        lookup = self._id_to_pos
        return np.array([lookup.get(int(d), -1) for d in doc_ids], dtype=np.int32)

    # -- delete / compaction ------------------------------------------------
    def delete_ids(
        self,
        doc_ids: Sequence[int],
        lex_sigs: Optional[Sequence[Optional[np.ndarray]]] = None,
        lex_dls: Optional[Sequence[int]] = None,
    ) -> int:
        """Tombstone rows: one device scatter makes them invisible to every
        lane immediately (filter_mask treats started=INT32_MIN as invalid);
        physical space is reclaimed by compact(). Neither the reference nor
        Postgres-backed deployments get this for free. ``lex_sigs``/
        ``lex_dls`` (from the durable store) let the corpus lexical stats
        shed the deleted documents' df/avgdl mass."""
        with self.lock:
            return self._delete_ids_locked(doc_ids, lex_sigs, lex_dls)

    def _delete_ids_locked(self, doc_ids, lex_sigs, lex_dls) -> int:
        # blacklist first: ids explicitly deleted must never re-enter,
        # even when unknown to this tier (store-only writer's rows)
        self.deleted_ids.update(int(d) for d in doc_ids)
        cold_n = 0
        if self.cold is not None:
            cold_pos = self.cold.positions(doc_ids)
            cmask = cold_pos >= 0
            if cmask.any():
                # dedupe within the request (same first-seen contract as
                # the hot path below; O(n), not a per-element rescan)
                seen_cold: set = set()
                uniq_idx = []
                for i in np.flatnonzero(cmask):
                    p = int(cold_pos[i])
                    if p not in seen_cold:
                        seen_cold.add(p)
                        uniq_idx.append(i)
                cold_n = self.cold.tombstone(
                    cold_pos[uniq_idx],
                    ([lex_sigs[i] for i in uniq_idx]
                     if lex_sigs is not None else None),
                    ([lex_dls[i] for i in uniq_idx]
                     if lex_dls is not None else None),
                )
                for i in uniq_idx:
                    sig = lex_sigs[i] if lex_sigs is not None else None
                    if sig is not None:
                        touched = np.flatnonzero(sig)
                        self.doc_freq[touched] = np.maximum(
                            self.doc_freq[touched] - 1, 0
                        )
                    if lex_dls is not None:
                        self.dl_sum = max(
                            self.dl_sum - int(lex_dls[i] or 0), 0
                        )
        pos_all = self.position_of(doc_ids)
        # drop unknown ids AND duplicates (a doc_id listed twice must not
        # double-count tombstones/emb_rows for one invalidated row)
        first_seen: Dict[int, int] = {}
        for i, p in enumerate(pos_all):
            if p >= 0 and int(p) not in first_seen:
                first_seen[int(p)] = i
        keep = np.zeros(pos_all.shape[0], dtype=bool)
        keep[list(first_seen.values())] = True
        pos_all = np.where(keep, pos_all, -1)
        if not keep.any():
            return cold_n
        pos = pos_all[keep]
        n = int(pos.shape[0])
        padded = _next_pow2(n)
        pad_pos = np.full(padded, pos[0], dtype=np.int32)
        pad_pos[:n] = pos
        if _oplog is not None:
            _oplog.emit("tombstone", {"corpus": self.name}, {"pos": pad_pos})
        self._journal("tombstone", (pad_pos,))
        self.started, self.has_emb = _tombstone_rows(
            self.started, self.has_emb, _stage(pad_pos)
        )
        self.emb_rows -= int(self.h_has_emb[pos].sum())
        self.h_started[pos] = INT32_MIN
        self.h_has_emb[pos] = False
        for i, doc_id in enumerate(doc_ids):
            if pos_all[i] >= 0:
                self._id_to_pos.pop(int(doc_id), None)
        if lex_sigs is not None:
            for i, sig in enumerate(lex_sigs):
                if pos_all[i] < 0 or sig is None:
                    continue
                touched = np.flatnonzero(sig)
                self.doc_freq[touched] = np.maximum(
                    self.doc_freq[touched] - 1, 0
                )
        if lex_dls is not None:
            self.dl_sum -= int(sum(
                dl for i, dl in enumerate(lex_dls) if pos_all[i] >= 0
            ))
            self.dl_sum = max(self.dl_sum, 0)
        self.tombstones += n
        return n + cold_n

    def maybe_compact(self, threshold_frac: float = 0.25) -> bool:
        """Compact when tombstones exceed a quarter of the rows (bounded
        wasted HBM + scan work); O(live rows) one-time gather. Works
        multi-host: the whole compaction is device programs mirrored
        over the op-log (the r2 stand-down is gone)."""
        compacted = False
        with self.lock:
            if self.cold is not None and self.cold.tombstones >= max(
                int(self.cold.count * threshold_frac), 64
            ):
                self.cold.compact()
                compacted = True
            if self.tombstones >= max(
                int(self.count * threshold_frac), 64
            ):
                self._compact_locked()
                compacted = True
            return compacted

    def compact(self) -> None:
        with self.lock:
            with events.timed("index.compact", corpus=self.name):
                self._compact_locked()

    def apply_compact_device(
        self, pad_live: np.ndarray, out_rows: int, cap: int
    ) -> None:
        """The device side of compaction: gather live rows (padding
        stamped invalid in-program), reallocate at ``cap``, write the
        packed rows at the front. Runs identically on the leader and —
        via the 'compact' op — on followers, so the gang's collectives
        stay lockstep."""
        gathered = _gather_live(
            self.emb, self.lex, self.tech, self.call_idx, self.started,
            self.has_emb, _stage(pad_live),
            _stage(np.int32(out_rows)),
            out_rows=int(pad_live.shape[0]),
        )
        self.capacity = cap
        self._alloc_device(cap)
        (self.emb, self.lex, self.tech, self.call_idx, self.started,
         self.has_emb) = _write_all_slabs(
            self.emb, self.lex, self.tech, self.call_idx, self.started,
            self.has_emb, *gathered, 0,
        )
        self.count = out_rows
        self.ivf = None
        self._ivf_overflow_host = np.zeros(0, dtype=np.int32)
        self._cancel_migration_locked()
        self._pos_gen += 1

    def _compact_locked(self) -> None:
        n = self.count
        live = np.flatnonzero(self.h_started[:n] != INT32_MIN).astype(np.int32)
        out_rows = int(live.shape[0])
        pad_live = np.zeros(max(_next_pow2(max(out_rows, 1)), 8), np.int32)
        pad_live[:out_rows] = live
        old_ids = self.h_ids
        old_call = self.h_call
        old_started = self.h_started
        old_has = self.h_has_emb
        cap = max(_next_pow2(max(out_rows, 8)),
                  int(settings.index_initial_capacity))
        if self.row_sharding is not None:
            rows_axis = self.row_sharding.mesh.shape.get("data", 1)
            if cap % max(rows_axis, 1):
                cap = _next_pow2(cap)
        if _oplog is not None:
            _oplog.emit(
                "compact",
                {"corpus": self.name, "out_rows": int(out_rows),
                 "cap": int(cap)},
                {"live": pad_live},
            )
        self.apply_compact_device(pad_live, out_rows, cap)
        self.h_ids = np.zeros(cap, dtype=np.int64)
        self.h_call = np.zeros(cap, dtype=np.int32)
        self.h_started = np.full(cap, INT32_MIN, dtype=np.int32)
        self.h_has_emb = np.zeros(cap, dtype=bool)
        self.h_ids[:out_rows] = old_ids[live]
        self.h_call[:out_rows] = old_call[live]
        self.h_started[:out_rows] = old_started[live]
        self.h_has_emb[:out_rows] = old_has[live]
        self._id_to_pos = {
            int(d): p for p, d in enumerate(self.h_ids[:out_rows])
        }
        self.emb_rows = int(self.h_has_emb[:out_rows].sum())
        self.count = out_rows
        self.tombstones = 0
        # row positions changed: derived IVF state is invalid
        self.ivf = None
        self._ivf_overflow_host = np.zeros(0, dtype=np.int32)
        self._pos_gen += 1

    @property
    def live_count(self) -> int:
        """Live rows across BOTH tiers — idf/avgdl and planner estimates
        are corpus-wide so hot and cold scoring agree."""
        cold = self.cold.live_count if self.cold is not None else 0
        return self.count - self.tombstones + cold

    # -- IVF dense index ----------------------------------------------------
    def _ivf_append_overflow(self, positions: np.ndarray) -> None:
        self._ivf_overflow_host = np.concatenate(
            [self._ivf_overflow_host, positions.astype(np.int32)]
        )
        padded_len = _next_pow2(max(len(self._ivf_overflow_host), 8))
        padded = np.full(padded_len, -1, dtype=np.int32)
        padded[: len(self._ivf_overflow_host)] = self._ivf_overflow_host
        if _multiprocess():
            # mirror: the overflow array is an INPUT of the gang's IVF
            # query program — shape and contents must match on every
            # process or the next 'query_ivf' diverges/deadlocks
            from ..parallel import oplog as oplog_mod

            if _oplog is not None:
                _oplog.emit(
                    "ivf_overflow",
                    {"corpus": self.name,
                     "count": len(self._ivf_overflow_host)},
                    {"padded": padded},
                )
            overflow_arr = oplog_mod.replicated_array(padded)
        else:
            overflow_arr = jnp.asarray(padded)
        self.ivf = dataclasses.replace(
            self.ivf,
            overflow=overflow_arr,
            overflow_count=len(self._ivf_overflow_host),
        )

    def gang_set_ivf_overflow(self, padded: np.ndarray, count: int) -> None:
        """Follower side of 'ivf_overflow' (parallel/oplog._apply)."""
        from ..parallel import oplog as oplog_mod

        with self.lock:
            padded = np.asarray(padded, dtype=np.int32)
            self._ivf_overflow_host = padded[:count].copy()
            self.ivf = dataclasses.replace(
                self.ivf,
                overflow=oplog_mod.replicated_array(padded),
                overflow_count=int(count),
            )

    def _ivf_plan(
        self, n: int, n_clusters: Optional[int], nprobe: Optional[int]
    ) -> Tuple[int, int]:
        """Deterministic (clusters, nprobe) from corpus size + settings —
        shared by single-process builds and the multi-host gang build
        (followers must derive identical bucket shapes)."""
        clusters = n_clusters or int(settings.ivf_clusters) or max(
            16, int(np.sqrt(n))
        )
        clusters = min(clusters, n)
        probe = nprobe or int(settings.ivf_nprobe) or max(
            4, int(clusters * 0.08)
        )
        # cap probed candidates at ~5% of the corpus: beyond that the
        # per-query row gather moves more HBM bytes than the brute-force
        # matmul it is replacing (measured at 1M: nprobe=80 of 1000
        # clusters gathered 16% of rows per query and ran 12x slower
        # than exact)
        bucket_cap_est = max(8, int(2.0 * n / clusters))
        max_probe = max(4, int(0.05 * n / bucket_cap_est))
        return clusters, min(probe, max_probe, clusters)

    def gang_build_install_ivf(
        self, n: int, clusters: int, probe: int, seed: int
    ) -> IvfState:
        """Run the mirrored IVF build program and install the result —
        the leader calls this inside build_ivf (after emitting the
        'build_ivf' op), followers from parallel/oplog._apply. Identical
        statics -> identical replicated assignments -> identical
        host-packed buckets on every process, with no (C, dim) centroid
        shipping over TCP."""
        from ..parallel import oplog as oplog_mod

        with self.lock:
            centroids, assign = oplog_mod.ivf_build_gang(
                self.emb,
                {"n": int(n), "n_clusters": int(clusters), "iters": 10,
                 "seed": int(seed),
                 "dequant": self.emb_dtype == jnp.int8},
            )
            bucket_cap = max(8, int(2.0 * n / clusters))
            buckets_np, overflow_np = build_buckets(
                np.asarray(assign), clusters, bucket_cap
            )
            self._ivf_overflow_host = overflow_np.astype(np.int32)
            padded_len = _next_pow2(max(len(self._ivf_overflow_host), 8))
            padded = np.full(padded_len, -1, dtype=np.int32)
            padded[: len(self._ivf_overflow_host)] = self._ivf_overflow_host
            self.ivf = IvfState(
                centroids=centroids,
                buckets=oplog_mod.replicated_array(buckets_np),
                overflow=oplog_mod.replicated_array(padded),
                overflow_count=len(self._ivf_overflow_host),
                built_count=int(n),
                n_clusters=int(clusters),
                nprobe=int(probe),
            )
            return self.ivf

    def build_ivf(
        self,
        n_clusters: Optional[int] = None,
        nprobe: Optional[int] = None,
        seed: int = 0,
    ) -> IvfState:
        """Build (or rebuild) the probed-cluster dense index on device.

        Serving is never blocked for the duration of the k-means: the
        embeddings are snapshotted under the lock (a device copy), the
        clustering runs OUTSIDE the lock, and the finished state installs
        atomically — rows inserted meanwhile land in the exact-scanned
        overflow tail, so nothing is ever invisible."""
        if _multiprocess():
            # Multi-host gang build (parallel/oplog.py): every process
            # must enqueue the identical k-means program over the GLOBAL
            # sharded embeddings, so the build mirrors as ONE op —
            # statics only; followers recompute identical buckets from
            # the replicated assignments. The corpus lock is held for
            # the WHOLE build so no other mirrored op interleaves with
            # the build's device programs in the log (blocking the gang
            # for the k-means duration is the price of lockstep).
            with self.lock:
                if self.count == 0:
                    raise RuntimeError(
                        f"{self.name}: empty corpus, nothing to build"
                    )
                n = self.count
                clusters, probe = self._ivf_plan(n, n_clusters, nprobe)
                if _oplog is not None:
                    _oplog.emit(
                        "build_ivf",
                        {"corpus": self.name, "n": int(n),
                         "clusters": int(clusters), "nprobe": int(probe),
                         "seed": int(seed)},
                    )
                return self.gang_build_install_ivf(
                    n, clusters, probe, int(seed)
                )
        with self.lock:
            if self.count == 0:
                raise RuntimeError(f"{self.name}: empty corpus, nothing to build")
            n = self.count
            pos_gen = self._pos_gen
            # device-side copy so later donated inserts can't invalidate
            # the buffer mid-clustering
            emb_snapshot = jnp.copy(
                jax.lax.slice_in_dim(self.emb, 0, n, axis=0)
            )
        if self.emb_dtype == jnp.int8:
            # k-means must run in float space (casting float centroids
            # back to int8 degenerates them); the probed-scan ranking is
            # scale-invariant, so clustering the dequantized rows keeps
            # the query path (int8 rows widened in-register) consistent
            emb_snapshot = emb_snapshot.astype(jnp.float32) / 127.0

        clusters, probe = self._ivf_plan(n, n_clusters, nprobe)
        centroids, assign = kmeans(
            emb_snapshot, jax.random.PRNGKey(seed),
            n_clusters=clusters, iters=10,
        )
        bucket_cap = max(8, int(2.0 * n / clusters))
        buckets_np, overflow_np = build_buckets(
            np.asarray(assign), clusters, bucket_cap
        )

        with self.lock:
            if self._pos_gen != pos_gen:
                # a compaction/restore renumbered rows while k-means ran:
                # the assignment maps PRE-renumber positions, installing
                # it would silently return wrong doc_ids from the dense
                # lane. Abort; the caller (CLI or rebuild daemon) retries
                # against the new layout.
                raise RuntimeError(
                    f"{self.name}: concurrent compaction/restore "
                    "invalidated the IVF build (row positions changed); "
                    "re-run the build"
                )
            # rows inserted during the build join the overflow tail
            tail = np.arange(n, self.count, dtype=np.int32)
            self._ivf_overflow_host = np.concatenate(
                [overflow_np.astype(np.int32), tail]
            )
            padded_len = _next_pow2(max(len(self._ivf_overflow_host), 8))
            padded = np.full(padded_len, -1, dtype=np.int32)
            padded[: len(self._ivf_overflow_host)] = self._ivf_overflow_host
            self.ivf = IvfState(
                centroids=centroids,
                buckets=jnp.asarray(buckets_np),
                overflow=jnp.asarray(padded),
                overflow_count=len(self._ivf_overflow_host),
                built_count=n,
                n_clusters=clusters,
                nprobe=probe,
            )
            return self.ivf

    def _maybe_schedule_ivf_rebuild(self) -> None:
        """Fire a background rebuild when the exact-scanned overflow tail
        grows past half the built index (before ivf_usable() goes false).
        k-means runs on a device-side snapshot OUTSIDE the corpus lock so
        serving is never blocked; the finished state swaps in atomically."""
        state = self.ivf
        if (
            state is None
            or self._ivf_rebuilding
            or not settings.dense_ivf_enabled
            or state.overflow_count < max(state.built_count // 2, 8)
        ):
            return
        if _multiprocess() and not settings.dense_ivf_auto_rebuild_multihost:
            # A gang IVF build is a mirrored collective program that holds
            # the shared corpus lock for the whole k-means — firing it
            # automatically from the insert path would silently pause
            # /retrieve for minutes on a production leader (ADVICE r4).
            # Stand down; operators rebuild explicitly (scripts/build_ivf)
            # or opt in via DENSE_IVF_AUTO_REBUILD_MULTIHOST=1.
            if not self._ivf_rebuild_warned:
                self._ivf_rebuild_warned = True
                import logging

                logging.getLogger(__name__).warning(
                    "ivf.auto_rebuild_standdown corpus=%s overflow=%d "
                    "built=%d — multi-host gang build blocks serving for "
                    "the k-means duration; run scripts/build_ivf or set "
                    "DENSE_IVF_AUTO_REBUILD_MULTIHOST=1",
                    self.name, state.overflow_count, state.built_count,
                )
            return
        self._ivf_rebuilding = True

        def rebuild():
            try:
                self.build_ivf(
                    n_clusters=None,
                    nprobe=None,
                    seed=int(self.count),
                )
            except Exception:  # pragma: no cover - logged, never fatal
                import logging

                logging.getLogger(__name__).exception(
                    "ivf.rebuild_failed corpus=%s", self.name
                )
            finally:
                self._ivf_rebuilding = False

        threading.Thread(target=rebuild, daemon=True).start()

    def ivf_usable(self) -> bool:
        """IVF serves the dense lane only while the exact-scanned tail is
        small relative to the built graph (else ann/exact is faster)."""
        return (
            self.ivf is not None
            and self.ivf.overflow_count < max(self.ivf.built_count, 1)
        )

    def ivf_dense_query(
        self, q_emb: np.ndarray, allowed_calls: np.ndarray,
        date_min: np.ndarray, date_max: np.ndarray, k: int,
    ):
        with self.lock:
            state = self.ivf
            k_eff = min(k, self.capacity)
            if _multiprocess():
                # mirror the separate IVF dispatch: the probed gather
                # over row-sharded embeddings is a GSPMD collective, so
                # the whole gang must enqueue it (parallel/oplog.py)
                from ..parallel import oplog as oplog_mod

                statics = {"k": int(k_eff), "nprobe": int(state.nprobe)}
                q_emb = np.asarray(q_emb, dtype=np.float32)
                allowed = np.asarray(allowed_calls, dtype=bool)
                dmin = np.asarray(date_min, dtype=np.int32)
                dmax = np.asarray(date_max, dtype=np.int32)
                if _oplog is not None:
                    _oplog.emit(
                        "query_ivf",
                        {"corpus": self.name, "statics": statics},
                        {"q_emb": q_emb, "allowed": allowed,
                         "dmin": dmin, "dmax": dmax},
                    )
                return oplog_mod.ivf_query(
                    self, state, q_emb, allowed, dmin, dmax, statics
                )
            return _ivf_dense_query(
                self.emb, self.call_idx, self.started, self.has_emb,
                state.centroids, state.buckets, state.overflow,
                jnp.asarray(q_emb), jnp.asarray(allowed_calls),
                jnp.asarray(date_min), jnp.asarray(date_max),
                k=k_eff, nprobe=state.nprobe,
            )

    # -- planning ---------------------------------------------------------
    def estimate_candidates(
        self,
        allowed_calls: Optional[np.ndarray],
        date_min: int,
        date_max: int,
        require_embedding: bool = True,
        unfiltered: bool = False,
    ) -> int:
        """Masked row count for the exact-vs-ANN planner (reference:
        app/retrieve.py:303-323 COUNT(*) under filters). Host mirrors make
        this a vectorized numpy pass — and the common unfiltered case is a
        cached counter, no pass at all."""
        n = self.count
        cold = self.cold
        cold_est = (
            cold.estimate(allowed_calls, date_min, date_max,
                          require_embedding, unfiltered)
            if cold is not None else 0
        )
        if n == 0:
            return cold_est
        if unfiltered:
            hot = self.emb_rows if require_embedding else (
                self.count - self.tombstones
            )
            return hot + cold_est
        mask = (self.h_started[:n] >= date_min) & (self.h_started[:n] <= date_max)
        if allowed_calls is not None:
            mask &= allowed_calls[self.h_call[:n]]
        if require_embedding:
            mask &= self.h_has_emb[:n]
        return int(mask.sum()) + cold_est

    # -- checkpoint (core/checkpoint.py drives these) ----------------------
    def state_arrays(self) -> Dict[str, np.ndarray]:
        with self.lock:
            return self._state_arrays_locked()

    def _state_arrays_locked(self) -> Dict[str, np.ndarray]:
        if _multiprocess():
            raise RuntimeError(
                "checkpoint save is single-process only (device arrays "
                "span processes); snapshot from a single-process restart "
                "— restore IS multi-host-supported (parallel/oplog.py)"
            )
        c = self.count
        doc_freq = self.doc_freq.copy()
        dl_sum = self.dl_sum
        if self.cold is not None and self.cold.count:
            logger.warning(
                "%s: checkpoint snapshots the HOT tier only — %s cold-tier "
                "rows rebuild from the store at startup (sync.reconcile)",
                self.name, self.cold.count,
            )
            # hot-only snapshot: subtract the cold tier's share of the
            # lexical stats; the startup reconcile re-adds it when the
            # cold rows re-insert from the store
            doc_freq = np.maximum(doc_freq - self.cold.df, 0)
            dl_sum = max(dl_sum - self.cold.dl_sum, 0)
        return {
            # storage dtype passes through (bf16 stays bf16): checkpoints
            # are half the size and no precision is gained by widening
            "emb": np.asarray(self.emb[:c]),
            "lex": np.asarray(self.lex[:c]),
            "tech": np.asarray(self.tech[:c]),
            "ids": self.h_ids[:c].copy(),
            "call": self.h_call[:c].copy(),
            "started": self.h_started[:c].copy(),
            "has_emb": self.h_has_emb[:c].copy(),
            "doc_freq": doc_freq,
            "dl_sum": np.array([dl_sum], dtype=np.int64),
        }

    def load_state(self, arrays: Dict[str, np.ndarray]) -> None:
        # Locked like the save side (state_arrays): a restore concurrent
        # with serving must never expose a half-swapped corpus.
        with self.lock:
            self._load_state_locked(arrays)

    def _load_state_locked(self, arrays: Dict[str, np.ndarray]) -> None:
        n = int(arrays["ids"].shape[0])
        self.count = 0
        # checkpoints are hot-tier-only: cold rows rebuild from the store
        # via the startup reconcile (they spill again past the cap)
        self.cold = None
        # IVF is derived from the (old) row positions — always invalidate
        self.ivf = None
        self._ivf_overflow_host = np.zeros(0, dtype=np.int32)
        self._cancel_migration_locked()
        self._pos_gen += 1
        cap = max(self.capacity, _next_pow2(max(n, 8)))
        self.capacity = cap
        if _oplog is not None:
            _oplog.emit("alloc", {"corpus": self.name, "cap": int(cap)})
        self._alloc_device(cap)
        self.h_ids = np.zeros(cap, dtype=np.int64)
        self.h_call = np.zeros(cap, dtype=np.int32)
        self.h_started = np.full(cap, INT32_MIN, dtype=np.int32)
        self.h_has_emb = np.zeros(cap, dtype=bool)
        if n:
            padded = _next_pow2(n)
            started = np.full(padded, INT32_MIN, dtype=np.int32)
            started[:n] = arrays["started"]
            emb_p = self._encode_emb(_pad_rows(arrays["emb"], padded))
            lex_p = _pad_rows(arrays["lex"].astype(np.int8), padded)
            tech_p = _pad_rows(arrays["tech"].astype(np.int32), padded)
            call_p = _pad_rows(arrays["call"].astype(np.int32), padded)
            has_p = _pad_rows(arrays["has_emb"].astype(bool), padded)
            if _oplog is not None:
                _oplog.emit(
                    "write_slabs",
                    {"corpus": self.name, "start": 0, "count_after": int(n)},
                    {"emb": emb_p, "lex": lex_p, "tech": tech_p,
                     "call": call_p, "started": started, "has": has_p},
                )
            (self.emb, self.lex, self.tech, self.call_idx, self.started,
             self.has_emb) = _write_all_slabs(
                self.emb, self.lex, self.tech, self.call_idx, self.started,
                self.has_emb,
                _stage(emb_p),
                _stage(lex_p), _stage(tech_p), _stage(call_p),
                _stage(started), _stage(has_p),
                0,
            )
            self.h_ids[:n] = arrays["ids"]
            self.h_call[:n] = arrays["call"]
            self.h_started[:n] = arrays["started"]
            self.h_has_emb[:n] = arrays["has_emb"]
        self.doc_freq = arrays["doc_freq"].astype(np.int64)
        self.dl_sum = int(arrays["dl_sum"][0])
        started_arr = arrays["started"].astype(np.int32)
        self._id_to_pos = {
            int(d): p for p, d in enumerate(arrays["ids"])
            # tombstoned rows restore as tombstones; their ids must not
            # resolve (a re-delete would double-count, a backfill would
            # write into a dead row)
            if started_arr[p] != INT32_MIN
        }
        self.emb_rows = int(arrays["has_emb"].astype(bool).sum())
        self.tombstones = int(
            (arrays["started"].astype(np.int32) == INT32_MIN).sum()
        )
        self.count = n

    def load_state_streaming(
        self,
        shards,                       # iterable of {ROW_KEYS: np.ndarray}
        doc_freq: np.ndarray,
        dl_sum: int,
        total_rows: int,
    ) -> None:
        """Streaming restore: one H2D slab write per shard, enqueued as each
        shard arrives — disk reads of shard i+1 overlap the (async) device
        transfer of shard i, and the host never materializes the whole
        corpus (load_state's concatenate peaks at full-corpus host bytes).
        Shards must arrive in row order and carry the keys of
        checkpoint.ROW_KEYS (emb already decoded to the storage dtype)."""
        with self.lock:
            n = int(total_rows)
            self.count = 0
            self.cold = None  # hot-only checkpoints; see state_arrays
            self.ivf = None
            self._ivf_overflow_host = np.zeros(0, dtype=np.int32)
            self._cancel_migration_locked()
            self._pos_gen += 1
            cap = max(self.capacity, _next_pow2(max(n, 8)))
            self.capacity = cap
            if _oplog is not None:
                _oplog.emit("alloc", {"corpus": self.name, "cap": int(cap)})
            self._alloc_device(cap)
            self.h_ids = np.zeros(cap, dtype=np.int64)
            self.h_call = np.zeros(cap, dtype=np.int32)
            self.h_started = np.full(cap, INT32_MIN, dtype=np.int32)
            self.h_has_emb = np.zeros(cap, dtype=bool)
            off = 0
            for shard in shards:
                m = int(shard["ids"].shape[0])
                if m == 0:
                    continue
                # exact-size slabs (no pow2 padding): a padded slab near the
                # tail could clamp past capacity and overwrite earlier rows;
                # shard sizes are uniform (+1 tail size) so this costs at
                # most two jit variants per restore
                emb_s = self._encode_emb(shard["emb"])
                lex_s = shard["lex"].astype(np.int8)
                tech_s = shard["tech"].astype(np.int32)
                call_s = shard["call"].astype(np.int32)
                started_s = shard["started"].astype(np.int32)
                has_s = shard["has_emb"].astype(bool)
                if _oplog is not None:
                    _oplog.emit(
                        "write_slabs",
                        {"corpus": self.name, "start": int(off),
                         "count_after": int(off + m)},
                        {"emb": emb_s, "lex": lex_s, "tech": tech_s,
                         "call": call_s, "started": started_s, "has": has_s},
                    )
                (self.emb, self.lex, self.tech, self.call_idx, self.started,
                 self.has_emb) = _write_all_slabs(
                    self.emb, self.lex, self.tech, self.call_idx,
                    self.started, self.has_emb,
                    _stage(emb_s),
                    _stage(lex_s),
                    _stage(tech_s),
                    _stage(call_s),
                    _stage(started_s),
                    _stage(has_s),
                    off,
                )
                self.h_ids[off:off + m] = shard["ids"]
                self.h_call[off:off + m] = shard["call"]
                self.h_started[off:off + m] = shard["started"]
                self.h_has_emb[off:off + m] = shard["has_emb"].astype(bool)
                off += m
            if off != n:
                raise ValueError(
                    f"{self.name}: checkpoint shards carried {off} rows, "
                    f"meta says {n}"
                )
            self.doc_freq = doc_freq.astype(np.int64)
            self.dl_sum = int(dl_sum)
            started = self.h_started[:n]
            self._id_to_pos = {
                int(d): p for p, d in enumerate(self.h_ids[:n])
                if started[p] != INT32_MIN
            }
            self.emb_rows = int(self.h_has_emb[:n].sum())
            self.tombstones = int((started == INT32_MIN).sum())
            self.count = n

    # -- query -------------------------------------------------------------
    def query(
        self,
        q_emb: Optional[np.ndarray],      # (B, dim) f32 or None
        q_lex: np.ndarray,                # (B, lex_dim) f32
        q_tech: np.ndarray,               # (B, Q) int32
        allowed_calls: np.ndarray,        # (B, C) bool
        date_min: np.ndarray,             # (B,) int32
        date_max: np.ndarray,             # (B,) int32
        *,
        k_dense: int,
        k_lex: int,
        k_tech: int,
        dense_mode: str = "exact",
        recall_target: Optional[float] = None,
    ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """Runs the fused program; returns per-lane rectangular
        (doc_ids, scores, counts) blocks. Empty index -> empty lanes
        (the SAME 3-tuple contract as the populated path — a divergent
        2-tuple here armed an unpack crash for any caller without the
        count guard)."""
        if self.count == 0:
            return self.empty_lanes(q_lex.shape[0], q_emb is not None)

        with self.lock:
            # Hold for the full dispatch: inserts DONATE the old buffers,
            # which would invalidate array references a concurrent reader
            # has already captured ("Array has been deleted").
            return self._query_locked(
                q_emb, q_lex, q_tech, allowed_calls, date_min, date_max,
                k_dense=k_dense, k_lex=k_lex, k_tech=k_tech,
                dense_mode=dense_mode, recall_target=recall_target,
            )

    def _query_locked(
        self, q_emb, q_lex, q_tech, allowed_calls, date_min, date_max,
        *, k_dense, k_lex, k_tech, dense_mode, recall_target,
    ):
        batch = q_lex.shape[0]
        dense_enabled = q_emb is not None
        k_dense_c = min(k_dense, self.capacity)
        k_lex_c = min(k_lex, self.capacity)
        k_tech_c = min(k_tech, self.capacity)
        if _multiprocess():
            from ..parallel import oplog as oplog_mod

            statics = {
                "k_dense": k_dense_c, "k_lex": k_lex_c, "k_tech": k_tech_c,
                "dense_mode": dense_mode,
                "recall_target": float(
                    recall_target if recall_target is not None
                    else settings.ann_recall_target
                ),
                "dense_enabled": dense_enabled,
            }
            q_emb_np = np.asarray(
                q_emb if dense_enabled
                else np.zeros((batch, self.dim), np.float32),
                dtype=np.float32,
            )
            payload = {
                "q_emb": q_emb_np,
                "q_lex": np.asarray(q_lex, dtype=np.float32),
                "q_tech": np.asarray(q_tech, dtype=np.int32),
                "allowed": np.asarray(allowed_calls, dtype=bool),
                "dmin": np.asarray(date_min, dtype=np.int32),
                "dmax": np.asarray(date_max, dtype=np.int32),
            }
            if _oplog is not None:
                _oplog.emit(
                    "query_single",
                    {"corpus": self.name, "statics": statics}, payload,
                )
            out = oplog_mod.single_query(
                self, payload["q_emb"], payload["q_lex"], payload["q_tech"],
                payload["allowed"], payload["dmin"], payload["dmax"],
                statics,
            )
            return self.postprocess_lanes(jax.device_get(out), batch)
        out = multi_lane_retrieve(
            self.emb, self.lex, self.tech, self.call_idx, self.started,
            self.has_emb,
            jnp.asarray(q_emb if dense_enabled
                        else np.zeros((batch, self.dim), np.float32)),
            jnp.asarray(q_lex), jnp.asarray(q_tech),
            jnp.asarray(allowed_calls),
            jnp.asarray(date_min), jnp.asarray(date_max),
            k_dense=k_dense_c, k_lex=k_lex_c, k_tech=k_tech_c,
            dense_mode=dense_mode,
            recall_target=float(
                recall_target
                if recall_target is not None
                else settings.ann_recall_target
            ),
            dense_enabled=dense_enabled,
        )
        return self.postprocess_lanes(jax.device_get(out), batch)

    def postprocess_lanes(
        self, out: Dict[str, Tuple[jax.Array, jax.Array]], batch: int,
        h_ids: Optional[np.ndarray] = None, count: Optional[int] = None,
    ) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Map device positions -> doc ids, RECTANGULAR: per lane
        (ids (B,k) i64, scores (B,k) f32, counts (B,) i32) where each
        row's first ``counts[b]`` entries are valid (scores arrive sorted
        desc with -inf sentinels last, so validity is a prefix). Fully
        vectorized — the previous per-row ragged split cost ~2 ms per
        128-query batch and forced a per-plan rebuild in the RRF merge.
        Callers running outside the corpus lock pass the (h_ids, count)
        snapshot captured at dispatch time — compaction REPLACES h_ids, so
        the snapshot stays position-consistent with the dispatched
        arrays."""
        if h_ids is None:
            h_ids = self.h_ids
        if count is None:
            count = self.count
        result: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        for lane, (scores, pos) in out.items():
            scores = np.asarray(scores)
            pos = np.asarray(pos)
            keep = np.isfinite(scores) & (pos >= 0) & (pos < count)
            ids_all = h_ids[np.where(keep, pos, 0)]
            scores_f32 = scores.astype(np.float32, copy=False)
            counts = keep.sum(axis=1, dtype=np.int32)
            if keep.shape[1] and not bool(
                (keep[:, :-1] >= keep[:, 1:]).all()
            ):
                # Defensive: scores arrive sorted desc with -inf sentinels
                # last, so `keep` is a prefix mask by construction. If a
                # program change ever violates that, compact per row so
                # the rectangular (block, counts) contract stays valid.
                ids_fix = np.full_like(ids_all, -1)
                scores_fix = np.full_like(scores_f32, -np.inf)
                for b in range(batch):
                    n = int(counts[b])
                    ids_fix[b, :n] = ids_all[b][keep[b]]
                    scores_fix[b, :n] = scores_f32[b][keep[b]]
                ids_all, scores_f32 = ids_fix, scores_fix
            result[lane] = (ids_all.astype(np.int64, copy=False),
                            scores_f32, counts)
        return result

    def postprocess_merged(
        self,
        merged: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
        h_ids: Optional[np.ndarray] = None,
        count: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Device-fused RRF output -> host rect merged block:
        (fused f32 (B,K), positions i32 (B,K), lane-masks i32 (B,K),
        counts (B,)) -> (doc_ids i64 (B,K), scores f64 (B,K),
        masks u8 (B,K), counts i32 (B,)). The device already excluded
        invalid rows (started_sec sentinel masks) and sorted by
        (-score, first-occurrence); the position->count clamp here is the
        same defensive guard as postprocess_lanes (a compaction racing
        the dispatch renumbers rows — the snapshot keeps consistency)."""
        if h_ids is None:
            h_ids = self.h_ids
        if count is None:
            count = self.count
        fused, pos, masks, counts = merged
        counts = counts.astype(np.int32, copy=False)
        K = pos.shape[1]
        in_prefix = np.arange(K)[None, :] < counts[:, None]
        keep = in_prefix & (pos >= 0) & (pos < count)
        if not bool((keep == in_prefix).all()):
            # snapshot race (rare): drop out-of-range rows, recompact
            counts = keep.sum(axis=1, dtype=np.int32)
            ids_fix = np.zeros(pos.shape, dtype=np.int64)
            scores_fix = np.zeros(pos.shape, dtype=np.float64)
            masks_fix = np.zeros(pos.shape, dtype=np.uint8)
            ids_all = h_ids[np.where(keep, pos, 0)]
            for b in range(pos.shape[0]):
                n = int(counts[b])
                row_keep = keep[b]
                ids_fix[b, :n] = ids_all[b][row_keep]
                scores_fix[b, :n] = fused[b][row_keep].astype(np.float64)
                masks_fix[b, :n] = masks[b][row_keep].astype(np.uint8)
            return ids_fix, scores_fix, masks_fix, counts
        ids = h_ids[np.where(keep, pos, 0)].astype(np.int64, copy=False)
        return (
            ids, fused.astype(np.float64),
            masks.astype(np.uint8, copy=False), counts,
        )

    def device_arrays(self) -> Tuple[jax.Array, ...]:
        return (self.emb, self.lex, self.tech, self.call_idx, self.started,
                self.has_emb)

    def empty_lanes(self, batch: int, dense_enabled: bool):
        empty = (np.zeros((batch, 0), dtype=np.int64),
                 np.zeros((batch, 0), dtype=np.float32),
                 np.zeros(batch, dtype=np.int32))
        lanes = {"lex": empty, "tech": empty}
        if dense_enabled:
            lanes["dense"] = empty
        return lanes


@dataclasses.dataclass
class PackedDispatch:
    """An in-flight fused-program dispatch: the flat device-output future
    (ONE array = one D2H transfer; ops/pack.unflatten_lanes splits it)
    plus the host-mirror snapshot postprocess needs. ``extra_dense``
    carries an out-of-program dense result (the separate IVF dispatch).
    ``ready`` carries immediate results for paths that had to block
    (cold start, multi-process)."""

    flat_raw: object = None
    sig: object = None                  # QuerySignature: the flat layout key
    # the dense mode that actually SERVED the chunks corpus ("ivf" may
    # downgrade to "ann" at dispatch when a compaction invalidated the
    # index between planning and execution) — response notes/debug must
    # report this, not the planned mode
    served_chunk_mode: object = None
    extra_dense: object = None          # optional (scores, pos) device pair
    chunk_snap: Tuple[np.ndarray, int] = (None, 0)  # type: ignore[assignment]
    artifact_snap: Tuple[np.ndarray, int] = (None, 0)  # type: ignore[assignment]
    batch: int = 0
    ready: Optional[Tuple[Dict, Dict]] = None
    # in-flight cold-tier block scans per corpus (core/coldtier.py):
    # [(lane_futures, ids_snapshot, block_rows)], merged at collect
    cold_chunks: list = dataclasses.field(default_factory=list)
    cold_artifacts: list = dataclasses.field(default_factory=list)
    cold_ks: Optional[Tuple[Tuple[int, int, int], Tuple[int, int, int]]] = None


class DeviceIndexManager:
    """Both corpora + the call registry capacity used for filter bitmaps."""

    def __init__(self) -> None:
        cap = int(settings.index_initial_capacity)
        self.mesh = None
        row_sharding = None
        if settings.mesh_shape.strip():
            from jax.sharding import NamedSharding, PartitionSpec

            from ..parallel.mesh import make_mesh

            self.mesh = make_mesh(settings.mesh_shape)
            data_rows = self.mesh.shape.get("data", 1)
            if cap % max(data_rows, 1):
                raise ValueError(
                    f"INDEX_INITIAL_CAPACITY {cap} must divide the mesh's "
                    f"data axis ({data_rows})"
                )
            row_sharding = NamedSharding(self.mesh, PartitionSpec("data", None))
        self.chunks = CorpusIndex(
            "chunks",
            dim=int(settings.embeddings_dim),
            lex_dim=int(settings.lexical_dim),
            tech_slots=int(settings.tech_hash_slots),
            capacity=cap,
            emb_dtype=settings.index_embedding_dtype,
            row_sharding=row_sharding,
        )
        self.artifacts = CorpusIndex(
            "artifact_chunks",
            dim=int(settings.embeddings_dim),
            lex_dim=int(settings.lexical_dim),
            tech_slots=int(settings.tech_hash_slots),
            capacity=cap,
            emb_dtype=settings.index_embedding_dtype,
            row_sharding=row_sharding,
        )
        if _multiprocess():
            # Lockstep invariant: the op-log is a valid serialization of
            # the leader's device enqueue order ONLY if no two leader
            # threads can interleave emit->enqueue windows of different
            # collective-bearing programs (ADVICE r4 medium: a background
            # gang IVF build holding just the chunks lock could cross-order
            # with an artifacts compaction holding just the artifacts
            # lock; followers replay in log order -> gang deadlock).
            # Under a multi-process mesh the two corpora share ONE RLock,
            # making every emit+enqueue pair leader-wide atomic by
            # construction. Single-process keeps separate locks (more
            # host concurrency; no log to keep consistent).
            self.artifacts.lock = self.chunks.lock
        self.call_capacity = 256
        from .prewarm import GrowthPrewarmer

        # Compiles the next capacity's fused program in the background
        # before growth needs it (the recompile guard; core/prewarm.py).
        self.prewarmer = GrowthPrewarmer(self)
        self.chunks._on_insert = self._after_insert
        self.artifacts._on_insert = self._after_insert
        self.chunks._grow_planner = self.prewarmer.growth_cap
        self.artifacts._grow_planner = self.prewarmer.growth_cap

    def _after_insert(self) -> None:
        self.prewarmer.maybe_prewarm()

    def ensure_call_capacity(self, n_calls: int) -> None:
        while self.call_capacity < n_calls:
            self.call_capacity *= 2

    def query_both(
        self,
        q_emb: Optional[np.ndarray],
        chunk_q_lex: np.ndarray,
        artifact_q_lex: np.ndarray,
        q_tech: np.ndarray,
        allowed_calls: np.ndarray,
        date_min: np.ndarray,
        date_max: np.ndarray,
        *,
        chunk_ks: Tuple[int, int, int],
        artifact_ks: Tuple[int, int, int],
        chunk_mode: str,
        artifact_mode: str,
        recall_target: float,
    ) -> Tuple[Dict, Dict]:
        """Six lanes over both corpora in ONE device dispatch (the /retrieve
        hot path). Falls back to per-corpus calls while either corpus is
        still empty (cold start)."""
        batch = chunk_q_lex.shape[0]
        dense_enabled = q_emb is not None
        # Hold BOTH corpus locks (fixed order) for the full device dispatch:
        # donated inserts invalidate buffers concurrent readers hold.
        with self.chunks.lock, self.artifacts.lock:
            return self._query_both_locked(
                q_emb, chunk_q_lex, artifact_q_lex, q_tech, allowed_calls,
                date_min, date_max, chunk_ks=chunk_ks,
                artifact_ks=artifact_ks, chunk_mode=chunk_mode,
                artifact_mode=artifact_mode, recall_target=recall_target,
                batch=batch, dense_enabled=dense_enabled,
            )

    def _resolve_chunk_dense(
        self, chunk_mode, dense_enabled, q_emb, allowed_calls,
        date_min, date_max, k_dense,
    ):
        """Resolve the chunks-corpus dense mode under the lock (shared by
        the packed hot path and the cold-start fallback so the two can't
        drift): an invalidated IVF falls back to ann; a live IVF serves
        the dense lane in its own dispatch and the fused program skips it
        ("none"). Returns (mode, ivf_dense_result_or_None)."""
        ivf_ok = (
            dense_enabled and chunk_mode == "ivf"
            and self.chunks.ivf is not None  # may have been invalidated
        )
        if dense_enabled and chunk_mode == "ivf" and not ivf_ok:
            return "ann", None
        if ivf_ok:
            return "none", self.chunks.ivf_dense_query(
                q_emb, allowed_calls, date_min, date_max, k_dense
            )
        return chunk_mode, None

    def _query_both_locked(
        self, q_emb, chunk_q_lex, artifact_q_lex, q_tech, allowed_calls,
        date_min, date_max, *, chunk_ks, artifact_ks, chunk_mode,
        artifact_mode, recall_target, batch, dense_enabled,
    ):
        if self.chunks.count == 0 or self.artifacts.count == 0:
            # The separate-dispatch IVF path rides the packed branch only;
            # in this (rare: one corpus still empty) fallback a planner
            # "ivf" choice serves as ann — same lanes, approx top-k.
            if chunk_mode == "ivf":
                chunk_mode = "ann"
            chunks_out = (
                self.chunks.query(
                    q_emb, chunk_q_lex, q_tech, allowed_calls, date_min,
                    date_max, k_dense=chunk_ks[0], k_lex=chunk_ks[1],
                    k_tech=chunk_ks[2], dense_mode=chunk_mode,
                    recall_target=recall_target,
                )
                if self.chunks.count
                else self.chunks.empty_lanes(batch, dense_enabled)
            )
            artifacts_out = (
                self.artifacts.query(
                    q_emb, artifact_q_lex, q_tech, allowed_calls, date_min,
                    date_max, k_dense=artifact_ks[0], k_lex=artifact_ks[1],
                    k_tech=artifact_ks[2], dense_mode=artifact_mode,
                    recall_target=recall_target,
                )
                if self.artifacts.count
                else self.artifacts.empty_lanes(batch, dense_enabled)
            )
            return chunks_out, artifacts_out

        if _multiprocess():
            raise RuntimeError(
                "multi-host serving dispatches through query_both_packed "
                "(mirrored op-log); the unpacked dual-corpus path is "
                "single-process only — parallel/oplog.py"
            )
        q_emb_arr = jnp.asarray(
            q_emb if dense_enabled
            else np.zeros((batch, self.chunks.dim), np.float32)
        )
        chunk_mode, ivf_dense = self._resolve_chunk_dense(
            chunk_mode, dense_enabled, q_emb, allowed_calls, date_min,
            date_max, chunk_ks[0],
        )
        chunks_raw, artifacts_raw = dual_corpus_retrieve(
            self.chunks.device_arrays(),
            self.artifacts.device_arrays(),
            q_emb_arr,
            jnp.asarray(chunk_q_lex.astype(np.float32)),
            jnp.asarray(artifact_q_lex.astype(np.float32)),
            jnp.asarray(q_tech),
            jnp.asarray(allowed_calls),
            jnp.asarray(date_min),
            jnp.asarray(date_max),
            chunk_ks=_clamp_ks(chunk_ks, self.chunks.capacity),
            artifact_ks=_clamp_ks(artifact_ks, self.artifacts.capacity),
            chunk_mode=chunk_mode,
            artifact_mode=artifact_mode,
            recall_target=float(recall_target),
            dense_enabled=dense_enabled,
        )
        if ivf_dense is not None:
            chunks_raw = dict(chunks_raw)
            chunks_raw["dense"] = ivf_dense
        # ONE device->host transfer for all lane outputs: each np.asarray on
        # a device array is a separate synchronizing copy.
        chunks_np, artifacts_np = jax.device_get((chunks_raw, artifacts_raw))
        return (
            self.chunks.postprocess_lanes(chunks_np, batch),
            self.artifacts.postprocess_lanes(artifacts_np, batch),
        )

    def _dispatch_multiprocess(self, sig, chunk_mode: str, packed: np.ndarray):
        """Multi-host dispatch: mirror the query to followers, then run
        the replicated-output program (parallel/oplog.py). Called under
        both corpus locks so the op-log order matches enqueue order."""
        from ..parallel import oplog as oplog_mod

        statics = {
            "batch": sig.batch, "emb_dim": sig.emb_dim,
            "q_feats": sig.q_feats, "tech_q": sig.tech_q,
            "n_calls": sig.n_calls,
            "chunk_ks": list(sig.chunk_ks),
            "artifact_ks": list(sig.artifact_ks),
            "chunk_mode": chunk_mode,
            "artifact_mode": sig.artifact_mode,
            "recall_target": sig.recall_target,
            "dense_enabled": sig.dense_enabled,
            "fuse_rrf": sig.fuse_rrf,
        }
        if _oplog is not None:
            _oplog.emit("query_packed",
                        {"corpus": "chunks", "statics": statics},
                        {"packed": packed})
        return oplog_mod.packed_query(
            self.chunks.device_arrays(),
            self.artifacts.device_arrays(),
            packed, statics,
        )

    def query_both_packed(
        self,
        q_emb: Optional[np.ndarray],          # (B, dim) f32 or None
        q_lex_feats: Sequence,                # per-plan (buckets, signs, tfs)
        q_tech: np.ndarray,
        allowed_calls: np.ndarray,
        date_min: np.ndarray,
        date_max: np.ndarray,
        *,
        chunk_ks: Tuple[int, int, int],
        artifact_ks: Tuple[int, int, int],
        chunk_mode: str,
        artifact_mode: str,
        recall_target: float,
    ) -> Tuple[Dict, Dict]:
        """The /retrieve hot path, blocking form: dispatch + collect."""
        return self.collect_packed(self.query_both_packed_async(
            q_emb, q_lex_feats, q_tech, allowed_calls, date_min, date_max,
            chunk_ks=chunk_ks, artifact_ks=artifact_ks,
            chunk_mode=chunk_mode, artifact_mode=artifact_mode,
            recall_target=recall_target,
        ))

    def query_both_packed_async(
        self,
        q_emb: Optional[np.ndarray],          # (B, dim) f32 or None
        q_lex_feats: Sequence,                # per-plan (buckets, signs, tfs)
        q_tech: np.ndarray,
        allowed_calls: np.ndarray,
        date_min: np.ndarray,
        date_max: np.ndarray,
        *,
        chunk_ks: Tuple[int, int, int],
        artifact_ks: Tuple[int, int, int],
        chunk_mode: str,
        artifact_mode: str,
        recall_target: float,
        fuse_rrf: bool = False,
    ) -> "PackedDispatch":
        """ONE packed H2D transfer + one ENQUEUE for all six lanes over
        both corpora, returning a handle WITHOUT blocking on the device —
        jax arrays are futures, so a caller can enqueue the next batch
        while this one computes, then ``collect_packed`` when it needs
        the results. Single-thread async pipelining keeps the device fed
        while the host prepares the next batch."""
        from ..ops.pack import (
            dual_corpus_retrieve_packed,
            pack_queries,
            sparse_lex_rows,
        )

        batch = q_tech.shape[0]
        dense_enabled = q_emb is not None
        F = int(settings.query_lex_features)
        if self.chunks.count == 0 or self.artifacts.count == 0:
            # cold start: the per-corpus fallback path (rare; not packed)
            chunk_q_lex = np.stack([
                _dense_query_vector(f, self.chunks) for f in q_lex_feats
            ])
            artifact_q_lex = np.stack([
                _dense_query_vector(f, self.artifacts) for f in q_lex_feats
            ])
            ready = self.query_both(
                q_emb, chunk_q_lex, artifact_q_lex, q_tech, allowed_calls,
                date_min, date_max, chunk_ks=chunk_ks,
                artifact_ks=artifact_ks, chunk_mode=chunk_mode,
                artifact_mode=artifact_mode, recall_target=recall_target,
            )
            ready = self._merge_cold_ready(
                ready, q_emb, q_lex_feats, q_tech, allowed_calls,
                date_min, date_max, chunk_ks, artifact_ks, chunk_mode,
                artifact_mode, recall_target, batch,
            )
            return PackedDispatch(
                ready=ready,
                # the empty-corpus fallback inside query_both serves a
                # planner "ivf" choice as ann (_query_both_locked)
                served_chunk_mode=(
                    "ann" if chunk_mode == "ivf" else chunk_mode
                ),
            )

        # idf uses LIVE counts: delete_ids sheds df mass, so counting
        # tombstoned rows in n_docs would skew BM25 idf until compaction
        chunk_sparse = sparse_lex_rows(
            q_lex_feats, self.chunks.doc_freq, self.chunks.live_count, F
        )
        artifact_sparse = sparse_lex_rows(
            q_lex_feats, self.artifacts.doc_freq, self.artifacts.live_count, F
        )
        packed = pack_queries(
            q_emb, chunk_sparse, artifact_sparse, q_tech, allowed_calls,
            date_min, date_max,
        )
        # H2D OUTSIDE the locks: the transfer references no corpus buffer,
        # so concurrent batches overlap their uploads with the current
        # batch's compute.
        # (Multi-process: stays numpy — jit stages it replicated on every
        # process; see _stage.)
        d_packed = _stage(packed)
        # Pre-stage the separate IVF dispatch's inputs too: its H2D
        # otherwise runs INSIDE the critical section below (holding both
        # corpus locks per IVF batch, serializing inserts and the next
        # batch's enqueue behind a transfer that references no corpus
        # buffer). jnp.asarray on an
        # already-device array is a no-op inside ivf_dense_query.
        # (IVF is single-process-only; multi-process keeps numpy.)
        if dense_enabled and chunk_mode == "ivf" and not _multiprocess():
            q_emb = jnp.asarray(q_emb)
            allowed_calls = jnp.asarray(allowed_calls)
            date_min = jnp.asarray(date_min)
            date_max = jnp.asarray(date_max)
        # Locks are held only from CAPTURING the array handles to ENQUEUE:
        # the donated-insert hazard is an insert deleting a handle between
        # capture and dispatch. Once the program is enqueued the runtime
        # orders a later donation after the query's reads, so the blocking
        # device_get happens OUTSIDE the locks — inserts and the next
        # batch's dispatch overlap with this batch's device time.
        from .prewarm import QuerySignature

        with self.chunks.lock, self.artifacts.lock:
            chunk_mode, ivf_dense = self._resolve_chunk_dense(
                chunk_mode, dense_enabled, q_emb, allowed_calls, date_min,
                date_max, chunk_ks[0],
            )
            # Device-fused RRF needs every lane in the main program and
            # all candidates in the hot tier: a separate IVF dense
            # dispatch ("none") or a cold tier (host-side per-lane merge
            # precedes RRF) falls back to the host merge path.
            fuse_rrf = bool(
                fuse_rrf
                and chunk_mode != "none"
                and (self.chunks.cold is None or self.chunks.cold.count == 0)
                and (self.artifacts.cold is None
                     or self.artifacts.cold.count == 0)
            )
            sig = QuerySignature(
                batch=batch,
                emb_dim=self.chunks.dim if dense_enabled else 1,
                q_feats=F, tech_q=q_tech.shape[1],
                n_calls=allowed_calls.shape[1],
                chunk_ks=_clamp_ks(chunk_ks, self.chunks.capacity),
                artifact_ks=_clamp_ks(artifact_ks, self.artifacts.capacity),
                chunk_mode=chunk_mode, artifact_mode=artifact_mode,
                recall_target=float(recall_target),
                dense_enabled=dense_enabled,
                packed_bytes=int(packed.shape[0]),
                dim=self.chunks.dim, lex_dim=self.chunks.lex_dim,
                tech_slots=self.chunks.tech_slots,
                emb_dtype=str(self.chunks.emb_dtype),
                fuse_rrf=fuse_rrf,
            )
            if _multiprocess():
                flat_raw = self._dispatch_multiprocess(
                    sig, chunk_mode, packed
                )
                compiled = _MULTIPROCESS_DISPATCHED
            else:
                # post-growth fast path: run the prewarmed AOT executable
                # (the jitted call would recompile — AOT compiles don't
                # populate the jit dispatch cache)
                compiled = self.prewarmer.get_compiled(
                    sig, self.chunks.capacity, self.artifacts.capacity
                )
            if compiled is _MULTIPROCESS_DISPATCHED:
                pass
            elif compiled is not None:
                if self.chunks.row_sharding is not None:
                    # AOT executables take inputs at their compiled
                    # shardings verbatim (no jit auto-resharding): the
                    # packed buffer was lowered replicated over the mesh
                    from jax.sharding import NamedSharding, PartitionSpec

                    d_packed = jax.device_put(
                        d_packed,
                        NamedSharding(
                            self.chunks.row_sharding.mesh, PartitionSpec()
                        ),
                    )
                flat_raw = compiled(
                    self.chunks.device_arrays(),
                    self.artifacts.device_arrays(),
                    d_packed,
                )
            else:
                flat_raw = dual_corpus_retrieve_packed(
                    self.chunks.device_arrays(),
                    self.artifacts.device_arrays(),
                    d_packed,
                    batch=batch,
                    emb_dim=sig.emb_dim,
                    q_feats=F,
                    tech_q=q_tech.shape[1],
                    n_calls=allowed_calls.shape[1],
                    chunk_ks=sig.chunk_ks,
                    artifact_ks=sig.artifact_ks,
                    chunk_mode=chunk_mode,
                    artifact_mode=artifact_mode,
                    recall_target=float(recall_target),
                    dense_enabled=dense_enabled,
                    fuse_rrf=fuse_rrf,
                )
            # snapshot the host-mirror state the postprocess needs while
            # still under the lock (a concurrent compact() REPLACES h_ids
            # and renumbers positions)
            chunk_snap = (self.chunks.h_ids, self.chunks.count)
            artifact_snap = (self.artifacts.h_ids, self.artifacts.count)
            # beyond-HBM cold tier: enqueue block scans behind the hot
            # program (still under the locks — the jit stages each host
            # block eagerly, so later inserts can't corrupt the scan)
            cold_chunks, cold_artifacts = self._dispatch_cold_locked(
                q_emb, q_lex_feats, q_tech, allowed_calls, date_min,
                date_max, chunk_ks, artifact_ks, chunk_mode,
                artifact_mode, recall_target,
            )
        if settings.readback_prefetch_enabled:
            # Enqueue the D2H copy NOW so it is queued behind the execute:
            # host work between dispatch and collect then overlaps the
            # readback instead of preceding its request. Non-blocking.
            for leaf in jax.tree_util.tree_leaves((flat_raw, ivf_dense)):
                try:
                    leaf.copy_to_host_async()
                except AttributeError:
                    pass
        self.prewarmer.note_signature(sig)
        self.prewarmer.maybe_prewarm()
        return PackedDispatch(
            flat_raw=flat_raw,
            sig=sig,
            # resolved under the lock: "none" means the separate IVF
            # dispatch carries the dense lane
            served_chunk_mode=(
                "ivf" if chunk_mode == "none" else chunk_mode
            ),
            extra_dense=ivf_dense,
            chunk_snap=chunk_snap,
            artifact_snap=artifact_snap,
            batch=batch,
            cold_chunks=cold_chunks,
            cold_artifacts=cold_artifacts,
            cold_ks=(chunk_ks, artifact_ks),
        )

    def _dispatch_cold_locked(
        self, q_emb, q_lex_feats, q_tech, allowed_calls, date_min,
        date_max, chunk_ks, artifact_ks, chunk_mode, artifact_mode,
        recall_target,
    ) -> Tuple[list, list]:
        """Enqueue cold-tier block scans for corpora with spilled rows
        (caller holds both corpus locks). Dense query vectors for the
        cold program densify on host from the same sparse features —
        corpus-wide df/live_count keep hot and cold scores identical."""
        out = []
        for corpus, ks, mode in (
            (self.chunks, chunk_ks, chunk_mode),
            (self.artifacts, artifact_ks, artifact_mode),
        ):
            tier = corpus.cold
            if tier is None or tier.count == 0:
                out.append([])
                continue
            q_lex_dense = np.stack([
                _dense_query_vector(f, corpus) for f in q_lex_feats
            ])
            out.append(tier.dispatch(
                q_emb, q_lex_dense, q_tech, allowed_calls,
                np.asarray(date_min, np.int32),
                np.asarray(date_max, np.int32),
                ks=ks, dense_mode=mode,
                recall_target=float(recall_target),
                block_rows=int(settings.cold_block_rows),
            ))
        return out[0], out[1]

    def _merge_cold_ready(
        self, ready, q_emb, q_lex_feats, q_tech, allowed_calls, date_min,
        date_max, chunk_ks, artifact_ks, chunk_mode, artifact_mode,
        recall_target, batch,
    ):
        """Synchronous cold merge for the blocking fallback path."""
        if (self.chunks.cold is None or self.chunks.cold.count == 0) and (
            self.artifacts.cold is None or self.artifacts.cold.count == 0
        ):
            return ready
        from .coldtier import collect_cold, merge_rect_lanes

        with self.chunks.lock, self.artifacts.lock:
            cold_chunks, cold_artifacts = self._dispatch_cold_locked(
                q_emb, q_lex_feats, q_tech, allowed_calls, date_min,
                date_max, chunk_ks, artifact_ks, chunk_mode,
                artifact_mode, recall_target,
            )
        chunks_rect, artifacts_rect = ready
        if cold_chunks:
            chunks_rect = merge_rect_lanes(
                chunks_rect, collect_cold(self.chunks, cold_chunks, batch),
                {"dense": chunk_ks[0], "lex": chunk_ks[1],
                 "tech": chunk_ks[2]},
            )
        if cold_artifacts:
            artifacts_rect = merge_rect_lanes(
                artifacts_rect,
                collect_cold(self.artifacts, cold_artifacts, batch),
                {"dense": artifact_ks[0], "lex": artifact_ks[1],
                 "tech": artifact_ks[2]},
            )
        return chunks_rect, artifacts_rect

    def collect_packed(self, disp: "PackedDispatch") -> Tuple[Dict, Dict]:
        """Block on a dispatched query (ONE flat device->host transfer for
        all lane outputs — every extra device array fetched is its own
        copy) and map positions -> doc ids."""
        from ..ops.pack import unflatten_lanes

        if disp.ready is not None:
            return disp.ready
        flat_np, extra_np = jax.device_get((disp.flat_raw, disp.extra_dense))
        sig = disp.sig
        if sig.fuse_rrf:
            from ..ops.pack import unflatten_merged

            chunks_m, artifacts_m = unflatten_merged(
                flat_np,
                chunk_ks=sig.chunk_ks, artifact_ks=sig.artifact_ks,
                chunk_mode=sig.chunk_mode, artifact_mode=sig.artifact_mode,
                dense_enabled=sig.dense_enabled,
            )
            return (
                {"__rrf__": self.chunks.postprocess_merged(
                    chunks_m, *disp.chunk_snap
                )},
                {"__rrf__": self.artifacts.postprocess_merged(
                    artifacts_m, *disp.artifact_snap
                )},
            )
        chunks_np, artifacts_np = unflatten_lanes(
            flat_np,
            chunk_ks=sig.chunk_ks, artifact_ks=sig.artifact_ks,
            chunk_mode=sig.chunk_mode, artifact_mode=sig.artifact_mode,
            dense_enabled=sig.dense_enabled,
        )
        if extra_np is not None:
            chunks_np = dict(chunks_np)
            chunks_np["dense"] = extra_np
        chunks_rect = self.chunks.postprocess_lanes(
            chunks_np, disp.batch, *disp.chunk_snap
        )
        artifacts_rect = self.artifacts.postprocess_lanes(
            artifacts_np, disp.batch, *disp.artifact_snap
        )
        if disp.cold_chunks or disp.cold_artifacts:
            from .coldtier import collect_cold, merge_rect_lanes

            cks, aks = disp.cold_ks
            if disp.cold_chunks:
                chunks_rect = merge_rect_lanes(
                    chunks_rect,
                    collect_cold(self.chunks, disp.cold_chunks, disp.batch),
                    {"dense": cks[0], "lex": cks[1], "tech": cks[2]},
                )
            if disp.cold_artifacts:
                artifacts_rect = merge_rect_lanes(
                    artifacts_rect,
                    collect_cold(
                        self.artifacts, disp.cold_artifacts, disp.batch
                    ),
                    {"dense": aks[0], "lex": aks[1], "tech": aks[2]},
                )
        return chunks_rect, artifacts_rect

    def corpus(self, name: str) -> CorpusIndex:
        if name == "chunks":
            return self.chunks
        if name == "artifact_chunks":
            return self.artifacts
        raise KeyError(name)


def _dense_query_vector(feats, corpus: CorpusIndex) -> np.ndarray:
    from ..ops.hashing import query_vector_from_features

    buckets, signs, tfs = feats
    return query_vector_from_features(
        buckets, signs, tfs, corpus.lex_dim, corpus.doc_freq,
        corpus.live_count,
    )


_index: Optional[DeviceIndexManager] = None
_index_lock = threading.Lock()


def get_index() -> DeviceIndexManager:
    global _index
    with _index_lock:
        if _index is None:
            _index = DeviceIndexManager()
        return _index


def reset_index() -> None:
    global _index
    with _index_lock:
        _index = None
    # the active lexical vocab belongs to the (store, index) pair; a fresh
    # index must not inherit a previous corpus's head layout
    from ..ingest import featurize

    featurize.set_active_vocab(None, 0)
