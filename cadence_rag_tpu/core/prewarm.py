"""Growth-compile prewarmer: compile the NEXT capacity's fused program
before the index doubles into it.

The fused /retrieve program (ops/pack.dual_corpus_retrieve_packed) is
compiled per (corpus capacity, batch, modes, ...) signature; capacity
growth therefore lands a fresh XLA compile on the first query after a
doubling, and under a steady writer that recompile dominates the query
tail.

This module watches fill levels and, once a corpus crosses
``prewarm_fill_fraction`` of capacity, AOT-compiles the doubled-capacity
variant of every recently-served query signature in a background thread
via ``jit(...).lower(ShapeDtypeStruct...).compile()`` — abstract avals
only, so prewarm allocates NO device arrays and takes NO corpus locks.
(Running the program against throwaway zero arrays instead would peak
at several times the corpus bytes mid-growth, when old and new buffers
coexist; AOT lowering allocates no device memory.)

Because AOT compilation does not populate jax's jit dispatch cache, the
dispatch path (core/index.query_both_packed) asks ``get_compiled`` for a
warm executable for its exact signature before falling back to the jitted
call; post-growth queries therefore run the prewarmed binary immediately
(tested: the post-growth dispatch adds no jit cache entry).

Mesh-aware: under a single-process MESH_SHAPE the avals carry the live
arrays' GSPMD shardings (corpus rows sharded over the data axis, packed
query buffer replicated) so the AOT executable accepts the sharded
inputs verbatim. Only multi-PROCESS gangs stand down — their lockstep
dispatch replays through the op-log and never consults the AOT table.

No reference counterpart (Postgres has no compile step); this is the
compiled-program analogue of index warm-up. SURVEY.md §5
failure-detection calls for "device-OOM/recompile guards" — this is the
recompile guard.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import TYPE_CHECKING, Dict, Optional, Set, Tuple

from ..config import settings

if TYPE_CHECKING:  # pragma: no cover
    from .index import DeviceIndexManager

logger = logging.getLogger(__name__)


def free_hbm_bytes():
    """Measured free device memory, or None when the backend doesn't
    report it (the CPU backend). Real numbers beat the static
    PREWARM_HBM_BUDGET_GB stand-in."""
    import jax

    try:
        stats = jax.local_devices()[0].memory_stats()
    except Exception:
        return None
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"]) - int(stats.get("bytes_in_use", 0))


def _corpus_row_bytes(corpus) -> int:
    return (
        corpus.dim * corpus.emb_dtype.itemsize
        + corpus.lex_dim            # int8 signature
        + corpus.tech_slots * 4 + 16  # call/started/has_emb + slack
    )


def plan_next_capacity(corpus, need: int, batch: int = 128,
                       free=None) -> int:
    """The capacity the NEXT growth should allocate: a doubling when it
    fits the device, else the largest fraction-of-capacity step
    (multiples of cap/8) that does. Near the top of device memory a
    doubling cannot fit (old+new buffers coexist) but a 1.125-1.25x step
    can, so growth (and its prewarmed program) keeps working instead of
    standing down. Reads the device's free memory; only the CPU backend,
    which reports none, plans against the static PREWARM_HBM_BUDGET_GB.
    A GPU that reports no memory stats is an error, not a reason to
    guess."""
    cap = corpus.capacity
    doubled = cap
    while doubled < max(need, cap + 1):
        doubled *= 2
    if corpus.row_sharding is not None:
        return doubled  # sharded capacities must divide the mesh
    row = _corpus_row_bytes(corpus)
    if free is None:
        free = free_hbm_bytes()
    if free is None:
        import jax

        if jax.default_backend() != "cpu":
            raise RuntimeError(
                f"the {jax.default_backend()} backend reports no "
                "memory_stats; growth planning needs the device's free "
                "memory"
            )
        budget = float(settings.prewarm_hbm_budget_gb) * (1 << 30)
        # old + new buffers coexist mid-growth; score planes grow by the
        # capacity delta
        def fits(c: int) -> bool:
            return (
                (cap + c) * row + 3 * batch * (c - cap) * 4 <= budget
            )
    else:
        headroom = free * 0.85  # slack for XLA temporaries
        def fits(c: int) -> bool:
            # growth allocates a FULL new buffer set (old stays live
            # until the copy lands and is counted inside bytes_in_use);
            # score planes grow only by the capacity delta
            return c * row + 3 * batch * (c - cap) * 4 <= headroom
    if fits(doubled):
        return doubled
    step = max(cap // 8, 8)
    candidate = cap + step * max(1, -(-(need - cap) // step))
    best = 0
    while candidate < doubled:
        if fits(candidate):
            best = candidate  # largest fitting step wins
        candidate += step
    if best >= max(need, cap + 1):
        return best
    return doubled  # nothing fits: keep the doubling contract; the
    # prewarmer warns and the actual growth surfaces the OOM


@dataclasses.dataclass(frozen=True)
class QuerySignature:
    """Everything (besides corpus capacities) that keys a fused-program
    compile: array dims/dtypes + the static arguments."""

    batch: int
    emb_dim: int
    q_feats: int
    tech_q: int
    n_calls: int
    chunk_ks: Tuple[int, int, int]
    artifact_ks: Tuple[int, int, int]
    chunk_mode: str
    artifact_mode: str
    recall_target: float
    dense_enabled: bool
    packed_bytes: int
    dim: int
    lex_dim: int
    tech_slots: int
    emb_dtype: str
    fuse_rrf: bool = False


class GrowthPrewarmer:
    _MAX_SIGS = 8
    _MAX_COMPILED = 8

    def __init__(self, manager: "DeviceIndexManager"):
        self._manager = manager
        self._lock = threading.Lock()
        self._sigs: list[QuerySignature] = []
        self._started: Set[Tuple[QuerySignature, int, int]] = set()
        self._compiled: Dict[Tuple[QuerySignature, int, int], object] = {}
        self._hbm_warned: Set[Tuple[int, int]] = set()
        self._thread: Optional[threading.Thread] = None
        # (corpus_name, current_cap) -> the capacity the next growth
        # should allocate (and whose program is being prewarmed)
        self._planned: Dict[Tuple[str, int], int] = {}

    # -- bookkeeping -------------------------------------------------------
    def note_signature(self, sig: QuerySignature) -> None:
        """Record a served query signature (most-recent-first, bounded)."""
        with self._lock:
            if sig in self._sigs:
                self._sigs.remove(sig)
            self._sigs.insert(0, sig)
            del self._sigs[self._MAX_SIGS:]

    def get_compiled(
        self, sig: QuerySignature, chunk_cap: int, art_cap: int
    ):
        """A prewarmed executable for this exact signature, or None."""
        with self._lock:
            return self._compiled.get((sig, chunk_cap, art_cap))

    def _target_caps(self) -> Tuple[int, int]:
        """Per-corpus NEXT-growth capacity (HBM-constrained: a doubling
        when it fits, a fractional step when only that does, the current
        capacity when the corpus is not near growth)."""
        frac = float(settings.prewarm_fill_fraction)
        min_cap = int(settings.prewarm_min_capacity)
        with self._lock:  # note_signature mutates the list concurrently
            batch = max((sig.batch for sig in self._sigs), default=128)

        def target(corpus) -> int:
            cap = corpus.capacity
            if cap >= min_cap and corpus.count >= frac * cap:
                planned = plan_next_capacity(corpus, cap + 1, batch)
                with self._lock:
                    self._planned[(corpus.name, cap)] = planned
                return planned
            return cap

        return target(self._manager.chunks), target(self._manager.artifacts)

    def growth_cap(self, corpus, need: int) -> int:
        """The capacity an actual growth should allocate — the planned
        (possibly prewarmed) target when one is recorded and still
        sufficient, else a fresh plan. Keeping this the single source of
        truth means the capacity growth picks is the one whose program
        was prewarmed."""
        with self._lock:
            planned = self._planned.get((corpus.name, corpus.capacity))
        if planned is not None and planned >= need:
            return planned
        return plan_next_capacity(corpus, need)

    def _fits_hbm(self, chunk_cap: int, art_cap: int) -> bool:
        """Can the device hold the target capacities at all? (plan_next_
        capacity already degrades a doubling to a fractional step; this
        guards the case where even the minimum step cannot fit — the
        AOT compile would run out of memory for its temporaries, and the
        host-side lowering of a multi-million-row program competes with
        serving while it fails.)"""
        with self._lock:  # note_signature mutates the list concurrently
            batch = max((sig.batch for sig in self._sigs), default=128)
        free = free_hbm_bytes()
        need = 0.0
        for corpus, cap in ((self._manager.chunks, chunk_cap),
                            (self._manager.artifacts, art_cap)):
            # row-sharded corpora split their bytes across the mesh's
            # data axis; the budget guards PER-DEVICE bytes
            shards = (
                corpus.row_sharding.mesh.shape.get("data", 1)
                if corpus.row_sharding is not None else 1
            )
            grow = max(cap - corpus.capacity, 0)
            if free is None:
                # old+new buffers coexist only for a corpus actually
                # growing; one held at its current capacity contributes
                # a single buffer set (counting it twice would make a
                # corpus near its budget stand down needlessly)
                coexist = (corpus.capacity + cap) if grow else cap
                need += coexist * _corpus_row_bytes(corpus) / shards
            elif grow:
                # bytes_in_use already covers live buffers; only the new
                # allocation is additional demand
                need += (cap * _corpus_row_bytes(corpus)) / shards
            need += 3 * batch * grow * 4 / shards
        if free is None:
            return need <= float(settings.prewarm_hbm_budget_gb) * (1 << 30)
        return need <= free * 0.85

    # -- trigger -----------------------------------------------------------
    def maybe_prewarm(self) -> bool:
        """Spawn a background compile if a corpus is near a doubling and the
        next capacity's program isn't warm yet. Returns True if spawned."""
        if not settings.prewarm_growth_enabled:
            return False
        if self._manager.chunks.row_sharding is not None:
            import jax

            if jax.process_count() > 1:
                # multi-process lockstep dispatch replays through the
                # op-log and never consults the AOT table (core/index.
                # _dispatch_multiprocess) — prewarming would burn the
                # host core for an executable that is never used
                return False
        chunk_cap, art_cap = self._target_caps()
        chunks = self._manager.chunks
        arts = self._manager.artifacts
        if chunk_cap == chunks.capacity and art_cap == arts.capacity:
            return False
        # Growths land ONE corpus at a time, so the capacity pair the
        # dispatch will look up after the next growth is (grown, current)
        # or (current, grown) — NOT the joint target. Round-4's soak paid
        # a 15.5 s on-lock recompile at (1048576, 65536) because only the
        # joint (1048576, 131072) was warm (the 51 s worst batch was this
        # compile under vocab-rebuild host contention). Compile every
        # REACHABLE pair, nearest-growth corpus first; the joint pair
        # last (it becomes reachable only after both grow).
        chunk_first = (
            chunks.count * arts.capacity >= arts.count * chunks.capacity
        )
        combos: list = []
        if chunk_cap != chunks.capacity:
            combos.append((chunk_cap, arts.capacity))
        if art_cap != arts.capacity:
            combos.append((chunks.capacity, art_cap))
        if not chunk_first:
            combos.reverse()
        if chunk_cap != chunks.capacity and art_cap != arts.capacity:
            combos.append((chunk_cap, art_cap))
        fitting = [c for c in combos if self._fits_hbm(*c)]
        if not fitting:
            if (chunk_cap, art_cap) not in self._hbm_warned:
                self._hbm_warned.add((chunk_cap, art_cap))
                logger.warning(
                    "prewarm.skipped_hbm chunk_cap=%s art_cap=%s "
                    "budget_gb=%s (provision INDEX_INITIAL_CAPACITY "
                    "upfront or shard via MESH_SHAPE at this scale)",
                    chunk_cap, art_cap, settings.prewarm_hbm_budget_gb,
                )
            return False
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            pending = [
                (sig, cc, ac)
                for cc, ac in fitting
                for sig in self._sigs
                if (sig, cc, ac) not in self._started
            ]
            if not pending:
                return False
            for key in pending:
                self._started.add(key)
            self._thread = threading.Thread(
                target=self._compile_all,
                args=(pending,),
                daemon=True,
                name="growth-prewarm",
            )
            self._thread.start()
            return True

    def wait(self, timeout: Optional[float] = None) -> None:
        thread = self._thread
        if thread is not None:
            thread.join(timeout)

    # -- compile -----------------------------------------------------------
    def _corpus_specs(self, cap: int, sig: QuerySignature):
        """Abstract avals for one corpus's device arrays. Under a
        single-process mesh the avals carry the live arrays' shardings so
        the AOT executable accepts the GSPMD-sharded inputs the dispatch
        passes (plain avals would compile a single-device program that
        rejects them)."""
        import jax
        import jax.numpy as jnp

        sharding_2d = self._manager.chunks.row_sharding
        if sharding_2d is None:
            def spec(shape, dtype):
                return jax.ShapeDtypeStruct(shape, dtype)
        else:
            from jax.sharding import NamedSharding, PartitionSpec

            sharding_1d = NamedSharding(
                sharding_2d.mesh, PartitionSpec(sharding_2d.spec[0])
            )

            def spec(shape, dtype):
                sh = sharding_2d if len(shape) == 2 else sharding_1d
                return jax.ShapeDtypeStruct(shape, dtype, sharding=sh)
        return (
            spec((cap, sig.dim), jnp.dtype(sig.emb_dtype)),
            spec((cap, sig.lex_dim), jnp.int8),
            spec((cap, sig.tech_slots), jnp.int32),
            spec((cap,), jnp.int32),
            spec((cap,), jnp.int32),
            spec((cap,), jnp.bool_),
        )

    def _packed_spec(self, sig: QuerySignature):
        import jax
        import jax.numpy as jnp

        sharding_2d = self._manager.chunks.row_sharding
        if sharding_2d is None:
            return jax.ShapeDtypeStruct((sig.packed_bytes,), jnp.uint8)
        from jax.sharding import NamedSharding, PartitionSpec

        return jax.ShapeDtypeStruct(
            (sig.packed_bytes,), jnp.uint8,
            sharding=NamedSharding(sharding_2d.mesh, PartitionSpec()),
        )

    def _compile_all(self, tasks) -> None:
        import jax
        import jax.numpy as jnp

        from ..ops.pack import dual_corpus_retrieve_packed

        from ..utils import events

        for sig, chunk_cap, art_cap in tasks:
            try:
                t_lower = time.monotonic()
                lowered = dual_corpus_retrieve_packed.lower(
                    self._corpus_specs(chunk_cap, sig),
                    self._corpus_specs(art_cap, sig),
                    self._packed_spec(sig),
                    batch=sig.batch, emb_dim=sig.emb_dim,
                    q_feats=sig.q_feats, tech_q=sig.tech_q,
                    n_calls=sig.n_calls,
                    chunk_ks=sig.chunk_ks, artifact_ks=sig.artifact_ks,
                    chunk_mode=sig.chunk_mode,
                    artifact_mode=sig.artifact_mode,
                    recall_target=sig.recall_target,
                    dense_enabled=sig.dense_enabled,
                    fuse_rrf=sig.fuse_rrf,
                )
                executable = lowered.compile()
                events.record(
                    "prewarm.compiled",
                    time.monotonic() - t_lower,
                    chunk_cap=int(chunk_cap), art_cap=int(art_cap),
                    batch=int(sig.batch),
                )
                with self._lock:
                    self._compiled[(sig, chunk_cap, art_cap)] = executable
                    cur = (self._manager.chunks.capacity,
                           self._manager.artifacts.capacity)
                    # bookkeeping for superseded capacities never matches
                    # again (capacities only grow) — prune every pass so
                    # _started/_planned stay bounded over process life
                    self._started = {
                        k for k in self._started
                        if k[1] >= cur[0] and k[2] >= cur[1]
                    }
                    self._planned = {
                        k: v for k, v in self._planned.items()
                        if v >= (self._manager.chunks.capacity
                                 if k[0] == "chunks"
                                 else self._manager.artifacts.capacity)
                    }
                    # prune executables for superseded capacities (each
                    # holds a device program binary). An entry is stale
                    # when EITHER cap is below current for its corpus —
                    # lexicographic comparison kept (high-chunk,
                    # stale-artifact) entries that can never match
                    if len(self._compiled) > self._MAX_COMPILED:
                        for key in list(self._compiled):
                            if key[1] < cur[0] or key[2] < cur[1]:
                                del self._compiled[key]
                        while len(self._compiled) > self._MAX_COMPILED:
                            del self._compiled[next(iter(self._compiled))]
                logger.info(
                    "prewarm.compiled chunk_cap=%s art_cap=%s batch=%s "
                    "modes=%s/%s", chunk_cap, art_cap, sig.batch,
                    sig.chunk_mode, sig.artifact_mode,
                )
                # With the single-growth pair's query program warm, the
                # buffer side can start too: background growth migration
                # (core/index.GrowthMigration) — growth becomes a swap.
                chunks = self._manager.chunks
                arts = self._manager.artifacts

                def _warmup_for(grow_chunks: bool, exe=executable,
                                pbytes=sig.packed_bytes):
                    """First execution of a fresh executable pays its
                    load onto the device — run it once over the migrated
                    buffers, off the serving thread."""
                    dummy = jnp.zeros((pbytes,), jnp.uint8)

                    def run(bufs):
                        c_args = bufs if grow_chunks else (
                            chunks.device_arrays()
                        )
                        a_args = (
                            arts.device_arrays() if grow_chunks else bufs
                        )
                        jax.block_until_ready(exe(c_args, a_args, dummy))

                    return run

                # one migration at a time: two concurrent ones would hold
                # BOTH corpora's old+new buffer pairs, a joint footprint
                # _fits_hbm only ever approved per single-growth combo
                if (chunk_cap > chunks.capacity
                        and art_cap == arts.capacity
                        and arts._migration is None):
                    chunks.start_migration(
                        chunk_cap, warmup=_warmup_for(True)
                    )
                elif (art_cap > arts.capacity
                        and chunk_cap == chunks.capacity
                        and chunks._migration is None):
                    arts.start_migration(
                        art_cap, warmup=_warmup_for(False)
                    )
            except Exception:  # never fatal: growth just pays the compile
                logger.exception(
                    "prewarm.failed chunk_cap=%s art_cap=%s", chunk_cap,
                    art_cap,
                )
                with self._lock:
                    # let a later pass RETRY: a transient failure (e.g.
                    # momentary HBM pressure) would otherwise blacklist
                    # this signature via _started forever
                    self._started.discard((sig, chunk_cap, art_cap))
