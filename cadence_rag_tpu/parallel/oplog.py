"""Multi-host lockstep serving: the device-index op-log.

When the mesh spans PROCESSES (multi-host gangs; SURVEY.md §2.4 DCN
scope), every process must enqueue the IDENTICAL XLA program sequence —
a jit over global sharded arrays launched by one process alone deadlocks
the gang. The reference never faces this (Postgres is a single server;
NCCL workers are lockstep by construction of the training loop); a
serving system must manufacture lockstep out of an arbitrary request
stream.

Architecture — leader-driven op replication:

- Process 0 (leader) runs the HTTP server, the SQLite store, and the
  full retrieval engine. Host-side work (featurization, planning, RRF,
  postprocess, store reads) happens ONLY on the leader.
- Followers mirror the DEVICE INDEX only: every device-touching index
  operation the leader performs — slab write, growth, tombstone,
  embedding/tech scatter, restore alloc, query dispatch — is streamed
  over a TCP op-log (length-prefixed json header + npz payload), and
  each follower replays it in order on its shards of the global mesh.
  TCP ordering + per-corpus locks on the leader make the log a valid
  serialization of the leader's own enqueue order, so GSPMD collectives
  line up by construction.
- Query programs are jitted with REPLICATED out_shardings in multihost
  mode: topk outputs are tiny, and a replicated output is the one thing
  the leader can read back without a cross-process gather.
- Host->device inputs (slabs, packed query bytes) stay as raw numpy in
  multihost mode: uncommitted inputs are staged to the needed sharding
  by jit itself, identically on every process — a committed
  process-local jnp.asarray would poison the global dispatch.

Stand-down under multihost (enforced in core/index.py): growth-prewarm
(multi-process only — single-process meshes prewarm with sharded avals,
core/prewarm.py). IVF is gang-supported: builds mirror as ONE
deterministic op ('build_ivf' — every process runs the same replicated
k-means over the global embeddings and packs identical buckets
host-side), overflow appends mirror ('ivf_overflow'), and the separate
IVF dense dispatch mirrors ('query_ivf') so the probed gather's GSPMD
collectives line up. A gang build holds the corpus lock for the whole
k-means (single-process builds release it) — lockstep requires the
build's program sequence to be contiguous in the log.
Compaction mirrors like any other device op (the gather stamps its
padding invalid in-program, so no host read-back is needed — the
'compact' op). Checkpoint SAVE and RESTORE are both supported:
restore mirrors the leader's writes like any other ingest; save is the
v3 gang format — every process writes the heavy row blocks it owns
(mirrored 'checkpoint_shards' op), the leader writes scalars/stats and
flips meta last (core/checkpoint._save_index_multihost; shared
filesystem required).

Validated end-to-end by tests/integration/test_multihost_serving.py:
two OS processes (CPU Gloo transport, 4+4 virtual devices), the real
serve startup path, HTTP ingest/delete/retrieve on the leader,
bit-identical to a single-process oracle.
"""

from __future__ import annotations

import io
import json
import socket
import struct
import threading
import time
from typing import Dict, Optional

import numpy as np

from ..logging_utils import get_logger

logger = get_logger(__name__)

_HDR = struct.Struct("<II")  # (json_len, npz_len)


def _handshake_digest(token: str) -> bytes:
    """32-byte follower-hello: sha256 over a purpose tag + the shared
    token. With no explicit DIST_OPLOG_TOKEN both sides derive the token
    from the coordinator address, which rejects accidental/stray
    connections (a real secret is required to resist an adversary on the
    network — documented in OPERATIONS.md)."""
    import hashlib

    return hashlib.sha256(b"cadence-oplog-v1\x00" + token.encode()).digest()


def default_token() -> str:
    from ..config import settings

    return settings.dist_oplog_token.strip() or (
        "derived:" + settings.dist_coordinator.strip()
    )

# module state (one gang per process)
_leader: Optional["LeaderOpLog"] = None
_mesh = None
_repl_packed_query = None
_repl_single_query = None
_repl_ivf_build = None
_repl_ivf_query = None


# -- wire format -----------------------------------------------------------

def _send_msg(sock: socket.socket, op: str, statics: Dict, arrays: Dict) -> None:
    header = json.dumps({"op": op, "statics": statics}).encode()
    if arrays:
        buf = io.BytesIO()
        # bf16 etc. have no npz codec — views as uint8 with dtype recorded
        packed = {}
        meta = {}
        for k, v in arrays.items():
            v = np.ascontiguousarray(v)
            meta[k] = (str(v.dtype), list(v.shape))
            packed[k] = v.view(np.uint8).reshape(-1)
        packed["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
        np.savez(buf, **packed)
        blob = buf.getvalue()
    else:
        blob = b""
    sock.sendall(_HDR.pack(len(header), len(blob)) + header + blob)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("op-log closed")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_msg(sock: socket.socket):
    jlen, blen = _HDR.unpack(_recv_exact(sock, _HDR.size))
    header = json.loads(_recv_exact(sock, jlen))
    arrays: Dict[str, np.ndarray] = {}
    if blen:
        with np.load(io.BytesIO(_recv_exact(sock, blen))) as data:
            meta = json.loads(bytes(data["__meta__"]).decode())
            import jax.numpy as jnp

            for k, (dtype, shape) in meta.items():
                arrays[k] = (
                    data[k].view(jnp.dtype(dtype)).reshape(shape)
                )
    return header["op"], header["statics"], arrays


# -- leader ----------------------------------------------------------------

class LeaderOpLog:
    """Accepts follower connections and broadcasts device ops in order.

    ``emit`` is called from inside the corpus locks at each device-op
    site (core/index.py), so the log order is exactly the leader's
    device enqueue order; the send lock keeps multi-corpus interleaving
    a valid serialization of it."""

    def __init__(self, port: int, n_followers: int, timeout_s: float = 120.0,
                 bind_host: str = "127.0.0.1", token: str = ""):
        self._send_lock = threading.Lock()
        self._socks = []
        expected = _handshake_digest(token or default_token())
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((bind_host, port))
        srv.listen(n_followers)
        deadline = time.monotonic() + timeout_s
        # Accept until n_followers AUTHENTICATE: an unauthenticated peer
        # is dropped and does not consume a follower slot (ADVICE r2 —
        # without the handshake any network peer could squat a slot and
        # hang the gang, or receive the full index stream).
        while len(self._socks) < n_followers:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                srv.close()
                raise TimeoutError(
                    f"op-log: {len(self._socks)}/{n_followers} followers "
                    f"authenticated within {timeout_s}s"
                )
            srv.settimeout(remaining)
            conn, addr = srv.accept()
            try:
                conn.settimeout(10.0)
                hello = _recv_exact(conn, len(expected))
            except (OSError, ConnectionError):
                conn.close()
                continue
            if hello != expected:
                logger.warning("oplog.follower_rejected addr=%s", addr)
                conn.close()
                continue
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._socks.append(conn)
            logger.info("oplog.follower_connected addr=%s", addr)
        srv.close()

    def emit(self, op: str, statics: Optional[Dict] = None,
             arrays: Optional[Dict] = None) -> None:
        with self._send_lock:
            for sock in self._socks:
                try:
                    _send_msg(sock, op, statics or {}, arrays or {})
                except OSError as exc:
                    # A lost follower means the gang can no longer enqueue
                    # lockstep programs — the next collective would hang.
                    # Fail fast with an operator-actionable error; the
                    # deployment must restart the gang (and can restore
                    # from checkpoint + store).
                    raise RuntimeError(
                        "op-log follower lost mid-serving; the multi-host "
                        "gang must be restarted"
                    ) from exc

    def shutdown(self) -> None:
        try:
            self.emit("shutdown")
        except (OSError, RuntimeError):  # follower already gone
            pass
        for sock in self._socks:
            try:
                sock.close()
            except OSError:
                pass


# -- replicated-output query jits ------------------------------------------

def _replicated_sharding():
    from jax.sharding import NamedSharding, PartitionSpec

    return NamedSharding(_mesh, PartitionSpec())


def replicated_array(arr: np.ndarray):
    """Committed fully-replicated global array from host values that are
    IDENTICAL on every process (deterministic host computation, or an
    op-log-mirrored payload). device_put to a cross-process sharding is
    illegal; make_array_from_callback builds each process's local shards."""
    import jax

    arr = np.ascontiguousarray(arr)
    return jax.make_array_from_callback(
        arr.shape, _replicated_sharding(), lambda idx: arr[idx]
    )


def ivf_build_gang(emb, statics: Dict):
    """All-process IVF k-means over the global sharded embeddings with
    replicated outputs (ops/ivf.ivf_build). Every process — the leader
    from build_ivf, followers from the mirrored 'build_ivf' op — calls
    this with identical statics, so the gang enqueues one identical
    program and every process can read the assignments back."""
    global _repl_ivf_build
    if _repl_ivf_build is None:
        import jax

        from ..ops import ivf as ivf_mod

        _repl_ivf_build = jax.jit(
            ivf_mod.ivf_build.__wrapped__,
            static_argnames=("n", "n_clusters", "iters", "seed", "dequant"),
            out_shardings=_replicated_sharding(),
        )
    return _repl_ivf_build(emb, **statics)


def ivf_query(corpus, state, q_emb, allowed, dmin, dmax, statics: Dict):
    """The separate IVF dense dispatch with replicated outputs — mirrored
    as the 'query_ivf' op so the probed gather over the row-sharded
    embeddings (a GSPMD collective) lines up gang-wide."""
    global _repl_ivf_query
    if _repl_ivf_query is None:
        import jax

        from ..core import index as index_mod

        _repl_ivf_query = jax.jit(
            index_mod._ivf_dense_query.__wrapped__,
            static_argnames=("k", "nprobe"),
            out_shardings=_replicated_sharding(),
        )
    return _repl_ivf_query(
        corpus.emb, corpus.call_idx, corpus.started, corpus.has_emb,
        state.centroids, state.buckets, state.overflow,
        np.asarray(q_emb, dtype=np.float32),
        np.asarray(allowed, dtype=bool),
        np.asarray(dmin, dtype=np.int32),
        np.asarray(dmax, dtype=np.int32),
        k=int(statics["k"]), nprobe=int(statics["nprobe"]),
    )


def packed_query(chunk_arrays, artifact_arrays, packed_np, statics: Dict):
    """Leader+follower entry for the fused dual-corpus program with
    replicated outputs (the leader reads them back host-side)."""
    global _repl_packed_query
    if _repl_packed_query is None:
        import jax

        from ..ops import pack

        _repl_packed_query = jax.jit(
            pack.dual_corpus_retrieve_packed.__wrapped__,
            static_argnames=(
                "batch", "emb_dim", "q_feats", "tech_q", "n_calls",
                "chunk_ks", "artifact_ks", "chunk_mode", "artifact_mode",
                "recall_target", "dense_enabled", "fuse_rrf",
            ),
            out_shardings=_replicated_sharding(),
        )
    statics = dict(statics)
    for key in ("chunk_ks", "artifact_ks"):
        statics[key] = tuple(statics[key])
    return _repl_packed_query(
        chunk_arrays, artifact_arrays, np.asarray(packed_np), **statics
    )


def single_query(corpus, q_emb, q_lex, q_tech, allowed, dmin, dmax,
                 statics: Dict):
    """Cold-start fallback lane program (one corpus), replicated out."""
    global _repl_single_query
    if _repl_single_query is None:
        import jax

        from ..ops import fused

        _repl_single_query = jax.jit(
            fused.multi_lane_retrieve.__wrapped__,
            static_argnames=(
                "k_dense", "k_lex", "k_tech", "dense_mode",
                "recall_target", "dense_enabled",
            ),
            out_shardings=_replicated_sharding(),
        )
    return _repl_single_query(
        corpus.emb, corpus.lex, corpus.tech, corpus.call_idx,
        corpus.started, corpus.has_emb,
        np.asarray(q_emb, dtype=np.float32),
        np.asarray(q_lex, dtype=np.float32),
        np.asarray(q_tech, dtype=np.int32),
        np.asarray(allowed, dtype=bool),
        np.asarray(dmin, dtype=np.int32),
        np.asarray(dmax, dtype=np.int32),
        **statics,
    )


# -- lifecycle -------------------------------------------------------------

def install_leader(manager, port: int, n_followers: int,
                   bind_host: str = "127.0.0.1",
                   token: str = "") -> None:
    """Process 0: wait for the gang's followers, then mirror every device
    op (must run BEFORE any index mutation — including the startup
    rebuild-from-store)."""
    global _leader, _mesh
    from ..core import index as index_mod

    _mesh = manager.mesh
    _leader = LeaderOpLog(port, n_followers, bind_host=bind_host,
                          token=token)
    index_mod.set_oplog(_leader)
    import atexit

    atexit.register(_leader.shutdown)
    logger.info("oplog.leader_ready followers=%s port=%s", n_followers, port)


def active() -> bool:
    return _mesh is not None


def leader() -> Optional[LeaderOpLog]:
    return _leader


# -- follower --------------------------------------------------------------

def _connect(host: str, port: int, timeout_s: float,
             token: str = "") -> socket.socket:
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            sock = socket.create_connection((host, port), timeout=5.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall(_handshake_digest(token or default_token()))
            sock.settimeout(None)
            return sock
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.2)


def _apply(manager, op: str, st: Dict, arrays: Dict) -> None:
    from ..core.index import (
        _scatter_emb_and_flags,
        _scatter_rows,
        _tombstone_rows,
        _write_all_slabs,
    )

    if op == "grow":
        manager.corpus(st["corpus"])._grow_to(int(st["cap"]))
        return
    if op == "compact":
        manager.corpus(st["corpus"]).apply_compact_device(
            arrays["live"], int(st["out_rows"]), int(st["cap"])
        )
        return
    if op == "checkpoint_shards":
        # gang save (checkpoint format v3): write THIS process's
        # addressable heavy row blocks; the leader polls for the files
        # before flipping meta (core/checkpoint._save_index_multihost)
        from ..core.checkpoint import write_local_heavy_shards

        write_local_heavy_shards(
            manager.corpus(st["corpus"]), st["path"],
            int(st["generation"]), int(st["count"]),
        )
        return
    if op == "alloc":
        c = manager.corpus(st["corpus"])
        c.count = 0
        c.capacity = int(st["cap"])
        c._alloc_device(c.capacity)
        return
    if op == "build_ivf":
        manager.corpus(st["corpus"]).gang_build_install_ivf(
            int(st["n"]), int(st["clusters"]), int(st["nprobe"]),
            int(st["seed"]),
        )
        return
    if op == "ivf_overflow":
        manager.corpus(st["corpus"]).gang_set_ivf_overflow(
            arrays["padded"], int(st["count"])
        )
        return
    if op == "query_ivf":
        c = manager.corpus(st["corpus"])
        ivf_query(c, c.ivf, arrays["q_emb"], arrays["allowed"],
                  arrays["dmin"], arrays["dmax"], st["statics"])
        return
    corpus = manager.corpus(st["corpus"])
    if op == "write_slabs":
        (corpus.emb, corpus.lex, corpus.tech, corpus.call_idx,
         corpus.started, corpus.has_emb) = _write_all_slabs(
            corpus.emb, corpus.lex, corpus.tech, corpus.call_idx,
            corpus.started, corpus.has_emb,
            np.asarray(arrays["emb"], dtype=corpus.emb_dtype),
            arrays["lex"], arrays["tech"], arrays["call"],
            arrays["started"], arrays["has"],
            int(st["start"]),
        )
        corpus.count = int(st["count_after"])
    elif op == "tombstone":
        corpus.started, corpus.has_emb = _tombstone_rows(
            corpus.started, corpus.has_emb, arrays["pos"]
        )
    elif op == "scatter_emb":
        corpus.emb, corpus.has_emb = _scatter_emb_and_flags(
            corpus.emb, corpus.has_emb, arrays["pos"],
            np.asarray(arrays["vals"], dtype=corpus.emb_dtype),
            arrays["flags"],
        )
    elif op == "scatter_tech":
        corpus.tech = _scatter_rows(corpus.tech, arrays["pos"], arrays["vals"])
    elif op == "scatter_lex":
        corpus.lex = _scatter_rows(corpus.lex, arrays["pos"], arrays["vals"])
    elif op == "query_packed":
        packed_query(
            manager.chunks.device_arrays(),
            manager.artifacts.device_arrays(),
            arrays["packed"], st["statics"],
        )
    elif op == "query_single":
        statics = dict(st["statics"])
        single_query(
            corpus, arrays["q_emb"], arrays["q_lex"], arrays["q_tech"],
            arrays["allowed"], arrays["dmin"], arrays["dmax"], statics,
        )
    else:
        raise ValueError(f"unknown op-log op {op!r}")


def follower_main(manager, host: str, port: int,
                  connect_timeout_s: float = 120.0) -> None:
    """Non-leader processes: apply the leader's device-op stream until
    shutdown/EOF. Called from serve startup (serve/api.py) instead of
    running the HTTP server."""
    global _mesh
    _mesh = manager.mesh
    sock = _connect(host, port, connect_timeout_s)
    logger.info("oplog.follower_loop host=%s port=%s", host, port)
    applied = 0
    try:
        while True:
            try:
                op, st, arrays = _recv_msg(sock)
            except ConnectionError:
                logger.info("oplog.leader_gone applied=%s", applied)
                return
            if op == "shutdown":
                logger.info("oplog.shutdown applied=%s", applied)
                return
            _apply(manager, op, st, arrays)
            applied += 1
    finally:
        try:
            sock.close()
        except OSError:
            pass
