"""Multi-host lockstep serving end-to-end (parallel/oplog.py).

Two OS processes join a jax.distributed gang (CPU Gloo, 4+4 virtual
devices, MESH_SHAPE=data:8). The LEADER runs the REAL serve startup path
(serve/http.py main -> api.startup -> oplog.install_leader) and its HTTP
server; the FOLLOWER enters the op-log replay loop inside the same
startup path. The test drives ingest (enough to force a capacity-growth
op), analysis artifacts, delete, and /retrieve over HTTP against the
leader, then replays the identical scenario against a single-process
server and asserts bit-identical retrieval results — proving inserts,
growth, tombstones and query dispatch all mirror correctly across the
process boundary.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time
import urllib.request
from datetime import datetime, timezone
from pathlib import Path

import pytest

WORKER = """
import jax
jax.config.update("jax_platforms", "cpu")
import sys
sys.argv = ["serve", "--host", "127.0.0.1", "--port", sys.argv[1]]
from cadence_rag_tpu.serve.http import main
main()
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", json.dumps(payload).encode(),
        {"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _delete(port, path):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="DELETE"
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _wait_health(port, proc, timeout_s=180):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(
                f"server exited rc={proc.returncode} before healthy"
            )
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/health", timeout=5
            ) as resp:
                if resp.status == 200:
                    return
        except OSError:
            time.sleep(0.5)
    raise AssertionError("server never became healthy")


def _drive(port):
    """The scenario: ingest past the 64-row initial capacity (growth op),
    an analysis artifact, a delete, then retrievals."""
    words = ["deploy", "rollback", "latency", "kafka", "billing", "cache",
             "timeout", "retry", "incident", "postgres"]
    for c in range(4):
        turns = [
            {"speaker": "A" if i % 2 == 0 else "B",
             "start_ts_ms": i * 5000, "end_ts_ms": i * 5000 + 4500,
             "text": " ".join(
                 words[(c + i + j) % len(words)] for j in range(10)
             ) + f" svc-{c % 2} step {i}"}
            for i in range(24)
        ]
        _post(port, "/ingest/transcript", {
            "call_ref": {"external_id": f"mh-{c}", "tags": [f"svc-{c % 2}"]},
            "transcript": {"format": "json_turns", "content": turns},
            "options": {"target_tokens": 20, "max_tokens": 40,
                        "overlap_tokens": 4},
        })
    _post(port, "/ingest/analysis", {
        "call_ref": {"external_id": "mh-0"},
        "artifacts": [{"kind": "summary",
                       "content": "kafka timeout incident summary for "
                                  "svc-0 rollback"}],
    })
    doomed = _post(port, "/ingest/call",
                   {"call_ref": {"external_id": "mh-3"}})["call_id"]
    results = {}
    results["pre_delete"] = _post(port, "/retrieve", {
        "query": "kafka timeout incident on svc-0",
        "return_style": "ids_only",
    })["retrieved_ids"]
    _delete(port, f"/calls/{doomed}")
    results["post_delete"] = _post(port, "/retrieve", {
        "query": "billing rollback latency", "return_style": "ids_only",
    })["retrieved_ids"]
    full = _post(port, "/retrieve", {"query": "postgres cache retry"})
    results["evidence"] = [q["chunk_id"] for q in full["quotes"]]
    stats = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/index/stats", timeout=30
    ).read())
    results["counts"] = (stats["chunks"]["count"],
                         stats["artifact_chunks"]["count"])
    results["capacity"] = stats["chunks"]["capacity"]
    return results


def _spawn(tmp_path, name, port, extra_env):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.update({
        "STORE_PATH": str(tmp_path / f"{name}.db"),
        "EMBEDDINGS_PROVIDER": "stub",
        "EMBEDDINGS_BASE_URL": "",
        "INDEX_INITIAL_CAPACITY": "64",
        "LOG_LEVEL": "INFO",
    })
    env.update(extra_env)
    log = open(tmp_path / f"{name}.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", WORKER, str(port)],
        env=env, stdout=log, stderr=subprocess.STDOUT,
    )
    return proc


class TestFollowerLoss:
    def test_emit_after_follower_loss_raises_gang_error(self):
        """A lost follower means the next collective would hang; emit must
        fail fast with an operator-actionable error instead."""
        import threading

        import numpy as np

        from cadence_rag_tpu.parallel.oplog import (
            LeaderOpLog,
            _handshake_digest,
            default_token,
        )

        port = _free_port()
        holder = {}

        def connect():
            deadline = time.monotonic() + 30
            while True:
                try:
                    holder["sock"] = socket.create_connection(
                        ("127.0.0.1", port), timeout=5)
                    holder["sock"].sendall(
                        _handshake_digest(default_token()))
                    return
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)

        t = threading.Thread(target=connect)
        t.start()
        log = LeaderOpLog(port, 1, timeout_s=30)
        t.join()
        holder["sock"].close()
        with pytest.raises(RuntimeError, match="gang must be restarted"):
            # the first sends may land in socket buffers before the
            # peer-closed state surfaces; keep pushing
            for _ in range(200):
                log.emit("grow", {"corpus": "chunks", "cap": 8},
                         {"pad": np.zeros(1 << 16, dtype=np.uint8)})


class TestFollowerHandshake:
    def test_unauthenticated_peer_rejected_without_squatting_slot(self):
        """ADVICE r2: a peer that fails the token handshake must be
        dropped — it must neither receive the op stream nor consume a
        follower slot (the real follower still connects)."""
        import threading

        from cadence_rag_tpu.parallel.oplog import (
            LeaderOpLog,
            _handshake_digest,
        )

        port = _free_port()
        results = {}

        def stray():
            deadline = time.monotonic() + 30
            while True:
                try:
                    s = socket.create_connection(("127.0.0.1", port),
                                                 timeout=5)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
            s.sendall(_handshake_digest("wrong-token"))
            # leader should close on us
            s.settimeout(10)
            results["stray_closed"] = s.recv(1) == b""
            s.close()

        def real():
            time.sleep(0.5)  # let the stray connect first
            s = socket.create_connection(("127.0.0.1", port), timeout=5)
            s.sendall(_handshake_digest("right-token"))
            results["real_sock"] = s

        t1 = threading.Thread(target=stray)
        t2 = threading.Thread(target=real)
        t1.start(); t2.start()
        log = LeaderOpLog(port, 1, timeout_s=30, token="right-token")
        t1.join(); t2.join()
        assert results["stray_closed"]
        log.emit("grow", {"corpus": "chunks", "cap": 8})
        results["real_sock"].close()


class TestMultihostServing:
    def test_two_process_gang_matches_single_process(self, tmp_path):
        coord = _free_port()
        oplog_port = _free_port()
        http_port = _free_port()
        gang_env = {
            "DIST_COORDINATOR": f"127.0.0.1:{coord}",
            "DIST_NUM_PROCESSES": "2",
            "DIST_OPLOG_PORT": str(oplog_port),
            "MESH_SHAPE": "data:8",
        }
        follower = _spawn(tmp_path, "follower", _free_port(),
                          {**gang_env, "DIST_PROCESS_ID": "1"})
        leader = _spawn(tmp_path, "leader", http_port,
                        {**gang_env, "DIST_PROCESS_ID": "0"})
        try:
            _wait_health(http_port, leader)
            gang = _drive(http_port)
        finally:
            leader.terminate()
            try:
                leader.wait(timeout=30)
            except subprocess.TimeoutExpired:
                leader.kill()
            try:
                follower.wait(timeout=60)
            except subprocess.TimeoutExpired:
                follower.kill()
                raise AssertionError(
                    "follower did not exit after leader shutdown"
                )

        assert gang["capacity"] > 64, "scenario must exercise growth"
        assert gang["counts"][0] > 64 and gang["counts"][1] >= 1

        # single-process oracle: identical scenario, no gang
        oracle_port = _free_port()
        oracle = _spawn(tmp_path, "oracle", oracle_port, {})
        try:
            _wait_health(oracle_port, oracle)
            solo = _drive(oracle_port)
        finally:
            oracle.terminate()
            try:
                oracle.wait(timeout=30)
            except subprocess.TimeoutExpired:
                oracle.kill()

        assert gang["counts"] == solo["counts"]
        assert gang["pre_delete"] == solo["pre_delete"]
        assert gang["post_delete"] == solo["post_delete"]
        assert gang["evidence"] == solo["evidence"]

    @pytest.mark.parametrize("emb_dtype", ["bfloat16", "int8"])
    def test_restore_backfill_and_fallback_ops(
        self, tmp_store, tmp_path, monkeypatch, emb_dtype
    ):
        """Engine-level gang: checkpoint restore (alloc/write ops), the
        cold-start query_single fallback (artifacts empty), embedding
        backfill (scatter_emb ops), then the packed path — all mirrored
        across two processes and identical to this (single-process)
        oracle. The int8 variant exercises the encode-before-emit slab
        path (quantized rows on the wire must replay bit-identically)."""
        from cadence_rag_tpu.core.index import reset_index

        monkeypatch.setattr(tmp_store, "index_embedding_dtype", emb_dtype)
        reset_index()
        from cadence_rag_tpu.core.checkpoint import save_index
        from cadence_rag_tpu.core.index import get_index
        from cadence_rag_tpu.embed.pipeline import run_embedding_backfill
        from cadence_rag_tpu.engine.retrieve import retrieve_evidence_batch
        from cadence_rag_tpu.ingest.ingest import (
            ingest_analysis,
            ingest_transcript,
        )
        from cadence_rag_tpu.schemas import (
            AnalysisArtifactIn,
            CallRef,
            ChunkingOptions,
            RetrieveRequest,
        )

        words = ["kafka", "timeout", "incident", "rollback", "billing",
                 "cache", "deploy", "latency"]
        for c in range(3):
            from cadence_rag_tpu.schemas import UtteranceIn

            turns = [
                UtteranceIn(
                    speaker="A", start_ts_ms=i * 5000,
                    end_ts_ms=i * 5000 + 4500,
                    text=" ".join(words[(c + i + j) % len(words)]
                                  for j in range(8)) + f" s{c} step {i}",
                )
                for i in range(20)
            ]
            ingest_transcript(
                CallRef(external_id=f"seed-{c}"), turns,
                ChunkingOptions(target_tokens=16, max_tokens=32,
                                overlap_tokens=0),
            )
        ckpt = str(tmp_path / "ckpt")
        save_index(ckpt)
        # leader's store must match the pre-backfill/pre-artifact state
        # the checkpoint captured — copy the db (and its WAL, which holds
        # recent writes) before the oracle mutates
        db_copy = tmp_path / "leader_seed.db"
        shutil.copyfile(tmp_store.store_path, db_copy)
        for suffix in ("-wal", "-shm"):
            src = Path(tmp_store.store_path + suffix)
            if src.exists():
                shutil.copyfile(src, str(db_copy) + suffix)

        def ids(query):
            return retrieve_evidence_batch(
                [RetrieveRequest(query=query, return_style="ids_only")]
            )[0]["retrieved_ids"]

        index = get_index()
        oracle = {"counts": [index.chunks.count, index.artifacts.count]}
        oracle["restored"] = ids("kafka timeout incident")
        run_embedding_backfill(batch_size=16)
        oracle["embedded"] = int(index.chunks.emb_rows)
        oracle["dense"] = ids("kafka timeout incident")
        ingest_analysis(
            CallRef(external_id="seed-0"),
            [AnalysisArtifactIn(kind="summary",
                                content="kafka incident rollback summary")],
        )
        oracle["packed"] = ids("kafka rollback")
        doomed = index.chunks.h_ids[: index.chunks.count][::3].tolist()
        index.chunks.delete_ids(doomed)
        index.chunks.compact()
        oracle["compacted_count"] = int(index.chunks.count)
        oracle["post_compact"] = ids("kafka timeout incident")
        # multi-host IVF phase (same ops as the worker; the planner must
        # route the dense lane through the probed index on both sides)
        monkeypatch.setattr(tmp_store, "dense_ivf_enabled", True)
        monkeypatch.setattr(tmp_store, "ivf_min_rows", 1)
        state = index.chunks.build_ivf(n_clusters=8, seed=7)
        oracle["ivf_plan"] = [state.built_count, state.n_clusters,
                              state.nprobe]
        oracle["ivf_usable"] = bool(index.chunks.ivf_usable())
        oracle["ivf_ids"] = ids("kafka timeout incident")
        from cadence_rag_tpu.schemas import UtteranceIn

        ingest_transcript(
            CallRef(external_id="post-ivf",
                started_at=datetime(2026, 1, 2, 3, 4, 5,
                                    tzinfo=timezone.utc)),
            [UtteranceIn(speaker="B", start_ts_ms=0, end_ts_ms=4000,
                         text="cache latency deploy rollback billing")],
            ChunkingOptions(target_tokens=16, max_tokens=32,
                            overlap_tokens=0),
        )
        oracle["ivf_overflow"] = int(index.chunks.ivf.overflow_count)
        oracle["post_overflow_ids"] = ids("kafka timeout incident")
        oracle["saved_format"] = 3
        oracle["saved_counts"] = [index.chunks.count,
                                  index.artifacts.count]
        # byte-level truth for the v3 gang-save equivalence check below
        oracle_state = {
            c.name: c.state_arrays()
            for c in (index.chunks, index.artifacts)
        }

        coord = _free_port()
        oplog_port = _free_port()
        env_common = {
            "DIST_COORDINATOR": f"127.0.0.1:{coord}",
            "MESH_SHAPE": "data:8",
            "LEXICAL_DIM": "1024",
            "EMBEDDINGS_DIM": "64",
            "INDEX_INITIAL_CAPACITY": "64",
            "INDEX_EMBEDDING_DTYPE": emb_dtype,
            "DENSE_IVF_ENABLED": "1",
            "IVF_MIN_ROWS": "1",
        }
        worker = str(Path(__file__).parent / "_multihost_engine_worker.py")
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["PYTHONPATH"] = (
            str(Path(__file__).resolve().parents[2])
            + os.pathsep + env.get("PYTHONPATH", "")
        )
        env.update(env_common)
        env.update({
            "EMBEDDINGS_PROVIDER": "stub",
            "EMBEDDINGS_BASE_URL": "",
        })
        fenv = dict(env)
        fenv["STORE_PATH"] = str(tmp_path / "follower.db")
        lenv = dict(env)
        lenv["STORE_PATH"] = str(tmp_path / "leader.db")
        shutil.copyfile(db_copy, lenv["STORE_PATH"])
        for suffix in ("-wal", "-shm"):
            src = Path(str(db_copy) + suffix)
            if src.exists():
                shutil.copyfile(src, lenv["STORE_PATH"] + suffix)
        flog = open(tmp_path / "f.log", "w")
        llog = open(tmp_path / "l.log", "w")
        gang_ckpt = str(tmp_path / "gang_ckpt")
        follower = subprocess.Popen(
            [sys.executable, worker, "1", f"127.0.0.1:{coord}",
             str(oplog_port), ckpt, gang_ckpt],
            env=fenv, stdout=flog, stderr=subprocess.STDOUT,
        )
        leader = subprocess.Popen(
            [sys.executable, worker, "0", f"127.0.0.1:{coord}",
             str(oplog_port), ckpt, gang_ckpt],
            env=lenv, stdout=llog, stderr=subprocess.STDOUT,
        )
        try:
            rc = leader.wait(timeout=420)
            follower.wait(timeout=60)
        except subprocess.TimeoutExpired:
            leader.kill()
            follower.kill()
            raise
        finally:
            flog.close()
            llog.close()
        leader_out = (tmp_path / "l.log").read_text()
        assert rc == 0, leader_out + (tmp_path / "f.log").read_text()
        result_line = [ln for ln in leader_out.splitlines()
                       if ln.startswith("RESULT ")]
        assert result_line, leader_out
        gang = json.loads(result_line[0][len("RESULT "):])
        assert gang == oracle

        # the gang's v3 save must restore single-process BYTE-EQUAL to
        # the oracle's corpus state
        import numpy as _np

        from cadence_rag_tpu.core.checkpoint import restore_index

        reset_index()
        meta = restore_index(gang_ckpt)
        assert meta["format_version"] == 3
        restored = get_index()
        for corpus in (restored.chunks, restored.artifacts):
            got = corpus.state_arrays()
            want = oracle_state[corpus.name]
            for key in ("emb", "lex", "tech", "ids", "call", "started",
                        "has_emb", "doc_freq", "dl_sum"):
                assert _np.array_equal(
                    _np.asarray(got[key]), _np.asarray(want[key])
                ), (corpus.name, key)
