"""Cross-process worker/API coherence.

The reference's 3-process topology (api + scanner + worker containers
sharing Postgres, reference docker-compose.yml:22-102) guarantees a
worker's writes are instantly visible to the API. Here the API server
runs in ONE OS process while the scanner and worker run in OTHERS
sharing only the SQLite store: a drop-folder bundle must become
retrievable through the live server WITHOUT restarting it, via the
trigger-maintained mutation log + StoreSyncer (ingest/sync.py).
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

SERVER = """
import jax
jax.config.update("jax_platforms", "cpu")
import sys
sys.argv = ["serve", "--host", "127.0.0.1", "--port", sys.argv[1]]
from cadence_rag_tpu.serve.http import main
main()
"""

SCANNER = """
import sys
sys.argv = ["ingest_scanner", "--once"]
from cadence_rag_tpu.scripts.ingest_scanner import main
main()
"""

WORKER = """
import sys
sys.argv = ["ingest_worker", "--once"]
from cadence_rag_tpu.scripts.ingest_worker import main
main()
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _get(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=30
    ) as resp:
        return json.loads(resp.read())


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", json.dumps(payload).encode(),
        {"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _env(tmp_path):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.update({
        "STORE_PATH": str(tmp_path / "shared.db"),
        "INGEST_ROOT_DIR": str(tmp_path / "ingest"),
        "EMBEDDINGS_PROVIDER": "stub",
        "EMBEDDINGS_BASE_URL": "",
        "EMBEDDINGS_DIM": "64",
        "LEXICAL_DIM": "1024",
        "INDEX_INITIAL_CAPACITY": "64",
        "INGEST_SINGLE_FILE_MIN_AGE_S": "0",
        "STORE_SYNC_INTERVAL_S": "0.2",
        "LOG_LEVEL": "INFO",
    })
    return env


def _run(code, env, tmp_path, name, *args, timeout=120):
    log = tmp_path / f"{name}.log"
    with open(log, "w") as out:
        proc = subprocess.run(
            [sys.executable, "-c", code, *map(str, args)],
            env=env, stdout=out, stderr=subprocess.STDOUT, timeout=timeout,
        )
    assert proc.returncode == 0, log.read_text()[-3000:]


class TestWorkerApiCoherence:
    def test_drop_folder_bundle_visible_without_restart(self, tmp_path):
        env = _env(tmp_path)
        inbox = tmp_path / "ingest" / "inbox"
        inbox.mkdir(parents=True)
        port = _free_port()
        log = open(tmp_path / "server.log", "w")
        server = subprocess.Popen(
            [sys.executable, "-c", SERVER, str(port)],
            env=env, stdout=log, stderr=subprocess.STDOUT,
        )
        try:
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                if server.poll() is not None:
                    raise AssertionError(
                        "server died: "
                        + (tmp_path / "server.log").read_text()[-3000:]
                    )
                try:
                    if _get(port, "/health")["status"] == "ok":
                        break
                except OSError:
                    time.sleep(0.3)

            # baseline: corpus empty, query returns nothing
            ids = _post(port, "/retrieve", {
                "query": "ECONNRESET rollback v2.3.1",
                "return_style": "ids_only",
            })["retrieved_ids"]
            assert ids == []

            # drop a bundle; scanner + worker run in SEPARATE processes
            bundle = inbox / "coherence-bundle"
            bundle.mkdir()
            (bundle / "transcript.json").write_text(json.dumps([
                {"speaker": "Ana", "start_ts_ms": 0, "end_ts_ms": 900,
                 "text": "the ECONNRESET fix landed in rollback v2.3.1"},
                {"speaker": "Raj", "start_ts_ms": 1000, "end_ts_ms": 1900,
                 "text": "object store tiering to SSD approved"},
            ]))
            (bundle / "_READY").touch()
            _run(SCANNER, env, tmp_path, "scanner")
            _run(WORKER, env, tmp_path, "worker")

            # job bookkeeping went through the shared store
            jobs = _get(port, "/ingest/jobs")["items"]
            assert jobs and jobs[0]["status"] == "succeeded"

            # the LIVE server picks the rows up via the syncer — no
            # restart
            deadline = time.monotonic() + 30
            ids = []
            while time.monotonic() < deadline:
                ids = _post(port, "/retrieve", {
                    "query": "ECONNRESET rollback v2.3.1",
                    "return_style": "ids_only",
                })["retrieved_ids"]
                if ids:
                    break
                time.sleep(0.2)
            assert any(i.startswith("chunk:") for i in ids), ids

            # auto-embed ran in the worker (store-only): the dense lane
            # must come up on the server once synced
            deadline = time.monotonic() + 30
            dense = False
            while time.monotonic() < deadline and not dense:
                resp = _post(port, "/retrieve", {
                    "query": "tiering to SSD approved",
                })
                dense = resp["notes"]["retrieval"]["lanes"]["dense"]
                if not dense:
                    time.sleep(0.2)
            assert dense
            assert resp["quotes"]

            # evidence expansion crosses back into the store correctly
            evidence_id = resp["quotes"][0]["evidence_id"]
            body = _post(port, "/expand", {"evidence_id": evidence_id})
            assert body["snippet"]
        finally:
            server.terminate()
            server.wait(timeout=30)
            log.close()
