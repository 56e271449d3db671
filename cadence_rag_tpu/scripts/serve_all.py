"""One-command deployment supervisor: api + scanner + worker (+ embed).

The reference's operational entry point is docker-compose.yml:22-102 —
api/scanner/worker/redis services with healthchecks, restart policies
and per-service env. This is the runnable equivalent for a bare host:
one command starts the full serving topology wired to one store,
supervises it, and tears it down cleanly.

    python -m cadence_rag_tpu.scripts.serve_all \
        --store /data/cadence.db --inbox /data/ingest \
        --port 8080 [--workers 2] [--embed-port 9090]

Processes (all children of this supervisor; SIGINT/SIGTERM stops all):

  api       serve/http.py — HTTP API + device index + StoreSyncer
  scanner   scripts/ingest_scanner.py — drop-folder -> job queue
  worker×N  scripts/ingest_worker.py — store-only ingest (the api's
            syncer applies device work; round-2 coherence design)
  embed     serve/embed_service.py (only with --embed-port) — the
            reference-wire /embed service; the api consumes it when
            EMBEDDINGS_BASE_URL points at it, else providers run
            in-process

Only the api process uses the accelerator (one JAX process per card:
each reserves most of the card's memory when it starts); every other
child runs with JAX_PLATFORMS=cpu.

Behavior matched to the compose file: children that die restart with
exponential backoff (restart: on-failure), the api is health-checked
over the real socket before dependents start (depends_on +
healthcheck), and env flows to every child (environment:). Logs
multiplex to stdout with service prefixes.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional


def _wait_health(port: int, timeout_s: float = 120.0) -> bool:
    """Poll the api's /health over a raw socket (no client deps)."""
    deadline = time.monotonic() + timeout_s
    req = (
        f"GET /health HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
        "Connection: close\r\n\r\n"
    ).encode()
    while time.monotonic() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port), 2.0) as s:
                s.sendall(req)
                data = s.recv(4096)
                if b'"status": "ok"' in data or b'"status":"ok"' in data:
                    return True
        except OSError:
            pass
        time.sleep(1.0)
    return False


class Service:
    def __init__(self, name: str, argv: List[str], env: Dict[str, str],
                 max_restarts: int = 5, backoff_base_s: float = 2.0):
        self.name = name
        self.argv = argv
        self.env = env
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.restarts = 0
        self.proc: Optional[subprocess.Popen] = None
        self.stopping = False

    def start(self) -> None:
        self.proc = subprocess.Popen(
            self.argv, env=self.env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, bufsize=1,
        )
        threading.Thread(
            target=self._pump, args=(self.proc,), daemon=True
        ).start()
        print(f"[serve_all] started {self.name} pid={self.proc.pid}",
              flush=True)

    def _pump(self, proc: subprocess.Popen) -> None:
        for line in proc.stdout or ():
            print(f"[{self.name}] {line.rstrip()}", flush=True)

    def poll_restart(self) -> bool:
        """Restart a dead child with backoff; False = gave up."""
        if self.stopping or self.proc is None:
            return True
        rc = self.proc.poll()
        if rc is None:
            return True
        if self.restarts >= self.max_restarts:
            print(f"[serve_all] {self.name} exited rc={rc}; restart "
                  f"budget ({self.max_restarts}) exhausted", flush=True)
            return False
        delay = self.backoff_base_s * (2 ** self.restarts)
        self.restarts += 1
        print(f"[serve_all] {self.name} exited rc={rc}; restart "
              f"{self.restarts}/{self.max_restarts} in {delay:.0f}s",
              flush=True)
        time.sleep(delay)
        self.start()
        return True

    def stop(self, grace_s: float = 15.0) -> None:
        self.stopping = True
        proc = self.proc
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(grace_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(5.0)


def build_services(args, base_env: Dict[str, str]) -> List[Service]:
    py = sys.executable
    services: List[Service] = []
    if args.embed_port:
        embed_env = dict(base_env)
        # one JAX process per card: the api process owns the device, so
        # the embed service runs its provider on the host CPU
        embed_env["JAX_PLATFORMS"] = "cpu"
        services.append(Service(
            "embed",
            [py, "-m", "cadence_rag_tpu.serve.embed_service",
             "--host", "127.0.0.1", "--port", str(args.embed_port),
             "--provider", args.embed_provider],
            embed_env,
        ))
        # the api + workers consume the served contract unless the
        # operator pinned an external one
        base_env.setdefault(
            "EMBEDDINGS_BASE_URL", f"http://127.0.0.1:{args.embed_port}"
        )
    api_env = dict(base_env)
    services.append(Service(
        "api",
        [py, "-m", "cadence_rag_tpu.serve.http",
         "--host", args.host, "--port", str(args.port)],
        api_env,
    ))
    scan_env = dict(base_env)
    scan_env["JAX_PLATFORMS"] = "cpu"  # host-only work
    services.append(Service(
        "scanner",
        [py, "-m", "cadence_rag_tpu.scripts.ingest_scanner"],
        scan_env,
    ))
    for i in range(args.workers):
        worker_env = dict(base_env)
        # workers never touch the device: store-only + CPU keeps them
        # off the card the api owns (ingest_worker sets store-only mode;
        # JAX_PLATFORMS pins any stray jit to the host)
        worker_env["JAX_PLATFORMS"] = "cpu"
        services.append(Service(
            f"worker{i}",
            [py, "-m", "cadence_rag_tpu.scripts.ingest_worker"],
            worker_env,
        ))
    return services


def main() -> None:
    parser = argparse.ArgumentParser(
        description="start api + scanner + worker(s) [+ embed] as one "
        "supervised deployment (reference: docker-compose.yml)"
    )
    parser.add_argument("--store", required=True,
                        help="shared SQLite store path (STORE_PATH)")
    parser.add_argument("--inbox", default="",
                        help="drop-folder root (INGEST_ROOT_DIR)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--embed-port", type=int, default=0,
                        help="also serve /embed on this port")
    parser.add_argument("--embed-provider", default="stub")
    parser.add_argument("--scanner", dest="scanner", action="store_true",
                        default=True)
    parser.add_argument("--no-scanner", dest="scanner",
                        action="store_false")
    parser.add_argument("--env", action="append", default=[],
                        metavar="KEY=VAL",
                        help="extra env for every service (repeatable)")
    args = parser.parse_args()

    base_env = dict(os.environ)
    base_env["STORE_PATH"] = args.store
    if args.inbox:
        base_env["INGEST_ROOT_DIR"] = args.inbox
    for kv in args.env:
        key, _, val = kv.partition("=")
        base_env[key] = val

    services = build_services(args, base_env)
    if not args.scanner:
        services = [s for s in services if s.name != "scanner"]

    # compose parity: the api must be healthy before dependents start
    api = next(s for s in services if s.name == "api")
    head = [s for s in services if s.name in ("embed", "api")]
    tail = [s for s in services if s not in head]
    stop_evt = threading.Event()

    def shutdown(_sig=None, _frm=None):
        stop_evt.set()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)

    for svc in head:
        svc.start()
    if not _wait_health(args.port):
        print("[serve_all] api never became healthy; aborting",
              flush=True)
        for svc in head:
            svc.stop()
        raise SystemExit(1)
    print(f"[serve_all] api healthy on :{args.port}", flush=True)
    for svc in tail:
        svc.start()

    try:
        while not stop_evt.is_set():
            for svc in services:
                if not svc.poll_restart():
                    if svc is api:
                        stop_evt.set()  # no api = no deployment
                    break
            stop_evt.wait(2.0)
    finally:
        print("[serve_all] stopping all services", flush=True)
        for svc in reversed(services):
            svc.stop()
        print("[serve_all] done", flush=True)


if __name__ == "__main__":
    main()
