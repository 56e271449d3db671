"""TRUE multi-process distributed validation: two OS processes join a
jax.distributed coordinator, the device mesh spans both, and the
corpus-sharded lanes' collectives cross the process boundary (Gloo on
CPU — the same machinery DIST_COORDINATOR uses across GPU hosts).

The single-process 8-device mesh tests (test_parallel.py,
test_sharded_serving.py) cannot catch cross-process issues; this one
does. Runs the launcher CLI operators use: evals/dist_check.py."""

import socket
import subprocess
import sys


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class TestTwoProcessMesh:
    def test_dist_check_two_processes(self):
        port = _free_port()
        proc = subprocess.run(
            [sys.executable, "-m", "cadence_rag_tpu.evals.dist_check",
             "--processes", "2", "--devices-per-process", "2",
             "--port", str(port)],
            capture_output=True, text=True, timeout=600,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "DIST CHECK PASSED" in proc.stdout
        assert proc.stdout.count("MATCH") == 2, proc.stdout
