"""Multi-process distributed smoke check (multi-host readiness).

Validates that the corpus-sharded retrieval lanes produce oracle-correct
results when the mesh SPANS PROCESS BOUNDARIES — i.e. that the
`DIST_COORDINATOR` path (serve/api.py startup) actually works, with
collectives crossing processes, not just a single-process multi-device
mesh. By default it runs on the CPU backend (Gloo transport), which
exercises the same jax.distributed + GSPMD machinery; ``--real-backend``
runs on the default backend instead, each process on its own
``--devices-per-process`` cards of one host (the launcher sets each
worker's CUDA_VISIBLE_DEVICES, e.g. 4 processes x 1 GPU, collectives over
NCCL).

Run as the coordinator-launcher (spawns the workers):
    python -m cadence_rag_tpu.evals.dist_check [--processes 2]
        [--devices-per-process 4] [--port 19911] [--real-backend]

or as one worker of an externally-launched gang (e.g. on real hosts):
    python -m cadence_rag_tpu.evals.dist_check --worker --process-id K \
        --processes N --coordinator host:port --real-backend
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def run_worker(
    process_id: int, n_processes: int, coordinator: str,
    devices_per_process: int, force_cpu: bool,
) -> int:
    if force_cpu:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags +
                f" --xla_force_host_platform_device_count={devices_per_process}"
            ).strip()
    import jax

    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=n_processes,
        process_id=process_id,
    )
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ..ops.fused import multi_lane_retrieve
    from ..parallel.sharded import sharded_multi_lane

    n_devices = jax.device_count()
    mesh = Mesh(np.array(jax.devices()).reshape(n_devices), ("data",))

    # identical seed on every process -> identical global inputs (SPMD)
    rng = np.random.default_rng(0)
    n, dim, dlex, s, batch = 64 * n_devices, 64, 256, 4, 2
    emb = rng.standard_normal((n, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    lex = rng.integers(-4, 5, size=(n, dlex)).astype(np.int8)
    tech = np.zeros((n, s), dtype=np.int32)
    tech[::7, 0] = 99
    call_idx = (np.arange(n) % 16).astype(np.int32)
    started = rng.integers(1000, 5000, size=n).astype(np.int32)
    has_emb = np.ones(n, bool)
    q_emb = emb[:batch].copy()
    q_lex = (rng.standard_normal((batch, dlex)) * 0.1).astype(np.float32)
    from ..ops.hashing import tech_query_structure_from_hashes

    q_tech = np.stack(
        [tech_query_structure_from_hashes([99], s) for _ in range(batch)]
    )
    allowed = np.ones((batch, 16), dtype=bool)
    dmin = np.zeros(batch, np.int32)
    dmax = np.full(batch, 2**31 - 1, np.int32)

    def make_global(arr, spec):
        sharding = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    lanes = sharded_multi_lane(
        mesh,
        make_global(emb, P("data", None)),
        make_global(lex, P("data", None)),
        make_global(tech, P("data", None)),
        make_global(call_idx, P("data")),
        make_global(started, P("data")),
        make_global(has_emb, P("data")),
        make_global(q_emb, P()), make_global(q_lex, P()),
        make_global(q_tech, P()), make_global(allowed, P()),
        make_global(dmin, P()), make_global(dmax, P()),
        k_dense=8, k_lex=8, k_tech=8,
    )
    got = {k: (np.asarray(v[0].addressable_data(0)),
               np.asarray(v[1].addressable_data(0)))
           for k, v in lanes.items()}

    single = multi_lane_retrieve(
        jnp.asarray(emb), jnp.asarray(lex), jnp.asarray(tech),
        jnp.asarray(call_idx), jnp.asarray(started), jnp.asarray(has_emb),
        jnp.asarray(q_emb), jnp.asarray(q_lex), jnp.asarray(q_tech),
        jnp.asarray(allowed), jnp.asarray(dmin), jnp.asarray(dmax),
        k_dense=8, k_lex=8, k_tech=8,
    )
    ok = True
    for lane in ("dense", "lex", "tech"):
        s_scores, s_pos = (np.asarray(x) for x in single[lane])
        m_scores, m_pos = got[lane]
        for b in range(batch):
            s_set = {int(p) for p, v in zip(s_pos[b], s_scores[b])
                     if np.isfinite(v)}
            m_set = {int(p) for p, v in zip(m_pos[b], m_scores[b])
                     if np.isfinite(v)}
            if s_set != m_set:
                ok = False
                print(f"proc{process_id} MISMATCH lane={lane} b={b}",
                      flush=True)
    print(
        f"proc{process_id}: sharded lanes "
        f"{'MATCH' if ok else 'FAIL'} across {n_processes} processes "
        f"({n_devices} global devices, {jax.default_backend()} "
        f"{jax.local_devices()[0].device_kind})", flush=True,
    )
    return 0 if ok else 1


def launch(n_processes: int, devices_per_process: int, port: int,
           real_backend: bool = False) -> int:
    coordinator = f"127.0.0.1:{port}"
    procs = []
    for pid in range(n_processes):
        # unbuffered, with faulthandler: a worker that dies in native
        # code still leaves its last output and a Python stack
        cmd = [sys.executable, "-u", "-X", "faulthandler",
               "-m", "cadence_rag_tpu.evals.dist_check",
               "--worker", "--process-id", str(pid),
               "--processes", str(n_processes),
               "--coordinator", coordinator,
               "--devices-per-process", str(devices_per_process)]
        env = dict(os.environ)
        if real_backend:
            cmd.append("--real-backend")
            # each worker opens only its own cards
            first = pid * devices_per_process
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                str(i) for i in range(first, first + devices_per_process))
            # XLA splits GEMM autotuning across a gang's processes by
            # default; with 4 processes x 1 H100 the workers left without
            # a share died by SIGSEGV compiling the first dot
            env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                                " --xla_gpu_shard_autotuning=false").strip()
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        ))
    rc = 0
    for pid, proc in enumerate(procs):
        out, _ = proc.communicate(timeout=600)
        tail = [ln for ln in out.splitlines() if "sharded lanes" in ln
                or "MISMATCH" in ln]
        if proc.returncode != 0:
            print(f"proc{pid}: exit status {proc.returncode}; output "
                  f"tail:\n{out[-8000:]}", flush=True)
        else:
            print("\n".join(tail) or out[-500:], flush=True)
        rc = rc or (1 if proc.returncode != 0 else 0)
    print("DIST CHECK", "PASSED" if rc == 0 else "FAILED", flush=True)
    return rc


def main() -> None:
    parser = argparse.ArgumentParser(
        description="multi-process distributed smoke check"
    )
    parser.add_argument("--processes", type=int, default=2)
    parser.add_argument("--devices-per-process", type=int, default=4)
    parser.add_argument("--port", type=int, default=19911)
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--process-id", type=int, default=0)
    parser.add_argument("--coordinator", default="")
    parser.add_argument("--real-backend", action="store_true",
                        help="use the default backend (GPUs), each process "
                        "on its own --devices-per-process local devices")
    args = parser.parse_args()
    if args.worker:
        sys.exit(run_worker(
            args.process_id, args.processes, args.coordinator,
            args.devices_per_process, force_cpu=not args.real_backend,
        ))
    sys.exit(launch(args.processes, args.devices_per_process, args.port,
                    real_backend=args.real_backend))


if __name__ == "__main__":
    main()
