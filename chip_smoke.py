#!/usr/bin/env python3
"""Smoke test of the /retrieve path on a GPU, through its normal entry points.

    python chip_smoke.py                # one card: 1M chunks + 100k artifacts
    python chip_smoke.py --four-cards   # MESH_SHAPE=data:4: 4M + 400k, sharded

One process. Phases (default run):

a. index   — the 1M-chunk + 100k-artifact index built through core/index.py
             (evals/synth.install_synthetic_corpus) with its SQLite store;
             device memory, the fused program's compile and memory
             analysis, and the growth capacity core/prewarm plans from the
             card's free memory.
b. lanes   — every lane of the production program (ops/pack.py) at batch
             128 against plain numpy references on 16 sampled queries,
             half with call + date filters (evals/lane_check.py), in exact
             and ann dense modes; device RRF against the host oracle; the
             precision each dot runs at; dense storage in f32 and int8.
c. serve   — serve/http.py's normal start-up in-process on a local port,
             micro-batcher on, growth prewarm at its default: /health,
             /index/stats, ingest + read-your-write, ~32 concurrent
             /retrieve (ids_only and evidence packs, with and without
             filters), all batched (/metrics).
d. timing  — compile, first-call and median batch time of the fused
             program at batch 128.

--four-cards runs only the sharded path: the lane checks on a 4-card
``data:4`` index, the same batch on one card with identical ids, and the
serve phase over the sharded index.

Every finding is printed on a line labelled with the card's name and power
limit. The last line is the JSON result; any failure exits non-zero
without it. There is no CPU path: the script refuses to run unless JAX's
default backend is the GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

BATCH = 128
N_ONE_CARD = 1_000_000                # chunks; artifacts are a tenth
N_FOUR_CARDS = 4_000_000
SAMPLE_ROWS = list(range(16))        # checked against numpy
FILTERED_ROWS = list(range(8, 16))   # half of the sample: call + date
REPEATS = 20


def card_lines():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


class Log:
    def __init__(self, label: str) -> None:
        self.label = label
        self.failed = []
        self.t0 = time.perf_counter()

    def __call__(self, phase: str, msg: str) -> None:
        print(f"[{self.label}] +{time.perf_counter() - self.t0:.0f}s "
              f"{phase}: {msg}", flush=True)

    def check(self, phase: str, ok: bool, what: str) -> None:
        self(phase, f"{'PASS' if ok else 'FAIL'} {what}")
        if not ok:
            self.failed.append(f"{phase}: {what}")


def build_index(n_chunks: int):
    """The benchmark's corpus (bench.py: synthetic rows installed on the
    device, artifacts a tenth of the chunks) and its matching store rows.
    The store load runs on a thread while the device phases run; call
    ``.join()`` on the returned loader before serving."""
    from bench import N_CALLS

    from cadence_rag_tpu.config import settings
    from cadence_rag_tpu.core.index import get_index, reset_index
    from cadence_rag_tpu.evals.synth import (
        bulk_store_rows,
        install_synthetic_corpus,
    )
    from cadence_rag_tpu.store.db import get_store, reset_store

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    settings.store_path = os.path.join(workdir, "store.db")
    settings.embeddings_provider = "stub"
    settings.embeddings_base_url = ""
    settings.lexical_dim = 4096
    settings.index_initial_capacity = 4096
    settings.rerank_enabled = False
    reset_store()
    reset_index()
    index = get_index()
    index.ensure_call_capacity(N_CALLS)
    n_art = max(n_chunks // 10, 1024)
    install_synthetic_corpus(index.chunks, n_chunks, N_CALLS, seed=0)
    install_synthetic_corpus(index.artifacts, n_art, N_CALLS, seed=1)
    loader = StoreLoader(bulk_store_rows, get_store(), n_chunks, n_art,
                         N_CALLS)
    return index, workdir, loader


class StoreLoader(threading.Thread):
    """bulk_store_rows on a thread; ``join`` re-raises its error."""

    def __init__(self, fn, *args) -> None:
        super().__init__(daemon=True)
        self.fn, self.args = fn, args
        self.error = None
        self.seconds = 0.0
        self.start()

    def run(self) -> None:
        t0 = time.perf_counter()
        try:
            self.fn(*self.args)
        except BaseException as exc:  # re-raised by join
            self.error = exc
        self.seconds = time.perf_counter() - t0

    def join(self, timeout=None) -> None:
        super().join(timeout)
        if self.error is not None:
            raise RuntimeError("store load failed") from self.error


def host_corpora(index):
    from cadence_rag_tpu.evals.lane_check import HostCorpus

    return (HostCorpus.from_device(index.chunks.device_arrays()),
            HostCorpus.from_device(index.artifacts.device_arrays()))


def make_batch(chunks_host, seed=0):
    from bench import N_CALLS

    from cadence_rag_tpu.config import settings
    from cadence_rag_tpu.evals.lane_check import make_queries

    return make_queries(
        chunks_host, batch=BATCH, n_calls=N_CALLS,
        q_feats=int(settings.query_lex_features),
        tech_capacity=int(settings.tech_slot_capacity),
        filtered_rows=FILTERED_ROWS, seed=seed,
    )


def compile_program(index, qb, d_packed, *, mode, fuse_rrf):
    from bench import ARTIFACT_KS, CHUNK_KS

    from cadence_rag_tpu.evals.lane_check import program_kwargs
    from cadence_rag_tpu.ops.pack import dual_corpus_retrieve_packed

    args = (index.chunks.device_arrays(), index.artifacts.device_arrays(),
            d_packed)
    t0 = time.perf_counter()
    compiled = dual_corpus_retrieve_packed.lower(
        *args, **program_kwargs(qb, args[0], chunk_ks=CHUNK_KS,
                                artifact_ks=ARTIFACT_KS, mode=mode,
                                fuse_rrf=fuse_rrf),
    ).compile()
    return compiled, time.perf_counter() - t0


def run_compiled(compiled, index, d_packed):
    import jax

    flat = compiled(index.chunks.device_arrays(),
                    index.artifacts.device_arrays(), d_packed)
    return np.asarray(jax.device_get(flat))


def gemm_lines(hlo_text: str):
    """The matrix products of an optimized GPU program: cuBLAS calls and
    Triton GEMM fusions, with their operand types and any precision or
    algorithm the compiler recorded."""
    import re

    out = []
    for line in hlo_text.splitlines():
        line = line.strip()
        if not (" dot(" in line or "gemm" in line.lower()):
            continue
        if line.startswith(("ROOT %", "%")) and "=" in line:
            name = line.split("=", 1)[0].strip()
            types = re.findall(r"\b(bf16|f16|f32|s8|u8)\[[\d,]*\]", line)
            extra = re.findall(
                r"(operand_precision=\{[^}]*\}|algorithm=\w+|"
                r"\"precision_config\":\{[^}]*\}|__cublas\$\w+|"
                r"__triton\w*)", line)
            out.append(f"{name}: {' '.join(types[:4])} {' '.join(extra)}")
    return out


def precision_probe():
    """The precision each lane's product runs at on this card, read from
    a value only f32 products keep: 1 + 2**-12 rounds to 1 in TF32 and
    bf16. Uses the lane functions themselves at lane-like shapes."""
    import jax
    import jax.numpy as jnp

    from cadence_rag_tpu.ops.lexical import lexical_scores
    from cadence_rag_tpu.ops.topk import dense_scores

    n, d = 65536, 4096
    x = np.float32(1.0 + 2.0 ** -12)
    q = np.zeros((BATCH, d), np.float32)
    q[:, 0] = x
    ones8 = np.zeros((n, d), np.int8)
    ones8[:, 0] = 1
    onesf = np.zeros((n, 1024), np.float32)
    onesf[:, 0] = 1.0

    def kind(v):
        return "f32" if float(v) == float(x) else "tf32/bf16 (rounded)"

    lex = jax.jit(lexical_scores)(jnp.asarray(q), jnp.asarray(ones8))
    dense32 = jax.jit(dense_scores)(jnp.asarray(q[:, :1024]),
                                    jnp.asarray(onesf))
    densebf = jax.jit(dense_scores)(jnp.asarray(q[:, :1024]),
                                    jnp.asarray(onesf, jnp.bfloat16))
    return {
        "lexical f32 x int8->bf16": kind(lex[0, 0]),
        "dense f32 storage": kind(dense32[0, 0]),
        "dense bf16 storage": kind(densebf[0, 0]),
    }


def storage_variants(index, qb, chunks_host, say):
    """Dense lane with f32 and int8 storage at full width: the same rows
    re-encoded on the card, ops/topk.cosine_topk against the reference."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from bench import CHUNK_KS

    from cadence_rag_tpu.evals.lane_check import (
        DENSE_MIN_RECALL,
        dense_reference,
        set_recall,
    )
    from cadence_rag_tpu.ops.masks import filter_mask
    from cadence_rag_tpu.ops.topk import cosine_topk

    rows = SAMPLE_ROWS
    c = index.chunks
    emb_bf16 = c.emb

    @jax.jit
    def full_f32(e):
        # bf16 values carry 8 significant bits, which TF32 holds exactly;
        # a perturbation gives the rows all 24 bits of an f32
        x = e.astype(jnp.float32)
        x = x + 1e-3 * jax.random.normal(jax.random.PRNGKey(5), x.shape)
        return x / jnp.linalg.norm(x, axis=1, keepdims=True)

    variants = {
        "float32": full_f32(emb_bf16),
        "int8": jax.jit(lambda e: jnp.clip(
            jnp.round(e.astype(jnp.float32) * 127.0), -127, 127
        ).astype(jnp.int8))(emb_bf16),
    }
    mask = filter_mask(
        c.call_idx, c.started, jnp.asarray(qb.allowed[rows]),
        jnp.asarray(qb.date_min[rows]), jnp.asarray(qb.date_max[rows]),
    ) & c.has_emb[None, :]
    results = {}
    for name, emb in variants.items():
        q = jnp.asarray(qb.q_emb[rows].astype(np.float16).astype(np.float32))
        fn = jax.jit(lambda q, e, m: cosine_topk(q, e, m, CHUNK_KS[0]))
        scores, pos = jax.device_get(fn(q, emb, mask))
        host = dataclasses.replace(chunks_host, emb=np.asarray(emb))
        ref = dense_reference(host, qb, rows, CHUNK_KS[0])
        dev = (np.zeros((BATCH, CHUNK_KS[0]), np.float32) - np.inf,
               np.zeros((BATCH, CHUNK_KS[0]), np.int32))
        dev[0][rows] = scores
        dev[1][rows] = pos
        res = set_recall(dev, ref, rows)
        results[name] = res
        say.check("b.lanes", res["min"] >= DENSE_MIN_RECALL,
                  f"dense storage={name} exact recall@{CHUNK_KS[0]} "
                  f"mean={res['mean']:.4f} min={res['min']:.4f} "
                  f"(target >= {DENSE_MIN_RECALL} on every row)")
        del host
    del variants
    return results


def phase_lanes(index, qb, d_packed, chunks_host, artifacts_host, programs,
                say, label_extra=""):
    """Phase b: both modes, all lanes, against numpy. ``programs`` maps
    (mode, fuse_rrf) to compiled programs, and gains the missing ones.
    Returns the flat outputs per (mode, fuse_rrf)."""
    from bench import ARTIFACT_KS, CHUNK_KS

    from cadence_rag_tpu.evals.lane_check import (
        compare_lanes,
        failures,
        lane_references,
    )

    t0 = time.perf_counter()
    refs = lane_references(chunks_host, artifacts_host, qb, SAMPLE_ROWS,
                           chunk_ks=CHUNK_KS, artifact_ks=ARTIFACT_KS)
    say("b.lanes", f"{label_extra}numpy references for {len(SAMPLE_ROWS)} "
        f"queries ({len(FILTERED_ROWS)} filtered) in "
        f"{time.perf_counter() - t0:.1f} s")
    outputs = {}
    for mode in ("exact", "ann"):
        for fuse in (False, True):
            if (mode, fuse) not in programs:
                compiled, secs = compile_program(index, qb, d_packed,
                                                 mode=mode, fuse_rrf=fuse)
                programs[(mode, fuse)] = compiled
                say("b.lanes", f"{label_extra}compiled mode={mode} "
                    f"fuse_rrf={fuse} in {secs:.1f} s")
            outputs[(mode, fuse)] = run_compiled(programs[(mode, fuse)],
                                                 index, d_packed)
        res = compare_lanes(outputs[(mode, False)], outputs[(mode, True)],
                            refs, SAMPLE_ROWS, chunk_ks=CHUNK_KS,
                            artifact_ks=ARTIFACT_KS, mode=mode)
        bad = failures(res)
        for key, r in res.items():
            if key.endswith((".dense", ".lex")):
                what = "recall@k" if key.endswith(".dense") else "overlap"
                say("b.lanes", f"{label_extra}mode={mode} {key} {what} "
                    f"mean={r['mean']:.4f} min={r['min']:.4f}")
            elif key.endswith(".tech"):
                say("b.lanes", f"{label_extra}mode={mode} {key} identical="
                    f"{r['identical']} matched_ids={r['matches']}")
            else:
                say("b.lanes", f"{label_extra}mode={mode} rrf ids "
                    f"identical={r['identical']} over {r['rows']} rows")
        say.check("b.lanes", not bad,
                  f"{label_extra}mode={mode} all lanes within target"
                  + (f": {bad}" if bad else ""))
    return outputs


def phase_index(index, qb, d_packed, say, build_s, tag="a.index"):
    """Phase a: what the index and its program take on the card."""
    import jax

    from cadence_rag_tpu.core.prewarm import free_hbm_bytes, plan_next_capacity

    say(tag, f"jax.devices()={jax.devices()}")
    say(tag, f"built {index.chunks.count} chunks (capacity "
        f"{index.chunks.capacity}) + {index.artifacts.count} artifacts "
        f"(capacity {index.artifacts.capacity}) on the device in "
        f"{build_s:.1f} s; rows sharded {index.chunks.emb.sharding}")
    for dev in jax.local_devices():
        stats = dev.memory_stats() or {}
        say(tag, f"{dev} memory_stats: bytes_in_use="
            f"{stats.get('bytes_in_use')} peak_bytes_in_use="
            f"{stats.get('peak_bytes_in_use')} bytes_limit="
            f"{stats.get('bytes_limit')}")
    compiled, secs = compile_program(index, qb, d_packed, mode="ann",
                                     fuse_rrf=False)
    mem = compiled.memory_analysis()
    say(tag, f"fused program (ann, batch {BATCH}) compile "
        f"{secs:.1f} s; argument_bytes={mem.argument_size_in_bytes} "
        f"temp_bytes={mem.temp_size_in_bytes} "
        f"output_bytes={mem.output_size_in_bytes}")
    free = free_hbm_bytes()
    say.check(tag, free is not None, f"card reports free memory "
              f"{free} bytes")
    for corpus in (index.chunks, index.artifacts):
        nxt = plan_next_capacity(corpus, corpus.capacity + 1)
        say(tag, f"plan_next_capacity({corpus.name}) from "
            f"{corpus.capacity} -> {nxt}")
    return compiled, secs


def phase_precision(index, qb, chunks_host, compiled, say):
    for line in gemm_lines(compiled.as_text())[:12]:
        say("b.precision", f"HLO {line}")
    for dot, prec in precision_probe().items():
        say("b.precision", f"{dot}: runs at {prec}")
    storage_variants(index, qb, chunks_host, say)
    tech_ties(index, qb, chunks_host, say)


def tech_ties(index, qb, chunks_host, say):
    """The tech lane where ties are the rule: call-start seconds cut to
    whole years, so most matches share a key. The lane must still order
    them (started_sec desc, position asc)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from bench import CHUNK_KS

    from cadence_rag_tpu.evals.lane_check import (
        INT32_MIN,
        ordered_equal,
        tech_reference,
    )
    from cadence_rag_tpu.ops.masks import filter_mask
    from cadence_rag_tpu.ops.techlane import tech_topk

    rows = SAMPLE_ROWS
    k = CHUNK_KS[2]
    c = index.chunks
    year = 365 * 86400
    coarse = jax.jit(lambda st: jnp.where(
        st == INT32_MIN, st, st // year * year))(c.started)
    args = (jnp.asarray(qb.q_tech[rows]), jnp.asarray(qb.allowed[rows]),
            jnp.asarray(qb.date_min[rows]), jnp.asarray(qb.date_max[rows]))

    @jax.jit
    def lane(tech, started, call_idx, q, allowed, dmin, dmax):
        mask = filter_mask(call_idx, started, allowed, dmin, dmax)
        return tech_topk(tech, started, q, mask, k)

    got = jax.device_get(lane(c.tech, coarse, c.call_idx, *args))
    host = dataclasses.replace(chunks_host, started=np.asarray(coarse))
    ref = tech_reference(host, qb, rows, k)

    def widen(lane):
        return tuple(np.concatenate(
            [x, np.zeros((BATCH - len(rows),) + x.shape[1:], x.dtype)])
            for x in lane)

    res = ordered_equal(widen(got), ref, rows)
    ties = sum(len(r) - len(np.unique(host.started[r])) for r in ref)
    say.check("b.lanes", res["identical"],
              f"tech lane under ties ({ties} of {res['matches']} returned "
              f"ids share a key): ids and order identical")


def phase_timing(compiled, compile_s, index, d_packed, say):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(compiled(index.chunks.device_arrays(),
                                   index.artifacts.device_arrays(), d_packed))
    first = time.perf_counter() - t0
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(index.chunks.device_arrays(),
                                       index.artifacts.device_arrays(),
                                       d_packed))
        times.append(time.perf_counter() - t0)
    say("d.timing", f"fused program (ann, batch {BATCH}): compile "
        f"{compile_s:.2f} s, first call {first * 1e3:.2f} ms, median batch "
        f"{np.median(times) * 1e3:.3f} ms over {REPEATS} (min "
        f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f})")


# ------------------------------------------------------------------ serving

class Server:
    """serve/http.make_app on an aiohttp runner in a background thread."""

    def __init__(self) -> None:
        import asyncio
        import socket
        import threading

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            self.port = sock.getsockname()[1]
        self.loop = asyncio.new_event_loop()
        self.ready = threading.Event()
        self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        if not self.ready.wait(120) or self.error:
            raise RuntimeError(f"server did not start: {self.error}")

    def _run(self) -> None:
        import asyncio

        from aiohttp import web

        from cadence_rag_tpu.serve.http import make_app

        asyncio.set_event_loop(self.loop)
        try:
            self.runner = web.AppRunner(make_app())
            self.loop.run_until_complete(self.runner.setup())
            site = web.TCPSite(self.runner, "127.0.0.1", self.port)
            self.loop.run_until_complete(site.start())
        except Exception as exc:  # reported by __init__
            self.error = repr(exc)
            self.ready.set()
            return
        self.ready.set()
        self.loop.run_forever()

    def stop(self) -> None:
        import asyncio

        asyncio.run_coroutine_threadsafe(
            self.runner.cleanup(), self.loop
        ).result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)

    def request(self, method, path, body=None, timeout=600):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=timeout)
        try:
            payload = None if body is None else json.dumps(body).encode()
            headers = {"Content-Type": "application/json"} if body else {}
            conn.request(method, path, body=payload, headers=headers)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read() or b"null")
        finally:
            conn.close()


def _transcript(ext_id, lines):
    return {
        "call_ref": {"external_id": ext_id, "tags": ["smoke"]},
        "transcript": {"format": "json_turns", "content": [
            {"speaker": "A", "start_ts_ms": i * 1000,
             "end_ts_ms": i * 1000 + 900, "text": t}
            for i, t in enumerate(lines)
        ]},
        "options": {"target_tokens": 25, "max_tokens": 50,
                    "overlap_tokens": 4},
    }


def _well_formed(style, body) -> bool:
    if not isinstance(body, dict):
        return False
    if style == "ids_only":
        ids = body.get("retrieved_ids")
        return (isinstance(ids, list) and len(ids) > 0
                and all(isinstance(i, str) and ":" in i for i in ids))
    return (isinstance(body.get("quotes"), list) and len(body["quotes"]) > 0
            and isinstance(body.get("notes"), dict))


def phase_serve(index, loader, n_chunks, say):
    from concurrent.futures import ThreadPoolExecutor

    from cadence_rag_tpu.config import settings
    from cadence_rag_tpu.ingest.sync import get_syncer
    from cadence_rag_tpu.serve.api import startup

    t0 = time.perf_counter()
    loader.join()
    say("c.serve", f"store rows for {n_chunks} chunks loaded in "
        f"{loader.seconds:.1f} s on a thread (waited "
        f"{time.perf_counter() - t0:.1f} s here)")
    settings.retrieve_batch_window_ms = 5
    t0 = time.perf_counter()
    startup()
    server = Server()
    say("c.serve", f"startup + listen on 127.0.0.1:{server.port} in "
        f"{time.perf_counter() - t0:.1f} s (batch window "
        f"{settings.retrieve_batch_window_ms} ms, prewarm "
        f"{settings.prewarm_growth_enabled})")
    try:
        status, health = server.request("GET", "/health")
        say.check("c.serve", status == 200, f"GET /health {status} {health}")
        status, stats = server.request("GET", "/index/stats")
        say.check("c.serve", status == 200 and
                  stats["chunks"]["count"] == index.chunks.count,
                  f"GET /index/stats {status} chunks="
                  f"{stats['chunks']['count']} capacity="
                  f"{stats['chunks']['capacity']}")

        tokens = [f"v9{i}.7.{4400 + i}" for i in range(3)]
        call_ids = []
        for i, tok in enumerate(tokens):
            status, out = server.request("POST", "/ingest/transcript",
                                         _transcript(f"smoke-{i}", [
                f"the gateway on {tok} kept dropping sessions",
                f"rolling back from {tok} cleared the resets on shard {i}",
            ]))
            say.check("c.serve", status == 200 and out["chunks_created"] > 0,
                      f"POST /ingest/transcript {status} {out}")
            call_ids.append(out.get("call_id"))

        t0 = time.perf_counter()
        status, out = server.request("POST", "/retrieve", {
            "query": f"what happened after {tokens[1]}",
            "return_style": "ids_only",
        })
        new_ids = [int(x.split(":")[1]) for x in out.get("retrieved_ids", [])
                   if x.startswith("chunk:")
                   and int(x.split(":")[1]) > n_chunks]
        owner = None
        if new_ids:
            _, chunk = server.request("GET", f"/chunks/{new_ids[0]}")
            owner = chunk.get("call_id")
        say.check("c.serve", status == 200 and owner == call_ids[1],
                  f"read-your-write: /retrieve for {tokens[1]} returned new "
                  f"chunk ids {new_ids} of call {owner} "
                  f"({(time.perf_counter() - t0) * 1e3:.0f} ms incl. compile)")

        filters = [
            None,
            {"date_from": "2021-01-01T00:00:00Z",
             "date_to": "2023-12-31T23:59:59Z"},
            {"call_ids": [call_ids[0], call_ids[2]]},
        ]
        words = ["gateway retry budget", "object store rollback",
                 "tiering latency cluster", "ECONNRESET on the edge",
                 f"sessions dropping after {tokens[0]}",
                 "lenovo bake-off azure rollout"]
        reqs = []
        for i in range(32):
            body = {"query": f"{words[i % len(words)]} {i}",
                    "return_style": ("ids_only" if i % 2 == 0
                                     else "evidence_pack_json")}
            if filters[i % 3] is not None:
                body["filters"] = filters[i % 3]
            reqs.append(body)

        def burst(tag):
            _, before = server.request("GET", "/metrics")
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(reqs)) as pool:
                results = list(pool.map(
                    lambda b: server.request("POST", "/retrieve", b), reqs))
            wall = time.perf_counter() - t0
            _, after = server.request("GET", "/metrics")
            b0, b1 = before["retrieve_batches"], after["retrieve_batches"]
            n_batches = b1["count"] - b0["count"]
            n_batched = b1["requests"] - b0["requests"]
            ok = [s == 200 and _well_formed(b["return_style"], r)
                  for (s, r), b in zip(results, reqs)]
            say.check("c.serve", all(ok),
                      f"{tag}: {sum(ok)}/{len(reqs)} concurrent /retrieve "
                      f"200 and well formed (ids_only + evidence packs, "
                      f"{sum(1 for b in reqs if 'filters' in b)} filtered) "
                      f"in {wall:.2f} s")
            say.check("c.serve", n_batched == len(reqs)
                      and n_batches < len(reqs),
                      f"{tag}: all {n_batched} requests went through the "
                      f"micro-batcher in {n_batches} batches "
                      f"(max size so far {b1['max_size']})")
            return results

        burst("burst 1 (compiles the batch shapes)")
        burst("burst 2 (warm)")
        status, metrics = server.request("GET", "/metrics")
        entry = metrics["endpoints"].get("POST /retrieve", {})
        say("c.serve", f"/metrics POST /retrieve count={entry.get('count')} "
            f"errors={entry.get('errors')} p50_ms={entry.get('p50_ms')} "
            f"p99_ms={entry.get('p99_ms')} batches="
            f"{metrics['retrieve_batches']}")
        _, stats = server.request("GET", "/index/stats")
        say("c.serve", f"/index/stats prewarm_compiled="
            f"{stats['prewarm_compiled']} chunks={stats['chunks']['count']}")
    finally:
        server.stop()
        get_syncer().stop()


# ------------------------------------------------------------------ runs

def prepare(n_chunks, say, tag):
    """Build the index, copy it to the host, make the query batch and
    compile the fused program (phase a)."""
    import jax

    t0 = time.perf_counter()
    index, workdir, loader = build_index(n_chunks)
    build_s = time.perf_counter() - t0
    chunks_host, artifacts_host = host_corpora(index)
    qb = make_batch(chunks_host)
    d_packed = jax.numpy.asarray(qb.packed())
    compiled, compile_s = phase_index(index, qb, d_packed, say, build_s,
                                      tag=tag)
    return (index, workdir, loader, chunks_host, artifacts_host, qb,
            d_packed, compiled, compile_s)


def run_one_card(say):
    (index, workdir, loader, chunks_host, artifacts_host, qb, d_packed,
     compiled, compile_s) = prepare(N_ONE_CARD, say, "a.index")
    try:
        phase_lanes(index, qb, d_packed, chunks_host, artifacts_host,
                    {("ann", False): compiled}, say)
        del artifacts_host
        phase_precision(index, qb, chunks_host, compiled, say)
        del chunks_host
        phase_timing(compiled, compile_s, index, d_packed, say)
        phase_serve(index, loader, N_ONE_CARD, say)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run_four_cards(say):
    import jax

    from bench import ARTIFACT_KS, CHUNK_KS

    from cadence_rag_tpu.config import settings
    from cadence_rag_tpu.evals.lane_check import run_packed, split_lanes

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, have "
                           f"{len(jax.devices())}")
    settings.mesh_shape = "data:4"
    (index, workdir, loader, chunks_host, artifacts_host, qb, d_packed,
     compiled, compile_s) = prepare(N_FOUR_CARDS, say, "4.index")
    try:
        outputs = phase_lanes(index, qb, d_packed, chunks_host,
                              artifacts_host, {("ann", False): compiled},
                              say, label_extra="data:4 ")
        del chunks_host, artifacts_host
        # the same batch against the same corpus on one card
        one = jax.devices()[0]
        single = [tuple(jax.device_put(a, one) for a in c.device_arrays())
                  for c in (index.chunks, index.artifacts)]
        t0 = time.perf_counter()
        flat1 = run_packed(single[0], single[1], qb, chunk_ks=CHUNK_KS,
                           artifact_ks=ARTIFACT_KS, mode="ann",
                           fuse_rrf=False)
        say("4.single", f"one-card program at {index.chunks.count} rows "
            f"compiled + ran in {time.perf_counter() - t0:.1f} s")
        del single
        sharded = split_lanes(outputs[("ann", False)], chunk_ks=CHUNK_KS,
                              artifact_ks=ARTIFACT_KS, mode="ann")
        alone = split_lanes(flat1, chunk_ks=CHUNK_KS,
                            artifact_ks=ARTIFACT_KS, mode="ann")
        diffs = []
        for name, a, b in zip(("chunks", "artifacts"), sharded, alone):
            for lane in a:
                for row in range(BATCH):
                    fa = a[lane][1][row][np.isfinite(a[lane][0][row])]
                    fb = b[lane][1][row][np.isfinite(b[lane][0][row])]
                    same = (np.array_equal(fa, fb) if lane == "tech"
                            else set(fa.tolist()) == set(fb.tolist()))
                    if not same:
                        diffs.append((name, lane, row))
        say.check("4.single", not diffs,
                  f"sharded data:4 ids identical to one card for all "
                  f"{BATCH} queries x 6 lanes"
                  + (f": {diffs[:8]}" if diffs else ""))
        phase_timing(compiled, compile_s, index, d_packed, say)
        phase_serve(index, loader, N_FOUR_CARDS, say)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card sharded path")
    args = parser.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default backend is "
              f"{jax.default_backend()}", file=sys.stderr)
        return 2
    cards = card_lines()
    say = Log(cards[0])
    say("start", f"jax {jax.__version__}, {len(jax.devices())} "
        f"{jax.devices()[0].device_kind}, XLA_FLAGS="
        f"{os.environ.get('XLA_FLAGS', '')!r}")
    os.environ.setdefault("TMPDIR", tempfile.gettempdir())
    try:
        if args.four_cards:
            run_four_cards(say)
        else:
            run_one_card(say)
    except Exception as exc:
        import traceback

        traceback.print_exc()
        say.failed.append(f"exception: {exc!r}")
    if say.failed:
        for what in say.failed:
            print(f"FAILED {what}", file=sys.stderr, flush=True)
        return 1
    for line in cards:
        print(line, flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # background threads (growth prewarm compiles, the store syncer) are
    # daemons; leave without waiting on them
    os._exit(code)
