"""Throughput/footprint bench for the Qwen3-shaped encoder.

Can this framework HOST the reference's actual embedding workload
(Qwen3-Embedding-4B-class forward pass: P620 runbook:32-35, 703-715)?
Measures texts/s and device-memory footprint at serving shapes on the
accelerator, next to (or instead of) the retrieval index.

Weights are synthetic (none ship in this image) and generated ON DEVICE;
the compute/memory profile is identical to a real checkpoint.

Usage:
  python -m cadence_rag_tpu.evals.qwen3_bench [--preset 4b]
      [--configs 8x128,8x512,4x1024] [--iters 8]

Methodology: jits defined once, weights generated on the device,
pipelined timing (enqueue iters, one device_get readback bound).
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def run(preset_name: str, configs, iters: int) -> None:
    from ..models import qwen3 as q3

    cfg = q3.preset(preset_name)
    n_params = cfg.param_count()
    t0 = time.perf_counter()
    params = q3.init_params(cfg, jax.random.PRNGKey(0))
    jax.block_until_ready(params)
    init_s = time.perf_counter() - t0
    weight_gb = n_params * 2 / 1e9  # bf16 (norms f32 are negligible)
    print(json.dumps({
        "preset": preset_name, "params": n_params,
        "weight_gb": round(weight_gb, 2), "init_s": round(init_s, 1),
    }), flush=True)

    encode = jax.jit(lambda p, t: q3.encode(p, t, cfg))
    rng = np.random.default_rng(0)
    for batch, seq in configs:
        tokens = rng.integers(
            1, cfg.vocab_buckets, size=(batch, seq)
        ).astype(np.int32)
        tok_dev = jax.device_put(jnp.asarray(tokens))
        t0 = time.perf_counter()
        out = jax.block_until_ready(encode(params, tok_dev))
        compile_s = time.perf_counter() - t0
        # pipelined: enqueue iters batches, readback of the LAST output
        # bounds the serialized device queue
        t0 = time.perf_counter()
        for _ in range(iters):
            out = encode(params, tok_dev)
        np.asarray(out)
        elapsed = time.perf_counter() - t0
        ms = elapsed / iters * 1e3
        print(json.dumps({
            "preset": preset_name, "batch": batch, "seq": seq,
            "compile_s": round(compile_s, 1),
            "ms_per_batch": round(ms, 1),
            "texts_per_s": round(batch / (ms / 1e3), 1),
            "tokens_per_s": round(batch * seq / (ms / 1e3), 0),
            "out_dim": int(out.shape[1]),
        }), flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="4b")
    p.add_argument("--configs", default="8x128,8x512,4x1024")
    p.add_argument("--iters", type=int, default=8)
    args = p.parse_args()
    configs = []
    for part in args.configs.split(","):
        b, s = part.strip().split("x")
        configs.append((int(b), int(s)))
    run(args.preset, configs, args.iters)


if __name__ == "__main__":
    main()
