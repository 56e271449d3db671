"""What the program promises about the backend it runs on: the approximate
top-k is exact off the platforms that lower it natively, the compile cache
lands where the rules say, growth planning does not guess device memory,
and chip_smoke.py refuses to run without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]


def test_masked_topk_approx_equals_exact_on_cpu():
    from cadence_rag_tpu.ops.topk import masked_topk_approx, masked_topk_exact

    rng = np.random.default_rng(0)
    scores = jnp.asarray(rng.standard_normal((8, 5000)).astype(np.float32))
    mask = jnp.asarray(rng.random((8, 5000)) < 0.3)
    ev, ei = masked_topk_exact(scores, mask, 50)
    av, ai = masked_topk_approx(scores, mask, 50, recall_target=0.9)
    np.testing.assert_array_equal(np.asarray(av), np.asarray(ev))
    np.testing.assert_array_equal(np.asarray(ai), np.asarray(ei))


_CACHE_PROBE = (
    "import cadence_rag_tpu, jax, jax.numpy as jnp\n"
    "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
    "jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)\n"
    "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.arange(7.0)).block_until_ready()\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


def _cache_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",
                        "JAX_ENABLE_COMPILATION_CACHE")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), **extra)
    return env


def test_compile_cache_uses_the_env_dir_when_set(tmp_path):
    cache = tmp_path / "cache"
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], cwd=tmp_path,
        env=_cache_env(JAX_COMPILATION_CACHE_DIR=str(cache)),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(cache)
    assert any(cache.iterdir()), "no cache entry written"


def test_compile_cache_defaults_to_the_checkout(tmp_path):
    import cadence_rag_tpu

    assert cadence_rag_tpu.CACHE_DIR == REPO / ".jax_cache"
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], cwd=tmp_path,
        env=_cache_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(REPO / ".jax_cache")
    assert any((REPO / ".jax_cache").iterdir())


def test_growth_planning_refuses_a_gpu_without_memory_stats(monkeypatch):
    from cadence_rag_tpu.core import prewarm

    class Corpus:
        capacity = 1024
        row_sharding = None
        dim, lex_dim, tech_slots = 64, 256, 8
        emb_dtype = np.dtype(np.float32)

    monkeypatch.setattr(prewarm, "free_hbm_bytes", lambda: None)
    # the CPU stands in with the static budget
    assert prewarm.plan_next_capacity(Corpus(), 1025) == 2048
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(RuntimeError, match="memory_stats"):
        prewarm.plan_next_capacity(Corpus(), 1025)


def test_metrics_count_micro_batches():
    from cadence_rag_tpu.serve.metrics import MetricsRegistry

    reg = MetricsRegistry()
    reg.observe_batch(3)
    reg.observe_batch(29)
    assert reg.snapshot()["retrieve_batches"] == {
        "count": 2, "requests": 32, "max_size": 29,
    }
    reg.reset()
    assert reg.snapshot()["retrieve_batches"]["count"] == 0


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_a_gpu(tmp_path, where):
    if where == "repo":
        cwd = REPO
    else:
        cwd = tmp_path
        shutil.copy(REPO / "chip_smoke.py", cwd / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs a GPU" in out.stderr
