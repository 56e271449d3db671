"""Test bootstrap.

Tests run on CPU with 8 virtual devices so multi-device sharding is
exercised without accelerator hardware (the reference's analogue:
disposable-schema Postgres isolation, tests/conftest.py:46-126 — our
isolation is a tmp SQLite store per test plus a fresh in-memory device
index).

Must run before any jax import, hence the env mutation at module import.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
# No persistent compile cache: the xdist workers (and the subprocesses
# some tests start) would write the same files at once.
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture()
def tmp_store(tmp_path, monkeypatch):
    """Fresh settings bound to a throwaway SQLite store + a fresh device
    index (the disposable-namespace isolation pattern; reference analogue:
    tests/conftest.py:46-126 random Postgres schemas)."""
    from cadence_rag_tpu.config import settings
    from cadence_rag_tpu.core.index import reset_index
    from cadence_rag_tpu.ingest.ingest import set_store_only
    from cadence_rag_tpu.ingest.sync import reset_syncer
    from cadence_rag_tpu.store.db import reset_store

    monkeypatch.setattr(settings, "store_path", str(tmp_path / "store.db"))
    monkeypatch.setattr(settings, "embeddings_provider", "stub")
    monkeypatch.setattr(settings, "embeddings_base_url", "")
    monkeypatch.setattr(settings, "index_initial_capacity", 256)
    monkeypatch.setattr(settings, "lexical_dim", 1024)
    monkeypatch.setattr(settings, "embeddings_dim", 64)
    from cadence_rag_tpu.embed.provider import reset_embed_cache

    set_store_only(False)
    reset_store()
    reset_index()
    reset_syncer()
    reset_embed_cache()
    yield settings
    set_store_only(False)
    reset_store()
    reset_index()
    reset_syncer()
    reset_embed_cache()
