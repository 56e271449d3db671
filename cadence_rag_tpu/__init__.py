"""cadence_rag_tpu — an accelerator-resident hybrid-retrieval RAG framework.

A from-scratch rebuild of the capabilities of ``bgconley/cadence-rag``
designed around one jitted device program:

- The retrieval core (dense cosine top-k, lexical BM25-style scoring,
  exact tech-token matching, RRF fusion, filter scoping) executes as a
  single jitted XLA program over device-resident index state instead of
  five sequential SQL queries against Postgres extensions
  (reference: app/retrieve.py:392-688).
- Index state is capacity-padded device arrays (embeddings, int8 lexical
  signatures, token-hash tables, call metadata) sharded over a
  ``jax.sharding.Mesh`` when the corpus outgrows one device.
- Host-side subsystems (metadata store, ingest pipelines, drop-folder job
  queue, HTTP API, eval gates) reproduce the reference's behavioral
  contracts without Postgres/Redis: SQLite + an in-process durable queue.

The JAX platform is chosen by ``JAX_PLATFORMS`` as usual.
"""

__version__ = "0.1.0"

import os as _os
from pathlib import Path as _Path

# Persistent compile cache: JAX reads JAX_COMPILATION_CACHE_DIR itself; when
# it is unset, keep compiled programs at a fixed path in the checkout (the
# path is part of the cache key, so it must not move between runs). Set at
# import, before anything in the package compiles.
CACHE_DIR = _Path(__file__).resolve().parent.parent / ".jax_cache"

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
