"""Environment-backed configuration.

Reproduces the reference's single-settings-object pattern
(reference: app/config.py:4-44) without pydantic-settings (not available in
this image): a dataclass whose fields are populated from environment
variables (upper-cased field name), with an optional ``.env`` file.

Adds the device-index knobs that have no reference counterpart: index
capacities/dtypes, lexical signature dimensionality, ANN recall target and
mesh shape (SURVEY.md §5 "config/flag system").
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path


def _parse_bool(raw: str) -> bool:
    return raw.strip().lower() in {"1", "true", "yes", "on"}


def _load_env_file(path: str) -> dict:
    values: dict = {}
    p = Path(path)
    if not p.is_file():
        return values
    for line in p.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, val = line.partition("=")
        values[key.strip().upper()] = val.strip().strip("'\"")
    return values


@dataclasses.dataclass
class Settings:
    # --- host metadata store (replaces DATABASE_URL/Postgres) ---
    store_path: str = "./cadence_rag.db"
    skip_version_check: bool = False

    # --- embedding provider (HTTP contract parity: app/embeddings.py) ---
    embeddings_base_url: str = ""
    embeddings_model_id: str = "Qwen/Qwen3-Embedding-4B"
    embeddings_dim: int = 1024
    embeddings_timeout_s: float = 180.0
    embeddings_batch_size: int = 32
    # "stub" = deterministic hash embedder (tests/bench); "http" = external
    # service; "neural" = in-process JAX embedder (models/embedder.py).
    embeddings_provider: str = ""

    # --- dense planner (parity: app/retrieve.py:277-300) ---
    embeddings_exact_scan_threshold: int = 2000
    embeddings_hnsw_ef_search: int = 80

    # --- filesystem ingest queue (parity: app/ingest_fs.py) ---
    ingest_queue_name: str = "ingest"
    ingest_root_dir: str = "./ingest"
    ingest_poll_seconds: int = 5
    ingest_auto_manifest: bool = True
    ingest_single_file_min_age_s: int = 5
    ingest_job_max_attempts: int = 3
    ingest_job_retry_backoff_s: int = 10
    ingest_auto_embed_on_success: bool = True
    ingest_auto_embed_fail_on_error: bool = False

    # --- analysis PDF OCR (parity: app/config.py:27-34) ---
    analysis_pdf_ocr_enabled: bool = False
    analysis_pdf_ocr_command: str = "ocrmypdf"
    analysis_pdf_ocr_languages: str = "eng"
    analysis_pdf_ocr_min_chars: int = 400
    analysis_pdf_ocr_min_alpha_ratio: float = 0.55
    analysis_pdf_ocr_max_pages: int = 150
    analysis_pdf_ocr_timeout_s: int = 600
    analysis_pdf_ocr_force: bool = False

    log_level: str = "INFO"

    # --- device-index knobs (no reference counterpart) ---
    # Device index capacity is padded to these sizes; growing beyond a
    # capacity re-jits once per doubling (core/index.py).
    index_initial_capacity: int = 4096
    # Embedding storage dtype: "bfloat16" (default), "float32", or "int8"
    # (unit vectors quantized round(x*127) at insert — halves dense-lane
    # HBM traffic and checkpoint size vs bf16; scoring widens in-register
    # and accumulates f32). IVF works under int8: k-means clusters the
    # DEQUANTIZED snapshot and probed scores rescale by 1/127
    # (ops/ivf.py; parity-tested in tests/integration/test_ivf_mode.py).
    index_embedding_dtype: str = "bfloat16"
    lexical_dim: int = 4096                  # hashed BM25 signature buckets
    lexical_dtype: str = "int8"
    # Vocab-head size used by scripts/build_lex_vocab.py: the top-df
    # features learned from the corpus get dedicated collision-free
    # buckets [0, head) (ops/hashing.apply_vocab; measured top-10 overlap
    # vs collision-free BM25 at D=4096: 0.87 -> ~0.96). Build-time knob —
    # the ACTIVE head rides with the store's lex_vocab table.
    lex_vocab_head: int = 2048
    # Drift-triggered automatic vocab rebuild (core/vocab.
    # auto_rebuild_if_needed, checked from the serving process's store
    # syncer loop). Opt-in: the rebuild re-featurizes the whole corpus
    # in-process (writes stall behind the vocab gate for its duration;
    # reads serve with transiently mixed lexical layout) and assumes
    # THIS process is the coherent owner of the layout — multi-process
    # gangs stand down, and concurrently-written worker rows are
    # repaired via lex_vocab_version provenance at rehydration.
    lex_vocab_auto_rebuild: bool = False
    # trigger: this many tail buckets hotter than the head's median df
    # (frequent NEW features are hashing into the collision tail)
    lex_vocab_drift_buckets: int = 64
    # ... AND the corpus grew by this factor since the active build
    lex_vocab_rebuild_min_growth: float = 1.5
    # with no vocab yet, bootstrap one once live docs reach this count
    # (0 = never bootstrap automatically)
    lex_vocab_bootstrap_docs: int = 0
    lex_vocab_rebuild_check_s: float = 300.0
    lex_vocab_rebuild_cooldown_s: float = 3600.0
    tech_hash_slots: int = 16                # token-hash slots per document
    # STARTING per-slot query capacity: the tech compare runs C
    # slot-aligned (B,N,S) passes, and C escalates per query (doubling to
    # a ceiling of max(8, 4*start)) whenever tokens would drop — so this
    # sets the cost of the COMMON case, not the token budget. C=1 covers
    # every 1-token query and most 2-3-token ones (a drop needs two
    # tokens colliding on a slot choice, ~1/S each way); each extra pass
    # re-reads the (N, S) slot table. Identifier-heavy queries widen
    # their own batch only (batches pad to the widest member).
    tech_slot_capacity: int = 1
    query_lex_features: int = 256            # sparse query-transfer width
    # RRF fusion ON DEVICE (ops/fusion.rrf_fuse_lanes_device): the fused
    # program returns merged (ids, scores, lane-masks) directly, skipping
    # the host per-lane postprocess + merge. Scores accumulate f32 on
    # device vs f64 on host, so
    # candidates whose fused scores differ by < ~1e-7 may swap order vs
    # the host oracle (true ties break identically). Debug-mode queries,
    # cold-tier corpora and separate-IVF dispatches always use the host
    # path; 0 restores it everywhere.
    device_rrf_enabled: bool = True
    # Background capacity growth (core/index.GrowthMigration): once the
    # prewarmer has the next capacity's query program warm, the target
    # buffers allocate+fill on a daemon thread and growth becomes a
    # pointer swap — serving never waits on the alloc+copy window
    # (Postgres never blocks reads while an index grows). 0 restores
    # synchronous lock-held growth everywhere.
    growth_migration_enabled: bool = True
    # Issue copy_to_host_async() on the fused program's output right at
    # dispatch: the D2H copy is queued behind the execute, so by the time
    # collect_packed blocks the bytes are already on host and host work
    # done between dispatch and collect overlaps the readback (what lets
    # the pipelined depth-2/3 server overlap assembly with readback). 0
    # restores request-at-collect.
    readback_prefetch_enabled: bool = True
    # lax.approx_max_k recall knob; only a backend with a native
    # approx_max_k lowering reads it — elsewhere the call is exact
    ann_recall_target: float = 0.95
    # IVF dense mode (opt-in): probed-cluster scan for large corpora.
    dense_ivf_enabled: bool = False
    ivf_min_rows: int = 200_000              # use IVF above this row count
    ivf_clusters: int = 0                    # 0 = auto sqrt(N)
    ivf_nprobe: int = 0                      # 0 = auto 8% of clusters (>=4)
    # Multi-host gangs: the automatic background IVF rebuild is a gang
    # k-means that holds the (shared) corpus lock — serving pauses for
    # the full build (minutes at 1M rows). Off by default so a capacity
    # event can't silently freeze a production leader; rebuild explicitly
    # via scripts/build_ivf.py, or opt in here.
    dense_ivf_auto_rebuild_multihost: bool = False
    # Beyond-HBM cold tier (core/coldtier.py): rows past this count per
    # corpus spill to host RAM and are scanned by the same fused lane
    # program in blocks streamed through the device per batch; results
    # merge with the hot tier before RRF (bit-identical to an uncapped
    # index, tested). 0 = off. Not combinable with MESH_SHAPE or
    # multi-process gangs — those are the scale-OUT paths.
    index_max_device_rows: int = 0
    cold_block_rows: int = 262144            # rows per streamed cold block
    retrieve_batch_window_ms: int = 0        # server-side query batching
    # Coalesce IDENTICAL requests within a micro-batch (same query,
    # filters, budget, style, debug): plan/embed/dispatch/assemble once,
    # fan the response out per request with fresh query_ids. Every stage
    # is a deterministic function of the request, so duplicates — hot
    # queries, thundering herds, retries landing in one batch window —
    # pay for one execution (engine/retrieve._coalesce_payloads).
    retrieve_coalesce_enabled: bool = True
    # Live store->index sync: the serving process tails the store's
    # trigger-maintained mutation log so writes by OTHER processes
    # (worker daemon, backfill CLIs) become retrievable without a
    # restart (ingest/sync.py). 0 disables the background poll.
    store_sync_interval_s: float = 1.0
    # Growth-compile prewarm: AOT-compile the fused program for the NEXT
    # capacity before fill crosses the doubling threshold (zero-HBM
    # jit.lower().compile(); core/prewarm.py), so the first query after
    # a doubling does not wait for a fresh compile.
    prewarm_growth_enabled: bool = True
    prewarm_fill_fraction: float = 0.75      # trigger at this fill level
    prewarm_min_capacity: int = 65536        # small corpora compile fast
    # Device-memory budget for growth planning on the CPU backend only
    # (core/prewarm.plan_next_capacity): a GPU reports its free memory
    # and planning reads that; the CPU reports none, so this stands in.
    # Growth degrades from a doubling to a fractional step when the
    # transient old+new footprint would exceed the budget.
    prewarm_hbm_budget_gb: float = 14.0
    embedder_params_path: str = ""           # trained weights for "neural"
    # Qwen3-shaped in-process encoder (EMBEDDINGS_PROVIDER=qwen3,
    # models/qwen3.py): the reference-scale embedding workload hosted on
    # the mesh. Preset "4b" is the Qwen3-Embedding-4B geometry (synthetic
    # weights unless QWEN3_PARAMS_PATH points at a real checkpoint);
    # "tiny" is the CPU-test shape.
    qwen3_preset: str = "4b"
    qwen3_params_path: str = ""
    # Real BPE vocab (models/tokenizer.py): a HuggingFace tokenizer.json
    # (or a directory with vocab.json+merges.txt). Empty = the offline
    # FNV-1a hash tokenizer (synthetic-weight runs). Required for real
    # checkpoints — hash ids don't match a trained embedding table.
    qwen3_tokenizer_path: str = ""
    # Cross-request embedding LRU (embed/provider.py): hot queries that
    # repeat ACROSS batch windows skip the provider (coalescing already
    # dedupes within a window). 0 = off (reference behavior); entries
    # keyed by provider/model/dim/weights so config changes invalidate.
    embed_cache_size: int = 0
    profiler_port: int = 0                   # jax.profiler server (0 = off)
    # Phase-4 rerank lane (BASELINE.md config 5)
    rerank_enabled: bool = False
    rerank_provider: str = "lexical"         # "lexical" | "neural"
    rerank_topk: int = 50
    reranker_params_path: str = ""           # distilled weights for "neural"
    # e.g. "data:4,model:2"; empty = one device
    mesh_shape: str = ""
    # Multi-host coordinated startup (jax.distributed). Empty = single
    # process. Set DIST_COORDINATOR=host:port on every process, plus
    # DIST_NUM_PROCESSES / DIST_PROCESS_ID, before starting the server.
    dist_coordinator: str = ""
    dist_num_processes: int = 0
    dist_process_id: int = 0
    # Device-index op-log port for multi-host lockstep serving
    # (parallel/oplog.py); 0 = coordinator port + 1.
    dist_oplog_port: int = 0
    # Interface the leader's op-log listener binds; empty = the
    # coordinator's host (pod-internal by construction — never a
    # wildcard bind). Set explicitly if the op-log should ride a
    # different interface than the coordinator.
    dist_oplog_bind: str = ""
    # Shared secret for the follower handshake; empty = a token derived
    # from the coordinator address (guards against stray connections
    # squatting follower slots — set a real secret in production, the
    # op-log stream carries document signatures and embeddings).
    dist_oplog_token: str = ""

    def __post_init__(self) -> None:
        env = dict(_load_env_file(os.environ.get("CADENCE_ENV_FILE", ".env")))
        env.update(os.environ)
        for field in dataclasses.fields(self):
            raw = env.get(field.name.upper())
            if raw is None:
                continue
            if field.type in ("bool", bool):
                value: object = _parse_bool(raw)
            elif field.type in ("int", int):
                value = int(raw)
            elif field.type in ("float", float):
                value = float(raw)
            else:
                value = raw
            setattr(self, field.name, value)


settings = Settings()


def reload_settings() -> Settings:
    """Re-read the environment into the module-level singleton.

    The reference's tests re-import app modules so module-level settings
    rebind (reference: tests/conftest.py:91-126); we instead mutate the
    singleton in place so every importer observes fresh values.
    """
    fresh = Settings()
    for field in dataclasses.fields(Settings):
        setattr(settings, field.name, getattr(fresh, field.name))
    return settings
