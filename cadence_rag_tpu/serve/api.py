"""Transport-agnostic API router: the reference's endpoint surface.

Endpoint-for-endpoint parity with the reference API (reference:
app/main.py:63-186): /health, /diagnostics, /ingest/{transcript,call,
analysis}, /ingest/jobs[/{id}], /calls[/{id}], /chunks/{id}, /expand,
/retrieve — same request models, same response shapes, same status codes
(400 unsupported format / invalid status filter, 404 missing, 409
ambiguous, 422 validation). Adds GET /index/stats (device-index
observability; no reference counterpart).

Each request runs under an X-Request-ID logging context
(reference: app/main.py:46-60).
"""

from __future__ import annotations

import dataclasses
import re
import uuid
from datetime import datetime
from typing import Any, Callable, Dict, List, Optional, Tuple

from pydantic import ValidationError

from ..config import settings
from ..core.index import get_index
from ..engine.browse import expand_evidence, get_call, get_chunk, list_calls
from ..engine.retrieve import retrieve_evidence
from ..ingest.fs_queue import get_ingest_job, list_ingest_jobs
from ..ingest.ingest import ingest_analysis, ingest_call, ingest_transcript
from ..logging_utils import (
    configure_logging,
    get_logger,
    reset_request_id,
    set_request_id,
)
from ..schemas import (
    AnalysisIngestRequest,
    CallIngestRequest,
    ChunkingOptions,
    ExpandRequest,
    RetrieveRequest,
    TranscriptIngestRequest,
)
from ..store.db import get_store
from ..utils.errors import ApiError

logger = get_logger(__name__)


@dataclasses.dataclass
class Request:
    method: str
    path: str
    path_params: Dict[str, str]
    query: Dict[str, List[str]]
    body: Any
    headers: Dict[str, str]

    def q1(self, name: str, default: Optional[str] = None) -> Optional[str]:
        values = self.query.get(name)
        return values[0] if values else default


Handler = Callable[[Request], Tuple[int, Dict[str, Any]]]


class Router:
    def __init__(self) -> None:
        self.routes: List[Tuple[str, re.Pattern, Handler, str]] = []

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        regex = re.compile(
            "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$"
        )
        self.routes.append(
            (method.upper(), regex, handler, f"{method.upper()} {pattern}")
        )

    def dispatch(
        self,
        method: str,
        path: str,
        *,
        query: Optional[Dict[str, List[str]]] = None,
        body: Any = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        import time as _time

        from .metrics import registry

        headers = {k.lower(): v for k, v in (headers or {}).items()}
        request_id = headers.get("x-request-id") or uuid.uuid4().hex
        token = set_request_id(request_id)
        try:
            for route_method, regex, handler, family in self.routes:
                if route_method != method.upper():
                    continue
                match = regex.match(path)
                if not match:
                    continue
                request = Request(
                    method=method.upper(),
                    path=path,
                    path_params=match.groupdict(),
                    query=query or {},
                    body=body,
                    headers=headers,
                )
                t0 = _time.perf_counter()
                try:
                    status, payload = handler(request)
                except ApiError as exc:
                    status, payload = exc.status, {"detail": exc.detail}
                except ValidationError as exc:
                    status, payload = 422, {"detail": exc.errors(include_url=False)}
                except Exception:
                    logger.exception(
                        "request.failed method=%s path=%s", method, path
                    )
                    status, payload = 500, {"detail": "internal error"}
                registry.observe(
                    family, _time.perf_counter() - t0, error=status >= 500
                )
                return status, payload, {"x-request-id": request_id}
            return 404, {"detail": "not found"}, {"x-request-id": request_id}
        finally:
            reset_request_id(token)


# ------------------------------------------------------------- handlers ----

def _parse_dt(raw: Optional[str]) -> Optional[datetime]:
    if not raw:
        return None
    try:
        return datetime.fromisoformat(raw)
    except ValueError as exc:
        raise ApiError(422, f"invalid datetime: {raw}") from exc


def health(_req: Request):
    try:
        info = get_store().fetch_info()
    except Exception as exc:
        raise ApiError(503, str(exc)) from exc
    return 200, {"status": "ok", "db": info}


def diagnostics(_req: Request):
    try:
        store = get_store()
        info = store.fetch_info()
        ok, message = store.validate_versions()
    except Exception as exc:
        return 200, {"status": "error", "detail": str(exc)}
    index = get_index()
    return 200, {
        "status": "ok" if ok else "mismatch",
        "detail": message,
        "db": info,
        "expected": {"schema_version": info.get("schema_version")},
        "index": {
            "chunks": index.chunks.count,
            "artifact_chunks": index.artifacts.count,
            "chunk_capacity": index.chunks.capacity,
            "embedding_dtype": str(index.chunks.emb_dtype),
            "mesh": (
                {axis: int(size) for axis, size in index.mesh.shape.items()}
                if index.mesh is not None else None
            ),
            "ivf": (
                {
                    "built_count": index.chunks.ivf.built_count,
                    "n_clusters": index.chunks.ivf.n_clusters,
                    "nprobe": index.chunks.ivf.nprobe,
                    "overflow_count": index.chunks.ivf.overflow_count,
                    "usable": index.chunks.ivf_usable(),
                }
                if index.chunks.ivf is not None else None
            ),
        },
    }


def ingest_transcript_endpoint(req: Request):
    payload = TranscriptIngestRequest.model_validate(req.body)
    if payload.transcript.format != "json_turns":
        raise ApiError(400, "unsupported transcript format")
    options = payload.options or ChunkingOptions()
    call_id, utterances_ingested, chunks_created = ingest_transcript(
        payload.call_ref, payload.transcript.content, options
    )
    return 200, {
        "call_id": call_id,
        "utterances_ingested": utterances_ingested,
        "chunks_created": chunks_created,
    }


def ingest_transcript_batch_endpoint(req: Request):
    """Batch ingest: a list of transcript requests in one call. The device
    index already inserts in slabs; this gives the HTTP surface the same
    batching (an addition — the reference ingests one transcript per
    request, app/main.py:92)."""
    body = req.body
    if not isinstance(body, list) or not body:
        raise ApiError(422, "expected a non-empty JSON array of "
                            "transcript ingest requests")
    payloads = [TranscriptIngestRequest.model_validate(item) for item in body]
    for payload in payloads:
        if payload.transcript.format != "json_turns":
            raise ApiError(400, "unsupported transcript format")
    # NON-atomic, per-item results: items succeed or fail independently
    # (transcript-hash idempotency makes retrying succeeded items a
    # no-op), and each failure is reported in place rather than aborting
    # the rest of the batch with no record of what landed.
    results = []
    failed = 0
    for payload in payloads:
        options = payload.options or ChunkingOptions()
        try:
            call_id, utterances_ingested, chunks_created = ingest_transcript(
                payload.call_ref, payload.transcript.content, options
            )
            results.append({
                "call_id": call_id,
                "utterances_ingested": utterances_ingested,
                "chunks_created": chunks_created,
            })
        except ApiError as exc:
            failed += 1
            results.append({"error": exc.detail, "status": exc.status})
        except Exception:
            # the endpoint's contract is per-item results: an unexpected
            # failure on item N must not abort items N+1.. with a bare
            # 500 and no record of what landed
            logger.exception("ingest.batch_item_failed")
            failed += 1
            results.append({"error": "internal error", "status": 500})
    return 200, {"items": results, "failed": failed}


def ingest_call_endpoint(req: Request):
    payload = CallIngestRequest.model_validate(req.body)
    call_id, created = ingest_call(payload.call_ref)
    return 200, {"call_id": call_id, "created": created}


def ingest_analysis_endpoint(req: Request):
    payload = AnalysisIngestRequest.model_validate(req.body)
    if not payload.artifacts:
        raise ApiError(400, "no artifacts provided")
    call_id, created = ingest_analysis(payload.call_ref, payload.artifacts)
    return 200, {"call_id": call_id, "artifacts_created": created}


def _parse_limit(req: Request, default: str = "50") -> int:
    try:
        limit = int(req.q1("limit", default))
    except ValueError as exc:
        # client input error, not a 500 (int('abc') raised out of the
        # handler and hit the generic 500 path + error metrics)
        raise ApiError(422, "limit must be an integer") from exc
    if not 1 <= limit <= 200:
        raise ApiError(422, "limit must be in [1, 200]")
    return limit


def list_jobs_endpoint(req: Request):
    status = req.q1("status")
    allowed = {"queued", "running", "succeeded", "failed", "invalid"}
    if status is not None and status not in allowed:
        raise ApiError(400, "invalid ingest job status filter")
    return 200, list_ingest_jobs(status=status, limit=_parse_limit(req))


def get_job_endpoint(req: Request):
    try:
        job_id = str(uuid.UUID(req.path_params["ingest_job_id"]))
    except ValueError as exc:
        raise ApiError(422, "invalid job id") from exc
    return 200, get_ingest_job(job_id)


def list_calls_endpoint(req: Request):
    return 200, list_calls(
        limit=_parse_limit(req),
        cursor=req.q1("cursor"),
        date_from=_parse_dt(req.q1("date_from")),
        date_to=_parse_dt(req.q1("date_to")),
        tags=req.query.get("tags"),
        external_id=req.q1("external_id"),
        external_source=req.q1("external_source"),
    )


def get_call_endpoint(req: Request):
    try:
        call_id = str(uuid.UUID(req.path_params["call_id"]))
    except ValueError as exc:
        raise ApiError(422, "invalid call id") from exc
    return 200, get_call(call_id)


def delete_call_endpoint(req: Request):
    try:
        call_id = str(uuid.UUID(req.path_params["call_id"]))
    except ValueError as exc:
        raise ApiError(422, "invalid call id") from exc
    from ..ingest.ingest import delete_call

    return 200, delete_call(call_id)


def get_chunk_endpoint(req: Request):
    try:
        chunk_id = int(req.path_params["chunk_id"])
    except ValueError as exc:
        raise ApiError(422, "invalid chunk id") from exc
    return 200, get_chunk(chunk_id)


def expand_endpoint(req: Request):
    payload = ExpandRequest.model_validate(req.body)
    return 200, expand_evidence(
        payload.evidence_id,
        window_ms=payload.window_ms,
        max_chars=payload.max_chars,
    )


def retrieve_endpoint(req: Request):
    payload = RetrieveRequest.model_validate(req.body)
    return 200, retrieve_evidence(payload)


def retrieve_batch_endpoint(req: Request):
    """Beyond-reference: explicit client-side batching — a list of
    RetrieveRequests served in one device dispatch per planner group
    (the engine API bulk evals use; no reference counterpart)."""
    from ..engine.retrieve import retrieve_evidence_batch

    body = req.body
    if not isinstance(body, list) or not body:
        raise ApiError(400, "expected a non-empty JSON array of requests")
    if len(body) > 256:
        raise ApiError(422, "batch too large (max 256)")
    payloads = [RetrieveRequest.model_validate(item) for item in body]
    return 200, {"results": retrieve_evidence_batch(payloads)}


def index_stats_endpoint(_req: Request):
    from ..core.vocab import drift_stats
    from ..ingest import featurize

    index = get_index()
    vocab, vocab_version = featurize.active_vocab()

    def corpus_stats(corpus):
        out = {
            "count": corpus.count,
            "capacity": corpus.capacity,
            "embedded": int(corpus.h_has_emb[: corpus.count].sum()),
            "avgdl": corpus.avgdl,
            "lexical_dim": corpus.lex_dim,
            "dim": corpus.dim,
            "emb_dtype": str(corpus.emb_dtype),
            "tombstones": corpus.tombstones,
            "ivf_built": corpus.ivf is not None,
        }
        if corpus.cold is not None:
            out["cold_tier"] = {
                "count": corpus.cold.count,
                "live": corpus.cold.live_count,
                "embedded": corpus.cold.emb_rows,
                "tombstones": corpus.cold.tombstones,
                "max_device_rows": corpus.max_device_rows,
            }
        if vocab is not None:
            out["lex_vocab"] = {
                "version": vocab_version,
                "head": int(vocab.size),
                "auto_rebuild": bool(settings.lex_vocab_auto_rebuild),
                **drift_stats(corpus, vocab),
            }
        return out
    from ..ingest.sync import get_syncer

    syncer = get_syncer()
    return 200, {
        "chunks": corpus_stats(index.chunks),
        "artifact_chunks": corpus_stats(index.artifacts),
        "call_capacity": index.call_capacity,
        # growth-prewarm observability: operators watch for warm
        # executables before a capacity doubling (core/prewarm.py)
        "prewarm_compiled": len(index.prewarmer._compiled),
        # store->index sync observability: lag = mutations not yet
        # applied to this process's device index (ingest/sync.py)
        "sync": {
            "consumer_id": syncer.consumer_id,
            "applied_seq": syncer.last_seq,
            "store_seq": syncer.current_watermark(),
        },
    }


def metrics_endpoint(_req: Request):
    from .metrics import registry

    return 200, registry.snapshot()


def startup() -> None:
    """Fail-fast startup gate + index recovery (reference lifespan:
    app/main.py:33-39)."""
    configure_logging(settings.log_level)
    if settings.dist_coordinator.strip():
        # multi-host: every process joins the coordinator BEFORE first
        # backend use so jax.devices() spans all hosts and MESH_SHAPE can
        # exceed one process's chips (SURVEY.md §2.4 DCN scope)
        import jax

        # gang members that share a host are each started with
        # CUDA_VISIBLE_DEVICES naming their own cards, and on GPUs with
        # --xla_gpu_shard_autotuning=false (docs/OPERATIONS.md)
        jax.distributed.initialize(
            coordinator_address=settings.dist_coordinator.strip(),
            num_processes=int(settings.dist_num_processes) or None,
            process_id=int(settings.dist_process_id),
        )
        logger.info(
            "api.distributed_initialized coordinator=%s process=%s/%s",
            settings.dist_coordinator, settings.dist_process_id,
            settings.dist_num_processes,
        )
        if jax.process_count() > 1:
            # Lockstep multi-host serving: the leader (process 0) runs the
            # HTTP server + store + engine and mirrors every device-index
            # op to followers over the op-log; followers replay the op
            # stream so the gang enqueues identical XLA programs
            # (parallel/oplog.py). Must install BEFORE any index mutation
            # — including the rebuild-from-store below.
            if not settings.mesh_shape.strip():
                raise RuntimeError(
                    "multi-host serving requires MESH_SHAPE spanning the "
                    "gang's devices (e.g. data:8)"
                )
            from ..parallel import oplog

            coord = settings.dist_coordinator.strip()
            coord_host, _, coord_port = coord.partition(":")
            if int(settings.dist_oplog_port):
                oplog_port = int(settings.dist_oplog_port)
            else:
                try:
                    oplog_port = int(coord_port) + 1
                except ValueError:
                    raise RuntimeError(
                        "cannot derive the op-log port: DIST_COORDINATOR="
                        f"{coord!r} carries no port — set DIST_OPLOG_PORT "
                        "or use DIST_COORDINATOR=host:port"
                    ) from None
            if jax.process_index() == 0:
                oplog.install_leader(
                    get_index(), oplog_port, jax.process_count() - 1,
                    bind_host=settings.dist_oplog_bind.strip() or coord_host,
                )
            else:
                logger.info("api.follower process=%s", jax.process_index())
                oplog.follower_main(get_index(), coord_host, oplog_port)
                raise SystemExit(0)  # leader shut down; no HTTP on followers
    import jax

    device = jax.devices()[0]
    logger.info(
        "api.startup backend=%s device_kind=%s devices=%s",
        jax.default_backend(), device.device_kind, jax.device_count(),
    )
    if int(settings.profiler_port) > 0:
        import jax.profiler

        jax.profiler.start_server(int(settings.profiler_port))
        logger.info("api.profiler_server port=%s", settings.profiler_port)
    store = get_store()
    if not settings.skip_version_check:
        ok, message = store.validate_versions()
        if not ok:
            raise RuntimeError(message)
    from ..ingest.ingest import rebuild_index_from_store
    from ..ingest.sync import get_syncer

    index = get_index()
    syncer = get_syncer()
    # watermark BEFORE the rebuild read: any row committed in between has
    # seq > watermark and the first poll picks it up (rows both rebuilt
    # and logged dedupe on doc_id)
    syncer.init_watermark()
    if index.chunks.count == 0 and index.artifacts.count == 0:
        # point featurizers at the store's active lexical vocab BEFORE any
        # query/ingest featurization (stored lex_sig blobs were written
        # under it, so the rebuilt device rows match by construction)
        from ..core.vocab import activate_from_store

        activate_from_store(store)
        counts = rebuild_index_from_store()
        logger.info("api.startup index_rebuilt chunks=%s artifacts=%s", *counts)
    else:
        # pre-populated index (checkpoint restore): diff against the
        # store so writes that happened while this process was down —
        # or rows deleted since the snapshot — are applied
        from ..core.vocab import load_vocab, vocab_digest
        from ..ingest import featurize

        active_vocab, active_version = featurize.active_vocab()
        stored = load_vocab(store)
        store_version = stored[1] if stored is not None else 0
        store_sha = vocab_digest(stored[0]) if stored is not None else ""
        # digests, not just version counters: two stores can each mint
        # their own v1 with different head hashes (e.g. a store restored
        # from a pre-vocab backup and rebuilt)
        if (store_version != active_version
                or store_sha != vocab_digest(active_vocab)):
            # restored signature rows and the store's featurization layout
            # diverged (a vocab was built after — or the checkpoint
            # predates — this store's lex_vocab): serving would score
            # mismatched layouts silently
            raise RuntimeError(
                f"restored index carries lex vocab v{active_version} but "
                f"the store's active vocab is v{store_version} (content "
                "compared by digest); re-snapshot after "
                "scripts/build_lex_vocab, or delete the stale checkpoint "
                "and let startup rebuild from the store"
            )
        counts = syncer.reconcile()
        logger.info("api.startup index_reconciled %s", counts)
    if float(settings.store_sync_interval_s) > 0:
        # (multi-host leaders included: syncer-applied ops go through the
        # same corpus methods, so they mirror to followers via the
        # op-log like any other index mutation)
        syncer.start(float(settings.store_sync_interval_s))
    if (
        settings.dense_ivf_enabled
        and index.chunks.count >= int(settings.ivf_min_rows)
        and not index.chunks.ivf_usable()
    ):
        state = index.chunks.build_ivf()
        logger.info(
            "api.startup ivf_built rows=%s clusters=%s nprobe=%s",
            state.built_count, state.n_clusters, state.nprobe,
        )
    logger.info("api.startup complete")


def build_router() -> Router:
    router = Router()
    router.add("GET", "/health", health)
    router.add("GET", "/diagnostics", diagnostics)
    router.add("POST", "/ingest/transcript", ingest_transcript_endpoint)
    router.add("POST", "/ingest/transcript/batch",
               ingest_transcript_batch_endpoint)
    router.add("POST", "/ingest/call", ingest_call_endpoint)
    router.add("POST", "/ingest/analysis", ingest_analysis_endpoint)
    router.add("GET", "/ingest/jobs", list_jobs_endpoint)
    router.add("GET", "/ingest/jobs/{ingest_job_id}", get_job_endpoint)
    router.add("GET", "/calls", list_calls_endpoint)
    router.add("GET", "/calls/{call_id}", get_call_endpoint)
    router.add("DELETE", "/calls/{call_id}", delete_call_endpoint)
    router.add("GET", "/chunks/{chunk_id}", get_chunk_endpoint)
    router.add("POST", "/expand", expand_endpoint)
    router.add("POST", "/retrieve", retrieve_endpoint)
    router.add("POST", "/retrieve/batch", retrieve_batch_endpoint)
    router.add("GET", "/index/stats", index_stats_endpoint)
    router.add("GET", "/metrics", metrics_endpoint)
    return router
