"""Filesystem ingest queue: drop-folder scanner, durable queue, worker.

Behavioral parity with the reference pipeline (reference: app/ingest_fs.py):

- drop-folder contract ``inbox/ -> processing/ -> done|failed/`` with a
  ``_READY`` sentinel for bundle directories and a min-age gate for bare
  single files that get auto-wrapped into bundles;
- bundle validation: manifest parse, bundle_id pattern, per-file sha256,
  path-escape guard; auto-manifest generation with format/kind inference;
- job rows with a ``queued -> running -> succeeded|failed|invalid`` state
  machine and per-file audit records;
- retry with exponential backoff intervals ``base * 2^i``;
- worker: ingest -> optional auto-embed (fail-open/closed) -> move bundle.

Difference from the reference: Redis/RQ is replaced by a durable SQLite
queue table with claim semantics (at-least-once, visibility via claimed_at)
— the job table remains the source of truth, exactly the property the
reference relies on (SURVEY.md §2.2).
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from pydantic import BaseModel, Field, ValidationError

from ..config import settings
from ..logging_utils import get_logger
from ..schemas import AnalysisArtifactIn, CallRef, ChunkingOptions
from ..store.db import get_store
from ..utils.timeutil import now_utc, to_iso
from .adapters import (
    AdapterError,
    infer_analysis_format,
    infer_transcript_format,
    load_analysis_content,
    load_transcript_payload,
)

logger = get_logger(__name__)

BUNDLE_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._\-]{0,127}$")
MANIFEST_NAME = "manifest.json"
READY_SENTINEL = "_READY"
TRANSCRIPT_SUFFIXES = {".json", ".md", ".markdown"}
ANALYSIS_KIND_HINTS = {
    "action": "action_items",
    "decision": "decisions",
    "summary": "summary",
    "note": "notes",
    "risk": "risks",
}


class TranscriptFileRef(BaseModel):
    path: str
    format: str = "auto"
    sha256: Optional[str] = None


class AnalysisFileRef(BaseModel):
    path: str
    format: str = "auto"
    kind: str = Field(default="notes", pattern=r"^[a-z0-9_]+$")
    sha256: Optional[str] = None


class BundleManifest(BaseModel):
    bundle_id: str
    call: Dict[str, Any] = Field(default_factory=dict)
    transcript: Optional[TranscriptFileRef] = None
    analyses: List[AnalysisFileRef] = Field(default_factory=list)


class BundleValidationError(ValueError):
    pass


# ------------------------------------------------------------ validation ----

def safe_join(base: Path, relative: str) -> Path:
    """Path-escape guard (reference: ingest_fs.py:119-124)."""
    candidate = (base / relative).resolve()
    if not str(candidate).startswith(str(base.resolve()) + "/") and candidate != base.resolve():
        raise BundleValidationError(f"path escapes bundle: {relative}")
    return candidate

def sha256_file(path: Path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest()


def validate_bundle_directory(bundle_dir: Path) -> BundleManifest:
    manifest_path = bundle_dir / MANIFEST_NAME
    if not manifest_path.is_file():
        raise BundleValidationError("manifest.json missing")
    try:
        manifest = BundleManifest.model_validate_json(
            manifest_path.read_text(encoding="utf-8")
        )
    except (ValidationError, ValueError) as exc:
        raise BundleValidationError(f"manifest invalid: {exc}") from exc
    if not BUNDLE_ID_RE.match(manifest.bundle_id):
        raise BundleValidationError(f"invalid bundle_id: {manifest.bundle_id!r}")
    refs: List[Tuple[str, Optional[str]]] = []
    if manifest.transcript:
        refs.append((manifest.transcript.path, manifest.transcript.sha256))
    refs.extend((a.path, a.sha256) for a in manifest.analyses)
    if not refs:
        raise BundleValidationError("manifest references no files")
    for rel, expected in refs:
        target = safe_join(bundle_dir, rel)
        if not target.is_file():
            raise BundleValidationError(f"referenced file missing: {rel}")
        if expected:
            actual = sha256_file(target)
            if actual != expected:
                raise BundleValidationError(
                    f"sha256 mismatch for {rel}: {actual} != {expected}"
                )
    return manifest


# --------------------------------------------------------- auto-manifest ----

def _sanitize_bundle_id(name: str) -> str:
    cleaned = re.sub(r"[^A-Za-z0-9._\-]", "-", name).strip("-.")
    return cleaned[:128] or f"bundle-{uuid.uuid4().hex[:8]}"


def infer_analysis_kind(path: Path) -> str:
    stem = path.stem.lower()
    for hint, kind in ANALYSIS_KIND_HINTS.items():
        if hint in stem:
            return kind
    return "notes"


def _transcript_likelihood(path: Path) -> int:
    """Score how transcript-like a file is; < 0 means 'never a transcript'
    (wrong suffix, or the stem names an analysis kind like summary/notes)."""
    if path.suffix.lower() not in TRANSCRIPT_SUFFIXES:
        return -1
    stem = path.stem.lower()
    if "analysis" in stem or any(hint in stem for hint in ANALYSIS_KIND_HINTS):
        return -1
    score = 0
    if "transcript" in stem or "call" in stem:
        score += 10
    if path.suffix.lower() == ".json":
        score += 5
    return score


def build_auto_manifest(bundle_dir: Path) -> BundleManifest:
    """Infer a manifest for a bare bundle (reference: ingest_fs.py:355-400):
    the most transcript-like file (scored by stem keywords and suffix, with
    analysis-kind stems like summary/notes excluded) becomes the
    transcript; remaining supported files become analyses with kind
    inferred from filename."""
    files = [
        path for path in sorted(bundle_dir.iterdir())
        if path.is_file() and path.name not in (MANIFEST_NAME, READY_SENTINEL)
    ]
    transcript_path: Optional[Path] = None
    best_score = -1
    for path in files:
        score = _transcript_likelihood(path)
        if score > best_score:
            best_score = score
            transcript_path = path
    if best_score < 0:
        transcript_path = None

    transcript: Optional[TranscriptFileRef] = None
    analyses: List[AnalysisFileRef] = []
    for path in files:
        if path == transcript_path:
            transcript = TranscriptFileRef(
                path=path.name,
                format=infer_transcript_format(path),
                sha256=sha256_file(path),
            )
        else:
            analyses.append(
                AnalysisFileRef(
                    path=path.name,
                    format=infer_analysis_format(path),
                    kind=infer_analysis_kind(path),
                    sha256=sha256_file(path),
                )
            )
    return BundleManifest(
        bundle_id=_sanitize_bundle_id(bundle_dir.name),
        transcript=transcript,
        analyses=analyses,
    )


def ensure_manifest(bundle_dir: Path) -> None:
    manifest_path = bundle_dir / MANIFEST_NAME
    if manifest_path.is_file():
        return
    if not settings.ingest_auto_manifest:
        raise BundleValidationError("manifest.json missing and auto-manifest disabled")
    manifest = build_auto_manifest(bundle_dir)
    manifest_path.write_text(
        json.dumps(manifest.model_dump(), indent=2), encoding="utf-8"
    )


# ------------------------------------------------------------- job store ----

def retry_intervals(max_attempts: int, base_seconds: int) -> List[int]:
    """Backoff schedule base*2^i for the retries after the first attempt
    (reference: ingest_fs.py:668-675)."""
    return [base_seconds * (2 ** i) for i in range(max(0, max_attempts - 1))]


def create_or_get_job(
    bundle_id: str, bundle_path: str, manifest: Optional[BundleManifest]
) -> Tuple[str, bool]:
    store = get_store()
    job_id = str(uuid.uuid4())
    with store.tx() as conn:
        cur = conn.execute(
            "INSERT OR IGNORE INTO ingest_jobs "
            "(ingest_job_id, bundle_id, status, max_attempts, bundle_path, manifest) "
            "VALUES (?,?,?,?,?,?)",
            (
                job_id, bundle_id, "queued",
                int(settings.ingest_job_max_attempts), bundle_path,
                manifest.model_dump_json() if manifest else None,
            ),
        )
        if cur.rowcount == 0:
            row = conn.execute(
                "SELECT ingest_job_id FROM ingest_jobs WHERE bundle_id = ?",
                (bundle_id,),
            ).fetchone()
            return row["ingest_job_id"], False
    return job_id, True


def upsert_job_files(job_id: str, bundle_dir: Path, manifest: BundleManifest) -> None:
    entries = []
    if manifest.transcript:
        entries.append((manifest.transcript.path, "transcript"))
    entries.extend((a.path, "analysis") for a in manifest.analyses)
    store = get_store()
    with store.tx() as conn:
        for rel, role in entries:
            path = safe_join(bundle_dir, rel)
            conn.execute(
                "INSERT OR REPLACE INTO ingest_job_files "
                "(ingest_job_id, path, sha256, size_bytes, role) VALUES (?,?,?,?,?)",
                (job_id, rel, sha256_file(path), path.stat().st_size, role),
            )


def update_job_status(
    job_id: str,
    status: str,
    *,
    error: Optional[str] = None,
    call_id: Optional[str] = None,
    bundle_path: Optional[str] = None,
    attempts_inc: int = 0,
) -> None:
    store = get_store()
    sets = ["status = ?"]
    params: List[Any] = [status]
    if attempts_inc:
        sets.append("attempts = attempts + ?")
        params.append(attempts_inc)
    if error is not None:
        sets.append("error = ?")
        params.append(error[:2000])
    if call_id is not None:
        sets.append("call_id = ?")
        params.append(call_id)
    if bundle_path is not None:
        sets.append("bundle_path = ?")
        params.append(bundle_path)
    if status == "running":
        sets.append("started_at = ?")
        params.append(to_iso(now_utc()))
    if status in ("succeeded", "failed", "invalid"):
        sets.append("finished_at = ?")
        params.append(to_iso(now_utc()))
    params.append(job_id)
    with store.tx() as conn:
        conn.execute(
            f"UPDATE ingest_jobs SET {', '.join(sets)} WHERE ingest_job_id = ?",
            params,
        )


def _job_payload(row, files) -> Dict[str, Any]:
    return {
        "ingest_job_id": row["ingest_job_id"],
        "bundle_id": row["bundle_id"],
        "status": row["status"],
        "attempts": row["attempts"],
        "max_attempts": row["max_attempts"],
        "error": row["error"],
        "call_id": row["call_id"],
        "bundle_path": row["bundle_path"],
        "created_at": row["created_at"],
        "started_at": row["started_at"],
        "finished_at": row["finished_at"],
        "files": [
            {
                "path": f["path"],
                "sha256": f["sha256"],
                "size_bytes": f["size_bytes"],
                "role": f["role"],
            }
            for f in files
        ],
    }


def get_ingest_job(job_id: str) -> Dict[str, Any]:
    store = get_store()
    with store.read() as conn:
        row = conn.execute(
            "SELECT * FROM ingest_jobs WHERE ingest_job_id = ?", (str(job_id),)
        ).fetchone()
        if not row:
            from ..utils.errors import ApiError

            raise ApiError(404, f"ingest job not found: {job_id}")
        files = conn.execute(
            "SELECT * FROM ingest_job_files WHERE ingest_job_id = ? ORDER BY path",
            (str(job_id),),
        ).fetchall()
    return _job_payload(row, files)


def list_ingest_jobs(
    status: Optional[str] = None, limit: int = 50
) -> Dict[str, Any]:
    store = get_store()
    sql = "SELECT * FROM ingest_jobs "
    params: List[Any] = []
    if status:
        sql += "WHERE status = ? "
        params.append(status)
    sql += "ORDER BY created_at DESC LIMIT ?"
    params.append(max(1, min(limit, 200)))
    with store.read() as conn:
        rows = conn.execute(sql, params).fetchall()
        items = []
        for row in rows:
            files = conn.execute(
                "SELECT * FROM ingest_job_files WHERE ingest_job_id = ? "
                "ORDER BY path",
                (row["ingest_job_id"],),
            ).fetchall()
            items.append(_job_payload(row, files))
    return {"items": items}


# ----------------------------------------------------------------- queue ----

def enqueue_job(job_id: str, delay_s: float = 0.0) -> None:
    store = get_store()
    with store.tx() as conn:
        conn.execute(
            "INSERT INTO queue (queue_name, payload, available_at) VALUES (?,?,?)",
            (
                settings.ingest_queue_name,
                json.dumps({"job_id": job_id}),
                time.time() + delay_s,
            ),
        )


def claim_next(worker_id: str, visibility_s: float = 600.0) -> Optional[Dict[str, Any]]:
    """At-least-once claim: oldest available message; stale claims (crashed
    workers) become claimable again after the visibility window."""
    store = get_store()
    now = time.time()
    with store.tx() as conn:
        row = conn.execute(
            "SELECT message_id, payload FROM queue WHERE queue_name = ? "
            "AND done = 0 AND available_at <= ? "
            "AND (claimed_at IS NULL OR claimed_at <= ?) "
            "ORDER BY message_id ASC LIMIT 1",
            (settings.ingest_queue_name, now, now - visibility_s),
        ).fetchone()
        if not row:
            return None
        conn.execute(
            "UPDATE queue SET claimed_at = ?, claimed_by = ? WHERE message_id = ?",
            (now, worker_id, row["message_id"]),
        )
    return {"message_id": row["message_id"], **json.loads(row["payload"])}


def ack(message_id: int) -> None:
    store = get_store()
    with store.tx() as conn:
        conn.execute("UPDATE queue SET done = 1 WHERE message_id = ?", (message_id,))


# --------------------------------------------------------------- scanner ----

def _move(src: Path, dest_dir: Path) -> Path:
    dest_dir.mkdir(parents=True, exist_ok=True)
    target = dest_dir / src.name
    if target.exists():
        target = dest_dir / f"{src.name}-{uuid.uuid4().hex[:8]}"
    shutil.move(str(src), str(target))
    return target


def _single_file_ready(path: Path) -> bool:
    if not path.is_file():
        return False
    age = time.time() - path.stat().st_mtime
    return age >= int(settings.ingest_single_file_min_age_s)


def _wrap_single_file(path: Path, inbox: Path) -> Path:
    bundle_dir = inbox / f"{path.stem}-{uuid.uuid4().hex[:8]}"
    bundle_dir.mkdir()
    shutil.move(str(path), str(bundle_dir / path.name))
    (bundle_dir / READY_SENTINEL).touch()
    return bundle_dir


def _record_invalid(bundle_dir: Path, failed_dir: Path, error: str) -> None:
    bundle_id = _sanitize_bundle_id(bundle_dir.name)
    job_id, created = create_or_get_job(bundle_id, str(bundle_dir), None)
    if not created:
        # bundle_id already has a job (e.g. an operator re-dropped a
        # directory with a used name): flipping THAT row to 'invalid'
        # would clobber a succeeded/queued job's status and repoint its
        # bundle_path at the re-dropped copy — record this drop under
        # its own id instead
        job_id, _ = create_or_get_job(
            f"{bundle_id}-dup-{uuid.uuid4().hex[:8]}",
            str(bundle_dir), None,
        )
    update_job_status(job_id, "invalid", error=error)
    moved = _move(bundle_dir, failed_dir)
    update_job_status(job_id, "invalid", bundle_path=str(moved))
    logger.warning("ingest_scan.invalid bundle=%s error=%s", bundle_id, error)


def scan_inbox_once(root: Optional[Path] = None) -> Dict[str, int]:
    """One scanner pass (reference: ingest_fs.py:708-802). Returns counts."""
    root = Path(root or settings.ingest_root_dir)
    inbox = root / "inbox"
    processing = root / "processing"
    failed = root / "failed"
    for d in (inbox, processing, failed, root / "done"):
        d.mkdir(parents=True, exist_ok=True)

    stats = {"enqueued": 0, "invalid": 0, "skipped": 0}
    for entry in sorted(inbox.iterdir()):
        bundle_dir: Optional[Path] = None
        if entry.is_dir():
            if not (entry / READY_SENTINEL).exists():
                stats["skipped"] += 1
                continue
            bundle_dir = entry
        elif _single_file_ready(entry):
            bundle_dir = _wrap_single_file(entry, inbox)
        else:
            stats["skipped"] += 1
            continue

        try:
            ensure_manifest(bundle_dir)
            manifest = validate_bundle_directory(bundle_dir)
        except (BundleValidationError, OSError) as exc:
            _record_invalid(bundle_dir, failed, str(exc))
            stats["invalid"] += 1
            continue

        job_id, created = create_or_get_job(
            manifest.bundle_id, str(bundle_dir), manifest
        )
        if not created:
            _record_invalid(
                bundle_dir, failed, f"duplicate bundle_id: {manifest.bundle_id}"
            )
            stats["invalid"] += 1
            continue
        moved = _move(bundle_dir, processing)
        update_job_status(job_id, "queued", bundle_path=str(moved))
        upsert_job_files(job_id, moved, manifest)
        enqueue_job(job_id)
        stats["enqueued"] += 1
        logger.info(
            "ingest_scan.enqueued bundle=%s job=%s", manifest.bundle_id, job_id
        )
    return stats


# ---------------------------------------------------------------- worker ----

def _auto_embed(call_id: str) -> None:
    """Post-ingest auto-embed with fail-open/closed policy (reference:
    ingest_fs.py:809-837)."""
    if not settings.ingest_auto_embed_on_success:
        return
    from ..embed.pipeline import run_embedding_backfill

    try:
        run_embedding_backfill(
            batch_size=int(settings.embeddings_batch_size),
            call_id=call_id,
            source="ingest_auto_embed",
        )
    except Exception as exc:
        if settings.ingest_auto_embed_fail_on_error:
            raise
        logger.warning("ingest_job.auto_embed_failed call=%s err=%s", call_id, exc)


def process_ingest_job(job_id: str) -> str:
    """Worker job body (reference: ingest_fs.py:840-963). Returns final
    status. Raising after re-queue marks a retryable failure."""
    from .ingest import ingest_analysis, ingest_transcript, ingest_call

    job = get_ingest_job(job_id)
    root = Path(settings.ingest_root_dir)
    bundle_dir = Path(job["bundle_path"])
    update_job_status(job_id, "running", attempts_inc=1)
    attempts = job["attempts"] + 1

    try:
        manifest = validate_bundle_directory(bundle_dir)
        call_ref = CallRef(**(manifest.call or {}))
        if not any(
            [call_ref.call_id, call_ref.external_id,
             call_ref.source_uri and call_ref.source_hash]
        ):
            call_ref.external_id = manifest.bundle_id
            call_ref.external_source = "ingest_fs"

        call_id: Optional[str] = None
        if manifest.transcript:
            utterances = load_transcript_payload(
                safe_join(bundle_dir, manifest.transcript.path),
                manifest.transcript.format,
            )
            call_id, _n_utt, _n_chunks = ingest_transcript(
                call_ref, utterances, ChunkingOptions()
            )
        else:
            call_id, _created = ingest_call(call_ref)

        artifacts = []
        for ref in manifest.analyses:
            content = load_analysis_content(
                safe_join(bundle_dir, ref.path), ref.format
            )
            artifacts.append(AnalysisArtifactIn(kind=ref.kind, content=content))
        if artifacts:
            ingest_analysis(CallRef(call_id=call_id), artifacts)

        _auto_embed(call_id)
        moved = _move(bundle_dir, root / "done")
        update_job_status(
            job_id, "succeeded", call_id=call_id, bundle_path=str(moved)
        )
        logger.info("ingest_job.complete job=%s call=%s", job_id, call_id)
        return "succeeded"
    except (BundleValidationError, AdapterError) as exc:
        moved = _move(bundle_dir, root / "failed")
        update_job_status(
            job_id, "invalid", error=str(exc), bundle_path=str(moved)
        )
        logger.warning("ingest_job.invalid job=%s err=%s", job_id, exc)
        return "invalid"
    except Exception as exc:
        if attempts < job["max_attempts"]:
            intervals = retry_intervals(
                job["max_attempts"], int(settings.ingest_job_retry_backoff_s)
            )
            delay = intervals[min(attempts - 1, len(intervals) - 1)]
            update_job_status(job_id, "queued", error=str(exc))
            enqueue_job(job_id, delay_s=delay)
            logger.warning(
                "ingest_job.retry job=%s attempt=%s delay=%ss err=%s",
                job_id, attempts, delay, exc,
            )
            return "queued"
        moved = _move(bundle_dir, root / "failed")
        update_job_status(job_id, "failed", error=str(exc), bundle_path=str(moved))
        logger.error("ingest_job.failed job=%s err=%s", job_id, exc)
        return "failed"


def work_once(worker_id: str = "worker") -> Optional[str]:
    """Claim and process one queued job; None when the queue is idle."""
    message = claim_next(worker_id)
    if message is None:
        return None
    try:
        status = process_ingest_job(message["job_id"])
    except Exception as exc:
        # an exception ESCAPING process_ingest_job (its own handlers
        # failed — e.g. the bundle dir vanished mid-move) used to be
        # acked by a bare finally, stranding the job in 'running'
        # forever with no queue message left to recover it. Mark it
        # failed so the state machine terminates, then ack (redelivering
        # a message whose handler crashes deterministically would loop).
        logger.exception(
            "ingest_worker.job_crashed job=%s", message["job_id"]
        )
        try:
            update_job_status(
                message["job_id"], "failed",
                error=f"worker crashed: {exc}",
            )
        except Exception:
            logger.exception(
                "ingest_worker.crash_status_update_failed job=%s",
                message["job_id"],
            )
        ack(message["message_id"])
        return "failed"
    ack(message["message_id"])
    return status
