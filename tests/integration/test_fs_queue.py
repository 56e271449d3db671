"""Drop-folder pipeline tests (coverage model: reference
tests/integration/test_ingest_jobs.py + tests/unit/test_ingest_fs.py:
scanner end-to-end, auto-manifest, single-file wrap, retry policy,
validation failures, auto-embed fail-open/closed)."""

import json
import os
import time
from pathlib import Path

import pytest

from cadence_rag_tpu.ingest import fs_queue
from cadence_rag_tpu.ingest.fs_queue import (
    BundleValidationError,
    build_auto_manifest,
    retry_intervals,
    safe_join,
    scan_inbox_once,
    sha256_file,
    validate_bundle_directory,
    work_once,
)


@pytest.fixture()
def ingest_root(tmp_store, tmp_path, monkeypatch):
    root = tmp_path / "ingest"
    monkeypatch.setattr(tmp_store, "ingest_root_dir", str(root))
    monkeypatch.setattr(tmp_store, "ingest_single_file_min_age_s", 0)
    (root / "inbox").mkdir(parents=True)
    return root


def _write_bundle(root: Path, name: str, with_manifest=True, ready=True):
    bundle = root / "inbox" / name
    bundle.mkdir()
    transcript = bundle / "transcript.json"
    transcript.write_text(
        json.dumps(
            [
                {"speaker": "Ana", "start_ts_ms": 0, "end_ts_ms": 4000,
                 "text": "the ECONNRESET issue is fixed in v2.3.1"},
                {"speaker": "Raj", "start_ts_ms": 4000, "end_ts_ms": 8000,
                 "text": "ship the new BOM to lenovo tomorrow"},
            ]
        )
    )
    notes = bundle / "analysis_notes.md"
    notes.write_text("Decided to pin the client library.\n")
    if with_manifest:
        manifest = {
            "bundle_id": name,
            "call": {"external_id": f"bundle-{name}"},
            "transcript": {
                "path": "transcript.json",
                "format": "auto",
                "sha256": sha256_file(transcript),
            },
            "analyses": [
                {"path": "analysis_notes.md", "format": "markdown",
                 "kind": "notes", "sha256": sha256_file(notes)}
            ],
        }
        (bundle / "manifest.json").write_text(json.dumps(manifest))
    if ready:
        (bundle / "_READY").touch()
    return bundle


class TestValidation:
    def test_valid_bundle(self, ingest_root):
        bundle = _write_bundle(ingest_root, "b1")
        manifest = validate_bundle_directory(bundle)
        assert manifest.bundle_id == "b1"
        assert manifest.transcript.path == "transcript.json"

    def test_sha_mismatch(self, ingest_root):
        bundle = _write_bundle(ingest_root, "b2")
        (bundle / "transcript.json").write_text("[]")
        with pytest.raises(BundleValidationError, match="sha256 mismatch"):
            validate_bundle_directory(bundle)

    def test_path_escape_rejected(self, ingest_root):
        bundle = _write_bundle(ingest_root, "b3", with_manifest=False)
        manifest = {
            "bundle_id": "b3",
            "transcript": {"path": "../../etc/passwd", "format": "auto"},
        }
        (bundle / "manifest.json").write_text(json.dumps(manifest))
        with pytest.raises(BundleValidationError, match="escapes"):
            validate_bundle_directory(bundle)

    def test_retry_intervals(self, tmp_store):
        assert retry_intervals(4, 5) == [5, 10, 20]
        assert retry_intervals(1, 5) == []


class TestAutoManifest:
    def test_inference(self, ingest_root):
        bundle = _write_bundle(ingest_root, "b4", with_manifest=False)
        manifest = build_auto_manifest(bundle)
        assert manifest.transcript is not None
        assert manifest.transcript.path == "transcript.json"
        assert manifest.analyses[0].kind == "notes"
        assert manifest.analyses[0].format == "markdown"

    def test_bundle_id_sanitization(self, ingest_root):
        bundle = (ingest_root / "inbox" / "weird name!! (v2)")
        bundle.mkdir()
        (bundle / "call.json").write_text(json.dumps([{"text": "hi"}]))
        manifest = build_auto_manifest(bundle)
        assert fs_queue.BUNDLE_ID_RE.match(manifest.bundle_id)


class TestScannerWorker:
    def test_scan_enqueue_process(self, ingest_root):
        _write_bundle(ingest_root, "job1")
        stats = scan_inbox_once(ingest_root)
        assert stats["enqueued"] == 1
        jobs = fs_queue.list_ingest_jobs()["items"]
        assert len(jobs) == 1 and jobs[0]["status"] == "queued"
        assert len(jobs[0]["files"]) == 2
        assert (ingest_root / "processing").iterdir()

        status = work_once()
        assert status == "succeeded"
        job = fs_queue.list_ingest_jobs()["items"][0]
        assert job["status"] == "succeeded"
        assert job["call_id"]
        assert list((ingest_root / "done").iterdir())
        # idle queue
        assert work_once() is None

        # retrieval sees the ingested content
        from cadence_rag_tpu.engine.retrieve import retrieve_evidence
        from cadence_rag_tpu.schemas import RetrieveRequest

        resp = retrieve_evidence(RetrieveRequest(query="ECONNRESET v2.3.1"))
        assert resp["quotes"]

    def test_pdf_docx_bundle_end_to_end(self, ingest_root):
        """A dropped bundle carrying .pdf and .docx analysis files ingests
        without optional libraries (adapter parity; the reference
        extracts these via pypdf/python-docx, ingest_adapters.py:131-293)."""
        from tests.unit.test_docformats import make_docx, make_pdf

        bundle = _write_bundle(ingest_root, "docjob", with_manifest=False)
        make_pdf(bundle / "capacity.pdf", [
            b"BT /F1 12 Tf (SSD tiering saved the latency budget) Tj ET",
        ], compress=True)
        make_docx(bundle / "summary.docx",
                  ["Postmortem: ECONNRESET storm resolved by rollback"])
        stats = scan_inbox_once(ingest_root)  # auto-manifest picks both up
        assert stats["enqueued"] == 1
        assert work_once() == "succeeded"
        job = fs_queue.list_ingest_jobs()["items"][0]
        roles = {f["path"] for f in job["files"]}
        assert {"capacity.pdf", "summary.docx"} <= roles

        from cadence_rag_tpu.engine.retrieve import retrieve_evidence
        from cadence_rag_tpu.schemas import RetrieveRequest

        resp = retrieve_evidence(
            RetrieveRequest(query="SSD tiering latency budget")
        )
        assert any("SSD tiering" in a["snippet"] for a in resp["artifacts"])
        resp = retrieve_evidence(
            RetrieveRequest(query="postmortem rollback ECONNRESET")
        )
        assert any("rollback" in a["snippet"] for a in resp["artifacts"])

    def test_not_ready_skipped(self, ingest_root):
        _write_bundle(ingest_root, "sleepy", ready=False)
        stats = scan_inbox_once(ingest_root)
        assert stats["enqueued"] == 0 and stats["skipped"] == 1

    def test_single_file_autowrap(self, ingest_root):
        single = ingest_root / "inbox" / "standalone_call.json"
        single.write_text(json.dumps([{"speaker": "A", "text": "hello world"}]))
        stats = scan_inbox_once(ingest_root)
        assert stats["enqueued"] == 1
        assert work_once() == "succeeded"

    def test_invalid_bundle_moves_to_failed(self, ingest_root, tmp_store, monkeypatch):
        monkeypatch.setattr(tmp_store, "ingest_auto_manifest", False)
        bundle = ingest_root / "inbox" / "nomanifest"
        bundle.mkdir()
        (bundle / "data.json").write_text("[]")
        (bundle / "_READY").touch()
        stats = scan_inbox_once(ingest_root)
        assert stats["invalid"] == 1
        jobs = fs_queue.list_ingest_jobs(status="invalid")["items"]
        assert len(jobs) == 1
        assert list((ingest_root / "failed").iterdir())

    def test_duplicate_bundle_id_invalid(self, ingest_root):
        _write_bundle(ingest_root, "dup")
        scan_inbox_once(ingest_root)
        work_once()
        _write_bundle(ingest_root, "dup")
        stats = scan_inbox_once(ingest_root)
        assert stats["invalid"] == 1

    def test_retryable_failure_requeues(self, ingest_root, monkeypatch):
        _write_bundle(ingest_root, "flaky")
        scan_inbox_once(ingest_root)

        calls = {"n": 0}
        import cadence_rag_tpu.ingest.fs_queue as fsq

        real_load = fsq.load_transcript_payload

        def flaky_load(path, fmt):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient io error")
            return real_load(path, fmt)

        monkeypatch.setattr(fsq, "load_transcript_payload", flaky_load)
        assert work_once() == "queued"
        job = fs_queue.list_ingest_jobs()["items"][0]
        assert job["status"] == "queued" and job["attempts"] == 1
        # message re-enqueued with backoff; make it available now
        store = fs_queue.get_store()
        with store.tx() as conn:
            conn.execute("UPDATE queue SET available_at = 0 WHERE done = 0")
        assert work_once() == "succeeded"

    def test_auto_embed_fail_open_and_closed(self, ingest_root, tmp_store, monkeypatch):
        import cadence_rag_tpu.ingest.fs_queue as fsq

        def boom(**kw):
            raise RuntimeError("embedder down")

        monkeypatch.setattr(
            "cadence_rag_tpu.embed.pipeline.run_embedding_backfill", boom
        )
        _write_bundle(ingest_root, "openfail")
        scan_inbox_once(ingest_root)
        monkeypatch.setattr(tmp_store, "ingest_auto_embed_fail_on_error", False)
        assert work_once() == "succeeded"  # fail-open

        monkeypatch.setattr(tmp_store, "ingest_auto_embed_fail_on_error", True)
        monkeypatch.setattr(tmp_store, "ingest_job_max_attempts", 1)
        _write_bundle(ingest_root, "closedfail")
        scan_inbox_once(ingest_root)
        assert work_once() == "failed"  # fail-closed exhausts attempts


class TestAutoManifestInference:
    def test_summary_md_not_mistaken_for_transcript(self, ingest_root):
        """Regression: 'summary_notes.md' sorts before 'transcript.json';
        the transcript must still be chosen by likelihood, not order."""
        bundle = ingest_root / "inbox" / "order-trap"
        bundle.mkdir()
        (bundle / "summary_notes.md").write_text("Rollback fixed it.\n")
        (bundle / "transcript.json").write_text(json.dumps(
            [{"speaker": "A", "start_ts_ms": 0, "end_ts_ms": 900,
              "text": "rollback to v2.3.1 resolved the resets"}]
        ))
        manifest = build_auto_manifest(bundle)
        assert manifest.transcript.path == "transcript.json"
        assert [a.path for a in manifest.analyses] == ["summary_notes.md"]
        assert manifest.analyses[0].kind in ("summary", "notes")

    def test_bundle_with_only_analyses(self, ingest_root):
        bundle = ingest_root / "inbox" / "analysis-only"
        bundle.mkdir()
        (bundle / "summary.md").write_text("Just a summary.\n")
        (bundle / "risks.csv").write_text("risk,owner\nslippage,Ana\n")
        manifest = build_auto_manifest(bundle)
        assert manifest.transcript is None
        assert len(manifest.analyses) == 2

    def test_end_to_end_with_mixed_bundle(self, ingest_root):
        bundle = ingest_root / "inbox" / "mixed"
        bundle.mkdir()
        (bundle / "summary_notes.md").write_text("Rollback fixed it.\n")
        (bundle / "transcript.json").write_text(json.dumps(
            [{"speaker": "A", "start_ts_ms": 0, "end_ts_ms": 900,
              "text": "the ECONNRESET storm hit the gateway"}]
        ))
        (bundle / "_READY").touch()
        scan_inbox_once(ingest_root)
        assert work_once() == "succeeded"
        from cadence_rag_tpu.engine.retrieve import retrieve_evidence
        from cadence_rag_tpu.schemas import RetrieveRequest

        resp = retrieve_evidence(RetrieveRequest(query="ECONNRESET storm gateway"))
        assert resp["quotes"] and resp["artifacts"]


class TestInvalidRecordIsolation:
    def test_duplicate_redrop_does_not_clobber_original_job(
            self, ingest_root):
        """A re-dropped bundle with a used bundle_id is recorded invalid
        under its OWN job row; the original (succeeded) job keeps its
        status and bundle_path (review finding: create_or_get_job
        returned the original row and _record_invalid overwrote it)."""
        _write_bundle(ingest_root, "redrop")
        scan_inbox_once(ingest_root)
        assert work_once() == "succeeded"
        original = fs_queue.list_ingest_jobs()["items"][0]
        assert original["status"] == "succeeded"

        _write_bundle(ingest_root, "redrop")
        stats = scan_inbox_once(ingest_root)
        assert stats["invalid"] == 1
        jobs = fs_queue.list_ingest_jobs()["items"]
        by_id = {j["ingest_job_id"]: j for j in jobs}
        # original untouched
        assert by_id[original["ingest_job_id"]]["status"] == "succeeded"
        assert (by_id[original["ingest_job_id"]]["bundle_path"]
                == original["bundle_path"])
        # the duplicate drop has its own invalid record
        invalid = [j for j in jobs if j["status"] == "invalid"]
        assert len(invalid) == 1
        assert invalid[0]["ingest_job_id"] != original["ingest_job_id"]

    def test_worker_crash_marks_job_failed_not_running(
            self, ingest_root, monkeypatch):
        """An exception ESCAPING process_ingest_job must not strand the
        job in 'running' with the queue message acked (review finding:
        bare finally-ack)."""
        _write_bundle(ingest_root, "crash")
        scan_inbox_once(ingest_root)
        import cadence_rag_tpu.ingest.fs_queue as fsq

        def boom(job_id):
            raise OSError("disk gone")

        monkeypatch.setattr(fsq, "process_ingest_job", boom)
        assert fsq.work_once() == "failed"
        job = fs_queue.list_ingest_jobs()["items"][0]
        assert job["status"] == "failed"
        assert "worker crashed" in (job["error"] or "")
        # message acked: nothing left to claim
        assert fsq.claim_next("w2") is None
