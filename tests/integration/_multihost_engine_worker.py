"""Worker for test_multihost_serving engine-level gang test.

Run as: python _multihost_engine_worker.py <pid> <coordinator> <oplog_port>
        <checkpoint_path>

Leader (pid 0): restore a checkpoint onto the gang's mesh, query while
the artifacts corpus is still empty (cold-start query_single fallback),
run the embedding backfill (scatter_emb ops), query dense, ingest an
analysis artifact and query through the packed dual-corpus path. Prints
one "RESULT {json}" line. Follower (pid != 0): replays the op-log.

Covers the op types the HTTP e2e scenario does not: alloc/write restore
ops, scatter_emb, and query_single.
"""

import json
import sys
from datetime import datetime, timezone

import jax

jax.config.update("jax_platforms", "cpu")


def main() -> None:
    pid = int(sys.argv[1])
    coordinator = sys.argv[2]
    oplog_port = int(sys.argv[3])
    ckpt = sys.argv[4]
    jax.distributed.initialize(
        coordinator, num_processes=2, process_id=pid
    )
    from cadence_rag_tpu.core.index import get_index
    from cadence_rag_tpu.parallel import oplog

    index = get_index()
    if pid != 0:
        oplog.follower_main(index, "127.0.0.1", oplog_port)
        return

    oplog.install_leader(index, oplog_port, 1)
    from cadence_rag_tpu.core.checkpoint import restore_index
    from cadence_rag_tpu.embed.pipeline import run_embedding_backfill
    from cadence_rag_tpu.engine.retrieve import retrieve_evidence_batch
    from cadence_rag_tpu.ingest.ingest import (
        ingest_analysis,
        ingest_transcript,
    )
    from cadence_rag_tpu.schemas import (
        AnalysisArtifactIn,
        CallRef,
        RetrieveRequest,
    )

    def ids(query):
        return retrieve_evidence_batch(
            [RetrieveRequest(query=query, return_style="ids_only")]
        )[0]["retrieved_ids"]

    out = {}
    restore_index(ckpt, index)
    out["counts"] = [index.chunks.count, index.artifacts.count]
    # artifacts empty -> cold-start fallback -> query_single op
    out["restored"] = ids("kafka timeout incident")
    summary = run_embedding_backfill(batch_size=16)  # scatter_emb ops
    out["embedded"] = int(index.chunks.emb_rows)
    del summary
    out["dense"] = ids("kafka timeout incident")
    ingest_analysis(
        CallRef(external_id="seed-0"),
        [AnalysisArtifactIn(kind="summary",
                            content="kafka incident rollback summary")],
    )
    out["packed"] = ids("kafka rollback")
    # compaction mirrors over the op-log (r2 stand-down removed):
    # tombstone a third of the chunks, force-compact, query again
    doomed = index.chunks.h_ids[: index.chunks.count][::3].tolist()
    index.chunks.delete_ids(doomed)
    index.chunks.compact()
    out["compacted_count"] = int(index.chunks.count)
    out["post_compact"] = ids("kafka timeout incident")
    # multi-host IVF: gang k-means build
    # mirrored as ONE 'build_ivf' op, the probed dense dispatch mirrored
    # per query ('query_ivf'), overflow appends mirrored ('ivf_overflow')
    state = index.chunks.build_ivf(n_clusters=8, seed=7)
    out["ivf_plan"] = [state.built_count, state.n_clusters, state.nprobe]
    out["ivf_usable"] = bool(index.chunks.ivf_usable())
    out["ivf_ids"] = ids("kafka timeout incident")
    from cadence_rag_tpu.schemas import ChunkingOptions, UtteranceIn

    ingest_transcript(
        CallRef(external_id="post-ivf",
                started_at=datetime(2026, 1, 2, 3, 4, 5,
                                    tzinfo=timezone.utc)),
        [UtteranceIn(speaker="B", start_ts_ms=0, end_ts_ms=4000,
                     text="cache latency deploy rollback billing")],
        ChunkingOptions(target_tokens=16, max_tokens=32, overlap_tokens=0),
    )
    out["ivf_overflow"] = int(index.chunks.ivf.overflow_count)
    out["post_overflow_ids"] = ids("kafka timeout incident")
    # gang save (checkpoint format v3): follower writes its heavy row
    # blocks via the mirrored op; leader writes scalars + meta-last
    from cadence_rag_tpu.core.checkpoint import save_index

    gang_ckpt = sys.argv[5]
    meta = save_index(gang_ckpt, index)
    out["saved_format"] = int(meta["format_version"])
    out["saved_counts"] = [meta["counts"]["chunks"],
                           meta["counts"]["artifact_chunks"]]
    print("RESULT " + json.dumps(out), flush=True)
    oplog.leader().shutdown()


if __name__ == "__main__":
    main()
