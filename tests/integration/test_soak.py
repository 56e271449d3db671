"""Soak harness machinery (evals/soak.py) at CPU scale: a seconds-long
run must drive queries + throttled writer + deletes + compaction + the
vocab auto-rebuild together and produce the windowed report the
accelerator-scale soak records."""

from cadence_rag_tpu.evals.soak import run_soak


class TestSoak:
    def test_short_soak_exercises_all_ops(self, tmp_store):
        out = run_soak(
            minutes=12 / 60,           # 12 s
            chunks=1_500,
            batch=8,
            writer_rows_s=600.0,       # 64-row slabs, ~7k rows -> growth
            delete_every_s=2.0,
            n_delete=40,
            compact_at_frac=0.55,
            vocab_at_frac=0.25,
            window_s=3.0,
            decay_floor=0.0,           # CPU timing too noisy to gate
            check=True,
        )
        assert out["failures"] == [], out
        assert out["queries"] > 0 and out["qps_overall"] > 0
        assert out["inserted_rows"] > 500
        assert out["deleted_rows"] > 0
        assert out["compactions"] == 1
        assert out["vocab_rebuild"] and out["vocab_rebuild"]["ran"], out
        assert out["capacity_growths"] == 1, out
        assert len(out["windows"]) >= 2
        for w in out["windows"]:
            assert w["qps"] > 0 and w["p99_ms"] >= w["p50_ms"]
