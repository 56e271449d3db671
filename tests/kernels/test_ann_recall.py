"""ANN recall gate at CPU-test scale (the 100k run is the CLI:
python -m cadence_rag_tpu.evals.ann_recall_gate)."""

from cadence_rag_tpu.evals.ann_recall_gate import measure_recall


class TestAnnRecall:
    def test_ann_mode_recall(self):
        result = measure_recall(n=4096, n_queries=16, k=10, mode="ann")
        assert result["recall_at_k"] >= 0.9, result

    def test_ef_search_improves_recall(self):
        low = measure_recall(n=4096, n_queries=16, k=10, ef_search=10)
        high = measure_recall(n=4096, n_queries=16, k=10, ef_search=640)
        assert high["recall_target"] > low["recall_target"]
        assert high["recall_at_k"] >= low["recall_at_k"] - 0.05

    def test_filtered_recall_contiguous_mask(self):
        """The filtered-ANN guarantee: recall must hold under a selective
        CONTIGUOUS mask — the worst case for a windowed partial reduce
        (date/call filters select insertion-contiguous rows); this is
        the CPU regression tripwire."""
        for density in (0.05, 0.01):
            result = measure_recall(
                n=8192, n_queries=16, k=10,
                density=density, mask_shape="contiguous",
            )
            assert result["recall_at_k"] >= 0.9, result

    def test_filtered_recall_random_mask(self):
        result = measure_recall(
            n=8192, n_queries=16, k=10, density=0.05, mask_shape="random"
        )
        assert result["recall_at_k"] >= 0.9, result

    def test_filtered_recall_restricts_to_mask(self):
        """Every returned index must satisfy the filter."""
        import numpy as np

        from cadence_rag_tpu.evals.filtered_recall_sweep import run_sweep

        rows = run_sweep(
            n=2048, batch=4, k=5, densities=[0.1], targets=[0.95],
            mask_shapes=["contiguous"], rounds=1,
        )
        assert rows and rows[0]["recall_at_k"] >= 0.8
        assert np.isfinite(rows[0]["approx_ms"])
