"""Planner decision table (coverage model: reference
tests/unit/test_retrieve_planner.py:13-49)."""

import pytest

from cadence_rag_tpu.config import settings
from cadence_rag_tpu.engine.planner import (
    choose_dense_mode,
    recall_target_for_ef_search,
)


class TestChooseDenseMode:
    def test_scoped_small_exact(self, monkeypatch):
        monkeypatch.setattr(settings, "embeddings_exact_scan_threshold", 2000)
        assert choose_dense_mode(500, scoped=True) == "exact"

    def test_scoped_large_ann(self, monkeypatch):
        monkeypatch.setattr(settings, "embeddings_exact_scan_threshold", 2000)
        assert choose_dense_mode(5000, scoped=True) == "ann"

    def test_unscoped_ann(self):
        assert choose_dense_mode(100, scoped=False) == "ann"

    def test_zero_candidates_exact(self):
        assert choose_dense_mode(0, scoped=True) == "exact"
        assert choose_dense_mode(0, scoped=False) == "exact"

    def test_threshold_boundary(self, monkeypatch):
        monkeypatch.setattr(settings, "embeddings_exact_scan_threshold", 2000)
        assert choose_dense_mode(2000, scoped=True) == "exact"
        assert choose_dense_mode(2001, scoped=True) == "ann"


class TestRecallTargetMap:
    def test_monotone_in_ef_search(self):
        # ef below the anchor is CLAMPED to it (planner docstring)
        lo = recall_target_for_ef_search(20)
        mid = recall_target_for_ef_search(80)
        hi = recall_target_for_ef_search(320)
        assert lo == mid < hi

    def test_anchor_at_80(self):
        assert recall_target_for_ef_search(80) == pytest.approx(
            float(settings.ann_recall_target)
        )

    def test_bounded(self):
        assert 0.5 <= recall_target_for_ef_search(1) <= 0.999
        assert 0.5 <= recall_target_for_ef_search(100000) <= 0.999
