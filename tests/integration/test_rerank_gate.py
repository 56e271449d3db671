"""Rerank gate (evals/rerank_gate.py): the TWO-REGISTER cross-encoder
(frozen lexical prior + trained residual) must beat
the lexical rescorer on paraphrase candidates AND hold the
lexically-saturated fixture gate's floors — both registers, one model.

The committed artifact (artifacts/reranker/two_register_v1.npz,
prior_gain 0.2, 2000 steps over paraphrase relevance triples + lexical
teacher triples) gated at: paraphrase neural_raw MRR 0.889 vs lexical
0.635 (floor 0.50, margin 0.10), e2e through /retrieve 0.438 vs 0.309,
fixture gate mrr 0.917 / recall@20 0.972 / ndcg@10 0.845 (floors
0.60/0.80/0.70). CI re-evaluates that artifact through the production
rerank providers on the regenerated gate corpus; a short CPU training
run smoke-tests the training half.
"""

from pathlib import Path

import pytest

from cadence_rag_tpu.evals.rerank_gate import run_gate

ARTIFACT = (
    Path(__file__).resolve().parents[2]
    / "artifacts" / "reranker" / "two_register_v1.npz"
)


class TestRerankGate:
    def test_committed_artifact_beats_lexical(self):
        assert ARTIFACT.is_file(), "committed reranker artifact missing"
        outcome = run_gate(params_path=str(ARTIFACT))
        assert outcome["failures"] == [], outcome
        assert outcome["neural_mrr"] > outcome["lexical_mrr"] + 0.10
        assert outcome["shuffled_mrr"] < outcome["neural_mrr"]
        # end-to-end through /retrieve with RERANK_ENABLED=1: the tuned
        # cross-encoder must not lose to the lexical provider on
        # candidates produced by the REAL fused retrieval
        assert outcome["e2e_neural_mrr"] >= outcome["e2e_lexical_mrr"]
        # the fixture register: reordering the fused top-k must not
        # break exact-token ranking
        fx = outcome["fixture_metrics"]
        assert fx["mrr"] >= 0.60 and fx["recall@20"] >= 0.80
        assert fx["ndcg@10"] >= 0.70

    def test_training_path_smoke(self):
        # machinery only: triples build, two-register training runs,
        # eval produces MRRs
        outcome = run_gate(steps=60, min_margin=-1.0, min_mrr=0.0,
                           fixture_phase=False)
        assert outcome["triples"] > 100
        assert outcome["queries"] > 10
        assert 0.0 <= outcome["neural_mrr"] <= 1.0
        assert outcome["final_loss"] is not None
