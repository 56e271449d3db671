"""Trained embedder as the dense provider: the committed artifact must
beat the hash stub on paraphrase queries and hold the fixture gate's
reference floors (MRR 0.60 / recall@20 0.80 / nDCG@10 0.70).
"""

from pathlib import Path

import pytest

ARTIFACT = Path(__file__).resolve().parents[2] / "artifacts" / "embedder" / \
    "tuned_small_v1.npz"


class TestCommittedArtifact:
    def test_artifact_loads_and_bag_regenerates(self):
        from cadence_rag_tpu.models.embedder import load_params

        params, cfg = load_params(str(ARTIFACT))
        assert cfg.use_bag and cfg.freeze_bag
        # the frozen bag is not stored; it regenerates from (cfg, seed)
        assert params["bag_emb"].shape == (cfg.vocab_buckets, cfg.embed_dim)
        assert cfg.embed_dim == 1024

    def test_real_gate_passes_with_neural_artifact(self, tmp_store,
                                                   monkeypatch):
        """The end-to-end gate (all lanes fused) clears the reference
        floors with provider=neural + the committed weights."""
        from cadence_rag_tpu.evals.real_gate import run_gate

        # the artifact obeys the production 1024-d vector contract (the
        # suite's tmp_store fixture shrinks dims for speed)
        monkeypatch.setattr(tmp_store, "embeddings_dim", 1024)
        outcome = run_gate(
            provider="neural", embedder_params_path=str(ARTIFACT)
        )
        assert outcome["failures"] == [], outcome

    def test_artifact_paraphrase_beats_stub_dense_only(self, tmp_store):
        """Dense-lane-only: the tuned model must beat the stub on register
        paraphrase (the one capability the stub cannot have). Uses the
        synthetic eval combos the artifact's training never saw."""
        import numpy as np

        from cadence_rag_tpu.config import settings
        from cadence_rag_tpu.embed.stub import embed_one
        from cadence_rag_tpu.evals.train_corpus import (
            EVENTS,
            generate_calls,
            train_eval_split,
        )
        from cadence_rag_tpu.models.embedder import (
            batch_tokenize,
            encode,
            load_params,
        )

        _, eval_combos = train_eval_split(seed=0)
        eval_calls = generate_calls(eval_combos, seed=1)
        docs, gold_sets, queries = [], [], []
        rng = np.random.default_rng(3)
        for ci, call in enumerate(eval_calls):
            phr = EVENTS[call.event]["summary"]
            queries.append(
                phr[int(rng.integers(0, len(phr)))].format(svc=call.service)
            )
            gold = set()
            for text in call.transcript:
                if call.service in text:
                    gold.add(len(docs))
                docs.append(text)
            gold_sets.append(gold)

        import jax
        import jax.numpy as jnp

        params, cfg = load_params(str(ARTIFACT))
        enc = jax.jit(lambda t: encode(params, t, cfg))

        def neural(texts):
            return np.asarray(enc(jnp.asarray(batch_tokenize(texts, cfg))))

        def stub(texts):
            return np.stack([
                embed_one(t, int(settings.embeddings_dim)) for t in texts
            ])

        def mrr(embed_fn):
            d = embed_fn(docs)
            q = embed_fn(queries)
            ranks = np.argsort(-(q @ d.T), axis=1)
            total = 0.0
            for qi, gold in enumerate(gold_sets):
                for rank, di in enumerate(ranks[qi], start=1):
                    if di in gold:
                        total += 1.0 / rank
                        break
            return total / len(gold_sets)

        stub_mrr = mrr(stub)
        neural_mrr = mrr(neural)
        assert neural_mrr > stub_mrr + 0.05, (neural_mrr, stub_mrr)
