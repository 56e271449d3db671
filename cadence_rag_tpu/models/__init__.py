"""In-process model families.

The reference delegates embedding to an external GPU service
(Qwen3-Embedding-4B behind Triton; reference:
P620_TRITON_QWEN3_4B_EMBEDDING_RUNBOOK.md). This package provides the
in-process equivalents: a JAX transformer embedder obeying the same vector
contract (last-token pooling, truncate-to-dim, L2 normalize) with a
contrastive training step shardable over a device mesh, and (later phases)
a cross-encoder reranker.
"""
