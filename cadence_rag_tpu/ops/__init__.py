"""Device kernels and vectorized XLA ops for the retrieval core.

The reference delegates all performance-critical search to native Postgres
extensions: pgvector (C) for dense cosine exact/HNSW scan, pg_search (Rust)
for BM25 over ngram(3,3) fields, and GIN array-overlap for tech tokens
(reference: SURVEY.md §2.3). This package re-implements each as
device-resident XLA compute:

- ``topk``     — batched cosine top-k: matmul + exact ``lax.top_k`` or
                 ``lax.approx_max_k`` (the ANN lane; exact on CPU and GPU).
- ``lexical``  — BM25-style scoring over signed-hash ngram signatures as a
                 matmul over int8 rows (replaces pg_search's `text @@@ :q`).
- ``techlane`` — exact token-hash intersection with recency ordering
                 (replaces `tech_tokens && :arr` + GIN).
- ``masks``    — call-level filter scoping as boolean masks fused into the
                 score computation (replaces SQL WHERE clauses).
- ``fusion``   — vectorized Reciprocal Rank Fusion.
- ``fused``    — the single jitted multi-lane program over the chunk matrix.
- ``hashing``  — host-side feature hashing shared with the C++ featurizer.
"""
