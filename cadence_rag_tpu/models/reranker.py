"""Cross-encoder reranker (Phase-4 lane; BASELINE.md config 5).

Scores (query, candidate) pairs jointly: hash-tokenized
``query [SEP] doc`` through a small bidirectional transformer, mean-pooled
to a scalar relevance logit. Shares the embedder's design choices
(static shapes, bf16 matmuls/f32 accum, hash tokenizer). Randomly
initialized until fine-tuned — the engine's default rerank provider is the
deterministic lexical scorer (engine/rerank.py); this model is the neural
drop-in once weights exist.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.hashing import fnv1a64
from .embedder import EmbedderConfig, init_params as _init_encoder_params

SEP_TOKEN_ID = 1  # reserved: hash ids start at 2


@dataclasses.dataclass(frozen=True)
class RerankerConfig:
    vocab_buckets: int = 32768
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    max_len: int = 256
    dtype: Any = jnp.bfloat16
    # Two-register recipe: the final score is
    # FROZEN lexical prior + trained transformer residual. The prior is
    # the deterministic BM25+tech-overlap rescore (engine/rerank.
    # prior_for_texts) passed in as an input — not a trainable path —
    # so exact-token ordering survives training by construction (the
    # embedder's frozen-bag residual pattern) while
    # the residual learns what the prior cannot rank (paraphrase).
    prior_residual: bool = False
    # Fixed scale on the prior before it joins the logits. Raw BM25
    # magnitudes (~10-50) drown the residual's trainable range where the
    # prior is only NOISE (paraphrase candidates all sharing the query's
    # service token); a sub-1 gain keeps exact-token margins decisive on
    # the fixture register while letting the residual win near-ties.
    prior_gain: float = 1.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def pair_tokenize(query: str, doc: str, cfg: RerankerConfig) -> np.ndarray:
    ids: List[int] = []
    for word in query.lower().split():
        h = fnv1a64(b"tok:" + word.encode("utf-8"))
        ids.append(int(h % (cfg.vocab_buckets - 2)) + 2)
    ids.append(SEP_TOKEN_ID)
    for word in doc.lower().split():
        h = fnv1a64(b"tok:" + word.encode("utf-8"))
        ids.append(int(h % (cfg.vocab_buckets - 2)) + 2)
        if len(ids) >= cfg.max_len:
            break
    out = np.zeros(cfg.max_len, dtype=np.int32)
    ids = ids[: cfg.max_len]
    out[: len(ids)] = ids
    return out


def init_params(cfg: RerankerConfig, key: jax.Array) -> Dict[str, Any]:
    enc_cfg = EmbedderConfig(
        vocab_buckets=cfg.vocab_buckets, d_model=cfg.d_model,
        n_layers=cfg.n_layers, n_heads=cfg.n_heads, d_ff=cfg.d_ff,
        max_len=cfg.max_len, embed_dim=1,
    )
    params = _init_encoder_params(enc_cfg, key)
    # out_proj (d_model, 1) acts as the relevance head
    return params


def score_pairs(params: Dict[str, Any], token_ids: jax.Array,
                cfg: RerankerConfig,
                prior: Optional[jax.Array] = None) -> jax.Array:
    """(P, L) int32 -> (P,) relevance logits (mean-pooled encoder +
    linear head). Bidirectional attention (no causal mask) — rerankers see
    the full pair. With ``cfg.prior_residual``, ``prior`` (P,) f32 is
    ADDED to the logits (an input, never a gradient path)."""
    from .embedder import _block, _layer_norm  # shared blocks

    enc_cfg = EmbedderConfig(
        vocab_buckets=cfg.vocab_buckets, d_model=cfg.d_model,
        n_layers=cfg.n_layers, n_heads=cfg.n_heads, d_ff=cfg.d_ff,
        max_len=cfg.max_len, embed_dim=1, dtype=cfg.dtype,
    )
    mask = token_ids != 0
    x = jnp.take(params["tok_emb"], token_ids, axis=0)
    x = x + params["pos_emb"][None, : token_ids.shape[1]]
    for block_params in params["blocks"]:
        x = _block(x, block_params, enc_cfg, mask, sharded=False)
    x = _layer_norm(x, params["final_ln"]["scale"], params["final_ln"]["bias"])
    denom = jnp.maximum(mask.sum(axis=1, keepdims=True), 1)
    pooled = (x * mask[..., None]).sum(axis=1) / denom
    logits = jnp.dot(
        pooled.astype(cfg.dtype), params["out_proj"].astype(cfg.dtype),
        preferred_element_type=jnp.float32,
    )[:, 0]
    if cfg.prior_residual and prior is not None:
        logits = logits + cfg.prior_gain * jax.lax.stop_gradient(
            jnp.asarray(prior, jnp.float32)
        )
    return logits


# ------------------------------------------------------------- training ----

def pairwise_loss(
    params: Dict[str, Any],
    tokens_hi: jax.Array,    # (P, L) pairs the teacher ranks HIGHER
    tokens_lo: jax.Array,    # (P, L) pairs the teacher ranks LOWER
    cfg: RerankerConfig,
    prior_hi: Optional[jax.Array] = None,
    prior_lo: Optional[jax.Array] = None,
) -> jax.Array:
    """RankNet-style pairwise logistic loss: distills the teacher's
    ORDERING (not its score scale) — rerank applies order only
    (engine/rerank.py keeps the RRF score ladder), so ordering is the
    entire contract. Under ``prior_residual`` the frozen prior joins the
    margin, so pairs the prior already orders correctly contribute ~zero
    gradient and the residual trains only where the prior is blind."""
    s_hi = score_pairs(params, tokens_hi, cfg, prior=prior_hi)
    s_lo = score_pairs(params, tokens_lo, cfg, prior=prior_lo)
    return jnp.mean(jax.nn.softplus(-(s_hi - s_lo)))


def train_step(params, opt_state, tokens_hi, tokens_lo,
               cfg: RerankerConfig, lr: float = 1e-4,
               prior_hi: Optional[jax.Array] = None,
               prior_lo: Optional[jax.Array] = None):
    from .embedder import adamw_update

    loss, grads = jax.value_and_grad(pairwise_loss)(
        params, tokens_hi, tokens_lo, cfg, prior_hi, prior_lo
    )
    new_params, new_opt = adamw_update(params, grads, opt_state, lr=lr)
    return new_params, new_opt, loss


def save_params(path: str, params: Dict[str, Any], cfg: RerankerConfig) -> None:
    flat = {}
    for key_path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat["/".join(str(k) for k in key_path)] = np.asarray(leaf)
    flat["__rerank_cfg__"] = np.array(
        [cfg.vocab_buckets, cfg.d_model, cfg.n_layers, cfg.n_heads,
         cfg.d_ff, cfg.max_len, int(cfg.prior_residual),
         int(round(cfg.prior_gain * 1000))], dtype=np.int64,
    )
    np.savez(path, **flat)


def load_params(path: str) -> "tuple[Dict[str, Any], RerankerConfig]":
    with np.load(path) as data:
        vals = data["__rerank_cfg__"]
        cfg = RerankerConfig(
            vocab_buckets=int(vals[0]), d_model=int(vals[1]),
            n_layers=int(vals[2]), n_heads=int(vals[3]), d_ff=int(vals[4]),
            max_len=int(vals[5]),
            # len-6 cfg rows are pre-round-5 artifacts (no prior head)
            prior_residual=bool(vals[6]) if vals.shape[0] > 6 else False,
            prior_gain=(
                float(vals[7]) / 1000.0 if vals.shape[0] > 7 else 1.0
            ),
        )
        template = init_params(cfg, jax.random.PRNGKey(0))
        leaves_with_path = jax.tree_util.tree_flatten_with_path(template)
        restored = [
            jnp.asarray(data["/".join(str(k) for k in key_path)])
            for key_path, _ in leaves_with_path[0]
        ]
        params = jax.tree_util.tree_unflatten(leaves_with_path[1], restored)
    return params, cfg


class NeuralReranker:
    _instance: Optional["NeuralReranker"] = None

    def __init__(self, cfg: Optional[RerankerConfig] = None, seed: int = 0):
        from ..config import settings

        params_path = (settings.reranker_params_path or "").strip()
        if cfg is None and params_path:
            self.params, self.cfg = load_params(params_path)
        else:
            self.cfg = cfg or RerankerConfig()
            self.params = init_params(self.cfg, jax.random.PRNGKey(seed))
        self._score = jax.jit(partial(score_pairs, cfg=self.cfg))

    @classmethod
    def shared(cls) -> "NeuralReranker":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Drop the singleton (tests and weight reloads)."""
        cls._instance = None

    def score(self, query: str, docs: Sequence[str],
              priors: Optional[np.ndarray] = None) -> np.ndarray:
        if not docs:  # candidates may have vanished from the store (race
            return np.zeros(0, dtype=np.float32)  # with a concurrent delete)
        tokens = np.stack([pair_tokenize(query, d, self.cfg) for d in docs])
        if self.cfg.prior_residual:
            prior = (
                np.zeros(len(docs), np.float32) if priors is None
                else np.asarray(priors, np.float32)
            )
            return np.asarray(
                self._score(self.params, jnp.asarray(tokens),
                            prior=jnp.asarray(prior))
            )
        return np.asarray(self._score(self.params, jnp.asarray(tokens)))
