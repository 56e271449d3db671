"""In-process JAX transformer text embedder.

Replaces the reference's external embedding service with an in-process JAX
model obeying the identical vector contract (reference:
P620_TRITON_QWEN3_4B_EMBEDDING_RUNBOOK.md:703-715): causal transformer,
**last-token pooling**, hidden truncated to ``embed_dim``, **L2
normalized** — so cosine ≡ dot in the device index.

Design choices:
- hash tokenizer (no vocab files; FNV-1a word/subword hashing into a fixed
  bucket space) keeps everything offline and deterministic;
- bf16 matmuls with f32 accumulation, static (batch, seq) shapes;
- Megatron-style tensor parallelism: attention heads and MLP hidden are
  sharded over the mesh's "model" axis, batch over "data"; sequence-dim
  activation sharding ("sp") is applied between blocks via
  with_sharding_constraint;
- contrastive InfoNCE training step (in-batch negatives) for fine-tuning on
  call-transcript pairs; the full step (fwd+bwd+adamw) is what
  __graft_entry__.dryrun_multichip compiles over an n-device mesh.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.hashing import fnv1a64

# --------------------------------------------------------------- config ----


@dataclasses.dataclass(frozen=True)
class EmbedderConfig:
    vocab_buckets: int = 32768
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 1024
    max_len: int = 128
    embed_dim: int = 1024          # output dim (truncation target)
    # Residual hash-bag head: a per-token embedding bag added to the
    # transformer output before normalization. Initialized with random
    # gaussian rows it reproduces the hash-stub's behavior (texts sharing
    # vocabulary are cosine-similar) at step 0, so training can only
    # improve on that lexical prior while the transformer learns the
    # paraphrase/synonym structure the bag cannot express.
    use_bag: bool = True
    bag_init_scale: float = 1.0    # bag mixture weight at init
    tfm_init_scale: float = 0.5    # transformer mixture weight at init
    # freeze_bag keeps the lexical prior fixed (stop_gradient on the bag
    # and the mixture): the transformer trains as a pure RESIDUAL, so the
    # tuned model can never fall below its lexical-prior starting point by
    # drifting the mixture toward a memorizing transformer.
    freeze_bag: bool = True
    dtype: Any = jnp.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# ------------------------------------------------------------ tokenizer ----

def hash_tokenize(text: str, cfg: EmbedderConfig) -> np.ndarray:
    """Word-level FNV-1a hashing into vocab buckets; ids are 1-based
    (0 = pad). Deterministic, no external vocab."""
    ids: List[int] = []
    for word in text.lower().split():
        h = fnv1a64(b"tok:" + word.encode("utf-8"))
        ids.append(int(h % (cfg.vocab_buckets - 1)) + 1)
        if len(ids) >= cfg.max_len:
            break
    return np.asarray(ids, dtype=np.int32)


def batch_tokenize(texts: Sequence[str], cfg: EmbedderConfig) -> np.ndarray:
    batch = np.zeros((len(texts), cfg.max_len), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = hash_tokenize(text, cfg)
        batch[i, : len(ids)] = ids
    return batch


# --------------------------------------------------------------- params ----

def init_params(cfg: EmbedderConfig, key: jax.Array) -> Dict[str, Any]:
    keys = jax.random.split(key, 4 + cfg.n_layers)
    scale = 0.02
    params: Dict[str, Any] = {
        "tok_emb": jax.random.normal(keys[0], (cfg.vocab_buckets, cfg.d_model)) * scale,
        "pos_emb": jax.random.normal(keys[1], (cfg.max_len, cfg.d_model)) * scale,
        "final_ln": {"scale": jnp.ones(cfg.d_model), "bias": jnp.zeros(cfg.d_model)},
        "out_proj": jax.random.normal(keys[2], (cfg.d_model, cfg.embed_dim)) * scale,
        "blocks": [],
    }
    if cfg.use_bag:
        # unit-gaussian rows: at init the bag term IS the hash stub
        params["bag_emb"] = jax.random.normal(
            keys[3], (cfg.vocab_buckets, cfg.embed_dim)
        )
        params["mix"] = jnp.array(
            [cfg.bag_init_scale, cfg.tfm_init_scale], jnp.float32
        )
    for i in range(cfg.n_layers):
        bkey = jax.random.split(keys[4 + i], 6)
        params["blocks"].append(
            {
                "ln1": {"scale": jnp.ones(cfg.d_model), "bias": jnp.zeros(cfg.d_model)},
                "wqkv": jax.random.normal(bkey[0], (cfg.d_model, 3 * cfg.d_model)) * scale,
                "wo": jax.random.normal(bkey[1], (cfg.d_model, cfg.d_model)) * scale,
                "ln2": {"scale": jnp.ones(cfg.d_model), "bias": jnp.zeros(cfg.d_model)},
                "w_in": jax.random.normal(bkey[2], (cfg.d_model, cfg.d_ff)) * scale,
                "w_out": jax.random.normal(bkey[3], (cfg.d_ff, cfg.d_model)) * scale,
            }
        )
    return params


def param_shardings(cfg: EmbedderConfig, mesh: Mesh) -> Dict[str, Any]:
    """Megatron layout: qkv/w_in column-parallel, wo/w_out row-parallel,
    token embeddings sharded over vocab."""
    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    block = {
        "ln1": {"scale": ns(), "bias": ns()},
        "wqkv": ns(None, "model"),
        "wo": ns("model", None),
        "ln2": {"scale": ns(), "bias": ns()},
        "w_in": ns(None, "model"),
        "w_out": ns("model", None),
    }
    out = {
        "tok_emb": ns("model", None),
        "pos_emb": ns(),
        "final_ln": {"scale": ns(), "bias": ns()},
        "out_proj": ns(None, "model"),
        "blocks": [block for _ in range(cfg.n_layers)],
    }
    if cfg.use_bag:
        out["bag_emb"] = ns("model", None)   # vocab-sharded like tok_emb
        out["mix"] = ns()
    return out


# -------------------------------------------------------------- forward ----

def _layer_norm(x: jax.Array, scale: jax.Array, bias: jax.Array) -> jax.Array:
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    normed = (x - mean) * jax.lax.rsqrt(var + 1e-5)
    return normed * scale + bias


def _block(x: jax.Array, params: Dict[str, Any], cfg: EmbedderConfig,
           mask: jax.Array, sharded: bool) -> jax.Array:
    batch, seq, _ = x.shape
    h = _layer_norm(x, params["ln1"]["scale"], params["ln1"]["bias"])
    qkv = jnp.dot(
        h.astype(cfg.dtype), params["wqkv"].astype(cfg.dtype),
        preferred_element_type=jnp.float32,
    )
    q, k, v = jnp.split(qkv, 3, axis=-1)

    def heads(t):
        return t.reshape(batch, seq, cfg.n_heads, cfg.head_dim).transpose(0, 2, 1, 3)

    q, k, v = heads(q), heads(k), heads(v)
    logits = jnp.einsum(
        "bhqd,bhkd->bhqk", q.astype(cfg.dtype), k.astype(cfg.dtype),
        preferred_element_type=jnp.float32,
    ) / jnp.sqrt(float(cfg.head_dim))
    causal = jnp.tril(jnp.ones((seq, seq), dtype=bool))
    attn_mask = causal[None, None] & mask[:, None, None, :]
    logits = jnp.where(attn_mask, logits, -1e9)
    weights = jax.nn.softmax(logits, axis=-1)
    ctx = jnp.einsum(
        "bhqk,bhkd->bhqd", weights.astype(cfg.dtype), v.astype(cfg.dtype),
        preferred_element_type=jnp.float32,
    )
    ctx = ctx.transpose(0, 2, 1, 3).reshape(batch, seq, cfg.d_model)
    attn_out = jnp.dot(
        ctx.astype(cfg.dtype), params["wo"].astype(cfg.dtype),
        preferred_element_type=jnp.float32,
    )
    x = x + attn_out

    h = _layer_norm(x, params["ln2"]["scale"], params["ln2"]["bias"])
    ff = jnp.dot(h.astype(cfg.dtype), params["w_in"].astype(cfg.dtype),
                 preferred_element_type=jnp.float32)
    ff = jax.nn.gelu(ff)
    ff = jnp.dot(ff.astype(cfg.dtype), params["w_out"].astype(cfg.dtype),
                 preferred_element_type=jnp.float32)
    x = x + ff
    if sharded:
        # sp: shard sequence over "data", hidden over "model" between blocks
        x = jax.lax.with_sharding_constraint(x, P("data", None, None))
    return x


def encode(params: Dict[str, Any], token_ids: jax.Array,
           cfg: EmbedderConfig, *, sharded: bool = False) -> jax.Array:
    """(B, L) int32 -> (B, embed_dim) unit vectors (last-token pooled)."""
    mask = token_ids != 0
    x = jnp.take(params["tok_emb"], token_ids, axis=0)
    x = x + params["pos_emb"][None, : token_ids.shape[1]]
    for block_params in params["blocks"]:
        x = _block(x, block_params, cfg, mask, sharded)
    x = _layer_norm(x, params["final_ln"]["scale"], params["final_ln"]["bias"])
    # last-token pooling: index of the final non-pad token per row
    lengths = jnp.maximum(mask.sum(axis=1) - 1, 0)
    pooled = x[jnp.arange(x.shape[0]), lengths]
    out = jnp.dot(
        pooled.astype(cfg.dtype), params["out_proj"].astype(cfg.dtype),
        preferred_element_type=jnp.float32,
    )
    if cfg.use_bag and "bag_emb" in params:
        counts = jnp.maximum(mask.sum(axis=1, keepdims=True), 1)
        bag = jnp.einsum(
            "bl,bld->bd", mask.astype(jnp.float32),
            jnp.take(params["bag_emb"], token_ids, axis=0),
        ) / counts
        bag_norm = jnp.linalg.norm(bag, axis=-1, keepdims=True)
        bag = bag / jnp.maximum(bag_norm, 1e-6)
        out_norm = jnp.linalg.norm(out, axis=-1, keepdims=True)
        out = out / jnp.maximum(out_norm, 1e-6)
        mix = params["mix"]
        if cfg.freeze_bag:
            bag = jax.lax.stop_gradient(bag)
            mix = jax.lax.stop_gradient(mix)
        out = mix[0] * bag + mix[1] * out
    norm = jnp.linalg.norm(out, axis=-1, keepdims=True)
    return out / jnp.maximum(norm, 1e-6)


# ------------------------------------------------------------- training ----

def info_nce_loss(params: Dict[str, Any], anchors: jax.Array,
                  positives: jax.Array, cfg: EmbedderConfig,
                  temperature: float = 0.05, *, sharded: bool = False,
                  negatives: Optional[jax.Array] = None) -> jax.Array:
    """InfoNCE with in-batch negatives; ``negatives`` (B, L) adds one
    explicit hard negative per anchor (lexical near-misses — candidates
    that SCORE high lexically but are not the positive — are the negatives
    that teach the model what the lexical lanes cannot already do)."""
    za = encode(params, anchors, cfg, sharded=sharded)
    zp = encode(params, positives, cfg, sharded=sharded)
    logits = za @ zp.T  # in-batch negatives
    if negatives is not None:
        zn = encode(params, negatives, cfg, sharded=sharded)
        logits = jnp.concatenate([logits, za @ zn.T], axis=1)
    logits = logits / temperature
    labels = jnp.arange(za.shape[0])
    return jnp.mean(
        -jax.nn.log_softmax(logits, axis=-1)[labels, labels]
    )


def adamw_init(params) -> Dict[str, Any]:
    zeros = jax.tree.map(jnp.zeros_like, params)
    return {"mu": zeros, "nu": jax.tree.map(jnp.zeros_like, params),
            "step": jnp.zeros((), jnp.int32)}


def adamw_update(params, grads, opt_state, lr=1e-4, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.01):
    step = opt_state["step"] + 1
    mu = jax.tree.map(lambda m, g: b1 * m + (1 - b1) * g, opt_state["mu"], grads)
    nu = jax.tree.map(lambda v, g: b2 * v + (1 - b2) * g * g, opt_state["nu"], grads)
    t = step.astype(jnp.float32)
    mu_hat_scale = 1.0 / (1 - b1 ** t)
    nu_hat_scale = 1.0 / (1 - b2 ** t)
    new_params = jax.tree.map(
        lambda p, m, v: p - lr * (
            m * mu_hat_scale / (jnp.sqrt(v * nu_hat_scale) + eps)
            + weight_decay * p
        ),
        params, mu, nu,
    )
    return new_params, {"mu": mu, "nu": nu, "step": step}


def train_step(params, opt_state, anchors, positives, cfg: EmbedderConfig,
               *, sharded: bool = False, negatives=None, lr: float = 1e-4):
    def loss_fn(p):
        return info_nce_loss(
            p, anchors, positives, cfg, sharded=sharded, negatives=negatives
        )

    loss, grads = jax.value_and_grad(loss_fn)(params)
    new_params, new_opt = adamw_update(params, grads, opt_state, lr=lr)
    return new_params, new_opt, loss


# ------------------------------------------------------------ persistence ----

def save_params(
    path: str, params: Dict[str, Any], cfg: EmbedderConfig,
    init_seed: int = 0,
) -> None:
    """Flat-key npz checkpoint (restorable without a device).

    A frozen bag head is NOT stored: it never trains, so it is bit-
    reproducible from (cfg, init_seed) at load — the bag table is
    vocab x embed_dim and would dominate the artifact size."""
    flat = {}
    for key_path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = "/".join(str(k) for k in key_path)
        if cfg.use_bag and cfg.freeze_bag and name == "['bag_emb']":
            continue
        flat[name] = np.asarray(leaf)
    flat["__cfg__"] = np.array(
        [cfg.vocab_buckets, cfg.d_model, cfg.n_layers, cfg.n_heads,
         cfg.d_ff, cfg.max_len, cfg.embed_dim, int(cfg.use_bag),
         int(cfg.freeze_bag), int(init_seed)],
        dtype=np.int64,
    )
    np.savez(path, **flat)


def load_params(path: str) -> "tuple[Dict[str, Any], EmbedderConfig]":
    with np.load(path) as data:
        vals = data["__cfg__"]
        cfg = EmbedderConfig(
            vocab_buckets=int(vals[0]), d_model=int(vals[1]),
            n_layers=int(vals[2]), n_heads=int(vals[3]), d_ff=int(vals[4]),
            max_len=int(vals[5]), embed_dim=int(vals[6]),
            # checkpoints predating the bag head have 7 fields -> no bag
            use_bag=bool(vals[7]) if vals.shape[0] > 7 else False,
            freeze_bag=bool(vals[8]) if vals.shape[0] > 8 else True,
        )
        init_seed = int(vals[9]) if vals.shape[0] > 9 else 0
        template = init_params(cfg, jax.random.PRNGKey(init_seed))
        leaves_with_path = jax.tree_util.tree_flatten_with_path(template)
        restored = []
        for key_path, template_leaf in leaves_with_path[0]:
            name = "/".join(str(k) for k in key_path)
            if name in data.files:
                restored.append(jnp.asarray(data[name]))
            else:
                # frozen bag head: regenerated from (cfg, init_seed)
                restored.append(jnp.asarray(template_leaf))
        params = jax.tree_util.tree_unflatten(leaves_with_path[1], restored)
    return params, cfg


# ---------------------------------------------------- provider interface ----

class NeuralEmbeddingProvider:
    """Serves the embed_texts contract from the in-process model."""

    _instance: Optional["NeuralEmbeddingProvider"] = None

    def __init__(self, cfg: Optional[EmbedderConfig] = None, seed: int = 0):
        from ..config import settings

        params_path = (settings.embedder_params_path or "").strip()
        if cfg is None and params_path:
            self.params, self.cfg = load_params(params_path)
            if int(self.cfg.embed_dim) != int(settings.embeddings_dim):
                # fail at STARTUP with the actual misconfig: otherwise
                # every embed() returns wrong-width vectors, the provider
                # facade raises per request, and retrieval silently
                # degrades to lexical-only with no pointer to the cause
                raise RuntimeError(
                    f"embedder checkpoint {params_path} produces "
                    f"{self.cfg.embed_dim}-d vectors but EMBEDDINGS_DIM="
                    f"{settings.embeddings_dim}; retrain or fix the env"
                )
            suffix = "-tuned"
        else:
            self.cfg = cfg or EmbedderConfig(
                embed_dim=int(settings.embeddings_dim)
            )
            self.params = init_params(self.cfg, jax.random.PRNGKey(seed))
            suffix = ""
        self.model_id = (
            f"cadence-neural-embedder-{self.cfg.d_model}d"
            f"{self.cfg.n_layers}L{suffix}"
        )
        self._encode = jax.jit(partial(encode, cfg=self.cfg))

    @classmethod
    def shared(cls) -> "NeuralEmbeddingProvider":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def embed(self, texts: Sequence[str]):
        from ..embed.provider import EmbeddingResult

        tokens = np.asarray(batch_tokenize(texts, self.cfg))
        # pad the batch to a power of two: encode is jitted per token
        # shape, and coalescing/adaptive backfill produce arbitrary
        # batch sizes — each new size would pay a fresh XLA compile
        # O(log B) variants instead.
        n = tokens.shape[0]
        padded_n = 1
        while padded_n < n:
            padded_n *= 2
        if padded_n != n:
            tokens = np.concatenate(
                [tokens, np.zeros((padded_n - n, tokens.shape[1]),
                                  tokens.dtype)]
            )
        vectors = np.asarray(self._encode(self.params, jnp.asarray(tokens)))
        return EmbeddingResult(
            vectors=[v.tolist() for v in vectors[:n]], model=self.model_id
        )
