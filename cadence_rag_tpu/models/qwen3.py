"""Qwen3-Embedding-4B-shaped encoder, in-process on the accelerator.

The reference's dense-lane quality engine is Qwen3-Embedding-4B served by
Triton on a GPU box (reference: P620_TRITON_QWEN3_4B_EMBEDDING_RUNBOOK.md:
32-35 — architecture; :489-497 — the /embed wire contract; :703-715 —
last-token pooling, hidden 2560 -> truncate 1024, L2 normalize). This
module demonstrates the framework can HOST that workload in-process: a
faithful Qwen3-4B-shaped decoder (GQA 32q/8kv heads, head_dim 128, QK
RMSNorm, SwiGLU d_ff 9728, RoPE, 36 layers, hidden 2560) whose forward
pass runs tp-sharded over a ``jax.sharding.Mesh`` next to the retrieval
index.

No Qwen weights ship in this image, so weights are synthetic by default
(the compute/memory/throughput profile is what the scale demonstration
needs); a real checkpoint can be loaded from an npz of the same layout.
Tokenization is the framework's offline FNV-1a hash tokenizer — swapping
in the real BPE vocab changes text->ids only, not the device program.

Design choices:
- per-layer weights are STACKED (L, ...) arrays walked by ``lax.scan``:
  compile time stays O(1) in depth (36 unrolled layers would compile for
  minutes);
- bf16 weights/activations, f32 accumulation on every matmul, f32
  softmax/rmsnorm statistics;
- Megatron tp: q/k/v/gate/up column-parallel, o/down row-parallel over
  the mesh's "model" axis; batch over "data"; activations re-constrained
  between layers;
- static (batch, seq) shapes, pow2-bucketed by the provider.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..logging_utils import get_logger
from ..ops.hashing import fnv1a64

logger = get_logger(__name__)

# --------------------------------------------------------------- config ----


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    vocab_buckets: int = 151_936
    d_model: int = 2560
    n_layers: int = 36
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    d_ff: int = 9728
    max_len: int = 1024
    embed_dim: int = 1024          # truncation target (2560 -> 1024)
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    dtype: Any = jnp.bfloat16

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        per_layer = (
            self.d_model * self.q_dim          # wq
            + 2 * self.d_model * self.kv_dim   # wk, wv
            + self.q_dim * self.d_model        # wo
            + 3 * self.d_model * self.d_ff     # gate, up, down
            + 2 * self.d_model                 # ln1, ln2
            + 2 * self.head_dim                # q_norm, k_norm
        )
        return (
            self.vocab_buckets * self.d_model
            + self.n_layers * per_layer
            + self.d_model                     # final_norm
        )


# Qwen3-4B geometry: config.json of Qwen/Qwen3-Embedding-4B (hidden 2560,
# 36 layers, 32 attention heads, 8 KV heads, head_dim 128, intermediate
# 9728, rope_theta 1e6). "tiny" is the CPU-test / dryrun shape.
PRESETS: Dict[str, Qwen3Config] = {
    "4b": Qwen3Config(),
    "1b": Qwen3Config(
        vocab_buckets=151_936, d_model=1536, n_layers=24, n_heads=16,
        n_kv_heads=8, head_dim=96, d_ff=4608,
    ),
    "tiny": Qwen3Config(
        vocab_buckets=512, d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, max_len=32, embed_dim=32,
    ),
}


def preset(name: str) -> Qwen3Config:
    try:
        return PRESETS[name.strip().lower()]
    except KeyError:
        raise ValueError(
            f"unknown qwen3 preset {name!r}; have {sorted(PRESETS)}"
        ) from None


# --------------------------------------------------------------- params ----

def _param_specs(cfg: Qwen3Config) -> List[tuple]:
    """(name, shape, kind) — kind 'w' = scaled normal bf16, 'ones' = f32."""
    L = cfg.n_layers
    return [
        ("tok_emb", (cfg.vocab_buckets, cfg.d_model), "w"),
        ("ln1", (L, cfg.d_model), "ones"),
        ("wq", (L, cfg.d_model, cfg.q_dim), "w"),
        ("wk", (L, cfg.d_model, cfg.kv_dim), "w"),
        ("wv", (L, cfg.d_model, cfg.kv_dim), "w"),
        ("q_norm", (L, cfg.head_dim), "ones"),
        ("k_norm", (L, cfg.head_dim), "ones"),
        ("wo", (L, cfg.q_dim, cfg.d_model), "w"),
        ("ln2", (L, cfg.d_model), "ones"),
        ("w_gate", (L, cfg.d_model, cfg.d_ff), "w"),
        ("w_up", (L, cfg.d_model, cfg.d_ff), "w"),
        ("w_down", (L, cfg.d_ff, cfg.d_model), "w"),
        ("final_norm", (cfg.d_model,), "ones"),
    ]


def param_shardings(cfg: Qwen3Config, mesh: Mesh) -> Dict[str, Any]:
    """Megatron layout over the stacked (L, ...) arrays: column-parallel
    projections shard their output dim, row-parallel their input dim."""
    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    return {
        "tok_emb": ns("model", None),
        "ln1": ns(), "ln2": ns(),
        "q_norm": ns(), "k_norm": ns(),
        "wq": ns(None, None, "model"),
        "wk": ns(None, None, "model"),
        "wv": ns(None, None, "model"),
        "wo": ns(None, "model", None),
        "w_gate": ns(None, None, "model"),
        "w_up": ns(None, None, "model"),
        "w_down": ns(None, "model", None),
        "final_norm": ns(),
    }


def init_params(
    cfg: Qwen3Config,
    key: jax.Array,
    shardings: Optional[Dict[str, Any]] = None,
) -> Dict[str, jax.Array]:
    """Synthetic weights, generated ON DEVICE (8 GB at the 4b preset —
    never materialized on the host or copied host->device). With
    ``shardings`` the arrays are born sharded (out_shardings on the
    per-tensor generator), so no single device ever holds the full model."""
    params: Dict[str, jax.Array] = {}
    specs = _param_specs(cfg)
    keys = jax.random.split(key, len(specs))
    for (name, shape, kind), k in zip(specs, keys):
        out_s = shardings.get(name) if shardings else None

        if kind == "ones":
            fn = jax.jit(
                lambda shape=shape: jnp.ones(shape, jnp.float32),
                out_shardings=out_s,
            )
            params[name] = fn()
        else:
            # fan-in scaling keeps forward activations O(1) through 36
            # layers (plain 0.02-std at d_ff 9728 overflows bf16 by layer
            # ~20 on synthetic weights)
            fan_in = shape[-2] if len(shape) > 1 else shape[-1]
            scale = float(1.0 / np.sqrt(fan_in))
            fn = jax.jit(
                lambda kk, shape=shape, scale=scale: (
                    jax.random.normal(kk, shape, dtype=jnp.bfloat16) * scale
                ),
                out_shardings=out_s,
            )
            params[name] = fn(k)
    return params


def load_params(path: str) -> "tuple[Dict[str, jax.Array], Qwen3Config]":
    """Restore a real checkpoint: an npz with the _param_specs layout plus
    an __cfg__ row (same scheme as models/embedder.py).

    Real-weight convention: the framework reserves token id 0 as the pad
    sentinel (encode()'s pad_mask), so a converted checkpoint must store
    real token id i's embedding at ``tok_emb`` row i+1 and leave row 0
    zeros — models/tokenizer.BpeTokenizer emits ids with the matching +1
    shift. A conversion script does ``tok_emb_npz[1:real_vocab+1] =
    hf_embed_tokens`` (vocab_buckets 151_936 leaves headroom over Qwen's
    151_669 used ids)."""
    import ml_dtypes

    with np.load(path, allow_pickle=False) as data:
        v = data["__cfg__"]
        cfg = Qwen3Config(
            vocab_buckets=int(v[0]), d_model=int(v[1]), n_layers=int(v[2]),
            n_heads=int(v[3]), n_kv_heads=int(v[4]), head_dim=int(v[5]),
            d_ff=int(v[6]), max_len=int(v[7]), embed_dim=int(v[8]),
        )
        bf16 = set(str(n) for n in data.get("__bf16__", np.array([])))
        params = {}
        for name, _, _ in _param_specs(cfg):
            arr = data[name]
            if name in bf16:
                arr = arr.view(ml_dtypes.bfloat16)
            params[name] = jnp.asarray(arr)
    return params, cfg


def save_params(path: str, params: Dict[str, jax.Array], cfg: Qwen3Config) -> None:
    # npz has no bf16 dtype: bf16 tensors ship as uint16 bit-views with a
    # name manifest (same bytes on disk, restored via view at load)
    flat = {}
    bf16_names = []
    for name, arr in params.items():
        host = np.asarray(arr)
        if host.dtype == jnp.bfloat16:
            bf16_names.append(name)
            host = host.view(np.uint16)
        flat[name] = host
    flat["__bf16__"] = np.array(bf16_names)
    flat["__cfg__"] = np.array(
        [cfg.vocab_buckets, cfg.d_model, cfg.n_layers, cfg.n_heads,
         cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.max_len, cfg.embed_dim],
        dtype=np.int64,
    )
    np.savez(path, **flat)


# ------------------------------------------------------------ tokenizer ----

def batch_tokenize(
    texts: Sequence[str], cfg: Qwen3Config, seq_len: Optional[int] = None,
    bpe=None,
) -> np.ndarray:
    """Text -> (B, seq) int32 ids, 0 = pad.

    With ``bpe`` (a models/tokenizer.BpeTokenizer, loaded from
    QWEN3_TOKENIZER_PATH): real byte-level BPE ids shifted +1 so id 0
    stays the pad sentinel — a real checkpoint's embedding table must
    hold real token id i at row i+1 (see load_params).

    Without: word-level FNV-1a hashing into vocab buckets (1-based) —
    the synthetic-weights stand-in; the device program is identical."""
    seq = seq_len or cfg.max_len
    out = np.zeros((len(texts), seq), dtype=np.int32)
    if bpe is not None:
        for i, text in enumerate(texts):
            ids = bpe.encode(text, max_len=seq, add_eos=True)
            out[i, : len(ids)] = ids
        return out
    for i, text in enumerate(texts):
        for j, word in enumerate(text.lower().split()):
            if j >= seq:
                break
            h = fnv1a64(b"qtok:" + word.encode("utf-8"))
            out[i, j] = int(h % (cfg.vocab_buckets - 1)) + 1
    return out


# -------------------------------------------------------------- forward ----

def _rms_norm(x: jax.Array, scale: jax.Array, eps: float) -> jax.Array:
    var = jnp.mean(jnp.square(x.astype(jnp.float32)), axis=-1, keepdims=True)
    normed = x.astype(jnp.float32) * jax.lax.rsqrt(var + eps)
    return (normed * scale).astype(x.dtype)


def _rope_tables(seq: int, head_dim: int, theta: float):
    """Neox-style half-split rotary tables, f32, (S, head_dim/2)."""
    inv = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)
    )
    pos = np.arange(seq, dtype=np.float32)
    ang = np.outer(pos, inv)
    return jnp.asarray(np.sin(ang)), jnp.asarray(np.cos(ang))


def _apply_rope(x: jax.Array, sin: jax.Array, cos: jax.Array) -> jax.Array:
    # x: (B, H, S, hd); sin/cos: (S, hd/2) -> broadcast (1, 1, S, hd/2)
    x1, x2 = jnp.split(x.astype(jnp.float32), 2, axis=-1)
    s, c = sin[None, None], cos[None, None]
    return jnp.concatenate([x1 * c - x2 * s, x2 * c + x1 * s], axis=-1)


def encode(
    params: Dict[str, jax.Array],
    token_ids: jax.Array,
    cfg: Qwen3Config,
    *,
    sharded: bool = False,
) -> jax.Array:
    """(B, S) int32 -> (B, embed_dim) unit vectors.

    Contract parity with the reference gateway (P620 runbook:703-715):
    causal forward, LAST-token pooling (final non-pad position), hidden
    truncated to ``embed_dim``, L2 normalized — cosine ≡ dot downstream."""
    B, S = token_ids.shape
    pad_mask = token_ids != 0
    x = jnp.take(params["tok_emb"], token_ids, axis=0)      # (B, S, D) bf16
    sin, cos = _rope_tables(S, cfg.head_dim, cfg.rope_theta)
    causal = jnp.tril(jnp.ones((S, S), dtype=bool))
    attn_mask = causal[None, None] & pad_mask[:, None, None, :]
    groups = cfg.n_heads // cfg.n_kv_heads
    dt = cfg.dtype

    def block(x, layer):
        h = _rms_norm(x, layer["ln1"], cfg.rms_eps)
        q = jnp.dot(h, layer["wq"].astype(dt),
                    preferred_element_type=jnp.float32)
        k = jnp.dot(h, layer["wk"].astype(dt),
                    preferred_element_type=jnp.float32)
        v = jnp.dot(h, layer["wv"].astype(dt),
                    preferred_element_type=jnp.float32)
        q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim).astype(dt)
        # Qwen3 QK-norm: per-head RMSNorm on q and k before RoPE
        q = _rms_norm(q, layer["q_norm"], cfg.rms_eps)
        k = _rms_norm(k, layer["k_norm"], cfg.rms_eps)
        q = _apply_rope(q.transpose(0, 2, 1, 3), sin, cos).astype(dt)
        k = _apply_rope(k.transpose(0, 2, 1, 3), sin, cos).astype(dt)
        v = v.transpose(0, 2, 1, 3)                     # (B, Hk, S, hd)
        # GQA: score kv heads against head groups without materializing
        # repeated k/v — reshape q to (B, Hk, G, S, hd)
        qg = q.reshape(B, cfg.n_kv_heads, groups, S, cfg.head_dim)
        logits = jnp.einsum(
            "bkgqd,bkpd->bkgqp", qg, k,
            preferred_element_type=jnp.float32,
        ) / np.sqrt(float(cfg.head_dim))
        logits = jnp.where(attn_mask[:, :, None], logits, -1e9)
        weights = jax.nn.softmax(logits, axis=-1).astype(dt)
        ctx = jnp.einsum(
            "bkgqp,bkpd->bkgqd", weights, v,
            preferred_element_type=jnp.float32,
        ).astype(dt)
        ctx = ctx.reshape(B, cfg.n_heads, S, cfg.head_dim)
        ctx = ctx.transpose(0, 2, 1, 3).reshape(B, S, cfg.q_dim)
        x = x + jnp.dot(ctx, layer["wo"].astype(dt),
                        preferred_element_type=jnp.float32).astype(dt)

        h = _rms_norm(x, layer["ln2"], cfg.rms_eps)
        gate = jnp.dot(h, layer["w_gate"].astype(dt),
                       preferred_element_type=jnp.float32)
        up = jnp.dot(h, layer["w_up"].astype(dt),
                     preferred_element_type=jnp.float32)
        ff = (jax.nn.silu(gate) * up).astype(dt)
        x = x + jnp.dot(ff, layer["w_down"].astype(dt),
                        preferred_element_type=jnp.float32).astype(dt)
        if sharded:
            x = jax.lax.with_sharding_constraint(x, P("data", None, None))
        return x, None

    stacked = {
        name: params[name]
        for name in ("ln1", "wq", "wk", "wv", "q_norm", "k_norm", "wo",
                     "ln2", "w_gate", "w_up", "w_down")
    }
    x, _ = jax.lax.scan(lambda c, l: block(c, l), x, stacked)
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    last = jnp.maximum(pad_mask.sum(axis=1) - 1, 0)
    pooled = x[jnp.arange(B), last].astype(jnp.float32)
    out = pooled[:, : cfg.embed_dim]                    # 2560 -> 1024
    norm = jnp.linalg.norm(out, axis=-1, keepdims=True)
    return out / jnp.maximum(norm, 1e-6)


# ---------------------------------------------------- provider interface ----

def _pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


class Qwen3EmbeddingProvider:
    """Serves the embed_texts contract from the in-process Qwen3-shaped
    encoder (EMBEDDINGS_PROVIDER=qwen3). Sequence lengths bucket to powers
    of two up to cfg.max_len so the jit variant count stays O(log) in both
    batch and length."""

    _instance: Optional["Qwen3EmbeddingProvider"] = None

    def __init__(self, cfg: Optional[Qwen3Config] = None, seed: int = 0):
        from ..config import settings

        path = (settings.qwen3_params_path or "").strip()
        if cfg is None and path:
            self.params, self.cfg = load_params(path)
            suffix = "-ckpt"
        else:
            self.cfg = cfg or preset(settings.qwen3_preset)
            self.params = init_params(self.cfg, jax.random.PRNGKey(seed))
            suffix = "-synthetic"
        if int(self.cfg.embed_dim) != int(settings.embeddings_dim):
            raise RuntimeError(
                f"qwen3 config produces {self.cfg.embed_dim}-d vectors but "
                f"EMBEDDINGS_DIM={settings.embeddings_dim}"
            )
        self.bpe = None
        tok_path = (settings.qwen3_tokenizer_path or "").strip()
        if tok_path:
            from .tokenizer import BpeTokenizer

            self.bpe = BpeTokenizer.load(tok_path)
            if self.bpe.vocab_size > self.cfg.vocab_buckets:
                raise RuntimeError(
                    f"tokenizer vocab ({self.bpe.vocab_size} incl. the "
                    f"+1 pad shift) exceeds the model's vocab_buckets "
                    f"({self.cfg.vocab_buckets})"
                )
            suffix += "-bpe"
        elif path:
            logger.warning(
                "qwen3: real checkpoint loaded but QWEN3_TOKENIZER_PATH "
                "is unset — hash-token ids will NOT match the trained "
                "embedding table; set the tokenizer for real quality"
            )
        self.model_id = (
            f"qwen3-shaped-{self.cfg.d_model}d{self.cfg.n_layers}L{suffix}"
        )
        self._encode = jax.jit(partial(encode, cfg=self.cfg))

    @classmethod
    def shared(cls) -> "Qwen3EmbeddingProvider":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def embed(self, texts: Sequence[str]):
        from ..embed.provider import EmbeddingResult

        n = len(texts)
        if self.bpe is not None:
            id_lists = [
                self.bpe.encode(t, max_len=self.cfg.max_len)
                for t in texts
            ]
            longest = max((len(x) for x in id_lists), default=1)
            seq = min(_pow2(max(longest, 1), lo=16), self.cfg.max_len)
            tokens = np.zeros((n, seq), dtype=np.int32)
            for i, ids in enumerate(id_lists):
                tokens[i, : len(ids)] = ids
        else:
            longest = max((len(t.split()) for t in texts), default=1)
            seq = min(_pow2(max(longest, 1), lo=16), self.cfg.max_len)
            tokens = batch_tokenize(texts, self.cfg, seq_len=seq)
        padded_n = _pow2(n)
        if padded_n != n:
            tokens = np.concatenate(
                [tokens, np.zeros((padded_n - n, seq), tokens.dtype)]
            )
        vectors = np.asarray(self._encode(self.params, jnp.asarray(tokens)))
        return EmbeddingResult(
            vectors=vectors[:n], model=self.model_id
        )
