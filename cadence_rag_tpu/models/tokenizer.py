"""Byte-level BPE tokenizer loader (stdlib-only) for real Qwen3 vocabs.

models/qwen3.py hash-tokenizes, so a real
Qwen3-Embedding checkpoint (the documented npz path) was not actually a
drop-in — nothing could load the real BPE vocab. This module loads the
HuggingFace ``tokenizer.json`` (or a ``vocab.json`` + ``merges.txt``
pair) and implements GPT-2-style byte-level BPE encoding, the scheme
Qwen2/Qwen3 tokenizers use (reference contract:
P620_TRITON_QWEN3_4B_EMBEDDING_RUNBOOK.md:514-716 — the gateway
tokenizes with AutoTokenizer before the ONNX forward).

Design notes:
- Pure stdlib: ``json`` + ``re``. Python ``re`` has no ``\\p{L}``/
  ``\\p{N}`` classes, so the Qwen pre-tokenizer regex is translated with
  the unicode-aware approximations ``[^\\W\\d_]`` (letters) and ``\\d``
  (numbers). Exotic unicode numerals may split differently from the HF
  tokenizer; ids for ASCII/latin/CJK text match.
- Framework pad convention: the encoder treats token id 0 as padding
  (models/qwen3.encode pad_mask), but byte-level BPE assigns id 0 to a
  real token ("!"). ``encode`` therefore returns ids SHIFTED by +1;
  a real-weight conversion must place real token id i at embedding row
  i+1 and leave row 0 zeros (see models/qwen3.load_params docstring).
"""

from __future__ import annotations

import json
import re
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

# Qwen2/GPT-4 style pre-tokenizer, translated to stdlib `re`:
#   \p{L} -> [^\W\d_]   \p{N} -> \d
_PRETOKEN_RE = re.compile(
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)"            # english contractions
    r"|(?:[^\w\r\n]|_)?[^\W\d_]+"              # optional non-letter + letters
    r"|\d{1,3}"                                # numbers in <=3-digit groups
    r"| ?(?:[^\s\w]|_)+[\r\n]*"                # punctuation runs
    r"|\s*[\r\n]+"                             # newlines w/ leading space
    r"|\s+(?!\S)"                              # trailing whitespace
    r"|\s+",
    re.UNICODE,
)


@lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte<->unicode table: printable bytes map to themselves,
    the rest to U+0100.. so every byte has a visible stand-in character
    and vocab keys stay valid JSON strings."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class BpeTokenizer:
    """Byte-level BPE: text -> pre-token pieces -> byte-unicode chars ->
    greedy lowest-rank merges -> vocab ids (+1 shift, see module doc)."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        *,
        eos_token: Optional[str] = "<|endoftext|>",
        shift: int = 1,
    ):
        self.vocab = vocab
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.shift = int(shift)
        self.byte_enc = _bytes_to_unicode()
        self.eos_id: Optional[int] = (
            vocab[eos_token] + self.shift
            if eos_token is not None and eos_token in vocab else None
        )
        self._cache: Dict[str, List[int]] = {}
        self._id_to_token = {v: k for k, v in vocab.items()}
        self._byte_dec = {v: k for k, v in self.byte_enc.items()}

    # -- loading -------------------------------------------------------
    @classmethod
    def from_tokenizer_json(cls, path: str, **kw) -> "BpeTokenizer":
        """HuggingFace ``tokenizer.json``: model.vocab + model.merges
        (merges are "a b" strings or [a, b] pairs in newer files);
        added_tokens extend the vocab."""
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        model = data.get("model") or {}
        if model.get("type") not in (None, "BPE"):
            raise ValueError(
                f"{path}: model.type={model.get('type')!r}, expected BPE"
            )
        vocab = dict(model.get("vocab") or {})
        merges: List[Tuple[str, str]] = []
        for m in model.get("merges") or []:
            if isinstance(m, str):
                a, _, b = m.partition(" ")
                merges.append((a, b))
            else:
                merges.append((m[0], m[1]))
        for tok in data.get("added_tokens") or []:
            vocab.setdefault(tok["content"], int(tok["id"]))
        return cls(vocab, merges, **kw)

    @classmethod
    def from_vocab_merges(
        cls, vocab_path: str, merges_path: str, **kw
    ) -> "BpeTokenizer":
        with open(vocab_path, encoding="utf-8") as fh:
            vocab = json.load(fh)
        merges: List[Tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    @classmethod
    def load(cls, path: str, **kw) -> "BpeTokenizer":
        """``path`` = tokenizer.json, or a directory holding either
        tokenizer.json or vocab.json+merges.txt."""
        p = Path(path)
        if p.is_dir():
            if (p / "tokenizer.json").exists():
                return cls.from_tokenizer_json(str(p / "tokenizer.json"), **kw)
            if (p / "vocab.json").exists() and (p / "merges.txt").exists():
                return cls.from_vocab_merges(
                    str(p / "vocab.json"), str(p / "merges.txt"), **kw
                )
            raise FileNotFoundError(
                f"{path}: no tokenizer.json or vocab.json+merges.txt"
            )
        return cls.from_tokenizer_json(str(p), **kw)

    # -- encoding ------------------------------------------------------
    def _bpe(self, piece: str) -> List[str]:
        """Greedy lowest-rank pair merging over byte-unicode chars."""
        word = list(piece)
        if len(word) < 2:
            return word
        while True:
            best = None
            best_rank = None
            for pair in zip(word, word[1:]):
                rank = self.ranks.get(pair)
                if rank is not None and (best_rank is None or rank < best_rank):
                    best, best_rank = pair, rank
            if best is None:
                return word
            a, b = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
            if len(word) < 2:
                return word

    def _encode_piece(self, piece: str) -> List[int]:
        cached = self._cache.get(piece)
        if cached is not None:
            return cached
        chars = "".join(
            self.byte_enc[b] for b in piece.encode("utf-8")
        )
        ids = []
        for tok in self._bpe(chars):
            tid = self.vocab.get(tok)
            if tid is None:
                # unmergeable unknown: fall back to per-char tokens
                ids.extend(
                    self.vocab[c] + self.shift for c in tok
                    if c in self.vocab
                )
            else:
                ids.append(tid + self.shift)
        if len(self._cache) < 65536:
            self._cache[piece] = ids
        return ids

    def encode(
        self, text: str, *, max_len: Optional[int] = None,
        add_eos: bool = True,
    ) -> List[int]:
        ids: List[int] = []
        for piece in _PRETOKEN_RE.findall(text):
            ids.extend(self._encode_piece(piece))
            if max_len is not None and len(ids) >= max_len:
                break
        if add_eos and self.eos_id is not None:
            # last-token pooling reads the EOS position (runbook :703) —
            # truncate to keep it in-window
            limit = (max_len - 1) if max_len is not None else len(ids)
            ids = ids[:limit] + [self.eos_id]
        elif max_len is not None:
            ids = ids[:max_len]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        chars = "".join(
            self._id_to_token.get(int(i) - self.shift, "")
            for i in ids
        )
        return bytes(
            self._byte_dec[c] for c in chars if c in self._byte_dec
        ).decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return max(self.vocab.values()) + 1 + self.shift
