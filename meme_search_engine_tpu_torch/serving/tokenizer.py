"""Text tokenisation for the SigLIP text tower.

Copy of ``meme_search_engine_tpu/serving/tokenizer.py`` (the port imports
nothing of the JAX package); ``tokenizers`` is imported where it is used.

The reference tokenises with the big_vision ``c4_en`` SentencePiece model
(32k vocab) using ``max_len=64, eos="sticky", pad_value=1``
(misc/clip_accursed.py:51-55): lowercased text is encoded, truncated to
63 pieces, an EOS (id 1) is appended "stickily" (always the final
position) and the sequence is right-padded with pad_value 1 up to 64.

Deployments provide the real vocab via a HuggingFace ``tokenizer.json``
(google/siglip-so400m-patch14-384 ships one) — loaded through the
``tokenizers`` library. For weightless environments (unit tests, perf
benches, CI) a deterministic hash tokenizer provides the same interface;
it produces stable ids but not c4_en-compatible ones.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

__all__ = ["SigLIPTokenizer", "HashTokenizer", "load_tokenizer"]

_EOS_ID = 1
_PAD_ID = 1


class SigLIPTokenizer:
    """HF tokenizers-backed SentencePiece tokenizer with sticky EOS."""

    def __init__(self, tokenizer, seq_len: int = 64):
        self._tok = tokenizer
        self.seq_len = seq_len

    @classmethod
    def from_file(cls, path: str, seq_len: int = 64) -> "SigLIPTokenizer":
        from tokenizers import Tokenizer

        if os.path.isdir(path):
            path = os.path.join(path, "tokenizer.json")
        return cls(Tokenizer.from_file(path), seq_len)

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.seq_len), _PAD_ID, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = self._tok.encode(text.lower(), add_special_tokens=False).ids
            ids = ids[: self.seq_len - 1]
            out[i, : len(ids)] = ids
            # sticky EOS: always the last position (clip_accursed.py:55)
            out[i, self.seq_len - 1] = _EOS_ID
        return out


class HashTokenizer:
    """Deterministic vocabulary-hashed tokenizer (test/bench fallback).

    Splits on whitespace and maps each word to a stable id in
    [2, vocab). Interface-compatible with :class:`SigLIPTokenizer`.
    """

    def __init__(self, vocab_size: int = 32_000, seq_len: int = 64):
        self.vocab_size = vocab_size
        self.seq_len = seq_len

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        import zlib

        out = np.full((len(texts), self.seq_len), _PAD_ID, dtype=np.int32)
        for i, text in enumerate(texts):
            words = text.lower().split()[: self.seq_len - 1]
            for j, w in enumerate(words):
                out[i, j] = 2 + zlib.crc32(w.encode()) % (self.vocab_size - 2)
            out[i, self.seq_len - 1] = _EOS_ID
        return out


def load_tokenizer(
    path: Optional[str], vocab_size: int = 32_000, seq_len: int = 64
):
    """Real tokenizer if a vocab file exists, hash fallback otherwise."""
    if path and (
        os.path.isfile(path)
        or os.path.isfile(os.path.join(path, "tokenizer.json"))
    ):
        return SigLIPTokenizer.from_file(path, seq_len)
    return HashTokenizer(vocab_size, seq_len)
