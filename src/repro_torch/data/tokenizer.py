"""Byte-fallback tokenizer with a trainable word vocabulary.

The paper pretrains on a Wikipedia dump (ace subset).  We implement a
self-contained tokenizer in the same spirit as GPT-2's byte-level BPE but
simplified to frequency-ranked whole words + byte fallback, so the data
pipeline has zero external dependencies and is exactly reproducible.

A copy of ``repro/data/tokenizer.py`` (pure numpy; the port cannot import
the reference, whose package loads jax), equal to it output for output.
"""
from __future__ import annotations

import json
import re
from collections import Counter
from typing import Dict, Iterable, List, Optional

_WORD_RE = re.compile(r" ?[A-Za-z]+| ?[0-9]+|[^A-Za-z0-9]")

N_SPECIAL = 4
PAD, BOS, EOS, UNK = 0, 1, 2, 3
SPECIAL_TOKENS = {"<pad>": PAD, "<bos>": BOS, "<eos>": EOS, "<unk>": UNK}
N_BYTES = 256


class Tokenizer:
    """ids = [specials][256 raw bytes][learned words...]."""

    def __init__(self, vocab: Optional[List[str]] = None):
        self.words: List[str] = vocab or []
        self.word_to_id: Dict[str, int] = {
            w: N_SPECIAL + N_BYTES + i for i, w in enumerate(self.words)}

    # ------------------------------------------------------------- #
    @property
    def vocab_size(self) -> int:
        return N_SPECIAL + N_BYTES + len(self.words)

    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int) -> "Tokenizer":
        budget = max(vocab_size - N_SPECIAL - N_BYTES, 0)
        counts: Counter = Counter()
        for t in texts:
            counts.update(_WORD_RE.findall(t))
        words = [w for w, c in counts.most_common(budget) if c > 1]
        return cls(words)

    # ------------------------------------------------------------- #
    def encode(self, text: str, *, bos: bool = True,
               eos: bool = True) -> List[int]:
        ids: List[int] = [BOS] if bos else []
        for piece in _WORD_RE.findall(text):
            wid = self.word_to_id.get(piece)
            if wid is not None:
                ids.append(wid)
            else:
                ids.extend(N_SPECIAL + b for b in piece.encode("utf-8"))
        if eos:
            ids.append(EOS)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        out: List[str] = []
        byte_run: List[int] = []

        def flush():
            if byte_run:
                out.append(bytes(byte_run).decode("utf-8", errors="replace"))
                byte_run.clear()

        for i in ids:
            if N_SPECIAL <= i < N_SPECIAL + N_BYTES:
                byte_run.append(i - N_SPECIAL)
            elif i >= N_SPECIAL + N_BYTES:
                flush()
                out.append(self.words[i - N_SPECIAL - N_BYTES])
            else:
                flush()
        flush()
        return "".join(out)

    # ------------------------------------------------------------- #
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"words": self.words}, f)

    @classmethod
    def load(cls, path: str) -> "Tokenizer":
        with open(path) as f:
            return cls(json.load(f)["words"])
