"""Corpus sources.

``synthetic_wikipedia`` generates a deterministic wikipedia-like corpus
(Zipfian vocabulary, sentence/paragraph structure) so end-to-end pretraining
runs are fully reproducible offline — standing in for the paper's
HuggingFace ``wikimedia/wikipedia 20231101.ace`` dump.  ``load_text_dir``
reads real text files when the user supplies a dataset.

A copy of ``repro/data/corpus.py`` (pure numpy; the port cannot import
the reference, whose package loads jax), equal to it output for output.
"""
from __future__ import annotations

import os
from typing import Iterator, List

import numpy as np

_CONSONANTS = "bcdfghjklmnprstvwz"
_VOWELS = "aeiou"


def _word(rng: np.random.Generator) -> str:
    n = int(rng.integers(1, 4))
    return "".join(
        _CONSONANTS[rng.integers(len(_CONSONANTS))]
        + _VOWELS[rng.integers(len(_VOWELS))]
        for _ in range(n))


def make_vocabulary(rng: np.random.Generator, size: int = 4000) -> List[str]:
    seen, out = set(), []
    while len(out) < size:
        w = _word(rng)
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


def synthetic_wikipedia(n_docs: int, *, seed: int = 0,
                        mean_doc_words: int = 180) -> Iterator[str]:
    """Deterministic Zipf-distributed documents with article structure."""
    rng = np.random.default_rng(seed)
    vocab = make_vocabulary(rng)
    ranks = np.arange(1, len(vocab) + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    for _ in range(n_docs):
        n_words = max(20, int(rng.poisson(mean_doc_words)))
        words = rng.choice(len(vocab), size=n_words, p=probs)
        title = " ".join(vocab[w].capitalize() for w in words[:3])
        body_words = [vocab[w] for w in words]
        sents, i = [], 0
        while i < len(body_words):
            n = int(rng.integers(5, 15))
            sent = " ".join(body_words[i:i + n])
            sents.append(sent.capitalize() + ".")
            i += n
        yield f"= {title} =\n" + " ".join(sents)


def load_text_dir(path: str) -> Iterator[str]:
    for name in sorted(os.listdir(path)):
        if name.endswith(".txt"):
            with open(os.path.join(path, name), errors="replace") as f:
                yield f.read()
