"""Deterministic, shardable training-data pipeline.

Documents -> token stream (BOS/EOS framed) -> packed fixed-length examples
-> epoch-shuffled global batches -> per-host shard.  Everything is a pure
function of (corpus, seed, step), so any data-parallel worker can
reconstruct its shard without coordination — the property the paper's
multi-VM Ray setup gets from a shared filesystem.

A copy of ``repro/data/pipeline.py`` (pure numpy; the port cannot import
the reference, whose package loads jax), equal to it output for output.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.data.tokenizer import EOS, Tokenizer


@dataclass
class PackedDataset:
    """Token matrix [n_examples, seq_len + 1]; +1 gives the shifted labels."""
    examples: np.ndarray
    seq_len: int

    def __len__(self) -> int:
        return len(self.examples)


def pack_documents(token_docs: List[List[int]], seq_len: int
                   ) -> PackedDataset:
    """Concatenate framed documents and slice into seq_len+1 windows."""
    stream: List[int] = []
    for doc in token_docs:
        stream.extend(doc)
    n = len(stream) // (seq_len + 1)
    if n == 0:
        raise ValueError(
            f"corpus too small: {len(stream)} tokens < seq_len+1={seq_len + 1}")
    arr = np.asarray(stream[: n * (seq_len + 1)],
                     dtype=np.int32).reshape(n, seq_len + 1)
    return PackedDataset(arr, seq_len)


def build_dataset(texts, tokenizer: Tokenizer, seq_len: int) -> PackedDataset:
    docs = [tokenizer.encode(t) for t in texts]
    return PackedDataset(
        pack_documents(docs, seq_len).examples, seq_len)


class Loader:
    """Deterministic epoch-shuffled batches, shardable by (shard, n_shards)."""

    def __init__(self, ds: PackedDataset, global_batch: int, *, seed: int = 0,
                 shard: int = 0, n_shards: int = 1, drop_remainder: bool = True):
        if global_batch % n_shards:
            raise ValueError("global_batch must divide by n_shards")
        self.ds = ds
        self.global_batch = global_batch
        self.seed = seed
        self.shard = shard
        self.n_shards = n_shards
        self.per_shard = global_batch // n_shards
        self.batches_per_epoch = len(ds) // global_batch
        if self.batches_per_epoch == 0:
            raise ValueError(
                f"dataset has {len(ds)} examples < global_batch={global_batch}")

    def epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(len(self.ds))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Global-step indexed batch (this shard's slice).  ``labels`` are
        already the next token; ``lm_loss`` shifts once more, as the
        reference's does, so position i is scored against ``window[i+2]``
        (ROADMAP queue 3)."""
        epoch = step // self.batches_per_epoch
        k = step % self.batches_per_epoch
        order = self.epoch_order(epoch)
        sel = order[k * self.global_batch: (k + 1) * self.global_batch]
        sel = sel[self.shard * self.per_shard:
                  (self.shard + 1) * self.per_shard]
        window = self.ds.examples[sel]
        return {"tokens": window[:, :-1],
                "labels": np.where(window[:, 1:] == 0, -1,
                                   window[:, 1:]).astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
