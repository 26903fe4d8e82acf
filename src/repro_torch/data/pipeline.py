"""Deterministic synthetic LM data pipeline.

The port of ``repro.data.pipeline``, numpy only: the batches are the
reference's arrays, element for element. Production shape: documents ->
(MinHash dedup, see dedup.py) -> token stream -> packed fixed-length
sequences -> batches. The synthetic corpus is a mixture of Markov chains
(the next token a function of the current one and a random branch), so a
small model learns it (loss drops well below unigram entropy) in a few
hundred steps; ``launch/train.py`` trains on it.

Determinism contract: batch content is a pure function of (seed, step),
independent of host count — restart/elastic-resume safe.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    seed: int = 0
    num_modes: int = 8          # distinct Markov chains (≈ document styles)
    branch: int = 4             # out-degree of each state

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # per-mode sparse transition tables: next token = table[mode, cur, br]
        self._table = rng.integers(0, v, size=(self.num_modes, v, self.branch),
                                   dtype=np.int64)

    def batch(self, step: int, global_batch: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b, s = global_batch, self.seq_len
        mode = rng.integers(0, self.num_modes, size=(b, 1))
        seq = np.empty((b, s + 1), dtype=np.int64)
        seq[:, 0] = rng.integers(0, self.vocab_size, size=b)
        choices = rng.integers(0, self.branch, size=(b, s))
        rows = np.arange(b)
        for t in range(s):
            seq[:, t + 1] = self._table[mode[:, 0], seq[:, t], choices[:, t]]
        return {"inputs": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}

    def batches(self, global_batch: int, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, global_batch)
            step += 1


class TokenBatcher:
    """Packs a ragged token-document stream into fixed [B, S] batches."""

    def __init__(self, docs, seq_len: int, pad_id: int = 0):
        self.seq_len = seq_len
        self.pad_id = pad_id
        stream = np.concatenate([np.asarray(d, np.int32) for d in docs]) \
            if docs else np.zeros((0,), np.int32)
        self.stream = stream

    def num_batches(self, batch: int) -> int:
        per = batch * self.seq_len
        return int(len(self.stream) // per)

    def batch(self, i: int, batch: int) -> Dict[str, np.ndarray]:
        per = batch * self.seq_len
        chunk = self.stream[i * per:(i + 1) * per]
        if len(chunk) < per:
            chunk = np.pad(chunk, (0, per - len(chunk)), constant_values=self.pad_id)
        x = chunk.reshape(batch, self.seq_len)
        y = np.roll(x, -1, axis=1)
        return {"inputs": x, "labels": y}
