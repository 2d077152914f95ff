"""Host-side federated batch loader: deterministic shuffle-buffer iteration
over client-stacked arrays with per-round minibatch assembly.

Counterpart of ``repro/data/loader.py``: numpy on the host, the port's own
copy, with byte-identical output for the same seed. The simulator consumes
whole client datasets per round (the paper's E-epoch protocol); this loader
serves training loops whose client corpora are token streams larger than a
round's budget.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class FederatedBatches:
    """Iterates (client-stacked) minibatches from [C, n, ...] arrays."""
    data: dict                    # leaves [C, n, ...]
    batch_size: int
    seed: int = 0
    drop_last: bool = True

    def __post_init__(self):
        first = next(iter(self.data.values()))
        self.C, self.n = first.shape[:2]
        self._rng = np.random.default_rng(self.seed)
        self._order = None
        self._cursor = self.n        # trigger reshuffle on first batch

    def _reshuffle(self):
        # independent permutation per client
        self._order = np.stack([self._rng.permutation(self.n)
                                for _ in range(self.C)])
        self._cursor = 0

    def next_batch(self) -> dict:
        """One [C, batch_size, ...] batch; reshuffles at epoch boundaries."""
        if self._cursor + self.batch_size > self.n:
            self._reshuffle()
        idx = self._order[:, self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        out = {}
        for k, v in self.data.items():
            out[k] = np.stack([v[c, idx[c]] for c in range(self.C)])
        return out

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


def pack_token_documents(docs: list[np.ndarray], seq_len: int,
                         pad_id: int = 0) -> np.ndarray:
    """Greedy sequence packing: concatenate documents, split into
    (seq_len+1)-token rows (input+shifted-label layout)."""
    flat = np.concatenate(docs) if docs else np.zeros((0,), np.int32)
    n = len(flat) // (seq_len + 1)
    if n == 0:
        row = np.full((seq_len + 1,), pad_id, np.int32)
        row[:len(flat)] = flat
        return row[None]
    return flat[:n * (seq_len + 1)].reshape(n, seq_len + 1).astype(np.int32)
