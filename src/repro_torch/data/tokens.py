"""Federated token streams for the LM-scale architectures.

The port's own copy of ``repro/data/tokens.py`` (same seed, byte-identical
tokens; ``tests/test_torch_train.py`` pins it).

Synthetic language modelling data with *controllable client alignment*:
each client draws from a Zipf-like unigram-with-bigram-structure source;
priority clients share one source distribution, non-priority clients
interpolate between the priority source and an independent one with a
per-client misalignment level — giving FedALIGN something real to select
on at LM scale.
"""
from __future__ import annotations

import numpy as np


def _zipf_probs(vocab, s=1.1, rng=None, perm=True):
    p = 1.0 / np.arange(1, vocab + 1) ** s
    p /= p.sum()
    if perm and rng is not None:
        p = p[rng.permutation(vocab)]
    return p


def _markov_stream(rng, n, vocab, unigram, shift):
    """Cheap bigram structure: next-token dist = unigram rolled by a
    source-specific shift of the previous token (deterministic mixing)."""
    toks = rng.choice(vocab, size=n, p=unigram)
    prev = np.roll(toks, 1)
    mix = (prev * shift) % vocab
    use_mix = rng.random(n) < 0.3
    return np.where(use_mix, mix, toks).astype(np.int32)


def make_token_federation(seed=0, vocab=512, n_clients=8, n_priority=4,
                          tokens_per_client=8192, seq_len=128,
                          misalign_max=1.0, misalign_skew=1.5):
    """Returns dict with tokens [C, n_seq, seq_len+1] (input+shifted label),
    priority_mask, weights, misalignment levels."""
    rng = np.random.default_rng(seed)
    pri_unigram = _zipf_probs(vocab, rng=rng)
    alt_unigram = _zipf_probs(vocab, rng=rng)
    n_seq = tokens_per_client // (seq_len + 1)
    C = n_clients

    streams, levels = [], []
    for c in range(C):
        if c < n_priority:
            lvl = 0.0
            unigram = pri_unigram
            shift = 3
        else:
            rank = (c - n_priority) / max(C - n_priority - 1, 1)
            lvl = min(1.0, misalign_max * rank ** misalign_skew)
            unigram = (1 - lvl) * pri_unigram + lvl * alt_unigram
            shift = 3 if lvl < 0.5 else 7
        streams.append(_markov_stream(rng, n_seq * (seq_len + 1), vocab,
                                      unigram, shift).reshape(n_seq, seq_len + 1))
        levels.append(lvl)

    priority_mask = np.zeros(C, bool)
    priority_mask[:n_priority] = True
    weights = np.full(C, 1.0 / n_priority, np.float32)
    # held-out global (priority-source) eval stream
    test = _markov_stream(rng, 64 * (seq_len + 1), vocab, pri_unigram, 3
                          ).reshape(64, seq_len + 1)
    return dict(tokens=np.stack(streams), priority_mask=priority_mask,
                weights=weights, misalignment=np.asarray(levels, np.float32),
                test_tokens=test)
