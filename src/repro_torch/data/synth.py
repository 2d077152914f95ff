"""SYNTH(alpha, beta) federated dataset — paper App. B.2, implemented exactly.

Priority clients: per-client model y = argmax(softmax(W_k x + b_k)) with
W_k, b_k ~ N(u_k, 1), u_k ~ N(0, alpha); x ~ N(v_k, Sigma),
Sigma_jj = j^-1.2; v_k elements ~ N(B_k, 1), B_k ~ N(0, beta).

Non-priority clients receive *global* data (one shared (W_g, b_g) model,
x ~ N(0, Sigma)) with two progressive noise processes (App. B.2):
  1. label flips    — per-client flip fraction up to ``label_noise_factor``,
                      skewed across clients by ``label_noise_skew``;
  2. irrelevant data — fraction of points replaced by an independent
                      distribution (x ~ N(0, I), uniform labels), up to
                      ``random_data_factor`` with ``random_data_skew``.

Per-client noise level: client with rank r in [0,1] gets
level = min(1, factor * r^skew): high skew => most clients near the max
(the paper: "high skews imply a larger number of non-priority clients are
misaligned").
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DIM = 60
NUM_CLASSES = 10

# paper Fig. 2 noise presets: (label_noise_skew, random_data_skew)
NOISE_PRESETS = {"low": 0.5, "medium": 1.5, "high": 5.0}


@dataclass
class Federation:
    """In-memory federated dataset: equal-sized client arrays."""
    x: np.ndarray          # [C, n, ...]
    y: np.ndarray          # [C, n]
    priority_mask: np.ndarray  # [C] bool
    weights: np.ndarray    # [C] p_k; priority mass sums to 1
    test_x: np.ndarray     # global (priority-distribution) test set
    test_y: np.ndarray
    client_test_x: np.ndarray | None = None   # [C, m, ...] per-client test
    client_test_y: np.ndarray | None = None


def _sigma():
    return np.diag(np.arange(1, DIM + 1, dtype=np.float64) ** -1.2)


def _sample_model(rng, alpha):
    u = rng.normal(0, np.sqrt(alpha))
    W = rng.normal(u, 1, size=(NUM_CLASSES, DIM))
    b = rng.normal(u, 1, size=(NUM_CLASSES,))
    return W, b


def _sample_input_mean(rng, beta):
    Bk = rng.normal(0, np.sqrt(beta))
    return rng.normal(Bk, 1, size=(DIM,))


def _sample_inputs(rng, n, v, sigma):
    return rng.multivariate_normal(v, sigma, size=n)


def _labels(W, b, x):
    logits = x @ W.T + b
    return np.argmax(logits, axis=-1)


def _noise_level(rank, factor, skew):
    """Client at rank r in [0,1] gets min(1, factor * r^(1/skew)).
    High skew pushes most clients toward the maximum noise (paper: 'high
    skews imply a larger number of non-priority clients are misaligned')."""
    return float(min(1.0, factor * rank ** (1.0 / skew)))


def make_synth_federation(seed=0, alpha=1.0, beta=1.0, n_priority=10,
                          n_nonpriority=10, samples_per_client=200,
                          label_noise_factor=2.5, label_noise_skew=1.5,
                          random_data_factor=1.0, random_data_skew=1.5,
                          test_samples=2000) -> Federation:
    rng = np.random.default_rng(seed)
    sigma = _sigma()
    C = n_priority + n_nonpriority
    n = samples_per_client
    xs, ys = [], []

    # ---- priority clients: heterogeneous SYNTH(alpha, beta) ------------------
    pri_models = []
    for _ in range(n_priority):
        W, b = _sample_model(rng, alpha)
        v = _sample_input_mean(rng, beta)
        pri_models.append((W, b, v))
        x = _sample_inputs(rng, n, v, sigma)
        xs.append(x)
        ys.append(_labels(W, b, x))

    # ---- global data + test set: mixture over the priority clients' own
    #      (W_k, b_k, v_k) — i.e. fresh draws from the SAME distributions ------
    def global_batch(m):
        per = -(-m // n_priority)
        gx, gy = [], []
        for W, b, v in pri_models:
            x = _sample_inputs(rng, per, v, sigma)
            gx.append(x)
            gy.append(_labels(W, b, x))
        gx, gy = np.concatenate(gx)[:m], np.concatenate(gy)[:m]
        perm = rng.permutation(m)
        return gx[perm], gy[perm]

    test_x, test_y = global_batch(test_samples)

    # ---- non-priority clients: global data + progressive noise ----------------
    for i in range(n_nonpriority):
        rank = i / max(n_nonpriority - 1, 1)
        x, y = global_batch(n)
        flip_frac = _noise_level(rank, label_noise_factor, label_noise_skew)
        rand_frac = _noise_level(rank, random_data_factor, random_data_skew)
        nf = int(flip_frac * n)
        if nf:
            idx = rng.choice(n, nf, replace=False)
            y[idx] = rng.integers(0, NUM_CLASSES, nf)
        nr = int(rand_frac * n)
        if nr:
            idx = rng.choice(n, nr, replace=False)
            x[idx] = rng.normal(0, 1, size=(nr, DIM))
            y[idx] = rng.integers(0, NUM_CLASSES, nr)
        xs.append(x)
        ys.append(y)

    x = np.stack(xs).astype(np.float32)
    y = np.stack(ys).astype(np.int32)
    priority_mask = np.zeros(C, bool)
    priority_mask[:n_priority] = True
    weights = np.full(C, 1.0 / n_priority)   # equal D_k => p_k = 1/|P| for all
    return Federation(x, y, priority_mask, weights.astype(np.float32),
                      test_x.astype(np.float32), test_y.astype(np.int32))
