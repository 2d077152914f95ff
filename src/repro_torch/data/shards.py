"""Uniclass-shard federated partitioning (McMahan et al. / paper App. B.1)
over class-structured synthetic stand-ins for FMNIST / EMNIST / CIFAR-10.

The container is offline, so the three benchmark datasets are replaced by
Gaussian class-prototype data with *matching* input dims, class counts and
shard statistics:

    fmnist : 784 dims, 10 classes, 120 shards x 500, 2 shards/client, N=60
    emnist : 784 dims, 47 classes, 600 shards x 180, 24 shards/client (bal.)
    cifar  : 32x32x3,  10 classes, 120 shards x 500, 2 shards/client

Distributional structure (uniclass shards -> extreme label skew per client)
is what drives the paper's heterogeneity claims and is preserved exactly.
"""
from __future__ import annotations


import numpy as np

from repro_torch.data.synth import Federation

SPECS = {
    "fmnist": dict(dim=(784,), classes=10, shards=120, shard_size=500,
                   shards_per_client=2, clients=60),
    "emnist": dict(dim=(784,), classes=47, shards=600, shard_size=180,
                   shards_per_client=24, clients=25),
    "cifar": dict(dim=(32, 32, 3), classes=10, shards=120, shard_size=500,
                  shards_per_client=2, clients=60),
}


def _prototype_data(rng, n, dim, classes, sep=0.2, noise=1.5, protos=None, y=None):
    """Gaussian class-prototype data: x = mu_c + noise, structured enough
    that class identity is learnable by the paper's models."""
    if protos is None:
        protos = rng.normal(0, sep / np.sqrt(np.prod(dim)),
                            size=(classes,) + tuple(dim))
    if y is None:
        y = rng.integers(0, classes, n)
    x = protos[y] + rng.normal(0, noise / np.sqrt(np.prod(dim)), size=(n,) + tuple(dim))
    return x.astype(np.float32), y.astype(np.int32), protos


def make_benchmark_federation(dataset="fmnist", seed=0, n_priority=2,
                              clients=None, samples_per_client=None,
                              test_samples=2000) -> Federation:
    """Uniclass shards, ``shards_per_client`` each, first ``n_priority``
    clients are priority. Matches the paper's N=60, |P|=2 default."""
    spec = dict(SPECS[dataset])
    if clients is not None:
        spec["clients"] = clients
    rng = np.random.default_rng(seed)
    # uniclass shards BY CONSTRUCTION: round-robin classes across shards so
    # every shard holds exactly one class (paper App. B.1 guarantee)
    shard_classes = np.arange(spec["shards"]) % spec["classes"]
    y_all = np.repeat(shard_classes, spec["shard_size"])
    x, y, protos = _prototype_data(rng, len(y_all), spec["dim"],
                                   spec["classes"], y=y_all)
    shards_x = x.reshape((spec["shards"], spec["shard_size"]) + tuple(spec["dim"]))
    shards_y = y.reshape(spec["shards"], spec["shard_size"])

    C = spec["clients"]
    spc = spec["shards_per_client"]
    assert C * spc <= spec["shards"], (C, spc, spec["shards"])
    assign = rng.permutation(spec["shards"])[:C * spc].reshape(C, spc)

    cx = shards_x[assign].reshape((C, spc * spec["shard_size"]) + tuple(spec["dim"]))
    cy = shards_y[assign].reshape(C, spc * spec["shard_size"])
    if samples_per_client is not None:
        keep = min(samples_per_client, cx.shape[1])
        sel = rng.permutation(cx.shape[1])[:keep]
        cx, cy = cx[:, sel], cy[:, sel]
    # per-client shuffle
    for i in range(C):
        p = rng.permutation(cx.shape[1])
        cx[i], cy[i] = cx[i][p], cy[i][p]

    priority_mask = np.zeros(C, bool)
    priority_mask[:n_priority] = True
    weights = np.full(C, 1.0 / n_priority, np.float32)

    test_x, test_y, _ = _prototype_data(rng, test_samples, spec["dim"],
                                        spec["classes"], protos=protos)
    # global test drawn from the same prototypes, restricted to priority classes
    pri_classes = np.unique(cy[:n_priority])
    keep = np.isin(test_y, pri_classes)
    return Federation(cx, cy, priority_mask, weights,
                      test_x[keep], test_y[keep],
                      client_test_x=None, client_test_y=None)
