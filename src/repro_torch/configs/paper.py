"""The paper's own experiment configurations (§4 + App. B/C), as data.

Counterpart of ``repro/configs/paper.py``: the same entries over the port's
``FedConfig``, field for field, under the same keys. Each entry pairs a
FedConfig with the dataset / model of the matching experiment — the single
source of truth for the reproduction runs. Apply a FIG6 point to FIG1's
fmnist entry as ``fed.replace(num_priority=n_priority, local_epochs=E)``
over ``make_benchmark_federation("fmnist", n_priority=n_priority)``.
"""
from __future__ import annotations

from repro_torch.configs.base import FedConfig

# §4 Fig. 1 — benchmark datasets, full participation
FIG1 = {
    "fmnist": dict(model="logreg", dataset="fmnist",
                   fed=FedConfig(num_clients=60, num_priority=2, rounds=200,
                                 local_epochs=5, epsilon=0.2, lr=0.1,
                                 warmup_frac=0.1)),
    "emnist": dict(model="mlp2", dataset="emnist",
                   fed=FedConfig(num_clients=25, num_priority=2, rounds=200,
                                 local_epochs=5, epsilon=0.2, lr=0.1,
                                 warmup_frac=0.1)),
    "cifar": dict(model="cnn", dataset="cifar",
                  fed=FedConfig(num_clients=60, num_priority=2, rounds=200,
                                local_epochs=5, epsilon=0.2, lr=0.01,
                                warmup_frac=0.1)),
}

# §4 Fig. 2 — SYNTH(1,1): eps=0.2 (0.4 for high noise), N=20, |P|=10
FIG2 = {
    level: dict(model="synth_logreg",
                fed=FedConfig(num_clients=20, num_priority=10, rounds=200,
                              local_epochs=5, lr=0.1, warmup_frac=0.1,
                              epsilon=0.4 if level == "high" else 0.2),
                skew=skew)
    for level, skew in (("low", 0.5), ("medium", 1.5), ("high", 5.0))
}

# App. C.2 — FedProx adaptation (mu = 1, 4 priority clients)
FIG4 = dict(model="logreg", dataset="fmnist",
            fed=FedConfig(num_clients=60, num_priority=4, rounds=150,
                          local_epochs=5, epsilon=0.2, lr=0.1,
                          warmup_frac=0.1, algorithm="fedprox", prox_mu=1.0))

# App. C.3 — partial participation (fraction 0.3, 18 priority)
FIG5 = dict(model="logreg", dataset="fmnist",
            fed=FedConfig(num_clients=60, num_priority=18, rounds=150,
                          local_epochs=5, epsilon=0.2, lr=0.1,
                          warmup_frac=0.1, participation=0.3))

# App. C.4 — priority-count / local-epoch sweeps
FIG6 = [dict(n_priority=2, E=5), dict(n_priority=6, E=5),
        dict(n_priority=18, E=5), dict(n_priority=6, E=3)]
