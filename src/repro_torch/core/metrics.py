"""Round-history bookkeeping for federation runs (a numpy-only copy of
``repro/core/metrics.py``)."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class History:
    rounds: list = field(default_factory=list)
    global_loss: list = field(default_factory=list)
    test_acc: list = field(default_factory=list)
    test_loss: list = field(default_factory=list)
    theta_round: list = field(default_factory=list)
    included: list = field(default_factory=list)
    eps: list = field(default_factory=list)
    lr: list = field(default_factory=list)
    gates: list = field(default_factory=list)

    def log(self, stats, test_acc=None, test_loss=None):
        self.rounds.append(int(stats["round"]))
        self.global_loss.append(float(stats["global_loss"]))
        self.theta_round.append(float(stats["theta_round"]))
        self.included.append(float(stats["included_nonpriority"]))
        self.eps.append(float(stats["eps"]))
        self.lr.append(float(stats["lr"]))
        self.gates.append(np.asarray(stats["gates"]))
        if test_acc is not None:
            self.test_acc.append(float(test_acc))
        if test_loss is not None:
            self.test_loss.append(float(test_loss))

    def theta_T(self, gamma, E):
        t = np.asarray(self.theta_round, np.float64)
        T = len(t) * E
        return float(np.sum(np.repeat(t, E)) / (T + gamma - 2))

    def summary(self):
        return {
            "final_acc": self.test_acc[-1] if self.test_acc else None,
            "best_acc": max(self.test_acc) if self.test_acc else None,
            "final_loss": self.global_loss[-1] if self.global_loss else None,
            "mean_included": float(np.mean(self.included)) if self.included else 0.0,
        }
