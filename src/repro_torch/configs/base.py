"""Federation configuration: a mirror of ``repro.configs.base.FedConfig``.

Every field name and default equals the reference's, so one config means
the same run in both packages (a test pins this). Knobs whose subsystem the
port has not reached yet are kept for that parity; ``validate_config``
refuses them with ``NotImplementedError`` naming the knob, never by
silently running something else.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class FedConfig:
    """FedALIGN / federation hyper-parameters (paper §3-4). See the
    reference's field comments for the full semantics of each knob."""
    num_clients: int = 60
    num_priority: int = 2
    local_epochs: int = 5             # E
    epsilon: float = 0.2              # selection threshold eps_t
    epsilon_decay: float = 0.0        # eps schedule decay rate
    epsilon_schedule: str = "constant"  # constant | linear | exp | step
    warmup_frac: float = 0.1          # priority-only warm-up rounds
    rounds: int = 100
    lr: float = 0.1
    lr_schedule: str = "constant"     # constant | paper_decay (2/(mu(t+gamma)))
    mu_strong: float = 1.0            # mu for paper_decay
    gamma_decay: float = 10.0         # gamma for paper_decay
    participation: float = 1.0        # fraction sampled per round (<1: not ported)
    straggler_period: int = 0         # >0: non-priority client k shows up every
                                      # (2 + k % period) rounds (App. A.4)
    candidate_pool: int = 0           # candidate-pool sampling (not ported)
    pool_weighting: str = "uniform"   # candidate-pool weights (not ported)
    algorithm: str = "fedavg"         # local solver: fedavg | fedprox
    prox_mu: float = 1.0              # FedProx proximal coefficient
    selection: str = "fedalign"       # fedalign | all | priority_only (ported);
                                      # topk_align | grad_sim | welfare (not yet)
    topk: int = 4
    sim_threshold: float = 0.0
    grad_sim_sketch: bool = False
    sketch_dim: int = 256
    utility_ema: float = 0.9          # decay of the cross-round client EMAs
    welfare_floor: float = 0.0
    backend: str = "vmap_spatial"     # vmap_spatial | scan_temporal (ported);
                                      # scan_async (not yet)
    async_depth: int = 0
    staleness_decay: float = 1.0
    async_mode: str = "fifo"
    min_lag: int = 1
    latency_mode: str = "none"
    latency_mu: float = 0.0
    latency_sigma: float = 0.5
    latency_net_mu: float = -1.0
    latency_net_sigma: float = 0.3
    round_deadline: float = float("inf")
    failure_model: str = "none"
    crash_rate: float = 0.0
    dropout_rate: float = 0.0
    dropout_len: int = 1
    corrupt_rate: float = 0.0
    corrupt_scale: float = 0.0
    divergence_guard: bool = False
    max_nonfinite_skips: int = 0
    adaptive_staleness: bool = False
    max_cohort: int = 0               # training-cohort budget (not ported)
    backlog_boost: float = 0.0
    align_stat: str = "accuracy"      # accuracy (paper experiments) | loss (theory)
    server_opt: str = "none"          # sgd (= "none") ported; momentum | adam |
                                      # yogi not yet
    server_lr: float = 1.0
    server_momentum: float = 0.9
    aggregator: str = "mean"          # mean ported; the robust / dp ones not yet
    trim_frac: float = 0.1
    dp_clip: float = 1.0
    dp_noise: float = 0.0
    dp_delta: float = 1e-5
    outlier_cos: float = 0.0
    server_b1: float = 0.9
    server_b2: float = 0.99
    server_eps: float = 1e-3
    agg_dtype: str = "float32"        # dtype of the client deltas on the wire:
                                      # float32 | bfloat16
    wire_codec: str = "identity"      # identity ported; int8 | topk | sketch not yet
    error_feedback: bool = True
    codec_topk_frac: float = 0.01
    codec_sketch_dim: int = 2048
    use_pallas: bool = False          # kept for field parity and never read:
                                      # the port picks the route by device —
                                      # on a CUDA tensor the fedagg CUDA kernel
                                      # always runs, on a CPU tensor its plain
                                      # PyTorch version
    fused_agg: bool = True            # one fedagg launch per round on the
                                      # [C, M_total] flattening (else per leaf)
    batch_size: int = 32              # local minibatch
    seed: int = 0

    def replace(self, **kw) -> "FedConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Config validation: one entry point, decorator-registered subsystem hooks.
_VALIDATORS: dict = {}


def register_validator(name: str):
    """Decorator: contribute a subsystem's FedConfig check to
    ``validate_config``. A hook raises ``ValueError`` on an invalid knob
    combination and ``NotImplementedError`` on a knob the port has not
    reached; hooks run in sorted-name order."""
    def deco(fn):
        _VALIDATORS[name] = fn
        return fn
    return deco


def validate_config(fed: "FedConfig") -> "FedConfig":
    """Run every registered subsystem validator against ``fed``; returns
    ``fed`` unchanged. Imports the subsystems so their hooks are always
    registered."""
    from repro_torch.core import aggregation  # noqa: F401  (registers hooks)
    from repro_torch.fl import engine         # noqa: F401  (registers hooks)
    for name in sorted(_VALIDATORS):
        _VALIDATORS[name](fed)
    return fed


@register_validator("population")
def check_pool_config(fed: "FedConfig") -> None:
    """Candidate-pool knobs: the reference's value checks, then the port's
    refusal of pooling itself."""
    if fed.candidate_pool < 0:
        raise ValueError(
            f"candidate_pool must be >= 0, got {fed.candidate_pool} "
            "(0 disables pooling)")
    if fed.pool_weighting not in ("uniform", "backlog", "ema"):
        raise ValueError(
            f"unknown pool_weighting {fed.pool_weighting!r}; "
            "valid: ['backlog', 'ema', 'uniform']")
    if 0 < fed.candidate_pool < fed.num_priority:
        raise ValueError(
            f"candidate_pool={fed.candidate_pool} is smaller than "
            f"num_priority={fed.num_priority}: priority clients are always "
            "in-pool, so the pool must hold at least all of them")
    if fed.candidate_pool > 0:
        raise NotImplementedError(
            f"candidate_pool={fed.candidate_pool}: candidate-pool rounds are "
            "not ported yet (use candidate_pool=0)")
