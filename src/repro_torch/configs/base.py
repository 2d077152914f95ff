"""Configuration dataclasses: mirrors of ``repro.configs.base.ModelConfig``
and ``FedConfig``.

Every field name and default equals the reference's, so one config means
the same run in both packages (a test pins this). Every FedConfig knob is
ported; ``validate_config`` raises the reference's ``ValueError``s. Model
knobs whose subsystem the port has not reached yet are kept for that
parity, and ``models.transformer.check_model_config`` refuses them with
``NotImplementedError`` naming the knob, never by silently running
something else.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ModelConfig:
    """An LM architecture and its execution knobs. See the reference's
    field comments for the full semantics; ``pdtype`` and ``cdtype`` are
    torch dtypes here."""
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads

    # --- attention options -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0           # 0 = full attention
    causal: bool = True

    # --- MLA (minicpm3) ------------------------------------------------------
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ------------------------------------------------------------------
    moe: bool = False
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- layer pattern ("attn", "jamba" and "xlstm") -------------------------
    pattern: str = "attn"
    first_dense: int = 0

    # --- SSM (jamba's Mamba mixer; the conv width and chunk also xlstm's) ----
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0              # 0 -> ceil(d_model/16)
    ssm_chunk: int = 256

    # --- xLSTM ---------------------------------------------------------------
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0

    # --- encoder/decoder (whisper: models/encdec.py) -------------------------
    encdec: bool = False
    encoder_layers: int = 0
    num_frames: int = 1500

    # --- VLM (llava) ---------------------------------------------------------
    vlm: bool = False
    num_image_tokens: int = 0

    # --- numerics --------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    tie_embeddings: bool = True

    # --- execution knobs ---------------------------------------------------------
    attn_block_q: int = 512           # unused by the port's kernels
    attn_block_kv: int = 1024         # kv block of the plain flash attention
    loss_chunk: int = 512
    remat: bool = True                # no effect on serving
    remat_policy: str = "full"
    use_pallas: bool = False          # never read: the route follows the device
    seq_shard_attn: bool = False      # sequence-sharded attention on a model axis
    attn_bf16: bool = False           # bf16 attention products (f32 softmax state)
    expert_parallel: bool = False
    dp_axes: tuple = ("data",)

    # --- citation / provenance ------------------------------------------------
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm_dt_rank == 0:
            object.__setattr__(self, "ssm_dt_rank", -(-self.d_model // 16))

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def period(self) -> int:
        return {"attn": 1, "jamba": 8, "xlstm": 2}[self.pattern]

    @property
    def n_periods(self) -> int:
        n = self.num_layers - self.first_dense
        if n % self.period:
            raise ValueError(f"{self.name}: {self.num_layers} layers minus "
                             f"{self.first_dense} dense ones is not a "
                             f"multiple of the period {self.period}")
        return n // self.period

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_kinds(self) -> list[dict]:
        """Blocks of one period, in order. kind: mixer + ffn type."""
        if self.pattern == "attn":
            return [{"mixer": "attn", "ffn": "moe" if self.moe else "dense"}]
        if self.pattern == "jamba":
            return [{"mixer": "attn" if i == 0 else "mamba",
                     "ffn": "moe" if (self.moe and i % self.moe_every
                                      == self.moe_offset) else "dense"}
                    for i in range(8)]
        if self.pattern == "xlstm":
            return [{"mixer": "mlstm", "ffn": "none"},
                    {"mixer": "slstm", "ffn": "none"}]
        raise ValueError(self.pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    """One of the assigned (seq_len, global_batch) workload points."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


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
    participation: float = 1.0        # fraction sampled per round (<1 = partial)
    straggler_period: int = 0         # >0: non-priority client k shows up every
                                      # (2 + k % period) rounds (App. A.4)
    candidate_pool: int = 0           # P clients a round draws (0: all C;
                                      # P >= C is the dense round)
    pool_weighting: str = "uniform"   # uniform | backlog | ema
    algorithm: str = "fedavg"         # local solver: fedavg | fedprox
    prox_mu: float = 1.0              # FedProx proximal coefficient
    selection: str = "fedalign"       # fedalign | all | priority_only |
                                      # topk_align | grad_sim | welfare
    topk: int = 4
    sim_threshold: float = 0.0
    grad_sim_sketch: bool = False
    sketch_dim: int = 256
    utility_ema: float = 0.9          # decay of the cross-round client EMAs
    welfare_floor: float = 0.0
    backend: str = "vmap_spatial"     # vmap_spatial | scan_temporal |
                                      # scan_async
    async_depth: int = 0              # in-flight buffer slots D (scan_async)
    staleness_decay: float = 1.0      # a landed delta's scale: decay ** age
    async_mode: str = "fifo"          # fifo (D rounds late) | ready
    min_lag: int = 1                  # ready: the age a slot pops at
    latency_mode: str = "none"        # none | lognormal (the event clock)
    latency_mu: float = 0.0           # log-mean of the compute time
    latency_sigma: float = 0.5
    latency_net_mu: float = -1.0      # log-mean of the network time
    latency_net_sigma: float = 0.3
    round_deadline: float = float("inf")  # later clients are lost
    failure_model: str = "none"       # none | crash | dropout | corrupt |
                                      # chaos
    crash_rate: float = 0.0
    dropout_rate: float = 0.0
    dropout_len: int = 1              # rounds a drop-out window spans
    corrupt_rate: float = 0.0
    corrupt_scale: float = 0.0        # 0: NaN rows, else a scaled delta
    divergence_guard: bool = False    # skip non-finite aggregates
    max_nonfinite_skips: int = 0      # consecutive skips that halt (0: never)
    adaptive_staleness: bool = False  # scale by the drift cosine too
    max_cohort: int = 0               # training-cohort budget K (0: off)
    backlog_boost: float = 0.0
    align_stat: str = "accuracy"      # accuracy (paper experiments) | loss (theory)
    server_opt: str = "none"          # sgd (= "none") | momentum | adam |
                                      # yogi
    server_lr: float = 1.0
    server_momentum: float = 0.9
    aggregator: str = "mean"          # mean | trimmed_mean | median | dp |
                                      # cosine_filter
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
    wire_codec: str = "identity"      # identity | int8 | topk | sketch
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
    combination, as the reference's hooks do (the aggregation hook also
    raises ``NotImplementedError`` on an ``agg_dtype`` the fedagg kernel
    does not take); hooks run in sorted-name order."""
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
    """Candidate-pool knobs, with the reference's errors: a negative pool,
    an unknown weighting, a pool too small to hold every priority client."""
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
