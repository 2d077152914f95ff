"""FedALIGN renormalized gated aggregation (paper eq. (15)):

    w <- sum_k p_k I_k w_k / sum_k p_k I_k

over client-stacked parameter dicts. Counterpart of
``repro/core/aggregation.py``. The default fused path flattens the whole
tree into one [C, M_total] buffer and launches the ``fedagg`` kernel once
per round; ``fused=False`` launches it once per leaf. Accumulation is f32
whatever the leaf dtype, so both paths agree to the cast.

Three registries, as in the reference:

- **aggregators** (``FedConfig.aggregator``): how the gated client deltas
  are reduced. ``mean`` is the paper rule; ``trimmed_mean`` / ``median``
  are the coordinate-wise Byzantine-robust order statistics, ``dp`` is
  DP-FedAvg clip + noise, and ``cosine_filter`` zeroes the gates of
  delta-sketch outliers before the plain mean. An aggregator is a PREPARE
  step producing gate/weight rewrites and kernel operands: the reduction
  itself stays one fedagg launch per round for every variant.
- **wire codecs** (``FedConfig.wire_codec``): lossy uplink compression of
  the fused buffer (``int8``, ``topk``, ``sketch``), decoded inside the same
  fedagg launch, with per-client error-feedback rows re-injecting the
  compression residual next round.
- **server optimizers** (``FedConfig.server_opt``): the aggregated delta
  feeds ``apply_server_opt`` as a pseudo-gradient: ``sgd`` (FedAvg),
  ``momentum`` (FedAvgM), ``adam`` (FedAdam) and ``yogi`` (FedYogi),
  reading ``server_momentum``, ``server_b1``, ``server_b2`` and
  ``server_eps``.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import register_validator
from repro_torch.kernels import ops as kops
from repro_torch.kernels.fedagg import decode_wire_plain
from repro_torch.optim import optimizers as _opt
from repro_torch.utils import (Registry, fold_in_name, round_up, tree_leaves,
                               tree_map, tree_unflatten_like)

_AGG_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_client_weights(weights, *, where="client weights"):
    """Validate client weights at the aggregation boundary: a negative p_k
    sign-flips that client's contribution and a NaN/inf poisons the whole
    aggregate, so both fail loudly here."""
    w = (weights.detach().cpu().float().numpy()
         if isinstance(weights, torch.Tensor) else np.asarray(weights))
    if not np.all(np.isfinite(w)):
        bad = np.flatnonzero(~np.isfinite(w))
        raise ValueError(
            f"{where} must be finite: clients {bad.tolist()} are NaN/inf. "
            "Check the shard spec / data-fraction computation that produced "
            "them — a NaN weight poisons every aggregated parameter.")
    if np.any(w < 0):
        bad = np.flatnonzero(w < 0)
        raise ValueError(
            f"{where} must be non-negative: clients {bad.tolist()} have "
            f"negative weight (min {w.min()}). A negative data fraction "
            "sign-flips that client's update in the renormalized mean; fix "
            "the shard spec instead of aggregating with it.")
    return weights


def pitched_empty(C: int, M: int, dtype, device) -> torch.Tensor:
    """An uninitialised [C, M] view whose rows start on 16-byte boundaries
    (the row pitch is M rounded up), so the kernel can use its widest
    loads."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return torch.empty(C, round_up(max(M, 1), 16 // itemsize), dtype=dtype,
                       device=device)[:, :M]


def flatten_stacked(client_params, dtype=torch.float32):
    """Client-stacked tree ([C, ...] leaves) -> one [C, M_total] buffer,
    laid out by ``pitched_empty``."""
    leaves = tree_leaves(client_params)
    C = leaves[0].shape[0]
    sizes = [math.prod(leaf.shape[1:]) for leaf in leaves]
    buf = pitched_empty(C, sum(sizes), dtype, leaves[0].device)
    off = 0
    for leaf, size in zip(leaves, sizes):
        buf[:, off:off + size].copy_(leaf.reshape(C, size))
        off += size
    return buf


def _unflatten(out, like, C):
    """[M_total] -> a tree shaped like the client tree's [C, ...] leaves
    minus their client axis, in each leaf's dtype."""
    leaves, off = [], 0
    for leaf in tree_leaves(like):
        size = math.prod(leaf.shape[1:])
        leaves.append(out[off:off + size].reshape(leaf.shape[1:]).to(leaf.dtype))
        off += size
    return tree_unflatten_like(like, leaves)


def aggregate_clients(client_params, weights, gates, *, fused=True,
                      aggregator="mean", fed=None, key=None,
                      wire_codec="identity", ef_accum=None, reduce=None):
    """client_params: tree with leading client axis C on every leaf.

    fused=True (default): one fedagg launch on the [C, M_total] flattening;
    fused=False: one launch per leaf (the parity reference).

    ``aggregator`` names a registered aggregator; the non-mean ones read
    their knobs off ``fed`` and take the client rows as deltas, and ``dp``
    needs the round's PRNG ``key`` for its noise draw. ``wire_codec`` names
    a registered codec compressing the fused buffer (non-identity codecs
    need ``fused=True`` and ``fed=``). With ``ef_accum`` (f32 per-client
    error-feedback rows, params-shaped leaves with the client axis) the
    accumulator is added to the rows before encoding and the call returns
    ``(aggregate, new_ef_accum)``: a row that transmitted (gate > 0 before
    any server-side gate rewrite) and has a finite residual keeps its
    residual x - decode(encode(x)); every other row keeps its old one.

    ``reduce`` (fused only) replaces the one ``kops.fedagg`` launch: it
    takes the same operands and returns the [M_total] aggregate. A pod
    round passes one that reduces a rank's rows and combines the ranks'
    (``fl/sharded.py: make_pod_round``)."""
    check_client_weights(weights)
    if reduce is None:
        reduce = kops.fedagg
    elif not fused:
        raise ValueError("reduce= replaces the fused launch; call with "
                         "fused=True")
    leaves = tree_leaves(client_params)
    if not leaves:
        return client_params
    C = leaves[0].shape[0]
    # which rows transmitted, before a server-side gate rewrite
    # (cosine_filter): a filtered-out client still sent its delta
    tx_gates = gates

    name = resolve_aggregator(aggregator)
    prepare = get_aggregator(name)
    if name != "mean":
        if fed is None:
            raise ValueError(
                f"aggregator={name!r} reads its knobs (trim_frac/dp_clip/"
                "dp_noise/outlier_cos/sketch_dim) off a FedConfig: pass fed=")
        weights, gates, kernel_kw, noise = prepare(fed, client_params, weights,
                                                   gates, key)
    else:
        kernel_kw, noise = {}, None

    codec_name = resolve_wire_codec(wire_codec)
    get_wire_codec(codec_name)
    if codec_name != "identity":
        if fed is None:
            raise ValueError(
                f"wire_codec={codec_name!r} reads its rate knobs "
                "(codec_topk_frac/codec_sketch_dim) off a FedConfig: "
                "pass fed=")
        if not fused:
            raise ValueError(
                f"wire_codec={codec_name!r} compresses the fused "
                "[C, M_total] buffer; call with fused=True")
        return _aggregate_coded(codec_name, client_params, weights, gates,
                                tx_gates, kernel_kw, noise, fed=fed,
                                ef_accum=ef_accum, reduce=reduce)
    if ef_accum is not None:
        raise ValueError(
            "ef_accum (error-feedback rows) only makes sense with a "
            "non-identity wire_codec: the identity wire is lossless, its "
            "residual is exactly zero")

    if not fused:
        # the dp noise is ONE [M_total] draw sliced at each leaf's offset,
        # so per-leaf equals fused coordinate for coordinate
        agg_leaves, off = [], 0
        for leaf in leaves:
            size = math.prod(leaf.shape[1:])
            kw = dict(kernel_kw)
            if noise is not None:
                kw["noise"] = noise[off:off + size]
            agg_leaves.append(kops.fedagg(leaf.reshape(C, -1), weights, gates,
                                          **kw).reshape(leaf.shape[1:]))
            off += size
        return tree_unflatten_like(client_params, agg_leaves)

    # a uniform leaf dtype stays on the wire (bf16 deltas stay bf16 in the
    # buffer); mixed-dtype trees go f32. Accumulation is f32 either way.
    dtypes = {leaf.dtype for leaf in leaves}
    buf_dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
    out = reduce(flatten_stacked(client_params, dtype=buf_dtype),
                 weights, gates, noise=noise, **kernel_kw)
    return _unflatten(out, client_params, C)


def _aggregate_coded(codec_name, client_params, weights, gates, tx_gates,
                     kernel_kw, noise, *, fed, ef_accum, reduce):
    """The compressed-uplink fused path: encode the f32 [C, M_total] buffer
    (error-feedback rows folded in first), decode and reduce inside the one
    fedagg launch, and advance the error-feedback rows. The dense decode is
    built only for the residual, never for the aggregation."""
    C = tree_leaves(client_params)[0].shape[0]
    codec = get_wire_codec(codec_name)
    buf = flatten_stacked(client_params, dtype=torch.float32)
    if ef_accum is not None:
        buf += flatten_stacked(ef_accum, dtype=torch.float32)
    M = buf.shape[1]
    updates, codec_kw = codec.encode(fed, buf)
    out = reduce(updates, weights, gates, noise=noise, **codec_kw,
                 **kernel_kw)
    agg = _unflatten(out, client_params, C)
    if ef_accum is None:
        return agg
    resid = buf - codec.decode(fed, updates, codec_kw, M)
    # a row advances only if it transmitted AND its residual is finite: a
    # corrupted (NaN) delta must not poison the accumulator for later rounds
    ok = (tx_gates > 0) & torch.all(torch.isfinite(resid), dim=1)
    new_ef, off = [], 0
    for old in tree_leaves(ef_accum):
        size = math.prod(old.shape[1:])
        r = resid[:, off:off + size].reshape(old.shape)
        okb = ok.reshape((C,) + (1,) * (old.dim() - 1))
        new_ef.append(torch.where(okb, r, old.float()))
        off += size
    return agg, tree_unflatten_like(ef_accum, new_ef)


# ================================================================ aggregators
AGGREGATORS = Registry("aggregator", aliases={None: "mean", "none": "mean"})


def register_aggregator(name: str, *, needs_key=False, in_kernel=True):
    """Register a PREPARE step ``prepare(fed, client_deltas, weights, gates,
    key) -> (weights, gates, kernel_kw, noise)`` under ``name``: it may
    rewrite the weight/gate vectors, attach kernel operands and return a
    [M_total] noise vector. ``needs_key`` marks stochastic aggregators (the
    round derives ``aggregator_key`` only for those); ``in_kernel`` marks
    those whose reduction is a kernel variant rather than a gate rewrite."""
    return AGGREGATORS.register(name, agg_name=name, needs_key=needs_key,
                                in_kernel=in_kernel)


def resolve_aggregator(name) -> str:
    """Canonical registry name ('none' / None is the plain gated mean)."""
    return AGGREGATORS.resolve(name)


def get_aggregator(name: str) -> Callable:
    return AGGREGATORS.lookup(name)


def aggregator_key(fed, round_idx):
    """Per-round PRNG key for stochastic aggregators (dp's noise draw): the
    reference's ``fold_in(fold_in_name(PRNGKey(seed), 'aggregator_noise'),
    round_idx)``, so both packages draw from the same stream."""
    base = fold_in_name(prng.PRNGKey(fed.seed), "aggregator_noise")
    return prng.fold_in(base, round_idx)


def inclusion_mass(fed, weights, gates):
    """The configured aggregator's denominator mass for a round: the
    aggregate can be nonzero iff this is > 0 (the zero-inclusion server
    skip keys off it). mean/dp/cosine_filter renormalize by sum p_k I_k;
    trimmed_mean/median are unweighted order statistics over the included
    clients, so their mass is the included count."""
    if resolve_aggregator(fed.aggregator) in ("trimmed_mean", "median"):
        return torch.sum((gates > 0).float())
    return torch.sum(weights.float() * gates.float())


@register_validator("aggregator")
def check_aggregator_config(fed):
    """The aggregator knobs whose bad values would corrupt the aggregate
    silently, as the reference checks them; the server optimizer's name
    (unknown names raise ValueError); and the port's refusal of the wire
    dtypes it lacks."""
    name = resolve_aggregator(fed.aggregator)
    get_aggregator(name)
    if name == "trimmed_mean" and not 0.0 <= fed.trim_frac < 0.5:
        raise ValueError(
            f"FedConfig.trim_frac={fed.trim_frac} outside [0, 0.5): trimming "
            "half or more from each side leaves no survivors for any n")
    if name == "dp":
        if fed.dp_clip <= 0:
            raise ValueError(
                f"FedConfig.dp_clip={fed.dp_clip} must be > 0: the clip bound "
                "is the DP sensitivity; 0 would zero every client delta")
        if fed.dp_noise < 0:
            raise ValueError(
                f"FedConfig.dp_noise={fed.dp_noise} must be >= 0 "
                "(noise multiplier z; 0 = clip-only)")
    if name == "cosine_filter":
        if not -1.0 <= fed.outlier_cos <= 1.0:
            raise ValueError(
                f"FedConfig.outlier_cos={fed.outlier_cos} outside [-1, 1]: "
                "it is compared against cosine similarities")
        if fed.sketch_dim <= 0:
            raise ValueError(
                "cosine_filter scores clients on sketch_dim CountSketches; "
                f"FedConfig.sketch_dim={fed.sketch_dim} must be > 0")
    get_server_optimizer(fed.server_opt)
    if fed.agg_dtype not in _AGG_DTYPES:
        raise NotImplementedError(
            f"agg_dtype={fed.agg_dtype!r}: the fedagg kernel takes "
            f"{sorted(_AGG_DTYPES)}")


def _delta_sq_norms(client_deltas):
    """Per-client squared L2 norm over the whole delta tree -> [C] f32."""
    leaves = tree_leaves(client_deltas)
    C = leaves[0].shape[0]
    tot = torch.zeros(C, dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        x = leaf.reshape(C, math.prod(leaf.shape[1:])).float()
        tot = tot + torch.sum(x * x, dim=1)
    return tot


@register_aggregator("mean")
def _agg_mean(fed, client_deltas, weights, gates, key):
    # the paper's renormalized gated weighted mean: the kernel default
    return weights, gates, {}, None


@register_aggregator("trimmed_mean")
def _agg_trimmed(fed, client_deltas, weights, gates, key):
    return weights, gates, dict(aggregator="trimmed_mean",
                                trim_frac=float(fed.trim_frac)), None


@register_aggregator("median")
def _agg_median(fed, client_deltas, weights, gates, key):
    return weights, gates, dict(aggregator="median"), None


@register_aggregator("dp", needs_key=True)
def _agg_dp(fed, client_deltas, weights, gates, key):
    """DP-FedAvg: clip each client delta to L2 <= dp_clip (a per-client
    factor folded into the kernel's weighted sum) and add
    N(0, (dp_noise * dp_clip / inclusion_mass)^2) per coordinate. The noise
    is one [M_total] draw per round on the deltas' device, outside the
    kernel, so the kernel and the plain version read the same vector."""
    if key is None:
        raise ValueError(
            "aggregator='dp' draws per-round Gaussian noise and needs the "
            "round key: thread key=aggregator_key(fed, round_idx) through "
            "aggregate_clients/aggregate_delta")
    leaves = tree_leaves(client_deltas)
    norms = torch.sqrt(_delta_sq_norms(client_deltas))
    row_scale = torch.clamp(fed.dp_clip / torch.clamp(norms, min=1e-12),
                            max=1.0)
    M = sum(math.prod(leaf.shape[1:]) for leaf in leaves)
    noise = prng.normal(torch.as_tensor(key).to(leaves[0].device), (M,))
    kw = dict(aggregator="dp", row_scale=row_scale,
              noise_scale=float(fed.dp_noise) * float(fed.dp_clip))
    return weights, gates, kw, noise


# ============================================================ DP accounting
# RDP orders to minimize over: dense where the optimum usually lands for
# z in [0.3, 10] over 1..1e5 rounds, sparse log-spaced tail for tiny z.
DP_RDP_ORDERS = tuple([1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0,
                       10.0, 12.0, 16.0, 20.0, 24.0, 32.0, 48.0, 64.0,
                       96.0, 128.0, 192.0, 256.0, 384.0, 512.0])


def dp_epsilon(noise_multiplier: float, steps: int, delta: float,
               orders=DP_RDP_ORDERS):
    """(epsilon, best_order) for ``steps`` compositions of the Gaussian
    mechanism with noise multiplier z at target ``delta``: Renyi DP of
    order alpha is alpha / (2 z^2) per step (Mironov 2017, Prop. 7),
    composed additively and converted with
    eps = min_alpha [steps alpha / (2 z^2) + log(1/delta) / (alpha - 1)]
    (ibid. Prop. 3). z <= 0 means no noise: epsilon is infinite. Sanity
    anchor: z=1, one step, delta=1e-5 -> eps ~ 5.3."""
    if steps <= 0:
        return 0.0, None
    if noise_multiplier <= 0:
        return float("inf"), None
    if not (0.0 < delta < 1.0):
        raise ValueError(f"dp_epsilon needs a target delta in (0, 1), "
                         f"got {delta}")
    z2 = float(noise_multiplier) ** 2
    log1d = math.log(1.0 / float(delta))
    best, best_order = float("inf"), None
    for a in orders:
        if a <= 1.0:
            continue
        eps = steps * a / (2.0 * z2) + log1d / (a - 1.0)
        if eps < best:
            best, best_order = eps, a
    return best, best_order


def dp_report(fed, rounds: int):
    """(epsilon, delta) spent by a run of ``rounds`` rounds under this
    config, or None when the run is not differentially private (aggregator
    != 'dp', or clip-only dp_noise=0)."""
    if resolve_aggregator(fed.aggregator) != "dp" or fed.dp_noise <= 0:
        return None
    eps, _ = dp_epsilon(float(fed.dp_noise), int(rounds), float(fed.dp_delta))
    return eps, float(fed.dp_delta)


@register_aggregator("cosine_filter", in_kernel=False)
def _agg_cosine(fed, client_deltas, weights, gates, key):
    """Zero the gate of clients whose delta direction disagrees with the
    cohort. Cosines are taken on sketch_dim CountSketches of the deltas
    (``engine.delta_sketch``) against the gated weighted mean of the
    NORMALIZED sketches, so a norm-boosted client cannot buy reference
    mass. Clients with cos < fed.outlier_cos drop out of the round; the
    reduction is then the plain gated mean."""
    from repro_torch.fl.engine import delta_sketch
    skey = fold_in_name(prng.PRNGKey(fed.seed), "aggregator_cosine_sketch")
    sk = delta_sketch(client_deltas, skey, int(fed.sketch_dim))
    norms = torch.sqrt(torch.sum(sk * sk, dim=1))
    dirs = sk / torch.clamp(norms, min=1e-12)[:, None]
    wg = (weights * gates).float()
    # excluded rows are masked before the weighted mean: a non-finite delta
    # behind gate 0 sketches to NaN and 0 * NaN would poison the reference
    ref = (torch.einsum("c,cd->d", wg, torch.where((wg > 0)[:, None], dirs, 0.0))
           / torch.clamp(torch.sum(wg), min=1e-30))
    ref = ref / torch.clamp(torch.sqrt(torch.sum(ref * ref)), min=1e-12)
    cos = dirs @ ref
    keep = (cos >= fed.outlier_cos).to(gates.dtype)
    return weights, gates * keep, {}, None


# ============================================================== wire codecs
WIRE_CODECS = Registry(
    "wire codec", aliases={None: "identity", "": "identity",
                           "none": "identity"})


def register_wire_codec(name: str):
    """Register a wire codec class under ``name``. It provides
    ``encode(fed, buf) -> (updates, codec_kw)`` (the wire operand and the
    kernel's decode operands), ``decode(fed, updates, codec_kw, M)`` (the
    dense f32 decode, for the error-feedback residual only) and
    ``wire_bytes(fed, C, M)`` (uplink bytes per round)."""
    return WIRE_CODECS.register(name, codec_name=name)


def resolve_wire_codec(name) -> str:
    """Canonical registry name ('none' / None / '' mean identity)."""
    return WIRE_CODECS.resolve(name)


def get_wire_codec(name):
    return WIRE_CODECS.lookup(name)


@register_validator("codec")
def check_codec_config(fed):
    """The wire-codec knobs whose bad values would corrupt the uplink
    silently, as the reference checks them; no-op for the identity wire."""
    name = resolve_wire_codec(fed.wire_codec)
    get_wire_codec(name)
    if name == "identity":
        return
    if not fed.fused_agg:
        raise ValueError(
            f"wire_codec={name!r} compresses the fused [C, M_total] buffer; "
            "fused_agg=False never builds that buffer (one kernel call per "
            "leaf) — enable fused_agg or set wire_codec='identity'")
    if name == "topk" and not 0.0 < float(fed.codec_topk_frac) <= 1.0:
        raise ValueError(
            f"FedConfig.codec_topk_frac={fed.codec_topk_frac} outside "
            "(0, 1]: it is the kept fraction of M_total per client row "
            "(k = max(1, floor(frac * M)))")
    if name == "sketch" and int(fed.codec_sketch_dim) < 1:
        raise ValueError(
            f"FedConfig.codec_sketch_dim={fed.codec_sketch_dim} must be "
            ">= 1 (the CountSketch row width on the wire)")


def wire_sketch_streams(fed, M: int, device="cpu"):
    """The run-constant CountSketch planes of the sketch codec: ``h`` [M]
    int32 buckets and ``sign`` [M] f32 Rademacher signs, one named stream
    off the config seed shared by every client and round (the reference's
    draw, bit for bit), drawn on ``device``."""
    dim = int(fed.codec_sketch_dim)
    key = fold_in_name(prng.PRNGKey(fed.seed, device=device), "wire_sketch")
    kh, ks = prng.split(key)
    return prng.randint(kh, (M,), 0, dim), prng.rademacher(ks, (M,))


def wire_bytes_per_round(fed, num_rows: int, m_total: int) -> int:
    """Analytic uplink bytes for one round: ``num_rows`` client rows of
    ``m_total`` coordinates through ``fed.wire_codec`` (identity pays
    ``agg_dtype`` bytes)."""
    codec = get_wire_codec(fed.wire_codec)
    return int(codec.wire_bytes(fed, int(num_rows), int(m_total)))


@register_wire_codec("identity")
class _IdentityCodec:
    """No codec: the [C, M] buffer travels as-is at ``fed.agg_dtype``."""

    @staticmethod
    def encode(fed, buf):
        return buf, {}

    @staticmethod
    def decode(fed, updates, codec_kw, M):
        return updates.float()

    @staticmethod
    def wire_bytes(fed, C, M):
        return C * M * torch.empty((), dtype=getattr(torch, fed.agg_dtype)).element_size()


@register_wire_codec("int8")
class _Int8Codec:
    """Symmetric per-row int8: q = round(x / scale) clipped to [-127, 127]
    (round half to even), scale = rowmax|x| / 127, 1.0 on an all-zero row.
    A NaN element encodes to 0, as XLA's float-to-int convert defines it (a
    C++ cast leaves it undefined), and a row with a NaN falls back to scale
    1, so a corrupted row reaches the reducer as zeros in both packages.
    The rows are laid out with a 16-byte pitch for the kernel's loads."""

    @staticmethod
    def encode(fed, buf):
        amax = torch.amax(torch.abs(buf), dim=1)
        scale = torch.where(amax > 0, amax / 127.0, 1.0).float()
        q = pitched_empty(buf.shape[0], buf.shape[1], torch.int8, buf.device)
        x = torch.nan_to_num(buf / scale[:, None], nan=0.0)
        q.copy_(torch.clamp(torch.round(x), -127.0, 127.0))
        return q, dict(codec="int8", dequant_scale=scale)

    @staticmethod
    def decode(fed, updates, codec_kw, M):
        return decode_wire_plain(updates, codec="int8", **_decode_kw(codec_kw))

    @staticmethod
    def wire_bytes(fed, C, M):
        return C * M + C * 4                        # int8 rows + f32 scales


@register_wire_codec("topk")
class _TopkCodec:
    """Per-row magnitude top-k: keep the k = max(1, floor(frac * M))
    largest |x| (ties to the lower index, as ``jax.lax.top_k``), sent as
    (value, index) pairs sorted by index, so a kernel block finds the pairs
    of its columns by binary search."""

    @staticmethod
    def _k(fed, M):
        return max(1, min(int(M), int(float(fed.codec_topk_frac) * M)))

    @staticmethod
    def encode(fed, buf):
        M = buf.shape[1]
        k = _TopkCodec._k(fed, M)
        # a stable descending sort keeps equal magnitudes in index order
        top = torch.sort(torch.abs(buf), dim=1, descending=True,
                         stable=True).indices[:, :k]
        idx = torch.sort(top, dim=1).values
        vals = torch.gather(buf, 1, idx).float().contiguous()
        return vals, dict(codec="topk", topk_idx=idx.to(torch.int32), out_m=M)

    @staticmethod
    def decode(fed, updates, codec_kw, M):
        return decode_wire_plain(updates, codec="topk", **_decode_kw(codec_kw))

    @staticmethod
    def wire_bytes(fed, C, M):
        return C * _TopkCodec._k(fed, M) * 8        # f32 value + i32 index


@register_wire_codec("sketch")
class _SketchCodec:
    """CountSketch uplink with one shared hash/sign stream per run
    (``wire_sketch_streams``): each client sends [codec_sketch_dim] f32
    bucket sums; the decode is ``sign[m] * s[c, h[m]]``."""

    @staticmethod
    def encode(fed, buf):
        M = buf.shape[1]
        dim = int(fed.codec_sketch_dim)
        h, sign = wire_sketch_streams(fed, M, buf.device)
        s = torch.zeros(buf.shape[0], dim, dtype=torch.float32,
                        device=buf.device)
        s.index_add_(1, h.long(), sign[None, :] * buf.float())
        return s, dict(codec="sketch", sketch_h=h, sketch_sign=sign, out_m=M)

    @staticmethod
    def decode(fed, updates, codec_kw, M):
        return decode_wire_plain(updates, codec="sketch", **_decode_kw(codec_kw))

    @staticmethod
    def wire_bytes(fed, C, M):
        return C * int(fed.codec_sketch_dim) * 4    # f32 bucket rows


def _decode_kw(codec_kw):
    return {k: v for k, v in codec_kw.items() if k != "codec"}


# ========================================================= server optimizers
SERVER_OPTIMIZERS = Registry("server optimizer",
                             aliases={None: "sgd", "none": "sgd"})


def resolve_server_opt(name) -> str:
    """Canonical registry name ('none', the legacy no-op, is plain sgd)."""
    return SERVER_OPTIMIZERS.resolve(name)


def get_server_optimizer(name: str) -> Callable:
    return SERVER_OPTIMIZERS.lookup(name)


def server_optimizer(fed):
    """The configured ServerOptimizer instance for ``fed.server_opt``."""
    return get_server_optimizer(fed.server_opt)(fed)


@SERVER_OPTIMIZERS.register("sgd", opt_name="sgd")
def _server_sgd(fed):
    # w <- w + server_lr * agg_delta: FedAvg at server_lr=1 (the paper rule)
    return _opt.sgd(0.0)


@SERVER_OPTIMIZERS.register("momentum", opt_name="momentum")
def _server_momentum(fed):
    # FedAvgM: momentum over aggregated deltas
    return _opt.sgd(momentum=fed.server_momentum)


@SERVER_OPTIMIZERS.register("adam", opt_name="adam")
def _server_adam(fed):
    return _opt.adam(fed.server_b1, fed.server_b2, fed.server_eps)


@SERVER_OPTIMIZERS.register("yogi", opt_name="yogi")
def _server_yogi(fed):
    return _opt.yogi(fed.server_b1, fed.server_b2, fed.server_eps)


def apply_server_opt(fed, global_params, opt_state, agg_delta, *, scale=1.0):
    """One server-optimizer step on an already-aggregated global delta; the
    delta enters as the pseudo-gradient g = -agg_delta (times ``scale``,
    in f32). Returns (new_params, new_opt_state)."""
    opt = server_optimizer(fed)
    if isinstance(scale, (int, float)) and float(scale) == 1.0:
        grads = tree_map(lambda d: -d.float(), agg_delta)
    else:
        grads = tree_map(lambda d: -d.float() * scale, agg_delta)
    return opt.update(grads, opt_state, global_params, fed.server_lr)


def aggregate_delta(global_params, client_params, weights, gates, *,
                    fed, key=None, ef_accum=None, reduce=None):
    """Delta-form gated aggregation without the server step:

        d <- agg(cast(w_k - w, fed.agg_dtype))      (one fused fedagg launch)

    reduced by ``fed.aggregator`` (``key`` feeds stochastic aggregators:
    ``aggregator_key(fed, round_idx)``) through ``fed.wire_codec``. With
    ``ef_accum`` (non-identity codecs) it returns ``(delta,
    new_ef_accum)``. Leaves come back in ``fed.agg_dtype``. ``reduce``:
    see ``aggregate_clients``."""
    if fed.agg_dtype not in _AGG_DTYPES:
        raise NotImplementedError(f"agg_dtype={fed.agg_dtype!r}")
    ad = _AGG_DTYPES[fed.agg_dtype]
    deltas = tree_map(lambda ck, g: (ck - g[None]).to(ad),
                      client_params, global_params)
    codec_name = resolve_wire_codec(fed.wire_codec)
    if codec_name == "identity" and ef_accum is not None:
        raise ValueError(
            "ef_accum given but fed.wire_codec='identity': the lossless "
            "wire has no compression residual to accumulate")
    return aggregate_clients(deltas, weights, gates, fused=fed.fused_agg,
                             aggregator=fed.aggregator, fed=fed, key=key,
                             wire_codec=codec_name, ef_accum=ef_accum,
                             reduce=reduce)


def aggregate_updates(global_params, client_params, weights, gates, *,
                      fed, opt_state=(), key=None):
    """Delta-form gated aggregation + the configured server optimizer.
    Returns (new_params, new_opt_state)."""
    agg = aggregate_delta(global_params, client_params, weights, gates,
                          fed=fed, key=key)
    return apply_server_opt(fed, global_params, opt_state, agg)
