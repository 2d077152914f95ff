"""FedALIGN renormalized gated aggregation (paper eq. (15)):

    w <- sum_k p_k I_k w_k / sum_k p_k I_k

over client-stacked parameter dicts. Counterpart of
``repro/core/aggregation.py``. The default fused path flattens the whole
tree into one [C, M_total] buffer and launches the ``fedagg`` kernel once
per round; ``fused=False`` launches it once per leaf. Accumulation is f32
whatever the leaf dtype, so both paths agree to the cast.

The aggregated delta feeds the server optimizer (``apply_server_opt``).
Only the slice of the reference's registries that the FedALIGN round uses
is ported: the ``mean`` aggregator, the ``identity`` wire and the ``sgd``
server optimizer. Names the reference registers beyond those raise
``NotImplementedError``; names it does not know raise ``ValueError``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import register_validator
from repro_torch.kernels import ops as kops
from repro_torch.optim import optimizers as _opt
from repro_torch.utils import (Registry, round_up, tree_leaves, tree_map,
                               tree_unflatten_like)

_AGG_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_UNPORTED = {
    "aggregator": ("trimmed_mean", "median", "dp", "cosine_filter"),
    "wire codec": ("int8", "topk", "sketch"),
    "server optimizer": ("momentum", "adam", "yogi"),
}


def _refuse(registry: Registry, name):
    """NotImplementedError for a name the reference registers but the port
    does not have yet, ValueError (the registry's) for an unknown one."""
    canonical = registry.resolve(name)
    if canonical in _UNPORTED[registry.kind]:
        raise NotImplementedError(
            f"{registry.kind} {canonical!r} is not ported yet; ported: "
            f"{registry.names()}")
    return registry.lookup(name)


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


def flatten_stacked(client_params, dtype=torch.float32):
    """Client-stacked tree ([C, ...] leaves) -> one [C, M_total] buffer.

    The rows are contiguous and start on 16-byte boundaries (the row pitch
    is M_total rounded up), so the kernel can use its widest loads; the
    returned tensor is the [C, M_total] view of that buffer."""
    leaves = tree_leaves(client_params)
    C = leaves[0].shape[0]
    sizes = [leaf[0].numel() for leaf in leaves]
    M = sum(sizes)
    itemsize = torch.empty((), dtype=dtype).element_size()
    buf = torch.empty(C, round_up(max(M, 1), 16 // itemsize), dtype=dtype,
                      device=leaves[0].device)
    off = 0
    for leaf, size in zip(leaves, sizes):
        buf[:, off:off + size].copy_(leaf.reshape(C, -1))
        off += size
    return buf[:, :M]


def aggregate_clients(client_params, weights, gates, *, fused=True,
                      aggregator="mean", fed=None, key=None,
                      wire_codec="identity", ef_accum=None):
    """client_params: tree with leading client axis C on every leaf.

    fused=True (default): one fedagg launch on the [C, M_total] flattening;
    fused=False: one launch per leaf (the parity reference)."""
    check_client_weights(weights)
    leaves = tree_leaves(client_params)
    if not leaves:
        return client_params
    C = leaves[0].shape[0]
    _refuse(AGGREGATORS, aggregator)
    _refuse(WIRE_CODECS, wire_codec)
    if ef_accum is not None:
        raise ValueError(
            "ef_accum (error-feedback rows) only makes sense with a "
            "non-identity wire_codec: the identity wire is lossless, its "
            "residual is exactly zero")

    if not fused:
        agg_leaves = [kops.fedagg(leaf.reshape(C, -1), weights, gates)
                      .reshape(leaf.shape[1:]) for leaf in leaves]
        return tree_unflatten_like(client_params, agg_leaves)

    # a uniform leaf dtype stays on the wire (bf16 deltas stay bf16 in the
    # buffer); mixed-dtype trees go f32. Accumulation is f32 either way.
    dtypes = {leaf.dtype for leaf in leaves}
    buf_dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
    out = kops.fedagg(flatten_stacked(client_params, dtype=buf_dtype),
                      weights, gates)
    agg_leaves, off = [], 0
    for leaf in leaves:
        size = leaf[0].numel()
        agg_leaves.append(
            out[off:off + size].reshape(leaf.shape[1:]).to(leaf.dtype))
        off += size
    return tree_unflatten_like(client_params, agg_leaves)


# ================================================================ aggregators
AGGREGATORS = Registry("aggregator", aliases={None: "mean", "none": "mean"})
WIRE_CODECS = Registry(
    "wire codec", aliases={None: "identity", "": "identity",
                           "none": "identity"})


@AGGREGATORS.register("mean", agg_name="mean", needs_key=False, in_kernel=True)
def _mean(fed, client_deltas, weights, gates, key):
    # the paper rule needs no prepare step: the kernel is the whole reduction
    return weights, gates, {}, None


@WIRE_CODECS.register("identity", codec_name="identity")
def _identity(fed, buf):
    return buf, {}


def resolve_aggregator(name) -> str:
    return AGGREGATORS.resolve(name)


def get_aggregator(name: str) -> Callable:
    return _refuse(AGGREGATORS, name)


def resolve_wire_codec(name) -> str:
    return WIRE_CODECS.resolve(name)


def inclusion_mass(fed, weights, gates):
    """The mean aggregator's denominator mass sum p_k I_k: the aggregate can
    be nonzero iff this is > 0 (the zero-inclusion server skip keys off it)."""
    return torch.sum(weights.float() * gates.float())


@register_validator("aggregator")
def check_aggregator_config(fed):
    """Aggregator, wire codec, server optimizer and wire dtype: the ported
    names pass, the reference's other names raise NotImplementedError."""
    get_aggregator(fed.aggregator)
    _refuse(WIRE_CODECS, fed.wire_codec)
    get_server_optimizer(fed.server_opt)
    if fed.agg_dtype not in _AGG_DTYPES:
        raise NotImplementedError(
            f"agg_dtype={fed.agg_dtype!r}: the fedagg kernel takes "
            f"{sorted(_AGG_DTYPES)}")


# ========================================================= server optimizers
SERVER_OPTIMIZERS = Registry("server optimizer",
                             aliases={None: "sgd", "none": "sgd"})


def resolve_server_opt(name) -> str:
    """Canonical registry name ('none', the legacy no-op, is plain sgd)."""
    return SERVER_OPTIMIZERS.resolve(name)


def get_server_optimizer(name: str) -> Callable:
    return _refuse(SERVER_OPTIMIZERS, name)


def server_optimizer(fed):
    """The configured ServerOptimizer instance for ``fed.server_opt``."""
    return get_server_optimizer(fed.server_opt)(fed)


@SERVER_OPTIMIZERS.register("sgd", opt_name="sgd")
def _server_sgd(fed):
    # w <- w + server_lr * agg_delta: FedAvg at server_lr=1 (the paper rule)
    return _opt.sgd(0.0)


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
                    fed, key=None, ef_accum=None):
    """Delta-form gated aggregation without the server step:

        d <- agg(cast(w_k - w, fed.agg_dtype))      (one fused fedagg launch)

    Returns the aggregated global delta, leaves in ``fed.agg_dtype``."""
    _refuse(WIRE_CODECS, fed.wire_codec)
    if ef_accum is not None:
        raise ValueError(
            "ef_accum given but fed.wire_codec='identity': the lossless "
            "wire has no compression residual to accumulate")
    if fed.agg_dtype not in _AGG_DTYPES:
        raise NotImplementedError(f"agg_dtype={fed.agg_dtype!r}")
    ad = _AGG_DTYPES[fed.agg_dtype]
    deltas = tree_map(lambda ck, g: (ck - g[None]).to(ad),
                      client_params, global_params)
    return aggregate_clients(deltas, weights, gates, fused=fed.fused_agg,
                             aggregator=fed.aggregator, fed=fed, key=key)


def aggregate_updates(global_params, client_params, weights, gates, *,
                      fed, opt_state=(), key=None):
    """Delta-form gated aggregation + the configured server optimizer.
    Returns (new_params, new_opt_state)."""
    agg = aggregate_delta(global_params, client_params, weights, gates,
                          fed=fed, key=key)
    return apply_server_opt(fed, global_params, opt_state, agg)
