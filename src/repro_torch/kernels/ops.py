"""Kernel dispatch layer. Counterpart of ``repro/kernels/ops.py``: the
reference picks Pallas or its jnp lowering by ``use_pallas``; the port
picks by device inside each wrapper (the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors), so there is no flag here.

Only the ``mean`` aggregator with the ``identity`` wire is ported; the
robust, private and compressed variants raise ``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.kernels import fedagg as _fedagg

_UNPORTED_AGGREGATORS = ("trimmed_mean", "median", "dp")
_UNPORTED_CODECS = ("int8", "topk", "sketch")


def fedagg(updates, weights, gates, *, aggregator="mean", codec="identity"):
    """Gated client aggregation: [C,M],[C],[C] -> [M] (one launch)."""
    if codec != "identity":
        if codec in _UNPORTED_CODECS:
            raise NotImplementedError(
                f"fedagg codec={codec!r} is not ported yet (identity only)")
        raise ValueError(f"unknown wire codec {codec!r}")
    if aggregator != "mean":
        if aggregator in _UNPORTED_AGGREGATORS:
            raise NotImplementedError(
                f"fedagg aggregator={aggregator!r} is not ported yet "
                "(mean only)")
        raise ValueError(f"unknown in-kernel aggregator {aggregator!r}")
    return _fedagg.fedagg(updates, weights, gates)
