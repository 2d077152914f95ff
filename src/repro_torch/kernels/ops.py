"""Kernel dispatch layer. Counterpart of ``repro/kernels/ops.py``: the
reference picks Pallas or its jnp lowering by ``use_pallas``; the port
picks by device inside each wrapper (the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors), so there is no flag here and each
op is its kernel module's wrapper.

``fedagg`` — gated client aggregation, one launch for every aggregator
(mean | trimmed_mean | median | dp) and wire codec (identity | int8 | topk
| sketch); see ``kernels/fedagg.py`` for the operands of each.
"""
from __future__ import annotations

from repro_torch.kernels.fedagg import fedagg  # noqa: F401
