"""Kernel dispatch layer. Counterpart of ``repro/kernels/ops.py``: the
reference picks Pallas or its jnp lowering by ``use_pallas``; the port
picks by device inside each wrapper (the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors), so there is no flag here and each
op is its kernel module's wrapper.

* ``fedagg`` — gated client aggregation, one launch for every aggregator
  (mean | trimmed_mean | median | dp) and wire codec (identity | int8 |
  topk | sketch); see ``kernels/fedagg.py`` for the operands of each.
* ``flash_attention`` / ``flash_attention_fwd`` / ``flash_attention_bwd`` —
  causal / windowed GQA attention over a full kv sequence (train and
  prefill): the differentiable op, the forward with the per-row LSE, and
  the backward (dq, dk, dv); ``kernels/flash_attention.py``.
* ``decode_attention`` — one query token against a KV cache with
  ``kv_len`` valid rows; ``kernels/decode_attention.py``.
* ``rmsnorm`` — row-wise RMSNorm, differentiable; ``kernels/rmsnorm.py``.
* ``ssm_scan`` / ``ssm_step`` — the Mamba (S6) selective scan over a
  sequence (train and prefill; optionally its final state) and one decode
  step of it; ``kernels/ssm_scan.py``.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention  # noqa: F401
from repro_torch.kernels.fedagg import fedagg  # noqa: F401
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_bwd, flash_attention_fwd)
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: F401
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_step  # noqa: F401
