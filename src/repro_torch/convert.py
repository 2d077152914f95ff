"""Move parameter trees between the JAX package and the port as numpy.

``params_from_jax(np_tree, device)`` takes a reference parameter pytree
whose leaves were turned into numpy arrays (``jax.tree.map(np.asarray,
params)``) and returns the port's dict of tensors; ``params_to_numpy``
goes back. Layouts are the same on both sides, so this is a copy, not a
transposition. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import resolve_device, tree_map


def params_from_jax(np_tree, device="cuda"):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev),
                    np_tree)


def params_to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays (on the host;
    bfloat16 leaves come back as float32, which numpy can hold)."""
    def to_np(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(to_np, tree)
