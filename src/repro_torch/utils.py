"""Small shared utilities: the Registry, tree math on nested dicts of
tensors, named PRNG sub-keys, parameter counting and device resolution.

Counterpart of ``repro/utils.py``. A "tree" here is a tensor or a (nested)
dict of tensors; leaves are visited in sorted-key order, the order
``jax.tree.leaves`` uses for dicts, so flattening a tree gives the same
layout in both packages.
"""
from __future__ import annotations

import functools
import zlib
from typing import Any, Callable

import torch

from repro_torch import prng

Tree = Any


class Registry(dict):
    """One generic name -> implementation table for every pluggable seam.

    It IS a dict, plus:

    * ``register(name, **attrs)`` — decorator factory; stamps ``attrs`` on
      the function and refuses duplicate names.
    * ``resolve(name)`` — the canonical name with the seam's aliases
      applied (e.g. server optimizer ``None``/``"none"`` -> ``"sgd"``).
    * ``lookup(name)`` — resolve + fetch, raising the one consistent
      unknown-name error that lists the valid entries.
    * ``names()`` — sorted registered names.
    """

    def __init__(self, kind: str, *, aliases: dict | None = None):
        super().__init__()
        self.kind = kind
        self.aliases = dict(aliases or {})

    def register(self, name: str, **attrs):
        def deco(fn):
            if name in self:
                raise ValueError(f"duplicate {self.kind} {name!r}")
            for k, v in attrs.items():
                setattr(fn, k, v)
            self[name] = fn
            return fn
        return deco

    def resolve(self, name):
        return self.aliases.get(name, name)

    def lookup(self, name):
        canonical = self.resolve(name)
        if canonical not in self:
            raise ValueError(
                f"unknown {self.kind} {name!r}; registered: {self.names()}")
        return self[canonical]

    def names(self) -> list:
        return sorted(self)


# ------------------------------------------------------------------ devices
def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Asking for CUDA where there is no
    card raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asked for a CUDA card but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev


# ---------------------------------------------------------------- tree math
def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over dicts with identical key sets."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)) and not tree:
        return []
    return [tree]


def tree_unflatten_like(like: Tree, leaves: list) -> Tree:
    """Rebuild a tree shaped like ``like`` from leaves in sorted-key order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_scale(tree: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, tree)


def tree_axpy(a, x: Tree, y: Tree) -> Tree:
    """a * x + y, leafwise."""
    return tree_map(lambda xi, yi: a * xi + yi, x, y)


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    leaves = tree_leaves(tree_map(lambda x, y: torch.sum(x * y), a, b))
    return functools.reduce(torch.add, leaves)


def tree_sq_norm(tree: Tree) -> torch.Tensor:
    return tree_dot(tree, tree)


def tree_cast(tree: Tree, dtype) -> Tree:
    return tree_map(lambda x: x.to(dtype), tree)


def param_count(tree: Tree) -> int:
    return int(sum(x.numel() for x in tree_leaves(tree)))


def param_bytes(tree: Tree) -> int:
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))


def fold_in_name(key: torch.Tensor, name: str) -> torch.Tensor:
    """Derive a named sub-key deterministically from a string.

    Uses crc32, NOT python's builtin ``hash`` (salted per process), so the
    key is the same in every process and equal to ``repro.utils``'s."""
    return prng.fold_in(key, zlib.crc32(name.encode()) % (2**31 - 1))


def split_like(key: torch.Tensor, names: list[str]) -> dict[str, torch.Tensor]:
    return {n: fold_in_name(key, n) for n in names}


def has_nan(tree: Tree) -> torch.Tensor:
    out = torch.tensor(False)
    for x in tree_leaves(tree):
        if x.is_floating_point():
            out = out | torch.isnan(x).any().cpu()
    return out


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b
