"""Pytree checkpoints in the reference's msgpack format.

Counterpart of ``repro/checkpoint/io.py``, file for file: a checkpoint is
the msgpack map ``{"treedef": str, "step": int or None, "leaves": [...],
"meta": dict or None}``, each leaf the map ``{b"__nd__": True, b"dtype":
numpy dtype string, b"shape": [...], b"data": raw little-endian bytes}``
(bin keys, as the reference's ``use_bin_type`` writes them). The port
writes through its own codec (``checkpoint.codec``), byte for byte what
``msgpack.packb(payload, default=_encode)`` writes, and reads what the
reference writes, in both directions.

A tree here is the port's (a tensor, a numpy array, a dict, list or
tuple of trees, or a dataclass such as ``FederationState``, whose fields
are visited in declaration order); leaves are flattened in
``jax.tree.flatten``'s order (dict keys sorted, ``()`` holds none), and
``treedef`` is the string ``str(treedef)`` the reference writes for the
same structure. Tensors are copied to the host; a bfloat16 leaf is
written as the two raw bytes of each element with dtype ``'<V2'``, the
string the reference writes for ml_dtypes' bfloat16 (numpy reads it back
as a 2-byte void, which ``load_pytree`` views as bfloat16 again).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import codec

_BF16 = np.dtype("V2")


def _encode(obj):
    if isinstance(obj, np.ndarray):
        dtype = "<V2" if obj.dtype == _BF16 else obj.dtype.str
        return {b"__nd__": True, b"dtype": dtype,
                b"shape": list(obj.shape), b"data": obj.tobytes()}
    raise TypeError(type(obj))


def _decode(obj):
    if b"__nd__" in obj:
        return np.frombuffer(obj[b"data"], dtype=np.dtype(obj[b"dtype"])
                             ).reshape(obj[b"shape"]).copy()
    return obj


def _is_leaf(t) -> bool:
    return not isinstance(t, (dict, list, tuple)) and not (
        dataclasses.is_dataclass(t) and not isinstance(t, type))


def flatten(tree: Any):
    """(leaves, treedef string) in ``jax.tree.flatten``'s order and
    spelling."""
    leaves: list = []

    def walk(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            inner = [walk(x) for x in t]
            return "(" + ", ".join(inner) + "," * (len(inner) == 1) + ")"
        if isinstance(t, list):
            return "[" + ", ".join(walk(x) for x in t) + "]"
        if not _is_leaf(t):
            kids = [walk(getattr(t, f.name)) for f in dataclasses.fields(t)]
            return (f"CustomNode({type(t).__name__}[()], ["
                    + ", ".join(kids) + "])")
        leaves.append(t)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def unflatten_like(like: Any, leaves: list) -> Any:
    """A tree shaped like ``like`` from leaves in ``flatten`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        if not _is_leaf(t):
            return dataclasses.replace(t, **{
                f.name: build(getattr(t, f.name))
                for f in dataclasses.fields(t)})
        return next(it)

    return build(like)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, np.ndarray):
        return leaf
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(_BF16)
    return t.contiguous().numpy()


def _from_host(arr: np.ndarray, like, device):
    """``arr`` as a tensor of ``like``'s dtype on ``device``."""
    like = torch.as_tensor(like)
    if like.dtype == torch.bfloat16 and arr.dtype == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        # converted by numpy first: the '<u4' of a PRNG key into the
        # port's int64 key words, value for value
        want = torch.empty(0, dtype=like.dtype).numpy().dtype
        t = torch.from_numpy(np.asarray(arr, dtype=want))
    return t.to(device=device)


def save_pytree(path: str, tree: Any, step: int | None = None,
                meta: dict | None = None) -> None:
    """Write ``tree`` (leaves copied to the host) with ``step`` and the
    plain dict ``meta`` of writer-side facts the reader may validate, to
    ``path`` through ``path + ".tmp"`` and ``os.replace``: a reader never
    sees half a file."""
    leaves, treedef = flatten(tree)
    payload = {"treedef": treedef, "step": step,
               "leaves": [_to_host(x) for x in leaves], "meta": meta}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(codec.packb(payload, default=_encode))
    os.replace(tmp, path)


def load_pytree(path: str, like: Any, device="cuda"):
    """Restore into the structure of ``like``: each leaf gets the dtype of
    ``like``'s and goes to ``device``. Returns ``(tree, step, meta)``.
    A leaf count or a leaf shape that differs from ``like``'s raises the
    reference's ``ValueError`` (a config whose state layout differs from
    the writer's: the server optimizer's moments, ``num_clients``,
    ``async_depth``, ``adaptive_staleness``, ``latency_mode``,
    ``divergence_guard``, ``wire_codec`` / ``error_feedback``). Knobs that
    change no shape are the writer's ``meta`` and
    ``fl.simulator.load_federation_state``'s to check."""
    with open(path, "rb") as f:
        payload = codec.unpackb(f.read(), object_hook=_decode)
    leaves, _ = flatten(like)
    new_leaves = payload["leaves"]
    if len(new_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint {path!r} holds {len(new_leaves)} leaves but the "
            f"requested structure has {len(leaves)} — was it written with a "
            "different config (server_opt moment layout, async_depth "
            "in-flight buffer, adaptive_staleness last_delta sketch, "
            "wire_codec/error_feedback ef_accum accumulator leaves, "
            "num_clients)?")
    out = []
    for i, (old, new) in enumerate(zip(leaves, new_leaves)):
        if tuple(new.shape) != tuple(old.shape):
            raise ValueError(
                f"checkpoint {path!r} leaf {i} has shape "
                f"{tuple(new.shape)} but the requested structure expects "
                f"{tuple(old.shape)} — config/state layout mismatch "
                "(e.g. a resume with a different async_depth, "
                "adaptive_staleness/sketch_dim, wire_codec/error_feedback "
                "ef_accum layout, or client count than the run that wrote "
                "the checkpoint)")
        out.append(_from_host(new, old, device))
    return (unflatten_like(like, out), payload.get("step"),
            payload.get("meta"))
