"""Partition-spec assignment for parameters, batches, caches and the
federation state.

Counterpart of ``repro/sharding/specs.py``, rule for rule: a name-rule +
divisibility-fallback engine. Leaf names carry layout intent
(column-parallel for input projections, row-parallel for output
projections, expert / tensor parallel for MoE); whenever the preferred dim
is not divisible by the mesh axis, the engine falls back to the largest
divisible dim, then to replication.

A spec is a ``PartitionSpec``: a tuple with one entry per tensor dim, each
``None``, an axis name or a tuple of axis names, as JAX's has it. The mesh
argument needs only ``.shape`` (an axis name -> size mapping) and
``axis_names``; a ``torch.distributed.device_mesh.DeviceMesh`` works too
(its ``mesh_dim_names`` and size tuple). So the production meshes of
``launch/mesh.py: production_mesh_shape`` need no process group at all.

``placements`` turns a spec into the DTensor ``Shard`` / ``Replicate`` list
over a DeviceMesh's dims, and ``local_shape`` gives one device's shard of a
shape under a spec.

Trees are the port's: dicts, lists and tuples of tensors (or anything with
a ``.shape``; a host int, as a cache's ``len``, is a 0-d leaf), and
``fl.engine.FederationState``.
"""
from __future__ import annotations

import dataclasses
import math
import re
from collections.abc import Mapping

# name -> preferred dim (negative = from the end) for the MODEL axis
_MODEL_DIM_RULES: list[tuple[str, int]] = [
    (r"^(wq|wk|wv|bq|bk|bv|wq_b|wkv_b|w_gate|w_up|b_up|w_in|w_gates|b_gates|"
     r"w_dtproj|lm_head|conv_w|conv_b)$", -1),
    (r"^(wo|w_out|w_xproj|w_if)$", 0),
    (r"^(w_down|b_down)$", 0),          # 2D [dff, d]; 3D handled below
    (r"^(embed|pos_dec|pos_enc)$", 0),  # vocab/position dim; fallback -> d
    (r"^(dt_bias|D|gn_scale)$", 0),
]

_REPLICATE = re.compile(r"^(scale|bias|w_router|A_log|r_gates|b_if|wq_a|wkv_a)$")

_STACKED = ("periods", "enc_blocks", "dec_blocks")


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name or a tuple of names; a
    tuple of one name is that name, as JAX's ``PartitionSpec`` keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


# ----------------------------------------------------------------- meshes
def mesh_axes(mesh) -> dict:
    """{axis name: size}, in the mesh's axis order."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    return dict(zip(names, tuple(shape)))


def dp_axes(mesh) -> tuple:
    """Mesh axes carrying clients / data parallelism."""
    return tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))


def dp_size(mesh) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def local_shape(shape, spec, mesh_shape) -> tuple:
    """One device's shard of ``shape`` under ``spec`` on a mesh of
    ``mesh_shape`` (an axis -> size mapping, or a mesh): each sharded dim
    divided by the product of its axes' sizes, rounded up as an uneven
    shard's first device holds it."""
    sizes = (mesh_axes(mesh_shape) if hasattr(mesh_shape, "shape")
             else dict(mesh_shape))
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _entry_axes(entry))
        out[d] = -(-out[d] // n)
    return tuple(out)


def placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` over ``mesh``'s dims: ``Shard(d)``
    on each mesh dim that a tensor dim d is split over, else
    ``Replicate()``. A dim split over several axes names them in the
    mesh's order (the major axis first, as JAX splits it)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} lists its axes out of the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


# ------------------------------------------------------------- tree walks
def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, PartitionSpec):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_specs_map(fn, tree):
    """``fn(leaf)`` over every leaf of ``tree`` (a spec counts as a leaf)."""
    return _map_with_path(lambda _p, leaf: fn(leaf), tree)


def spec_pairs(tree, specs):
    """(leaf, spec) over a tree and its spec tree, in the spec tree's
    order (a spec is a leaf; a FederationState walks its fields)."""
    if isinstance(specs, PartitionSpec):
        yield tree, specs
    elif isinstance(specs, dict):
        for k in specs:
            yield from spec_pairs(tree[k], specs[k])
    elif isinstance(specs, (list, tuple)):
        for a, b in zip(tree, specs, strict=True):
            yield from spec_pairs(a, b)
    elif dataclasses.is_dataclass(specs):
        for f in dataclasses.fields(specs):
            yield from spec_pairs(getattr(tree, f.name),
                                  getattr(specs, f.name))
    else:
        raise TypeError(f"unexpected spec {specs!r}")


def _stack_offset(path) -> int:
    """Leaves under 'periods' / stacked inits carry a leading stack axis."""
    return 1 if any(isinstance(k, str) and k in _STACKED for k in path) else 0


def _leaf_name(path) -> str:
    for k in reversed(path):
        if isinstance(k, str):
            return k
    return ""


def _try_assign(spec: list, shape, dim: int, axis, size: int) -> bool:
    if dim < 0:
        dim += len(shape)
    if 0 <= dim < len(shape) and spec[dim] is None \
            and shape[dim] % size == 0 and shape[dim] >= size:
        spec[dim] = axis
        return True
    return False


def _fallback_assign(spec: list, shape, axis, size: int,
                     skip: tuple = ()) -> bool:
    cands = [i for i in range(len(shape))
             if spec[i] is None and i not in skip
             and shape[i] % size == 0 and shape[i] >= size]
    if not cands:
        return False
    i = max(cands, key=lambda j: shape[j])
    spec[i] = axis
    return True


# ------------------------------------------------------------------ specs
def _param_spec(path, leaf, mesh, *, fsdp: bool,
                expert_parallel: bool) -> PartitionSpec:
    sizes = mesh_axes(mesh)
    name = _leaf_name(path)
    off = _stack_offset(path)
    shape = _shape(leaf)[off:]
    spec: list = [None] * len(shape)
    msize = sizes["model"]

    if not _REPLICATE.match(name) and len(shape) > 0:
        placed = False
        # MoE expert tensors [E, d, f] / [E, f, d]
        if len(shape) == 3 and name in ("w_gate", "w_up", "w_down"):
            if expert_parallel and shape[0] % msize == 0:
                placed = _try_assign(spec, shape, 0, "model", msize)
            if not placed:
                dim = 1 if name == "w_down" else 2     # the dff dim
                placed = _try_assign(spec, shape, dim, "model", msize)
        if not placed:
            for pat, dim in _MODEL_DIM_RULES:
                if re.match(pat, name):
                    placed = _try_assign(spec, shape, dim, "model", msize)
                    break
        if not placed:
            placed = _fallback_assign(spec, shape, "model", msize)
        if fsdp and len(shape) >= 2 and "data" in sizes:
            _fallback_assign(spec, shape, "data", sizes["data"])

    return P(*([None] * off + spec))


def auto_param_specs(param_shapes, mesh, *, fsdp: bool = False,
                     expert_parallel: bool = False):
    """A tree of params (or their meta shapes) -> the same tree of specs."""
    return _map_with_path(
        lambda p, leaf: _param_spec(p, leaf, mesh, fsdp=fsdp,
                                    expert_parallel=expert_parallel),
        param_shapes)


def auto_batch_specs(batch_shapes, mesh, *, batch_dim: int = 0):
    """Shard the batch dim over (pod, data) when divisible, else replicate."""
    dp, dpsize = dp_axes(mesh), dp_size(mesh)

    def one(leaf):
        shape = _shape(leaf)
        spec = [None] * len(shape)
        if len(shape) > batch_dim and shape[batch_dim] % dpsize == 0 \
                and shape[batch_dim] >= dpsize:
            spec[batch_dim] = dp
        return P(*spec)
    return tree_specs_map(one, batch_shapes)


def auto_tree_specs(shapes, mesh, *, prefer_batch_dim: int = 0,
                    model_dim_order: str = "largest"):
    """Generic (e.g. KV caches): batch dim over dp when divisible, model on
    a remaining divisible dim, else dp on largest (long caches).

    model_dim_order:
      'largest' — largest divisible dim (decode caches: shards the long
                  cache axis)
      'last'    — innermost dims first (prefill cache outputs: k / v leave
                  the projections sharded on KV*hd)
    """
    dp, dpsize = dp_axes(mesh), dp_size(mesh)
    msize = mesh_axes(mesh)["model"]

    def one(path, leaf):
        off = _stack_offset(path)
        body = _shape(leaf)[off:]
        spec: list = [None] * len(body)
        used_dp = False
        if len(body) > prefer_batch_dim and body[prefer_batch_dim] % dpsize == 0 \
                and body[prefer_batch_dim] >= dpsize:
            spec[prefer_batch_dim] = dp
            used_dp = True
        if len(body) > 1:
            if model_dim_order == "last":
                placed = False
                for dim in range(len(body) - 1, prefer_batch_dim, -1):
                    if _try_assign(spec, body, dim, "model", msize):
                        placed = True
                        break
                if not placed:
                    _fallback_assign(spec, body, "model", msize,
                                     skip=(prefer_batch_dim,))
            else:
                _fallback_assign(spec, body, "model", msize,
                                 skip=(prefer_batch_dim,))
        if not used_dp and len(body) > 1:
            _fallback_assign(spec, body, dp, dpsize, skip=(prefer_batch_dim,))
        return P(*([None] * off + spec))

    return _map_with_path(one, shapes)


def federation_state_specs(fed, param_specs):
    """The spec tree of an ``fl.engine.FederationState``, field for field
    the reference's: server-optimizer moments inherit their param's spec;
    the [C] client vectors (backlog, EMAs, latencies) and scalar counters
    replicate; the ``scan_async`` in-flight deltas and the wire codec's
    error-feedback rows are params-shaped behind a leading unsplit axis
    (ring slot, client), so they shard as the params they update. The
    drift sketch replicates. ``candidate_pool`` adds no leaf."""
    from repro_torch.core.aggregation import (resolve_server_opt,
                                              resolve_wire_codec)
    from repro_torch.fl.engine import FederationState

    def lead(specs):
        return tree_specs_map(lambda sp: P(*([None] + list(sp))), specs)

    name = resolve_server_opt(fed.server_opt)
    rep = P()
    if name == "sgd" or (name == "momentum" and fed.server_momentum == 0.0):
        # the stateless update: momentum 0 collapses to sgd's ()
        opt_specs = ()
    elif name == "momentum":
        opt_specs = {"m": param_specs}
    else:                                   # adam / yogi: m, v, step counter
        opt_specs = {"m": param_specs, "v": param_specs, "t": rep}
    if fed.async_depth > 0:
        inflight_specs = {"delta": lead(param_specs), "valid": rep, "age": rep}
        if fed.latency_mode != "none":
            inflight_specs["timer"] = rep
    else:
        inflight_specs = ()
    last_delta_specs = (rep if fed.async_depth > 0 and fed.adaptive_staleness
                        else ())
    latency_specs = ({"compute": rep, "net": rep}
                     if fed.latency_mode != "none" else ())
    skips_specs = rep if fed.divergence_guard else ()
    if resolve_wire_codec(fed.wire_codec) != "identity" and fed.error_feedback:
        ef_specs = lead(param_specs)
    else:
        ef_specs = ()
    return FederationState(params=param_specs, opt_state=opt_specs,
                           backlog=rep, util_ema=rep, incl_ema=rep,
                           inflight=inflight_specs,
                           last_delta=last_delta_specs,
                           latency=latency_specs,
                           nonfinite_skips=skips_specs,
                           ef_accum=ef_specs)
