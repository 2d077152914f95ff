"""The model axis: tensor-parallel params over ``"model"`` for the dense
GQA family (qwen1.5-0.5b, qwen2.5-3b, phi3-mini-3.8b), by explicit local
shards and Megatron's operators.

The counterpart of what GSPMD inserts when the reference runs its round
over a ``(data, model)`` mesh with the params placed by
``sharding/specs.py: auto_param_specs``. Each rank of a model group holds
its shard of every leaf, exactly as the specs place it:

* column-parallel (the last dim split): ``wq``, ``wk``, ``wv``, ``bq``,
  ``bk``, ``bv``, ``w_gate``, ``w_up``, ``lm_head``;
* row-parallel (the first dim split): ``wo``, ``w_down``;
* vocab-parallel (the vocab rows split): ``embed``;
* replicated: the norm scales.

A leaf the specs place off that dim (their largest-divisible fallback)
raises ``NotImplementedError`` (ROADMAP A17b), as does every other arch.

Activations between the tensor-parallel regions are replicated: every
rank holds the same [B, S, d] rows, and every replicated tensor's gradient
is whole on every rank. The operators, each a pair of
``torch.autograd.Function``s:

* ``copy`` (f): forward the identity, backward the all-reduce of the
  gradient (a replicated input entering a region whose ranks use it
  differently);
* ``reduce`` (g): forward the all-reduce, backward the identity (the
  partial products of a row-parallel layer summed);
* ``gather_cols``: forward the all-gather of the last dim, backward the
  rank's slice (the gathered tensor is used alike on every rank, or
  passes through ``copy`` first);
* ``seq_from_heads`` / ``heads_from_seq``: the all-to-all between the
  heads layout (all S rows, the rank's columns) and the sequence layout
  (the rank's S / m rows, all columns), each the other's backward.

``vocab_embed`` is the vocab-parallel lookup (a masked gather of the
local rows and an all-reduce); ``vocab_xent`` the vocab-parallel
cross-entropy of one chunk (the all-reduced max, then one all-reduce of
the sum of exponentials and the gold logit, which only its owner holds).

Every collective a ``ModelAxis`` runs is appended to ``COLLECTIVES`` (which
``fl/sharded.py`` re-exports) with its group (``"model"``) and bytes, as
the dp collectives are; ``loss_plan`` predicts them for one loss (forward
only, or a training step's forward, remat recompute and backward) from
the config and the batch shape. ``shard_params`` / ``gather_params`` move
a tree to and from this rank's shards.

The transport is the process group's (NCCL, or gloo where two ranks
share one card): every collective used here is one that gloo carries for
CUDA tensors as well (``scripts/gloo_cuda_probe.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.sharding.specs import (PartitionSpec, auto_param_specs,
                                        mesh_axes, spec_pairs)

MODEL = "model"
# Every collective a pod round issued in this process, in order: {"kind":
# "all_gather" | "all_reduce" | "all_to_all", "group": the dp axes or
# "model", "bytes": the gathered, reduced or exchanged tensor's}. A
# counter as the kernels' ``launches``; clear it to count a run.
COLLECTIVES: list = []

# the leaf -> the dim its spec must split over "model" (None: replicated)
_COLUMN = ("wq", "wk", "wv", "bq", "bk", "bv", "w_gate", "w_up", "lm_head")
_ROW = ("wo", "w_down", "embed")
_REPLICATED = ("scale",)


def _refuse(what):
    raise NotImplementedError(f"the model axis: {what} is not ported yet "
                              "(ROADMAP A17b)")


def check_model(cfg, m: int):
    """Only the dense GQA family runs on a model axis m > 1: MoE, MLA,
    jamba, xlstm, the encoder-decoder and llava's image inputs raise, and
    so do query heads that do not divide the axis without
    ``seq_shard_attn``."""
    kind = ("enc-dec" if cfg.encdec else "MoE" if cfg.moe else "MLA"
            if cfg.mla else "llava's image inputs" if cfg.vlm
            else cfg.pattern if cfg.pattern != "attn" else None)
    if kind is not None or cfg.first_dense:
        _refuse(f"{cfg.name} ({kind or 'leading dense blocks'}) on a model "
                f"axis of {m}")
    if cfg.num_heads % m and not cfg.seq_shard_attn:
        _refuse(f"{cfg.name}'s {cfg.num_heads} query heads on a model axis of "
                f"{m} without seq_shard_attn")


def _leaf_name(path):
    return next((k for k in reversed(path) if isinstance(k, str)), "")


def _walk(tree, specs, path=()):
    """(path, leaf, spec) over a tree and its spec tree."""
    if isinstance(specs, PartitionSpec):
        yield path, tree, specs
    elif isinstance(specs, dict):
        for k in specs:
            yield from _walk(tree[k], specs[k], path + (k,))
    else:
        for i, (a, b) in enumerate(zip(tree, specs, strict=True)):
            yield from _walk(a, b, path + (i,))


def check_specs(shapes, specs):
    """Every leaf placed on the dim its layer reads it by (see the module
    note); a fallback placement raises (A17b)."""
    for path, leaf, spec in _walk(shapes, specs):
        name = _leaf_name(path)
        off = 1 if "periods" in path else 0
        want = [None] * (len(leaf.shape) - off)
        if name in _COLUMN:
            want[-1] = MODEL
        elif name in _ROW:
            want[0] = MODEL
        elif name not in _REPLICATED:
            _refuse(f"leaf {'/'.join(map(str, path))}")
        if tuple(spec[off:]) != tuple(want) or any(spec[:off]):
            _refuse(f"leaf {'/'.join(map(str, path))} placed {spec} (its "
                    f"layer reads it split as {PartitionSpec(*want)}; the "
                    "specs fell back to another dim)")


def param_specs(cfg, mesh):
    """``auto_param_specs`` of ``cfg``'s params on ``mesh``, checked."""
    from repro_torch.models.registry import param_shapes
    shapes = param_shapes(cfg)
    specs = auto_param_specs(shapes, mesh)
    check_specs(shapes, specs)
    return specs


# ------------------------------------------------------- params <-> shards
def _chunk(spec, mesh, coords):
    """[(dim, index, count)] of this rank's chunk on each split dim."""
    names = list(mesh_axes(mesh))
    sizes = mesh_axes(mesh)
    out = []
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx, n = 0, 1
        for a in axes:
            idx = idx * sizes[a] + coords[names.index(a)]
            n *= sizes[a]
        out.append((d, idx, n))
    return out


def shard_params(params, specs, mesh):
    """This rank's local leaves of ``params`` (whole, identical on every
    rank) under ``specs``: each split dim narrowed to the rank's chunk
    (mesh-major order over the entry's axes, as JAX splits), cloned so the
    whole leaves can be freed."""
    coords = mesh.get_coordinate()

    def one(leaf, spec):
        for d, idx, n in _chunk(spec, mesh, coords):
            size = leaf.shape[d]
            if size % n:
                raise ValueError(f"dim {d} of {tuple(leaf.shape)} does not "
                                 f"split into {n}")
            leaf = leaf.narrow(d, idx * (size // n), size // n)
        return leaf.clone()
    return _map2(one, params, specs)


def gather_params(local, specs, mesh):
    """The whole leaves from every rank's shards (``shard_params``'
    inverse): one all-gather over the mesh dim of each split dim, on every
    rank. Not a round's collective: nothing is recorded."""
    import torch.distributed as dist

    def one(leaf, spec):
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            if isinstance(entry, tuple):
                raise NotImplementedError(f"gather_params: dim {d} split over "
                                          f"{entry}")
            group = mesh.get_group(entry)
            n = dist.get_world_size(group)
            parts = leaf.movedim(d, 0).contiguous()
            out = parts.new_empty((n * parts.shape[0],) + parts.shape[1:])
            dist.all_gather_into_tensor(out, parts, group=group)
            leaf = out.movedim(0, d)
        return leaf.contiguous()
    return _map2(one, local, specs)


def _map2(fn, tree, specs):
    if isinstance(specs, PartitionSpec):
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: _map2(fn, tree[k], specs[k]) for k in specs}
    return type(specs)(_map2(fn, a, b) for a, b in zip(tree, specs, strict=True))


def replicated_leaves(tree, specs):
    """The leaves every rank of a model group holds whole."""
    return [leaf for leaf, spec in spec_pairs(tree, specs)
            if all(e is None for e in spec)]


# ------------------------------------------------------------ the group
class ModelAxis:
    """One rank of a model group: its index ``rank`` of ``size``, the
    group's collectives (each recorded in ``COLLECTIVES``)
    and the tensor-parallel operators over them."""

    def __init__(self, group):
        import torch.distributed as dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    # raw collectives
    def _record(self, kind, t):
        COLLECTIVES.append({"kind": kind, "group": MODEL,
                            "bytes": t.numel() * t.element_size()})

    def all_reduce(self, x, op="sum"):
        import torch.distributed as dist
        dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group=self.group)
        self._record("all_reduce", x)
        return x

    def all_gather_last(self, x):
        """[..., n] on each rank -> [..., size * n], rank order."""
        import torch.distributed as dist
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=self.group)
        self._record("all_gather", out)
        out = out.reshape((self.size,) + tuple(x.shape))
        return out.movedim(0, -2).reshape(tuple(x.shape[:-1])
                                          + (self.size * x.shape[-1],))

    def all_to_all(self, x):
        """[size, ...]: chunk j goes to rank j; returns [size, ...], chunk i
        from rank i."""
        import torch.distributed as dist
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        self._record("all_to_all", out)
        return out

    def all_true(self, flag):
        """A 0-d bool agreed by the group: true where it holds on every
        rank (the divergence guard's finite flag over the shards)."""
        t = flag.to(torch.int32).reshape(1)
        return self.all_reduce(-t, "max").reshape(()) == -1

    # the operators
    def copy(self, x):
        return _Copy.apply(x, self)

    def reduce(self, x):
        return _Reduce.apply(x, self)

    def gather_cols(self, x):
        return _GatherCols.apply(x, self)

    def seq_from_heads(self, x):
        return _SeqFromHeads.apply(x, self)

    def heads_from_seq(self, x):
        return _HeadsFromSeq.apply(x, self)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.all_reduce(g.contiguous().clone()), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return ax.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax, ctx.n = ax, x.shape[-1]
        return ax.all_gather_last(x)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.ax.rank, ctx.n
        return g[..., r * n:(r + 1) * n].contiguous(), None


def _seq_from_heads(ax, x):
    """[B, S, N] (the rank's N columns of every row) -> [B, S / m, m N]
    (the rank's S / m rows of every column)."""
    B, S, N = x.shape
    m = ax.size
    if S % m:
        raise ValueError(f"seq_shard_attn: {S} rows do not split over the "
                         f"{m} ranks of the model axis")
    parts = x.reshape(B, m, S // m, N).movedim(1, 0)           # [m, B, S/m, N]
    got = ax.all_to_all(parts)                                 # from rank i: its cols
    return got.permute(1, 2, 0, 3).reshape(B, S // m, m * N)


def _heads_from_seq(ax, x):
    """``_seq_from_heads``' inverse: [B, S / m, m N] -> [B, S, N]."""
    B, Sl, mN = x.shape
    m = ax.size
    parts = x.reshape(B, Sl, m, mN // m).permute(2, 0, 1, 3)   # [m, B, S/m, N]
    got = ax.all_to_all(parts)                                 # from rank i: its rows
    return got.movedim(0, 1).reshape(B, m * Sl, mN // m)


class _SeqFromHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _seq_from_heads(ax, x)

    @staticmethod
    def backward(ctx, g):
        return _heads_from_seq(ctx.ax, g), None


class _HeadsFromSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _heads_from_seq(ax, x)

    @staticmethod
    def backward(ctx, g):
        return _seq_from_heads(ctx.ax, g), None


# ------------------------------------------------ vocab-parallel layers
def vocab_embed(ax, table, tokens):
    """``table`` [V / m, d]: this rank's vocab rows. The rows of the tokens
    it owns, zero elsewhere, summed over the group: the whole lookup on
    every rank (one all-reduce of [B, S, d] in the table's dtype)."""
    n = table.shape[0]
    local = tokens - ax.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return ax.reduce(torch.where(inside[..., None], rows,
                                 torch.zeros((), dtype=rows.dtype,
                                             device=rows.device)))


class _VocabXent(torch.autograd.Function):
    """Per-row logsumexp(logits) - logits[label] of logits whose vocab
    columns are split over the group; ``logits`` [..., V / m] f32, this
    rank's columns from ``v0``."""

    @staticmethod
    def forward(ctx, logits, labels, v0, ax):
        n = logits.shape[-1]
        m = ax.all_reduce(torch.amax(logits, dim=-1), "max")
        local = labels - v0
        inside = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)
        gold = torch.where(inside, torch.gather(logits, -1, idx[..., None])[..., 0],
                           torch.zeros((), device=logits.device))
        both = torch.stack([torch.sum(torch.exp(logits - m[..., None]), dim=-1),
                            gold])
        both = ax.all_reduce(both)
        logz = m + torch.log(both[0])
        ctx.save_for_backward(logits, logz, idx, inside)
        return logz - both[1]

    @staticmethod
    def backward(ctx, g):
        logits, logz, idx, inside = ctx.saved_tensors
        d = torch.exp(logits - logz[..., None]) * g[..., None]
        d.scatter_add_(-1, idx[..., None],
                       -(g * inside.to(g.dtype))[..., None])
        return d, None, None, None


def vocab_xent(ax, logits, labels, v0):
    return _VocabXent.apply(logits, labels, v0, ax)


# ------------------------------------------------------- the plan of a loss
@dataclasses.dataclass(frozen=True)
class LossPlan:
    """What ``pod_round_plan`` needs of the model axis: the config, the
    group's size and the [b, S] token shapes of a client's batch and the
    server batch."""
    cfg: object
    size: int
    client: tuple
    server: tuple

    def loss(self, shape, *, train: bool) -> list:
        return loss_plan(self.cfg, self.size, *shape, train=train)


def _entry(kind, nbytes):
    return {"kind": kind, "group": MODEL, "bytes": int(nbytes)}


def kv_whole(cfg, m) -> bool:
    """k and v are gathered whole before the kernel: under seq_shard_attn,
    or where the spec splits wk / wv inside a kv head (KV % m)."""
    return bool(cfg.seq_shard_attn) or cfg.num_kv_heads % m != 0


def loss_plan(cfg, m, b, S, *, train: bool) -> list:
    """The model collectives of one ``loss_fn`` on [b, S] tokens, in the
    order they run: the forward alone (``train`` False: the eval pass and the
    server loss, no graph) or a local step (its forward, then the
    backward: the loss's, then each period's remat recompute and its
    backward, last layer first)."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cd = torch.empty((), dtype=cfg.cdtype).element_size()
    pd = torch.empty((), dtype=cfg.pdtype).element_size()
    act = b * S * d * cd                          # a [b, S, d] activation
    kv_bytes = 2 * b * S * KV * hd * cd           # k and v, stacked, whole
    q_bytes = b * S * H * hd * cd                 # q or the output, whole
    seq = bool(cfg.seq_shard_attn)
    gather = kv_whole(cfg, m)

    attn_fwd = []
    if seq:
        attn_fwd.append(_entry("all_to_all", q_bytes // m))
    if gather:
        attn_fwd.append(_entry("all_gather", kv_bytes))
    if seq:
        attn_fwd.append(_entry("all_to_all", q_bytes // m))
    layer_fwd = attn_fwd + [_entry("all_reduce", act), _entry("all_reduce", act)]
    # the backward runs the operators' backwards in reverse creation order:
    # the FFN's copy, then the attention output's all-to-all, k / v's copy,
    # q's all-to-all and the attention input's copy
    attn_bwd = []
    if seq:
        attn_bwd.append(_entry("all_to_all", q_bytes // m))
    if gather:
        attn_bwd.append(_entry("all_reduce", kv_bytes))
    if seq:
        attn_bwd.append(_entry("all_to_all", q_bytes // m))
    layer_bwd = [_entry("all_reduce", act)] + attn_bwd + [_entry("all_reduce", act)]

    chunk = min(cfg.loss_chunk, S)
    n_chunks = -(-S // chunk)
    loss_fwd = [e for _ in range(n_chunks) for e in (
        _entry("all_reduce", b * chunk * 4), _entry("all_reduce", 2 * b * chunk * 4))]
    embed = [_entry("all_reduce", b * S * d * pd)]
    n = cfg.num_layers
    fwd = embed + layer_fwd * n + loss_fwd
    if not train:
        return fwd
    bwd = [_entry("all_reduce", act)]             # the loss input's copy
    if not cfg.remat or cfg.remat_policy == "save_mixer":
        # no recompute, or save_mixer's norm2 + FFN checkpoint, which reruns
        # up to its last saved tensor: the FFN's all-reduce comes after it
        # and is not rerun
        bwd += layer_bwd * n
    else:
        # a period's recompute stops at its last saved tensor (the
        # non-reentrant checkpoint's early stop): the FFN's all-reduce,
        # which follows it, is not rerun
        bwd += (layer_fwd[:-1] + layer_bwd) * n
    return fwd + bwd
