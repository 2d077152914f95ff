"""The rank processes of tests/test_torch_pod.py, and the round runner the
test's parent shares with them. It imports no JAX, so a rank starts on
torch alone: ``start_ranks`` forks each layout's ranks from a forkserver
that has imported this module and the port once.

``drive`` runs RUN's rounds of one FedConfig on the smoke qwen1.5, as
``launch.train.run`` draws them (the token federation, the batches from
``default_rng(0)``, the init from ``PRNGKey(0)``), through the one-process
``make_spatial_round`` or, given a mesh, this rank's ``make_pod_round``;
``rank_main`` is one gloo rank on the CPU (a ``FileStore`` rendezvous in
the test's own directory, one torch and one BLAS thread) that drives every
config, then checks the launcher and the DTensor placements, and pickles
what it saw for the parent."""
import hashlib
import multiprocessing
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

RUN = dict(rounds=2, clients=8, n_priority=2, per_client=1, seq=16,
           local_epochs=1, lr=0.05)
# every knob of the pod round, each config a few of them: the four
# aggregators, the identity, int8, topk and sketch wires with error
# feedback (dense and under a cohort), the five loss-based strategies, the
# four server optimizers, a cohort with its backlog boost, the fault layer
# and the event clock under the guard and a buffer, and the bf16 wire
CONFIGS = {
    "mean": dict(epsilon=0.1),
    "dp": dict(epsilon=0.1, aggregator="dp", dp_clip=0.5, dp_noise=0.5,
               selection="all", server_opt="momentum", server_momentum=0.9),
    "trimmed": dict(epsilon=0.1, aggregator="trimmed_mean", trim_frac=0.2,
                    selection="priority_only", server_opt="adam",
                    server_lr=0.01),
    "median_cohort": dict(epsilon=0.1, aggregator="median", max_cohort=3,
                          server_opt="yogi", server_lr=0.01),
    "int8_cohort": dict(epsilon=0.1, wire_codec="int8", max_cohort=3,
                        selection="topk_align", topk=2),
    "int8_welfare": dict(epsilon=0.1, wire_codec="int8", selection="welfare"),
    "faults": dict(epsilon=0.1, failure_model="chaos", crash_rate=0.2,
                   corrupt_rate=0.2, corrupt_scale=-2.0,
                   divergence_guard=True, async_depth=1, async_mode="ready",
                   adaptive_staleness=True, latency_mode="lognormal",
                   round_deadline=3.0),
    "mean_bf16": dict(epsilon=0.1, agg_dtype="bfloat16"),
    "topk": dict(epsilon=0.1, wire_codec="topk", codec_topk_frac=0.1,
                 max_cohort=3, backlog_boost=0.05),
    "sketch": dict(epsilon=0.1, wire_codec="sketch", codec_sketch_dim=4096,
                   error_feedback=False),
}
# (ranks, pods): a (data=2) and a (pod=2, data=2) host mesh
LAYOUTS = {"data2": (2, None), "pod2_data2": (4, 2)}


def start_ranks(fn, world, args):
    """fn(rank, *args) in ``world`` processes, not joined. They fork from
    a forkserver that imported this module and the port once: a spawned
    interpreter a rank would import torch and the port again, ~10 s of CPU
    each. Call it with the ranks' environment set: the server keeps the
    environment it starts with."""
    import torch.multiprocessing as mp
    multiprocessing.set_forkserver_preload([__name__,
                                            "repro_torch.launch.train"])
    return mp.start_processes(fn, args=args, nprocs=world, join=False,
                              start_method="forkserver")


def _np(tree):
    from repro_torch.utils import tree_leaves
    return [t.detach().cpu().numpy().copy() for t in tree_leaves(tree)]


_SETUP = {}


def _setup():
    """The smoke qwen1.5, its token federation and its initial params,
    made once a process (each drive trains a copy of the params)."""
    if not _SETUP:
        from repro_torch import prng
        from repro_torch.configs import get_smoke
        from repro_torch.data.tokens import make_token_federation
        from repro_torch.models import get_model
        cfg = get_smoke("qwen1.5-0.5b")
        model = get_model(cfg)
        _SETUP.update(cfg=cfg, model=model, init=model.init(
            prng.PRNGKey(0), device="cpu"), data=make_token_federation(
            seed=0, vocab=cfg.vocab_size, n_clients=RUN["clients"],
            n_priority=RUN["n_priority"], seq_len=RUN["seq"],
            misalign_max=1.0, tokens_per_client=max(
                8192, RUN["per_client"] * (RUN["seq"] + 1) * 4)))
    return _SETUP


def drive(fed_kw, mesh=None):
    """RUN's rounds under ``fed_kw``: {"stats": each round's stats as
    numpy, "params", "ef" (the state's error-feedback rows), "opt_t",
    "collectives" (the pod round's records), "scales" (each int8 encode's
    largest row scale)}."""
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import aggregation
    from repro_torch.fl import engine, sharded
    from repro_torch.launch.train import build_batches
    from repro_torch.utils import tree_map
    C, P = RUN["clients"], RUN["n_priority"]
    setup = _setup()
    cfg, model, data = setup["cfg"], setup["model"], setup["data"]
    fed = FedConfig(num_clients=C, num_priority=P,
                    local_epochs=RUN["local_epochs"], lr=RUN["lr"], **fed_kw)
    if mesh is None:
        step = sharded.make_spatial_round(model, fed, C, device="cpu")
    else:
        step = sharded.make_pod_round(model, fed, C, mesh, device="cpu")
    state = engine.init_state(tree_map(torch.clone, setup["init"]), fed, C)
    scales, encode = [], aggregation._Int8Codec.encode

    def recording_encode(fed, buf):
        q, kw = encode(fed, buf)
        scales.append(float(kw["dequant_scale"].max()) if q.shape[0] else 0.0)
        return q, kw

    sharded.COLLECTIVES.clear()
    aggregation._Int8Codec.encode = staticmethod(recording_encode)
    try:
        rng = np.random.default_rng(0)
        stats = []
        for r in range(RUN["rounds"]):
            batch = build_batches(cfg, data, clients=C,
                                  per_client=RUN["per_client"],
                                  seq=RUN["seq"], rng=rng, device="cpu",
                                  block=None if mesh is None
                                  else step.pod.block(C))
            state, st = step(state, batch, r)
            stats.append({k: v.numpy().copy() for k, v in st.items()})
    finally:
        aggregation._Int8Codec.encode = staticmethod(encode)
    opt = state.opt_state
    return {"stats": stats, "params": _np(state.params),
            "ef": _np(state.ef_accum),
            "opt_t": int(opt["t"]) if isinstance(opt, dict) and "t" in opt
            else None,
            "collectives": list(sharded.COLLECTIVES), "scales": scales}


def _dtensor_check():
    """On a (data=2, model=2) mesh of the four ranks: each smoke leaf
    distributed by its spec's placements holds ``local_shape`` here and
    gathers back to itself; and the pod round refuses a knob the model
    axis has not reached (the dp aggregator)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import prng
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import FedConfig
    from repro_torch.fl import sharded
    from repro_torch.models import get_model
    from repro_torch.sharding import specs
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    model = get_model(get_smoke("qwen1.5-0.5b"))
    params = model.init(prng.PRNGKey(0), device="cpu")
    spec_tree = specs.auto_param_specs(params, mesh, fsdp=True)
    out = []
    for leaf, spec in specs.spec_pairs(params, spec_tree):
        dt = distribute_tensor(leaf, mesh, specs.placements(spec, mesh))
        out.append((tuple(spec), tuple(dt.to_local().shape),
                    specs.local_shape(tuple(leaf.shape), spec, mesh),
                    bool(torch.equal(dt.full_tensor(), leaf))))
    try:
        sharded.make_pod_round(model, FedConfig(num_clients=8,
                                                aggregator="dp"), 8, mesh,
                               device="cpu")
        refusal = None
    except NotImplementedError as exc:
        refusal = str(exc)
    return {"leaves": out, "refusal": refusal}


def digest(arrays) -> str:
    """One sha256 over a list of arrays' bytes."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _slim(run, rank, world):
    """What a rank sends back of one config's run: rank 0 its params, the
    others their digest; the error-feedback rows of its own clients and
    whether every other row is still zero."""
    n = RUN["clients"] // world
    mine = slice(rank * n, (rank + 1) * n)
    out = dict(run, params_digest=digest(run["params"]),
               ef_mine=[e[mine] for e in run["ef"]],
               ef_rest_zero=all(not np.delete(e, range(rank * n, (rank + 1) * n),
                                              axis=0).any() for e in run["ef"]))
    del out["ef"]
    if rank:
        del out["params"]
    return out


def rank_main(rank, world, pods, tmp):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    try:
        from repro_torch.launch import train
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(1, pods=pods, device_type="cpu")
        out = {"runs": {name: _slim(drive(kw, mesh), rank, world)
                        for name, kw in CONFIGS.items()}}
        params, hist = train.run(arch="qwen1.5-0.5b", device="cpu",
                                 verbose=False, mesh=mesh, **RUN,
                                 **CONFIGS["mean"])
        out["train_run"] = {"params_digest": digest(_np(params)),
                            "gates": [h["gates"] for h in hist]}
        if world == 4:
            out["dtensor"] = _dtensor_check()
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------- the model axis
# tests/test_torch_model_axis.py: the pod round with tensor-parallel params
# over "model" for the dense GQA family, on smoke configs
MODEL_RUN = dict(rounds=2, clients=4, n_priority=2, per_client=2, seq=32,
                 local_epochs=1, lr=0.05)
# the gate threshold of each arch's smoke model: its non-priority clients'
# gaps |F_k - F| lie on both sides of it, each farther than GATE_MARGIN
MODEL_EPS = {"qwen1.5-0.5b": 0.03, "qwen2.5-3b": 0.02, "phi3-mini-3.8b": 0.2}
MODEL_CONFIGS = {
    "mean": dict(),
    "mean_bf16": dict(agg_dtype="bfloat16"),
    "trimmed": dict(aggregator="trimmed_mean", trim_frac=0.25),
    "median": dict(aggregator="median"),
    "cohort": dict(max_cohort=3, server_opt="momentum", server_momentum=0.9),
    # NaN-corrupted clients under the divergence guard, the finite flag
    # agreed over the model group: seed 5's draws skip round 0 and land
    # round 1
    "guard": dict(failure_model="corrupt", corrupt_rate=0.25,
                  divergence_guard=True, seed=5),
}
FIVE = ("mean", "mean_bf16", "trimmed", "median", "cohort")
# layout -> (ranks, model axis, arch, [(name, config, seq_shard_attn)],
# whether it also runs train.run): the five configs on (data 2, model 2)
# and (data 1, model 2), the guard on the cheapest; on (data 1, model 4),
# where four ranks make each collective the slowest, the configs the
# reference's mesh runs are held against and a cohort
MODEL_LAYOUTS = {
    "d2m2": (4, 2, "qwen1.5-0.5b", [(n, n, False) for n in FIVE], True),
    "m4": (4, 4, "qwen2.5-3b",
           [(n, n, False) for n in ("mean", "median", "cohort")]
           + [("mean_seq", "mean", True)], False),
    "m2": (2, 2, "phi3-mini-3.8b",
           [(n, n, False) for n in FIVE + ("guard",)], True),
}

_MODEL_SETUP = {}


def model_setup(arch):
    """The smoke ``arch``, its token federation and its initial params
    (``PRNGKey(0)``), made once a process."""
    if arch not in _MODEL_SETUP:
        from repro_torch import prng
        from repro_torch.configs import get_smoke
        from repro_torch.data.tokens import make_token_federation
        from repro_torch.models import get_model
        cfg = get_smoke(arch)
        run = MODEL_RUN
        _MODEL_SETUP[arch] = dict(
            cfg=cfg, init=get_model(cfg).init(prng.PRNGKey(0), device="cpu"),
            data=make_token_federation(
                seed=0, vocab=cfg.vocab_size, n_clients=run["clients"],
                n_priority=run["n_priority"], seq_len=run["seq"],
                misalign_max=1.0, tokens_per_client=max(
                    8192, run["per_client"] * (run["seq"] + 1) * 4)))
    return _MODEL_SETUP[arch]


def model_fed(arch, name):
    from repro_torch.configs.base import FedConfig
    run = MODEL_RUN
    return FedConfig(num_clients=run["clients"], num_priority=run["n_priority"],
                     local_epochs=run["local_epochs"], lr=run["lr"],
                     epsilon=MODEL_EPS[arch], **MODEL_CONFIGS[name])


def drive_model(arch, name, seq_shard=False, mesh=None):
    """MODEL_RUN's rounds of config ``name`` on the smoke ``arch`` through
    the one-process ``make_spatial_round`` or, given a mesh, this rank's
    ``make_pod_round`` (the params sharded from the same init). Returns
    {"stats", "params" (whole: gathered from the shards), "opt_t", and on a
    mesh "replicated" (the digest of the leaves every model rank holds
    whole), "collectives" and "trained" (each round's), "M_local"}."""
    from repro_torch.fl import engine, sharded
    from repro_torch.launch.train import build_batches
    from repro_torch.models import get_model
    from repro_torch.sharding import model_axis
    from repro_torch.utils import tree_leaves, tree_map
    run = MODEL_RUN
    C = run["clients"]
    setup = model_setup(arch)
    cfg = setup["cfg"].replace(seq_shard_attn=seq_shard)
    model = get_model(cfg)
    fed = model_fed(arch, name)
    params = tree_map(torch.clone, setup["init"])
    if mesh is None:
        step = sharded.make_spatial_round(model, fed, C, device="cpu")
    else:
        step = sharded.make_pod_round(model, fed, C, mesh, device="cpu")
        params = step.shard(params)
    state = engine.init_state(params, fed, C)
    out = {"stats": [], "collectives": [], "trained": []}
    train_stack = sharded._train_stack

    def counting(model, params, client_batch, rows, *a, **kw):
        out["trained"][-1] += len(rows)
        return train_stack(model, params, client_batch, rows, *a, **kw)

    sharded._train_stack = counting
    try:
        rng = np.random.default_rng(0)
        for r in range(run["rounds"]):
            batch = build_batches(cfg, setup["data"], clients=C,
                                  per_client=run["per_client"], seq=run["seq"],
                                  rng=rng, device="cpu",
                                  block=None if mesh is None
                                  else step.pod.block(C))
            sharded.COLLECTIVES.clear()
            out["trained"].append(0)
            state, st = step(state, batch, r)
            out["stats"].append({k: v.numpy().copy() for k, v in st.items()})
            out["collectives"].append(list(sharded.COLLECTIVES))
    finally:
        sharded._train_stack = train_stack
    opt = state.opt_state
    out["opt_t"] = (int(opt["t"]) if isinstance(opt, dict) and "t" in opt
                    else None)
    if mesh is not None:
        out["M_local"] = sum(t.numel() for t in tree_leaves(state.params))
        out["replicated"] = digest(_np(model_axis.replicated_leaves(
            state.params, step.specs)))
        out["params"] = _np(step.gather(state.params))
    else:
        out["params"] = _np(state.params)
    return out


def model_rank_main(rank, world, layout, tmp):
    """One gloo rank of a model-axis layout: every config of
    MODEL_LAYOUTS[layout], then (where the layout says so)
    ``train.run(mesh=...)`` under mean; rank 0 keeps the params, every
    rank its digests."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    try:
        from repro_torch.launch import train
        from repro_torch.launch.mesh import make_host_mesh
        _, m, arch, runs, with_train = MODEL_LAYOUTS[layout]
        mesh = make_host_mesh(m, device_type="cpu")
        out = {"runs": {}}
        for name, config, seq in runs:
            got = drive_model(arch, config, seq, mesh)
            got["params_digest"] = digest(got["params"])
            if rank:
                del got["params"]
            out["runs"][name] = got
        if with_train:
            params, hist = train.run(arch=arch, device="cpu", verbose=False,
                                     mesh=mesh, epsilon=MODEL_EPS[arch],
                                     **MODEL_RUN)
            out["train_run"] = {"params_digest": digest(_np(params)),
                                "gates": [h["gates"] for h in hist]}
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
