"""The rank processes of tests/test_torch_pod.py, and the round runner the
test's parent shares with them. It imports no JAX, so a spawned rank
starts on torch alone.

``drive`` runs RUN's rounds of one FedConfig on the smoke qwen1.5, as
``launch.train.run`` draws them (the token federation, the batches from
``default_rng(0)``, the init from ``PRNGKey(0)``), through the one-process
``make_spatial_round`` or, given a mesh, this rank's ``make_pod_round``;
``rank_main`` is one gloo rank on the CPU (a ``FileStore`` rendezvous in
the test's own directory, one torch and one BLAS thread) that drives every
config, then checks the launcher and the DTensor placements, and pickles
what it saw for the parent."""
import hashlib
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
    gathers back to itself; and the pod round refuses the model axis."""
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
        sharded.make_pod_round(model, FedConfig(num_clients=8), 8, mesh,
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
