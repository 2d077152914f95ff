"""The reference's jitted spatial round on a host mesh of CPU devices, run
in a subprocess of tests/test_torch_model_axis.py (the device count must
be set before JAX starts):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/jax_mesh_round.py JOBS.pkl OUT.pkl

JOBS.pkl holds {"arch", "run" (torch_pod_ranks.MODEL_RUN), "eps",
"configs" (name -> FedConfig knobs), "jobs": [(label, config name, mesh
shape (data, model) or None, seq_shard_attn)]}. Each job drives the
reference's ``make_round_step`` (jitted) over ``run["rounds"]`` rounds of
``build_batches``' draws from ``default_rng(0)``, from
``model.init(PRNGKey(0))``; on a mesh the state is placed by
``auto_param_specs`` / ``federation_state_specs`` under ``jax.set_mesh``
of a ``jax.make_mesh`` with ``AxisType.Auto`` axes (the reference's own
``make_host_mesh`` makes ``Explicit`` axes under jax 0.9, and its round
then fails at the embedding gather). OUT.pkl gets {label: {"stats",
"params"}} as numpy."""
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding

from repro.configs import get_smoke
from repro.configs.base import FedConfig
from repro.data.tokens import make_token_federation
from repro.fl import engine, sharded
from repro.launch.train import build_batches
from repro.models import get_model
from repro.sharding.specs import auto_param_specs, federation_state_specs


def drive(spec, config, mesh_shape, seq_shard):
    run = spec["run"]
    C = run["clients"]
    cfg = get_smoke(spec["arch"]).replace(seq_shard_attn=seq_shard)
    model = get_model(cfg)
    fed = FedConfig(num_clients=C, num_priority=run["n_priority"],
                    local_epochs=run["local_epochs"], lr=run["lr"],
                    epsilon=spec["eps"], **spec["configs"][config])
    data = make_token_federation(
        seed=0, vocab=cfg.vocab_size, n_clients=C,
        n_priority=run["n_priority"], seq_len=run["seq"], misalign_max=1.0,
        tokens_per_client=max(8192, run["per_client"] * (run["seq"] + 1) * 4))
    step = jax.jit(sharded.make_round_step(model, fed, C, fsdp=False))
    state = engine.init_state(model.init(jax.random.PRNGKey(0)), fed, C)
    mesh = None
    if mesh_shape is not None:
        mesh = jax.make_mesh(mesh_shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        specs = federation_state_specs(
            fed, auto_param_specs(jax.eval_shape(lambda: state.params), mesh))
        placed = jax.tree.map(lambda s: NamedSharding(mesh, s), specs)
        state = jax.device_put(state, placed)
    rng = np.random.default_rng(0)
    stats = []
    for r in range(run["rounds"]):
        batch = build_batches(cfg, data, clients=C,
                              per_client=run["per_client"], seq=run["seq"],
                              rng=rng)
        if mesh is None:
            state, st = step(state, batch, jnp.int32(r))
        else:
            with jax.set_mesh(mesh):
                state, st = step(state, batch, jnp.int32(r))
            # back to the specs' placement, which the round's outputs need
            # not keep: the next round then reuses this round's executable
            state = jax.device_put(state, placed)
        stats.append({k: np.asarray(st[k]) for k in
                      ("server_loss", "gates", "local_losses", "backlog")})
    return {"stats": stats,
            "params": [np.asarray(x) for x in jax.tree.leaves(state.params)]}


def main(jobs_path, out_path):
    with open(jobs_path, "rb") as f:
        spec = pickle.load(f)
    out = {label: drive(spec, config, mesh_shape, seq)
           for label, config, mesh_shape, seq in spec["jobs"]}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
