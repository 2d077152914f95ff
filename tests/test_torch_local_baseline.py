"""The local-only baseline (paper App. C.1): the port's
``run_local_baseline`` against the JAX package's on the CPU, with the
reference's initial weights carried across (``convert.params_from_jax``).

The reference trains one client at a time; the port trains every listed
client in one vmapped solve, from [K]-stacked starting points, on the
reference's key stream (``PRNGKey(fed.seed + 1)`` split once a client,
each client's key into ``max(epochs // E, 1)`` chunk keys) and its
minibatch orders. The reference's trained params are the ones its
``run_local_baseline`` hands to ``evaluate``, recorded there.

Tolerances: the accuracies as counts of correctly classified test
examples, exactly (the reference's jitted mean rounds the f32 ratio its
own way: 0.995 of 1,000 reads 0.99500006 there, 0.99500000 here);
the trained params within 1e-5 x max|p| of the reference's (f32 on both
sides, the same steps, only the order of sums differs; 7.9e-7 at most
over these cases, up to 12 chunks of SGD)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.data.shards import make_benchmark_federation as jax_shards  # noqa: E402
from repro.fl import simulator as ref_sim  # noqa: E402
from repro.models.small import SMALL_MODELS as JAX_MODELS  # noqa: E402
from repro.models.small import make_loss_fn as jax_loss_fn  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.data.shards import make_benchmark_federation  # noqa: E402
from repro_torch.data.synth import make_synth_federation  # noqa: E402
from repro_torch.fl.simulator import (run_local_baseline,  # noqa: E402
                                      train_local_baseline)
from repro_torch.models.small import SMALL_MODELS, make_loss_fn  # noqa: E402
from test_torch_round import jax_synth, one_blas_thread, one_torch_thread  # noqa: E402,F401

PARAMS_REL = 1e-5

# tests/test_simulator.py's _fed at 4 rounds
SIM_FED = dict(num_clients=12, num_priority=6, rounds=4, local_epochs=3,
               epsilon=0.2, lr=0.1, warmup_frac=0.1, batch_size=32)
SYNTH_KW = dict(seed=2, n_priority=2, n_nonpriority=2, samples_per_client=50)
SHARD_KW = dict(seed=0, n_priority=2, clients=6, samples_per_client=50,
                test_samples=400)
# bench_local_vs_global.py's FedConfig, at 6 clients and 2 rounds
BENCH_FED = dict(num_clients=6, num_priority=2, rounds=2, local_epochs=5,
                 epsilon=0.2, lr=0.1, warmup_frac=0.1, batch_size=16)


@pytest.fixture(scope="module")
def federations():
    """Both packages' federations, built once a module at one BLAS thread."""
    with one_blas_thread():
        return {"synth": (jax_synth(**SYNTH_KW),
                          make_synth_federation(**SYNTH_KW)),
                "fmnist": (jax_shards("fmnist", **SHARD_KW),
                           make_benchmark_federation("fmnist", **SHARD_KW))}


def _jax_init(model):
    """The reference's init, with small random weights for the zero-init
    logistic regressions, so each client starts from its own point."""
    init = JAX_MODELS[model][0]

    def init_fn(key):
        p = init(key)
        if model in ("logreg", "synth_logreg"):
            keys = jax.random.split(key, len(p))
            p = {k: 0.05 * jax.random.normal(kk, v.shape, jnp.float32)
                 for kk, (k, v) in zip(keys, sorted(p.items()))}
        return p

    return init_fn


def _port_init(jax_init):
    def init_fn(seed, device="cuda"):
        p = jax_init(jax.random.PRNGKey(seed))
        return params_from_jax(jax.tree.map(np.asarray, p), device)
    return init_fn


def _reference(model, fed_kw, fedn, **kw):
    """The reference's accuracies and the params it evaluated, by client."""
    seen = []
    evaluate = ref_sim.evaluate

    def recording(loss_fn, params, x, y):
        seen.append(jax.tree.map(np.asarray, params))
        return evaluate(loss_fn, params, x, y)

    ref_sim.evaluate = recording
    try:
        accs = ref_sim.run_local_baseline(
            jax_loss_fn(JAX_MODELS[model][1]), _jax_init(model),
            JaxFedConfig(**fed_kw), fedn, **kw)
    finally:
        ref_sim.evaluate = evaluate
    return accs, dict(zip(accs, seen))


CASES = {
    "test_simulator_case": ("synth_logreg", "synth", SIM_FED,
                            dict(client_ids=[0, 2])),
    "all_clients": ("synth_logreg", "synth", SIM_FED, {}),
    "fedprox": ("synth_logreg", "synth",
                dict(SIM_FED, algorithm="fedprox", prox_mu=1.0),
                dict(client_ids=[3, 1])),
    "epochs_not_a_multiple_of_E": ("synth_logreg", "synth", SIM_FED,
                                   dict(epochs=8, client_ids=[1, 2, 3])),
    "epochs_under_E": ("synth_logreg", "synth", SIM_FED,
                       dict(epochs=2, client_ids=[0])),
    "fmnist_bench_config": ("logreg", "fmnist", BENCH_FED,
                            dict(client_ids=[5, 2, 4])),
}


@pytest.mark.parametrize("case", list(CASES))
def test_local_baseline_matches_reference(case, federations):
    model, data, fed_kw, kw = CASES[case]
    jfedn, tfedn = federations[data]
    want, ref_params = _reference(model, fed_kw, jfedn, **kw)
    loss_fn = make_loss_fn(SMALL_MODELS[model][1])
    init_fn = _port_init(_jax_init(model))
    got = run_local_baseline(loss_fn, init_fn, FedConfig(**fed_kw), tfedn,
                             device="cpu", **kw)
    assert list(got) == list(want)
    n = len(tfedn.test_y)
    assert {c: round(a * n) for c, a in got.items()} == {
        c: round(a * n) for c, a in want.items()}
    assert all(abs(got[c] - want[c]) < 1e-6 for c in want)
    ids, params = train_local_baseline(loss_fn, init_fn, FedConfig(**fed_kw),
                                       tfedn, device="cpu", **kw)
    assert ids == list(want)
    stacked = params_to_numpy(params)
    for i, c in enumerate(ids):
        for k, pj in ref_params[c].items():
            scale = np.abs(pj).max()
            np.testing.assert_allclose(stacked[k][i], pj, rtol=0,
                                       atol=PARAMS_REL * scale,
                                       err_msg=f"client {c} {k}")
            # the training moved the params: a baseline that skipped it
            # would fail here
            p0 = np.asarray(_jax_init(model)(
                jax.random.PRNGKey(fed_kw.get("seed", 0) + 100 + c))[k])
            assert np.abs(pj - p0).max() > 100 * PARAMS_REL * scale


def test_one_solve_equals_client_by_client(federations):
    """The batched solve trains a client as it would alone: client 2's
    params in a solve beside client 0 equal, bit for bit, its solve with
    ``client_ids=[2]`` (the same key: first in both lists)."""
    _, tfedn = federations["synth"]
    loss_fn = make_loss_fn(SMALL_MODELS["synth_logreg"][1])
    init_fn = _port_init(_jax_init("synth_logreg"))
    fed = FedConfig(**SIM_FED)
    _, alone = train_local_baseline(loss_fn, init_fn, fed, tfedn,
                                    client_ids=[2], device="cpu")
    _, together = train_local_baseline(loss_fn, init_fn, fed, tfedn,
                                       client_ids=[2, 0], device="cpu")
    for k in alone:
        torch.testing.assert_close(together[k][0], alone[k][0], rtol=0,
                                   atol=0)


def test_entry_point_refuses_to_run_on_cpu_by_default(federations):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, tfedn = federations["synth"]
    init_fn, apply_fn = SMALL_MODELS["synth_logreg"]
    with pytest.raises(RuntimeError, match="CUDA"):
        run_local_baseline(make_loss_fn(apply_fn), init_fn,
                           FedConfig(**SIM_FED), tfedn, client_ids=[0])
