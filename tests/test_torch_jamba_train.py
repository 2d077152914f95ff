"""Jamba federated training: the port's ``launch.train.run`` on the smoke
jamba (attention + 7 Mamba mixers a period, MoE FFNs; f32, remat) on the
CPU against the JAX package's ``repro.launch.train.run`` loop (its
batches, spatial round, init and state; tests/test_torch_train_round.py's
``_jax_run``), 2 rounds, 4 clients of which 2 priority, 2 sequences of 16
tokens, E = 2. One reference run for the module (its compile is most of
the file's time).

Tolerances: gates and included counts exactly, after checking that every
gate decision lies farther than GATE_MARGIN from eps in the port's run;
server and client losses within 1e-5 relative; params within 1e-4 x
max(1, max|want|) per leaf (the loss_fn gradient's bound in
tests/test_torch_jamba.py, over E = 2 steps a round)."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_train_round as round_tests  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

ARCH = "jamba_1_5_large_398b"
RUN = dict(rounds=2, clients=4, n_priority=2, per_client=2, seq=16,
           local_epochs=2, lr=0.05)
EPS = 0.22              # gates a non-priority client in and one out
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-4
GATE_MARGIN = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors: one torch thread for the module (see
    tests/test_torch_train.py), the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference_run():
    mp = pytest.MonkeyPatch()
    mp.setattr(round_tests, "RUN_KW", RUN)
    try:
        yield round_tests._jax_run(ARCH, {}, EPS)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def port_run():
    return train.run(arch=ARCH, epsilon=EPS, device="cpu", verbose=False,
                     **RUN)


def test_train_run_gates_match_reference(reference_run, port_run):
    _, jh = reference_run
    _, th = port_run
    assert len(jh) == len(th) == RUN["rounds"]
    for j, t in zip(jh, th):
        gaps = np.abs(np.asarray(t["local_losses"]) - t["server_loss"])
        assert np.all(np.abs(gaps[RUN["n_priority"]:] - EPS) > GATE_MARGIN)
        np.testing.assert_array_equal(np.asarray(t["gates"]), j["gates"])
        assert t["included"] == float(j["gates"].sum()) - RUN["n_priority"]
    included = [t["included"] for t in th]
    assert 0 < sum(included) < (RUN["clients"] - RUN["n_priority"]) * len(th)


def test_train_run_losses_and_params_match_reference(reference_run,
                                                      port_run):
    jp, jh = reference_run
    tp, th = port_run
    for j, t in zip(jh, th):
        np.testing.assert_allclose(t["server_loss"], j["server_loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(t["local_losses"], j["local_losses"],
                                   rtol=LOSS_RTOL)
    want = jax.tree.leaves(jp)
    got = tree_leaves(tp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        bound = PARAM_TOL * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g.numpy() - w).max()) <= bound
    assert all(not x.requires_grad for x in got)
