"""The temporal LM round on the smoke jamba (attention + 7 Mamba mixers
through the SSMScan Function, the MoE on the dense pattern), the arch the
reference routes through that round (``needs_fsdp``), against the JAX
package's ``make_temporal_round`` on the CPU: tests/test_torch_temporal.py's
federation, batches and tolerances, 2 rounds, eps 0.1 (round 0 gates client
2 out and client 3 in, round 1 both out; every decision > 0.04 from eps).
Kept apart from that file so each stays well under a minute on one
worker: the reference's jamba round compiles for ~25 s."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.fl import engine  # noqa: E402
from test_torch_temporal import (ROUNDS, assert_margins,  # noqa: E402
                                 assert_state_parity, jax_rounds, port_rounds)

ARCH = "jamba_1_5_large_398b"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors: one torch thread for the module (see
    tests/test_torch_train.py), the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_jamba_temporal_round_matches_reference(monkeypatch):
    fed_kw = dict(epsilon=0.1)
    calls = []
    server_delta = engine.server_delta

    def counting_delta(*a, **k):
        calls.append(1)
        return server_delta(*a, **k)
    monkeypatch.setattr(engine, "server_delta", counting_delta)
    tstate, tstats = port_rounds(fed_kw, arch=ARCH)
    assert_margins(tstats, fed_kw["epsilon"])
    assert 0 < sum(st["gates"][2:].sum() for st in tstats) < 2 * ROUNDS
    assert not calls                    # the mean stream reaches no fedagg
    jstate, jstats = jax_rounds(fed_kw, arch=ARCH)
    assert_state_parity(tstate, tstats, jstate, jstats)
