"""The temporal LM round's gathered branches against the JAX package's
``make_temporal_round`` on the CPU, at tests/test_torch_temporal.py's
smoke config, batches and tolerances (2 rounds): the robust aggregators
(trimmed_mean, median, dp) and the int8 wire with error feedback, which
gather the trained params into a [C, ...] stack for fedagg, a gated-out
client's row holding the received params; and grad_sim on CountSketches,
whose first pass trains every client to sketch its delta and whose second
re-trains the included ones. Kept apart from that file so each stays well
under a minute on one worker."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.fl import engine, sharded  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from test_torch_temporal import (C, ROUNDS, assert_margins,  # noqa: E402
                                 assert_state_parity, jax_rounds, port_rounds)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors: one torch thread for the module (see
    tests/test_torch_train.py), the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# eps 0.1 gates client 3 out in round 0 (tests/test_torch_temporal.py), so
# its row of the gathered stack holds the received params
GATHER = {
    "trimmed_mean": dict(epsilon=1e9, aggregator="trimmed_mean",
                         trim_frac=0.25),
    "median_eps_tight": dict(epsilon=0.1, aggregator="median"),
    "dp": dict(epsilon=1e9, aggregator="dp", dp_clip=0.5, dp_noise=0.3),
    "int8_ef_eps_tight": dict(epsilon=0.1, wire_codec="int8"),
}


@pytest.mark.parametrize("case", sorted(GATHER))
def test_gathered_round_matches_reference(case, monkeypatch):
    """Params too within TOL, but under int8 one more quantum of the run's
    largest row scale (tests/test_torch_round_agg.py: a last-bit
    difference of a delta can cross a rounding boundary)."""
    from repro_torch.core import aggregation as tagg
    fed_kw = GATHER[case]
    scales, rows = [], []
    encode = tagg._Int8Codec.encode
    server_delta = engine.server_delta

    def recording_encode(fed, buf):
        q, kw = encode(fed, buf)
        scales.append(float(kw["dequant_scale"].max()))
        return q, kw

    def recording_delta(fed, gp, cp, w, g, **k):
        rows.append(tree_leaves(cp)[0].shape[0])
        return server_delta(fed, gp, cp, w, g, **k)
    monkeypatch.setattr(tagg._Int8Codec, "encode",
                        staticmethod(recording_encode))
    monkeypatch.setattr(engine, "server_delta", recording_delta)
    tstate, tstats = port_rounds(fed_kw)
    assert rows == [C] * ROUNDS
    if fed_kw["epsilon"] < 1e3:
        assert_margins(tstats, fed_kw["epsilon"])
        assert tstats[0]["gates"].sum() < C
    jstate, jstats = jax_rounds(fed_kw)
    assert_state_parity(tstate, tstats, jstate, jstats,
                        extra_atol=max(scales, default=0.0))


def test_grad_sim_sketch_matches_reference(monkeypatch):
    """Two passes: every client trains for its sketch, then the included
    ones train again for the mean stream; the gates come from pass 1."""
    fed_kw = dict(epsilon=1e9, selection="grad_sim", grad_sim_sketch=True,
                  sketch_dim=64, sim_threshold=0.0)
    trained, cosines = [], []
    train_steps, cosine = sharded._train_steps, engine.cosine_to_priority

    def counting_train(*a, **k):
        trained.append(1)
        return train_steps(*a, **k)

    def recording_cosine(*a):
        cosines.append(cosine(*a).numpy())
        return torch.from_numpy(cosines[-1])
    monkeypatch.setattr(sharded, "_train_steps", counting_train)
    monkeypatch.setattr(engine, "cosine_to_priority", recording_cosine)
    tstate, tstats = port_rounds(fed_kw)
    gated = [int(st["gates"].sum()) for st in tstats]
    assert len(trained) == C * ROUNDS + sum(gated)
    assert 0 < sum(gated) - 2 * ROUNDS < (C - 2) * ROUNDS   # some in, some out
    # every non-priority cosine lies > 1e-3 from the threshold, so that
    # equal gates are meaningful
    assert len(cosines) == ROUNDS
    assert all(np.all(np.abs(c[2:] - fed_kw["sim_threshold"]) > 1e-3)
               for c in cosines), cosines
    jstate, jstats = jax_rounds(fed_kw)
    assert_state_parity(tstate, tstats, jstate, jstats)
