"""Overlapped cohorts and faults in the LM rounds: the port's spatial and
temporal rounds against ``repro.fl.sharded``'s on the CPU, at the smoke
qwen1.5-0.5b of tests/test_torch_temporal.py (f32, 4 clients of which 2
priority, 2 sequences of 32 tokens, E = 2, lr 0.05) on the batches
``launch.train.build_batches`` draws: the fifo pipe at depth 1 with
crashes (and drop-outs), the variable-lag buffer under the event clock
with a deadline and the guard, NaN corruption under the guard with the
fifo pipe (spatial round only: the temporal round refuses it); and
``launch.train.run``'s halt (synchronous, NaN corruption) against the
reference's.

Tolerances: tests/test_torch_temporal.py's (gates, backlog and every
buffer and fault stat exactly; losses 1e-5 relative; params, moments and
EMAs atol = rtol = 5e-5), after checking every gate decision lies farther
than GATE_MARGIN from eps and every completion time farther than
LATENCY_MARGIN from each integer up to ceil(deadline) and from the
deadline in the port's run."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.fl import engine  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from test_torch_failures import assert_latency_margins  # noqa: E402
from test_torch_temporal import (C, assert_margins,  # noqa: E402
                                 assert_state_parity, jax_rounds,
                                 one_torch_thread, port_rounds)

FAULT_STATS = ("staleness", "applied_valid", "inflight_occupancy",
               "lost_clients", "skipped_nonfinite")


# name: (fsdp, rounds, knobs). eps 0.1 splits the non-priority clients
CASES = {
    "spatial_fifo_d1_crash_nan_guard": (False, 2, dict(
        epsilon=0.1, async_depth=1, failure_model="chaos", crash_rate=0.3,
        corrupt_rate=0.3, divergence_guard=True)),
    "spatial_clock_deadline": (False, 3, dict(
        epsilon=0.1, async_depth=2, async_mode="ready",
        latency_mode="lognormal", round_deadline=2.0, failure_model="crash",
        crash_rate=0.25, divergence_guard=True, server_opt="momentum",
        server_lr=0.5)),
    "temporal_fifo_d1_crash_dropout": (True, 2, dict(
        epsilon=0.1, async_depth=1, failure_model="chaos", crash_rate=0.3,
        dropout_rate=0.3, dropout_len=2)),
    "temporal_clock_deadline": (True, 3, dict(
        epsilon=0.1, async_depth=2, async_mode="ready",
        latency_mode="lognormal", round_deadline=2.0, failure_model="crash",
        crash_rate=0.25, divergence_guard=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_round_matches_reference(case):
    fsdp, rounds, kw = CASES[case]
    tstate, tstats = port_rounds(kw, rounds=rounds, fsdp=fsdp)
    assert_margins(tstats, kw["epsilon"])
    if "round_deadline" in kw:
        assert_latency_margins(tstate.latency, kw["round_deadline"])
    jstate, jstats = jax_rounds(kw, rounds, fsdp=fsdp)
    assert_state_parity(tstate, tstats, jstate, jstats)
    for t, j in zip(tstats, jstats):
        for k in FAULT_STATS:
            if k in j:
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    if isinstance(tstate.inflight, dict):
        for k in ("valid", "age", "timer"):
            if k in jstate.inflight:
                np.testing.assert_array_equal(
                    tstate.inflight[k].numpy(),
                    np.asarray(jstate.inflight[k]), err_msg=k)
    assert sum(float(s["lost_clients"]) for s in tstats) > 0
    if kw.get("corrupt_rate"):
        # a NaN aggregate was zeroed before it entered the buffer
        assert max(int(s["skipped_nonfinite"]) for s in tstats) > 0


def test_lost_temporal_client_skips_its_steps(monkeypatch):
    """A lost streamed client trains no step; its selection gate still
    counts for the backlog."""
    from repro_torch.fl import sharded
    calls = {"trained": 0}
    train_steps = sharded._train_steps

    def counting(*a, **k):
        calls["trained"] += 1
        return train_steps(*a, **k)
    monkeypatch.setattr(sharded, "_train_steps", counting)
    kw = dict(epsilon=1e9, failure_model="crash", crash_rate=0.5)
    _, stats = port_rounds(kw, rounds=2)
    lost = sum(int(s["lost_clients"]) for s in stats)
    assert lost > 0
    assert calls["trained"] == 2 * C - lost
    assert all(int(s["gates"].sum()) + int(s["lost_clients"]) == C
               for s in stats)


def test_train_run_halt_matches_reference():
    """launch.train.run under NaN corruption and the guard stops at the
    round whose skip count reaches max_nonfinite_skips, as the
    reference's; the records carry the skip counts."""
    from repro.launch.train import run as jax_run
    kw = dict(rounds=5, clients=4, n_priority=2, per_client=2, seq=32,
              failure_model="corrupt", corrupt_rate=0.5,
              divergence_guard=True, max_nonfinite_skips=2, verbose=False)
    jparams, jhist = jax_run(**kw)
    params, hist = train.run(device="cpu", **kw)
    assert len(hist) == len(jhist) < kw["rounds"]
    assert [h["skipped_nonfinite"] for h in hist] == [
        h["skipped_nonfinite"] for h in jhist]
    assert hist[-1]["skipped_nonfinite"] == 2
    np.testing.assert_allclose([h["server_loss"] for h in hist],
                               [h["server_loss"] for h in jhist], rtol=1e-5)
    assert all(torch.isfinite(p).all() for p in tree_leaves(params))


def test_train_run_records_lost_clients():
    params, hist = train.run(rounds=2, clients=4, n_priority=2, per_client=2,
                             seq=32, device="cpu", verbose=False,
                             backend="scan_async", async_depth=1,
                             failure_model="crash", crash_rate=0.5)
    assert all("lost_clients" in h and "skipped_nonfinite" not in h
               for h in hist)
    assert engine.resolve_failure_model(None) == "none"
