"""Checkpoints of the port against the JAX package on the CPU: the port's
msgpack codec against the ``msgpack`` package byte for byte, the state
layout (leaf order, shapes, dtype strings and the treedef string) for
every combination of server optimizer, in-flight buffer, event clock,
divergence guard, error-feedback rows and drift sketch, files crossing
between the packages in both directions, the fingerprint's
``ValueError``s, the drain's rewrite, and resumes: a pooled ``scan_async``
run interrupted with cohorts in flight (tests/test_pool.py's case) must
equal the uninterrupted run bit for bit, and the port resumed from the
reference's file must equal the reference's uninterrupted run at
tests/test_torch_round.py's tolerances (gates, pools and backlog
exactly, params within 1e-4 max|p|)."""
import functools
import itertools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")

from repro.checkpoint.io import _encode as jax_encode  # noqa: E402
from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.data.synth import make_synth_federation as jax_synth  # noqa: E402
from repro.fl import engine as jengine  # noqa: E402
from repro.fl import simulator as jsim  # noqa: E402
from repro.models.small import SMALL_MODELS as JAX_MODELS  # noqa: E402
from repro.models.small import make_loss_fn as jax_loss_fn  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.checkpoint import codec  # noqa: E402
from repro_torch.checkpoint.io import flatten, load_pytree, save_pytree  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.synth import make_synth_federation  # noqa: E402
from repro_torch.fl import engine  # noqa: E402
from repro_torch.fl import simulator as tsim  # noqa: E402
from repro_torch.models.small import SMALL_MODELS, make_loss_fn  # noqa: E402
from test_torch_round import _init, one_torch_thread  # noqa: E402,F401

# tests/test_pool.py's federation and resume config
FEDN = dict(seed=11, n_priority=3, n_nonpriority=9, samples_per_client=64)
C = 12
BASE = dict(num_clients=C, num_priority=3, rounds=8, local_epochs=1,
            epsilon=0.3, warmup_frac=0.0, align_stat="loss", lr=0.1,
            batch_size=32)
POOL_ASYNC = dict(BASE, candidate_pool=6, server_opt="yogi", server_lr=0.3,
                  backend="scan_async", async_depth=2, staleness_decay=0.9)


@functools.lru_cache(maxsize=None)
def federations():
    """FEDN in both packages, made once per module: the SYNTH generator
    draws each client with small SVDs, which crawl beside other test
    workers."""
    return jax_synth(**FEDN), make_synth_federation(**FEDN)


@functools.lru_cache(maxsize=None)
def init_params():
    return _init("synth_logreg")


# every msgpack format the checkpoints use, at each width's edges
PAYLOADS = {
    "nil_bool": [None, True, False],
    "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
             2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
             -2**31 - 1, -2**63],
    "float64": [0.5, -0.0, 1e300, float("inf"), -2.5e-310],
    "str": ["", "a" * 31, "a" * 32, "b" * 255, "c" * 256, "d" * 65535,
            "e" * 65536, "été"],
    "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 65535, b"w" * 65536],
    "arrays": [[], [1] * 15, [2] * 16, [3] * 65535, [4] * 65536, (5, 6)],
    "maps": [{}, {str(i): i for i in range(15)},
             {str(i): i for i in range(16)},
             {i: None for i in range(65536)}],
    "leaves": {"treedef": "PyTreeDef(*)", "step": 3, "leaves": [
        np.zeros((2, 3), np.float32), np.arange(4, dtype=np.uint32),
        np.ones((), np.int32), np.zeros((0,), np.float32)],
        "meta": {"async_mode": "ready", "min_lag": 1, "x": 0.25,
                 "adaptive_staleness": False}},
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_codec_bytes_equal_msgpack(name):
    obj = PAYLOADS[name]
    want = msgpack.packb(obj, default=jax_encode)
    assert codec.packb(obj, default=jax_encode) == want
    got = codec.unpackb(want)
    if name != "leaves":
        assert got == msgpack.unpackb(want, strict_map_key=False)
    else:
        for a, b in zip(got["leaves"], obj["leaves"]):
            assert a[b"dtype"] == b.dtype.str and a[b"data"] == b.tobytes()
    with pytest.raises(ValueError):
        codec.unpackb(want + b"\xc0")


def _layout_cfgs():
    """Every state layout: the server optimizer x in-flight buffer x event
    clock x guard x error-feedback rows (x drift sketch with a buffer)."""
    for opt, buf, clock, guard, ef in itertools.product(
            ("none", "momentum", "adam", "yogi"), (0, 2), (False, True),
            (False, True), (False, True)):
        for sketch in (False, True) if buf else (False,):
            kw = dict(num_clients=5, num_priority=2, server_opt=opt,
                      divergence_guard=guard, sketch_dim=16)
            if buf:
                kw.update(backend="scan_async", async_depth=buf,
                          async_mode="ready", adaptive_staleness=sketch)
            if clock:
                kw.update(latency_mode="lognormal")
            if ef:
                kw.update(wire_codec="int8", error_feedback=True)
            yield kw


@pytest.mark.parametrize("opt", ["none", "momentum", "adam", "yogi"])
def test_state_layout_matches_reference(opt):
    """The written leaves of init_state for each layout: the treedef
    string, and each leaf's shape and dtype string, as the reference
    writes them."""
    p0 = init_params()
    tp0 = params_from_jax(jax.tree.map(np.asarray, p0), "cpu")
    n = 0
    for kw in _layout_cfgs():
        if kw["server_opt"] != opt:
            continue
        n += 1
        jstate = jengine.init_state(p0, JaxFedConfig(**kw), 5)
        state = engine.init_state(tp0, FedConfig(**kw), 5)
        jleaves, jtd = jax.tree.flatten({"state": jstate,
                                         "rng": jax.random.PRNGKey(0)})
        key = prng.PRNGKey(0).numpy().astype(np.uint32)
        leaves, td = flatten({"state": state, "rng": key})
        assert td == str(jtd), kw
        assert len(leaves) == len(jleaves), kw
        for a, b in zip(leaves, jleaves):
            a = np.asarray(a)
            b = np.asarray(b)
            assert (a.shape, a.dtype.str) == (b.shape, b.dtype.str), kw
    assert n == 24


def _ref_run(cfg, **kw):
    return jsim.run_federation(jax_loss_fn(JAX_MODELS["synth_logreg"][1]),
                               init_params(), JaxFedConfig(**cfg),
                               federations()[0], **kw)


def _port_run(cfg, p0=None, **kw):
    p0 = p0 if p0 is not None or "state" in kw else params_from_jax(
        jax.tree.map(np.asarray, init_params()), "cpu")
    return tsim.run_federation(make_loss_fn(SMALL_MODELS["synth_logreg"][1]),
                               p0, FedConfig(**cfg),
                               federations()[1], device="cpu",
                               **kw)


def _like(cfg):
    return engine.init_state(params_from_jax(
        jax.tree.map(np.asarray, init_params()), "cpu"),
        FedConfig(**cfg), C)


def _leaves_equal(a, b):
    la, lb = flatten(a)[0], flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_pooled_async_mid_flight_resume(tmp_path):
    """tests/test_pool.py's case in the port: interrupt a pooled
    scan_async run at round 5 with cohorts in flight, save, load, resume:
    every state leaf bit-identical to the uninterrupted run, pools and
    gates the same rounds; the uninterrupted run's checkpoints (one a
    chunk boundary) hold its final state."""
    path = str(tmp_path / "pool_async.msgpack")
    full = _port_run(POOL_ASYNC, eval_every=4,
                     checkpoint_path=str(tmp_path / "full.msgpack"))
    half = _port_run(dict(POOL_ASYNC, rounds=5), eval_every=4)
    assert float(half.state.inflight["valid"].sum()) > 0.0
    tsim.save_federation_state(path, half.state, half.rng, 5,
                               fed=FedConfig(**POOL_ASYNC))
    state, rng, step = tsim.load_federation_state(
        path, _like(POOL_ASYNC), fed=FedConfig(**POOL_ASYNC), device="cpu")
    assert step == 5 and torch.equal(rng, half.rng)
    resumed = _port_run(POOL_ASYNC, eval_every=4, state=state, rng=rng,
                        start_round=step)
    assert _leaves_equal(full.state, resumed.state)
    assert torch.equal(full.rng, resumed.rng)
    np.testing.assert_array_equal(np.array(full.gates[5:]),
                                  np.array(resumed.gates))
    final, _, step = tsim.load_federation_state(
        str(tmp_path / "full.msgpack"), _like(POOL_ASYNC), device="cpu")
    assert step == POOL_ASYNC["rounds"] and _leaves_equal(final, full.state)


def test_reference_checkpoint_resumes_in_port(tmp_path):
    """The reference writes a checkpoint at round 5 of the pooled async
    run under int8 + error feedback (its run_federation with
    checkpoint_path); the port loads it and resumes to round 8, which
    matches the reference's uninterrupted run."""
    cfg = dict(POOL_ASYNC, wire_codec="int8", error_feedback=True,
               server_opt="adam", server_lr=0.05)
    path = str(tmp_path / "ref.msgpack")
    _ref_run(dict(cfg, rounds=5), eval_every=4, checkpoint_path=path)
    want = _ref_run(cfg, eval_every=4)
    state, rng, step = tsim.load_federation_state(
        path, _like(cfg), fed=FedConfig(**cfg), device="cpu")
    assert step == 5
    got = _port_run(cfg, eval_every=4, state=state, rng=rng,
                    start_round=step)
    np.testing.assert_array_equal(np.array(got.gates),
                                  np.array(want.gates[5:]))
    np.testing.assert_array_equal(got.state.backlog.numpy(),
                                  np.asarray(want.state.backlog))
    for k, w in want.params.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got.params[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_port_checkpoint_loads_in_reference(tmp_path):
    """The port's file, written at the end of a pooled async run with the
    clock, the guard and int8 rows, loads in the reference's
    load_federation_state (with the fingerprint check), leaf for leaf and
    dtype for dtype; the reference writing the same tree back gives the
    same bytes."""
    cfg = dict(POOL_ASYNC, rounds=4, async_mode="ready",
               latency_mode="lognormal", divergence_guard=True,
               wire_codec="int8", error_feedback=True,
               adaptive_staleness=True)
    path = str(tmp_path / "port.msgpack")
    h = _port_run(cfg, eval_every=2, checkpoint_path=path)
    jfed = JaxFedConfig(**cfg)
    jlike = jengine.init_state(init_params(), jfed, C)
    jstate, jrng, step = jsim.load_federation_state(path, jlike, fed=jfed)
    assert step == cfg["rounds"]
    leaves, td = flatten({"state": h.state, "rng": h.rng})
    jleaves, jtd = jax.tree.flatten({"state": jstate, "rng": jrng})
    assert td == str(jtd) and len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        b = np.asarray(b)
        np.testing.assert_array_equal(a.numpy().astype(b.dtype), b)
    again = str(tmp_path / "again.msgpack")
    jsim.save_federation_state(again, jstate, jrng, step, fed=jfed)
    with open(path, "rb") as f, open(again, "rb") as g:
        assert f.read() == g.read()


def test_fingerprint_mismatch_raises(tmp_path):
    """The reference's ValueError for every shape-invisible knob the
    writer recorded; a matching config and no config load clean; a shape
    mismatch raises load_pytree's ValueError."""
    path = str(tmp_path / "fp.msgpack")
    cfg = dict(POOL_ASYNC, async_mode="ready", rounds=1)
    h = _port_run(cfg, checkpoint_path=path)
    like = _like(cfg)
    fed = FedConfig(**cfg)
    for kw, match in ((dict(async_mode="fifo"), "async_mode"),
                      (dict(candidate_pool=0), "candidate_pool"),
                      (dict(pool_weighting="backlog"), "pool_weighting"),
                      (dict(aggregator="median"), "aggregator"),
                      (dict(failure_model="crash"), "failure_model")):
        with pytest.raises(ValueError, match=match):
            tsim.load_federation_state(path, like, fed=fed.replace(**kw),
                                       device="cpu")
        with pytest.raises(ValueError, match=match):
            jsim.load_federation_state(
                path, jengine.init_state(init_params(),
                                         JaxFedConfig(**cfg), C),
                fed=JaxFedConfig(**cfg).replace(**kw))
    for f in (fed, None):
        state, _, _ = tsim.load_federation_state(path, like, fed=f,
                                                 device="cpu")
        assert _leaves_equal(state, h.state)
    with pytest.raises(ValueError, match="leaves"):
        tsim.load_federation_state(
            path, _like(dict(cfg, server_opt="momentum")), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_pytree(path, {"state": _like(dict(cfg, num_clients=C)),
                           "rng": torch.zeros(3, dtype=torch.int64)},
                    device="cpu")


def test_drain_rewrites_the_final_checkpoint(tmp_path):
    """With drain_inflight the final file holds the drained state (an
    empty buffer at the same step), as the reference's: resuming it and
    draining again applies nothing twice."""
    path, jpath = str(tmp_path / "d.msgpack"), str(tmp_path / "jd.msgpack")
    cfg = dict(POOL_ASYNC, rounds=4)
    h = _port_run(cfg, eval_every=2, checkpoint_path=path,
                  drain_inflight=True)
    _ref_run(cfg, eval_every=2, checkpoint_path=jpath, drain_inflight=True)
    state, rng, step = tsim.load_federation_state(path, _like(cfg),
                                                  device="cpu")
    jstate, _, jstep = tsim.load_federation_state(jpath, _like(cfg),
                                                  device="cpu")
    assert step == jstep == cfg["rounds"]
    assert float(state.inflight["valid"].sum()) == 0.0
    assert torch.equal(state.inflight["valid"], jstate.inflight["valid"])
    assert _leaves_equal(state, h.state)
    again = engine.drain_inflight(FedConfig(**cfg), state)
    assert all(torch.equal(again.params[k], h.params[k]) for k in h.params)


def test_save_load_pytree_roundtrip_dtypes(tmp_path):
    """Every dtype the port keeps, bfloat16 as the reference's '<V2'
    bytes, restored to the dtype and device of ``like``."""
    tree = {"a": torch.randn(3, 4), "b": (torch.arange(5, dtype=torch.int32),
                                          [torch.tensor(7)]),
            "c": torch.randn(6).to(torch.bfloat16), "d": ()}
    path = str(tmp_path / "t.msgpack")
    save_pytree(path, tree, step=None, meta=None)
    back, step, meta = load_pytree(path, tree, device="cpu")
    assert step is None and meta is None
    got, want = flatten(back)[0], flatten(tree)[0]
    assert all(torch.equal(x, y) and x.dtype == y.dtype
               for x, y in zip(got, want))
    with open(path, "rb") as f:
        raw = msgpack.unpackb(f.read(), strict_map_key=False)
    assert [x[b"dtype"] for x in raw["leaves"]] == [
        "<f4", "<i4", "<i8", "<V2"]
