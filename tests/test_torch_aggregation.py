"""Gated aggregation in the port against repro.core.aggregation: the fused
[C, M_total] path, the per-leaf path, the delta form with both wire dtypes
and the sgd server step, on the same client trees; and the zero-inclusion
round that must leave the params bit-exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.data.synth import make_synth_federation  # noqa: E402
from repro_torch.fl import engine  # noqa: E402
from repro_torch.models.small import SMALL_MODELS, make_loss_fn  # noqa: E402
from repro_torch import prng  # noqa: E402

SHAPES = {"b": (10,), "w": (60, 10), "c": (5, 5, 3, 4), "z": (7,)}


def _tree(C, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(C,) + s).astype(dtype) for k, s in SHAPES.items()}


def _wg(C, seed):
    rng = np.random.default_rng(seed + 1)
    w = (rng.random(C) + 0.1).astype(np.float32)
    g = (rng.random(C) > 0.4).astype(np.float32)
    g[0] = 1.0
    return w, g


def _close(got, want, dtype):
    """f32: the sums run in another order (1e-5 abs on O(1) values). bf16:
    within one bf16 ulp of the reference's bf16 result."""
    for k in want:
        a = np.asarray(got[k], np.float32)
        b = np.asarray(jnp.asarray(want[k]).astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=k)
        else:
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -126))) - 7)
            assert np.all(np.abs(a - b) <= ulp), k


def _to_t(tree, dtype="float32"):
    return {k: torch.from_numpy(np.array(v)).to(getattr(torch, dtype))
            for k, v in tree.items()}


def test_flatten_stacked_matches_reference_layout():
    tree = _tree(4, 0)
    want = np.asarray(jagg.flatten_stacked(jax.tree.map(jnp.asarray, tree)))
    got = agg.flatten_stacked(_to_t(tree))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # rows start on 16-byte boundaries for the kernel's widest loads
    assert got.stride(0) % 4 == 0 and got.stride(1) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_leaf"])
def test_aggregate_clients_matches_reference(fused, dtype):
    C = 6
    tree, (w, g) = _tree(C, 1), _wg(C, 1)
    jt = jax.tree.map(lambda a: jnp.asarray(a).astype(getattr(jnp, dtype)), tree)
    want = jagg.aggregate_clients(jt, jnp.asarray(w), jnp.asarray(g),
                                  fused=fused)
    got = agg.aggregate_clients(
        _to_t({k: np.asarray(v.astype(jnp.float32)) for k, v in jt.items()},
              dtype), torch.from_numpy(w), torch.from_numpy(g), fused=fused)
    assert all(got[k].dtype == getattr(torch, dtype) for k in got)
    _close({k: v.float().numpy() for k, v in got.items()}, want, dtype)


def test_fused_equals_per_leaf():
    tree, (w, g) = _tree(5, 2), _wg(5, 2)
    a = agg.aggregate_clients(_to_t(tree), torch.from_numpy(w),
                              torch.from_numpy(g), fused=True)
    b = agg.aggregate_clients(_to_t(tree), torch.from_numpy(w),
                              torch.from_numpy(g), fused=False)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=1e-6)


@pytest.mark.parametrize("agg_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_leaf"])
def test_aggregate_delta_and_server_step_match_reference(agg_dtype, fused):
    C = 5
    clients, (w, g) = _tree(C, 3), _wg(C, 3)
    glob = {k: v[0] * 0.5 for k, v in _tree(1, 4).items()}
    kw = dict(agg_dtype=agg_dtype, fused_agg=fused)
    jfed, fed = JaxFedConfig(**kw), FedConfig(**kw)
    jd = jagg.aggregate_delta(jax.tree.map(jnp.asarray, glob),
                              jax.tree.map(jnp.asarray, clients),
                              jnp.asarray(w), jnp.asarray(g), fed=jfed)
    d = agg.aggregate_delta(_to_t(glob), _to_t(clients), torch.from_numpy(w),
                            torch.from_numpy(g), fed=fed)
    assert all(d[k].dtype == getattr(torch, agg_dtype) for k in d)
    _close({k: v.float().numpy() for k, v in d.items()}, jd, agg_dtype)
    # the sgd server step on the SAME delta is elementwise: bit-exact
    jnew, jstate = jagg.apply_server_opt(jfed, jax.tree.map(jnp.asarray, glob),
                                         (), jd)
    new, state = agg.apply_server_opt(
        fed, _to_t(glob), (),
        {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
            getattr(torch, agg_dtype)) for k, v in jd.items()})
    assert state == () and jstate == ()
    for k in jnew:
        np.testing.assert_array_equal(new[k].numpy(), np.asarray(jnew[k]))


def test_aggregate_updates_matches_reference():
    clients, (w, g) = _tree(4, 5), _wg(4, 5)
    glob = {k: v[0] for k, v in _tree(1, 6).items()}
    jnew, _ = jagg.aggregate_updates(jax.tree.map(jnp.asarray, glob),
                                     jax.tree.map(jnp.asarray, clients),
                                     jnp.asarray(w), jnp.asarray(g),
                                     fed=JaxFedConfig())
    new, _ = agg.aggregate_updates(_to_t(glob), _to_t(clients),
                                   torch.from_numpy(w), torch.from_numpy(g),
                                   fed=FedConfig())
    _close({k: v.numpy() for k, v in new.items()}, jnew, "float32")


def test_zero_gates_aggregate_to_exact_zeros():
    tree = _tree(4, 7)
    out = agg.aggregate_clients(_to_t(tree), torch.ones(4), torch.zeros(4))
    assert all(bool(torch.all(v == 0)) for v in out.values())


@pytest.mark.parametrize("backend", ["vmap_spatial", "scan_temporal"])
def test_zero_inclusion_round_leaves_params_bit_exact(backend):
    """Every client weight 0: the inclusion mass is 0, the server step is
    skipped and the params come back bit-identical (not + 0 * delta)."""
    fedn = make_synth_federation(seed=0, n_priority=2, n_nonpriority=2,
                                 samples_per_client=16, test_samples=20)
    init_fn, apply_fn = SMALL_MODELS["synth_logreg"]
    params = params_from_jax({"w": np.random.default_rng(0).normal(
        size=(60, 10)).astype(np.float32), "b": np.zeros(10, np.float32)},
        "cpu")
    fed = FedConfig(num_clients=4, num_priority=2, rounds=2, local_epochs=1,
                    batch_size=8, backend=backend)
    round_fn = engine.make_round_fn(make_loss_fn(apply_fn), fed)
    state = engine.init_state(params, fed, 4)
    data = {"x": torch.from_numpy(fedn.x), "y": torch.from_numpy(fedn.y).long()}
    new, stats = round_fn(state, data, torch.from_numpy(fedn.priority_mask),
                          torch.zeros(4), prng.PRNGKey(0), 1)
    for k in params:
        np.testing.assert_array_equal(params_to_numpy(new.params)[k],
                                      params_to_numpy(params)[k])
    assert float(stats["included_nonpriority"]) >= 0


@pytest.mark.parametrize("bad", [np.nan, -0.5])
def test_check_client_weights_rejects_bad_weights(bad):
    w = np.ones(4, np.float32)
    w[2] = bad
    with pytest.raises(ValueError, match="client 2|clients \\[2\\]"):
        agg.check_client_weights(torch.from_numpy(w))
