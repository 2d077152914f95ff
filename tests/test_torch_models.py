"""The paper's small models in the port against repro.models.small: same
parameter names and layouts, and the same loss, accuracy and gradients on
the same inputs with the reference's parameters carried across."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import small as ref  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.models import small  # noqa: E402

# (input shape, classes) of each model's data
SPECS = {"logreg": ((784,), 10), "mlp2": ((784,), 47),
         "cnn": ((32, 32, 3), 10), "synth_logreg": ((60,), 10)}
# f32 on both sides; only the order of the sums inside the matmuls and
# convolutions differs, which moves a loss or gradient of O(1) by ~1e-6
ATOL = 1e-5


def _ref_params(name, seed):
    init, _ = ref.SMALL_MODELS[name]
    p = init(jax.random.PRNGKey(seed))
    if name in ("logreg", "synth_logreg"):
        # their reference init is all zeros: draw weights so the test
        # exercises the matmul, not just the bias
        rng = np.random.default_rng(seed)
        p = {k: jnp.asarray(rng.normal(0, 0.1, v.shape), jnp.float32)
             for k, v in p.items()}
    return p


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_loss_acc_and_grads_match_reference(name, seed):
    shape, classes = SPECS[name]
    rng = np.random.default_rng(100 + seed)
    x = rng.normal(size=(16,) + shape).astype(np.float32)
    y = rng.integers(0, classes, 16).astype(np.int32)
    p = _ref_params(name, seed)
    (loss, met), grads = jax.value_and_grad(
        ref.make_loss_fn(ref.SMALL_MODELS[name][1]), has_aux=True)(
            p, {"x": jnp.asarray(x), "y": jnp.asarray(y)})

    loss_fn = small.make_loss_fn(small.SMALL_MODELS[name][1])
    tp = params_from_jax(jax.tree.map(np.asarray, p), "cpu")
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    tgrads, (tloss, tmet) = torch.func.grad_and_value(
        lambda q: loss_fn(q, batch), has_aux=True)(tp)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=0, atol=ATOL)
    # accuracy is a count over 16 examples: exact unless a logit tie flips
    assert float(tmet["acc"]) == float(met["acc"])
    tg = params_to_numpy(tgrads)
    assert sorted(tg) == sorted(grads)
    for k in grads:
        np.testing.assert_allclose(tg[k], np.asarray(grads[k]), rtol=0,
                                   atol=ATOL, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_init_names_shapes_and_generator(name):
    want = ref.SMALL_MODELS[name][0](jax.random.PRNGKey(0))
    init_fn, _ = small.SMALL_MODELS[name]
    got = init_fn(3, "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())
    again = init_fn(torch.Generator().manual_seed(3), "cpu")
    for k in got:
        torch.testing.assert_close(got[k], again[k], rtol=0, atol=0)


def test_cnn_flattens_in_reference_hwc_order():
    """Only f1's rows for one (h, w, c) input are nonzero: the logits move
    only if the port flattens [B, 8, 8, 64] in the reference's order."""
    p = _ref_params("cnn", 0)
    f1 = np.zeros((64 * 8 * 8, 128), np.float32)
    f1[(3 * 8 + 5) * 64 + 7] = 1.0            # h=3, w=5, c=7 in (h, w, c)
    p = dict(p, f1=jnp.asarray(f1))
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(np.float32)
    want = np.asarray(ref.cnn_apply(p, jnp.asarray(x)))
    got = small.SMALL_MODELS["cnn"][1](
        params_from_jax(jax.tree.map(np.asarray, p), "cpu"),
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
