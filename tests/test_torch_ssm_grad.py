"""The selective scan's gradient (``kernels/ssm_scan.py``: the ``SSMScan``
Function, its backward ``ssm_scan_bwd``) on the CPU: against ``jax.grad``
of the reference's jnp lowering ``repro.kernels.ops._ssm_scan_jnp`` (what
the reference's training differentiates) for all six inputs, x in f32 and
bf16, at a length that is not a multiple of any chunk; against autograd
through ``ssm_scan_plain`` in float64 across several backward chunks and
at chunk sizes that split the sequence differently; a float64
``gradcheck`` of the plain route; and the final state, which takes no
gradient.

Tolerances:
* against the reference in f32: 1e-5 x max(1, max|want|) per input (the
  reverse recurrence as associative scans against the reference's, in
  another order: ~4e-7 relative seen);
* dx with bf16 x: 2^-7 x (|scan part| + |D dy part|) plus that: the
  reference rounds the two parts of dx to bf16 apart and adds them in
  bf16, the port rounds their f32 sum once (cancellation between the
  parts puts the reference up to ~30 ulps of the sum away);
* float64 against autograd through the plain route: 1e-10 x max(1,
  max|want|) (the same math; only the order of f64 sums differs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssm_scan as sk  # noqa: E402

GRAD_TOL = 1e-5
F64_TOL = 1e-10
NAMES = ("x", "dt", "A", "B", "C", "D")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one torch thread for the module (see
    tests/test_torch_train.py), the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scan_inputs(Bt, S, Di, N, seed=0):
    """x, dt, A, B, C, D and an output gradient dy as numpy f32, drawn as
    tests/test_kernels.py shapes the scan's inputs."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    x = 0.5 * f(Bt, S, Di)
    dt = (0.1 * np.log1p(np.exp(f(Bt, S, Di)))).astype(np.float32)
    A = (-np.exp(0.5 * f(Di, N))).astype(np.float32)
    return [x, dt, A, f(Bt, S, N), f(Bt, S, N), f(Di)], f(Bt, S, Di)


def _leaves(arrays, dtype=torch.float32, x_dtype=None):
    out = [torch.tensor(a, dtype=dtype) for a in arrays]
    if x_dtype is not None:
        out[0] = out[0].to(x_dtype)
    return [t.requires_grad_(True) for t in out]


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_grad_of_the_reference(x_dtype):
    import jax
    import jax.numpy as jnp
    from repro.kernels.ops import _ssm_scan_jnp
    arrays, dy = scan_inputs(2, 37, 24, 16)
    jdt = jnp.dtype(x_dtype)
    jins = [jnp.asarray(arrays[0]).astype(jdt)] + [jnp.asarray(a) for a in arrays[1:]]
    jdy = jnp.asarray(dy).astype(jdt)

    def loss(*a):
        return jnp.sum(_ssm_scan_jnp(*a).astype(jnp.float32)
                       * jdy.astype(jnp.float32))
    want = jax.grad(loss, argnums=tuple(range(6)))(*jins)
    tdt = getattr(torch, x_dtype)
    ins = _leaves(arrays, x_dtype=tdt)
    y = sk.ssm_scan(*ins)
    assert y.dtype == tdt and y.grad_fn is not None
    got = torch.autograd.grad(y, ins, torch.tensor(dy).to(tdt))
    for name, g, w, t in zip(NAMES, got, want, ins):
        assert g.dtype == t.dtype, name
        g = g.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        bound = GRAD_TOL * max(1.0, float(np.abs(w).max()))
        if name == "x" and x_dtype == "bfloat16":
            # the reference rounds the scan's part and D dy's part of dx to
            # bf16 apart (one per use of x.astype) and adds them in bf16;
            # the port rounds their f32 sum once: 2^-8 relative a rounding
            d_part = (arrays[5] * np.asarray(jdy.astype(jnp.float32)))
            f32_ins = _leaves([t.detach().float().numpy() for t in ins])
            dx32 = torch.autograd.grad(
                sk.ssm_scan(*f32_ins), f32_ins[0],
                torch.tensor(np.asarray(jdy.astype(jnp.float32))))[0].numpy()
            parts = np.abs(dx32 - d_part) + np.abs(d_part)
            assert np.all(np.abs(g - w) <= 2.0 ** -7 * parts + bound), name
        else:
            assert float(np.abs(g - w).max()) <= bound, name


@pytest.mark.parametrize("S,chunk", [(130, 64), (130, 8), (64, 64), (1, 64),
                                     (37, 5)])
def test_backward_matches_autograd_through_the_plain_route(S, chunk,
                                                           monkeypatch):
    """ssm_scan_bwd's chunked scans against autograd through the plain
    sequential recurrence, float64, with chunks that split S evenly, not
    at all, or leave a ragged last chunk."""
    monkeypatch.setattr(sk, "BWD_CHUNK", chunk)
    arrays, dy = scan_inputs(2, S, 5, 4, seed=1)
    ins = _leaves(arrays, torch.float64)
    dy = torch.tensor(dy, dtype=torch.float64)
    got = torch.autograd.grad(sk.ssm_scan(*ins), ins, dy)
    want = torch.autograd.grad(sk.ssm_scan_plain(*ins), ins, dy)
    for name, g, w in zip(NAMES, got, want):
        bound = F64_TOL * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= bound, name


def test_gradcheck_float64_plain_route():
    arrays, _ = scan_inputs(1, 19, 3, 2, seed=2)
    ins = _leaves(arrays, torch.float64)
    assert torch.autograd.gradcheck(lambda *t: sk.ssm_scan(*t), ins)


def test_final_state_takes_no_gradient_and_forward_is_unchanged():
    arrays, dy = scan_inputs(2, 21, 6, 4, seed=3)
    ins = _leaves(arrays)
    y, h = sk.ssm_scan(*ins, return_state=True)
    assert h.grad_fn is None and not h.requires_grad
    want_y, want_h = sk.ssm_scan_plain(*[t.detach() for t in ins],
                                       return_state=True)
    assert torch.equal(y.detach(), want_y) and torch.equal(h, want_h)
    g_state = torch.autograd.grad(y, ins, torch.tensor(dy))
    g_plain = torch.autograd.grad(sk.ssm_scan(*ins), ins, torch.tensor(dy))
    for a, b in zip(g_state, g_plain):
        assert torch.equal(a, b)
    # no kernel launches on the CPU, under grad or not
    before = sk.ssm_scan.launches
    with torch.no_grad():
        sk.ssm_scan(*ins)
    assert sk.ssm_scan.launches == before
