"""The Theorem-1 testbed: the port's core/theory.py against the JAX
package's (numpy, float64) on the CPU.

Tolerances: the quadratic instances are byte-identical (both draw in numpy
in the same order); the gates of every round of ``run_fedalign_gd``
exactly equal, each round's margin ``min | |F_k - F| - eps |`` over the
non-priority clients asserted above 1e-9 so that the f64 rounding (the
port's batched einsums against the reference's per-client products,
~1e-15) cannot flip one; the histories, ``w_T`` and the closed forms
within 1e-12 of the reference's largest magnitude; ``excess(w)`` within
1e-12 of F(w) (the rounding of the reference's F(w) - F(w*)); the scalar
maths exactly. Then the reference's own tests/test_theory.py assertions,
re-run on the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import theory as ref  # noqa: E402
from repro_torch.core import theory  # noqa: E402

REL = 1e-12
MARGIN = 1e-9
INSTANCES = [dict(seed=0), dict(seed=3, n_priority=4, n_nonpriority=6, dim=8),
             dict(seed=4, n_priority=3, n_nonpriority=8, dim=6),
             dict(seed=1, n_nonpriority=6, nonpriority_align=np.linspace(1, 0, 6)),
             dict(seed=7, n_priority=2, n_nonpriority=5, dim=5, mu=0.2, L=6.0,
                  priority_spread=2.0)]


def _close(got, want, what):
    got = np.asarray(got.cpu() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    err = float(np.max(np.abs(got - want)))
    assert err <= REL * scale, f"{what}: {err} > {REL} x {scale}"


def _pair(kw):
    return ref.make_quadratic_pfl(**kw), theory.make_quadratic_pfl(**kw,
                                                                   device="cpu")


def _lr(q):
    L, mu = q.smoothness()
    gamma = max(8 * L / mu, 5)
    return L, mu, gamma, (lambda t: 2.0 / (mu * (t + gamma)))


@pytest.mark.parametrize("kw", INSTANCES, ids=lambda kw: f"seed{kw['seed']}")
def test_instance_is_byte_identical(kw):
    qj, qt = _pair(kw)
    for name in ("A", "c", "d", "priority_mask", "weights"):
        got = getattr(qt, name)
        assert got.dtype == (torch.bool if name == "priority_mask"
                             else torch.float64), name
        np.testing.assert_array_equal(got.numpy(), getattr(qj, name),
                                      err_msg=name)


@pytest.mark.parametrize("kw", INSTANCES, ids=lambda kw: f"seed{kw['seed']}")
def test_closed_forms_match(kw):
    qj, qt = _pair(kw)
    _close(qt.w_star(), qj.w_star(), "w_star")
    _close(qt.gamma(), qj.gamma(), "gamma")
    C = len(qj.d)
    _close(qt.gammas(), [qj.gamma_k(k) for k in range(C)], "gammas")
    for k in range(C):
        _close(qt.gamma_k(k), qj.gamma_k(k), f"gamma_k({k})")
    w = np.random.default_rng(kw["seed"]).normal(size=qj.c.shape[1])
    wt = torch.from_numpy(w)
    _close(qt.F(wt), qj.F(w), "F")
    _close(qt.losses(wt), [qj.F_k(w, k) for k in range(C)], "losses")
    for k in range(C):
        _close(qt.F_k(wt, k), qj.F_k(w, k), f"F_k({k})")
    for got, want in zip(qt.smoothness(), qj.smoothness()):
        _close(got, want, "smoothness")


@pytest.mark.parametrize("kw", INSTANCES, ids=lambda kw: f"seed{kw['seed']}")
@pytest.mark.parametrize("dist", [1e-3, 0.1, 3.0])
def test_excess_equals_the_loss_difference(kw, dist):
    """``excess(w)`` against the reference's F(w) - F(w*) at points
    ``dist`` from w*: within 1e-12 of the losses' own scale, the rounding
    of the reference's subtraction."""
    qj, qt = _pair(kw)
    u = np.random.default_rng(kw["seed"]).normal(size=qj.c.shape[1])
    w = qj.w_star() + dist * u / np.linalg.norm(u)
    got = float(qt.excess(torch.from_numpy(w)))
    want = qj.F(w) - qj.F(qj.w_star())
    assert got > 0
    assert abs(got - want) <= REL * abs(qj.F(w)), (got, want)


def _reference_run(q, T, E, eps, lr_fn):
    """The reference's run with each round's gates, recovered from the w
    its loop hands to ``q.F`` once a round (the round's first call)."""
    ws = []
    F = q.F
    q.F = lambda w: (ws.append(np.array(w)), F(w))[1]
    try:
        out = ref.run_fedalign_gd(q, T, E, eps, lr_fn)
    finally:
        del q.F
    C = len(q.d)
    gates = np.array([np.where(q.priority_mask, 1.0,
                               (np.abs(np.array([q.F_k(w, k) for k in range(C)])
                                       - F(w)) < eps).astype(float))
                      for w in ws])
    return out, gates


@pytest.mark.parametrize("kw", INSTANCES[1:3], ids=lambda kw: f"seed{kw['seed']}")
@pytest.mark.parametrize("eps", [0.0, 0.2, 0.5, 2.0, 1e9])
@pytest.mark.parametrize("E", [1, 5])
def test_run_fedalign_gd_matches_reference(kw, eps, E):
    qj, qt = _pair(kw)
    _, _, _, lr_fn = _lr(qj)
    T = 40
    (wj, thj, rhj), gates_j = _reference_run(qj, T, E, eps, lr_fn)
    rec = {}
    wt, tht, rht = theory.run_fedalign_gd(qt, T, E, eps, lr_fn, record=rec)
    assert rec["margin"].min() > MARGIN, rec["margin"].min()
    np.testing.assert_array_equal(rec["gates"], gates_j)
    assert isinstance(tht, np.ndarray) and tht.shape == (T,)
    _close(tht, thj, "theta history")
    _close(rht, rhj, "rho history")
    _close(wt, wj, "w_T")


def test_gates_select_on_the_bench_instance():
    """bench_theory.py's instance at its eps grid: the gates of eps 0.5
    admit some but not all non-priority clients, so the exact-gate check
    above is not vacuous."""
    qt = theory.make_quadratic_pfl(seed=3, n_priority=4, n_nonpriority=6,
                                   dim=8, device="cpu")
    _, _, _, lr_fn = _lr(qt)
    rec = {}
    theory.run_fedalign_gd(qt, 40, 5, 0.5, lr_fn, record=rec)
    admitted = rec["gates"][:, 4:].sum()
    assert 0 < admitted < 40 * 6


def test_scalar_maths_match():
    args = dict(L=4.0, mu=0.5, sigma=0.3, G=2.5, E=5, w0_dist_sq=1.7)
    assert theory.theorem1_constants(**args) == ref.theorem1_constants(**args)
    kw = dict(C1=3.0, C2=4.5, gamma=64.0, Gamma=0.25, theta_T=0.8, rho_T=0.01)
    assert theory.theorem1_bound(300, **kw) == ref.theorem1_bound(300, **kw)
    rng = np.random.default_rng(0)
    th, rh = rng.uniform(0.5, 1, 30), rng.uniform(0, 0.1, 30)
    want = ref.empirical_theta_rho(list(th), list(rh), 64.0, 5)
    assert theory.empirical_theta_rho(list(th), list(rh), 64.0, 5) == want
    assert theory.empirical_theta_rho(th, rh, 64.0, 5) == want
    assert theory.empirical_theta_rho(torch.from_numpy(th),
                                      torch.from_numpy(rh), 64.0, 5) == want


def test_entry_points_refuse_to_run_on_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        theory.make_quadratic_pfl(seed=0)


# ---------------------------------- the reference's tests/test_theory.py
def test_quadratic_closed_forms():
    q = theory.make_quadratic_pfl(seed=0, device="cpu")
    ws = q.w_star()
    # gradient of the priority objective vanishes at w*
    grad = sum(q.weights[k] * q.A[k] @ (ws - q.c[k])
               for k in range(len(q.d)) if q.priority_mask[k])
    assert float(torch.linalg.norm(grad)) < 1e-8
    assert float(q.gamma()) >= -1e-10
    L, mu = q.smoothness()
    assert L >= mu > 0


def test_aligned_nonpriority_have_small_gamma_k():
    q = theory.make_quadratic_pfl(seed=1, n_nonpriority=6,
                                  nonpriority_align=np.linspace(1, 0, 6),
                                  device="cpu")
    gks = [float(q.gamma_k(k)) for k in range(4, 10)]
    assert gks[0] < gks[-1]          # aligned client -> small Gamma_k
    assert gks[0] < 0.5


def test_theorem1_bound_holds_on_quadratic():
    q = theory.make_quadratic_pfl(seed=3, n_priority=4, n_nonpriority=6,
                                  dim=8, device="cpu")
    L, mu, gamma, lr_fn = _lr(q)
    E, T_rounds = 5, 60
    w_T, theta_hist, rho_hist = theory.run_fedalign_gd(q, T_rounds, E, 0.5,
                                                       lr_fn)
    err = float(q.F(w_T) - q.F(q.w_star()))
    G2 = max(float(torch.linalg.norm(q.A[k] @ (torch.zeros(8, dtype=torch.float64)
                                               - q.c[k]))) ** 2
             for k in range(len(q.d))) * 4 + 1.0
    C1, C2, _ = theory.theorem1_constants(
        L, mu, sigma=0.0, G=np.sqrt(G2), E=E,
        w0_dist_sq=float(torch.linalg.norm(q.w_star())) ** 2)
    theta_T, rho_un = theory.empirical_theta_rho(theta_hist, rho_hist, gamma, E)
    bound = theory.theorem1_bound(T_rounds * E, C1=C1, C2=C2, gamma=gamma,
                                  Gamma=float(q.gamma()), theta_T=theta_T,
                                  rho_T=2 * L / mu * rho_un)
    assert err <= bound, (err, bound)
    assert 0 < theta_T <= 1.0


def test_theta_rho_tradeoff_direction():
    q = theory.make_quadratic_pfl(seed=4, n_priority=3, n_nonpriority=8, dim=6,
                                  device="cpu")
    L, mu, gamma, lr_fn = _lr(q)
    res = {}
    for eps in (0.0, 0.3, 3.0, 1e9):
        _, th, rh = theory.run_fedalign_gd(q, 30, 5, eps, lr_fn)
        res[eps] = theory.empirical_theta_rho(th, rh, gamma, 5)
    assert res[0.0][0] == pytest.approx(1.0 * 30 * 5 / (30 * 5 + gamma - 2), rel=1e-6)
    assert res[1e9][0] < res[0.3][0] <= res[0.0][0] + 1e-9
    assert res[1e9][1] >= res[0.0][1]
    assert res[0.0][1] == 0.0


def test_eps_zero_recovers_fedavg_priority_rate():
    q = theory.make_quadratic_pfl(seed=5, device="cpu")
    _, _, _, lr_fn = _lr(q)
    w_a, _, _ = theory.run_fedalign_gd(q, 20, 5, eps=0.0, lr_fn=lr_fn)
    # manual FedAvg over priority clients only
    C = len(q.d)
    w = torch.zeros(q.c.shape[1], dtype=torch.float64)
    t = 0
    for r in range(20):
        locals_ = []
        for k in range(C):
            wk = w.clone()
            for e in range(5):
                wk = wk - lr_fn(t + e) * (q.A[k] @ (wk - q.c[k]))
            locals_.append(wk)
        t += 5
        wg = q.weights * q.priority_mask
        w = torch.einsum("k,ki->i", wg, torch.stack(locals_)) / wg.sum()
    np.testing.assert_allclose(w_a.numpy(), w.numpy(), atol=1e-10)
