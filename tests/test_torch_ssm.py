"""The selective scan (K8), the Mamba mixer and the MoE FFN of the port
against the JAX package on the CPU; on a CUDA card the scan kernel against
its plain version.

* ``ssm_scan_plain`` against the reference's three: the sequential oracle
  ``kernels/ref.py:ssm_scan_ref``, the chunked jnp lowering
  ``ops.ssm_scan(use_pallas=False)`` and ``ssm_scan_pallas`` in interpret
  mode, at tests/test_kernels.py's shapes, plus a length that is not a
  multiple of the chunk (the oracle and the lowering: the Pallas kernel
  asserts S % chunk == 0); its final state against
  ``models/ssm.py:_final_state``; ``ssm_step`` against ``ops.ssm_step``;
* ``mamba_block`` in train, prefill (output and cache) and decode, and
  ``moe_apply`` at a capacity that drops tokens and at one that drops none,
  with the smoke jamba's params carried across;
* the wrapper under grad (the SSMScan Function; once ROADMAP A16f's
  refusal), on the CPU and the card;
* on the card only: the kernel against ``ssm_scan_plain``, f32 and bf16 x,
  N in {4, 8, 16}, ragged S and Di, Bt 1 and 3, with its final state.

Tolerances:
* the scan against the reference: the reference's own tolerance for its
  scans against the oracle (tests/test_kernels.py), atol 2e-5 + rtol 2e-4;
  a bf16 output within one bf16 ulp of the oracle's plus that;
* blocks (mamba, moe): PARITY x max(1, max|want|), a handful of chained f32
  products of K <= 544 terms, each off by ~sqrt(K) 2^-24 relative in
  another summation order;
* the kernel against its plain version on the card: f32 within 1e-5 x
  max(1, max|y|) (the same recurrence, FMA contraction and expf vs the
  plain exp differ by an ulp a step, and the decaying state does not let
  them grow); a bf16 y within one bf16 ulp plus that.

The JAX package is imported inside the tests that use it, so the card-only
cases also run on a machine without JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssm.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssm_scan as sk  # noqa: E402

SCAN_TOL = dict(atol=2e-5, rtol=2e-4)
PARITY = 2e-5
KERNEL_TOL = 1e-5

# (Bt, S, Di, N, chunk): tests/test_kernels.py's, and a ragged S
REF_CASES = [(1, 64, 16, 4, 16), (2, 128, 32, 8, 32), (2, 96, 8, 16, 32)]
RAGGED = (2, 50, 12, 16, 16)
# card: (Bt, S, Di, N): ragged S and Di, Bt 1 and 3, N in {4, 8, 16}, and
# a grid of more blocks than the card's SMs
KERNEL_CASES = [(1, 64, 128, 4), (3, 77, 200, 8), (1, 300, 130, 16),
                (3, 129, 256, 16), (2, 1, 64, 16), (2, 77, 16400, 8)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors, where torch's intra-op thread pool costs more
    than it saves, badly so with several test workers on the host's cores:
    one thread for the module, the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def scan_inputs(Bt, S, Di, N, seed=0):
    """x, dt, A, B, C, D as numpy f32, drawn as tests/test_kernels.py
    shapes them: dt = 0.1 softplus(normal), A = -exp(0.5 normal)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    x = 0.5 * f(Bt, S, Di)
    dt = (0.1 * np.log1p(np.exp(f(Bt, S, Di)))).astype(np.float32)
    A = (-np.exp(0.5 * f(Di, N))).astype(np.float32)
    return x, dt, A, f(Bt, S, N), f(Bt, S, N), f(Di)


def _t(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


# ------------------------------------------------------------ plain vs JAX
@pytest.mark.parametrize("Bt,S,Di,N,chunk", REF_CASES + [RAGGED])
def test_scan_plain_matches_reference_scans(Bt, S, Di, N, chunk):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref
    from repro.kernels.ssm_scan import ssm_scan_pallas
    arrs = scan_inputs(Bt, S, Di, N, seed=S)
    got = sk.ssm_scan_plain(*_t(arrs)).numpy()
    j = [jnp.asarray(a) for a in arrs]
    np.testing.assert_allclose(got, np.asarray(ref.ssm_scan_ref(*j)), **SCAN_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.ssm_scan(*j, chunk=chunk)),
                               **SCAN_TOL)
    if S % chunk == 0:
        pal = ssm_scan_pallas(*j, chunk=chunk, block_d=max(Di // 2, 1),
                              interpret=True)
        np.testing.assert_allclose(got, np.asarray(pal), **SCAN_TOL)
    # the wrapper takes the plain version for CPU tensors; chunk changes nothing
    assert torch.equal(ops.ssm_scan(*_t(arrs), chunk=chunk),
                       ops.ssm_scan(*_t(arrs), chunk=1))


def test_scan_plain_bf16_x_matches_the_oracle():
    import jax.numpy as jnp
    from repro.kernels import ref
    x, *rest = scan_inputs(2, 40, 24, 16, seed=5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = sk.ssm_scan_plain(xb, *_t(rest))
    assert got.dtype == torch.bfloat16
    want = np.asarray(ref.ssm_scan_ref(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                                       *[jnp.asarray(a) for a in rest]), np.float32)
    err = np.abs(got.float().numpy() - want)
    assert np.all(err <= _bf16_ulp(want) + SCAN_TOL["atol"] + SCAN_TOL["rtol"] * np.abs(want))


def test_final_state_matches_reference():
    import jax.numpy as jnp
    from repro.models.ssm import _final_state
    x, dt, A, B, C, D = scan_inputs(2, 37, 20, 16, seed=3)
    y, h = sk.ssm_scan_plain(*_t((x, dt, A, B, C, D)), return_state=True)
    assert h.shape == (2, 20, 16) and h.dtype == torch.float32
    want = _final_state(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A), jnp.asarray(B))
    np.testing.assert_allclose(h.numpy(), np.asarray(want), **SCAN_TOL)
    assert torch.equal(y, sk.ssm_scan_plain(*_t((x, dt, A, B, C, D))))


def test_ssm_step_matches_reference_and_replays_the_scan():
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    x, dt, A, B, C, D = scan_inputs(2, 16, 8, 4, seed=4)
    h = torch.zeros(2, 8, 4)
    hj = jnp.zeros((2, 8, 4))
    outs = []
    for t in range(16):
        h, y = ops.ssm_step(h, *_t((x[:, t], dt[:, t], A, B[:, t], C[:, t])))
        hj, yj = jops.ssm_step(hj, *[jnp.asarray(a) for a in
                                     (x[:, t], dt[:, t], A, B[:, t], C[:, t])])
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), **SCAN_TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), **SCAN_TOL)
        outs.append(y + torch.from_numpy(x[:, t] * D[None]))
    want, h_scan = sk.ssm_scan_plain(*_t((x, dt, A, B, C, D)), return_state=True)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), want.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), h_scan.numpy(), **SCAN_TOL)


# -------------------------------------------------------------- gradients
@pytest.mark.parametrize("which", [0, 1, 2, 5])
def test_scan_refuses_grad(which):
    """Once a refusal (ROADMAP A16f), now the gradient: with one input
    requiring grad, ``ssm_scan`` builds a graph through the SSMScan
    Function whose gradient for that input is autograd's through the
    plain recurrence (f32, PARITY of the largest magnitude); under
    no_grad it builds none (tests/test_torch_ssm_grad.py has the rest)."""
    t = _t(scan_inputs(1, 8, 4, 4))
    t[which].requires_grad_(True)
    y = sk.ssm_scan(*t)
    assert y.grad_fn is not None
    dy = torch.from_numpy(np.random.default_rng(1).normal(
        size=y.shape).astype(np.float32))
    got = torch.autograd.grad(y, t[which], dy)[0]
    want = torch.autograd.grad(sk.ssm_scan_plain(*t), t[which], dy)[0]
    assert float((got - want).abs().max()) <= PARITY * max(
        1.0, float(want.abs().max()))
    with torch.no_grad():
        y, h = sk.ssm_scan(*t, return_state=True)
    assert y.grad_fn is None and h.shape == (1, 4, 4)


def test_scan_checks_shapes():
    x, dt, A, B, C, D = _t(scan_inputs(1, 8, 4, 4))
    with pytest.raises(ValueError, match="dt"):
        sk.ssm_scan(x, dt[:, :4], A, B, C, D)
    with pytest.raises(ValueError, match="D"):
        sk.ssm_scan(x, dt, A, B, C, D[:2])
    with pytest.raises(ValueError, match="chunk"):
        sk.ssm_scan(x, dt, A, B, C, D, chunk=0)


# ------------------------------------------------------------ blocks vs JAX
@pytest.fixture(scope="module")
def jamba_pair():
    """(jax cfg, port cfg, jax params of period 0, port params carried
    across) for the smoke jamba."""
    import jax
    from repro.configs import get_smoke as jax_get_smoke
    from repro.models import transformer as JT
    from repro_torch.configs import get_smoke
    from repro_torch.convert import params_from_jax
    from repro_torch.utils import tree_map
    jcfg = jax_get_smoke("jamba_1_5_large_398b").replace(remat=False)
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    jp0 = jax.tree.map(lambda a: a[0], jp["periods"])
    tp0 = tree_map(lambda a: a[0], params_from_jax(jax.tree.map(np.asarray, jp), "cpu")["periods"])
    return jcfg, get_smoke("jamba_1_5_large_398b"), jp0, tp0


def _close(got, want, tol=PARITY):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err} > {tol} x {scale}"


def test_mamba_block_three_modes(jamba_pair):
    import jax.numpy as jnp
    from repro.models import ssm as JS
    from repro_torch.models import ssm as TS
    jcfg, tcfg, jp0, tp0 = jamba_pair
    jp, tp = jp0["l1"]["mamba"], tp0["l1"]["mamba"]
    S = 11
    x = np.random.default_rng(0).normal(size=(2, S + 3, tcfg.d_model)).astype(np.float32)
    jy, _ = JS.mamba_block(jp, jnp.asarray(x[:, :S]), jcfg, mode="train")
    ty, tc = TS.mamba_block(tp, torch.from_numpy(x[:, :S]), tcfg, mode="train")
    assert tc is None
    _close(ty, jy)
    jy, jc = JS.mamba_block(jp, jnp.asarray(x[:, :S]), jcfg, mode="prefill")
    ty, tc = TS.mamba_block(tp, torch.from_numpy(x[:, :S]), tcfg, mode="prefill")
    _close(ty, jy)
    for name in ("conv", "h"):
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name])
    assert tc["h"].dtype == torch.float32
    for t in range(S, S + 3):          # decode steps, the cache updated in place
        conv, h = tc["conv"], tc["h"]
        jy, jc = JS.mamba_block(jp, jnp.asarray(x[:, t:t + 1]), jcfg, mode="decode",
                                cache=jc)
        ty, tc = TS.mamba_block(tp, torch.from_numpy(x[:, t:t + 1]), tcfg,
                                mode="decode", cache=tc)
        assert tc["conv"] is conv and tc["h"] is h
        _close(ty, jy)
        for name in ("conv", "h"):
            _close(tc[name], jc[name])


def test_init_mamba_keeps_A_log_and_D_f32():
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import init_mamba
    cfg = get_config("jamba-1.5-large-398b").replace(d_model=64, ssm_dt_rank=8)
    p = init_mamba(prng.PRNGKey(0), cfg)
    assert p["w_in"].dtype == torch.bfloat16 and p["dt_bias"].dtype == torch.bfloat16
    assert p["A_log"].dtype == torch.float32 and p["D"].dtype == torch.float32
    want = np.log(np.expm1(np.float32(0.01)))
    assert float(p["dt_bias"][0]) == float(torch.tensor(want).to(torch.bfloat16))


@pytest.mark.parametrize("capacity_factor,S,shared", [(0.5, 24, 0), (16.0, 9, 0),
                                                     (1.25, 12, 1)],
                         ids=["drops", "no_drop", "shared_expert"])
def test_moe_apply_matches_reference(jamba_pair, capacity_factor, S, shared):
    import jax
    import jax.numpy as jnp
    from repro.models import moe as JM
    from repro_torch.convert import params_from_jax
    from repro_torch.models import moe as TM
    jcfg, tcfg, jp0, tp0 = jamba_pair
    knobs = dict(capacity_factor=capacity_factor, num_shared_experts=shared)
    jcfg, tcfg = jcfg.replace(**knobs), tcfg.replace(**knobs)
    jp, tp = jp0["l1"]["moe"], tp0["l1"]["moe"]
    if shared:
        jp = JM.init_moe(jax.random.PRNGKey(3), jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(1).normal(size=(2, S, tcfg.d_model)).astype(np.float32)
    jy, jaux = JM.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = TM.moe_apply(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    for name in ("lb_loss", "router_z"):
        _close(taux[name], jaux[name])
    assert float(taux["drop_frac"]) == float(jaux["drop_frac"])
    if capacity_factor > 1:
        assert float(taux["drop_frac"]) == 0.0 or shared
    else:
        assert float(taux["drop_frac"]) > 0.0          # the spill row is in use


def test_moe_top_k_ties_go_to_the_lower_index():
    """jax.lax.top_k's tie order: equal router probabilities pick the
    lower expert first (a zero router gives every expert the same)."""
    import jax.numpy as jnp
    from repro.models import moe as JM
    from repro_torch.configs import get_smoke
    from repro_torch.models import moe as TM
    from repro.configs import get_smoke as jax_get_smoke
    tcfg = get_smoke("jamba_1_5_large_398b")
    jcfg = jax_get_smoke("jamba_1_5_large_398b")
    rng = np.random.default_rng(2)
    d, E, f = tcfg.d_model, tcfg.num_experts, tcfg.moe_d_ff
    p = {"w_router": np.zeros((d, E), np.float32),
         "w_gate": rng.normal(size=(E, d, f)).astype(np.float32) * 0.1,
         "w_up": rng.normal(size=(E, d, f)).astype(np.float32) * 0.1,
         "w_down": rng.normal(size=(E, f, d)).astype(np.float32) * 0.1}
    x = rng.normal(size=(1, 5, d)).astype(np.float32)
    jy, jaux = JM.moe_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    ty, taux = TM.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), tcfg)
    _close(ty, jy)
    assert float(taux["drop_frac"]) == float(jaux["drop_frac"]) > 0.0


# --------------------------------------------------------------- the card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bt,S,Di,N", KERNEL_CASES)
def test_scan_kernel_matches_plain(cuda_device, Bt, S, Di, N, dtype):
    x, *rest = scan_inputs(Bt, S, Di, N, seed=Di)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).to(cuda_device)
    rt = _t(rest, cuda_device)
    before = sk.ssm_scan.launches
    y, h = sk.ssm_scan(xt, *rt, return_state=True)
    torch.cuda.synchronize()
    assert sk.ssm_scan.launches == before + 1
    want, h_want = sk.ssm_scan_plain(xt, *rt, return_state=True)
    y, want = y.float().cpu().numpy(), want.float().cpu().numpy()
    bound = KERNEL_TOL * max(1.0, float(np.abs(want).max()))
    if dtype == "bfloat16":
        bound = bound + _bf16_ulp(want)
    assert np.all(np.abs(y - want) <= bound)
    h, h_want = h.cpu().numpy(), h_want.cpu().numpy()
    assert np.abs(h - h_want).max() <= KERNEL_TOL * max(1.0, float(np.abs(h_want).max()))


@pytest.mark.cuda
def test_scan_kernel_refuses_what_it_does_not_take(cuda_device):
    x, dt, A, B, C, D = _t(scan_inputs(1, 8, 40, 4), cuda_device)
    with pytest.raises(ValueError, match="states"):
        sk.ssm_scan(x, dt, torch.zeros(40, 17, device=cuda_device),
                    torch.zeros(1, 8, 17, device=cuda_device),
                    torch.zeros(1, 8, 17, device=cuda_device), D)
    with pytest.raises(TypeError, match="float32"):
        sk.ssm_scan(x, dt.double(), A, B, C, D)
    with pytest.raises(ValueError, match="contiguous"):
        sk.ssm_scan(x, dt, A, B.transpose(1, 2).contiguous().transpose(1, 2), C, D)
    # under grad the kernel still runs (one launch), now with a backward
    before = sk.ssm_scan.launches
    y = sk.ssm_scan(x.requires_grad_(True), dt, A, B, C, D)
    assert y.grad_fn is not None and sk.ssm_scan.launches == before + 1
