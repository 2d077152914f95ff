"""repro_torch.prng against live jax.random: every integer output bitwise
equal (threefry2x32, partitionable streams), for several keys and sizes;
uniform, bernoulli and rademacher bitwise equal; normal within 3 ulp of
jax's draw (XLA's log1p inside erf_inv is not the host's), with fewer than
2% of the draws off at all."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.utils import fold_in_name as jax_fold_in_name  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.utils import fold_in_name  # noqa: E402

SEEDS = [0, 1, 42, -1, 2**31 - 1]
SIZES = [1, 2, 7, 40, 200, 1000]


def _jkey(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def test_threefry_partitionable_is_on():
    # the port reproduces the partitionable streams; the other setting
    # derives split/bits differently and every parity test would be moot
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  _jkey(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_split_bits_permutation(seed, n):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.split(tk, n).numpy(),
                                  _jkey(jax.random.split(jk, n)))
    np.testing.assert_array_equal(
        prng.bits(tk, (n,)).numpy(),
        np.asarray(jax.random.bits(jk, (n,))).astype(np.int64))
    np.testing.assert_array_equal(prng.permutation(tk, n).numpy(),
                                  np.asarray(jax.random.permutation(jk, n)))


@pytest.mark.parametrize("data", [0, 1, 17, 2**31 - 2, 2**32 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed, data):
    np.testing.assert_array_equal(
        prng.fold_in(prng.PRNGKey(seed), data).numpy(),
        _jkey(jax.random.fold_in(jax.random.PRNGKey(seed), data)))


@pytest.mark.parametrize("name", ["c1", "w1", "aggregator_noise", "f2"])
def test_fold_in_name(name):
    np.testing.assert_array_equal(
        fold_in_name(prng.PRNGKey(7), name).numpy(),
        _jkey(jax_fold_in_name(jax.random.PRNGKey(7), name)))


def test_bits_multidim_and_batched_keys():
    jk = jax.random.split(jax.random.PRNGKey(3), 4)
    tk = prng.split(prng.PRNGKey(3), 4)
    got = prng.bits(tk, (3, 5)).numpy()
    for i in range(4):
        np.testing.assert_array_equal(
            got[i], np.asarray(jax.random.bits(jk[i], (3, 5))).astype(np.int64))


def test_permutation_two_sort_rounds_and_batched_keys():
    # n > 1625 takes two sort rounds (ceil(3 ln n / ln(2^32 - 1)) = 2)
    jk = jax.random.split(jax.random.PRNGKey(5), 3)
    got = prng.permutation(prng.split(prng.PRNGKey(5), 3), 2000).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(jax.random.permutation(jk[i], 2000)))


def test_round_key_chain():
    """The chain the round consumes: driver split, participation split,
    local split, per-client keys, per-epoch keys and their permutations."""
    jr, tr = jax.random.PRNGKey(0), prng.PRNGKey(0)
    for _ in range(3):
        jr, jrk = jax.random.split(jr)
        tr, trk = prng.split(tr)
        jrk, _ = jax.random.split(jrk)
        trk, _ = prng.split(trk)
        _, jl = jax.random.split(jrk)
        _, tl = prng.split(trk)
        jcl = jax.random.split(jl, 6)
        tcl = prng.split(tl, 6)
        np.testing.assert_array_equal(tcl.numpy(), _jkey(jcl))
        tperm = prng.permutation(prng.split(tcl, 3), 40).numpy()
        for c in range(6):
            for e, ek in enumerate(jax.random.split(jcl[c], 3)):
                np.testing.assert_array_equal(
                    tperm[c, e], np.asarray(jax.random.permutation(ek, 40)))


@pytest.mark.parametrize("n", [1, 7, 1000, 100003])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bernoulli_rademacher_bit_exact(seed, n):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.uniform(tk, (n,)).numpy(),
                                  np.asarray(jax.random.uniform(jk, (n,))))
    np.testing.assert_array_equal(
        prng.uniform(tk, (n,), -0.5, 3.0).numpy(),
        np.asarray(jax.random.uniform(jk, (n,), minval=-0.5, maxval=3.0)))
    for p in (0.5, 0.1):
        np.testing.assert_array_equal(
            prng.bernoulli(tk, p, (n,)).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, (n,))))
    got = prng.rademacher(tk, (n,))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.rademacher(jk, (n,), jnp.float32)))


@pytest.mark.parametrize("lo,hi", [(0, 2048), (0, 256), (0, 7), (-5, 9),
                                   (-2**31, 2**31 - 1), (3, 4)])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_bit_exact(seed, lo, hi):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    got = prng.randint(tk, (5001,), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.randint(jk, (5001,), lo, hi,
                                                   dtype=jnp.int32)))


def test_randint_batched_keys_and_2d_shape():
    jk = jax.random.split(jax.random.PRNGKey(2), 3)
    got = prng.randint(prng.split(prng.PRNGKey(2), 3), (4, 9), 0, 100).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(jax.random.randint(jk[i], (4, 9), 0, 100)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_three_ulp(seed):
    """f32 normal draws: XLA's erf_inv polynomial and fused multiply-adds
    reproduced, its log1p not; that costs at most 3 ulp on < 2% of draws."""
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    n = 200000
    got = prng.normal(tk, (n,)).numpy()
    want = np.asarray(jax.random.normal(jk, (n,)))
    assert got.dtype == np.float32 and got.shape == (n,)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 3
    assert np.mean(ulps > 0) < 0.02


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999940395355])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    got = prng.erf_inv(x).numpy()
    np.testing.assert_array_equal(got[:3], want[:3])
    np.testing.assert_allclose(got[3:], want[3:], rtol=4e-7)


def test_noise_key_chain_of_the_dp_aggregator():
    """The dp noise of a round: normal(fold_in(fold_in_name(PRNGKey(seed),
    'aggregator_noise'), round)), as the reference draws it."""
    for r in (0, 5):
        jk = jax.random.fold_in(
            jax_fold_in_name(jax.random.PRNGKey(3), "aggregator_noise"), r)
        tk = prng.fold_in(fold_in_name(prng.PRNGKey(3), "aggregator_noise"), r)
        np.testing.assert_array_equal(tk.numpy(), _jkey(jk))
        a = prng.normal(tk, (4096,)).numpy()
        b = np.asarray(jax.random.normal(jk, (4096,)))
        assert np.max(np.abs(a - b)) <= 3 * np.spacing(np.abs(b)).max()
