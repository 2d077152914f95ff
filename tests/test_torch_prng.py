"""repro_torch.prng against live jax.random: every integer output bitwise
equal (threefry2x32, partitionable streams), for several keys and sizes."""
import jax
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
