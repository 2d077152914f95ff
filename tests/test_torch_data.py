"""The port's own copies of the numpy federations give byte-identical data
to ``repro.data`` for the same seed: SYNTH and the FMNIST stand-in here, the
CIFAR stand-in (the largest) in test_torch_data_cifar.py."""
import hashlib

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data.shards import make_benchmark_federation as jax_benchmark  # noqa: E402
from repro.data.synth import make_synth_federation as jax_synth  # noqa: E402
from repro_torch.data.shards import make_benchmark_federation  # noqa: E402
from repro_torch.data.synth import make_synth_federation  # noqa: E402
from test_torch_round import one_blas_thread  # noqa: E402

FIELDS = ("x", "y", "priority_mask", "weights", "test_x", "test_y",
          "client_test_x", "client_test_y")


@pytest.fixture(autouse=True, scope="module")
def blas_one_thread():
    """numpy's BLAS at one thread for the module: the generators' small
    SVDs and products crawl at a thread a core beside other test workers
    (``test_torch_round.one_blas_thread``); the bytes are the same."""
    with one_blas_thread():
        yield


def federation_digest(fedn) -> dict:
    """Per-field dtype, shape and sha256 of the raw bytes (a field that is
    None stays None), so two large federations compare without both being
    held in memory."""
    out = {}
    for name in FIELDS:
        a = getattr(fedn, name)
        out[name] = None if a is None else (
            str(a.dtype), a.shape,
            hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest())
    return out


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kw", [
    dict(n_priority=10, n_nonpriority=10, samples_per_client=200),
    dict(n_priority=4, n_nonpriority=4, samples_per_client=40,
         label_noise_skew=5.0, random_data_skew=0.5, test_samples=200),
], ids=["quickstart", "small_high_skew"])
def test_synth_federation_byte_identical(seed, kw):
    assert (federation_digest(make_synth_federation(seed=seed, **kw))
            == federation_digest(jax_synth(seed=seed, **kw)))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fmnist_federation_byte_identical(seed):
    assert (federation_digest(make_benchmark_federation("fmnist", seed=seed,
                                                        n_priority=2))
            == federation_digest(jax_benchmark("fmnist", seed=seed,
                                               n_priority=2)))


def test_benchmark_federation_options_byte_identical():
    kw = dict(seed=3, n_priority=3, clients=10, samples_per_client=50,
              test_samples=300)
    assert (federation_digest(make_benchmark_federation("fmnist", **kw))
            == federation_digest(jax_benchmark("fmnist", **kw)))
