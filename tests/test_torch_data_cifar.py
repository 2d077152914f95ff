"""The port's CIFAR stand-in (config (b)'s federation: 60 clients x 1000
images of 32x32x3) is byte-identical to ``repro.data``'s for 3 seeds. Kept
apart from test_torch_data.py: each generation takes seconds and GBs."""
import pytest

pytest.importorskip("torch")

from repro.data.shards import make_benchmark_federation as jax_benchmark  # noqa: E402
from repro_torch.data.shards import make_benchmark_federation  # noqa: E402
from test_torch_data import federation_digest  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_cifar_federation_byte_identical(seed):
    want = federation_digest(jax_benchmark("cifar", seed=seed, n_priority=2))
    got = federation_digest(make_benchmark_federation("cifar", seed=seed,
                                                      n_priority=2))
    assert got == want
