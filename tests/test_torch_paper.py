"""The paper layer's data: the port's configs/paper.py and data/loader.py
against the JAX package's, exactly.

Every FIG entry equals the reference's field for field under the same
keys; the batch loader's batches equal the reference's byte for byte over
several seeds, batch sizes and leaf dtypes, across reshuffle boundaries;
``pack_token_documents`` equals the reference's, the empty list and a
short padded document included."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import paper as ref_paper  # noqa: E402
from repro.data import loader as ref_loader  # noqa: E402
from repro_torch.configs import paper  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.data import loader  # noqa: E402


def _same_entry(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "fed":
            assert isinstance(got[k], FedConfig)
            assert dataclasses.asdict(got[k]) == dataclasses.asdict(v)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("name", ["FIG1", "FIG2"])
def test_figure_dicts_equal_the_reference(name):
    got, want = getattr(paper, name), getattr(ref_paper, name)
    assert list(got) == list(want)
    for key in want:
        _same_entry(got[key], want[key])


@pytest.mark.parametrize("name", ["FIG4", "FIG5"])
def test_figure_entries_equal_the_reference(name):
    _same_entry(getattr(paper, name), getattr(ref_paper, name))


def test_fig6_sweep_equals_the_reference():
    assert paper.FIG6 == ref_paper.FIG6


def test_fig6_points_apply_to_fig1_fmnist():
    """A FIG6 point over FIG1's fmnist config, as the sweep applies it."""
    for pt in paper.FIG6:
        fed = paper.FIG1["fmnist"]["fed"].replace(
            num_priority=pt["n_priority"], local_epochs=pt["E"])
        want = dataclasses.replace(ref_paper.FIG1["fmnist"]["fed"],
                                   num_priority=pt["n_priority"],
                                   local_epochs=pt["E"])
        assert dataclasses.asdict(fed) == dataclasses.asdict(want)


def _data(C, n, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(C, n, 3, 2)).astype(np.float32),
            "y": rng.integers(0, 10, (C, n)).astype(np.int32),
            "t": rng.integers(0, 50_000, (C, n, 5)).astype(np.int64)}


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("batch_size", [1, 4, 7, 13])
def test_federated_batches_equal_the_reference(seed, batch_size):
    data = _data(3, 13, seed + 100)
    got = loader.FederatedBatches(data, batch_size, seed=seed)
    want = ref_loader.FederatedBatches(data, batch_size, seed=seed)
    assert (got.C, got.n) == (want.C, want.n) == (3, 13)
    reshuffles = 0
    for _, a, b in zip(range(40), got, want):
        reshuffles += got._cursor == batch_size
        assert list(a) == list(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k
    assert reshuffles >= 2             # crossed at least one epoch boundary


def test_federated_batches_next_batch_matches_iteration():
    data = _data(2, 9, 5)
    a = loader.FederatedBatches(data, 4, seed=3)
    b = ref_loader.FederatedBatches(data, 4, seed=3)
    for _ in range(5):
        x, y = a.next_batch(), b.next_batch()
        assert all(x[k].tobytes() == y[k].tobytes() for k in y)


DOCS = {
    "empty": [],
    "short_padded": [np.array([5, 6, 7], np.int32)],
    "exact_row": [np.arange(9, dtype=np.int32)],
    "several": [np.arange(1, 12, dtype=np.int32), np.array([40, 41], np.int32),
                np.arange(100, 123, dtype=np.int32)],
    "int64_docs": [np.arange(30, dtype=np.int64), np.arange(7, dtype=np.int64)],
}


@pytest.mark.parametrize("name", list(DOCS))
@pytest.mark.parametrize("seq_len,pad_id", [(8, 0), (4, -1), (31, 3)])
def test_pack_token_documents_equals_the_reference(name, seq_len, pad_id):
    got = loader.pack_token_documents(DOCS[name], seq_len, pad_id)
    want = ref_loader.pack_token_documents(DOCS[name], seq_len, pad_id)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
