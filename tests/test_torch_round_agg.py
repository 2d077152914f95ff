"""The FedALIGN round under every aggregator and wire codec the port runs:
run_federation against the JAX package on the shortened quickstart config
of tests/test_torch_round.py cut to 4 rounds (C=8, 4 priority, E=2), both
backends, at that file's tolerances (gates and included counts exact), plus
the dp run's (epsilon, delta) report. Kept apart from that file so each
stays well under a minute on one worker. Both packages' SYNTH federations
are built once for the module (``feds``): the runs only read them, and the
reference's generator alone takes ~1.2 s a build."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_round import (BASE, FED_KW, _assert_history_parity,  # noqa: E402
                              _runs, jax_synth, make_synth_federation,
                              one_blas_thread)

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These rounds work on tensors of a few hundred elements, where torch's
    intra-op thread pool costs more than it saves (4-5x here, more with
    several test workers on the host's cores): one thread for the module,
    the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with one_blas_thread():
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def feds():
    """(the reference's federation, the port's), built once."""
    return jax_synth(**FED_KW), make_synth_federation(**FED_KW)


# the robust, private and compressed aggregation of the same parity config:
# every aggregator and codec the port runs, on both backends
AGG_VARIANTS = {
    "median": dict(aggregator="median"),
    "trimmed_mean": dict(aggregator="trimmed_mean", trim_frac=0.2),
    "dp": dict(aggregator="dp", dp_clip=0.5, dp_noise=0.3),
    "cosine_filter": dict(aggregator="cosine_filter", outlier_cos=0.2,
                          sketch_dim=64),
    "int8_ef": dict(wire_codec="int8"),
    "topk_ef": dict(wire_codec="topk", codec_topk_frac=0.2),
    "sketch": dict(wire_codec="sketch", codec_sketch_dim=256,
                   error_feedback=False),
}


@pytest.mark.parametrize("backend", ["vmap_spatial", "scan_temporal"])
@pytest.mark.parametrize("variant", sorted(AGG_VARIANTS))
def test_run_federation_aggregators_and_codecs_match_reference(
        variant, backend, monkeypatch, feds):
    """Gates, included counts, losses and accuracy at the tolerances above.
    Params too, but int8 rounds x / scale to an integer: a last-bit
    difference of x (the local-training sums run in another order) can
    cross a rounding boundary and move one transmitted coordinate by one
    quantum, scale = max|x_row| / 127. Error feedback carries the
    difference into the next round's residual, so it does not accumulate:
    there the params may differ by up to one quantum of the run's largest
    row scale, recorded from the port's encode."""
    from repro_torch.core import aggregation as tagg
    scales = []
    encode = tagg._Int8Codec.encode

    def recording_encode(fed, buf):
        q, kw = encode(fed, buf)
        scales.append(float(kw["dequant_scale"].max()))
        return q, kw

    monkeypatch.setattr(tagg._Int8Codec, "encode",
                        staticmethod(recording_encode))
    cfg = dict(BASE, rounds=4, backend=backend, **AGG_VARIANTS[variant])
    hj, ht = _runs("synth_logreg", cfg, *feds, eval_every=2)
    _assert_history_parity(hj, ht, FED_KW["test_samples"],
                           params_extra_atol=max(scales, default=0.0))
    assert (ht.dp_epsilon, ht.dp_delta) == (hj.dp_epsilon, hj.dp_delta)
