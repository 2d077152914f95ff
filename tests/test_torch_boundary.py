"""The port's boundary: it imports neither JAX nor the JAX package, its
config mirrors the reference's field for field, its entry points refuse to
fall back to the CPU when asked for the card, and every knob outside the
ported slice raises NotImplementedError instead of running something else."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro_torch.configs.base import FedConfig, validate_config  # noqa: E402
from repro_torch.core import aggregation  # noqa: E402
from repro_torch.data.synth import make_synth_federation  # noqa: E402
from repro_torch.fl import engine  # noqa: E402
from repro_torch.fl.simulator import run_federation  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.small import SMALL_MODELS, make_loss_fn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_no_jax_and_no_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_fedconfig_mirrors_reference_fields_and_defaults():
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxFedConfig)]
    port = [(f.name, f.default) for f in dataclasses.fields(FedConfig)]
    assert port == ref


def _tiny():
    fedn = make_synth_federation(seed=0, n_priority=2, n_nonpriority=2,
                                 samples_per_client=16, test_samples=20)
    init_fn, apply_fn = SMALL_MODELS["synth_logreg"]
    return fedn, init_fn, make_loss_fn(apply_fn)


def test_default_device_entry_points_refuse_to_run_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    fedn, init_fn, loss_fn = _tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_fn(0)
    from repro_torch.convert import params_from_jax
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": np.zeros(2, np.float32)})
    params = init_fn(0, "cpu")
    fed = FedConfig(num_clients=4, num_priority=2, rounds=1, local_epochs=1,
                    batch_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_federation(loss_fn, params, fed, fedn)


OUT_OF_SLICE = [
    ("selection", "topk_align"), ("selection", "grad_sim"),
    ("selection", "welfare"), ("backend", "scan_async"),
    ("async_depth", 2), ("participation", 0.5), ("max_cohort", 2),
    ("candidate_pool", 3), ("aggregator", "trimmed_mean"),
    ("aggregator", "median"), ("aggregator", "dp"),
    ("aggregator", "cosine_filter"), ("wire_codec", "int8"),
    ("wire_codec", "topk"), ("wire_codec", "sketch"),
    ("server_opt", "momentum"), ("server_opt", "adam"),
    ("server_opt", "yogi"), ("failure_model", "crash"),
    ("failure_model", "chaos"), ("latency_mode", "lognormal"),
    ("round_deadline", 2.0), ("divergence_guard", True),
    ("agg_dtype", "float16"),
]


@pytest.mark.parametrize("knob,value", OUT_OF_SLICE,
                         ids=[f"{k}={v}" for k, v in OUT_OF_SLICE])
def test_out_of_slice_knob_raises(knob, value):
    fed = FedConfig(num_clients=4, num_priority=2, rounds=1, local_epochs=1,
                    batch_size=8).replace(**{knob: value})
    _, _, loss_fn = _tiny()
    with pytest.raises(NotImplementedError, match=knob if knob not in (
            "aggregator", "wire_codec", "server_opt") else "not ported"):
        validate_config(fed)
    with pytest.raises(NotImplementedError):
        engine.make_round_fn(loss_fn, fed)


@pytest.mark.parametrize("kw", [dict(checkpoint_path="ckpt"),
                                dict(drain_inflight=True)],
                         ids=["checkpoint_path", "drain_inflight"])
def test_out_of_slice_driver_options_raise(kw):
    fedn, init_fn, loss_fn = _tiny()
    fed = FedConfig(num_clients=4, num_priority=2, rounds=1, local_epochs=1,
                    batch_size=8)
    with pytest.raises(NotImplementedError):
        run_federation(loss_fn, init_fn(0, "cpu"), fed, fedn, device="cpu",
                       **kw)


@pytest.mark.parametrize("aggregator,codec", [("median", "identity"),
                                              ("mean", "int8")])
def test_out_of_slice_kernel_variants_raise(aggregator, codec):
    u = torch.zeros(2, 4)
    w = g = torch.ones(2)
    with pytest.raises(NotImplementedError):
        ops.fedagg(u, w, g, aggregator=aggregator, codec=codec)


@pytest.mark.parametrize("knob,value", [("selection", "no_such_rule"),
                                        ("aggregator", "no_such_agg"),
                                        ("server_opt", "no_such_opt"),
                                        ("latency_mode", "no_such_clock")])
def test_unknown_names_raise_value_error(knob, value):
    fed = FedConfig().replace(**{knob: value})
    with pytest.raises(ValueError, match="unknown"):
        validate_config(fed)


def test_ported_registries_hold_only_the_slice():
    assert engine.STRATEGIES.names() == ["all", "fedalign", "priority_only"]
    assert aggregation.AGGREGATORS.names() == ["mean"]
    assert aggregation.SERVER_OPTIMIZERS.names() == ["sgd"]
    assert aggregation.resolve_server_opt("none") == "sgd"
