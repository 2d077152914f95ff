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
from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import ARCH_IDS, PORTED, get_config, get_smoke  # noqa: E402
from repro_torch.configs.base import FedConfig, ModelConfig, validate_config  # noqa: E402
from repro_torch.core import aggregation  # noqa: E402
from repro_torch.data.synth import make_synth_federation  # noqa: E402
from repro_torch.fl import engine  # noqa: E402
from repro_torch.fl.simulator import run_federation  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import encdec, transformer  # noqa: E402
from repro_torch.models.small import SMALL_MODELS, make_loss_fn  # noqa: E402
from repro_torch.serving import BatchScheduler  # noqa: E402
from repro_torch.utils import tree_leaves as _leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors, where torch's intra-op thread pool costs more
    than it saves, badly so with several test workers on the host's cores:
    one thread for the module, the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# (knob, value, outcome): the knobs once outside the slice. The still
# refused ones raise NotImplementedError naming the knob; the knobs the
# port has since reached ("runs") validate, build a round and run it on
# the CPU; set alone, async_depth (without the scan_async backend) and
# round_deadline (without the event clock) raise the reference's
# ValueError
OUT_OF_SLICE = [
    ("selection", "topk_align", "runs"), ("selection", "grad_sim", "runs"),
    ("selection", "welfare", "runs"), ("backend", "scan_async", "runs"),
    ("async_depth", 2, ValueError), ("participation", 0.5, "runs"),
    ("max_cohort", 2, "runs"), ("candidate_pool", 3, "runs"),
    ("server_opt", "momentum", "runs"), ("server_opt", "adam", "runs"),
    ("server_opt", "yogi", "runs"), ("failure_model", "crash", "runs"),
    ("failure_model", "chaos", "runs"), ("latency_mode", "lognormal", "runs"),
    ("round_deadline", 2.0, ValueError), ("divergence_guard", True, "runs"),
    ("agg_dtype", "float16", NotImplementedError),
]


@pytest.mark.parametrize("knob,value,outcome", OUT_OF_SLICE,
                         ids=[f"{k}={v}" for k, v, _ in OUT_OF_SLICE])
def test_out_of_slice_knob_raises(knob, value, outcome):
    fed = FedConfig(num_clients=4, num_priority=2, rounds=1, local_epochs=1,
                    batch_size=8).replace(**{knob: value})
    fedn, init_fn, loss_fn = _tiny()
    if outcome == "runs":
        assert validate_config(fed) is fed
        hist = run_federation(loss_fn, init_fn(0, "cpu"), fed, fedn,
                              device="cpu")
        assert len(hist.gates) == 1 and np.isfinite(hist.global_loss[0])
        assert np.isfinite(hist.params["w"].numpy()).all()
        return
    if outcome is ValueError:
        with pytest.raises(ValueError, match=knob):
            engine.make_round_fn(loss_fn, fed)
        return
    with pytest.raises(NotImplementedError, match=knob if knob not in (
            "aggregator", "wire_codec", "server_opt") else "not ported"):
        validate_config(fed)
    with pytest.raises(NotImplementedError):
        engine.make_round_fn(loss_fn, fed)


# the driver options once outside the slice: both run, and change nothing
# of the run (drain_inflight is a no-op on a synchronous run); the
# checkpoint they write loads back to the run's final state and key
@pytest.mark.parametrize("kw", [dict(checkpoint_path="ckpt.msgpack"),
                                dict(drain_inflight=True)],
                         ids=["checkpoint_path", "drain_inflight"])
def test_out_of_slice_driver_options_raise(kw, tmp_path):
    from repro_torch.fl.simulator import load_federation_state
    fedn, init_fn, loss_fn = _tiny()
    fed = FedConfig(num_clients=4, num_priority=2, rounds=1, local_epochs=1,
                    batch_size=8)
    if "checkpoint_path" in kw:
        kw = dict(checkpoint_path=str(tmp_path / kw["checkpoint_path"]))
    plain = run_federation(loss_fn, init_fn(0, "cpu"), fed, fedn,
                           device="cpu")
    hist = run_federation(loss_fn, init_fn(0, "cpu"), fed, fedn,
                          device="cpu", **kw)
    assert all(torch.equal(hist.params[k], plain.params[k])
               for k in plain.params)
    if "checkpoint_path" in kw:
        state, rng, step = load_federation_state(
            kw["checkpoint_path"], engine.init_state(init_fn(0, "cpu"), fed, 4),
            fed=fed, device="cpu")
        assert step == 1 and torch.equal(rng, hist.rng)
        assert all(torch.equal(state.params[k], hist.params[k])
                   for k in plain.params)


PORTED_KNOBS = [("aggregator", "trimmed_mean"), ("aggregator", "median"),
                ("aggregator", "dp"), ("aggregator", "cosine_filter"),
                ("wire_codec", "int8"), ("wire_codec", "topk"),
                ("wire_codec", "sketch")]


@pytest.mark.parametrize("knob,value", PORTED_KNOBS,
                         ids=[f"{k}={v}" for k, v in PORTED_KNOBS])
def test_ported_knob_validates_and_builds_a_round(knob, value):
    fed = FedConfig(num_clients=4, num_priority=2, rounds=1, local_epochs=1,
                    batch_size=8).replace(**{knob: value})
    _, _, loss_fn = _tiny()
    assert validate_config(fed) is fed
    assert callable(engine.make_round_fn(loss_fn, fed))


@pytest.mark.parametrize("aggregator,codec", [("no_such_agg", "identity"),
                                              ("mean", "no_such_codec"),
                                              ("cosine_filter", "identity")])
def test_unknown_kernel_variants_raise(aggregator, codec):
    """The kernel knows the four in-kernel reducers and four decoders;
    cosine_filter is a gate rewrite upstream, never a kernel variant."""
    u = torch.zeros(2, 4)
    w = g = torch.ones(2)
    with pytest.raises(ValueError, match="unknown"):
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
    assert engine.STRATEGIES.names() == [
        "all", "fedalign", "grad_sim", "priority_only", "topk_align",
        "welfare"]
    assert aggregation.AGGREGATORS.names() == [
        "cosine_filter", "dp", "mean", "median", "trimmed_mean"]
    assert aggregation.WIRE_CODECS.names() == [
        "identity", "int8", "sketch", "topk"]
    assert aggregation.SERVER_OPTIMIZERS.names() == [
        "adam", "momentum", "sgd", "yogi"]
    assert aggregation.resolve_server_opt("none") == "sgd"


# ------------------------------------------------------------ the LM slice
def test_import_walk_covers_the_lm_modules():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in _port_files() if "repro_torch" in p.parts}
    assert {"configs/qwen1_5_0_5b.py", "configs/qwen2_5_3b.py",
            "configs/phi3_mini_3_8b.py", "kernels/flash_attention.py",
            "kernels/decode_attention.py", "kernels/rmsnorm.py",
            "models/layers.py", "models/attention.py", "models/transformer.py",
            "models/registry.py", "launch/serve.py",
            "serving/scheduler.py"} <= names


def test_model_config_mirrors_reference_fields_and_defaults():
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxModelConfig)]
    port = [(f.name, f.default) for f in dataclasses.fields(ModelConfig)]
    assert port == ref


def test_lm_entry_points_refuse_to_run_on_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = get_smoke("qwen1.5-0.5b")
    model = get_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(prng.PRNGKey(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.make_cache(1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--batch", "1", "--prompt-len", "4", "--gen", "2"])
    params = {"embed": torch.zeros(cfg.vocab_size, cfg.d_model)}   # on the CPU
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.generate(model, params, torch.zeros(1, 4, dtype=torch.int32), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchScheduler(model, params, batch_slots=1, max_len=8)


def test_serve_main_runs_on_the_cpu_when_asked(capsys):
    toks = serve.main(["--batch", "2", "--prompt-len", "5", "--gen", "3",
                       "--device", "cpu"])
    assert toks.shape == (2, 8)
    assert "generated 2x3 tokens" in capsys.readouterr().out


# seq_shard_attn (ported with the model axis, ROADMAP A17b), on each model
# family's entry points (the decoder-only, the hybrid and the enc-dec)
OUT_OF_SLICE_LM = [("qwen1.5-0.5b", "seq_shard_attn", True),
                   ("jamba-1.5-large-398b", "seq_shard_attn", True),
                   ("whisper-medium", "seq_shard_attn", True)]


@pytest.mark.parametrize("arch,knob,value", OUT_OF_SLICE_LM,
                         ids=[f"{a}-{k}={v}" for a, k, v in OUT_OF_SLICE_LM])
def test_out_of_slice_lm_knob_raises(arch, knob, value):
    """The knob no longer raises: on one rank it is the identity (the
    reference's sharding constraint without a mesh), so every entry point
    builds the same trees as without it; only the pod round's model axis
    reads it."""
    cfg = get_smoke(arch).replace(**{knob: value})
    base = get_smoke(arch)
    mod = encdec if cfg.encdec else transformer
    assert get_model(cfg).cfg is cfg
    shapes = lambda c: [tuple(t.shape) for t in _leaves(  # noqa: E731
        mod.init(prng.PRNGKey(0, device="meta"), c, device="meta"))]
    assert shapes(cfg) == shapes(base)
    cache = lambda c: [tuple(getattr(t, "shape", ())) for t in _leaves(  # noqa: E731
        mod.make_cache(c, 1, 8, device="meta"))]
    assert cache(cfg) == cache(base)


def test_train_run_refuses_encdec_with_the_reference_assertion():
    """whisper has no federated round: the reference's ``launch/train.run``
    asserts ``not cfg.encdec`` (repro/launch/train.py:61), and so does the
    port's, with the same message, before it builds anything."""
    for smoke in (True, False):
        with pytest.raises(AssertionError, match="enc-dec training"):
            train.run(arch="whisper-medium", smoke=smoke, rounds=1, clients=2,
                      n_priority=1, device="cpu", verbose=False)


# ------------------------------------------------------- the training slice
def test_train_entry_points_refuse_to_run_on_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.fl import sharded
    from repro_torch.launch import train
    model = get_model(get_smoke("qwen1.5-0.5b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run(rounds=1, clients=2, n_priority=1, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--rounds", "1", "--clients", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded.make_round_step(model, FedConfig(num_clients=2), 2, fsdp=False)


def test_import_walk_covers_the_training_modules():
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in _port_files() if "repro_torch" in p.parts}
    assert {"data/tokens.py", "configs/cli.py", "fl/sharded.py",
            "launch/train.py", "launch/train_profile.py",
            "kernels/flash_attention.py", "kernels/rmsnorm.py",
            "models/layers.py", "models/transformer.py"} <= names


# ---------------------------------------------------------- the jamba slice
def test_import_walk_covers_the_jamba_modules():
    """The jamba serving path's modules are among the files the import
    check above walks (so none imports jax or the reference)."""
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in _port_files() if "repro_torch" in p.parts}
    assert {"configs/jamba_1_5_large_398b.py", "kernels/ssm_scan.py",
            "models/ssm.py", "models/moe.py", "models/transformer.py",
            "launch/serve.py", "launch/serve_profile.py",
            "serving/scheduler.py"} <= names
    assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "ssm_scan.cu").exists()


# ------------------------------------------------- the llava and xlstm slice
def test_import_walk_covers_the_vlm_and_xlstm_modules():
    """llava's and xlstm's configs and the xLSTM blocks are among the files
    the import check above walks (so none imports jax or the reference)."""
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in _port_files() if "repro_torch" in p.parts}
    assert {"configs/llava_next_34b.py", "configs/xlstm_125m.py",
            "models/xlstm.py", "models/transformer.py"} <= names


@pytest.mark.parametrize("arch", ["llava-next-34b", "xlstm-125m"])
def test_vlm_and_xlstm_archs_are_ported(arch):
    for cfg in (get_config(arch), get_smoke(arch)):
        assert get_model(cfg).cfg is cfg


@pytest.mark.parametrize("arch,knob,value", OUT_OF_SLICE_LM,
                         ids=[f"{a}-{k}={v}" for a, k, v in OUT_OF_SLICE_LM])
def test_out_of_slice_refusals_name_a17b(arch, knob, value):
    """Nothing of the model layer is refused any more; what the model axis
    has not reached (every arch outside the dense GQA family, serving on
    local heads) raises naming ROADMAP A17b."""
    from repro_torch.sharding import model_axis
    cfg = get_smoke(arch).replace(**{knob: value})
    assert transformer._UNPORTED == ()
    if arch == "qwen1.5-0.5b":
        model_axis.check_model(cfg, 2)
        from repro_torch.models.attention import gqa_attention_block
        with pytest.raises(NotImplementedError, match="A17b"):
            gqa_attention_block({}, torch.zeros(1, 4, cfg.d_model), cfg,
                                positions=torch.arange(4), mode="decode",
                                tp=object())
    else:
        with pytest.raises(NotImplementedError, match="A17b"):
            model_axis.check_model(cfg, 2)


# ------------------------------------------------- the encoder-decoder slice
def test_import_walk_covers_the_encdec_modules():
    """whisper's config and the encoder-decoder are among the files the
    import check above walks (so neither imports jax or the reference)."""
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in _port_files() if "repro_torch" in p.parts}
    assert {"configs/whisper_medium.py", "models/encdec.py",
            "models/attention.py", "models/layers.py"} <= names


def test_every_arch_is_ported():
    """``get_config`` / ``get_smoke`` / ``get_model`` take all ten archs;
    whisper's model is the encoder-decoder's."""
    assert set(PORTED) == set(ARCH_IDS) and len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        for cfg in (get_config(arch), get_smoke(arch)):
            assert get_model(cfg).cfg is cfg
    caches = get_model(get_smoke("whisper-medium")).make_cache(1, 4, device="meta")
    assert set(caches) == {"dec", "enc_out"}


@pytest.mark.parametrize("knob,value", [("attn_bf16", True),
                                        ("remat_policy", "save_mixer")])
def test_single_card_knobs_are_ported(knob, value):
    """The two single-card knobs once refused (A16b ``attn_bf16``, A16d
    ``save_mixer``) build a model and take a gradient on the CPU."""
    cfg = get_smoke("qwen1.5-0.5b").replace(**{knob: value})
    model = get_model(cfg)
    params = model.init(prng.PRNGKey(0), device="cpu")
    leaves = [t.requires_grad_(True) for t in _leaves(params)]
    toks = torch.zeros(1, 8, dtype=torch.int64)
    loss, _ = model.loss_fn(params, {"tokens": toks, "labels": toks,
                                     "mask": torch.ones(1, 8)})
    assert all(g is not None for g in torch.autograd.grad(loss, leaves))


# ------------------------------------------------------ the paper layer slice
def test_import_walk_covers_the_paper_layer():
    """The paper's configs, the Theorem 1 testbed, the batch loader and the
    simulator with the local-only baseline are among the files the import
    check above walks (so none imports jax or the reference)."""
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in _port_files() if "repro_torch" in p.parts}
    assert {"configs/paper.py", "core/theory.py", "data/loader.py",
            "fl/simulator.py"} <= names


def test_paper_layer_entry_points_refuse_to_run_on_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.core import theory
    from repro_torch.fl.simulator import run_local_baseline
    fedn, init_fn, loss_fn = _tiny()
    fed = FedConfig(num_clients=4, num_priority=2, rounds=1, local_epochs=1,
                    batch_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_local_baseline(loss_fn, init_fn, fed, fedn, client_ids=[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        theory.make_quadratic_pfl(seed=0)
    q = theory.make_quadratic_pfl(seed=0, device="cpu")
    assert q.A.device.type == "cpu" and q.A.dtype == torch.float64


# ------------------------------------------------- the pod layer's data axes
def test_import_walk_covers_the_pod_layer():
    """The specs, the meshes, the dry-run and the pod round are among the
    files the import check above walks (so none imports jax or the
    reference)."""
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in _port_files() if "repro_torch" in p.parts}
    assert {"sharding/specs.py", "launch/mesh.py", "launch/dryrun.py",
            "fl/sharded.py", "models/registry.py"} <= names


def test_pod_layer_entry_points_refuse_to_run_on_cpu_by_default():
    """make_pod_round defaults to the card and raises where there is none,
    before it touches a process group; make_host_mesh needs one; importing
    the mesh module touches none."""
    import torch.distributed as dist
    from repro_torch.fl import sharded
    from repro_torch.launch import mesh
    assert not dist.is_initialized()
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    model = get_model(get_smoke("qwen1_5_0_5b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded.make_pod_round(model, FedConfig(num_clients=8), 8,
                               mesh.mesh_shape(data=2, model=1))
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_host_mesh(1)
    assert not dist.is_initialized()
