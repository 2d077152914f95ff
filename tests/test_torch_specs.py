"""The port's partition specs (``repro_torch.sharding.specs``) and
allocation-free shapes (``models/registry.py: param_shapes``,
``cache_shapes``, ``prefill_cache_shapes``) against the reference's
``repro.sharding.specs`` and ``jax.eval_shape``, leaf for leaf.

The reference's spec functions read only ``mesh.shape`` and
``mesh.axis_names`` (``src/repro/sharding/specs.py:37-107``), so they run
on a ``jax.sharding.AbstractMesh`` of the production axes; the port's on
``launch/mesh.py: production_mesh_shape``. Every param leaf of the ten
archs' full configs, on both meshes, with ``fsdp`` by ``needs_fsdp`` and
forced on, ``expert_parallel`` on and off; the token batches of every
input shape; the decode caches at decode_32k, long_500k and batch 1 in
both ``model_dim_order``s; the federation state of every server
optimizer and every buffer / clock / guard / codec layout. A spec is
compared entry for entry (None, an axis name or a tuple of names)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh, PartitionSpec

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.fl import sharded as jax_sharded  # noqa: E402
from repro.launch.dryrun import _token_batch_shapes as jax_batch  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.fl import engine, sharded  # noqa: E402
from repro_torch.launch.dryrun import _token_batch_shapes  # noqa: E402
from repro_torch.launch.mesh import mesh_shape, production_mesh_shape  # noqa: E402
from repro_torch.models.registry import (cache_shapes, param_shapes,  # noqa: E402
                                         prefill_cache_shapes)
from repro_torch.sharding import specs  # noqa: E402

JAX_MESHES = {"single": AbstractMesh((16, 16), ("data", "model")),
              "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
MESHES = {"single": production_mesh_shape(multi_pod=False),
          "multi": production_mesh_shape(multi_pod=True)}


def _key(path):
    return tuple(getattr(k, "key", getattr(k, "idx", getattr(k, "name", None)))
                 for k in path)


def _jax_flat(tree, is_leaf=None):
    """{path: leaf} of a JAX tree (dict keys, sequence indices)."""
    return {_key(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _flat(tree, pre=()):
    """{path: leaf} of a port tree: dicts, lists and tuples (a spec, a
    tensor or an int is a leaf)."""
    if isinstance(tree, specs.PartitionSpec) or not isinstance(
            tree, (dict, list, tuple)):
        return {pre: tree}
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        out.update(_flat(v, pre + (k,)))
    return out


def _jax_specs(tree):
    return {k: tuple(v) for k, v in
            _jax_flat(tree, lambda x: isinstance(x, PartitionSpec)).items()}


def _port_specs(tree):
    return {k: tuple(v) for k, v in _flat(tree).items()}


def _shape_dtype(leaf):
    return tuple(leaf.shape), str(jnp.dtype(leaf.dtype))


def _port_shape_dtype(leaf):
    return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.eval_shape(jax_get_model(jax_get_config(arch)).init,
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return param_shapes(get_config(arch))


def test_input_shapes_mirror_reference():
    assert list(INPUT_SHAPES) == list(JAX_INPUT_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == \
            dataclasses.asdict(JAX_INPUT_SHAPES[name])


def test_production_meshes_mirror_reference():
    for name, mesh in MESHES.items():
        assert mesh.shape == dict(JAX_MESHES[name].shape)
        assert mesh.axis_names == JAX_MESHES[name].axis_names
        assert specs.dp_axes(mesh) == jspecs.dp_axes(JAX_MESHES[name])


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_shapes_match_eval_shape(arch):
    """param_shapes against eval_shape(model.init); cache_shapes against
    eval_shape(make_cache) at decode_32k; prefill_cache_shapes against the
    caches eval_shape(make_prefill_step) returns (whisper's cross caches,
    MLA's latent cache, llava's image rows included)."""
    want = {k: _shape_dtype(v) for k, v in _jax_flat(_jax_params(arch)).items()}
    got = {k: _port_shape_dtype(v) for k, v in _flat(_port_params(arch)).items()}
    assert got == want
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model = jax_get_model(jcfg)
    B, S = INPUT_SHAPES["decode_32k"].global_batch, INPUT_SHAPES["decode_32k"].seq_len
    want = jax.eval_shape(lambda: model.make_cache(B, S))
    got = cache_shapes(cfg, B, S)
    assert {k: _port_shape_dtype(v) for k, v in _flat(got).items()} == \
        {k: _shape_dtype(v) for k, v in _jax_flat(want).items()}
    B, S = 2, 64
    n_img = cfg.num_image_tokens if cfg.vlm else 0
    batch = jax_batch(jcfg, None, B, S + n_img, stacked=False)
    out = jax.eval_shape(jax_sharded.make_prefill_step(model),
                         _jax_params(arch), batch)
    got = prefill_cache_shapes(cfg, B, S)
    assert {k: _port_shape_dtype(v) for k, v in _flat(got).items()} == \
        {k: _shape_dtype(v) for k, v in _jax_flat(out[0]).items()}
    assert all(t.device.type == "meta" for t in _flat(got).values())


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_param_specs_match_reference(arch, mesh):
    needs = sharded.needs_fsdp(get_config(arch))
    assert needs == jax_sharded.needs_fsdp(jax_get_config(arch))
    for fsdp in sorted({needs, True}):
        for ep in (False, True):
            want = jspecs.auto_param_specs(_jax_params(arch), JAX_MESHES[mesh],
                                           fsdp=fsdp, expert_parallel=ep)
            got = specs.auto_param_specs(_port_params(arch), MESHES[mesh],
                                         fsdp=fsdp, expert_parallel=ep)
            assert _port_specs(got) == _jax_specs(want), (fsdp, ep)


def test_expert_parallel_moves_experts_onto_the_model_axis():
    """jamba's 16 experts equal the model axis: the expert dim (after the
    period stack) carries it only with expert_parallel."""
    shapes = _port_params("jamba_1_5_large_398b")
    on = specs.auto_param_specs(shapes, MESHES["single"], expert_parallel=True)
    off = specs.auto_param_specs(shapes, MESHES["single"])
    assert on["periods"]["l1"]["moe"]["w_gate"][1] == "model"
    assert off["periods"]["l1"]["moe"]["w_gate"][1] is None


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_batch_specs_match_reference(mesh):
    for arch in JAX_ARCH_IDS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for shape in INPUT_SHAPES.values():
            B, S = shape.global_batch, shape.seq_len
            want = jspecs.auto_batch_specs(
                jax_batch(jcfg, None, B, S, stacked=False), JAX_MESHES[mesh])
            got = specs.auto_batch_specs(
                _token_batch_shapes(cfg, None, B, S, stacked=False),
                MESHES[mesh])
            assert _port_specs(got) == _jax_specs(want), (arch, shape.name)
    odd = {"odd": torch.empty(3, 5, device="meta")}
    assert specs.auto_batch_specs(odd, MESHES[mesh])["odd"] == (None, None)


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_cache_specs_match_reference(arch, mesh):
    model = jax_get_model(jax_get_config(arch))
    points = [(s.global_batch, s.seq_len) for s in
              (INPUT_SHAPES["decode_32k"], INPUT_SHAPES["long_500k"])]
    for B, S in points + [(1, 32_768)]:
        want_shapes = jax.eval_shape(lambda: model.make_cache(B, S))
        got_shapes = cache_shapes(get_config(arch), B, S)
        for order in ("largest", "last"):
            want = jspecs.auto_tree_specs(want_shapes, JAX_MESHES[mesh],
                                          model_dim_order=order)
            got = specs.auto_tree_specs(got_shapes, MESHES[mesh],
                                        model_dim_order=order)
            assert _port_specs(got) == _jax_specs(want), (B, S, order)


STATE_CASES = [
    ("sgd", {}), ("momentum", {}), ("adam", {}), ("yogi", {}),
    ("momentum", {"server_momentum": 0.0}),
    ("adam", {"async_depth": 2, "backend": "scan_async"}),
    ("sgd", {"async_depth": 2, "backend": "scan_async",
             "async_mode": "ready", "adaptive_staleness": True,
             "latency_mode": "lognormal"}),
    ("yogi", {"divergence_guard": True}),
    ("sgd", {"wire_codec": "int8"}),
    ("sgd", {"wire_codec": "topk", "error_feedback": False}),
    ("momentum", {"candidate_pool": 4}),
]


@pytest.mark.parametrize("server_opt,kw", STATE_CASES,
                         ids=[f"{o}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for o, kw in STATE_CASES])
def test_federation_state_specs_match_reference(server_opt, kw):
    """The spec tree mirrors the state's tree (init_state over the smoke
    qwen1.5, 8 clients) and equals the reference's, field for field."""
    jmodel = jax_get_model(jax_get_smoke("qwen1_5_0_5b"))
    jshapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jfed = JaxFedConfig(server_opt=server_opt, **kw)
    want = jspecs.federation_state_specs(
        jfed, jspecs.auto_param_specs(jshapes, JAX_MESHES["single"]))
    shapes = param_shapes(get_smoke("qwen1_5_0_5b"))
    fed = FedConfig(server_opt=server_opt, **kw)
    got = specs.federation_state_specs(
        fed, specs.auto_param_specs(shapes, MESHES["single"]))
    state = engine.init_state(shapes, fed, 8)
    for f in dataclasses.fields(state):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert _port_specs(g) == _jax_specs(w), f.name
        leaves = _flat(getattr(state, f.name))
        assert set(leaves) == set(_flat(g)), f.name
        for path, spec in _flat(g).items():
            assert len(spec) <= leaves[path].dim(), (f.name, path)


def test_local_shape_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = mesh_shape(pod=2, data=16, model=16)
    assert specs.local_shape((64, 48, 7), (("pod", "data"), "model", None),
                             mesh) == (2, 3, 7)
    assert specs.local_shape((5,), ("model",), mesh.shape) == (1,)
    assert specs.placements((None, "model"), mesh) == [
        Replicate(), Replicate(), Shard(1)]
    assert specs.placements((("pod", "data"), None), mesh) == [
        Shard(0), Shard(0), Replicate()]
    with pytest.raises(ValueError):
        specs.placements((("data", "pod"),), mesh)


def test_pod_round_refusals():
    """A knob the model axis has not reached (dp on model 2), an FSDP arch
    and every knob the pod round has not reached raise
    NotImplementedError naming A17b, before any collective (a mesh shape
    stands in for the DeviceMesh)."""
    from repro_torch.models import get_model
    model = get_model(get_smoke("qwen1_5_0_5b"))
    fed = FedConfig(num_clients=8)
    cases = [(model, fed.replace(aggregator="dp"), mesh_shape(data=2, model=2)),
             (get_model(get_smoke("jamba_1_5_large_398b")), fed,
              mesh_shape(data=2, model=1))]
    for knobs in ({"selection": "grad_sim"},
                  {"aggregator": "cosine_filter"},
                  {"candidate_pool": 4}, {"fused_agg": False},
                  {"aggregator": "median", "wire_codec": "int8"}):
        cases.append((model, fed.replace(**knobs), mesh_shape(data=2, model=1)))
    for m, f, mesh in cases:
        with pytest.raises(NotImplementedError, match="A17b"):
            sharded.make_pod_round(m, f, 8, mesh, device="cpu")


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_full_state_specs_of_every_arch_match_reference(arch, mesh):
    """Every field of the federation state populated (adam's moments and
    step, the buffer with its clock, the drift sketch, the latencies, the
    guard's counter, the int8 wire's error-feedback rows) over each full
    config's param specs, fsdp by needs_fsdp: the reference's tree."""
    kw = dict(server_opt="adam", async_depth=2, backend="scan_async",
              async_mode="ready", adaptive_staleness=True,
              latency_mode="lognormal", divergence_guard=True,
              wire_codec="int8")
    fsdp = sharded.needs_fsdp(get_config(arch))
    want = jspecs.federation_state_specs(
        JaxFedConfig(**kw), jspecs.auto_param_specs(
            _jax_params(arch), JAX_MESHES[mesh], fsdp=fsdp))
    got = specs.federation_state_specs(
        FedConfig(**kw), specs.auto_param_specs(
            _port_params(arch), MESHES[mesh], fsdp=fsdp))
    for f in dataclasses.fields(got):
        assert _port_specs(getattr(got, f.name)) == \
            _jax_specs(getattr(want, f.name)), f.name
