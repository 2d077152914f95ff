"""The port's image inputs (``cfg.vlm``) and llava-next-34b against the JAX
package on the CPU, in f32 at smoke size (2 layers, d 256, 8 query heads
over 2 kv heads, 16 image rows): the config mirror, the model's key tree
with ``img_norm``; ``loss_fn`` on a batch with ``image_embeds`` (loss,
token count, gradients against ``jax.grad``) and without (the reference's
``AttributeError``, which ``launch.train.run`` raises too); both LM rounds
against the reference's on batches that carry image embeds; prefill with
images then decode at n_img + S + i, against teacher forcing and the
reference's ``prefill`` / ``decode_step``; the text-only ``generate``;
and the cache.

Batches lay out ``image_embeds`` as ``repro/launch/dryrun.py:
_token_batch_shapes`` does: [C, b, n_img, d] beside the clients' [C, b,
S_text] tokens, [b, n_img, d] beside the server's, drawn from numpy.

Tolerances: PARITY x max(1, max|want|) for activations and logits
(tests/test_torch_lm.py); gradients GRAD_TOL of each leaf's largest
magnitude (tests/test_torch_jamba.py); decode against the train-mode
forward at tests/test_serve.py's atol 5e-4 + rtol 5e-3; the rounds as
tests/test_torch_temporal.py's (gates and backlog exactly, losses 1e-5
relative, params atol = rtol = 5e-5)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_temporal as temporal_tests  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.launch.serve import pad_caches as jax_pad_caches  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.data.tokens import make_token_federation  # noqa: E402
from repro_torch.fl import engine, sharded  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.train import build_batches  # noqa: E402
from repro_torch.launch.serve import generate, pad_caches  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.utils import tree_leaves, tree_unflatten_like  # noqa: E402

ARCH = "llava_next_34b"
PARITY = 2e-5
GRAD_TOL = 1e-4
SERVE = dict(atol=5e-4, rtol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors: one torch thread for the module (see
    tests/test_torch_lm.py), the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, port cfg, jax params, port params carried across), one
    reference init for the module."""
    jcfg = jax_get_smoke(ARCH).replace(remat=False)
    tcfg = get_smoke(ARCH)
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _close(got, want, tol=PARITY):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err} > {tol} x {scale}"


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape)


def _images(cfg, lead, seed):
    """Stub vision-tower output [*lead, n_img, d], f32 normal draws."""
    shape = tuple(lead) + (cfg.num_image_tokens, cfg.d_model)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _batch(cfg, B, S, seed):
    toks = _tokens(cfg, (B, S + 1), seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": np.ones((B, S), np.float32),
            "image_embeds": _images(cfg, (B,), seed + 100)}


# ------------------------------------------------------------------ config
def test_config_mirrors_the_reference():
    for j, t in ((jax_get_smoke(ARCH), get_smoke(ARCH)),
                 (jax_get_config(ARCH), get_config(ARCH))):
        for f in dataclasses.fields(j):
            if f.name not in ("param_dtype", "compute_dtype"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.pdtype == getattr(torch, j.param_dtype)
        assert t.cdtype == getattr(torch, j.compute_dtype)
        assert t.n_periods == j.n_periods and t.layer_kinds() == j.layer_kinds()
    full = get_config("llava-next-34b")
    assert full.vlm and full.num_image_tokens == 576 and full.rope_theta == 5e6
    assert full.pdtype == torch.bfloat16 and not full.tie_embeddings
    assert full.num_heads // full.num_kv_heads == 7


# -------------------------------------------------------------------- init
def test_init_matches_the_reference_key_tree(pair):
    """The whole model's tree, ``img_norm`` among it (ones), leaf for leaf
    within 4 ulp; at full width the leaves' bf16 bytes are 68.8 GB
    (34.39 B params), counted on the meta device."""
    jcfg, tcfg, jp, _ = pair
    mine = params_to_numpy(TT.init(prng.PRNGKey(0), tcfg, device="cpu"))
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(mine) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _ulps(a, b).max() <= 4
    assert np.all(mine["img_norm"]["scale"] == 1)
    full = get_config(ARCH)
    shapes = jax.eval_shape(lambda: JT.init(jax.random.PRNGKey(0),
                                            jax_get_config(ARCH)))
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert round(n / 1e9, 2) == 34.39
    assert all(s.dtype == jnp.bfloat16 for s in jax.tree.leaves(shapes))
    assert round(2 * n / 1e9, 1) == 68.8 and full.num_layers == 60


# ------------------------------------------------------------------ train
def test_loss_and_gradient_with_images(pair):
    """The loss over the text positions only (tokens = B x S_text, as
    tests/test_models_smoke.py counts them) and every leaf's gradient,
    ``img_norm``'s included, against ``jax.grad``."""
    jcfg, tcfg, jp, tp = pair
    batch = _batch(tcfg, 2, 9, 4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg), has_aux=True))(jp)
    leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(tp)]
    tl, tm = TT.loss_fn(tree_unflatten_like(tp, leaves),
                        {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    _close(tl.detach(), jl)
    assert float(tm["tokens"]) == float(jm["tokens"]) == 2 * 9
    grads = torch.autograd.grad(tl, leaves)
    for g, want in zip(grads, jax.tree.leaves(jg)):
        _close(g, want, tol=GRAD_TOL)
    img = tree_unflatten_like(tp, list(grads))["img_norm"]["scale"]
    assert float(img.abs().max()) > 0


def test_missing_images_raise_the_reference_error(pair):
    """A llava batch without ``image_embeds``: the reference's ``loss_fn``
    and the port's raise the same ``AttributeError``; so does the port's
    ``launch.train.run``, whose batches (as the reference's
    ``build_batches``) carry none (ROADMAP, Reference caveats)."""
    jcfg, tcfg, jp, tp = pair
    batch = {k: v for k, v in _batch(tcfg, 2, 9, 4).items() if k != "image_embeds"}
    with pytest.raises(AttributeError) as want:
        JT.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    with pytest.raises(AttributeError) as got:
        TT.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    assert str(got.value) == str(want.value)
    with pytest.raises(AttributeError) as run:
        train.run(arch="llava-next-34b", rounds=1, clients=2, n_priority=1,
                  per_client=2, seq=16, device="cpu", verbose=False)
    assert str(run.value) == str(want.value)


# ------------------------------------------------------- federated training
C, B, S_TEXT, ROUNDS = 4, 2, 16, 2
BASE = dict(local_epochs=2, lr=0.05)
# eps 0.14 gates client 3 in and client 2 out in both rounds of both round
# kinds (every decision > 0.02 from eps)
EPS = 0.14


def _round_images(cfg):
    """Each round's image embeds, laid out as the reference's dryrun lays
    them out: (clients' [C, B, n_img, d], server's [B, n_img, d])."""
    return [(_images(cfg, (C, B), 1000 + 2 * r), _images(cfg, (B,), 1001 + 2 * r))
            for r in range(ROUNDS)]


def _jax_rounds(fsdp, images):
    """The reference's round (``fsdp``: its temporal round), jitted, on
    tests/test_torch_temporal.py's federation and batches (at S_TEXT) plus
    ``images``."""
    from repro.data.tokens import make_token_federation as jax_tokens
    from repro.fl import engine as jengine, sharded as jsharded
    from repro.launch.train import build_batches as jax_batches
    cfg = jax_get_smoke(ARCH).replace(remat=False)
    model = jax_get_model(cfg)
    fed = JaxFedConfig(**BASE, epsilon=EPS)
    data = jax_tokens(seed=0, vocab=cfg.vocab_size, n_clients=C, n_priority=2,
                      seq_len=S_TEXT, tokens_per_client=(S_TEXT + 1) * 8)
    step = jax.jit(jsharded.make_round_step(model, fed, C, fsdp=fsdp))
    state = jengine.init_state(model.init(jax.random.PRNGKey(0)), fed, C)
    rng = np.random.default_rng(0)
    stats = []
    for r, (ic, isv) in enumerate(images):
        batch = jax_batches(cfg, data, clients=C, per_client=B, seq=S_TEXT, rng=rng)
        batch["clients"]["image_embeds"] = jnp.asarray(ic)
        batch["server"]["image_embeds"] = jnp.asarray(isv)
        state, st = step(state, batch, jnp.int32(r))
        stats.append({k: np.asarray(v) for k, v in st.items()})
    return state, stats


def _port_rounds(fsdp, images):
    cfg = get_smoke(ARCH)
    model = get_model(cfg)
    fed = FedConfig(**BASE, epsilon=EPS)
    step = sharded.make_round_step(model, fed, C, fsdp=fsdp, device="cpu")
    state = engine.init_state(model.init(prng.PRNGKey(0), device="cpu"), fed, C)
    data = make_token_federation(seed=0, vocab=cfg.vocab_size, n_clients=C,
                                 n_priority=2, seq_len=S_TEXT,
                                 tokens_per_client=(S_TEXT + 1) * 8)
    rng = np.random.default_rng(0)
    stats = []
    for r, (ic, isv) in enumerate(images):
        batch = build_batches(cfg, data, clients=C, per_client=B, seq=S_TEXT,
                              rng=rng, device="cpu")
        batch["clients"]["image_embeds"] = torch.from_numpy(ic)
        batch["server"]["image_embeds"] = torch.from_numpy(isv)
        state, st = step(state, batch, r)
        stats.append({k: v.numpy() for k, v in st.items()})
    return state, stats


@pytest.mark.parametrize("fsdp", [False, True], ids=["spatial", "temporal"])
def test_lm_rounds_with_images_match_reference(fsdp):
    """Two rounds of the spatial round and of the temporal round (the one
    ``needs_fsdp`` picks for llava) on batches with image embeds: gates
    and backlog exactly after checking every decision's margin, losses,
    params, moments and EMAs within the stated bounds."""
    cfg = get_smoke(ARCH)
    assert sharded.needs_fsdp(cfg)
    images = _round_images(cfg)
    jstate, jstats = _jax_rounds(fsdp, images)
    tstate, tstats = _port_rounds(fsdp, images)
    temporal_tests.assert_margins(tstats, EPS)
    gated = np.stack([t["gates"][2:] for t in tstats])
    assert 0 < gated.sum() < gated.size
    temporal_tests.assert_state_parity(tstate, tstats, jstate, jstats)


# ----------------------------------------------------------------- serving
@functools.lru_cache(maxsize=None)
def _jax_decode(jcfg):
    return jax.jit(lambda p, c, t, pos: JT.decode_step(p, c, t, pos, jcfg))


def test_prefill_with_images_then_decode(pair):
    """Prefill 16 image rows and 9 text tokens, pad the caches to n_img +
    S + 5, then 5 decode steps at positions n_img + S + i (the reference's
    model API, as its ``generate`` is text-only): every logit against the
    port's train-mode forward on the images and all 14 tokens, and against
    the reference's ``prefill`` and jitted ``decode_step``."""
    jcfg, tcfg, jp, tp = pair
    model = get_model(tcfg)
    B_, S, new = 2, 9, 5
    n_img = tcfg.num_image_tokens
    toks = _tokens(tcfg, (B_, S + new), 3)
    img = _images(tcfg, (B_,), 3)
    hidden, _, _ = TT.forward(tp, torch.from_numpy(toks), tcfg, mode="train",
                              image_embeds=torch.from_numpy(img))
    assert hidden.shape[1] == n_img + S + new
    ref = hidden.float() @ tp["lm_head"].float()
    jcache, jl = JT.prefill(jp, {"tokens": jnp.asarray(toks[:, :S]),
                                 "image_embeds": jnp.asarray(img)}, jcfg)
    tcache, tl = model.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S]),
                                    "image_embeds": torch.from_numpy(img)})
    assert tcache["periods"]["l0"]["len"] == n_img + S
    np.testing.assert_allclose(tl.numpy(), ref[:, n_img + S - 1].numpy(), **SERVE)
    _close(tl, jl)
    _close(tcache["periods"]["l0"]["k"], jcache["periods"]["l0"]["k"])
    jcache = jax_pad_caches(jax_get_model(jcfg), jcache, B_, n_img + S + new)
    tcache = pad_caches(model, tcache, B_, n_img + S + new)
    step = _jax_decode(jcfg)
    for i in range(new - 1):
        tok = toks[:, S + i:S + i + 1].astype(np.int32)
        pos = n_img + S + i
        jl, jcache = step(jp, jcache, jnp.asarray(tok), pos)
        tl, tcache = model.decode_step(tp, tcache, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(tl.numpy(), ref[:, pos].numpy(), **SERVE)
        _close(tl, jl)


def test_text_only_generate_matches_reference_and_serve_main(pair, capsys):
    """``generate`` serves text only, as the reference's: greedy tokens
    equal the reference's after checking every decision's top-2 gap
    exceeds 5 x PARITY; ``serve.main`` at the smoke llava."""
    jcfg, tcfg, jp, tp = pair
    model = get_model(tcfg)
    prompt = _tokens(tcfg, (2, 7), 9).astype(np.int32)
    want = np.asarray(jax_generate(jax_get_model(jcfg), jp, jnp.asarray(prompt), 6))
    got = generate(model, tp, torch.from_numpy(prompt), 6, device="cpu")
    hidden, _, _ = TT.forward(tp, got[:, :-1], tcfg, mode="train")
    logits = hidden[:, 6:].float() @ tp["lm_head"].float()
    top = torch.topk(logits, 2, dim=-1).values
    assert float(torch.min(top[..., 0] - top[..., 1])) > 5 * PARITY
    np.testing.assert_array_equal(got.numpy(), want)
    toks = serve.main(["--arch", "llava-next-34b", "--batch", "2",
                       "--prompt-len", "5", "--gen", "3", "--device", "cpu"])
    assert toks.shape == (2, 8)
    assert "llava-next-34b: generated 2x3 tokens" in capsys.readouterr().out


def test_cache_shapes_and_bytes(pair):
    """The cache against the reference's ``jax.eval_shape``; at full width
    in bf16 it holds 245,760 B a token (60 layers x k and v x 8 kv heads x
    128), 0.54 GB for 2 sequences of 576 + 512 + 16 rows."""
    jcfg, tcfg, _, _ = pair
    want = jax.eval_shape(lambda: JT.make_cache(jcfg, 3, 17))
    got = TT.make_cache(tcfg, 3, 17, device="meta")
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        if isinstance(a, int):
            assert a == 0
        else:
            assert tuple(a.shape) == b.shape
    full = TT.make_cache(get_config(ARCH), 2, 576 + 512 + 16, device="meta")
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(full)
                 if isinstance(t, torch.Tensor))
    assert nbytes == 245_760 * 2 * 1104 and round(nbytes / 1e9, 2) == 0.54
