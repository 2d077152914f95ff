"""The port's encoder-decoder (whisper-medium, ``models/encdec.py``) against
the JAX package on the CPU, in f32 at smoke size (2 encoder and 2 decoder
layers, d 256, 8 heads at hd 32, 32 frames): the config mirror, the
init's key tree, LayerNorm and the GELU MLP, cross-attention, ``encode``,
``decode_forward(mode="train")``, ``loss_fn`` with its gradients, serving
(``prefill`` with frames, ``pad_caches``, decode steps) and a kv tail
(frames that are no multiple of ``attn_block_kv``).

The reference's params are drawn once a module and carried across with
``convert.params_from_jax`` (an init draws 65,536 x d rows of ``pos_dec``);
the port's own init is held to the reference's in one test, at a narrower
width. Frames and tokens are numpy draws from a seed.

Tolerances: PARITY (2e-5) x max(1, max|want|) for activations, losses and
logits (tests/test_torch_lm.py: chained f32 products in another summation
order); gradients within GRAD_TOL (1e-5) of each leaf's largest magnitude;
greedy tokens exactly, after asserting every decision's top-1 / top-2 gap
exceeds twice the logits' bound; the port's decode against its own
teacher-forced logits at tests/test_serve.py's atol 5e-4 + rtol 5e-3."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.launch.serve import pad_caches as jax_pad_caches  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.launch.serve import pad_caches  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.utils import tree_leaves, tree_unflatten_like  # noqa: E402

ARCH = "whisper_medium"
PARITY = 2e-5
GRAD_TOL = 1e-5
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
    jp = JE.init(jax.random.PRNGKey(0), jcfg)
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


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _batch(cfg, B, S, seed, T=None):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S + 1))
    return {"frames": _normal((B, T or cfg.num_frames, cfg.d_model), seed + 100),
            "tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": (np.random.default_rng(seed + 1).random((B, S)) < 0.9
                     ).astype(np.float32)}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _gap(logits):
    top = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    return float(np.min(top[..., 1] - top[..., 0]))


# ------------------------------------------------------------------ config
def test_config_mirrors_the_reference():
    for j, t in ((jax_get_smoke(ARCH), get_smoke(ARCH)),
                 (jax_get_config(ARCH), get_config(ARCH))):
        for f in dataclasses.fields(j):
            if f.name not in ("param_dtype", "compute_dtype"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.pdtype == getattr(torch, j.param_dtype)
        assert t.cdtype == getattr(torch, j.compute_dtype)
    full = get_config("whisper-medium")
    assert full.encdec and full.encoder_layers == full.num_layers == 24
    assert full.num_frames == 1500 and full.head_dim == 64 and full.tie_embeddings


# -------------------------------------------------------------------- init
def test_init_matches_the_reference_key_tree():
    """The port draws its own weights: the reference's tree (``pos_dec``
    of 65,536 rows, per-layer leaves stacked on [layers]) leaf for leaf
    within 4 ulp, as the port's other inits (3 from the draw's erf_inv,
    one more from the scale's rounding), the norms' ones and the biases'
    zeros exactly. At d 16 (one head of 16), so that the 65,536-row
    ``pos_dec`` costs 1 M draws a package, not the smoke's 16.8 M."""
    narrow = dict(d_model=16, num_heads=1, num_kv_heads=1, head_dim=16, d_ff=32,
                  vocab_size=128)
    jcfg = jax_get_smoke(ARCH).replace(**narrow)
    tcfg = get_smoke(ARCH).replace(**narrow)
    mine = params_to_numpy(TE.init(prng.PRNGKey(0), tcfg, device="cpu"))
    want = jax.tree.map(np.asarray, JE.init(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.structure(mine) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _ulps(a, b).max() <= 4
    assert mine["pos_dec"].shape == (65536, 16)
    assert mine["dec_blocks"]["mlp"]["w_up"].shape == (2, 16, 32)
    assert np.all(mine["enc_norm"]["scale"] == 1) and np.all(mine["enc_norm"]["bias"] == 0)
    assert np.all(mine["dec_blocks"]["mlp"]["b_up"] == 0)


# ------------------------------------------------------------------ layers
def test_layernorm_takes_the_population_variance():
    """Random scale and bias, rows with a mean far from 0: against the
    reference's ``layernorm``; the sample variance (torch.var's default)
    would miss the bound."""
    d = 48
    x = _normal((5, 7, d), 1, 3.0) + 2.0
    p = {"scale": _normal((d,), 2), "bias": _normal((d,), 3)}
    want = np.asarray(JL.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x)))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = TL.layernorm(tp, torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, want)
    xt = torch.from_numpy(x)
    sample = ((xt - xt.mean(-1, keepdim=True)) * torch.rsqrt(xt.var(-1, keepdim=True) + 1e-5)
              * tp["scale"] + tp["bias"])
    assert float(np.abs(sample.numpy() - want).max()) > 10 * PARITY * np.abs(want).max()
    bf = TL.layernorm(tp, torch.from_numpy(x).to(torch.bfloat16))
    assert bf.dtype == torch.bfloat16


def test_gelu_mlp_is_the_tanh_gelu_with_biases():
    """Random weights and biases against the reference's ``gelu_mlp_apply``
    (``jax.nn.gelu``'s default, the tanh approximation); the erf GELU
    (torch's default) misses the bound on inputs of magnitude ~2."""
    d, f = 32, 64
    p = {"w_up": _normal((d, f), 4, 0.4), "b_up": _normal((f,), 5),
         "w_down": _normal((f, d), 6, 0.2), "b_down": _normal((d,), 7)}
    x = _normal((3, 9, d), 8)
    want = np.asarray(JL.gelu_mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                        jnp.asarray(x), jnp.float32))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(TL.gelu_mlp_apply(tp, torch.from_numpy(x), torch.float32), want)
    h = torch.nn.functional.gelu(torch.from_numpy(x) @ tp["w_up"] + tp["b_up"])
    erf = h @ tp["w_down"] + tp["b_down"]
    assert float(np.abs(erf.numpy() - want).max()) > PARITY * max(1.0, np.abs(want).max())


def test_cross_attention_matches_reference(pair):
    """The decoder's first layer's cross-attention weights, queries of 6
    rows over the 32 encoder rows, against the reference's."""
    jcfg, tcfg, jp, tp = pair
    x, enc = _normal((2, 6, jcfg.d_model), 9), _normal((2, jcfg.num_frames, jcfg.d_model), 10)
    jx = jax.tree.map(lambda t: t[0], jp["dec_blocks"]["cross_attn"])
    want = JA.cross_attention(jx, jnp.asarray(x), jnp.asarray(enc), jcfg)
    tx = {k: v[0] for k, v in tp["dec_blocks"]["cross_attn"].items()}
    got = TA.cross_attention(tx, torch.from_numpy(x), torch.from_numpy(enc), tcfg)
    _close(got, want)


# ------------------------------------------------------------------ forward
def test_encode_matches_reference(pair):
    jcfg, tcfg, jp, tp = pair
    frames = _normal((2, jcfg.num_frames, jcfg.d_model), 11)
    want = JE.encode(jp, jnp.asarray(frames), jcfg)
    got = TE.encode(tp, frames, tcfg)
    _close(got, want)


def test_decode_forward_train_matches_reference(pair):
    jcfg, tcfg, jp, tp = pair
    b = _batch(jcfg, 2, 9, 12)
    enc = JE.encode(jp, jnp.asarray(b["frames"]), jcfg)
    want, jc = JE.decode_forward(jp, jnp.asarray(b["tokens"]), enc, jcfg, mode="train")
    got, tc = TE.decode_forward(tp, b["tokens"], torch.from_numpy(np.asarray(enc)), tcfg,
                                mode="train")
    assert jc is None and tc is None
    _close(got, want)


def test_loss_and_gradients_match_reference(pair):
    """``loss_fn`` (remat on: each decoder block a checkpoint) and its
    gradient leaf for leaf against ``jax.value_and_grad``; the metrics'
    token count and ``aux_loss`` 0 exactly."""
    jcfg, tcfg, jp, tp = pair
    assert tcfg.remat
    b = _batch(jcfg, 2, 10, 13)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p, jb: JE.loss_fn(p, jb, jcfg),
                                              has_aux=True))(jp, _jnp(b))
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    tl, tm = TE.loss_fn(tree_unflatten_like(tp, leaves), _torch(b), tcfg)
    grads = torch.autograd.grad(tl, leaves)
    _close(tl.detach(), jl)
    assert float(tm["tokens"]) == float(jm["tokens"]) == float(b["mask"].sum())
    assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for got, want in zip(grads, jleaves):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        if scale == 0.0:                 # pos_dec rows past the tokens
            assert float(got.abs().max()) == 0.0
            continue
        err = float(np.abs(got.numpy() - want).max())
        assert err <= GRAD_TOL * scale, f"grad err {err} > {GRAD_TOL} x {scale}"


def test_remat_gives_the_gradient_without_it(pair):
    """Checkpointed decoder blocks run the same ops again in the backward:
    the gradient without remat, bit for bit."""
    _, tcfg, _, tp = pair
    b = _torch(_batch(tcfg, 2, 7, 14))
    out = []
    for remat in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
        loss, _ = TE.loss_fn(tree_unflatten_like(tp, leaves), b, tcfg.replace(remat=remat))
        out.append(torch.autograd.grad(loss, leaves))
    assert all(torch.equal(a, c) for a, c in zip(*out))


# ------------------------------------------------------------------ serving
def _serve_traces(jcfg, tcfg, jp, tp, frames, prompt, new):
    """prefill + pad_caches + ``new`` greedy decode steps in both packages
    (tests/test_serve.py:69's path), each feeding its own argmax: the
    logits of every call, the tokens, and the port's caches."""
    jm, tm = jax_get_model(jcfg), get_model(tcfg)
    B, S = prompt.shape
    jc, jl = jm.prefill(jp, {"tokens": jnp.asarray(prompt), "frames": jnp.asarray(frames)})
    jc = jax_pad_caches(jm, jc, B, S + new)
    tc, tl = tm.prefill(tp, {"tokens": torch.from_numpy(prompt),
                             "frames": torch.from_numpy(frames)})
    tc = pad_caches(tm, tc, B, S + new)
    jstep = jax.jit(jm.decode_step)
    jlog, tlog, jtok, ttok = [np.asarray(jl)], [tl.numpy()], [], []
    for i in range(new):
        jt = jnp.argmax(jnp.asarray(jlog[-1]), -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(torch.from_numpy(tlog[-1]), -1)[:, None].to(torch.int32)
        jtok.append(np.asarray(jt))
        ttok.append(tt.numpy())
        jl, jc = jstep(jp, jc, jt, jnp.int32(S + i))
        tl, tc = tm.decode_step(tp, tc, tt, S + i)
        jlog.append(np.asarray(jl))
        tlog.append(tl.numpy())
    return jlog, tlog, jtok, ttok, tc


def test_prefill_and_decode_steps_match_reference(pair):
    """2 x 6 prompt tokens over 32 frames, then 4 decode steps: f32 logits
    within PARITY of the reference's, greedy tokens equal; and each step's
    logits against the port's own train-mode forward on the same tokens
    (teacher forcing: K7 over the cache against the flash path)."""
    jcfg, tcfg, jp, tp = pair
    B, S, new = 2, 6, 4
    frames = _normal((B, jcfg.num_frames, jcfg.d_model), 15)
    prompt = np.random.default_rng(16).integers(0, jcfg.vocab_size, size=(B, S))
    jlog, tlog, jtok, ttok, tc = _serve_traces(jcfg, tcfg, jp, tp, frames, prompt, new)
    for got, want in zip(tlog, jlog):
        _close(got, want)
        assert _gap(want) > 2 * PARITY * max(1.0, float(np.abs(want).max()))
    for a, b in zip(ttok, jtok):
        assert np.array_equal(a, b)
    assert tc["dec"]["self"]["len"] == S + new
    toks = np.concatenate([prompt] + ttok, axis=1)
    enc = TE.encode(tp, frames, tcfg)
    hidden, _ = TE.decode_forward(tp, toks, enc, tcfg, mode="train")
    ref = (hidden.float() @ tp["embed"].T.float()).numpy()
    for i, got in enumerate(tlog):
        np.testing.assert_allclose(got, ref[:, S - 1 + i], **SERVE)


def test_caches_keep_the_cross_kv_and_enc_out(pair):
    """prefill's caches: self k / v of S rows and len S (a host int),
    cross k / v of the 32 frames for every layer, within PARITY of the
    reference's; ``pad_caches`` grows the self k / v only and hands the
    cross k / v and ``enc_out`` back as the same tensors; the meta cache's
    shapes are the reference's ``make_cache``'s."""
    jcfg, tcfg, jp, tp = pair
    B, S = 2, 5
    frames = _normal((B, jcfg.num_frames, jcfg.d_model), 17)
    prompt = np.random.default_rng(18).integers(0, jcfg.vocab_size, size=(B, S))
    jc, _ = JE.prefill(jp, {"tokens": jnp.asarray(prompt), "frames": jnp.asarray(frames)},
                       jcfg)
    tc, _ = TE.prefill(tp, {"tokens": torch.from_numpy(prompt),
                            "frames": torch.from_numpy(frames)}, tcfg)
    assert tc["dec"]["self"]["len"] == S == int(jc["dec"]["self"]["len"][0])
    for part in ("self", "cross"):
        for f in ("k", "v"):
            _close(tc["dec"][part][f], jc["dec"][part][f])
    _close(tc["enc_out"], jc["enc_out"])
    model = get_model(tcfg)
    padded = pad_caches(model, tc, B, S + 7)
    assert padded["dec"]["self"]["k"].shape[2] == S + 7
    assert torch.equal(padded["dec"]["self"]["v"][:, :, :S], tc["dec"]["self"]["v"])
    assert padded["dec"]["cross"]["k"] is tc["dec"]["cross"]["k"]
    assert padded["dec"]["cross"]["v"] is tc["dec"]["cross"]["v"]
    assert padded["enc_out"] is tc["enc_out"]
    want = jax.eval_shape(lambda: JE.make_cache(jcfg, B, S + 7))
    got = model.make_cache(B, S + 7, device="meta")
    assert got["dec"]["self"]["len"] == 0
    for part in ("self", "cross"):
        for f in ("k", "v"):
            assert tuple(got["dec"][part][f].shape) == want["dec"][part][f].shape
    assert tuple(got["enc_out"].shape) == want["enc_out"].shape


def test_kv_tail_matches_reference(pair):
    """40 frames with ``attn_block_kv`` 16: the encoder's 40 keys are no
    block multiple, so the plain flash attention pads and masks a tail
    (the card's kernel cuts its last 128-key tile the same way at 1500).
    The smoke weights with a 40-row ``pos_enc`` (numpy draws, the same in
    both): ``encode``, the loss, and prefill's logits (decode attends the
    frames in the unblocked cross-attention only)."""
    jcfg0, tcfg0, jp, tp = pair
    knobs = dict(num_frames=40, attn_block_kv=16)
    jcfg, tcfg = jcfg0.replace(**knobs), tcfg0.replace(**knobs)
    pe = _normal((40, jcfg.d_model), 19, 0.02)
    jp = dict(jp, pos_enc=jnp.asarray(pe))
    tp = dict(tp, pos_enc=torch.from_numpy(pe))
    b = _batch(jcfg, 2, 8, 20)
    _close(TE.encode(tp, b["frames"], tcfg), JE.encode(jp, jnp.asarray(b["frames"]), jcfg))
    _close(TE.loss_fn(tp, _torch(b), tcfg)[0], JE.loss_fn(jp, _jnp(b), jcfg)[0])
    prompt = b["tokens"][:, :5]
    _, jl = JE.prefill(jp, {"tokens": jnp.asarray(prompt),
                            "frames": jnp.asarray(b["frames"])}, jcfg)
    _, tl = TE.prefill(tp, {"tokens": torch.from_numpy(prompt),
                            "frames": torch.from_numpy(b["frames"])}, tcfg)
    _close(tl, jl)


def test_registry_dispatches_on_encdec():
    """``get_model`` binds the encoder-decoder's functions for whisper, the
    decoder-only ones otherwise, as the reference's registry."""
    model = get_model(get_smoke(ARCH))
    caches = model.make_cache(1, 4, device="meta")
    assert set(caches) == {"dec", "enc_out"}
    assert set(get_model(get_smoke("qwen1.5-0.5b")).make_cache(1, 4, device="meta")) \
        == {"pre", "periods"}
