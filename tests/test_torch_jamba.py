"""The port's jamba (attention + 7 Mamba mixers a period, MoE FFNs on every
other layer) against the JAX package on the CPU, in f32 at smoke size: the
config mirror, the init's key tree, the train-mode forward with its aux,
the prefill caches, decode logits, ``generate``'s and the
``BatchScheduler``'s tokens, ``serve.main``; and MoE on the dense pattern
(the smoke qwen1.5-0.5b with 4 experts, top-2).

Tolerances (as tests/test_torch_serve.py):
* port against its own teacher-forced logits: tests/test_serve.py's atol
  5e-4 + rtol 5e-3, at capacity_factor 16 (no token dropped, so a token's
  output does not depend on the others in its batch: the reference's
  tests/test_models_smoke.py sets the same for MoE);
* port against the JAX package: PARITY x max(1, max|want|), a few dozen
  chained f32 products of K <= 544 terms, each off by ~sqrt(K) 2^-24
  relative in another summation order;
* greedy tokens are compared exactly only after asserting that every token
  decision's top-1 / top-2 gap exceeds twice the PARITY bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.launch.serve import pad_caches as jax_pad_caches  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import BatchScheduler as JaxBatchScheduler  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import generate, pad_caches  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import BatchScheduler, Request  # noqa: E402

ARCH = "jamba_1_5_large_398b"
PARITY = 2e-5
SERVE = dict(atol=5e-4, rtol=5e-3)
NO_DROP = dict(capacity_factor=16.0)
_CACHE = {}
_PARAMS = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors, where torch's intra-op thread pool costs more
    than it saves, badly so with several test workers on the host's cores:
    one thread for the module, the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch=ARCH, **knobs):
    """(jax model, jax params, port model, port params carried across);
    one JAX init per architecture and knobs other than the capacity."""
    key = (arch, tuple(sorted(knobs.items())))
    if key not in _CACHE:
        jcfg = jax_get_smoke(arch).replace(remat=False, **knobs)
        tcfg = get_smoke(arch).replace(**knobs)
        jm, tm = jax_get_model(jcfg), get_model(tcfg)
        init_key = (arch, tuple(sorted((k, v) for k, v in knobs.items()
                                       if k != "capacity_factor")))
        if init_key not in _PARAMS:
            jp = jm.init(jax.random.PRNGKey(0))
            _PARAMS[init_key] = (jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
        _CACHE[key] = (jm, _PARAMS[init_key][0], tm, _PARAMS[init_key][1])
    return _CACHE[key]


def _parity(got, want, tol=PARITY):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err} > {tol} x {scale}"


def _gap(logits):
    top = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
    return float(np.min(top[..., 1] - top[..., 0]))


def _assert_decisions_resolved(trace):
    for logits in trace:
        scale = max(1.0, float(np.abs(logits).max()))
        assert _gap(logits) > 2 * PARITY * scale, f"top-2 gap {_gap(logits)}"


# ------------------------------------------------------------------ config
def test_config_mirrors_the_reference_and_keeps_the_dt_rank():
    for j, t in ((jax_get_smoke(ARCH), get_smoke(ARCH)),
                 (jax_get_config(ARCH), get_config(ARCH))):
        for f in dataclasses.fields(j):
            if f.name not in ("param_dtype", "compute_dtype"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.pdtype == getattr(torch, j.param_dtype)
        assert t.cdtype == getattr(torch, j.compute_dtype)
        assert t.n_periods == j.n_periods and t.d_inner == j.d_inner
        assert t.layer_kinds() == j.layer_kinds()
    smoke = get_smoke("jamba-1.5-large-398b")
    assert smoke.ssm_dt_rank == 512 and smoke.d_inner == 256
    kinds = smoke.layer_kinds()
    assert [k["mixer"] for k in kinds] == ["attn"] + ["mamba"] * 7
    assert [k["ffn"] for k in kinds] == ["dense", "moe"] * 4


# -------------------------------------------------------------------- init
def test_init_matches_the_reference_key_tree():
    """The port draws its own weights: the reference's key tree leaf for
    leaf within 4 ulp (3 from the draw's erf_inv, one more from the
    scale's rounding), the constants (A_log, D, dt_bias, norms, conv bias)
    within one."""
    _, jp, tm, tp = _setup()
    mine = params_to_numpy(tm.init(prng.PRNGKey(0), device="cpu"))
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(mine) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        ulps = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
        assert ulps.max() <= 4
    assert set(tp["periods"]) == {f"l{j}" for j in range(8)}
    assert "mamba" in tp["periods"]["l1"] and "moe" in tp["periods"]["l1"]
    assert "attn" in tp["periods"]["l0"] and "mlp" in tp["periods"]["l0"]


# ------------------------------------------------------------------ forward
def _jax_layer_auxes(jp, toks, jcfg):
    """Each layer's aux term, the reference's ``_apply_block`` run layer by
    layer on the reference's forward (train mode), the layer loop jitted
    once (op by op it takes ~14 s at smoke size on one core)."""
    @jax.jit
    def auxes(jp, toks):
        x = jp["embed"][toks].astype(jcfg.cdtype)
        positions = jnp.arange(toks.shape[1])
        out = []
        for i in range(jcfg.n_periods):
            pp = jax.tree.map(lambda a: a[i], jp["periods"])
            for j, kind in enumerate(jcfg.layer_kinds()):
                x, _, aux = JT._apply_block(pp[f"l{j}"], x, jcfg, kind,
                                            positions=positions, mode="train",
                                            cache=None)
                out.append(aux)
        return jnp.stack(out)
    return [float(a) for a in np.asarray(auxes(jp, toks))]


@pytest.mark.parametrize("arch,knobs", [
    (ARCH, {}),
    ("qwen1_5_0_5b", dict(moe=True, num_experts=4, top_k=2, moe_d_ff=128)),
], ids=["jamba", "qwen_moe"])
def test_train_forward_and_aux(arch, knobs):
    """The port's aux is the reference's: ``forward`` adds each period's
    last layer's router_aux_coef x lb_loss (``period_fn`` returns
    ``aux_acc + aux`` after its layer loop, repro/models/transformer.py:
    142-151), so for jamba l7's alone of the four MoE layers with a
    positive aux; one layer a period (the dense pattern) counts them all.
    The task loss, the aux and the loss are held to the reference's."""
    jm, jp, tm, tp = _setup(arch, **knobs)
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab_size, size=(2, 11))
    jh, _, jaux = JT.forward(jp, jnp.asarray(toks), jm.cfg, mode="train")
    th, tc, taux = TT.forward(tp, torch.from_numpy(toks), tm.cfg, mode="train")
    assert tc is None
    _parity(th, jh)
    per_layer = _jax_layer_auxes(jp, jnp.asarray(toks), jm.cfg)
    period = len(tm.cfg.layer_kinds())
    _parity(jaux, sum(per_layer[period - 1::period]))     # the reference's sum
    _parity(taux, jaux)
    assert sum(a > 0 for a in per_layer) == (4 if arch == ARCH else tm.cfg.num_layers)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "mask": np.ones(toks.shape, np.float32)}
    jl, jmet = jm.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tmet = tm.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    _parity(tmet["task_loss"], jmet["task_loss"])
    _parity(tmet["aux_loss"], jmet["aux_loss"])
    _parity(tl, jl)


def test_dense_moe_loss_gradient_matches_reference():
    """MoE trains on the dense pattern (the Mamba scan does not yet):
    loss_fn's gradient leaf for leaf against jax.grad."""
    knobs = dict(moe=True, num_experts=4, top_k=2, moe_d_ff=128)
    jm, jp, tm, tp = _setup("qwen1_5_0_5b", **knobs)
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab_size, size=(2, 9))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "mask": np.ones(toks.shape, np.float32)}
    jg = jax.grad(lambda p: jm.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(jp)
    from repro_torch.utils import tree_leaves, tree_unflatten_like
    leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(tp)]
    loss = tm.loss_fn(tree_unflatten_like(tp, leaves),
                      {k: torch.from_numpy(v) for k, v in batch.items()})[0]
    grads = torch.autograd.grad(loss, leaves)
    for g, want in zip(grads, jax.tree.leaves(jg)):
        _parity(g, want, tol=1e-4)


def _jamba_reference_grad(jcfg):
    """(batch, loss, gradient) of the reference's smoke jamba under
    ``jcfg`` on one 2 x 9 batch."""
    _, jp, tm, _ = _setup()
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, size=(2, 9))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "mask": np.ones(toks.shape, np.float32)}
    jl, jg = jax.value_and_grad(lambda p: JT.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)[0])(jp)
    return batch, jl, jax.tree.leaves(jg)


def _port_grad(tp, batch, cfg):
    from repro_torch.utils import tree_leaves, tree_unflatten_like
    leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(tp)]
    loss = TT.loss_fn(tree_unflatten_like(tp, leaves),
                      {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)[0]
    return loss, torch.autograd.grad(loss, leaves)


def test_jamba_gradient_is_refused():
    """Once a refusal (ROADMAP A16f), now the gradient: the smoke jamba's
    loss_fn gradient (remat on, the Mamba mixers through the SSMScan
    Function, the MoE on the dense pattern) against jax.grad of the
    reference's (no remat, the same function), leaf for leaf within 1e-4
    x max(1, max|want|), as the dense MoE test above."""
    jm, _, tm, tp = _setup()
    assert tm.cfg.remat and tm.cfg.remat_policy == "full"
    batch, _, jg = _jamba_reference_grad(jm.cfg)
    _, grads = _port_grad(tp, batch, tm.cfg)
    assert len(grads) == len(jg)
    for g, want in zip(grads, jg):
        _parity(g, want, tol=1e-4)


def test_save_mixer_gradient_matches_reference_and_full():
    """``remat_policy="save_mixer"`` on the smoke jamba (8 layers a period,
    an attention and 7 Mamba mixers, MoE on every other layer): the loss
    and gradient against jax.grad of the reference under the same policy,
    leaf for leaf within 1e-4 x max(1, max|want|) as the test above; and
    the port's "full" policy's, bit for bit (the period's aux is still its
    last layer's)."""
    jm, _, tm, tp = _setup()
    batch, jl, jg = _jamba_reference_grad(
        jm.cfg.replace(remat=True, remat_policy="save_mixer"))
    loss, grads = _port_grad(tp, batch, tm.cfg.replace(remat_policy="save_mixer"))
    loss_full, grads_full = _port_grad(tp, batch, tm.cfg)
    _parity(loss.detach(), jl)
    assert len(grads) == len(jg)
    for g, want in zip(grads, jg):
        _parity(g, want, tol=1e-4)
    assert torch.equal(loss, loss_full)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_full))


# ------------------------------------------------------------------ serving
def test_prefill_caches_match_reference():
    jm, jp, tm, tp = _setup()
    toks = np.random.default_rng(4).integers(0, tm.cfg.vocab_size, size=(2, 10))
    jc, jl = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tc, tl = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _parity(tl, jl)
    assert tc["pre"] == [] and set(tc["periods"]) == set(jc["periods"])
    for name, c in tc["periods"].items():
        jcn = jc["periods"][name]
        for field, t in c.items():
            if field == "len":
                assert t == int(jcn["len"][0]) == 10
                continue
            assert t.dtype == (torch.float32 if field == "h" else tm.cfg.cdtype)
            _parity(t, jcn[field])
    assert tc["periods"]["l1"]["conv"].shape == (1, 2, 3, tm.cfg.d_inner)
    assert tc["periods"]["l1"]["h"].shape == (1, 2, tm.cfg.d_inner, 16)


def test_pad_caches_passes_recurrent_states_through():
    _, _, tm, tp = _setup()
    caches, _ = tm.prefill(tp, {"tokens": torch.zeros(2, 5, dtype=torch.int32)})
    padded = pad_caches(tm, caches, 2, 9)
    for j in range(1, 8):
        for field in ("conv", "h"):
            assert padded["periods"][f"l{j}"][field] is caches["periods"][f"l{j}"][field]
    k = padded["periods"]["l0"]["k"]
    assert k.shape[2] == 9 and torch.equal(k[:, :, :5], caches["periods"]["l0"]["k"])
    full = tm.make_cache(2, 9, device="meta")
    assert full["periods"]["l3"]["h"].shape == caches["periods"]["l3"]["h"].shape


def test_prefill_then_decode_matches_teacher_forced_and_reference():
    jm, jp, tm, tp = _setup(**NO_DROP)
    B, S, S2 = 2, 12, 18
    cfg = tm.cfg
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S2), 0, cfg.vocab_size))
    hidden, _, _ = TT.forward(tp, torch.from_numpy(toks), cfg, mode="train")
    ref_logits = (hidden.float() @ tp["lm_head"].float()).numpy()
    jcaches, jlogits = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :S])})
    caches, logits = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])})
    np.testing.assert_allclose(logits.numpy(), ref_logits[:, S - 1], **SERVE)
    _parity(logits, jlogits)
    caches = pad_caches(tm, caches, B, S2)
    jcaches = jax_pad_caches(jm, jcaches, B, S2)
    jstep = jax.jit(jm.decode_step)
    for t in range(S, S2):
        logits, caches = tm.decode_step(tp, caches, torch.from_numpy(toks[:, t:t + 1]), t)
        jlogits, jcaches = jstep(jp, jcaches, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        np.testing.assert_allclose(logits.numpy(), ref_logits[:, t], **SERVE)
        _parity(logits, jlogits)
    assert caches["periods"]["l0"]["len"] == S2
    for j in range(1, 8):
        for field in ("conv", "h"):
            _parity(caches["periods"][f"l{j}"][field], jcaches["periods"][f"l{j}"][field])


@pytest.mark.parametrize("S", [1, 2, 3, 5])
def test_short_prompts_prefill_then_decode(S):
    """Prompts shorter than ssm_conv_dim - 1 tokens (ROADMAP Queue C2): the
    port's prefill left-pads the conv cache (models/ssm.py) and decodes.
    Each of 3 decode steps is held against the port's own train-mode
    forward over the whole sequence; at S >= 3, where the reference's
    prefill keeps a full conv cache, also against the reference's prefill
    + decode (below that the reference's next decode raises)."""
    jm, jp, tm, tp = _setup(**NO_DROP)
    B, new = 2, 3
    cfg = tm.cfg
    assert cfg.ssm_conv_dim - 1 == 3
    toks = np.random.default_rng(10 + S).integers(0, cfg.vocab_size, size=(B, S + new))
    hidden, _, _ = TT.forward(tp, torch.from_numpy(toks), cfg, mode="train")
    ref_logits = (hidden.float() @ tp["lm_head"].float()).numpy()
    caches, logits = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])})
    assert caches["periods"]["l1"]["conv"].shape == (1, B, 3, cfg.d_inner)
    np.testing.assert_allclose(logits.numpy(), ref_logits[:, S - 1], **SERVE)
    caches = pad_caches(tm, caches, B, S + new)
    witness = S >= cfg.ssm_conv_dim - 1
    if witness:
        jcaches, jlogits = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :S])})
        _parity(logits, jlogits)
        jcaches = jax_pad_caches(jm, jcaches, B, S + new)
        jstep = jax.jit(jm.decode_step)
    for t in range(S, S + new):
        logits, caches = tm.decode_step(tp, caches, torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(logits.numpy(), ref_logits[:, t], **SERVE)
        if witness:
            jlogits, jcaches = jstep(jp, jcaches, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
            _parity(logits, jlogits)
    assert caches["periods"]["l0"]["len"] == S + new


def _jax_trace(jm, jp, prompt, new):
    """The reference's generate, call by call: the logits of each token
    decision and the tokens [B, S + new] it returns."""
    B, S = prompt.shape
    caches, logits = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt)})
    caches = jax_pad_caches(jm, caches, B, S + new)
    step = jax.jit(jm.decode_step)
    trace, out = [], [np.asarray(prompt)]
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for i in range(new):
        trace.append(np.asarray(logits))
        out.append(np.asarray(tok))
        logits, caches = step(jp, caches, tok, jnp.int32(S + i))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    return trace, np.concatenate(out, axis=1)


def test_generate_matches_reference_tokens():
    jm, jp, tm, tp = _setup()
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(3), (2, 8), 0,
                                         tm.cfg.vocab_size))
    out = generate(tm, tp, torch.from_numpy(prompt), 6, device="cpu")
    assert out.shape == (2, 14) and out.dtype == torch.int32
    trace, want = _jax_trace(jm, jp, prompt, 6)
    np.testing.assert_array_equal(want, np.asarray(jax_generate(jm, jp, jnp.asarray(prompt), 6)))
    _assert_decisions_resolved(trace)
    np.testing.assert_array_equal(out.numpy(), want)


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in lengths]


def test_scheduler_matches_reference_scheduler():
    """At the config's capacity (1.25) a decode tick's MoE capacity couples
    the slots of a wave, so the port's scheduler is held against the
    reference's scheduler, token for token; every decision the port turns
    into a token is first checked to be resolved (its top-2 gap over four
    times the PARITY bound, so the reference's exceeds twice it)."""
    jm, jp, tm, tp = _setup()
    lengths, new, slots = (5, 9, 9, 7, 4), 5, 2
    prompts = _prompts(tm.cfg, lengths, 0)
    ticks = []

    def recording(params, caches, tokens, pos):
        logits, caches = TT.decode_step(params, caches, tokens, pos, tm.cfg)
        ticks.append(logits.numpy())
        return logits, caches
    sched = BatchScheduler(dataclasses.replace(tm, decode_step=recording), tp,
                           batch_slots=slots, max_len=32, device="cpu")
    jsched = JaxBatchScheduler(jm, jp, batch_slots=slots, max_len=32)
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=new))
        jsched.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=new))
    done = {r.rid: r.out_tokens for r in sched.run()}
    jdone = {r.rid: r.out_tokens for r in jsched.run()}
    assert sched.ticks == jsched.ticks == len(ticks)
    start = 0                            # each wave's first tick
    for w in range(0, len(prompts), slots):
        wave = lengths[w:w + slots]
        for i, n in enumerate(wave):
            for m in range(new):         # row i's token m comes from tick n - 1 + m
                row = ticks[start + n - 1 + m][i]
                assert _gap(row) > 4 * PARITY * max(1.0, float(np.abs(row).max()))
        start += max(wave) + new - 1
    assert done == jdone
    assert all(len(t) == new for t in done.values())


def test_scheduler_matches_generate_without_drops():
    """With no token dropped every slot is independent: the scheduler's
    tokens (fed through decode steps) equal generate's (prefill, then
    decode) for each prompt alone, and the reference's."""
    jm, jp, tm, tp = _setup(**NO_DROP)
    prompts = _prompts(tm.cfg, (7, 7, 7), 1)
    sched = BatchScheduler(tm, tp, batch_slots=2, max_len=32, device="cpu")
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    done = {r.rid: r for r in sched.run()}
    for i, p in enumerate(prompts):
        trace, want = _jax_trace(jm, jp, p[None], 5)
        _assert_decisions_resolved(trace)
        mine = generate(tm, tp, p[None], 5, device="cpu")[0, len(p):]
        np.testing.assert_array_equal(mine.numpy(), want[0, len(p):])
        np.testing.assert_array_equal(np.asarray(done[i].out_tokens), want[0, len(p):])


def test_serve_main_runs_jamba_on_the_cpu(capsys):
    toks = serve.main(["--arch", "jamba-1.5-large-398b", "--batch", "2",
                       "--prompt-len", "6", "--gen", "3", "--device", "cpu"])
    assert toks.shape == (2, 9) and int(toks.max()) < get_smoke(ARCH).vocab_size
    assert "jamba-1.5-large-398b: generated 2x3 tokens" in capsys.readouterr().out
