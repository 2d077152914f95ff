"""The port's serving path against the JAX package on the CPU, in f32 at
smoke size: the three tests of tests/test_serve.py (prefill then decode
against teacher forcing, the windowed ring roll, generate) and the three of
tests/test_scheduler.py, each also held against the reference's own
logits and tokens (the scheduler against the reference's generate, which
tests/test_scheduler.py pins equal to the reference's scheduler).

Tolerances:
* port against its own teacher-forced logits: tests/test_serve.py's atol
  5e-4 + rtol 5e-3;
* port against the JAX package: PARITY x max(1, max|logits|), about ten
  chained f32 products of K <= 512 terms, each off by ~sqrt(K) 2^-24
  relative in another summation order (~1.3e-5 in all);
* greedy tokens are compared exactly only after asserting that every token
  decision's top-1 / top-2 gap in the reference's logits exceeds twice the
  PARITY bound: closer logits could flip an argmax on rounding alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.launch.serve import pad_caches as jax_pad_caches  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import generate, pad_caches  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import BatchScheduler, Request  # noqa: E402

PARITY = 2e-5
SERVE = dict(atol=5e-4, rtol=5e-3)
_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors, where torch's intra-op thread pool costs more
    than it saves, badly so with several test workers on the host's cores:
    one thread for the module, the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, **knobs):
    """(jax model, jax params, port model, port params carried across)."""
    key = (arch, tuple(sorted(knobs.items())))
    if key not in _CACHE:
        jcfg = jax_get_smoke(arch).replace(remat=False, **knobs)
        tcfg = get_smoke(arch).replace(**knobs)
        jm, tm = jax_get_model(jcfg), get_model(tcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        _CACHE[key] = (jm, jp, tm, tp)
    return _CACHE[key]


def _parity(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= PARITY * scale


def _assert_decisions_resolved(trace):
    """Every reference logits row that becomes a token is decided by more
    than twice the PARITY bound."""
    for logits in trace:
        top = np.sort(np.asarray(logits, np.float32), axis=-1)[..., -2:]
        gap = float(np.min(top[..., 1] - top[..., 0]))
        scale = max(1.0, float(np.abs(logits).max()))
        assert gap > 2 * PARITY * scale, f"top-2 gap {gap}"


def _jax_trace(jm, jp, prompt, new):
    """The reference's generate, call by call (the same jitted prefill and
    decode_step): the logits of each token decision and the tokens [B, S +
    new] it returns."""
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


def _teacher_forced(arch, B, S, S2, seed, **knobs):
    jm, jp, tm, tp = _setup(arch, **knobs)
    cfg = tm.cfg
    toks = np.array(jax.random.randint(jax.random.PRNGKey(seed), (B, S2), 0,
                                       cfg.vocab_size))
    hidden, _, _ = TT.forward(tp, torch.from_numpy(toks), cfg, mode="train")
    w = tp["embed"].T if cfg.tie_embeddings else tp["lm_head"]
    ref_logits = (hidden.float() @ w.float()).numpy()
    jcaches, jlogits = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])})
    caches, logits = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])})
    np.testing.assert_allclose(logits.numpy(), ref_logits[:, S - 1], **SERVE)
    _parity(logits, jlogits)
    return jm, jp, tm, tp, toks, ref_logits, jcaches, caches


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "qwen2_5_3b", "phi3_mini_3_8b"])
def test_prefill_then_decode_matches_teacher_forced(arch):
    B, S, S2 = 2, 12, 18
    jm, jp, tm, tp, toks, ref_logits, jcaches, caches = _teacher_forced(
        arch, B, S, S2, 1)
    caches = pad_caches(tm, caches, B, S2)
    jcaches = jax_pad_caches(jm, jcaches, B, S2)
    for t in range(S, S2):
        logits, caches = tm.decode_step(tp, caches, torch.from_numpy(toks[:, t:t + 1]), t)
        jlogits, jcaches = jm.decode_step(jp, jcaches, jnp.asarray(toks[:, t:t + 1]),
                                          jnp.int32(t))
        np.testing.assert_allclose(logits.numpy(), ref_logits[:, t], **SERVE)
        _parity(logits, jlogits)
    assert caches["periods"]["l0"]["len"] == S2


def test_windowed_prefill_ring_roll():
    """Prefill longer than the window: ring slots must line up with decode,
    and the ring holds what the reference's holds."""
    B, S, S2 = 1, 13, 17                 # prefill 13 > window 8
    jm, jp, tm, tp, toks, ref_logits, jcaches, caches = _teacher_forced(
        "qwen1_5_0_5b", B, S, S2, 2, sliding_window=8)
    for name in ("k", "v"):
        _parity(caches["periods"]["l0"][name], jcaches["periods"]["l0"][name])
    assert caches["periods"]["l0"]["k"].shape[2] == 8
    for t in range(S, S2):
        logits, caches = tm.decode_step(tp, caches, torch.from_numpy(toks[:, t:t + 1]), t)
        jlogits, jcaches = jm.decode_step(jp, jcaches, jnp.asarray(toks[:, t:t + 1]),
                                          jnp.int32(t))
        np.testing.assert_allclose(logits.numpy(), ref_logits[:, t], **SERVE)
        _parity(logits, jlogits)
        for name in ("k", "v"):
            _parity(caches["periods"]["l0"][name], jcaches["periods"]["l0"][name])


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "qwen2_5_3b"])
def test_generate_shapes_determinism_and_reference_tokens(arch):
    jm, jp, tm, tp = _setup(arch)
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(3), (2, 8), 0,
                                         tm.cfg.vocab_size))
    out1 = generate(tm, tp, torch.from_numpy(prompt), 6, device="cpu")
    out2 = generate(tm, tp, prompt, 6, device="cpu")
    assert out1.shape == (2, 14) and out1.dtype == torch.int32
    assert torch.equal(out1, out2)
    assert int(out1.max()) < tm.cfg.vocab_size
    np.testing.assert_array_equal(out1[:, :8].numpy(), prompt)
    trace, want = _jax_trace(jm, jp, prompt, 6)
    np.testing.assert_array_equal(want, np.asarray(
        jax_generate(jm, jp, jnp.asarray(prompt), 6)))
    _assert_decisions_resolved(trace)
    np.testing.assert_array_equal(out1.numpy(), want)


def test_pad_caches_grows_the_sequence_axis_only():
    _, _, tm, tp = _setup("qwen1_5_0_5b")
    caches, _ = tm.prefill(tp, {"tokens": torch.zeros(2, 5, dtype=torch.int32)})
    padded = pad_caches(tm, caches, 2, 9)
    k, k0 = padded["periods"]["l0"]["k"], caches["periods"]["l0"]["k"]
    assert k.shape == (tm.cfg.n_periods, 2, 9, tm.cfg.num_kv_heads, tm.cfg.head_dim)
    assert torch.equal(k[:, :, :5], k0) and not k[:, :, 5:].any()
    assert padded["periods"]["l0"]["len"] == 5 and padded["pre"] == []


# --------------------------------------------------------------- scheduler
def _sequential(arch, prompt, max_new):
    """The reference's generate tokens for one prompt (its decisions
    asserted resolved), which the port's generate matches."""
    jm, jp, tm, tp = _setup(arch)
    trace, want = _jax_trace(jm, jp, prompt[None], max_new)
    _assert_decisions_resolved(trace)
    want = want[0, len(prompt):]
    mine = generate(tm, tp, prompt[None], max_new, device="cpu")[0, len(prompt):]
    np.testing.assert_array_equal(mine.numpy(), want)
    return want


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "qwen2_5_3b"])
def test_scheduler_matches_sequential_generate(arch):
    jm, jp, tm, tp = _setup(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 9, 7)]
    sched = BatchScheduler(tm, tp, batch_slots=2, max_len=32, device="cpu")
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    done = sched.run()
    assert len(done) == len(prompts)
    # two waves of lock-step ticks; a slot's first new token comes from the
    # tick that feeds its last prompt token, so a wave lasts its longest
    # prompt + 6 - 1 ticks
    assert sched.ticks == (9 + 5) + (9 + 5)
    by_rid = {r.rid: r for r in done}
    for i, p in enumerate(prompts):
        want = _sequential(arch, p, 6)
        got = np.asarray(by_rid[i].out_tokens)
        assert len(got) == 6 and by_rid[i].done
        np.testing.assert_array_equal(got, want)


def test_scheduler_eos_stops_early():
    _, _, tm, tp = _setup("qwen1_5_0_5b")
    rng = np.random.default_rng(1)
    p = rng.integers(0, tm.cfg.vocab_size, size=6).astype(np.int32)
    ref = _sequential("qwen1_5_0_5b", p, 12)
    eos = int(ref[2])                  # force stop at the 3rd generated token
    sched = BatchScheduler(tm, tp, batch_slots=1, max_len=32, eos_id=eos, device="cpu")
    sched.submit(Request(rid=0, prompt=p, max_new_tokens=12))
    done = sched.run()
    assert done[0].out_tokens[-1] == eos
    assert len(done[0].out_tokens) <= 3
    np.testing.assert_array_equal(done[0].out_tokens, ref[:len(done[0].out_tokens)])


def test_scheduler_multiple_waves():
    _, _, tm, tp = _setup("qwen1_5_0_5b")
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(0, tm.cfg.vocab_size, size=4)
                    .astype(np.int32), max_new_tokens=3) for i in range(5)]
    sched = BatchScheduler(tm, tp, batch_slots=2, max_len=16, device="cpu")
    for r in reqs:
        sched.submit(r)
    done = sched.run()
    assert sorted(r.rid for r in done) == [0, 1, 2, 3, 4]
    assert all(len(r.out_tokens) == 3 for r in done)
    assert sched.ticks == 3 * 6 and sched.idle()
