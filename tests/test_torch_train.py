"""Federated LM training in the port against the JAX package on the CPU, at
smoke size in f32: the token federation, the chunked loss, ``loss_fn``'s
value and gradient, the training CLI, serving on trained params, and the
knobs outside the slice (the round itself: tests/test_torch_train_round.py).

Tolerances:

* PARITY (2e-5, as tests/test_torch_lm.py): activations, losses and
  gradients, relative to the largest magnitude compared (at least 1 for
  losses): about ten chained f32 products of K <= 512 terms, each off by
  ~sqrt(K) 2^-24 relative in another summation order (~1.3e-5).
* The round's params after 3 rounds (tests/test_torch_train_round.py):
  PARITY relative to each leaf's largest magnitude (at least 1); E = 2 SGD
  steps at lr 0.05 a round move the params by less than their own size,
  and the gradients agree to ~2e-6 relative. Under int8 with error
  feedback one more quantum of the run's largest row scale (a last-bit
  difference of a delta can cross a rounding boundary;
  tests/test_torch_round_agg.py).
* Gates and included counts exactly, after checking that every gate
  decision's |F_k - F| is farther than 1e-3 from eps in the port's run."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.tokens import make_token_federation  # noqa: E402
from repro_torch.fl import engine, sharded  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.train import build_batches  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

PARITY = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors, where torch's intra-op thread pool costs more
    than it saves, badly so with several test workers on the host's cores:
    one thread for the module, the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=PARITY, floor=0.0):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(floor, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err} > {tol} x {scale}"


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("kw", [dict(), dict(seed=3, vocab=100, n_clients=5,
                                             n_priority=2, seq_len=31,
                                             tokens_per_client=4000,
                                             misalign_max=0.7)])
def test_token_federation_is_byte_identical(kw):
    from repro.data.tokens import make_token_federation as jax_tokens
    want, got = jax_tokens(**kw), make_token_federation(**kw)
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype
        assert want[k].tobytes() == got[k].tobytes(), k


# ------------------------------------------------------------------- loss
@pytest.mark.parametrize("S,chunk", [(64, 32), (50, 32), (20, 64)],
                         ids=["chunk_multiple", "padded", "chunk_gt_S"])
def test_chunked_softmax_xent_value_and_grad_match_reference(S, chunk):
    rng = np.random.default_rng(S)
    B, D, V = 2, 48, 97
    h = rng.normal(size=(B, S, D)).astype(np.float32)
    w = (0.2 * rng.normal(size=(V, D))).astype(np.float32)
    y = rng.integers(0, V, size=(B, S)).astype(np.int32)
    m = (rng.random((B, S)) < 0.8).astype(np.float32)

    def jloss(h, w):
        s, c = JL.chunked_softmax_xent(h, w, jnp.asarray(y), jnp.asarray(m),
                                       chunk)
        return s, c
    (js, jc), (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(jnp.asarray(h),
                                                            jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ts, tc = TL.chunked_softmax_xent(th, tw, torch.from_numpy(y),
                                     torch.from_numpy(m), chunk)
    tgh, tgw = torch.autograd.grad(ts, (th, tw))
    assert float(tc) == float(jc) == float(m.sum())
    _close(ts.detach(), js, floor=1.0)
    _close(tgh, jgh)
    _close(tgw, jgw)


def _loss_inputs(cfg, seed=0, B=2, S=50):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.9).astype(np.float32)
    return toks[:, :-1], toks[:, 1:], mask


@pytest.mark.parametrize("arch,knobs", [("qwen1.5-0.5b", {}),
                                        ("qwen2.5-3b", {}),
                                        ("qwen1.5-0.5b", {"sliding_window": 16}),
                                        ("qwen1.5-0.5b", {"remat_policy": "save_mixer"})],
                         ids=["qwen1.5", "qwen2.5", "qwen1.5_window16",
                              "qwen1.5_save_mixer"])
def test_loss_fn_value_and_grad_match_reference(arch, knobs):
    """With remat (the smoke configs' default; under ``save_mixer`` the
    reference's policy too): the FlashAttention and RMSNorm Functions'
    backward on the CPU (the kernels' plain formulas) against
    jax.value_and_grad of the reference's jnp model."""
    jcfg, tcfg = jax_get_smoke(arch).replace(**knobs), get_smoke(arch).replace(**knobs)
    assert tcfg.remat
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    tokens, labels, mask = _loss_inputs(jcfg)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
          "mask": jnp.asarray(mask)}
    (jl, jm), jg = jax.value_and_grad(lambda p: JT.loss_fn(p, jb, jcfg),
                                      has_aux=True)(jp)
    tp = tree_map(lambda x: x.requires_grad_(True),
                  params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels),
          "mask": torch.from_numpy(mask)}
    tl, tm = TT.loss_fn(tp, tb, tcfg)
    grads = torch.autograd.grad(tl, tree_leaves(tp))
    _close(tl.detach(), jl, floor=1.0)
    _close(tm["task_loss"].detach(), jm["task_loss"], floor=1.0)
    assert float(tm["tokens"]) == float(jm["tokens"]) == float(mask.sum())
    assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for want, got in zip(jleaves, grads):
        assert float(np.abs(np.asarray(want)).max()) > 0.0
        _close(got, want)


def test_remat_gives_the_gradient_of_the_plain_forward():
    """Checkpointed periods recompute the forward in the backward: the same
    gradient as without remat, bit for bit on the CPU."""
    cfg = get_smoke("qwen2.5-3b")
    params = TT.init(prng.PRNGKey(0), cfg, device="cpu")
    tokens, labels, mask = _loss_inputs(cfg, seed=1)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels), "mask": torch.from_numpy(mask)}
    out = []
    for remat in (True, False):
        p = tree_map(lambda x: x.clone().requires_grad_(True), params)
        loss, _ = TT.loss_fn(p, batch, cfg.replace(remat=remat))
        out.append(torch.autograd.grad(loss, tree_leaves(p)))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,knobs", [("qwen1.5-0.5b", {}),
                                        ("qwen1.5-0.5b", {"moe": True, "num_experts": 4,
                                                          "top_k": 2, "moe_d_ff": 128})],
                         ids=["qwen1.5", "qwen1.5_moe"])
def test_save_mixer_gives_the_full_policy_gradient(arch, knobs):
    """``remat_policy="save_mixer"`` (each layer's FFN a checkpoint, its
    mixer kept) runs the same ops as "full" in the same order, and every
    tensor's gradient sums the same terms: the loss and gradient of
    "full", bit for bit, the MoE's aux among them."""
    cfg = get_smoke(arch).replace(**knobs)
    params = TT.init(prng.PRNGKey(0), cfg, device="cpu")
    tokens, labels, mask = _loss_inputs(cfg, seed=2, B=2, S=24)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels), "mask": torch.from_numpy(mask)}
    out = []
    for policy in ("save_mixer", "full"):
        p = tree_map(lambda x: x.clone().requires_grad_(True), params)
        loss, met = TT.loss_fn(p, batch, cfg.replace(remat_policy=policy))
        out.append((loss, met["aux_loss"], torch.autograd.grad(loss, tree_leaves(p))))
    (l1, a1, g1), (l2, a2, g2) = out
    assert torch.equal(l1, l2) and torch.equal(a1, a2)
    assert (float(a1) > 0) == bool(knobs)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


ATTN_BF16_GRAD_TOL = 6e-3


def test_attn_bf16_loss_and_grad_match_reference():
    """``attn_bf16`` on the smoke qwen1.5 (f32 compute): the loss within
    PARITY (absolute: 40 f32 ulp of a loss of ~6.3) of the reference's
    under the knob, where the knob itself moves the reference's loss by
    more than 5x that (1.2e-4; its forward rounds as the
    jnp lowering does: q * scale, k, v and each block's p to bf16, f32
    accumulation); the gradients within ATTN_BF16_GRAD_TOL of each leaf's
    largest magnitude: the backward rounds at other points than the
    reference's autodiff of its blockwise scan (4.6e-3 measured; an f32
    backward gives 8.0e-3), as tests/test_torch_flash_bwd.py's MM_GRAD_TOL
    says of one attention."""
    arch = "qwen1.5-0.5b"
    jcfg = jax_get_smoke(arch).replace(attn_bf16=True)
    tcfg = get_smoke(arch).replace(attn_bf16=True)
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    tokens, labels, mask = _loss_inputs(jcfg)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
          "mask": jnp.asarray(mask)}
    grad = jax.jit(jax.value_and_grad(lambda p, c: JT.loss_fn(p, jb, c)[0]),
                   static_argnums=1)
    jl, jg = grad(jp, jcfg)
    jl32 = JT.loss_fn(jp, jb, jcfg.replace(attn_bf16=False))[0]
    assert abs(float(jl) - float(jl32)) > 5 * PARITY
    tp = tree_map(lambda x: x.requires_grad_(True),
                  params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels),
          "mask": torch.from_numpy(mask)}
    tl, _ = TT.loss_fn(tp, tb, tcfg)
    grads = torch.autograd.grad(tl, tree_leaves(tp))
    assert abs(float(tl) - float(jl)) <= PARITY
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for want, got in zip(jleaves, grads):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert float(np.abs(got.numpy() - want).max()) <= ATTN_BF16_GRAD_TOL * scale


def test_generate_on_trained_params_builds_no_graph():
    params, _ = train.run(arch="qwen1.5-0.5b", rounds=1, clients=2,
                          n_priority=1, per_client=1, seq=16,
                          local_epochs=1, device="cpu", verbose=False)
    model = get_model(get_smoke("qwen1.5-0.5b"))
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    assert all(x.requires_grad for x in leaves)
    toks = serve.generate(model, params, torch.zeros(1, 5, dtype=torch.int32),
                          3, device="cpu")
    assert toks.shape == (1, 8) and not toks.requires_grad
    caches, logits = model.prefill(params, {"tokens": toks})
    assert not logits.requires_grad and logits.grad_fn is None
    assert not caches["periods"]["l0"]["k"].requires_grad


# -------------------------------------------------------------------- CLI
def _flags(parser):
    return sorted(opt for a in parser._actions for opt in a.option_strings)


def test_cli_flag_set_matches_reference():
    """The reference launcher's flags (and its defaults), plus --device,
    --mesh (the pod round, one process a rank) and --dist-backend (its
    process group's backend)."""
    from repro.launch.train import build_parser as jax_parser
    want, got = jax_parser(), train.build_parser()
    assert _flags(got) == sorted(_flags(want) + ["--device", "--mesh",
                                                 "--dist-backend"])
    jd, td = vars(want.parse_args([])), vars(got.parse_args([]))
    assert td.pop("device") == "cuda"
    assert td.pop("mesh") is None
    assert td.pop("dist_backend") is None
    assert jd.keys() == td.keys()
    for k in jd:
        assert jd[k] == td[k] or (jd[k] != jd[k] and td[k] != td[k]), k
    from repro.configs.cli import fed_from_args as jax_fed_from_args
    from repro_torch.configs.cli import fed_from_args
    argv = ["--aggregator", "median", "--wire-codec", "int8", "--rounds", "2"]
    assert fed_from_args(got.parse_args(argv)) == jax_fed_from_args(
        want.parse_args(argv))


def test_train_main_runs_on_the_cpu_when_asked(capsys):
    params, hist = train.main(["--rounds", "1", "--clients", "2", "--seq",
                               "16", "--device", "cpu"])
    assert len(hist) == 1 and np.isfinite(hist[0]["server_loss"])
    assert "round   0" in capsys.readouterr().out


# ------------------------------------------------------------ out of slice
# (knobs, ROADMAP item): the knobs once outside the LM round. The ones
# still refused raise naming their item; the knobs the port has since
# reached (item None: selection, overlapped cohorts, the fault layer)
# build the round and train.run runs it
OUT_OF_SLICE = [
    (dict(max_cohort=2), None), (dict(server_opt="momentum"), None),
    (dict(server_opt="adam"), None), (dict(selection="grad_sim"), None),
    (dict(selection="topk_align"), None), (dict(selection="welfare"), None),
    (dict(async_depth=2, backend="scan_async"), None),
    (dict(failure_model="crash", crash_rate=0.1), None),
    (dict(latency_mode="lognormal"), None),
    (dict(divergence_guard=True), None), (dict(candidate_pool=3), None),
]


@pytest.mark.parametrize("kw,item", OUT_OF_SLICE,
                         ids=[next(iter(kw)) + "=" + str(next(iter(kw.values())))
                              for kw, _ in OUT_OF_SLICE])
def test_out_of_slice_round_knob_raises(kw, item):
    model = get_model(get_smoke("qwen1.5-0.5b"))
    fed = FedConfig(num_clients=4, num_priority=2, **kw)
    if item is None:
        assert callable(sharded.make_round_step(model, fed, 4, fsdp=False,
                                                device="cpu"))
        params, hist = train.run(rounds=1, clients=4, n_priority=2,
                                 per_client=2, seq=32, device="cpu",
                                 verbose=False, **kw)
        assert len(hist) == 1 and np.isfinite(hist[0]["server_loss"])
        assert all(torch.isfinite(p).all() for p in tree_leaves(params))
        return
    with pytest.raises(NotImplementedError, match=item):
        sharded.make_round_step(model, fed, 4, fsdp=False, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        train.run(rounds=1, clients=4, n_priority=2, device="cpu",
                  verbose=False, **kw)


def test_fsdp_round_is_not_ported():
    """Once a refusal (ROADMAP A17), now the temporal round: fsdp=True
    builds it, and since the candidate pools (A13) no listed knob is
    refused: both rounds build under each, and the temporal round runs a
    round under each (the spatial round runs each through train.run in
    test_out_of_slice_round_knob_raises; tests/test_torch_temporal.py
    holds the round)."""
    cfg = get_smoke("qwen1.5-0.5b")
    model = get_model(cfg)
    assert all(item is None for _, item in OUT_OF_SLICE)
    data = make_token_federation(seed=0, vocab=cfg.vocab_size, n_clients=4,
                                 n_priority=2, seq_len=16,
                                 tokens_per_client=17 * 8)
    batch = build_batches(cfg, data, clients=4, per_client=1, seq=16,
                          rng=np.random.default_rng(0), device="cpu")
    params = model.init(prng.PRNGKey(0), device="cpu")
    for kw, _ in OUT_OF_SLICE:
        fed = FedConfig(num_clients=4, num_priority=2, local_epochs=1, **kw)
        assert callable(sharded.make_round_step(model, fed, 4, fsdp=False,
                                                device="cpu"))
        if kw.get("selection") == "grad_sim":
            fed = fed.replace(grad_sim_sketch=True)
        step = sharded.make_round_step(model, fed, 4, fsdp=True,
                                       device="cpu")
        state, stats = step(engine.init_state(params, fed, 4), batch, 0)
        assert stats["gates"].shape == (4,), kw
        assert all(torch.isfinite(p).all()
                   for p in tree_leaves(state.params)), kw


def test_cli_parses_out_of_slice_knobs_and_run_refuses_them():
    """The parser takes every reference flag, and the knob once refused
    now runs: ``--candidate-pool 3`` raises the reference's ValueError (the
    run's 4 priority clients do not fit a pool of 3), a pool of 5 trains
    the 4 priority clients and 1 sampled of the CLI's 8."""
    argv = ["--device", "cpu", "--rounds", "1", "--seq", "32"]
    a = train.build_parser().parse_args(["--candidate-pool", "3"] + argv)
    assert isinstance(a, argparse.Namespace) and a.candidate_pool == 3
    with pytest.raises(ValueError, match="num_priority=4"):
        train.main(["--candidate-pool", "3"] + argv)
    params, hist = train.main(["--candidate-pool", "5"] + argv)
    assert len(hist) == 1 and np.isfinite(hist[0]["server_loss"])
    assert sum(g > 0 for g in hist[0]["gates"][4:]) <= 1
