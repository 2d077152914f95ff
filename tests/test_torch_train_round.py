"""The spatial FedALIGN round over the dense LMs: the port's
``launch.train.run`` on the CPU against the JAX package's
``repro.launch.train.run`` loop, 3 rounds at smoke size in f32, on the
three smoke configs of ``chip_smoke.py``'s slice (f1) and under median +
int8 with error feedback. Gates and included counts exactly, losses and
params at tests/test_torch_train.py's tolerances. Kept apart from that
file so each stays well under a minute on one worker."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.configs.base import FedConfig as JaxFedConfig  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from test_torch_train import PARITY, _close  # noqa: E402

GATE_MARGIN = 1e-3
# (arch, model knobs, eps): eps chosen so that over the 3 rounds at least
# one non-priority client is gated in and one out, every decision at least
# 0.05 from eps
TRAIN_CONFIGS = [("qwen1.5-0.5b", {}, 0.15), ("qwen2.5-3b", {}, 0.15),
                 ("qwen1.5-0.5b", {"sliding_window": 16}, 0.2)]
RUN_KW = dict(rounds=3, clients=4, n_priority=2, per_client=2, seq=64,
              local_epochs=2, lr=0.05)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-size tensors: one torch thread for the module (see
    tests/test_torch_train.py), the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run(arch, knobs, eps, **fed_kw):
    """``repro.launch.train.run``'s loop (its batches, round step, init
    and state), keeping each round's stats."""
    from repro.data.tokens import make_token_federation as jax_tokens
    from repro.fl import engine, sharded as jsharded
    from repro.launch.train import build_batches
    kw = RUN_KW
    cfg = jax_get_smoke(arch).replace(**knobs)
    model = jax_get_model(cfg)
    fed = JaxFedConfig(num_clients=kw["clients"], num_priority=kw["n_priority"],
                       local_epochs=kw["local_epochs"], epsilon=eps,
                       lr=kw["lr"], **fed_kw)
    fed_data = jax_tokens(seed=0, vocab=cfg.vocab_size,
                          n_clients=kw["clients"], n_priority=kw["n_priority"],
                          seq_len=kw["seq"], misalign_max=1.0,
                          tokens_per_client=max(8192, kw["per_client"]
                                                * (kw["seq"] + 1) * 4))
    step = jax.jit(jsharded.make_round_step(model, fed, kw["clients"],
                                            fsdp=False))
    state = engine.init_state(model.init(jax.random.PRNGKey(0)), fed,
                              kw["clients"])
    rng = np.random.default_rng(0)
    hist = []
    for r in range(kw["rounds"]):
        batch = build_batches(cfg, fed_data, clients=kw["clients"],
                              per_client=kw["per_client"], seq=kw["seq"],
                              rng=rng)
        state, stats = step(state, batch, jnp.int32(r))
        hist.append({k: np.asarray(stats[k]) for k in
                     ("server_loss", "gates", "local_losses")})
    return state.params, hist


def _port_run(arch, knobs, eps, monkeypatch, **fed_kw):
    if knobs:
        monkeypatch.setattr(train, "get_smoke",
                            lambda a: get_smoke(a).replace(**knobs))
    return train.run(arch=arch, epsilon=eps, device="cpu", verbose=False,
                     **RUN_KW, **fed_kw)


def _assert_round_parity(jp, jh, tp, th, eps, params_extra_atol=0.0):
    assert len(jh) == len(th)
    for j, t in zip(jh, th):
        gaps = np.abs(np.asarray(t["local_losses"]) - t["server_loss"])
        assert np.all(np.abs(gaps - eps) > GATE_MARGIN), (gaps, eps)
        np.testing.assert_array_equal(np.asarray(t["gates"]), j["gates"])
        assert t["included"] == float(j["gates"].sum()) - RUN_KW["n_priority"]
        _close(t["server_loss"], j["server_loss"], floor=1.0)
        _close(t["local_losses"], j["local_losses"], floor=1.0)
    for want, got in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        want = np.asarray(want)
        bound = PARITY * max(1.0, float(np.abs(want).max())) + params_extra_atol
        assert float(np.abs(got.numpy() - want).max()) <= bound


@pytest.mark.parametrize("arch,knobs,eps", TRAIN_CONFIGS,
                         ids=["qwen1.5", "qwen2.5", "qwen1.5_window16"])
def test_train_run_matches_reference(arch, knobs, eps, monkeypatch):
    jp, jh = _jax_run(arch, knobs, eps)
    tp, th = _port_run(arch, knobs, eps, monkeypatch)
    # eps admits some non-priority client in some round and drops one in
    # another: both sides of the gate are exercised
    assert 0 < sum(h["included"] for h in th) < 2 * len(th)
    _assert_round_parity(jp, jh, tp, th, eps)
    assert all(not x.requires_grad for x in tree_leaves(tp))


def test_train_run_median_int8_error_feedback_matches_reference(monkeypatch):
    from repro_torch.core import aggregation as tagg
    scales = []
    encode = tagg._Int8Codec.encode

    def recording_encode(fed, buf):
        q, kw = encode(fed, buf)
        scales.append(float(kw["dequant_scale"].max()))
        return q, kw

    monkeypatch.setattr(tagg._Int8Codec, "encode",
                        staticmethod(recording_encode))
    fed_kw = dict(aggregator="median", wire_codec="int8")
    jp, jh = _jax_run("qwen1.5-0.5b", {}, 0.15, **fed_kw)
    tp, th = _port_run("qwen1.5-0.5b", {}, 0.15, monkeypatch, **fed_kw)
    assert len(scales) == RUN_KW["rounds"]
    _assert_round_parity(jp, jh, tp, th, 0.15, params_extra_atol=max(scales))


