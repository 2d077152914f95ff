"""The paper's own experiment models (App. B.1), as ``nn.Module``s:

  * logreg  — 784x10 logistic regression               (FMNIST)
  * mlp2    — 784-200-200-47 two-layer network         (balanced EMNIST)
  * cnn     — 2xconv5x5 (32,64ch) + FC(4096x128) + 128x10, ReLU, Kaiming
              init                                      (CIFAR-10)
  * synth_logreg — 60x10 logistic regression            (SYNTH(a,b))

Counterpart of ``repro/models/small.py``. Parameter names equal the
reference's dict keys and keep its layouts (dense weights ``[in, out]``,
conv weights HWIO, images NHWC), so a parameter dict converted from the
reference drops straight in. The federation code is functional: it holds
parameters as plain dicts and calls a model through
``torch.func.functional_call`` on a template module that lives on the meta
device. Init draws from an explicit ``torch.Generator`` (Kaiming normal);
it is not bit-equal to JAX's init — ``convert.params_from_jax`` carries
weights across where both packages must start from the same point.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call


def _kaiming(gen: torch.Generator, shape) -> torch.Tensor:
    fan_in = math.prod(shape[:-1])
    return torch.randn(shape, generator=gen) * (2.0 / fan_in) ** 0.5


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class LogReg(nn.Module):
    def __init__(self, in_dim=784, num_classes=10):
        super().__init__()
        self.w = _param(torch.zeros(in_dim, num_classes))
        self.b = _param(torch.zeros(num_classes))

    def forward(self, x):
        return x @ self.w + self.b


class MLP2(nn.Module):
    def __init__(self, in_dim=784, hidden=200, num_classes=47, gen=None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator()
        self.w1 = _param(_kaiming(gen, (in_dim, hidden)))
        self.b1 = _param(torch.zeros(hidden))
        self.w2 = _param(_kaiming(gen, (hidden, hidden)))
        self.b2 = _param(torch.zeros(hidden))
        self.w3 = _param(_kaiming(gen, (hidden, num_classes)))
        self.b3 = _param(torch.zeros(num_classes))

    def forward(self, x):
        h = F.relu(x @ self.w1 + self.b1)
        h = F.relu(h @ self.w2 + self.b2)
        return h @ self.w3 + self.b3


class CNN(nn.Module):
    def __init__(self, num_classes=10, gen=None):
        super().__init__()
        gen = gen if gen is not None else torch.Generator()
        self.c1 = _param(_kaiming(gen, (5, 5, 3, 32)))
        self.cb1 = _param(torch.zeros(32))
        self.c2 = _param(_kaiming(gen, (5, 5, 32, 64)))
        self.cb2 = _param(torch.zeros(64))
        self.f1 = _param(_kaiming(gen, (64 * 8 * 8, 128)))
        self.fb1 = _param(torch.zeros(128))
        self.f2 = _param(_kaiming(gen, (128, num_classes)))
        self.fb2 = _param(torch.zeros(num_classes))

    def forward(self, x):
        """x: [B, 32, 32, 3] (NHWC, the reference layout)."""
        # NCHW / OIHW inside; "SAME" for a 5x5 stride-1 conv is padding 2
        y = x.permute(0, 3, 1, 2)
        y = F.conv2d(y, self.c1.permute(3, 2, 0, 1), self.cb1, padding=2)
        y = F.max_pool2d(F.relu(y), 2)
        y = F.conv2d(y, self.c2.permute(3, 2, 0, 1), self.cb2, padding=2)
        y = F.max_pool2d(F.relu(y), 2)
        # the reference flattens [B, 8, 8, 64] in (h, w, c) order: go back
        # to NHWC first, or f1 sees its inputs in another order
        y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)
        y = F.relu(y @ self.f1 + self.fb1)
        return y @ self.f2 + self.fb2


_BUILDERS = {
    "logreg": lambda gen: LogReg(784, 10),
    "mlp2": lambda gen: MLP2(784, 200, 47, gen=gen),
    "cnn": lambda gen: CNN(10, gen=gen),
    "synth_logreg": lambda gen: LogReg(60, 10),
}


def _make(name):
    with torch.device("meta"):
        template = _BUILDERS[name](None)

    def init_fn(seed_or_gen, device="cuda"):
        """Fresh parameter dict on ``device`` from a seed or a generator."""
        from repro_torch.utils import resolve_device
        dev = resolve_device(device)
        gen = (seed_or_gen if isinstance(seed_or_gen, torch.Generator)
               else torch.Generator().manual_seed(int(seed_or_gen)))
        with torch.device("cpu"):
            module = _BUILDERS[name](gen)
        return {k: v.detach().to(dev) for k, v in module.named_parameters()}

    def apply_fn(params, x):
        return functional_call(template, params, (x,))

    return init_fn, apply_fn


# name -> (init_fn(seed_or_generator, device), apply_fn(params, x))
SMALL_MODELS = {name: _make(name) for name in _BUILDERS}


def make_loss_fn(apply_fn):
    """Mean softmax cross-entropy + accuracy. batch: {'x','y'}.

    Means are a sum divided by the count, as ``jnp.mean`` computes them, so
    the accuracy of n examples is exactly (correct / n) in both packages."""
    def loss_fn(params, batch):
        logits = apply_fn(params, batch["x"])
        y = batch["y"].long()
        n = y.shape[0]
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y[:, None])[:, 0]
        loss = torch.sum(logz - gold) / n
        acc = torch.sum((torch.argmax(logits, -1) == y).float()) / n
        return loss, {"acc": acc}
    return loss_fn
