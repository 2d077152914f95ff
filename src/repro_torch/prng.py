"""Threefry-2x32 counter-based PRNG, bit-exact with ``jax.random``.

It reproduces the installed jax (0.9) with ``jax_threefry_partitionable``
on: a key is a pair of uint32 words, and every derived stream hashes a
64-bit iota with the key.

* ``split(key, n)[i]``      = threefry(key, (hi(i), lo(i)))
* ``fold_in(key, d)``       = threefry(key, (0, d))
* ``bits(key, shape)[i]``   = y0 ^ y1 of threefry(key, (hi(i), lo(i)))
* ``permutation(key, n)``   = argsort of ``bits`` by a stable sort, repeated
  ``ceil(3 ln n / ln(2^32 - 1))`` times with fresh sub-keys, as
  ``jax.random.permutation`` does.

The FedALIGN round needs these to match the reference exactly: local SGD
draws its minibatch order from ``permutation``, and the inclusion gates can
only agree if every client saw the same minibatches.

Representation: uint32 words are held in ``torch.int64`` tensors masked to
32 bits (torch has no full uint32 arithmetic). A key is a ``[..., 2]``
tensor; every function accepts a batch of keys in the leading dims, so the
``[C, E]`` minibatch permutations of a round come out of one call on the
device that holds the keys. This is plain integer tensor code, not a kernel.
"""
from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """The key ``jax.random.PRNGKey(seed)`` builds from a 32-bit seed:
    ``[0, seed mod 2^32]``."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise OverflowError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 block function on broadcastable int64
    tensors of uint32 words; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _hash_iota(key: torch.Tensor, shape: tuple):
    """threefry(key, iota64(shape)) for a batch of keys ``[..., 2]``:
    returns two int64 tensors of shape ``key.shape[:-1] + shape``."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    iota = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    expand = lead + (1,) * len(shape)
    k0 = key[..., 0].reshape(expand)
    k1 = key[..., 1].reshape(expand)
    return threefry2x32(k0, k1, iota >> 32, iota & _MASK)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` -> ``[..., num, 2]``."""
    y0, y1 = _hash_iota(key, (num,))
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``data`` (an int, or an integer tensor that
    broadcasts against the key batch) is taken modulo 2^32."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values in
    [0, 2^32), shape ``key.shape[:-1] + shape``."""
    if isinstance(shape, int):
        shape = (shape,)
    y0, y1 = _hash_iota(key, tuple(shape))
    return y0 ^ y1


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``[..., 2]`` -> ``[..., n]``
    int64 permutations of ``range(n)``, one per key."""
    n = int(n)
    x = torch.arange(n, device=key.device).expand(key.shape[:-1] + (n,))
    num_rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_MASK))
    for _ in range(num_rounds):
        sub = split(key, 2)
        key, subkey = sub[..., 0, :], sub[..., 1, :]
        order = torch.sort(bits(subkey, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x.contiguous()
