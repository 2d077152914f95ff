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
* ``uniform``, ``bernoulli``, ``rademacher`` and ``randint`` build on
  ``bits`` exactly as jax 0.9 does (mantissa fill, compare, two-word
  modulus), so their outputs are bit-exact too.
* ``gumbel`` is ``-log(-log(uniform(tiny, 1)))``, ``jax.random.gumbel``'s
  default mode: the uniform is bit-exact, the two logs are the host
  library's and may sit an ulp or so off XLA's.
* ``normal`` is ``sqrt(2) * erf_inv(uniform(-1 + ulp, 1))`` with XLA's f32
  ``erf_inv`` polynomial (M. Giles' approximation, the constants and the
  Horner order of XLA's lowering). It is not bit-exact: ``log1p`` is the
  host library's, not XLA's; the tests state the ulp bound.
* ``truncated_normal`` is ``sqrt(2) * erf_inv(uniform(erf(lo/sqrt2),
  erf(hi/sqrt2)))`` clipped inside the bounds, as jax draws it, with the
  same erf_inv (so the same ulp bound).

The FedALIGN round needs these to match the reference exactly: local SGD
draws its minibatch order from ``permutation``, and the inclusion gates can
only agree if every client saw the same minibatches. The dp aggregator's
noise comes from ``normal``, the sketch codec's and the cosine filter's
hash and sign planes from ``randint`` and ``rademacher``.

A key on the ``meta`` device has no value, so ``split``, ``fold_in`` and
``truncated_normal`` give their results' shapes alone there, with no
hashing: ``init(key, device="meta")`` then yields a model's param shapes in
milliseconds (``models/registry.py: param_shapes``).

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
    if key.device.type == "meta":
        return key.new_empty(key.shape[:-1] + (int(num), 2))
    y0, y1 = _hash_iota(key, (num,))
    return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``data`` (an int, or an integer tensor that
    broadcasts against the key batch) is taken modulo 2^32."""
    if key.device.type == "meta":
        lead = torch.broadcast_shapes(key.shape[:-1], torch.as_tensor(data).shape)
        return key.new_empty(lead + (2,))
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


def uniform(key: torch.Tensor, shape, minval=0.0, maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits fill the mantissa of a float in [1, 2), minus 1, scaled."""
    if isinstance(shape, int):
        shape = (shape,)
    return _uniform_from_bits(bits(key, tuple(shape)), minval, maxval)


def _uniform_from_bits(b: torch.Tensor, minval, maxval) -> torch.Tensor:
    fb = (b >> 9) | 0x3F800000
    floats = fb.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=b.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=b.device)
    # XLA fuses the scale and shift into one multiply-add; the f32 product
    # is exact in f64, so one f64 step rounded to f32 is that fma
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def bernoulli(key: torch.Tensor, p: float = 0.5, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` (bool)."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode "low"): ``-log(-log(u))``
    with ``u`` uniform on [finfo(f32).tiny, 1). Not bit-exact (see the
    module note); the candidate-pool sampler ranks by it, and its callers
    check that no rank sits on a rounding tie."""
    u = uniform(key, shape, torch.finfo(torch.float32).tiny, 1.0)
    return -torch.log(-torch.log(u))


def rademacher(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.rademacher(key, shape, float32)``: +-1 from a fair
    ``bernoulli``."""
    return 2.0 * bernoulli(key, 0.5, shape).float() - 1.0


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)`` for
    ``minval < maxval`` within int32: two 32-bit words per value reduced
    modulo the span (uint32 arithmetic, as jax does it)."""
    if isinstance(shape, int):
        shape = (shape,)
    minval, maxval = int(minval), int(maxval)
    if not -2**31 <= minval < maxval <= 2**31 - 1:
        raise ValueError(f"randint: need int32 bounds minval < maxval, got "
                         f"[{minval}, {maxval})")
    k = split(key, 2)
    higher = bits(k[..., 0, :], tuple(shape))
    lower = bits(k[..., 1, :], tuple(shape))
    span = (maxval - minval) & _MASK
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = (((higher % span) * mult) & _MASK) + (lower % span)
    off = (off & _MASK) % span
    return (off + minval).to(torch.int32)


# XLA's f32 erf_inv (M. Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w = -log1p(-x^2), one set of constants for w < 5
# and one (in sqrt(w)) beyond
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """f32 inverse error function, XLA's polynomial in XLA's order."""
    x = x.float()
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    # XLA evaluates the Horner steps as fused multiply-adds: the f32
    # product is exact in f64, so one f64 step rounded to f32 is the fma
    ww = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    lo = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    hi = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, 9):
        p = (torch.where(lt, lo[i], hi[i]).double() + p.double() * ww).float()
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


_SQRT2_F32 = 1.41421353816986083984375       # float32(sqrt(2))
_NEXT_ABOVE_MINUS_ONE = -0.999999940395355224609375   # nextafter(-1, 0) in f32


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: sqrt(2) erf_inv(u), u
    uniform on [nextafter(-1, 0), 1). Within the ulp bound the tests state
    of jax's draw, not bit-exact (see the module note)."""
    u = uniform(key, shape, _NEXT_ABOVE_MINUS_ONE, 1.0)
    return _SQRT2_F32 * erf_inv(u)


_TRUNC_CHUNK = 1 << 24        # draws per pass: bounds the int64 temporaries


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)``
    for one key ``[2]`` and host-scalar bounds: ``u`` uniform between
    ``erf(lower / sqrt2)`` and ``erf(upper / sqrt2)``, ``sqrt2 * erf_inv(u)``,
    clipped to the open interval (``nextafter`` of each bound inwards).

    The bounds' erf is taken in f64 and rounded to f32 (XLA's f32 erf gives
    the same value at the init's +-2; the tests pin it). The draw runs over
    the flat index in chunks of ``_TRUNC_CHUNK``, so a 300M-entry embedding
    table needs no more than a few hundred MB of scratch; the bits are the
    same as one pass over the whole shape."""
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(int(s) for s in shape)
    if key.shape != (2,):
        raise ValueError(f"truncated_normal takes one key [2], got "
                         f"{tuple(key.shape)}")
    if key.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    f32 = torch.float32
    lo32 = torch.tensor(lower, dtype=f32)
    hi32 = torch.tensor(upper, dtype=f32)
    sqrt2 = torch.tensor(_SQRT2_F32, dtype=f32)
    a = float(torch.tensor(math.erf(float(lo32 / sqrt2)), dtype=f32))
    b = float(torch.tensor(math.erf(float(hi32 / sqrt2)), dtype=f32))
    clip_lo = float(torch.nextafter(lo32, torch.tensor(math.inf)))
    clip_hi = float(torch.nextafter(hi32, torch.tensor(-math.inf)))
    n = math.prod(shape)
    out = torch.empty(n, dtype=f32, device=key.device)
    k0, k1 = key[0], key[1]
    for start in range(0, n, _TRUNC_CHUNK):
        stop = min(n, start + _TRUNC_CHUNK)
        iota = torch.arange(start, stop, dtype=torch.int64, device=key.device)
        y0, y1 = threefry2x32(k0, k1, iota >> 32, iota & _MASK)
        u = _uniform_from_bits(y0 ^ y1, a, b)
        out[start:stop] = torch.clamp(_SQRT2_F32 * erf_inv(u), clip_lo, clip_hi)
    return out.reshape(shape)
