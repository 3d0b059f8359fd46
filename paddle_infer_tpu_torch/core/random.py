"""Threefry-2x32 counter-based keys, bit for bit ``jax.random``.

The serving plane derives each request's sampling stream as
``fold_in(PRNGKey(seed), rid)`` and each step's key as
``fold_in(base, step)`` (``serving/programs.py``), so a port that wants
the reference's sampled token streams needs the reference's bits, not
merely a good generator; so does training, whose dropout masks hash a
seed drawn from each step's keys.  This module re-implements the pieces
those paths use — ``PRNGKey``, ``fold_in``, ``split``, scalar ``bits``,
``uniform``, ``categorical`` and the ``KeyStream`` that stands in for
the JAX package's global key — on torch tensors, following jax's
``_src/prng.py`` and ``_src/random.py`` with
``jax_threefry_partitionable`` on (the default, so ``random_bits``
hashes the flat element index split into (hi, lo) uint32 counters and
returns ``bits1 ^ bits2``).

torch has no full uint32 arithmetic, so words live in int64 tensors and
every add and shift is masked back to 32 bits.  A key is an int64
tensor ``[..., 2]`` holding two uint32 words; numpy uint32 keys are
accepted too.  Everything a compiled step draws (``fold_in`` by a
counter, ``bits``, ``uniform``, ``categorical``) runs as tensor ops on
the key's device and reads nothing back to the host, so a CUDA graph
can hold it; only the host-side ``KeyStream`` state (``split``) uses
Python integers.
"""
from __future__ import annotations

import contextlib

import torch

_M = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)
# float32 smallest normal: jax.random.gumbel draws uniform(minval=tiny)
_TINY = 1.1754943508222875e-38


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) over broadcastable int64
    tensors holding uint32 values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M
    x1 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in (_ROT0 if i % 2 == 0 else _ROT1):
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0, x1


def _as_key(key, device=None) -> torch.Tensor:
    if not isinstance(key, torch.Tensor):
        key = torch.as_tensor(key.astype("int64") if hasattr(key, "astype")
                              else key, dtype=torch.int64)
    key = key.to(torch.int64)
    return key if device is None else key.to(device)


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the seed is an
    int32, so the key is ``[0, seed mod 2**32]``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the int32 range jax "
                         "accepts with 64-bit mode off")
    return torch.tensor([0, seed & _M], dtype=torch.int64, device=device)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``key [..., 2]`` and ``data`` (int or
    integer tensor broadcastable to ``key[..., 0]``) fold elementwise,
    which is also what ``jax.vmap(jax.random.fold_in)`` computes.  An
    int folds in as a scalar operand (no host tensor is made)."""
    key = _as_key(key)
    if isinstance(data, int):
        data = data & _M
    else:
        data = torch.as_tensor(data, device=key.device).to(torch.int64) & _M
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits`` of ``shape`` for a key ``[..., 2]``:
    leading key dims batch independent draws, as under ``vmap``."""
    key = _as_key(key)
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    pad = (1,) * len(shape)
    k1 = key[..., 0].reshape(key.shape[:-1] + pad)
    k2 = key[..., 1].reshape(key.shape[:-1] + pad)
    b1, b2 = threefry2x32(k1, k2, (idx >> 32).reshape(shape),
                          (idx & _M).reshape(shape))
    return b1 ^ b2


def _key_words(key):
    """One key as two Python ints (the scalar fast path: threefry over
    ints costs microseconds, over 1-element tensors a millisecond)."""
    k = _as_key(key)
    if tuple(k.shape) != (2,):
        raise ValueError(f"expected one key [2], got {tuple(k.shape)}")
    w0, w1 = k.tolist()
    return w0 & _M, w1 & _M


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` in partitionable mode: key ``i``
    is ``threefry(key, (0, i))`` → ``[num, 2]``, on the host with
    Python integers (``split_on_device`` is the same as tensor ops)."""
    k1, k2 = _key_words(key)
    return torch.tensor([threefry2x32(k1, k2, 0, i) for i in range(num)],
                        dtype=torch.int64)


def split_on_device(key, num: int = 2) -> torch.Tensor:
    """``split`` as tensor ops on the key's device, reading nothing back
    (a CUDA graph can hold it): ``threefry(key, (0, i))`` is
    ``fold_in(key, i)``."""
    key = _as_key(key)
    return fold_in(key, torch.arange(num, device=key.device))


def bits(key) -> torch.Tensor:
    """Scalar 32-bit ``jax.random.bits(key, dtype=uint32)``: ``b1 ^ b2``
    of ``threefry(key, (0, 0))``, as an int64 tensor on the key's device
    (0-d for one key ``[2]``; keys ``[..., 2]`` draw elementwise, as
    under ``vmap``)."""
    k = _as_key(key)
    if k.dim() == 0 or k.shape[-1] != 2:
        raise ValueError(f"expected keys [..., 2], got {tuple(k.shape)}")
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], 0, 0)
    return b1 ^ b2


def seed_from_key(key) -> torch.Tensor:
    """The uint32 dropout seed drawn from a key (``_seed_from_key``): a
    0-d int64 tensor on the key's device, which the flash kernels read
    from device memory."""
    return bits(key)


# counters derived per vector pass inside a trace_key_scope (an ERNIE
# forward at 12 layers draws 49)
_SCOPE_BLOCK = 64


class _Scope:
    """The draws of one ``trace_key_scope(base)``: draw ``i`` is
    ``fold_in(base, i)``.  Keys and their seeds are derived
    ``_SCOPE_BLOCK`` counters at a time, in one vector pass each, so a
    step's dropouts cost a few launches on the device instead of two
    threefry chains apiece."""

    def __init__(self, base):
        self.base = base
        self.counter = 0
        self.keys = self.seeds = None

    def draw(self):
        """Row ``counter`` of the key and seed blocks, then advance."""
        i = self.counter
        self.counter += 1
        j = i % _SCOPE_BLOCK
        if j == 0:
            ctr = torch.arange(i, i + _SCOPE_BLOCK, dtype=torch.int64,
                               device=self.base.device)
            self.keys = fold_in(self.base, ctr)
            self.seeds = bits(self.keys)
        return self.keys[j], self.seeds[j]


class KeyStream:
    """An explicit stream of keys: the port of the JAX package's global
    RNG state (``core/random.py`` there), passed to whoever draws.

    ``seed(n)`` sets the key to ``jax.random.key(n)``.  ``next_key()``
    splits the key (``key, sub = split(key)``, returning ``sub``, on the
    host) or, inside ``trace_key_scope(base)``, returns ``fold_in(base,
    counter)`` with a counter from 0 on ``base``'s device — what a
    compiled train step draws for each dropout of its forward.
    ``next_seed()`` is ``seed_from_key(next_key())``, read from the
    scope's precomputed block inside a scope."""

    def __init__(self, seed: int = 0):
        self.seed(seed)

    def seed(self, n: int):
        self.key = PRNGKey(n)
        self._scopes = []
        return n

    def next_key(self) -> torch.Tensor:
        if self._scopes:
            return self._scopes[-1].draw()[0]
        self.key, sub = split(self.key)
        return sub

    def next_seed(self) -> torch.Tensor:
        if self._scopes:
            return self._scopes[-1].draw()[1]
        return seed_from_key(self.next_key())

    @contextlib.contextmanager
    def trace_key_scope(self, key):
        """Derive ``next_key`` from ``key`` (by ``fold_in``) while open."""
        self._scopes.append(_Scope(_as_key(key)))
        try:
            yield
        finally:
            self._scopes.pop()


def uniform(key, shape=(), minval=0.0, maxval=1.0) -> torch.Tensor:
    """float32 ``jax.random.uniform``: 23 random mantissa bits under
    exponent 0, minus one, scaled into ``[minval, maxval)``."""
    bits = random_bits(key, tuple(shape))
    fbits = (bits >> 9) | 0x3F800000
    floats = (fbits.to(torch.int32).view(torch.float32) - 1.0)
    lo = torch.full((), minval, dtype=torch.float32, device=floats.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (Gumbel-max with
    the default low-range gumbel: ``-log(-log(uniform(tiny, 1)))``).
    ``key [..., 2]`` batches over as many leading dims of ``logits`` as
    it has, like ``jax.vmap(lambda k, row: categorical(k, row))``; the
    rest are drawn from each key, so one key ``[2]`` over ``[b, V]``
    logits is ``jax.random.categorical(key, logits)``."""
    logits = logits.to(torch.float32)
    key = _as_key(key, logits.device)
    u = uniform(key, tuple(logits.shape[key.dim() - 1:]),
                minval=_TINY, maxval=1.0)
    g = -torch.log(-torch.log(u))
    return torch.argmax(g + logits, dim=-1)
