"""Sort-free random permutations via a cycle-walking Feistel network (port
of ``torchrecsys_tpu/utils/permute.py``).

A 6-round Feistel network over the index bits is a bijection of
``[0, 2^bits)``; re-applying it until a value lands in ``[0, n)``
(cycle-walking) restricts it to a permutation of ``[0, n)``: O(n) integer
math on the device, no sort.

The JAX package computes in wrapping uint32. torch has no wrapping uint32
arithmetic, so every value here is an int64 holding 32 bits, reduced to 32
bits after each add, multiply and xor; the multiplies by 32-bit constants
go through 16-bit halves so no product leaves int64. The six round keys
are an input (:func:`round_keys` draws them from a ``torch.Generator``),
so the same keys give the JAX package's permutation bit for bit.
"""

from __future__ import annotations

import torch

ROUNDS = 6
_M32 = 0xFFFFFFFF
_INT32_MAX = 2**31 - 1


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for 0 <= x < 2^32: x = hi * 2^16 + lo, and
    hi * c_hi * 2^32 vanishes mod 2^32."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _round_fn(x: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Keyed integer mix (xorshift-multiply), 32 bits -> 32 bits."""
    h = _mul32((x + key) & _M32, 0x9E3779B9)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _feistel(v: torch.Tensor, keys: torch.Tensor, half_bits: int) -> torch.Tensor:
    mask = (1 << half_bits) - 1
    left, right = v >> half_bits, v & mask
    for r in range(ROUNDS):
        left, right = right, left ^ (_round_fn(right, keys[r]) & mask)
    return (left << half_bits) | right


def round_keys(generator: torch.Generator) -> torch.Tensor:
    """Six round keys in ``[0, 2^31 - 1)`` as int64 on the generator's
    device (the JAX package draws them with ``jax.random.randint``)."""
    return torch.randint(
        0, _INT32_MAX, (ROUNDS,), generator=generator, device=generator.device,
        dtype=torch.int64,
    )


def random_permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """A permutation of ``[0, n)`` as int64 on ``keys``' device.

    ``keys``: (6,) integers in ``[0, 2^32)``. Cycle-walking ends because
    the cipher permutes its finite domain; the expected walk is at most
    ``domain / n <= 4`` passes (one host sync each)."""
    dev = keys.device
    if n <= 1:
        return torch.arange(n, dtype=torch.int64, device=dev)
    bits = max(2, (n - 1).bit_length())
    half_bits = (bits + 1) // 2
    keys = keys.to(torch.int64) & _M32
    v = _feistel(torch.arange(n, dtype=torch.int64, device=dev), keys, half_bits)
    while True:
        out = v >= n
        if not bool(out.any()):
            return v
        v = torch.where(out, _feistel(v, keys, half_bits), v)
