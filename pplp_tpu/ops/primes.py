"""Host-side prime generation and per-modulus precomputations.

Replaces (behaviorally) SEAL's ``CoeffModulus::BFVDefault`` used at
``/root/reference/src/demo.cc:73``: chains of NTT-friendly primes (p = 1 mod
2n) at the HomomorphicEncryption.org 128-bit-security bit budgets, selected by
the same deterministic rule SEAL uses — the largest primes below 2^bit_size
congruent to 1 mod 2n, in descending order within a bit size.

Also provides the ``tpu`` profile (``tpu_default``) of <2^30 primes so residues
fit a single 32-bit lane (see ``pplp_tpu.ops.modmath.m31``).

Everything here is Python-int host code executed once at context build; no
device math.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

__all__ = ["is_prime", "get_primes", "bfv_default", "tpu_default", "Modulus"]

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin, valid for all n < 3.3e24 (covers 64-bit)."""
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@functools.lru_cache(maxsize=None)
def get_primes(bit_size: int, count: int, ntt_size: int) -> tuple[int, ...]:
    """Largest ``count`` primes < 2^bit_size with p = 1 mod 2*ntt_size.

    Mirrors the selection rule of SEAL's ``util::get_primes`` so the resulting
    default chains line up with SEAL-4.1's precomputed tables.
    """
    factor = 2 * ntt_size
    found = []
    # Largest candidate = 1 mod factor strictly below 2^bit_size.
    value = ((1 << bit_size) - 1) // factor * factor + 1
    lower = 1 << (bit_size - 1)
    while len(found) < count and value > lower:
        if is_prime(value):
            found.append(value)
        value -= factor
    if len(found) < count:
        raise ValueError(
            f"cannot find {count} primes of {bit_size} bits = 1 mod {factor}"
        )
    return tuple(found)


# HE-standard (128-bit classical security) total coeff-modulus bit budgets,
# split into per-prime bit sizes the way SEAL-4.1's BFVDefault tables do.
_BFV_DEFAULT_BITS = {
    1024: [27],
    2048: [54],
    4096: [36, 36, 37],
    8192: [43, 43, 44, 44, 44],
    16384: [48, 48, 48, 49, 49, 49, 49, 49, 49],
    32768: [55] * 15 + [56],
}

# ``tpu`` profile chains: every prime < 2^30 so a residue is one u32 lane. Totals stay
# within the same security budgets as above.
_TPU_DEFAULT_BITS = {
    1024: [27],
    2048: [27, 27],  # 54
    4096: [28, 27, 27, 27],  # 109
    8192: [28, 28, 27, 27, 27, 27, 27, 27],  # 218
    16384: [28] * 6 + [27] * 10,  # 438
    32768: [29] * 11 + [28] * 20,  # 879 <= 881
}


def _chain(bits_table, poly_modulus_degree: int) -> list[int]:
    bits = bits_table[poly_modulus_degree]
    out = []
    for b in sorted(set(bits)):
        n_b = bits.count(b)
        out.extend(get_primes(b, n_b, poly_modulus_degree))
    # Preserve the bit-size order of the table (ascending), largest prime
    # first within each bit size — matching SEAL's table layout.
    return out


def bfv_default(poly_modulus_degree: int) -> list[int]:
    """SEAL-4.1-style default coefficient modulus chain (128-bit security)."""
    return _chain(_BFV_DEFAULT_BITS, poly_modulus_degree)


def tpu_default(poly_modulus_degree: int) -> list[int]:
    """``tpu`` profile chain: <2^30 primes, same security budget, more limbs."""
    return _chain(_TPU_DEFAULT_BITS, poly_modulus_degree)


def _primitive_root(q: int) -> int:
    """Smallest generator of (Z/q)^* for prime q."""
    fac = []
    m = q - 1
    d = 2
    while d * d <= m:
        if m % d == 0:
            fac.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        fac.append(m)
    g = 2
    while True:
        if all(pow(g, (q - 1) // p, q) != 1 for p in fac):
            return g
        g += 1


@dataclass(frozen=True)
class Modulus:
    """A single RNS prime with all host-side precomputations.

    const_ratio is floor(2^128 / q) (SEAL's Barrett triple, here kept as a
    Python int and sliced into u32 limbs by the device-table builders).
    """

    value: int
    bit_count: int = field(init=False)
    const_ratio: int = field(init=False)
    mu64: int = field(init=False)  # floor(2^64 / q), for the m31 profile

    def __post_init__(self):
        object.__setattr__(self, "bit_count", self.value.bit_length())
        object.__setattr__(self, "const_ratio", (1 << 128) // self.value)
        object.__setattr__(self, "mu64", (1 << 64) // self.value)

    @functools.cached_property
    def generator(self) -> int:
        return _primitive_root(self.value)

    def minimal_primitive_root(self, order: int) -> int:
        """Smallest primitive ``order``-th root of unity mod q (order | q-1)."""
        assert (self.value - 1) % order == 0
        root = pow(self.generator, (self.value - 1) // order, self.value)
        # Walk the group of primitive roots (odd powers) to find the smallest:
        # they are root^k for k coprime to order; for power-of-two order, odd k.
        best = root
        current = root
        gen_sq = pow(root, 2, self.value)
        for _ in range(order // 2 - 1):
            current = current * gen_sq % self.value
            if current < best:
                best = current
        return best

    def shoup(self, w: int, word_bits: int) -> int:
        """floor(w * 2^word_bits / q) for Shoup multiplication."""
        return (w << word_bits) // self.value
