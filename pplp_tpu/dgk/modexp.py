"""Batched multi-precision modular exponentiation on u32 device lanes.

The DGK back-end's hot path is 2048-bit modexps (encrypt: g^m * h^r mod n;
homomorphic eval: powers; decrypt: c^vpq) which the reference executes one at
a time through GMP. Here a batch of B exponentiations runs as ONE jitted
program: numbers are [B, D] arrays of 16-bit digits in u32 lanes, a Montgomery
CIOS multiply is a `lax.scan` over digit steps (carry-save columns, exact —
per-column sums stay < 2^32), and exponentiation scans over exponent bits
with per-lane bit selects.

North star: 10k parallel encrypted comparisons (BASELINE.md config[2]).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["MontgomeryCtx", "to_digits", "from_digits"]

DIGIT_BITS = 16
MASK = (1 << DIGIT_BITS) - 1


def to_digits(values, D: int) -> np.ndarray:
    """Python ints / array -> [B, D] u32 of 16-bit digits (little-endian)."""
    vals = np.atleast_1d(np.asarray(values, dtype=object))
    out = np.zeros((len(vals), D), np.uint32)
    for b, v in enumerate(vals):
        v = int(v)
        for i in range(D):
            if not v:
                break
            out[b, i] = v & MASK
            v >>= DIGIT_BITS
    return out


def from_digits(digs) -> list[int]:
    digs = np.asarray(digs, np.uint64)
    out = []
    for row in digs:
        v = 0
        for i in range(len(row) - 1, -1, -1):
            v = (v << DIGIT_BITS) | int(row[i])
        out.append(v)
    return out


@dataclass(frozen=True, eq=False)
class MontgomeryCtx:
    """Montgomery arithmetic mod an odd n, digit base 2^16, R = 2^(16 D)."""

    n_int: int
    D: int
    n: jnp.ndarray        # [D] u32 digits
    n_prime: jnp.ndarray  # u32: -n^{-1} mod 2^16
    r2: jnp.ndarray       # [D]: R^2 mod n (to_mont multiplier)
    one_mont: jnp.ndarray  # [D]: R mod n

    @staticmethod
    def build(n: int) -> "MontgomeryCtx":
        assert n % 2 == 1
        D = (n.bit_length() + DIGIT_BITS - 1) // DIGIT_BITS + 1
        R = 1 << (DIGIT_BITS * D)
        return MontgomeryCtx(
            n_int=n,
            D=D,
            n=jnp.asarray(to_digits([n], D)[0]),
            n_prime=jnp.uint32((-pow(n, -1, 1 << DIGIT_BITS)) % (1 << DIGIT_BITS)),
            r2=jnp.asarray(to_digits([R * R % n], D)[0]),
            one_mont=jnp.asarray(to_digits([R % n], D)[0]),
        )

    # ------------------------------------------------------------------

    def _normalize(self, t):
        """Propagate carries of a carry-save [B, D+1] array -> [B, D+1]."""
        def step(carry, col):
            full = col + carry
            return full >> DIGIT_BITS, full & MASK
        carry, cols = jax.lax.scan(step, jnp.zeros_like(t[..., 0]),
                                   jnp.moveaxis(t, -1, 0))
        return jnp.moveaxis(cols, 0, -1)

    def _cond_sub_n(self, a):
        """a in [0, 2n) normalized -> a mod n."""
        n = self.n.astype(jnp.uint32)
        def step(borrow, pair):
            av, nv = pair
            d = av - nv - borrow
            neg = (d >> 31) & 1  # borrow flag via sign bit of 17-bit-safe sub
            return neg, (d + (neg << DIGIT_BITS)) & MASK
        borrow, diffs = jax.lax.scan(
            step, jnp.zeros_like(a[..., 0]),
            (jnp.moveaxis(a, -1, 0), jnp.broadcast_to(n[:, None], (a.shape[-1],) + a.shape[:-1])
             if a.ndim > 1 else n),
        )
        diffs = jnp.moveaxis(diffs, 0, -1)
        use_diff = borrow == 0  # no final borrow => a >= n
        return jnp.where(use_diff[..., None], diffs, a)

    # Digits of `a` consumed per scan step (the W fused steps unroll in the
    # scan body and fuse into few sweeps).
    BLOCK_W = 8

    def mont_mul(self, a, b):
        """Montgomery product REDC(a*b): [B, D] x [B or 1, D] -> [B, D].

        Round-5 formulation (scripts/r5_dgk_cios_ab.py): each CIOS digit
        step builds the shifted accumulator as ONE expression of aligned
        concats + adds — no scatter (.at[]) updates, which XLA materializes
        individually (~8 sweeps/step). Measured 7.2x faster than the
        round-4 scatter form (1.46 vs 10.55 ms per [10000, 129] product).

        Inputs normalized (< n); output normalized in [0, n). Carry-save
        columns stay exact: each digit step adds < 2^18 per column plus the
        dropped column's carry, so columns stay < 4*D*2^16 < 2^32 for
        D <= 2^13.
        """
        D = self.D
        n = self.n
        npr = self.n_prime
        W = self.BLOCK_W
        B_shape = jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        b_b = jnp.broadcast_to(b, B_shape + (D,))
        zero1 = jnp.zeros(B_shape + (1,), jnp.uint32)
        zeroD = jnp.zeros(B_shape + (D,), jnp.uint32)

        def step(t, a_i):
            """t' (post-shift) [j] = t[j+1] + lo[j+1] + hi[j] + carry*(j==0)
            where lo/hi are the 16-bit halves of a_i*b + m*n and m is the
            REDC multiplier from column 0's full value."""
            p = a_i.reshape(B_shape + (1,)) * b_b  # 16x16 -> 32 bits exact
            m = ((t[..., 0] + (p[..., 0] & MASK)) * npr) & MASK
            q = m[..., None] * n
            lo = (p & MASK) + (q & MASK)
            hi = (p >> DIGIT_BITS) + (q >> DIGIT_BITS)
            carry = (t[..., 0] + lo[..., 0]) >> DIGIT_BITS
            shifted_t = jnp.concatenate([t[..., 1:], zero1], -1)
            lo_sh = jnp.concatenate([lo[..., 1:], zero1, zero1], -1)
            hi_al = jnp.concatenate([hi, zero1], -1)
            c0 = jnp.concatenate([carry[..., None], zeroD], -1)
            return shifted_t + lo_sh + hi_al + c0

        def block(t, a_blk):  # a_blk: [W, *B_shape]
            for w in range(W):
                t = step(t, a_blk[w])
            return t, None

        a_cols = jnp.moveaxis(jnp.broadcast_to(a, B_shape + (D,)), -1, 0)
        nb, tail = D // W, D % W
        t = jnp.zeros(B_shape + (D + 1,), jnp.uint32)
        if nb:
            main = a_cols[: nb * W].reshape((nb, W) + B_shape)
            t, _ = jax.lax.scan(block, t, main)
        for i in range(tail):
            t = step(t, a_cols[nb * W + i])
        t = self._normalize(t)
        # t < 2n < 2^(16D), so the top normalized digit is 0; drop it.
        return self._cond_sub_n(t[..., :D])

    def to_mont(self, a):
        return self.mont_mul(a, self.r2.reshape((1,) * (a.ndim - 1) + (-1,)))

    def from_mont(self, a):
        one = jnp.zeros_like(a).at[..., 0].set(1)
        return self.mont_mul(a, one)

    # ------------------------------------------------------------------

    def powmod(self, base, exp_bits):
        """base^exp mod n, batched.

        base: [B or 1, D] digits (standard domain), exp_bits: [B, E] u32 of
        0/1 (little-endian bit order). Returns [B, D] standard domain.
        """
        B = exp_bits.shape[0]
        base_m = self.to_mont(base)  # stays [1, D] for a shared base
        acc = jnp.broadcast_to(self.one_mont, (B, self.D))

        def step(state, bits):
            acc, base_m = state
            mult = self.mont_mul(acc, base_m)
            acc = jnp.where((bits != 0)[:, None], mult, acc)
            base_m = self.mont_mul(base_m, base_m)
            return (acc, base_m), None

        (acc, _), _ = jax.lax.scan(step, (acc, base_m), jnp.moveaxis(exp_bits, -1, 0))
        return self.from_mont(acc)

    # Exponents at most this wide unroll at trace time; wider ones use a
    # lax.scan (a ~320-bit decrypt exponent unrolled is ~480 scans in one
    # graph — XLA:CPU segfaults compiling it).
    UNROLL_BITS = 64

    def powmod_shared_exp_mont(self, base_m, exp: int):
        """base^exp for Montgomery-domain base and a shared STATIC Python-int
        exponent; result stays in the Montgomery domain.

        Small exponents unroll left-to-right square-and-multiply at trace
        time: the bits are compile-time constants, so zero bits emit no
        multiply at all — ~25% fewer Montgomery products than the scan
        form's square+multiply+select every step (round-4 DGK throughput
        work). Large exponents keep the scan form."""
        assert exp >= 0
        if exp == 0:
            return jnp.broadcast_to(self.one_mont, base_m.shape)
        bits = [(exp >> i) & 1 for i in range(exp.bit_length())][::-1]
        if len(bits) <= self.UNROLL_BITS:
            acc = base_m  # top bit is 1
            for bit in bits[1:]:
                acc = self.mont_mul(acc, acc)
                if bit:
                    acc = self.mont_mul(acc, base_m)
            return acc
        acc = jnp.broadcast_to(self.one_mont, base_m.shape)
        bit_arr = jnp.asarray(np.asarray(bits, np.uint32))

        def step(acc, bit):
            acc = self.mont_mul(acc, acc)
            with_mul = self.mont_mul(acc, base_m)
            return jnp.where(bit != 0, with_mul, acc), None

        acc, _ = jax.lax.scan(step, acc, bit_arr)
        return acc

    def powmod_shared_exp(self, base, exp: int):
        """base^exp mod n for per-lane bases and one shared Python-int
        exponent (standard domain in and out)."""
        return self.from_mont(self.powmod_shared_exp_mont(self.to_mont(base), exp))

    def mulmod(self, a, b):
        """a * b mod n for digit arrays (standard domain)."""
        return self.mont_mul(self.to_mont(a), b)


def exp_to_bits(exps, E: int) -> np.ndarray:
    """Python ints -> [B, E] u32 bit array (little-endian)."""
    exps = np.atleast_1d(np.asarray(exps, dtype=object))
    out = np.zeros((len(exps), E), np.uint32)
    for b, v in enumerate(exps):
        v = int(v)
        for i in range(E):
            if not v:
                break
            out[b, i] = v & 1
            v >>= 1
    return out
