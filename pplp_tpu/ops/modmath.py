"""Modular arithmetic over 32-bit integer lanes.

Every 64-bit (and wider) quantity is represented as little-endian u32 limbs
and all products are built from 16-bit digit partial products (comba
multiplication). This u32-lane design was inherited from the package's first
accelerator target, which had no 64-bit integer multiplier, and is kept for
now. This module is pure ``jax.numpy`` — shape-polymorphic, jittable,
vmappable.

Two "profiles" are provided:

* ``m31`` — moduli q < 2^30. A residue is a single uint32 array. This is the
  fast profile: Shoup multiplication is 2 u32 multiplies + 1 mulhi.
* ``m62`` — moduli q < 2^62 (covers SEAL-4.1-style default chains whose primes
  are 27..61 bits). A residue is a ``(lo, hi)`` pair of uint32 arrays.

Replaces (not a translation) the role played in the reference by
SEAL's ``seal::util`` 64/128-bit modular arithmetic, which backs every
Evaluator call in ``/root/reference/src/demo.cc:154-160``.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "mul32",
    "mulhi32",
    "comba_mul",
    "limbs_add",
    "limbs_sub",
    "m31",
    "m62",
]

_U16 = 0xFFFF


def _u32(x):
    return jnp.asarray(x, dtype=jnp.uint32)


def mul32(a, b):
    """Full 32x32 -> 64-bit product as an (lo, hi) pair of uint32 arrays."""
    a = _u32(a)
    b = _u32(b)
    a0 = a & _U16
    a1 = a >> 16
    b0 = b & _U16
    b1 = b >> 16
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    # mid = lh + hl may overflow 32 bits; recover the carry from wraparound.
    mid = lh + hl
    mid_c = (mid < lh).astype(jnp.uint32)
    lo = ll + (mid << 16)
    lo_c = (lo < ll).astype(jnp.uint32)
    hi = hh + (mid >> 16) + (mid_c << 16) + lo_c
    return lo, hi


def mulhi32(a, b):
    """High 32 bits of the 32x32 product."""
    return mul32(a, b)[1]


def comba_mul(a_limbs, b_limbs, out_limbs=None):
    """Exact multi-precision product of little-endian u32 limb vectors.

    Operands are decomposed into 16-bit digits; each digit product (< 2^32) is
    split into its two 16-bit halves which are accumulated into per-column u32
    sums (bounded well below 2^32 for practical limb counts), then carries are
    propagated once. Returns ``len(a)+len(b)`` u32 limbs unless ``out_limbs``
    truncates.
    """
    a_digits = []
    for limb in a_limbs:
        limb = _u32(limb)
        a_digits += [limb & _U16, limb >> 16]
    b_digits = []
    for limb in b_limbs:
        limb = _u32(limb)
        b_digits += [limb & _U16, limb >> 16]

    na, nb = len(a_digits), len(b_digits)
    ncols = na + nb
    # cols[k] accumulates sum of 16-bit halves destined for digit k.
    cols = [None] * (ncols + 1)

    def acc(k, v):
        cols[k] = v if cols[k] is None else cols[k] + v

    for i in range(na):
        for j in range(nb):
            p_lo, p_hi = None, None
            p = a_digits[i] * b_digits[j]  # < 2^32, exact in u32
            p_lo = p & _U16
            p_hi = p >> 16
            acc(i + j, p_lo)
            acc(i + j + 1, p_hi)

    n_out = out_limbs * 2 if out_limbs is not None else ncols
    digits = []
    carry = None
    for k in range(min(n_out, ncols)):
        v = cols[k] if cols[k] is not None else jnp.zeros_like(a_digits[0])
        if carry is not None:
            v = v + carry
        digits.append(v & _U16)
        carry = v >> 16
    while len(digits) < n_out:
        v = carry if carry is not None else jnp.zeros_like(a_digits[0])
        digits.append(v & _U16)
        carry = v >> 16 if carry is not None else None

    out = []
    for k in range(0, n_out, 2):
        out.append(digits[k] | (digits[k + 1] << 16))
    return out


def limbs_add(a_limbs, b_limbs):
    """Multi-precision add of equal-length u32 limb vectors (carry dropped)."""
    out = []
    carry = None
    for a, b in zip(a_limbs, b_limbs):
        a = _u32(a)
        s = a + _u32(b)
        c_new = (s < a).astype(jnp.uint32)
        if carry is not None:
            s2 = s + carry
            c_new = c_new + (s2 < s).astype(jnp.uint32)
            s = s2
        out.append(s)
        carry = c_new
    return out


def limbs_sub(a_limbs, b_limbs):
    """Multi-precision subtract (a - b), borrow dropped past the top limb."""
    out = []
    borrow = None
    for a, b in zip(a_limbs, b_limbs):
        a = _u32(a)
        b = _u32(b)
        d = a - b
        br_new = (a < b).astype(jnp.uint32)
        if borrow is not None:
            d2 = d - borrow
            br_new = br_new + (d < borrow).astype(jnp.uint32)
            d = d2
        out.append(d)
        borrow = br_new
    return out


# ---------------------------------------------------------------------------
# Profile m31: q < 2^30, residue = single uint32 array.
# ---------------------------------------------------------------------------


class m31:
    """Vector ops mod q < 2^30. ``q``/``mu`` broadcast against the residues.

    ``mu = floor(2^64 / q)`` is passed as an (lo, hi) pair of u32 (hi <= 31).
    All results are canonical in [0, q).
    """

    nlimb = 1

    @staticmethod
    def zeros(shape):
        return jnp.zeros(shape, jnp.uint32)

    @staticmethod
    def add(x, y, q):
        s = x + y  # < 2q < 2^31, no wrap
        return s - jnp.where(s >= q, q, 0).astype(jnp.uint32)

    @staticmethod
    def sub(x, y, q):
        return jnp.where(x >= y, x - y, (x + q) - y)

    @staticmethod
    def neg(x, q):
        return jnp.where(x == 0, x, q - x)

    @staticmethod
    def csub(x, q):
        """Conditional subtract: map [0, 2q) -> [0, q)."""
        return x - jnp.where(x >= q, q, 0).astype(jnp.uint32)

    @staticmethod
    def mulmod_shoup(x, w, w_shoup, q):
        """x * w mod q with precomputed w_shoup = floor(w * 2^32 / q).

        Requires x in [0, q) (actually [0, 2^32) works for the estimate but
        canonical inputs keep the result in [0, 2q) before the final csub).
        """
        est = mulhi32(w_shoup, x)
        r = w * x - est * q  # wrapping arithmetic; true value in [0, 2q)
        return m31.csub(r, q)

    @staticmethod
    def mulmod_shoup_lazy(x, w, w_shoup, q):
        """Shoup product WITHOUT the final subtraction: result in [0, 2q).

        Valid for any x < 2^32 (Harvey lazy butterflies feed x < 4q)."""
        est = mulhi32(w_shoup, x)
        return w * x - est * q

    @staticmethod
    def csub2q(x, two_q):
        """Map [0, 4q) -> [0, 2q) (Harvey lazy normalization step)."""
        return x - jnp.where(x >= two_q, two_q, 0).astype(jnp.uint32)

    @staticmethod
    def lazy_add(x, y):
        """Raw add without reduction (caller guarantees < 2^32)."""
        return x + y

    @staticmethod
    def lazy_sub2q(x, y, two_q):
        """x - y + 2q without reduction (x, y < 2q -> result < 4q)."""
        return x + two_q - y

    @staticmethod
    def reduce64(lo, hi, q, mu_lo, mu_hi):
        """Reduce a 64-bit value (lo, hi) mod q via Barrett.

        mu = floor(2^64/q) as u32 pair. est = low limb of floor(x*mu / 2^64),
        computed exactly from only the partial products that can reach bit 64
        (~half the multiplies of a full 4-limb comba product):

          floor(x*mu/2^64) = hi*mu_hi
                             + carry(lo*mu_hi + hi*mu_lo + mulhi(lo, mu_lo))

        est differs from floor(x/q) by < 2, so the remainder is < 3q < 2^32
        for q < 2^30 (two conditional subtracts).
        """
        h1 = mulhi32(lo, mu_lo)
        s_lo, s_hi = mul32(lo, mu_hi)
        t_lo, t_hi = mul32(hi, mu_lo)
        u = s_lo + t_lo
        c = (u < t_lo).astype(jnp.uint32)
        u2 = u + h1
        c = c + (u2 < h1).astype(jnp.uint32)
        est = hi * mu_hi + s_hi + t_hi + c
        r = lo - est * q
        r = m31.csub(r, q)
        return m31.csub(r, q)

    @staticmethod
    def mulmod(x, y, q, mu_lo, mu_hi):
        """General x*y mod q (both operands variable)."""
        lo, hi = mul32(x, y)
        return m31.reduce64(lo, hi, q, mu_lo, mu_hi)

    @staticmethod
    def shoup_precompute(w, q, mu_lo, mu_hi):
        """Device computation of floor(w * 2^32 / q) for w in [0, q).

        Barrett estimate from (w << 32) * mu with exact correction steps.
        """
        zero = jnp.zeros_like(w)
        prod = comba_mul([zero, w], [mu_lo, mu_hi])
        est = prod[2]
        r = zero - est * q  # (w<<32) - est*q mod 2^32; true value < 3q < 2^32
        for _ in range(2):
            ge = r >= q
            est = est + ge.astype(jnp.uint32)
            r = r - jnp.where(ge, q, 0).astype(jnp.uint32)
        return est


# ---------------------------------------------------------------------------
# Profile m62: q < 2^62, residue = (lo, hi) uint32 pair.
# ---------------------------------------------------------------------------


class m62:
    """Vector ops mod q < 2^62 with residues as (lo, hi) u32 pairs.

    Constants per modulus (broadcastable arrays):
      q = (q_lo, q_hi); ratio = floor(2^128/q) as 3 u32 limbs (r0, r1, r2).
    Canonical residues in [0, q).
    """

    nlimb = 2

    @staticmethod
    def zeros(shape):
        return jnp.zeros(shape, jnp.uint32), jnp.zeros(shape, jnp.uint32)

    @staticmethod
    def _geq(x, y):
        """x >= y for 64-bit pairs."""
        xl, xh = x
        yl, yh = y
        return (xh > yh) | ((xh == yh) & (xl >= yl))

    @staticmethod
    def _add_raw(x, y):
        xl, xh = x
        yl, yh = y
        lo = xl + yl
        hi = xh + yh + (lo < xl).astype(jnp.uint32)
        return lo, hi

    @staticmethod
    def _sub_raw(x, y):
        xl, xh = x
        yl, yh = y
        lo = xl - yl
        hi = xh - yh - (xl < yl).astype(jnp.uint32)
        return lo, hi

    @staticmethod
    def csub(x, q):
        ge = m62._geq(x, q)
        d = m62._sub_raw(x, q)
        sel = lambda a, b: jnp.where(ge, a, b)
        return sel(d[0], x[0]), sel(d[1], x[1])

    @staticmethod
    def add(x, y, q):
        # x, y < q < 2^62 so x + y < 2^63: no wrap past 64 bits.
        return m62.csub(m62._add_raw(x, y), q)

    @staticmethod
    def sub(x, y, q):
        lt = ~m62._geq(x, y)
        xa = m62._add_raw(x, q)
        big = (jnp.where(lt, xa[0], x[0]), jnp.where(lt, xa[1], x[1]))
        return m62._sub_raw(big, y)

    @staticmethod
    def neg(x, q):
        is_zero = (x[0] == 0) & (x[1] == 0)
        d = m62._sub_raw(q, x)
        return (
            jnp.where(is_zero, x[0], d[0]),
            jnp.where(is_zero, x[1], d[1]),
        )

    @staticmethod
    def mulmod_shoup(x, w, w_shoup, q):
        """x*w mod q, w_shoup = floor(w * 2^64 / q) as u32 pair.

        r = (w*x mod 2^64) - hi64(w_shoup * x) * q mod 2^64, in [0, 2q).
        """
        return m62.csub(m62.mulmod_shoup_lazy(x, w, w_shoup, q), q)

    @staticmethod
    def mulmod_shoup_lazy(x, w, w_shoup, q):
        """Shoup product WITHOUT the final subtraction: result in [0, 2q).

        Valid for any 64-bit x (Harvey lazy butterflies feed x < 4q < 2^64).
        """
        wx = comba_mul([x[0], x[1]], [w[0], w[1]], out_limbs=2)
        est_full = comba_mul([x[0], x[1]], [w_shoup[0], w_shoup[1]])
        est = (est_full[2], est_full[3])  # hi64 of x * w_shoup
        est_q = comba_mul([est[0], est[1]], [q[0], q[1]], out_limbs=2)
        return m62._sub_raw((wx[0], wx[1]), (est_q[0], est_q[1]))

    @staticmethod
    def csub2q(x, two_q):
        """Map [0, 4q) -> [0, 2q) (Harvey lazy normalization; 4q < 2^64)."""
        ge = m62._geq(x, two_q)
        d = m62._sub_raw(x, two_q)
        sel = lambda a, b: jnp.where(ge, a, b)
        return sel(d[0], x[0]), sel(d[1], x[1])

    @staticmethod
    def lazy_add(x, y):
        """Raw add without reduction (caller guarantees < 2^64)."""
        return m62._add_raw(x, y)

    @staticmethod
    def lazy_sub2q(x, y, two_q):
        """x - y + 2q without reduction (x, y < 2q -> result < 4q)."""
        return m62._sub_raw(m62._add_raw(x, two_q), y)

    @staticmethod
    def reduce128(z, q, ratio):
        """Reduce 4-limb z mod q; ratio = floor(2^128/q) as 3 u32 limbs.

        est = floor(z * ratio / 2^128) is computed exactly (full 7-limb comba
        product), giving remainder in [0, 2q): one conditional subtract.
        """
        prod = comba_mul(list(z), list(ratio))  # 7 limbs
        est = (prod[4], prod[5])  # floor(z*ratio / 2^128), low 64 bits
        est_q = comba_mul([est[0], est[1]], [q[0], q[1]], out_limbs=2)
        r = m62._sub_raw((z[0], z[1]), (est_q[0], est_q[1]))
        return m62.csub(r, q)

    @staticmethod
    def mulmod(x, y, q, ratio):
        z = comba_mul([x[0], x[1]], [y[0], y[1]])  # 4 limbs
        return m62.reduce128(z, q, ratio)

    @staticmethod
    def shoup_precompute(w, q, ratio):
        """Device computation of floor(w * 2^64 / q) for w in [0, q)."""
        zero = jnp.zeros_like(w[0])
        prod = comba_mul([zero, zero, w[0], w[1]], list(ratio))
        est = (prod[4], prod[5])
        eq = comba_mul([est[0], est[1]], [q[0], q[1]], out_limbs=2)
        r = m62._sub_raw((zero, zero), (eq[0], eq[1]))
        for _ in range(2):
            ge = m62._geq(r, q)
            inc_lo = est[0] + ge.astype(jnp.uint32)
            est = (inc_lo, est[1] + (inc_lo < est[0]).astype(jnp.uint32))
            d = m62._sub_raw(r, q)
            r = (jnp.where(ge, d[0], r[0]), jnp.where(ge, d[1], r[1]))
        return est
