"""Full-RNS BFV ciphertext multiplication (BEHZ variant) + relinearization.

Implements the Bajard–Eynard–Hasan–Zucca integer-only RNS multiply — the
algorithm class SEAL 4.1 uses for ``Evaluator::multiply`` (the capability the
reference gets from SEAL but never exercises in the demo; it is this
framework's north-star throughput op, BASELINE.md: >=1e6 ct-ct mults/s at
n=4096):

  1. extend both ciphertexts from base Q to auxiliary base B_sk via
     m_tilde-scaled fast base conversion + small Montgomery reduction,
  2. tensor the ciphertexts in NTT domain over Q and B_sk (Karatsuba),
  3. fast floor: w ~ floor(t * e / q) computed in B_sk,
  4. Shenoy–Kumaresan exact conversion B_sk -> Q.

Supported on both residue profiles: m31 (<2^30 primes — the fast path; base
conversions are 96-bit column accumulations) and m62 (SEAL-style 36..61-bit
chains as u32 pairs; conversions accumulate 160-bit columns). Relinearization
uses the RNS gadget g_i (=1 mod q_i, =0 mod q_j): digits are the per-limb
residues of c2, so key switching is k NTTs + 2k pointwise multiplies against
NTT-domain relin keys.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import modmath as mm
from ..ops import ntt
from ..ops.primes import Modulus, get_primes
from .ciphertext import Ciphertext
from .context import BFVContext

__all__ = ["RnsMultiplier", "RelinKeys", "create_relin_keys", "relinearize"]

M_TILDE_BITS = 16
M_TILDE = 1 << M_TILDE_BITS
_M32 = 0xFFFFFFFF


def _u32s(vals):
    return jnp.asarray(np.asarray(vals, dtype=np.uint32))


def _limb_split(vals, nlimb, col=True):
    """Python ints -> tuple of u32 arrays, optionally shaped [L, 1]."""
    parts = []
    for i in range(nlimb):
        arr = _u32s([(int(v) >> (32 * i)) & _M32 for v in vals])
        parts.append(arr[:, None] if col else arr)
    return tuple(parts)


def _tmap(f, *xs):
    return jax.tree.map(f, *xs)


def _tslice_limbs(x, sl):
    return _tmap(lambda a: a[..., sl, :], x)


def _twhere(mask, a, b):
    return _tmap(lambda u, v: jnp.where(mask, u, v), a, b)


def _reduce96(z0, z1, z2, q, mu_lo, mu_hi):
    """(z2*2^64 + z1*2^32 + z0) mod q, q < 2^30."""
    r12 = mm.m31.reduce64(z1, z2, q, mu_lo, mu_hi)
    return mm.m31.reduce64(z0, r12, q, mu_lo, mu_hi)


@dataclass(frozen=True, eq=False)
class _Basis:
    """A prime basis with its NTT tables and per-limb Barrett constants."""

    moduli: tuple[Modulus, ...]
    tables: ntt.NttTables

    @property
    def k(self):
        return len(self.moduli)

    @property
    def profile(self):
        return self.tables.profile

    def q_col(self):  # broadcastable against [..., k, n]
        return _tmap(lambda a: a[:, None], self.tables.q)

    def mu_col(self):
        return tuple(m[:, None] for m in self.tables.mu)

    def shoup_const(self, vals):
        """Per-limb constants with Shoup companions, profile-packed."""
        if self.profile == "m31":
            w = _u32s(vals)[:, None]
            ws = _u32s(
                [(int(v) << 32) // m.value for v, m in zip(vals, self.moduli)]
            )[:, None]
            return w, ws
        w = _limb_split(vals, 2)
        ws = _limb_split(
            [(int(v) << 64) // m.value for v, m in zip(vals, self.moduli)], 2
        )
        return w, ws

    def mulmod_shoup(self, x, const):
        w, ws = const
        p = mm.m31 if self.profile == "m31" else mm.m62
        return p.mulmod_shoup(x, w, ws, self.q_col())

    def add(self, x, y):
        p = mm.m31 if self.profile == "m31" else mm.m62
        return p.add(x, y, self.q_col())

    def sub(self, x, y):
        p = mm.m31 if self.profile == "m31" else mm.m62
        return p.sub(x, y, self.q_col())


@dataclass(frozen=True, eq=False)
class _SubBasis(_Basis):
    """The first ``head`` limbs of a parent basis (shares its tables)."""

    head: int = 0

    def q_col(self):
        return _tmap(lambda a: a[: self.head, None], self.tables.q)

    def mu_col(self):
        return tuple(m[: self.head, None] for m in self.tables.mu)


def _conv_ints(src_moduli, dst_moduli, extra=1):
    """|prod(src)/src_i * extra|_d as python ints [D][S]."""
    prod = 1
    for m in src_moduli:
        prod *= m.value
    return [[(prod // s.value * extra) % d.value for s in src_moduli]
            for d in dst_moduli]


def _accum_reduce(y, conv, dst: _Basis):
    """sum_i y[..., i, :] * conv[d][i] mod dst_d -> [..., D, n].

    m31: exact 96-bit column accumulation.
    m62: exact 160-bit accumulation via comba partials + top-limb fold.
    """
    D = len(conv)
    S = len(conv[0])
    if dst.profile == "m31":
        cm = _u32s(conv)  # [D, S]
        z0 = z1 = z2 = None
        for i in range(S):
            yi = y[..., i : i + 1, :]
            ci = cm[:, i][:, None]
            lo, hi = mm.mul32(yi, ci)
            if z0 is None:
                z0, z1, z2 = lo, hi, jnp.zeros_like(lo)
            else:
                z0 = z0 + lo
                c0 = (z0 < lo).astype(jnp.uint32)
                z1n = z1 + hi
                c1 = (z1n < hi).astype(jnp.uint32)
                z1 = z1n + c0
                c1 = c1 + (z1 < z1n).astype(jnp.uint32)
                z2 = z2 + c1
        q = dst.tables.q[:, None]
        mu_lo, mu_hi = dst.mu_col()
        return _reduce96(z0, z1, z2, q, mu_lo, mu_hi)

    # m62: accumulate 5 u32 limbs exactly.
    c0m = [[(c >> 0) & _M32 for c in row] for row in conv]
    c1m = [[(c >> 32) & _M32 for c in row] for row in conv]
    c0a = _u32s(c0m)  # [D, S]
    c1a = _u32s(c1m)
    acc = None
    for i in range(S):
        ylo = y[0][..., i : i + 1, :]
        yhi = y[1][..., i : i + 1, :]
        prod = mm.comba_mul([ylo, yhi], [c0a[:, i][:, None], c1a[:, i][:, None]])
        prod5 = prod + [jnp.zeros_like(prod[0])]
        acc = prod5 if acc is None else mm.limbs_add(acc, prod5)
    q = dst.q_col()
    ratio = dst.mu_col()
    low = mm.m62.reduce128(tuple(acc[:4]), q, ratio)
    # Fold the top limb: acc[4] * 2^128 mod m.
    top = (acc[4], jnp.zeros_like(acc[4]))
    r128 = dst.shoup_const([(1 << 128) % m.value for m in dst.moduli])
    return dst.add(low, dst.mulmod_shoup(top, r128))


def _low16(y, profile, idx):
    arr = y if profile == "m31" else y[0]
    return arr[..., idx, :] & jnp.uint32(M_TILDE - 1)


class RnsMultiplier:
    """BEHZ multiplier bound to one BFVContext (either residue profile)."""

    def __init__(self, ctx: BFVContext):
        self.ctx = ctx
        n = ctx.n
        t = ctx.t
        k = ctx.L
        profile = ctx.tables.profile
        q_values = [m.value for m in ctx.moduli]
        q = ctx.q

        # Size the auxiliary base: need prod(B) > 2 * n * t * q (SK bound on
        # |w| ~ t*e/q) with margin for the uncentered sm_mrq (x_hat < 2q).
        need_bits = q.bit_length() + t.bit_length() + n.bit_length() + 6
        if profile == "m31":
            p_bits, p_cap = 30, 29
        else:
            p_bits, p_cap = 60, 59
        l = max(k + 1, (need_bits + p_cap - 1) // p_cap)
        pool = [p for p in get_primes(p_bits, l + k + 2, n) if p not in q_values]
        b_values = pool[:l]
        msk = pool[l]
        assert len(b_values) == l

        self.base_q = _Basis(ctx.moduli, ctx.tables)
        bsk_moduli = [Modulus(p) for p in b_values + [msk]]
        self.base_bsk = _Basis(
            tuple(bsk_moduli),
            ntt.build_tables(bsk_moduli, n, engine=ctx.tables.engine),
        )
        # Single-modulus "basis" views for m_sk-only arithmetic.
        self.base_msk = _Basis(
            (Modulus(msk),), ntt.build_tables([Modulus(msk)], n)
        )
        self.b_only = _SubBasis(
            tuple(bsk_moduli[:-1]), self.base_bsk.tables, head=l
        )
        self.l = l
        self.msk = msk
        M = 1
        for p in b_values:
            M *= p
        self.M = M

        qm = q_values
        bq, bb = self.base_q, self.base_bsk
        # Raw integer constants (the Shoup/u32 forms below derive from them).
        self.mtilde_qhat_inv_ints = [
            (M_TILDE * pow(q // qi, -1, qi)) % qi for qi in qm
        ]
        self.conv_q_to_mtilde_ints = [(q // qi) % M_TILDE for qi in qm]
        self.inv_mtilde_bsk_ints = [pow(M_TILDE, -1, m.value) for m in bsk_moduli]
        self.t_mod_q_ints = [t % qi for qi in qm]
        self.t_mod_bsk_ints = [t % m.value for m in bsk_moduli]
        self.inv_q_bsk_ints = [pow(q % m.value, -1, m.value) for m in bsk_moduli]
        self.qhat_inv_ints = [pow(q // qi, -1, qi) for qi in qm]
        self.inv_M_msk_int = pow(M % msk, -1, msk)
        self.M_mod_q_ints = [M % qi for qi in qm]
        # --- Q -> B_sk u {m_tilde} conversion constants -------------------
        self.mtilde_qhat_inv = bq.shoup_const(self.mtilde_qhat_inv_ints)
        self.conv_q_to_bsk = _conv_ints(ctx.moduli, bsk_moduli)
        self.conv_q_to_mtilde = _u32s(self.conv_q_to_mtilde_ints)
        self.neg_inv_q_mtilde = int(pow(-q, -1, M_TILDE))
        self.q_mod_bsk_ints = [q % m.value for m in bsk_moduli]
        self.inv_mtilde_bsk = bb.shoup_const(self.inv_mtilde_bsk_ints)
        # --- fast floor constants ----------------------------------------
        self.t_mod_q = bq.shoup_const(self.t_mod_q_ints)
        self.t_mod_bsk = bb.shoup_const(self.t_mod_bsk_ints)
        self.inv_q_bsk = bb.shoup_const(self.inv_q_bsk_ints)
        self.qhat_inv = bq.shoup_const(self.qhat_inv_ints)
        # --- B_sk -> Q (Shenoy-Kumaresan) constants -----------------------
        b_basis = bsk_moduli[:-1]
        self.bhat_inv_b = [pow(M // p.value, -1, p.value) for p in b_basis]
        self.conv_b_to_q = _conv_ints(b_basis, ctx.moduli)
        self.conv_b_to_msk = _conv_ints(b_basis, [Modulus(msk)])
        self.inv_M_msk = self.base_msk.shoup_const([self.inv_M_msk_int])
        self.M_mod_q = bq.shoup_const(self.M_mod_q_ints)
        self.mskM_mod_q_ints = [(msk * M) % qi for qi in qm]
        self.msk_half = msk // 2

    # ------------------------------------------------------------------

    def _bhat_inv_const(self):
        """Shoup consts for the B-only sub-basis (first l limbs of B_sk)."""
        bb = self.base_bsk
        if bb.profile == "m31":
            w = _u32s(self.bhat_inv_b)[:, None]
            ws = _u32s(
                [(int(v) << 32) // m.value
                 for v, m in zip(self.bhat_inv_b, self.b_only.moduli)]
            )[:, None]
            return w, ws
        w = _limb_split(self.bhat_inv_b, 2)
        ws = _limb_split(
            [(int(v) << 64) // m.value
             for v, m in zip(self.bhat_inv_b, self.b_only.moduli)], 2
        )
        return w, ws

    def _small_mul_mod(self, const_ints, r, dst: _Basis):
        """const_d * r mod dst_d for u32 r [..., n] -> [..., D, n]."""
        if dst.profile == "m31":
            cm = _u32s(const_ints)[:, None]
            lo, hi = mm.mul32(cm, r[..., None, :])
            q = dst.tables.q[:, None]
            mu_lo, mu_hi = dst.mu_col()
            return mm.m31.reduce64(lo, hi, q, mu_lo, mu_hi)
        c = _limb_split(const_ints, 2)
        rb = r[..., None, :]
        prod = mm.comba_mul([c[0], c[1]], [rb])  # 3 limbs
        z = (prod[0], prod[1], prod[2], jnp.zeros_like(prod[0]))
        return mm.m62.reduce128(z, dst.q_col(), dst.mu_col())

    def _to_bsk(self, x_q):
        """Base extension Q -> B_sk with m_tilde Montgomery correction."""
        bq, bb = self.base_q, self.base_bsk
        y = bq.mulmod_shoup(x_q, self.mtilde_qhat_inv)
        x_bsk = _accum_reduce(y, self.conv_q_to_bsk, bb)
        # m_tilde component: 16-bit arithmetic.
        mask = jnp.uint32(M_TILDE - 1)
        acc = None
        for i in range(bq.k):
            term = (_low16(y, bq.profile, i) * self.conv_q_to_mtilde[i]) & mask
            acc = term if acc is None else (acc + term) & mask
        r = (acc * jnp.uint32(self.neg_inv_q_mtilde)) & mask
        corr = self._small_mul_mod(self.q_mod_bsk_ints, r, bb)
        x_bsk = bb.add(x_bsk, corr)
        return bb.mulmod_shoup(x_bsk, self.inv_mtilde_bsk)

    def _fast_floor(self, e_q, e_bsk):
        """floor(t * e / q) (with BEHZ-bounded error) expressed in B_sk."""
        bq, bb = self.base_q, self.base_bsk
        te_q = bq.mulmod_shoup(e_q, self.t_mod_q)
        te_b = bb.mulmod_shoup(e_bsk, self.t_mod_bsk)
        y = bq.mulmod_shoup(te_q, self.qhat_inv)
        conv = _accum_reduce(y, self.conv_q_to_bsk_plain(), bb)
        return bb.mulmod_shoup(bb.sub(te_b, conv), self.inv_q_bsk)

    @functools.cache
    def conv_q_to_bsk_plain(self):
        return tuple(
            tuple(row) for row in _conv_ints(self.ctx.moduli, self.base_bsk.moduli)
        )

    def _sk_to_q(self, w_bsk):
        """Shenoy-Kumaresan exact conversion B_sk -> Q."""
        bq = self.base_q
        l = self.l
        w_b = _tslice_limbs(w_bsk, slice(0, l))
        w_msk = _tslice_limbs(w_bsk, slice(l, l + 1))
        p = mm.m31 if bq.profile == "m31" else mm.m62
        bhw, bhws = self._bhat_inv_const()
        y = p.mulmod_shoup(w_b, bhw, bhws, self.b_only.q_col())
        conv_q = _accum_reduce(y, self.conv_b_to_q, bq)
        conv_msk = _accum_reduce(y, self.conv_b_to_msk, self.base_msk)
        diff = self.base_msk.sub(conv_msk, w_msk)
        alpha = self.base_msk.mulmod_shoup(diff, self.inv_M_msk)
        # out = conv_q - alpha*M; where centered alpha is negative, + msk*M.
        if bq.profile == "m31":
            a_bc = jnp.broadcast_to(alpha, alpha.shape[:-2] + (bq.k, alpha.shape[-1]))
            am = bq.mulmod_shoup(a_bc, self.M_mod_q)
            out = bq.sub(conv_q, am)
            corr_add = _u32s(self.mskM_mod_q_ints)[:, None]
            corr = bq.add(out, jnp.broadcast_to(corr_add, out.shape))
            high = alpha[..., 0:1, :] > jnp.uint32(self.msk_half)
            return jnp.where(high, corr, out)
        a_bc = _tmap(
            lambda a: jnp.broadcast_to(a, a.shape[:-2] + (bq.k, a.shape[-1])), alpha
        )
        am = bq.mulmod_shoup(a_bc, self.M_mod_q)
        out = bq.sub(conv_q, am)
        corr_c = _limb_split(self.mskM_mod_q_ints, 2)
        corr = bq.add(out, _tmap(lambda c, o: jnp.broadcast_to(c, o.shape), corr_c, out))
        half = (jnp.uint32(self.msk_half & _M32), jnp.uint32(self.msk_half >> 32))
        high = mm.m62._geq(alpha, half) & ~(
            (alpha[0] == jnp.uint32(self.msk_half & _M32))
            & (alpha[1] == jnp.uint32(self.msk_half >> 32))
        )
        high = high[..., 0:1, :]
        return _twhere(high, corr, out)

    # ------------------------------------------------------------------

    def multiply(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        """BFV multiply: (c0,c1) x (d0,d1) -> size-3 ciphertext in Q.

        Structure note (round-4 A/B, scripts/r4_ab_multiply.py): keeping the
        four input polys as SEPARATE per-poly phase chains is ~1.45x faster
        under XLA than stacking them on a leading axis ([4,B,L,n] stacking
        measured 23.6 ms vs 16.5 ms per 256-batch call — the big stacked
        arrays defeat XLA's fusion/layout choices). Do not "batch" these."""
        assert ct1.size == 2 and ct2.size == 2
        assert ct1.domain == "coeff" and ct2.domain == "coeff"
        tq, tb = self.base_q.tables, self.base_bsk.tables

        def prep(poly):
            bsk = self._to_bsk(poly)
            return (ntt.forward(poly, tq), ntt.forward(bsk, tb))

        c0, c1 = (prep(x) for x in ct1.polys)
        d0, d1 = (prep(x) for x in ct2.polys)

        es = []
        for basis_i, (basis, tbx) in ((0, (self.base_q, tq)), (1, (self.base_bsk, tb))):
            a0, a1 = c0[basis_i], c1[basis_i]
            b0, b1 = d0[basis_i], d1[basis_i]
            e0 = ntt.pointwise_mul(a0, b0, tbx)
            e2 = ntt.pointwise_mul(a1, b1, tbx)
            # Karatsuba: e1 = (a0+a1)(b0+b1) - e0 - e2 (3 multiplies).
            cross = ntt.pointwise_mul(basis.add(a0, a1), basis.add(b0, b1), tbx)
            e1 = basis.sub(basis.sub(cross, e0), e2)
            es.append(tuple(ntt.inverse(e, tbx) for e in (e0, e1, e2)))

        out_polys = []
        for j in range(3):
            w = self._fast_floor(es[0][j], es[1][j])
            out_polys.append(self._sk_to_q(w))
        return Ciphertext(tuple(out_polys), "coeff")


# ---------------------------------------------------------------------------
# Relinearization
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclass
class KSwitchKeys:
    """RNS-gadget key-switching keys toward a target secret T:
    key[j] = (b_j, a_j) in NTT domain, b_j = -(a_j s + e_j) + g_j T,
    g_j = 1 mod prod(q_i, i in group j), 0 mod the other limbs. T = s^2
    gives relinearization keys; T = s(X^g) gives Galois keys.

    ``groups`` records the gadget's limb grouping (None == one digit per
    limb, the classic gadget); it rides in the pytree aux data so
    ``relinearize`` can dispatch the right digit decomposition from the
    keys alone — ONE production relin config, selected at keygen.

    Registered as a pytree so key generation can run under ONE jit (eager
    keygen is hundreds of tiny dispatches)."""

    k0: Any  # [D, L, n] stacked b_j (with Shoup companions)
    k0_shoup: Any
    k1: Any
    k1_shoup: Any
    groups: tuple | None = None

    def tree_flatten(self):
        return (self.k0, self.k0_shoup, self.k1, self.k1_shoup), (self.groups,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, groups=aux[0])


RelinKeys = KSwitchKeys  # relin keys are key-switch keys for T = s^2


def _digit_groups(k: int, width: int):
    """Consecutive limb groups for the RNS gadget: width=1 is the classic
    per-limb gadget; width=2 pairs limbs (digit modulus q_i*q_{i+1})."""
    return tuple(
        tuple(range(i, min(i + width, k))) for i in range(0, k, width)
    )


def default_relin_width(ctx: BFVContext) -> int:
    """Noise-bounded gadget width for THIS context's parameters (the one
    production relinearization config — VERDICT r4 task 6). BFV rule ONLY:
    it measures gadget noise against the Delta/2 = q/2t decryption headroom.
    CKKS paths (no Delta; keyswitch error is message error) must pass
    width=1 explicitly — ``ckks.ckks_create_relin_keys`` does.

    Keyswitch noise add ~ D * n * digit_max * B_err; require it at least
    ``margin`` bits under Delta/2 = q/(2t). Width 2 halves the dominant
    relin cost (one forward NTT per digit); wider digits need Garner
    lifting (not implemented), so the result is capped at 2.

    Examples at the shipped chains: tpu profile n=4096 (4 x ~27-bit,
    t=2^16) -> width 2 (digit ~2^55, noise ~2^75 vs budget 2^92); SEAL m62
    n=4096 (36+36+37, t=2^16) -> width 1 (a 2^73 digit would put the noise
    at ~2^93, over the 2^92 budget); SEAL m62 n=8192 -> width 2."""
    import math

    margin_bits = 10
    b_err_bits = 7  # CBD bound (|e| <= 2*eta = 12 < 2^7) with headroom
    delta_half_bits = (ctx.q // ctx.t).bit_length() - 2
    best = 1
    for width in (2,):
        groups = _digit_groups(ctx.L, width)
        digit_bits = max(
            sum(ctx.moduli[i].value.bit_length() for i in g) for g in groups
        )
        noise_bits = (
            math.ceil(math.log2(len(groups)))
            + ctx.n.bit_length()
            + digit_bits
            + b_err_bits
        )
        if noise_bits + margin_bits <= delta_half_bits:
            best = width
    return best


def create_kswitch_keys(ctx: BFVContext, sk, target_ntt, key,
                        inject=None, groups=None) -> KSwitchKeys:
    """``inject``: optional list of (a_coeff_res, e_coeff_res) per digit —
    explicit randomness for known-answer vectors (tests/bfv_oracle.py).

    ``groups``: limb groups of the gadget (default one digit per limb).
    g_j = 1 mod q_i for i in group j, 0 elsewhere — so in RNS the key's
    target term is simply the target masked to the group's limbs."""
    from . import sampling
    from .keys import _shoup as sh

    p = ctx.prof
    q2 = ctx.tables.q_b(1)
    k = ctx.L
    if groups is None:
        groups = _digit_groups(k, 1)
    k0_rows, k1_rows = [], []
    for gi, group in enumerate(groups):
        if inject is not None:
            a = ntt.forward(inject[gi][0], ctx.tables)
            e_ntt = ntt.forward(inject[gi][1], ctx.tables)
        else:
            key, ka, ke = jax.random.split(key, 3)
            a = sampling.uniform_rq(ka, ctx)
            e_ntt = ntt.forward(sampling.cbd_poly(ke, ctx), ctx.tables)
        b = p.neg(p.add(p.mulmod_shoup(a, sk.s_ntt, sk.s_shoup, q2), e_ntt, q2), q2)
        # add g_j * T: only the group's limbs get the target secret.
        sel = jnp.zeros((k, 1), jnp.uint32)
        for i in group:
            sel = sel.at[i, 0].set(1)
        gt = jax.tree.map(lambda v: v * sel, target_ntt)
        b = p.add(b, gt, q2)
        k0_rows.append(b)
        k1_rows.append(a)
    stack = lambda rows: jax.tree.map(lambda *xs: jnp.stack(xs), *rows)

    def row_shoup(rows):
        return jax.tree.map(lambda *xs: jnp.stack(xs), *[sh(ctx, r) for r in rows])

    return KSwitchKeys(
        k0=stack(k0_rows), k0_shoup=row_shoup(k0_rows),
        k1=stack(k1_rows), k1_shoup=row_shoup(k1_rows),
        groups=tuple(groups),
    )


def create_relin_keys(ctx: BFVContext, sk, key, inject=None,
                      width: int | None = None) -> KSwitchKeys:
    """Relinearization keys at the production gadget width.

    ``width=None`` selects :func:`default_relin_width` (the ONE production
    config); explicit ``width`` overrides for experiments/tests. ``inject``
    (known-answer vectors) implies the per-limb gadget unless width is
    given, because the injected randomness list is per-digit."""
    p = ctx.prof
    q2 = ctx.tables.q_b(1)
    s2 = p.mulmod_shoup(sk.s_ntt, sk.s_ntt, sk.s_shoup, q2)
    if width is None:
        width = 1 if inject is not None else default_relin_width(ctx)
    groups = _digit_groups(ctx.L, width)
    return create_kswitch_keys(ctx, sk, s2, key, inject=inject, groups=groups)


def create_relin_keys_wide(ctx: BFVContext, sk, key, width: int = 2):
    """Back-compat wrapper: relin keys at an explicit gadget width.
    Returns (keys, groups); ``relinearize`` now reads the groups from the
    keys, so new code should call ``create_relin_keys`` directly."""
    keys = create_relin_keys(ctx, sk, key, width=width)
    return keys, keys.groups


def lift_digit_grouped(ctx: BFVContext, poly, group):
    """Lift gadget digit |poly| mod prod(q_i, i in group) into every limb.

    Width 1: plain residue broadcast-reduce. Width 2 (both profiles): CRT
    compose x = r0 + q0*t with t = (r1 - r0)*q0^{-1} mod q1, then reduce
    x per limb as (r0 mod q_i) + (q0 mod q_i)*t mod q_i — all
    coefficient-wise, so it works on any lane-sharded slice too
    (DistMultiplier reuses it per shard)."""
    p = ctx.prof
    tb = ctx.tables
    moduli = [m.value for m in ctx.moduli]
    if tb.profile == "m31":
        q_col = tb.q[:, None]
        mu_lo, mu_hi = (m[:, None] for m in tb.mu)
        if len(group) == 1:
            i = group[0]
            digit = _tslice_limbs(poly, slice(i, i + 1))
            return p.reduce64(
                jnp.broadcast_to(digit, poly.shape), jnp.zeros_like(poly),
                q_col, mu_lo, mu_hi,
            )
        assert len(group) == 2, "width>2 digits need Garner lifting"
        i0, i1 = group
        q0, q1v = moduli[i0], moduli[i1]
        r0 = poly[..., i0 : i0 + 1, :]
        r1 = poly[..., i1 : i1 + 1, :]
        m1 = Modulus(q1v)
        mu1_lo = jnp.uint32(m1.mu64 & _M32)
        mu1_hi = jnp.uint32(m1.mu64 >> 32)
        q1j = jnp.uint32(q1v)
        # t = (r1 - r0) * q0^{-1} mod q1  (CRT mixing digit).
        r0m = p.reduce64(r0, jnp.zeros_like(r0), q1j, mu1_lo, mu1_hi)
        d = p.sub(r1, r0m, q1j)
        inv01 = pow(q0, -1, q1v)
        t = p.mulmod_shoup(
            d, jnp.uint32(inv01), jnp.uint32((inv01 << 32) // q1v), q1j
        )
        r0_b = jnp.broadcast_to(r0, poly.shape)
        r0_all = p.reduce64(r0_b, jnp.zeros_like(poly), q_col, mu_lo, mu_hi)
        q0w = [q0 % qi for qi in moduli]
        q0ws = [((q0 % qi) << 32) // qi for qi in moduli]
        qt = p.mulmod_shoup(
            jnp.broadcast_to(t, poly.shape),
            _u32s(q0w)[:, None], _u32s(q0ws)[:, None], q_col,
        )
        return p.add(r0_all, qt, q_col)

    # -- m62 profile (u32 limb pairs) -----------------------------------
    q_col = _tmap(lambda a: a[:, None], tb.q)
    ratio = tuple(m[:, None] for m in tb.mu)
    zero_like = lambda a: jnp.zeros_like(a)

    def bcast_reduce(r):  # r: (lo, hi) slices [..., 1, n] -> all limbs
        lo = jnp.broadcast_to(r[0], poly[0].shape)
        hi = jnp.broadcast_to(r[1], poly[0].shape)
        return p.reduce128((lo, hi, zero_like(lo), zero_like(lo)), q_col, ratio)

    if len(group) == 1:
        i = group[0]
        return bcast_reduce(_tmap(lambda a: a[..., i : i + 1, :], poly))
    assert len(group) == 2, "width>2 digits need Garner lifting"
    i0, i1 = group
    q0, q1v = moduli[i0], moduli[i1]
    r0 = _tmap(lambda a: a[..., i0 : i0 + 1, :], poly)
    r1 = _tmap(lambda a: a[..., i1 : i1 + 1, :], poly)
    m1 = Modulus(q1v)
    pair = lambda v: (jnp.uint32(v & _M32), jnp.uint32(v >> 32))
    q1p = pair(q1v)
    ratio1 = tuple(jnp.uint32(w) for w in _split_ratio(m1.const_ratio))
    r0m = p.reduce128(
        (r0[0], r0[1], zero_like(r0[0]), zero_like(r0[0])), q1p, ratio1
    )
    d = p.sub(r1, r0m, q1p)
    inv01 = pow(q0, -1, q1v)
    t = p.mulmod_shoup(d, pair(inv01), pair((inv01 << 64) // q1v), q1p)
    r0_all = bcast_reduce(r0)
    t_b = _tmap(lambda a: jnp.broadcast_to(a, poly[0].shape), t)
    q0w = _limb_split([q0 % qi for qi in moduli], 2)
    q0ws = _limb_split([((q0 % qi) << 64) // qi for qi in moduli], 2)
    qt = p.mulmod_shoup(t_b, q0w, q0ws, q_col)
    return p.add(r0_all, qt, q_col)


def _split_ratio(vals3):
    """m62 const_ratio (3 u32 limbs as ints or tuple) -> 3 scalars."""
    if isinstance(vals3, (tuple, list)):
        return vals3
    return ((vals3 >> 0) & _M32, (vals3 >> 32) & _M32, (vals3 >> 64) & _M32)


def keyswitch_contributions_grouped(ctx: BFVContext, poly, keys: KSwitchKeys,
                                    groups):
    """Grouped-digit keyswitch: digit j = |poly| mod prod(q_i, i in
    group j), CRT-composed from the group's residues and lifted to every
    limb, then one forward NTT per digit instead of one per limb."""
    p = ctx.prof
    tb = ctx.tables
    q2 = tb.q_b(1)
    acc0 = acc1 = None
    for j, group in enumerate(groups):
        lifted = lift_digit_grouped(ctx, poly, group)
        d_ntt = ntt.forward(lifted, tb)
        t0 = p.mulmod_shoup(
            d_ntt, jax.tree.map(lambda a: a[j], keys.k0),
            jax.tree.map(lambda a: a[j], keys.k0_shoup), q2,
        )
        t1 = p.mulmod_shoup(
            d_ntt, jax.tree.map(lambda a: a[j], keys.k1),
            jax.tree.map(lambda a: a[j], keys.k1_shoup), q2,
        )
        acc0 = t0 if acc0 is None else p.add(acc0, t0, q2)
        acc1 = t1 if acc1 is None else p.add(acc1, t1, q2)
    return ntt.inverse(acc0, tb), ntt.inverse(acc1, tb)


def relinearize_wide(ctx: BFVContext, ct: Ciphertext, rlk: KSwitchKeys,
                     groups=None) -> Ciphertext:
    """Back-compat alias: ``relinearize`` now reads groups from the keys."""
    assert ct.size == 3 and ct.domain == "coeff"
    p = ctx.prof
    q2 = ctx.tables.q_b(1)
    c0, c1, c2 = ct.polys
    d0, d1 = keyswitch_contributions_grouped(
        ctx, c2, rlk, groups if groups is not None else rlk.groups
    )
    return Ciphertext((p.add(c0, d0, q2), p.add(c1, d1, q2)), "coeff")


def make_keys_jit(ctx: BFVContext, seed: int):
    """(SecretKey, relin KSwitchKeys) generated under ONE compiled graph.

    Eager keygen (KeyGenerator + create_relin_keys outside jit) issues
    hundreds of tiny dispatches, each its own compile on first use.
    Benchmarks and profiles should use this instead."""
    from . import sampling
    from .keys import SecretKey, _shoup

    def f(key):
        key_s, key_r = jax.random.split(key)
        s = sampling.ternary_poly(key_s, ctx)
        s_ntt = ntt.forward(s, ctx.tables)
        s_shoup = _shoup(ctx, s_ntt)
        sk = SecretKey(s_ntt=s_ntt, s_shoup=s_shoup)
        return (s_ntt, s_shoup), create_relin_keys(ctx, sk, key_r)

    (s_ntt, s_shoup), rlk = jax.jit(f)(jax.random.key(seed))
    return SecretKey(s_ntt=s_ntt, s_shoup=s_shoup), rlk


def keyswitch_contributions(ctx: BFVContext, poly, keys: KSwitchKeys):
    """Sum_i NTT(lift(|poly|_{q_i})) * key[i] -> (d0, d1) in coeff domain.

    Structure note (round-4 A/B): the per-digit loop is faster under XLA
    than stacking the k digits on a leading axis (+1 ms per 256-batch call
    for the stacked form) — same finding as RnsMultiplier.multiply."""
    p = ctx.prof
    tb = ctx.tables
    q2 = tb.q_b(1)
    k = ctx.L
    acc0 = acc1 = None
    for i in range(k):
        digit = _tslice_limbs(poly, slice(i, i + 1))
        # Lift |poly|_{q_i} into every limb (generic 64/128-bit reduction).
        if tb.profile == "m31":
            mu2 = tuple(m[:, None] for m in tb.mu)
            lifted = p.reduce64(
                jnp.broadcast_to(digit, poly.shape), jnp.zeros_like(poly),
                tb.q[:, None], mu2[0], mu2[1],
            )
        else:
            dig_b = _tmap(lambda a, full: jnp.broadcast_to(a, full.shape), digit, poly)
            zero = jnp.zeros_like(dig_b[0])
            ratio = tuple(m[:, None] for m in tb.mu)
            lifted = p.reduce128(
                (dig_b[0], dig_b[1], zero, zero),
                _tmap(lambda a: a[:, None], tb.q), ratio,
            )
        d_ntt = ntt.forward(lifted, tb)
        t0 = p.mulmod_shoup(
            d_ntt, jax.tree.map(lambda a: a[i], keys.k0),
            jax.tree.map(lambda a: a[i], keys.k0_shoup), q2,
        )
        t1 = p.mulmod_shoup(
            d_ntt, jax.tree.map(lambda a: a[i], keys.k1),
            jax.tree.map(lambda a: a[i], keys.k1_shoup), q2,
        )
        acc0 = t0 if acc0 is None else p.add(acc0, t0, q2)
        acc1 = t1 if acc1 is None else p.add(acc1, t1, q2)
    return ntt.inverse(acc0, tb), ntt.inverse(acc1, tb)


def relinearize(ctx: BFVContext, ct: Ciphertext, rlk: KSwitchKeys) -> Ciphertext:
    """Size-3 -> size-2: key-switch c2 with the gadget the KEYS were built
    for (keys.groups) — one production config, chosen at keygen by
    ``default_relin_width``; per-limb keys take the classic fast path."""
    assert ct.size == 3 and ct.domain == "coeff"
    p = ctx.prof
    q2 = ctx.tables.q_b(1)
    c0, c1, c2 = ct.polys
    groups = rlk.groups
    if groups is None or all(len(g) == 1 for g in groups):
        d0, d1 = keyswitch_contributions(ctx, c2, rlk)
    else:
        d0, d1 = keyswitch_contributions_grouped(ctx, c2, rlk, groups)
    return Ciphertext((p.add(c0, d0, q2), p.add(c1, d1, q2)), "coeff")
