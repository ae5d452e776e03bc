"""Homomorphic evaluation: add/sub/negate, plain add/multiply.

Covers the evaluator surface the reference protocol uses
(``/root/reference/src/demo.cc:154-160``: add_plain, multiply_plain, add, sub).
All ops are pure functions over Ciphertext pytrees — jit/vmap/shard_map ready.
multiply_plain transforms the ciphertext per-op (SEAL BFV convention) but the
plaintext NTT + Shoup precompute is shared across both ct components.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops import ntt
from .ciphertext import Ciphertext
from .context import BFVContext
from .keys import _shoup
from .plaintext import Plaintext

__all__ = ["Evaluator", "mod_switch_to_next", "restrict_secret_key"]


class Evaluator:
    def __init__(self, ctx: BFVContext):
        self.ctx = ctx

    # -- ct (+|-) ct ----------------------------------------------------

    def _zip(self, a: Ciphertext, b: Ciphertext, fn):
        assert a.domain == b.domain
        k = max(a.size, b.size)
        q2 = self.ctx.tables.q_b(1)
        p = self.ctx.prof
        polys = []
        for i in range(k):
            if i >= a.size:
                polys.append(b.polys[i] if fn is p.add else p.neg(b.polys[i], q2))
            elif i >= b.size:
                polys.append(a.polys[i])
            else:
                polys.append(fn(a.polys[i], b.polys[i], q2))
        return Ciphertext(polys=tuple(polys), domain=a.domain)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._zip(a, b, self.ctx.prof.add)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._zip(a, b, self.ctx.prof.sub)

    def negate(self, a: Ciphertext) -> Ciphertext:
        p, q2 = self.ctx.prof, self.ctx.tables.q_b(1)
        return Ciphertext(tuple(p.neg(c, q2) for c in a.polys), a.domain)

    def add_many(self, cts) -> Ciphertext:
        """Tree-sum of ciphertexts (SEAL Evaluator::add_many; the CKKS demo
        aggregates with it, /root/reference/src/ckks_demo/ckks_server.cc)."""
        cts = list(cts)
        assert cts, "add_many of nothing"
        while len(cts) > 1:
            nxt = [
                self.add(cts[i], cts[i + 1]) if i + 1 < len(cts) else cts[i]
                for i in range(0, len(cts), 2)
            ]
            cts = nxt
        return cts[0]

    # -- ct * ct ----------------------------------------------------------

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """BEHZ full-RNS multiply (size-3 result; relinearize to shrink)."""
        from .behz import RnsMultiplier

        mul = getattr(self, "_mul", None)
        if mul is None:
            mul = self._mul = RnsMultiplier(self.ctx)
        return mul.multiply(a, b)

    def relinearize(self, ct: Ciphertext, keys) -> Ciphertext:
        """Dispatch on key type: RNS-gadget KSwitchKeys or special-prime
        SPKeys (bfv.keyswitch)."""
        from .keyswitch import SPKeys, sp_relinearize

        if isinstance(keys, SPKeys):
            return sp_relinearize(self.ctx, ct, keys)
        from .behz import relinearize

        return relinearize(self.ctx, ct, keys)

    # -- ct (+|-) plain -------------------------------------------------

    def _plain_pairs(self, plain):
        if isinstance(plain, Plaintext):
            lo, hi = plain.pair_u32(self.ctx.n)
            return jnp.asarray(lo), jnp.asarray(hi)
        return plain  # already (lo, hi) arrays

    def add_plain(self, a: Ciphertext, plain) -> Ciphertext:
        assert a.domain == "coeff"
        m_lo, m_hi = self._plain_pairs(plain)
        term = self.ctx.scale_plain(m_lo, m_hi)
        p, q2 = self.ctx.prof, self.ctx.tables.q_b(1)
        return Ciphertext((p.add(a.polys[0], term, q2),) + a.polys[1:], a.domain)

    def sub_plain(self, a: Ciphertext, plain) -> Ciphertext:
        assert a.domain == "coeff"
        m_lo, m_hi = self._plain_pairs(plain)
        term = self.ctx.scale_plain(m_lo, m_hi)
        p, q2 = self.ctx.prof, self.ctx.tables.q_b(1)
        return Ciphertext((p.sub(a.polys[0], term, q2),) + a.polys[1:], a.domain)

    # -- ct * plain -----------------------------------------------------

    def multiply_plain(self, a: Ciphertext, plain) -> Ciphertext:
        """a * m where m is an un-scaled plaintext poly (centered lift)."""
        assert a.domain == "coeff"
        ctx = self.ctx
        m_ntt, m_shoup = self.plain_spectrum(plain)
        p, q2 = ctx.prof, ctx.tables.q_b(1)
        polys = []
        for c in a.polys:
            c_ntt = ntt.forward(c, ctx.tables)
            prod = p.mulmod_shoup(c_ntt, m_ntt, m_shoup, q2)
            polys.append(ntt.inverse(prod, ctx.tables))
        return Ciphertext(tuple(polys), "coeff")

    # -- NTT-domain chaining --------------------------------------------
    #
    # Every op here is exact modular ring arithmetic, and the NTT is a ring
    # isomorphism — so chained expressions (e.g. the protocol's blind
    # distance s*(c1 + z - (c2*xb + c3*yb)) + s*r) can transform each
    # operand ONCE, combine in the spectrum, and inverse-transform once,
    # with bit-identical results to the op-by-op coefficient-domain chain.
    # SEAL's BFV evaluator re-transforms per multiply_plain call; this is
    # the transform-budget optimization (NTT sweeps are the memory-traffic
    # currency — docs/performance_model.md).

    def plain_spectrum(self, plain):
        """Plaintext -> (m_ntt, m_shoup), cacheable across calls/radii."""
        ctx = self.ctx
        m_lo, m_hi = self._plain_pairs(plain)
        m_rq = ctx.lift_plain_centered(m_lo, m_hi)
        m_ntt = ntt.forward(m_rq, ctx.tables)
        return m_ntt, _shoup(ctx, m_ntt)

    def to_ntt(self, a: Ciphertext) -> Ciphertext:
        """Transform all components (one stacked NTT dispatch)."""
        assert a.domain == "coeff"
        import jax

        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *a.polys)
        spec = ntt.forward(stacked, self.ctx.tables)
        k = a.size
        polys = tuple(
            jax.tree.map(lambda x: x[i], spec) for i in range(k)
        )
        return Ciphertext(polys, "ntt")

    def from_ntt(self, a: Ciphertext) -> Ciphertext:
        assert a.domain == "ntt"
        import jax

        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *a.polys)
        coeff = ntt.inverse(stacked, self.ctx.tables)
        polys = tuple(
            jax.tree.map(lambda x: x[i], coeff) for i in range(a.size)
        )
        return Ciphertext(polys, "coeff")

    def multiply_plain_ntt(self, a: Ciphertext, spectrum) -> Ciphertext:
        """Pointwise ct * plain with both already in the NTT domain."""
        assert a.domain == "ntt"
        m_ntt, m_shoup = spectrum
        p, q2 = self.ctx.prof, self.ctx.tables.q_b(1)
        return Ciphertext(
            tuple(p.mulmod_shoup(c, m_ntt, m_shoup, q2) for c in a.polys),
            "ntt",
        )


def mod_switch_to_next(ctx: BFVContext, ct: Ciphertext):
    """SEAL's Evaluator::mod_switch_to_next: drop the last RNS prime,
    x -> round(x / q_last) per component (either residue profile).

    BFV's invariant scaling Delta = q/t survives the divide-and-round (the
    message term round(q m / t) / q_last ~ round(q' m / t)); noise grows by
    ~||s||_1 from rounding. Returns (smaller context, switched ciphertext);
    decrypt with the secret key restricted to the head limbs
    (``restrict_secret_key``)."""
    from .rescale import make_divide_round_last

    L = ctx.L
    assert L >= 2, "nothing left to switch"
    q_last = ctx.moduli[-1].value
    new_ctx = BFVContext.build(
        ctx.parms.with_coeff_modulus(ctx.parms.coeff_modulus[:-1]),
        engine=ctx.tables.engine,
    )
    one_poly = make_divide_round_last(
        new_ctx.tables, new_ctx.moduli, q_last, L
    )
    assert ct.domain == "coeff"
    return new_ctx, Ciphertext(tuple(one_poly(p) for p in ct.polys), "coeff")


def restrict_secret_key(ctx_small: BFVContext, sk):
    """Project a secret key onto a context with fewer (head) limbs."""
    import jax

    from .keys import SecretKey, _shoup

    L = ctx_small.L
    s = jax.tree.map(lambda a: a[..., :L, :], sk.s_ntt)
    return SecretKey(s_ntt=s, s_shoup=_shoup(ctx_small, s))
