"""Jitted protocol stages: one compiled graph per stage per context.

The protocol roles (roles.py) are written over the eager BFV API; on an
accelerator every eager op is a separate dispatch through the runtime, and a
full protocol run issues thousands of them, so dispatch latency, not compute,
dominates. These wrappers trace each protocol stage ONCE per
(context, shapes) and take all radius/key-dependent values (public key,
blinding plaintexts, secret key) as runtime arguments, so every radius of a
sweep reuses the same executable and a stage is a single dispatch.

The reference gets this for free: SEAL's C++ Evaluator runs at native speed
per call (/root/reference/src/server.cc:122-133). This module is the
accelerator equivalent: XLA-compiled stage graphs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..bfv.ciphertext import Ciphertext
from ..bfv.context import BFVContext
from ..bfv.decryptor import Decryptor
from ..bfv.encryptor import Encryptor
from ..bfv.evaluator import Evaluator
from ..bfv.keys import PublicKey, SecretKey, _shoup
from ..ops import ntt

__all__ = [
    "keygen_fn",
    "encrypt_batch_fn",
    "blind_distance_fn",
    "ct_value_fn",
    "make_secret_key",
    "make_public_key",
]


@functools.lru_cache(maxsize=8)
def keygen_fn(ctx: BFVContext):
    """key -> (s_ntt, s_shoup, pk0_ntt, pk1_ntt, pk0_shoup, pk1_shoup)."""
    from ..bfv import sampling

    def f(key):
        key_s, key_pk = jax.random.split(key)
        p, q2 = ctx.prof, ctx.tables.q_b(1)
        s = sampling.ternary_poly(key_s, ctx)
        s_ntt = ntt.forward(s, ctx.tables)
        s_shoup = _shoup(ctx, s_ntt)
        key_a, key_e = jax.random.split(key_pk)
        a_ntt = sampling.uniform_rq(key_a, ctx)
        e = sampling.cbd_poly(key_e, ctx)
        e_ntt = ntt.forward(e, ctx.tables)
        a_s = p.mulmod_shoup(a_ntt, s_ntt, s_shoup, q2)
        pk0 = p.neg(p.add(a_s, e_ntt, q2), q2)
        return s_ntt, s_shoup, pk0, a_ntt, _shoup(ctx, pk0), _shoup(ctx, a_ntt)

    return jax.jit(f)


def make_secret_key(out) -> SecretKey:
    return SecretKey(s_ntt=out[0], s_shoup=out[1])


def make_public_key(out) -> PublicKey:
    return PublicKey(
        pk0_ntt=out[2], pk1_ntt=out[3], pk0_shoup=out[4], pk1_shoup=out[5]
    )


@functools.lru_cache(maxsize=8)
def encrypt_batch_fn(ctx: BFVContext):
    """(pk arrays, m_lo [B, n], m_hi [B, n], keys [B]) -> (c0, c1) [B, L, n].

    One traced graph encrypts the protocol's whole message batch (u, 2xa,
    2ya -> B=3). Each row uses its own PRNG key, reproducing the eager
    per-message encrypt chain bit-for-bit (golden transcripts must not move).
    """

    def f(pk0_ntt, pk1_ntt, pk0_shoup, pk1_shoup, m_lo, m_hi, keys):
        pk = PublicKey(pk0_ntt, pk1_ntt, pk0_shoup, pk1_shoup)
        enc = Encryptor(ctx, pk)
        B = m_lo.shape[0]
        parts = [enc.encrypt_pairs(m_lo[i], m_hi[i], keys[i]).polys
                 for i in range(B)]
        # Leading batch axis on every leaf (m62 polys are (lo, hi) trees).
        return jax.tree.map(lambda *xs: jnp.stack(xs), *parts)

    return jax.jit(f)


@functools.lru_cache(maxsize=8)
def blind_distance_fn(ctx: BFVContext):
    """Homomorphic blind distance as ONE graph (demo.cc:148-160 sequence).

    Plaintext operands arrive as (lo, hi) u32 coefficient arrays so new
    blinding values / coordinates never retrace.

    NTT-domain chained: each ciphertext transforms ONCE (a single stacked
    forward dispatch for all six component polys), the whole expression
    s*(c1 + z - (c2*xb + c3*yb)) combines pointwise in the spectrum, and one
    stacked inverse brings the result back — 11 poly-transforms per call vs
    15 for the op-by-op chain (and 3 dispatches vs 15). The NTT is a ring
    isomorphism and every op is exact modular arithmetic, so outputs are
    bit-identical to the coefficient-domain sequence (golden transcripts
    pinned in tests/test_golden.py must not move).
    """

    def f(c1p, c2p, c3p, z, xb, yb, s, sr):
        ev = Evaluator(ctx)
        c1 = ev.add_plain(Ciphertext(tuple(c1p), "coeff"), z)
        c2 = Ciphertext(tuple(c2p), "coeff")
        c3 = Ciphertext(tuple(c3p), "coeff")
        # One stacked forward NTT for all six component polynomials.
        all_polys = c1.polys + c2.polys + c3.polys
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *all_polys)
        spec = ntt.forward(stacked, ctx.tables)
        comp = lambda i: jax.tree.map(lambda x: x[i], spec)
        c1s = Ciphertext((comp(0), comp(1)), "ntt")
        c2s = Ciphertext((comp(2), comp(3)), "ntt")
        c3s = Ciphertext((comp(4), comp(5)), "ntt")
        xb_s = ev.plain_spectrum(xb)
        yb_s = ev.plain_spectrum(yb)
        s_s = ev.plain_spectrum(s)
        acc = ev.sub(
            c1s,
            ev.add(ev.multiply_plain_ntt(c2s, xb_s),
                   ev.multiply_plain_ntt(c3s, yb_s)),
        )
        out = ev.from_ntt(ev.multiply_plain_ntt(acc, s_s))
        return ev.add_plain(out, sr).polys

    return jax.jit(f)


@functools.lru_cache(maxsize=8)
def ct_value_fn(ctx: BFVContext):
    """(s_ntt, s_shoup, ct polys) -> RNS residues of c0 + c1*s (+...)."""

    def f(s_ntt, s_shoup, polys):
        dec = Decryptor(ctx, SecretKey(s_ntt, s_shoup))
        return dec.ct_value_rns(Ciphertext(tuple(polys), "coeff"))

    return jax.jit(f)


def plain_pair(value: int, t: int, n: int):
    """Hex-encoded plaintext (lo, hi) pair arrays for ``value`` mod t."""
    from ..bfv.plaintext import Plaintext
    from ..utils.hexcodec import uint64_to_hex_string

    lo, hi = Plaintext(uint64_to_hex_string(value % t), n=n).pair_u32(n)
    return jnp.asarray(lo), jnp.asarray(hi)
