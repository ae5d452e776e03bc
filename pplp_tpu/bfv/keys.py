"""Key generation: ternary secret, RLWE public key (NTT domain).

The analogue of SEAL's ``KeyGenerator`` / ``create_public_key`` used at
``/root/reference/src/demo.cc:81-85``. Keys are held in NTT domain with Shoup
companions so every key multiply in encrypt/decrypt is the 3-multiply fast
path on 32-bit lanes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax

from ..ops import ntt
from . import sampling
from .context import BFVContext

__all__ = ["SecretKey", "PublicKey", "KeyGenerator", "make_sk_pk_jit"]


def _shoup(ctx: BFVContext, w):
    p = ctx.prof
    tb = ctx.tables
    if tb.profile == "m31":
        return p.shoup_precompute(w, tb.q[:, None], tb.mu[0][:, None], tb.mu[1][:, None])
    q = jax.tree.map(lambda a: a[:, None], tb.q)
    ratio = tuple(m[:, None] for m in tb.mu)
    return p.shoup_precompute(w, q, ratio)


@dataclass
class SecretKey:
    s_ntt: Any
    s_shoup: Any


@dataclass
class PublicKey:
    pk0_ntt: Any
    pk1_ntt: Any
    pk0_shoup: Any
    pk1_shoup: Any


class KeyGenerator:
    """Deterministic given an explicit PRNG key (reproducibility hook)."""

    def __init__(self, ctx: BFVContext, key):
        if isinstance(key, int):
            key = jax.random.key(key)
        self.ctx = ctx
        self._key_s, self._key_pk = jax.random.split(key)
        self._sk: SecretKey | None = None

    def secret_key(self) -> SecretKey:
        if self._sk is None:
            ctx = self.ctx
            s = sampling.ternary_poly(self._key_s, ctx)
            s_ntt = ntt.forward(s, ctx.tables)
            self._sk = SecretKey(s_ntt=s_ntt, s_shoup=_shoup(ctx, s_ntt))
        return self._sk

    def create_public_key(self) -> PublicKey:
        ctx = self.ctx
        sk = self.secret_key()
        key_a, key_e = jax.random.split(self._key_pk)
        p = ctx.prof
        q2 = ctx.tables.q_b(1)
        # Uniform a is sampled directly in NTT domain (uniformity is invariant).
        a_ntt = sampling.uniform_rq(key_a, ctx)
        e = sampling.cbd_poly(key_e, ctx)
        e_ntt = ntt.forward(e, ctx.tables)
        a_s = p.mulmod_shoup(a_ntt, sk.s_ntt, sk.s_shoup, q2)
        pk0 = p.neg(p.add(a_s, e_ntt, q2), q2)
        return PublicKey(
            pk0_ntt=pk0,
            pk1_ntt=a_ntt,
            pk0_shoup=_shoup(ctx, pk0),
            pk1_shoup=_shoup(ctx, a_ntt),
        )


def make_sk_pk_jit(ctx: BFVContext, key):
    """(SecretKey, PublicKey) generated under ONE compiled graph.

    Eager ``KeyGenerator`` issues dozens of separate dispatches, each with
    its own fixed cost; one jit makes it one. Same discipline as
    ``behz.make_keys_jit`` (sk+rlk)."""
    if isinstance(key, int):
        key = jax.random.key(key)

    def f(k):
        kg = KeyGenerator(ctx, k)
        sk = kg.secret_key()
        pk = kg.create_public_key()
        return (
            (sk.s_ntt, sk.s_shoup),
            (pk.pk0_ntt, pk.pk1_ntt, pk.pk0_shoup, pk.pk1_shoup),
        )

    (s_ntt, s_shoup), (pk0, pk1, pk0s, pk1s) = jax.jit(f)(key)
    return (
        SecretKey(s_ntt=s_ntt, s_shoup=s_shoup),
        PublicKey(pk0_ntt=pk0, pk1_ntt=pk1, pk0_shoup=pk0s, pk1_shoup=pk1s),
    )
