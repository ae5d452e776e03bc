"""Additive secret sharing over Z_{2^32} with Beaver-triple multiplication.

The device analogue of ABY's arithmetic sharing (``S_ARITH``): shares are
u32 device arrays, every gate is a vectorized lane op, and whole batches of
circuit instances evaluate in one jit. The dealer plays ABY's OT-based triple
generation (trusted-dealer model).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp

__all__ = ["ArithShare", "BeaverDealer", "share", "reconstruct"]


@jax.tree_util.register_pytree_node_class
@dataclass
class ArithShare:
    """A value x split as x = s0 + s1 (mod 2^32) between two parties."""

    s0: Any
    s1: Any

    def tree_flatten(self):
        return (self.s0, self.s1), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- linear gates (local, no communication) -------------------------

    def __add__(self, other):
        if isinstance(other, ArithShare):
            return ArithShare(self.s0 + other.s0, self.s1 + other.s1)
        return ArithShare(self.s0 + jnp.uint32(other), self.s1)

    def __sub__(self, other):
        if isinstance(other, ArithShare):
            return ArithShare(self.s0 - other.s0, self.s1 - other.s1)
        return ArithShare(self.s0 - jnp.uint32(other), self.s1)

    def __rsub__(self, other):
        return ArithShare(jnp.uint32(other) - self.s0, -self.s1)

    def mul_public(self, c):
        c = jnp.uint32(c)
        return ArithShare(self.s0 * c, self.s1 * c)


def share(x, key) -> ArithShare:
    """Split public/owned values into two uniform shares."""
    x = jnp.asarray(x, jnp.uint32)
    r = jax.random.bits(key, x.shape, jnp.uint32)
    return ArithShare(x - r, r)


def reconstruct(sh: ArithShare):
    return sh.s0 + sh.s1


class BeaverDealer:
    """Generates multiplication triples (a, b, c=ab) as shares."""

    def __init__(self, key):
        self.key = key

    def _next(self):
        self.key, k = jax.random.split(self.key)
        return k

    def triple(self, shape) -> tuple[ArithShare, ArithShare, ArithShare]:
        a = jax.random.bits(self._next(), shape, jnp.uint32)
        b = jax.random.bits(self._next(), shape, jnp.uint32)
        c = a * b
        return (
            share(a, self._next()),
            share(b, self._next()),
            share(c, self._next()),
        )

    def mul(self, x: ArithShare, y: ArithShare) -> ArithShare:
        """Beaver multiplication: opens d = x-a and e = y-b only."""
        shape = jnp.broadcast_shapes(x.s0.shape, y.s0.shape)
        a, b, c = self.triple(shape)
        d = reconstruct(x - a)
        e = reconstruct(y - b)
        return c + b.mul_public(d) + a.mul_public(e) + d * e


def open_for_yao(sh: ArithShare):
    """The A2Y boundary: the value is revealed into the 'garbled' domain.

    (Models ABY's PutA2YGate; comparison gates downstream operate on the
    reconstructed value — see package docstring for the scope rationale.)
    """
    return reconstruct(sh)
