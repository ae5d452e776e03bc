"""Negacyclic NTT/INTT over RNS prime chains, vectorized over u32 lanes.

Design (not a port of SEAL's scalar loops): every butterfly stage is one
whole-array operation over the trailing coefficient axis reshaped to
``[..., L, h, 2, t]``, which XLA maps onto full-width vector ops. Twiddles are
Harvey/Longa-Naehrig bit-reversed psi-power tables with Shoup precomputed
companions, so an NTT multiply is 2 u32 multiplies + 1 mulhi on the m31
profile. The u32-lane design was inherited from the package's first
accelerator target and is kept for now.

Replaces SEAL's ``util::ntt_negacyclic_harvey`` that ultimately
executes every ``Evaluator::multiply_plain`` in the reference protocol
(``/root/reference/src/demo.cc:155-159``).

Layout contract: ``forward`` consumes standard coefficient order and produces
the NTT spectrum in bit-reversed order; ``inverse`` consumes bit-reversed order
and returns standard order. Pointwise products are order-agnostic, so callers
never observe the internal ordering.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .modmath import m31, m62
from .primes import Modulus

ENGINES = ("stage", "four", "four4")

__all__ = ["ENGINES", "NttTables", "build_tables", "forward", "inverse",
           "forward_chunked", "inverse_chunked", "pointwise_mul",
           "negacyclic_polymul", "to_device", "to_numpy"]


def _bitrev(k: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (k & 1)
        k >>= 1
    return r


def _split_u32(vals: np.ndarray | list, nlimb: int):
    """Split python-int/u64 values into little-endian u32 limb arrays."""
    arr = np.asarray(vals, dtype=object)
    out = []
    for i in range(nlimb):
        out.append(np.vectorize(lambda v, s=32 * i: (int(v) >> s) & 0xFFFFFFFF,
                                otypes=[np.uint32])(arr))
    return out


@dataclass
class NttTables:
    """Device-ready tables for one RNS chain at one polynomial degree.

    ``engine`` selects the transform implementation (spectra from different
    engines use different-but-internally-consistent orderings):
      * "stage"       — whole-array butterfly sweeps (XLA, any profile)
      * "four"        — four-step decomposition (jnp, m31 only)
      * "four4"       — four-step with radix-4 fused column sweeps (same
                        tables and output order as "four", bit-identical
                        spectra, ~half the materialized butterfly sweeps)
    """

    n: int
    logn: int
    profile: str  # "m31" | "m62"
    moduli: tuple[Modulus, ...]
    q: Any          # m31: u32 [L]; m62: (lo, hi) each [L]
    mu: Any         # m31: (mu_lo, mu_hi) [L]; m62: ratio limbs (r0, r1, r2)
    w: Any          # psi powers, bit-reversed order, [L, n]
    ws: Any         # Shoup companions of w
    iw: Any         # inverse psi powers, bit-reversed, [L, n]
    iws: Any
    n_inv: Any      # [L]
    n_inv_s: Any
    engine: str = "stage"
    four_step: Any = None  # ntt4.FourStepTables when engine != "stage"

    @property
    def L(self) -> int:
        return len(self.moduli)

    @property
    def prof(self):
        return m31 if self.profile == "m31" else m62

    def q_b(self, extra_dims: int):
        """q broadcast-shaped for activations [..., L, <extra_dims>]."""
        idx = (slice(None),) + (None,) * extra_dims
        return jax.tree.map(lambda a: a[idx], self.q)

    def mu_b(self, extra_dims: int):
        idx = (slice(None),) + (None,) * extra_dims
        return jax.tree.map(lambda a: a[idx], self.mu)


def build_tables(
    moduli: Sequence[Modulus], n: int, engine: str = "stage"
) -> NttTables:
    """Build forward/inverse twiddle tables for a chain of NTT-friendly primes."""
    if engine not in ENGINES:
        raise ValueError(f"unknown NTT engine {engine!r}; expected one of {ENGINES}")
    logn = n.bit_length() - 1
    assert 1 << logn == n
    profile = "m31" if all(m.value < (1 << 30) for m in moduli) else "m62"
    if profile == "m62":
        # Barrett ratio floor(2^128/q) must fit 3 u32 limbs (q >= 2^32), and
        # 2q < 2^63 for wrap-free conditional subtracts.
        assert all(1 << 32 <= m.value < 1 << 62 for m in moduli), (
            "m62 profile requires all primes in [2^32, 2^62); do not mix "
            "sub-30-bit primes into a wide chain"
        )
    nlimb = 1 if profile == "m31" else 2
    shoup_bits = 32 if profile == "m31" else 64

    brv = [_bitrev(k, logn) for k in range(n)]
    w_rows, ws_rows, iw_rows, iws_rows = [], [], [], []
    n_inv_l, n_inv_s_l, q_l, mu_l = [], [], [], []
    for mod in moduli:
        q = mod.value
        assert (q - 1) % (2 * n) == 0, "prime not NTT-friendly for this n"
        psi = mod.minimal_primitive_root(2 * n)
        psi_inv = pow(psi, -1, q)
        pw, ipw = [1] * n, [1] * n
        for k in range(1, n):
            pw[k] = pw[k - 1] * psi % q
            ipw[k] = ipw[k - 1] * psi_inv % q
        w_row = [pw[brv[k]] for k in range(n)]
        iw_row = [ipw[brv[k]] for k in range(n)]
        w_rows.append(w_row)
        iw_rows.append(iw_row)
        ws_rows.append([mod.shoup(v, shoup_bits) for v in w_row])
        iws_rows.append([mod.shoup(v, shoup_bits) for v in iw_row])
        ninv = pow(n, -1, q)
        n_inv_l.append(ninv)
        n_inv_s_l.append(mod.shoup(ninv, shoup_bits))
        q_l.append(q)
        if profile == "m31":
            mu_l.append(mod.mu64)
        else:
            mu_l.append(mod.const_ratio)

    def pack(vals, limbs=nlimb):
        parts = [jnp.asarray(p) for p in _split_u32(vals, limbs)]
        return parts[0] if limbs == 1 else tuple(parts)

    four_step = None
    if engine != "stage":
        assert profile == "m31", "four-step engines require the m31 profile"
        from . import ntt4

        four_step = ntt4.build_tables4(moduli, n)
    return NttTables(
        n=n,
        logn=logn,
        profile=profile,
        moduli=tuple(moduli),
        q=pack(q_l),
        mu=tuple(jnp.asarray(p) for p in _split_u32(mu_l, 2 if profile == "m31" else 3)),
        w=pack(w_rows),
        ws=pack(ws_rows),
        iw=pack(iw_rows),
        iws=pack(iws_rows),
        n_inv=pack(n_inv_l),
        n_inv_s=pack(n_inv_s_l),
        engine=engine,
        four_step=four_step,
    )


def _double(q):
    """2q for either residue profile (m62 pairs carry into the high limb)."""
    if isinstance(q, tuple):
        return m62._add_raw(q, q)
    return q * 2


def _view(x, h: int, t: int):
    """Reshape trailing coeff axis n -> (h, 2, t)."""
    return jax.tree.map(lambda a: a.reshape(a.shape[:-1] + (h, 2, t)), x)


def _flat(x, n: int):
    return jax.tree.map(lambda a: a.reshape(a.shape[:-3] + (n,)), x)


def _half(x, which: int):
    return jax.tree.map(lambda a: a[..., which, :], x)


def _stack(u, v):
    return jax.tree.map(lambda a, b: jnp.stack([a, b], axis=-2), u, v)


def _slice_tbl(tbl, lo: int, hi: int):
    """tbl [L, n] -> [L, hi-lo, 1] for broadcasting against [..., L, h, t]."""
    return jax.tree.map(lambda a: a[:, lo:hi, None], tbl)


def forward(x, tb: NttTables):
    """Negacyclic NTT along the trailing axis. x: [..., L, n] residues."""
    if tb.engine in ("four", "four4"):
        from . import ntt4

        return ntt4.forward4(x, tb.four_step, radix4=tb.engine == "four4")
    p = tb.prof
    n = tb.n
    q3 = tb.q_b(2)
    two_q = _double(q3)
    h, t = 1, n
    for _ in range(tb.logn):
        t //= 2
        xv = _view(x, h, t)
        u = _half(xv, 0)
        v = _half(xv, 1)
        w = _slice_tbl(tb.w, h, 2 * h)
        ws = _slice_tbl(tb.ws, h, 2 * h)
        # Harvey lazy CT: u < 4q -> [0,2q); outputs < 4q; canonical at end.
        u = p.csub2q(u, two_q)
        mv = p.mulmod_shoup_lazy(v, w, ws, q3)
        x = _flat(_stack(p.lazy_add(u, mv), p.lazy_sub2q(u, mv, two_q)), n)
        h *= 2
    q2 = tb.q_b(1)
    return p.csub(p.csub2q(x, _double(q2)), q2)


def inverse(x, tb: NttTables):
    """Inverse negacyclic NTT (consumes forward's output order)."""
    if tb.engine in ("four", "four4"):
        from . import ntt4

        return ntt4.inverse4(x, tb.four_step, radix4=tb.engine == "four4")
    p = tb.prof
    n = tb.n
    q3 = tb.q_b(2)
    two_q = _double(q3)
    h, t = n // 2, 1
    for _ in range(tb.logn):
        xv = _view(x, h, t)
        u = _half(xv, 0)
        v = _half(xv, 1)
        w = _slice_tbl(tb.iw, h, 2 * h)
        ws = _slice_tbl(tb.iws, h, 2 * h)
        # Harvey lazy GS: inputs/outputs < 2q; canonical via the n^{-1} mul.
        s = p.csub2q(p.lazy_add(u, v), two_q)
        d = p.mulmod_shoup_lazy(p.lazy_sub2q(u, v, two_q), w, ws, q3)
        x = _flat(_stack(s, d), n)
        h //= 2
        t *= 2
    # Scale by n^{-1} (full Shoup reduction restores canonical residues).
    q2 = tb.q_b(1)
    ninv = jax.tree.map(lambda a: a[:, None], tb.n_inv)
    ninv_s = jax.tree.map(lambda a: a[:, None], tb.n_inv_s)
    return p.mulmod_shoup(x, ninv, ninv_s, q2)


def _map_chunks(fn, x, chunk: int):
    leaves = jax.tree.leaves(x)
    b = leaves[0].shape[0]
    if b <= chunk or b % chunk:
        return fn(x)
    xc = jax.tree.map(
        lambda a: a.reshape(b // chunk, chunk, *a.shape[1:]), x
    )
    out = jax.lax.map(fn, xc)
    return jax.tree.map(lambda a: a.reshape(b, *a.shape[2:]), out)


def forward_chunked(x, tb: NttTables, chunk: int = 1024):
    """Big-batch forward NTT: ``lax.map`` over ``chunk``-row blocks inside
    one jit. On the first accelerator target the monolithic [10240, 3, 8192]
    graph lost a large share of the per-element rate of the batch-1024 shape
    (working-set locality: the four-step transposes of a >1 GB array), and
    mapping chunk-sized blocks recovered it; on the GPU this is not measured
    yet. Falls through to :func:`forward` when the batch is small or not
    divisible."""
    return _map_chunks(lambda c: forward(c, tb), x, chunk)


def inverse_chunked(x, tb: NttTables, chunk: int = 1024):
    """Big-batch inverse NTT; see :func:`forward_chunked`."""
    return _map_chunks(lambda c: inverse(c, tb), x, chunk)


def pointwise_mul(a, b, tb: NttTables):
    """General residue-wise product (both operands variable): Barrett path."""
    p = tb.prof
    q2 = tb.q_b(1)
    mu2 = tuple(m[:, None] for m in tb.mu)
    if tb.profile == "m31":
        return p.mulmod(a, b, q2, mu2[0], mu2[1])
    return p.mulmod(a, b, q2, mu2)


def negacyclic_polymul(a, b, tb: NttTables):
    """c = a * b mod (x^n + 1) mod q_i, coefficient order in and out."""
    return inverse(pointwise_mul(forward(a, tb), forward(b, tb), tb), tb)


def to_device(coeffs: np.ndarray, tb: NttTables):
    """Host residue matrix [L, n] (python ints / uint64) -> device value."""
    limbs = _split_u32(coeffs, 1 if tb.profile == "m31" else 2)
    parts = [jnp.asarray(p) for p in limbs]
    return parts[0] if tb.profile == "m31" else tuple(parts)


def to_numpy(x, tb: NttTables) -> np.ndarray:
    """Device value -> host object-int residue array."""
    if tb.profile == "m31":
        return np.asarray(jax.device_get(x), dtype=np.uint64)
    lo, hi = (np.asarray(jax.device_get(p), dtype=np.uint64) for p in x)
    return lo | (hi << np.uint64(32))
