"""Four-step negacyclic NTT: the production transform decomposition.

Splits the length-n transform into n = C1 x C2 (C2 = vector lane width 128):

  step A: length-C1 *negacyclic* NTTs down the C1 axis (root psi^C2), lanes
          carry the C2 axis — every butterfly reshape touches only leading
          dims, so the data never leaves its lane;
  step B: elementwise twiddle T[p1, j2] = psi^{j2*(2*brv(p1)+1)};
  step C: transpose, then length-C2 *cyclic* NTTs (root omega^C1 = psi^{2C1})
          down the C2 axis (Gentleman-Sande DIF, position-varying twiddles).

Output order is an internal bijection (digit-transposed, bit-reversed per
digit); ``inverse4`` mirrors it exactly, and pointwise products only ever pair
like-ordered spectra. The layout (a 128-wide axis that no butterfly splits)
was inherited from the package's first accelerator target and is kept for
now.

Cites: replaces the role of SEAL's ntt_negacyclic_harvey (see ntt.py) with
whole-array butterflies rather than scalar ones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .modmath import m31
from .primes import Modulus

__all__ = ["FourStepTables", "build_tables4", "forward4", "inverse4", "C2"]

C2 = 128
_LOG_C2 = 7


def _bitrev(k: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (k & 1)
        k >>= 1
    return r


@dataclass
class FourStepTables:
    n: int
    c1: int
    logc1: int
    moduli: tuple[Modulus, ...]
    q: Any            # u32 [L]
    mu: Any           # (lo, hi) [L]
    # Step A (negacyclic C1, Harvey layout) + inverses:
    w1: Any           # [L, C1]
    w1s: Any
    iw1: Any
    iw1s: Any
    # Step B twiddle matrix (+inverse, inverse includes 1/n scale):
    tw: Any           # [L, C1, C2]
    tws: Any
    itw: Any
    itws: Any
    # Step C cyclic C2 stage tables, packed [L, LOG_C2, C2//2]:
    wc: Any
    wcs: Any
    iwc: Any
    iwcs: Any

    @property
    def L(self):
        return len(self.moduli)


def build_tables4(moduli: Sequence[Modulus], n: int) -> FourStepTables:
    assert n % C2 == 0 and n >= 2 * C2
    c1 = n // C2
    logc1 = c1.bit_length() - 1
    assert 1 << logc1 == c1
    for m in moduli:
        assert m.value < (1 << 30), "four-step engine is m31-profile only"
        assert (m.value - 1) % (2 * n) == 0

    w1_l, w1s_l, iw1_l, iw1s_l = [], [], [], []
    tw_l, tws_l, itw_l, itws_l = [], [], [], []
    wc_l, wcs_l, iwc_l, iwcs_l = [], [], [], []
    q_l, mu_lo, mu_hi = [], [], []

    for mod in moduli:
        q = mod.value
        psi = mod.minimal_primitive_root(2 * n)
        psi_inv = pow(psi, -1, q)
        # Step A tables: negacyclic C1 with psi1 = psi^C2 (order 2*C1).
        psi1 = pow(psi, C2, q)
        psi1_inv = pow(psi_inv, C2, q)
        brv1 = [_bitrev(k, logc1) for k in range(c1)]
        pw = [1] * c1
        ipw = [1] * c1
        for k in range(1, c1):
            pw[k] = pw[k - 1] * psi1 % q
            ipw[k] = ipw[k - 1] * psi1_inv % q
        w1 = [pw[brv1[k]] for k in range(c1)]
        iw1 = [ipw[brv1[k]] for k in range(c1)]
        # Step B: T[p1, j2] = psi^{j2*(2*brv(p1)+1)}.
        tw = [[pow(psi, j2 * (2 * brv1[p1] + 1), q) for j2 in range(C2)]
              for p1 in range(c1)]
        # Inverse twiddle includes the global 1/n scale.
        n_inv = pow(n, -1, q)
        itw = [[pow(psi_inv, j2 * (2 * brv1[p1] + 1), q) * n_inv % q
                for j2 in range(C2)] for p1 in range(c1)]
        # Step C: cyclic C2 GS stages. omega_c = psi^{2*c1} has order C2.
        om = pow(psi, 2 * c1, q)
        om_inv = pow(psi_inv, 2 * c1, q)
        wc = np.ones((_LOG_C2, C2 // 2), dtype=object)
        iwc = np.ones((_LOG_C2, C2 // 2), dtype=object)
        t = C2 // 2
        for s in range(_LOG_C2):
            stride = C2 // (2 * t)  # omega exponent step for this stage
            for jt in range(t):
                wc[s, jt] = pow(om, jt * stride, q)
                iwc[s, jt] = pow(om_inv, jt * stride, q)
            t //= 2

        sh = lambda v: mod.shoup(int(v), 32)
        w1_l.append(w1)
        w1s_l.append([sh(v) for v in w1])
        iw1_l.append(iw1)
        iw1s_l.append([sh(v) for v in iw1])
        tw_l.append(tw)
        tws_l.append([[sh(v) for v in row] for row in tw])
        itw_l.append(itw)
        itws_l.append([[sh(v) for v in row] for row in itw])
        wc_l.append(wc.tolist())
        wcs_l.append([[sh(v) for v in row] for row in wc.tolist()])
        iwc_l.append(iwc.tolist())
        iwcs_l.append([[sh(v) for v in row] for row in iwc.tolist()])
        q_l.append(q)
        mu_lo.append(mod.mu64 & 0xFFFFFFFF)
        mu_hi.append(mod.mu64 >> 32)

    u32 = lambda v: jnp.asarray(np.asarray(v, dtype=np.uint32))
    return FourStepTables(
        n=n, c1=c1, logc1=logc1, moduli=tuple(moduli),
        q=u32(q_l), mu=(u32(mu_lo), u32(mu_hi)),
        w1=u32(w1_l), w1s=u32(w1s_l), iw1=u32(iw1_l), iw1s=u32(iw1s_l),
        tw=u32(tw_l), tws=u32(tws_l), itw=u32(itw_l), itws=u32(itws_l),
        wc=u32(wc_l), wcs=u32(wcs_l), iwc=u32(iwc_l), iwcs=u32(iwcs_l),
    )


# ---------------------------------------------------------------------------
# Core column transforms. Shapes: x is [..., G, C1, C2] where G is a "groups"
# axis (RNS limbs, or limbs x batch inside the Pallas kernel); each table has
# a leading G axis and q broadcasts as [G, 1, 1]. Used by both the jnp path
# and the fused Pallas kernel.
#
# Each has a radix-4 variant (suffix _r4) fusing two butterfly levels into
# one materialized sweep: identical multiplies in identical order (outputs
# are bit-identical to the radix-2 loops — pinned in tests/test_ntt4.py),
# but ~half the whole-array reshape/stack sweeps, which is what the
# XLA-compiled transform was bound by on the first accelerator target.
# ---------------------------------------------------------------------------


def _ntt_col_negacyclic(x, w1, w1s, q3, logc1):
    """CT-DIT negacyclic NTT along axis -2, Harvey lazy form.

    Inputs < 4q, outputs < 4q (one conditional per butterfly: u -> [0, 2q));
    the caller canonicalizes at the end. Twiddles per group."""
    c1 = x.shape[-2]
    lanes = x.shape[-1]
    h, t = 1, c1
    for _ in range(logc1):
        t //= 2
        xv = x.reshape(x.shape[:-2] + (h, 2, t, lanes))
        u = xv[..., 0, :, :]
        v = xv[..., 1, :, :]
        w = w1[:, h : 2 * h][:, :, None, None]
        ws = w1s[:, h : 2 * h][:, :, None, None]
        q = q3[..., None]
        u = m31.csub2q(u, q * 2)
        mv = m31.mulmod_shoup_lazy(v, w, ws, q)  # < 2q
        x = jnp.stack([u + mv, u - mv + q * 2], axis=-3)
        x = x.reshape(x.shape[:-4] + (c1, lanes))
        h *= 2
    return x


def _intt_col_negacyclic(x, iw1, iw1s, q3, logc1):
    """GS-DIF inverse along axis -2, Harvey lazy (inputs/outputs < 2q;
    no final scale — folded into step B)."""
    c1 = x.shape[-2]
    lanes = x.shape[-1]
    h, t = c1 // 2, 1
    for _ in range(logc1):
        xv = x.reshape(x.shape[:-2] + (h, 2, t, lanes))
        u = xv[..., 0, :, :]
        v = xv[..., 1, :, :]
        w = iw1[:, h : 2 * h][:, :, None, None]
        ws = iw1s[:, h : 2 * h][:, :, None, None]
        q = q3[..., None]
        s = m31.csub2q(u + v, q * 2)
        d = m31.mulmod_shoup_lazy(u - v + q * 2, w, ws, q)
        x = jnp.stack([s, d], axis=-3).reshape(x.shape[:-2] + (c1, lanes))
        h //= 2
        t *= 2
    return x


def _ntt_col_cyclic_gs(x, wc, wcs, q3):
    """GS-DIF cyclic NTT along axis -2, Harvey lazy (< 2q stable).

    Input natural order, output bit-reversed positions.
    """
    lanes = x.shape[-1]
    t = C2 // 2
    for s in range(_LOG_C2):
        m = C2 // (2 * t)
        xv = x.reshape(x.shape[:-2] + (m, 2, t, lanes))
        u = xv[..., 0, :, :]
        v = xv[..., 1, :, :]
        w = wc[:, s, :t][:, None, :, None]
        ws = wcs[:, s, :t][:, None, :, None]
        q = q3[..., None]
        a = m31.csub2q(u + v, q * 2)
        b = m31.mulmod_shoup_lazy(u - v + q * 2, w, ws, q)
        x = jnp.stack([a, b], axis=-3).reshape(x.shape[:-2] + (C2, lanes))
        t //= 2
    return x


def _intt_col_cyclic_ct(x, iwc, iwcs, q3):
    """CT-DIT inverse cyclic along axis -2, Harvey lazy (< 4q tolerant)."""
    lanes = x.shape[-1]
    t = 1
    for s in range(_LOG_C2 - 1, -1, -1):
        m = C2 // (2 * t)
        xv = x.reshape(x.shape[:-2] + (m, 2, t, lanes))
        u = xv[..., 0, :, :]
        v = xv[..., 1, :, :]
        w = iwc[:, s, :t][:, None, :, None]
        ws = iwcs[:, s, :t][:, None, :, None]
        q = q3[..., None]
        u = m31.csub2q(u, q * 2)
        mv = m31.mulmod_shoup_lazy(v, w, ws, q)
        x = jnp.stack([u + mv, u - mv + q * 2], axis=-3)
        x = x.reshape(x.shape[:-4] + (C2, lanes))
        t *= 2
    return x


def _ntt_col_negacyclic_r4(x, w1, w1s, q3, logc1):
    """Radix-4 CT-DIT: two butterfly levels per sweep (odd tail radix-2).

    Per fused sweep over view [..., h, 2(i), 2(j), t2, lanes]:
    stage h pairs over i with twiddle w[h+b]; stage 2h pairs over j with
    twiddle w[2h+2b+i]. Same ops, same order as two radix-2 sweeps."""
    c1 = x.shape[-2]
    lanes = x.shape[-1]
    h, t = 1, c1
    stages = logc1
    while stages >= 2:
        t //= 4
        xv = x.reshape(x.shape[:-2] + (h, 2, 2, t, lanes))
        u = xv[..., 0, :, :, :]
        v = xv[..., 1, :, :, :]
        wa = w1[:, h : 2 * h][:, :, None, None, None]
        was = w1s[:, h : 2 * h][:, :, None, None, None]
        # stage-2h twiddles w[2h + 2b + i], split by i parity:
        w2 = w1[:, 2 * h : 4 * h].reshape(w1.shape[0], h, 2)
        w2s = w1s[:, 2 * h : 4 * h].reshape(w1.shape[0], h, 2)
        q = q3[..., None, None]
        u = m31.csub2q(u, q * 2)
        mv = m31.mulmod_shoup_lazy(v, wa, was, q)
        y0 = u + mv                # i = 0 branch, < 4q
        y1 = u - mv + q * 2        # i = 1 branch, < 4q

        def s2(y, i):
            a = y[..., 0, :, :]
            b = y[..., 1, :, :]
            wi = w2[:, :, i][:, :, None, None]
            wis = w2s[:, :, i][:, :, None, None]
            a = m31.csub2q(a, q3[..., None] * 2)
            mb = m31.mulmod_shoup_lazy(b, wi, wis, q3[..., None])
            return jnp.stack([a + mb, a - mb + q3[..., None] * 2], axis=-3)

        x = jnp.stack([s2(y0, 0), s2(y1, 1)], axis=-4)
        x = x.reshape(x.shape[:-5] + (c1, lanes))
        h *= 4
        stages -= 2
    if stages:  # odd log: one radix-2 tail stage
        t //= 2
        xv = x.reshape(x.shape[:-2] + (h, 2, t, lanes))
        u = xv[..., 0, :, :]
        v = xv[..., 1, :, :]
        w = w1[:, h : 2 * h][:, :, None, None]
        ws = w1s[:, h : 2 * h][:, :, None, None]
        q = q3[..., None]
        u = m31.csub2q(u, q * 2)
        mv = m31.mulmod_shoup_lazy(v, w, ws, q)
        x = jnp.stack([u + mv, u - mv + q * 2], axis=-3)
        x = x.reshape(x.shape[:-4] + (c1, lanes))
    return x


def _intt_col_negacyclic_r4(x, iw1, iw1s, q3, logc1):
    """Radix-4 GS-DIF inverse over the C1 axis (two levels per sweep).

    Fused view [..., h/2, 2(x'), 2(y'), t, lanes]: stage h butterflies over
    y' (block 2b+x', twiddle iw[h+2b+x']); stage h/2 butterflies over x'
    (twiddle iw[h/2+b])."""
    c1 = x.shape[-2]
    lanes = x.shape[-1]
    h, t = c1 // 2, 1
    stages = logc1
    while stages >= 2:
        # View axes: [..., h/2 (b2), 2 (x'), 2 (y'), t, lanes]; flat c1
        # index = b2*4t + x'*2t + y'*t + k. Stage h butterflies over y'
        # (block 2b2+x'); stage h/2 butterflies over x' (block b2).
        xv = x.reshape(x.shape[:-2] + (h // 2, 2, 2, t, lanes))
        q = q3[..., None, None]
        u = xv[..., 0, :, :]   # y' = 0 -> [..., h/2, 2(x'), t, lanes]
        v = xv[..., 1, :, :]   # y' = 1
        w1v = iw1[:, h : 2 * h].reshape(iw1.shape[0], h // 2, 2)
        w1vs = iw1s[:, h : 2 * h].reshape(iw1.shape[0], h // 2, 2)
        wa = w1v[:, :, :, None, None]
        was = w1vs[:, :, :, None, None]
        y0 = m31.csub2q(u + v, q * 2)
        y1 = m31.mulmod_shoup_lazy(u - v + q * 2, wa, was, q)
        # stage h/2: butterfly over x' axis (-3) with twiddle iw[h/2 + b2].
        w2 = iw1[:, h // 2 : h][:, :, None, None]
        w2s = iw1s[:, h // 2 : h][:, :, None, None]

        def s2(y):
            p = y[..., 0, :, :]  # x' = 0 -> [..., h/2, t, lanes]
            r = y[..., 1, :, :]  # x' = 1
            a = m31.csub2q(p + r, q3[..., None] * 2)
            b = m31.mulmod_shoup_lazy(p - r + q3[..., None] * 2, w2, w2s,
                                      q3[..., None])
            return jnp.stack([a, b], axis=-3)  # [..., h/2, 2(br2), t, lanes]

        # Final layout (b2, br2, y', k): br2 replaces x', y' stays in place.
        x = jnp.stack([s2(y0), s2(y1)], axis=-3)
        x = x.reshape(x.shape[:-5] + (c1, lanes))
        h //= 4
        t *= 4
        stages -= 2
    if stages:
        xv = x.reshape(x.shape[:-2] + (h, 2, t, lanes))
        u = xv[..., 0, :, :]
        v = xv[..., 1, :, :]
        w = iw1[:, h : 2 * h][:, :, None, None]
        ws = iw1s[:, h : 2 * h][:, :, None, None]
        q = q3[..., None]
        s = m31.csub2q(u + v, q * 2)
        d = m31.mulmod_shoup_lazy(u - v + q * 2, w, ws, q)
        x = jnp.stack([s, d], axis=-3).reshape(x.shape[:-2] + (c1, lanes))
    return x


def _ntt_col_cyclic_gs_r4(x, wc, wcs, q3):
    """Radix-4 GS-DIF cyclic over the C2 axis (two stages per sweep).

    Fused view [..., m, 2(op1), 2(op2), t2, lanes]: stage s butterflies
    over op1 (twiddle wc[s][op2*t2+k]); stage s+1 over op2 (wc[s+1][k])."""
    lanes = x.shape[-1]
    t = C2 // 2
    s = 0
    while s + 2 <= _LOG_C2:
        m = C2 // (2 * t)
        t2 = t // 2
        xv = x.reshape(x.shape[:-2] + (m, 2, 2, t2, lanes))
        q = q3[..., None, None]
        u = xv[..., 0, :, :, :]
        v = xv[..., 1, :, :, :]
        w1v = wc[:, s, :t].reshape(wc.shape[0], 2, t2)[:, None, :, :, None]
        w1vs = wcs[:, s, :t].reshape(wcs.shape[0], 2, t2)[:, None, :, :, None]
        ya = m31.csub2q(u + v, q * 2)
        yb = m31.mulmod_shoup_lazy(u - v + q * 2, w1v, w1vs, q)
        w2 = wc[:, s + 1, :t2][:, None, :, None]
        w2s = wcs[:, s + 1, :t2][:, None, :, None]

        def s2(y):
            p = y[..., 0, :, :]
            r = y[..., 1, :, :]
            a = m31.csub2q(p + r, q3[..., None] * 2)
            b = m31.mulmod_shoup_lazy(p - r + q3[..., None] * 2, w2, w2s,
                                      q3[..., None])
            return jnp.stack([a, b], axis=-3)

        x = jnp.stack([s2(ya), s2(yb)], axis=-4)
        x = x.reshape(x.shape[:-5] + (C2, lanes))
        t //= 4
        s += 2
    if s < _LOG_C2:
        m = C2 // (2 * t)
        xv = x.reshape(x.shape[:-2] + (m, 2, t, lanes))
        u = xv[..., 0, :, :]
        v = xv[..., 1, :, :]
        w = wc[:, s, :t][:, None, :, None]
        ws = wcs[:, s, :t][:, None, :, None]
        q = q3[..., None]
        a = m31.csub2q(u + v, q * 2)
        b = m31.mulmod_shoup_lazy(u - v + q * 2, w, ws, q)
        x = jnp.stack([a, b], axis=-3).reshape(x.shape[:-2] + (C2, lanes))
    return x


def _intt_col_cyclic_ct_r4(x, iwc, iwcs, q3):
    """Radix-4 CT-DIT inverse cyclic (two stages per sweep, descending s).

    Fused view [..., m2, 2(i2), 2(i1), t, lanes]: stage s butterflies over
    i1 (twiddle iwc[s][k]); stage s-1 over i2 (iwc[s-1][i1*t+k])."""
    lanes = x.shape[-1]
    t = 1
    s = _LOG_C2 - 1
    while s - 1 >= 0:
        m2 = C2 // (4 * t)
        xv = x.reshape(x.shape[:-2] + (m2, 2, 2, t, lanes))
        q = q3[..., None, None]
        u = xv[..., 0, :, :]   # i1 = 0
        v = xv[..., 1, :, :]   # i1 = 1
        w1v = iwc[:, s, :t][:, None, None, :, None]
        w1vs = iwcs[:, s, :t][:, None, None, :, None]
        u = m31.csub2q(u, q * 2)
        mv = m31.mulmod_shoup_lazy(v, w1v, w1vs, q)
        y0 = u + mv
        y1 = u - mv + q * 2
        ys = jnp.stack([y0, y1], axis=-3)  # [..., m2, 2(i2), 2(i1), t, l]
        # stage s-1 over i2 with twiddle iwc[s-1][i1*t + k]:
        w2 = iwc[:, s - 1, : 2 * t].reshape(iwc.shape[0], 2, t)[:, None, :, :, None]
        w2s = iwcs[:, s - 1, : 2 * t].reshape(iwc.shape[0], 2, t)[:, None, :, :, None]
        u2 = ys[..., 0, :, :, :]
        v2 = ys[..., 1, :, :, :]
        u2 = m31.csub2q(u2, q * 2)
        mv2 = m31.mulmod_shoup_lazy(v2, w2, w2s, q)
        x = jnp.stack([u2 + mv2, u2 - mv2 + q * 2], axis=-4)
        x = x.reshape(x.shape[:-5] + (C2, lanes))
        t *= 4
        s -= 2
    if s >= 0:
        m = C2 // (2 * t)
        xv = x.reshape(x.shape[:-2] + (m, 2, t, lanes))
        u = xv[..., 0, :, :]
        v = xv[..., 1, :, :]
        w = iwc[:, s, :t][:, None, :, None]
        ws = iwcs[:, s, :t][:, None, :, None]
        q = q3[..., None]
        u = m31.csub2q(u, q * 2)
        mv = m31.mulmod_shoup_lazy(v, w, ws, q)
        x = jnp.stack([u + mv, u - mv + q * 2], axis=-3)
        x = x.reshape(x.shape[:-4] + (C2, lanes))
    return x


def fwd_core(x, w1, w1s, tw, tws, wc, wcs, q, logc1, radix4=False):
    """[..., G, n] -> [..., G, n]; tables carry the leading G axis.

    Internally Harvey-lazy ([0,4q)/[0,2q) residues); canonical in and out."""
    c1 = x.shape[-1] // C2
    q3 = q.reshape(q.shape + (1, 1))
    x = x.reshape(x.shape[:-1] + (c1, C2))
    colA = _ntt_col_negacyclic_r4 if radix4 else _ntt_col_negacyclic
    colC = _ntt_col_cyclic_gs_r4 if radix4 else _ntt_col_cyclic_gs
    x = colA(x, w1, w1s, q3, logc1)                      # < 4q
    x = m31.mulmod_shoup_lazy(x, tw, tws, q3)            # < 2q
    x = jnp.swapaxes(x, -1, -2)  # [.., C2, C1]
    x = colC(x, wc, wcs, q3)                             # < 2q
    x = m31.csub(x, q3)
    return x.reshape(x.shape[:-2] + (c1 * C2,))


def inv_core(x, iw1, iw1s, itw, itws, iwc, iwcs, q, logc1, radix4=False):
    c1 = x.shape[-1] // C2
    q3 = q.reshape(q.shape + (1, 1))
    x = x.reshape(x.shape[:-1] + (C2, c1))
    colC = _intt_col_cyclic_ct_r4 if radix4 else _intt_col_cyclic_ct
    colA = _intt_col_negacyclic_r4 if radix4 else _intt_col_negacyclic
    x = colC(x, iwc, iwcs, q3)                           # < 4q
    x = jnp.swapaxes(x, -1, -2)  # [.., C1, C2]
    x = m31.mulmod_shoup_lazy(x, itw, itws, q3)          # < 2q
    x = colA(x, iw1, iw1s, q3, logc1)                    # < 2q
    x = m31.csub(x, q3)
    return x.reshape(x.shape[:-2] + (c1 * C2,))


def forward4(x, tb: FourStepTables, radix4: bool = False):
    """x: [..., L, n] residues -> spectra [..., L, n] (internal order)."""
    return fwd_core(x, tb.w1, tb.w1s, tb.tw, tb.tws, tb.wc, tb.wcs,
                    tb.q, tb.logc1, radix4=radix4)


def inverse4(x, tb: FourStepTables, radix4: bool = False):
    return inv_core(x, tb.iw1, tb.iw1s, tb.itw, tb.itws, tb.iwc, tb.iwcs,
                    tb.q, tb.logc1, radix4=radix4)
