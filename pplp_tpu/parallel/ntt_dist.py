"""Distributed negacyclic NTT with an explicit all-to-all collective.

The four-step decomposition (ops/ntt4.py) is exactly the textbook distributed
NTT: with the lane axis C2 sharded over the 'coeff' mesh axis,

  step A  (length-C1 column NTTs)   — local: butterflies run down the C1
                                      axis, which every shard holds whole;
  step B  (twiddle matrix)          — local (per-shard twiddle slice);
  transpose + ALL-TO-ALL            — the one cross-device exchange, a
                                      single all-to-all (over NVLink on a
                                      multi-GPU host);
  step C  (length-128 column NTTs)  — local again (C1 is now the sharded
                                      lane axis).

Per transform each chip exchanges n/S * (S-1)/S coefficients — the
bisection-optimal volume for a full transform.

Array layout: coefficients enter as the 2-D view [..., L, C1, C2] (row-major
view of the length-n axis, free reshape) with the C2 axis sharded
P(..., None, 'coeff'); spectra come out as [..., L, C2, C1] with the C1 axis
sharded. ``inverse`` mirrors exactly; pointwise products pair like-ordered,
like-sharded spectra, so callers never observe the internal order. Composes
with dp/limb sharding in the same shard_map.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..ops import ntt4
from ..ops.modmath import m31
from ..ops.ntt4 import C2, FourStepTables

__all__ = ["make_dist_ntt", "pointwise_mul_dist", "coeff_view", "flat_view"]


def coeff_view(x, tb: FourStepTables):
    """[..., L, n] -> the engine's coefficient view [..., L, C1, C2]."""
    return x.reshape(x.shape[:-1] + (tb.c1, C2))


def flat_view(x):
    """Inverse of coeff_view."""
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


def _tw_shards(tb: FourStepTables, n_shards: int, inverse: bool):
    """Step-B twiddle matrices pre-split per shard: [S, L, c1, C2/S]."""
    tw, tws = (tb.itw, tb.itws) if inverse else (tb.tw, tb.tws)
    chunk = C2 // n_shards
    stack = lambda a: jnp.stack(
        [a[:, :, s * chunk : (s + 1) * chunk] for s in range(n_shards)]
    )
    return stack(tw), stack(tws)


def make_dist_ntt(tb: FourStepTables, mesh: Mesh, coeff_axis: str = "coeff",
                  batch_axis=None, limb_axis=None):
    """Build shard-mapped (forward, inverse) over ``mesh``.

    forward: [..., L, C1, C2] (C2 sharded) -> spectrum [..., L, C2, C1]
    (C1 sharded); inverse mirrors.
    """
    S = mesh.shape[coeff_axis]
    c1 = tb.c1
    assert C2 % S == 0 and c1 % S == 0, "coeff shards must divide 128 and C1"
    tw_f, tws_f = _tw_shards(tb, S, inverse=False)
    tw_i, tws_i = _tw_shards(tb, S, inverse=True)

    spec_in = P(batch_axis, limb_axis, None, coeff_axis)
    spec_out = P(batch_axis, limb_axis, None, coeff_axis)
    spec_tw = P(coeff_axis, limb_axis, None, None)
    spec_tbl2 = P(limb_axis, None)          # [L, C1] step-A tables
    spec_tbl3 = P(limb_axis, None, None)    # [L, 7, 64] step-C tables
    spec_q = P(limb_axis)

    def fwd_local(x, w1, w1s, twl, twsl, wc, wcs, q):
        # x local: [B', L', c1, C2/S] — every shard holds whole C1 columns.
        qq = q.reshape(q.shape + (1, 1))
        xb = ntt4._ntt_col_negacyclic(x, w1, w1s, qq, tb.logc1)       # < 4q
        xb = m31.mulmod_shoup_lazy(xb, twl[0], twsl[0], qq)           # < 2q
        xb = jnp.swapaxes(xb, -1, -2)  # [B', L', C2/S, c1]
        xb = jax.lax.all_to_all(
            xb, coeff_axis, split_axis=xb.ndim - 1, concat_axis=xb.ndim - 2,
            tiled=True,
        )  # -> [B', L', C2, c1/S]
        xb = ntt4._ntt_col_cyclic_gs(xb, wc, wcs, qq)                 # < 2q
        return m31.csub(xb, qq)

    def inv_local(x, iw1, iw1s, itwl, itwsl, iwc, iwcs, q):
        # x local: [B', L', C2, c1/S].
        qq = q.reshape(q.shape + (1, 1))
        xb = ntt4._intt_col_cyclic_ct(x, iwc, iwcs, qq)               # < 4q
        xb = jax.lax.all_to_all(
            xb, coeff_axis, split_axis=xb.ndim - 2, concat_axis=xb.ndim - 1,
            tiled=True,
        )  # -> [B', L', C2/S, c1]
        xb = jnp.swapaxes(xb, -1, -2)  # [B', L', c1, C2/S]
        xb = m31.mulmod_shoup_lazy(xb, itwl[0], itwsl[0], qq)         # < 2q
        xb = ntt4._intt_col_negacyclic(xb, iw1, iw1s, qq, tb.logc1)   # < 2q
        return m31.csub(xb, qq)

    smap = functools.partial(shard_map, mesh=mesh)
    fwd = smap(
        fwd_local,
        in_specs=(spec_in, spec_tbl2, spec_tbl2, spec_tw, spec_tw,
                  spec_tbl3, spec_tbl3, spec_q),
        out_specs=spec_out,
    )
    inv = smap(
        inv_local,
        in_specs=(spec_out, spec_tbl2, spec_tbl2, spec_tw, spec_tw,
                  spec_tbl3, spec_tbl3, spec_q),
        out_specs=spec_in,
    )

    def forward(x):
        return fwd(x, tb.w1, tb.w1s, tw_f, tws_f, tb.wc, tb.wcs, tb.q)

    def inverse(x):
        return inv(x, tb.iw1, tb.iw1s, tw_i, tws_i, tb.iwc, tb.iwcs, tb.q)

    return forward, inverse


def pointwise_mul_dist(a, b, tb: FourStepTables):
    """Residue-wise product of like-ordered spectra ([..., L, C2, C1] views)."""
    q = tb.q[:, None, None]
    mu = tuple(m[:, None, None] for m in tb.mu)
    return m31.mulmod(a, b, q, mu[0], mu[1])
