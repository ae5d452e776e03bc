"""Distributed BEHZ ciphertext multiply + relinearization (the flagship op,
sharded — BASELINE.md multi-host row: n=32768 mult+relin with all-to-all NTT
stages).

Everything in the BEHZ pipeline except the NTT butterflies is coefficient-
wise or spectrum-pointwise, so the whole multiply runs inside ONE shard_map
with the polynomial's lane axis sharded over the 'coeff' mesh axis:

  to_bsk / fast-floor / Shenoy-Kumaresan / pointwise tensor  — local math
  forward + inverse NTTs       — local four-step passes + one all-to-all
                                 each (parallel/ntt_dist.py schedule)
  relinearization              — local digit lift + dist NTTs + key pointwise

Cross-device traffic per transform is the bisection-optimal n*(S-1)/S
coefficients. Spectra use the
ntt4 ("four") ordering, so contexts must be built with engine="four" and the
relin keys generated under that engine; results are bit-exact vs the
single-device RnsMultiplier + relinearize on the same context (tested on the
8-device virtual CPU mesh, tests/test_behz_dist.py).

Composable with dp (batch) sharding via the same mesh: pass batch_axis="dp".
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..bfv.behz import KSwitchKeys, RnsMultiplier
from ..bfv.ciphertext import Ciphertext
from ..bfv.context import BFVContext
from ..ops import ntt4
from ..ops.modmath import m31
from ..ops.ntt4 import C2
from jax import shard_map

from .ntt_dist import _tw_shards

__all__ = ["DistMultiplier"]


class DistMultiplier:
    """BEHZ multiply + relinearize under shard_map over a device mesh.

    ``mesh`` must carry a ``coeff`` axis whose size divides both 128 and
    n/128; an optional ``dp`` axis shards the ciphertext batch."""

    def __init__(self, ctx: BFVContext, rlk: KSwitchKeys, mesh: Mesh,
                 coeff_axis: str = "coeff", batch_axis: str | None = None):
        assert ctx.tables.profile == "m31", "dist multiplier is m31-only"
        assert ctx.tables.engine == "four", (
            "build the context with engine='four' so key spectra match the "
            "distributed four-step ordering"
        )
        self.ctx = ctx
        self.mesh = mesh
        self.coeff_axis = coeff_axis
        self.batch_axis = batch_axis
        self.mul = RnsMultiplier(ctx)
        self.rlk = rlk
        S = mesh.shape[coeff_axis]
        tb_q = ctx.tables.four_step
        tb_b = self.mul.base_bsk.tables.four_step
        assert C2 % S == 0 and tb_q.c1 % S == 0
        self.S = S
        # Step-B twiddles pre-split per coeff shard: [S, L, c1, C2/S].
        self.twq_f = _tw_shards(tb_q, S, inverse=False)
        self.twq_i = _tw_shards(tb_q, S, inverse=True)
        self.twb_f = _tw_shards(tb_b, S, inverse=False)
        self.twb_i = _tw_shards(tb_b, S, inverse=True)
        # Gadget groups come FROM the keys (one production relin config —
        # keygen picks the noise-bounded width, behz.default_relin_width).
        kq, n = ctx.L, ctx.n
        self.groups = rlk.groups or tuple((i,) for i in range(kq))
        D = len(self.groups)
        # Relin keys in the spectrum view [D, L, C2, c1] (c1 axis sharded).
        spec_view = lambda a: a.reshape(D, kq, C2, tb_q.c1)
        self.keys_spec = tuple(
            spec_view(a) for a in (rlk.k0, rlk.k0_shoup, rlk.k1, rlk.k1_shoup)
        )
        self._jit = jax.jit(self._build())

    # -- local (per-shard) transform passes --------------------------------

    def _fwd_local(self, x, tb, tw_pair, ax):
        """[.., K, c1, C2/S] canonical -> spectrum [.., K, C2, c1/S] canonical."""
        twl, twsl = tw_pair
        qq = tb.q[:, None, None]
        xb = ntt4._ntt_col_negacyclic(x, tb.w1, tb.w1s, qq, tb.logc1)
        xb = m31.mulmod_shoup_lazy(xb, twl[0], twsl[0], qq)
        xb = jnp.swapaxes(xb, -1, -2)
        xb = jax.lax.all_to_all(
            xb, ax, split_axis=xb.ndim - 1, concat_axis=xb.ndim - 2, tiled=True
        )
        xb = ntt4._ntt_col_cyclic_gs(xb, tb.wc, tb.wcs, qq)
        return m31.csub(xb, qq)

    def _inv_local(self, x, tb, tw_pair, ax):
        twl, twsl = tw_pair
        qq = tb.q[:, None, None]
        xb = ntt4._intt_col_cyclic_ct(x, tb.iwc, tb.iwcs, qq)
        xb = jax.lax.all_to_all(
            xb, ax, split_axis=xb.ndim - 2, concat_axis=xb.ndim - 1, tiled=True
        )
        xb = jnp.swapaxes(xb, -1, -2)
        xb = m31.mulmod_shoup_lazy(xb, twl[0], twsl[0], qq)
        xb = ntt4._intt_col_negacyclic(xb, tb.iw1, tb.iw1s, qq, tb.logc1)
        return m31.csub(xb, qq)

    # -- the shard-mapped multiply -----------------------------------------

    def _build(self):
        ctx, mul = self.ctx, self.mul
        tb_q = ctx.tables.four_step
        tb_b = mul.base_bsk.tables.four_step
        ax = self.coeff_axis
        kq = ctx.L
        c1 = tb_q.c1

        # Local views: each shard holds whole c1 columns over C2/S lanes.
        coeff = lambda a: a.reshape(a.shape[:-1] + (c1, -1))
        flat = lambda a: a.reshape(a.shape[:-2] + (-1,))

        def local(x1, x2, twqf, twqi, twbf, twbi, k0, k0s, k1, k1s):
            # x1, x2: [B', 2, K, c1, C2/S] canonical coefficient shards.
            def prep(poly):
                # poly: [B', K, c1, C2/S]
                bsk = coeff(mul._to_bsk(flat(poly)))
                return (
                    self._fwd_local(poly, tb_q, twqf, ax),
                    self._fwd_local(bsk, tb_b, twbf, ax),
                )

            c0, c1_, d0, d1 = (prep(p) for p in
                               (x1[:, 0], x1[:, 1], x2[:, 0], x2[:, 1]))

            def karatsuba(a0, a1, b0, b1, tb):
                q = tb.q[:, None, None]
                mu = tuple(m[:, None, None] for m in tb.mu)
                e0 = m31.mulmod(a0, b0, q, *mu)
                e2 = m31.mulmod(a1, b1, q, *mu)
                cross = m31.mulmod(a0 + a1, b0 + b1, q, *mu)
                e1 = m31.sub(m31.sub(cross, e0, q), e2, q)
                return e0, e1, e2

            eq = karatsuba(c0[0], c1_[0], d0[0], d1[0], tb_q)
            eb = karatsuba(c0[1], c1_[1], d0[1], d1[1], tb_b)
            eq = [flat(self._inv_local(e, tb_q, twqi, ax)) for e in eq]
            eb = [flat(self._inv_local(e, tb_b, twbi, ax)) for e in eb]

            outs = [
                mul._sk_to_q(mul._fast_floor(eq[j], eb[j])) for j in range(3)
            ]

            # Relinearize: lift each gadget digit locally (the CRT lift is
            # coefficient-wise, so it runs unchanged on the lane-sharded
            # slice), dist-NTT, key dot. Groups come from the keys.
            from ..bfv.behz import lift_digit_grouped

            q2 = ctx.tables.q[:, None]
            acc0 = acc1 = None
            for j, group in enumerate(self.groups):
                lifted = lift_digit_grouped(ctx, outs[2], group)
                dn = self._fwd_local(coeff(lifted), tb_q, twqf, ax)
                qs = tb_q.q[:, None, None]
                t0 = m31.mulmod_shoup(dn, k0[j], k0s[j], qs)
                t1 = m31.mulmod_shoup(dn, k1[j], k1s[j], qs)
                acc0 = t0 if acc0 is None else m31.add(acc0, t0, qs)
                acc1 = t1 if acc1 is None else m31.add(acc1, t1, qs)
            d0p = flat(self._inv_local(acc0, tb_q, twqi, ax))
            d1p = flat(self._inv_local(acc1, tb_q, twqi, ax))
            out0 = m31.add(outs[0], d0p, q2)
            out1 = m31.add(outs[1], d1p, q2)
            return jnp.stack(
                [coeff(out0), coeff(out1)], axis=1
            )  # [B', 2, K, c1, C2/S]

        ba = self.batch_axis
        spec_x = P(ba, None, None, None, self.coeff_axis)
        spec_tw = P(self.coeff_axis, None, None, None)
        spec_key = P(None, None, None, self.coeff_axis)

        smap = shard_map(
            local,
            mesh=self.mesh,
            in_specs=(spec_x, spec_x, spec_tw, spec_tw, spec_tw, spec_tw,
                      spec_key, spec_key, spec_key, spec_key),
            out_specs=spec_x,
        )

        def run(x1, x2):
            return smap(x1, x2, self.twq_f, self.twq_i, self.twb_f,
                        self.twb_i, *self.keys_spec)

        return run

    # -- public API ---------------------------------------------------------

    def shard_ciphertext(self, ct: Ciphertext):
        """[..., L, n] polys -> device array [B, 2, L, c1, C2] on the mesh."""
        kq, n = self.ctx.L, self.ctx.n
        c1 = self.ctx.tables.four_step.c1
        x = jnp.stack(ct.polys, axis=-3).reshape((-1, 2, kq, c1, C2))
        sh = NamedSharding(
            self.mesh, P(self.batch_axis, None, None, None, self.coeff_axis)
        )
        return jax.device_put(x, sh)

    def multiply_relinearize(self, ct1: Ciphertext, ct2: Ciphertext) -> Ciphertext:
        assert ct1.size == 2 and ct2.size == 2
        assert ct1.domain == "coeff" and ct2.domain == "coeff"
        kq, n = self.ctx.L, self.ctx.n
        batch = ct1.polys[0].shape[:-2]
        x1 = self.shard_ciphertext(ct1)
        x2 = self.shard_ciphertext(ct2)
        out = self._jit(x1, x2)
        out = out.reshape(batch + (2, kq, n))
        return Ciphertext((out[..., 0, :, :], out[..., 1, :, :]), "coeff")
