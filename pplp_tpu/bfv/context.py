"""BFV context: NTT tables plus all RNS scaling precomputations.

The analogue of SEAL's ``SEALContext`` + ``ContextData`` (used at
``/root/reference/src/demo.cc:76``): owns the modulus chain, the per-prime NTT
tables, the Delta = floor(q/t) residues for encryption scaling, and the host
CRT recomposition constants used by decryption.

Encryption encodes a plaintext coefficient m as round(q*m/t) mod each q_i:
    round(q*m/t) = Delta*m + fix,  fix = floor((q mod t)*m + (t+1)/2) / t),
computed entirely on-device in u32 limbs (exact Barrett division by t with
correction steps — valid for any t, power-of-two or prime).
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
from ..ops.primes import Modulus
from .params import EncryptionParameters

__all__ = ["BFVContext"]


def _limbs_const(value: int, count: int, shape=()):
    """Python int -> list of u32 scalar (or broadcast) jnp arrays."""
    out = []
    for i in range(count):
        v = (value >> (32 * i)) & 0xFFFFFFFF
        out.append(jnp.full(shape, v, jnp.uint32) if shape else jnp.uint32(v))
    return out


@dataclass(frozen=True, eq=False)
class BFVContext:
    parms: EncryptionParameters
    tables: ntt.NttTables
    t: int
    q: int
    delta: int
    q_mod_t: int
    # Device constants:
    delta_mod_q: Any        # profile value [L, 1]
    delta_shoup: Any        # Shoup companion of delta_mod_q
    t_mod_q: Any            # profile value [L, 1] (t reduced mod q_i)
    q_mod_t_limbs: tuple    # 2 u32 scalars
    addend_limbs: tuple     # (t+1)//2, 2 u32 scalars
    mu_t_limbs: tuple       # floor(2^128/t), 4 u32 scalars
    t_limbs: tuple          # 2 u32 scalars
    # Host CRT recomposition: x = sum_i ((x_i * qhat_inv_i) mod q_i) * qhat_i mod q
    qhat: tuple
    qhat_inv: tuple

    @property
    def n(self) -> int:
        return self.parms.poly_modulus_degree

    @property
    def L(self) -> int:
        return len(self.parms.coeff_modulus)

    @property
    def prof(self):
        return self.tables.prof

    @property
    def moduli(self):
        return self.tables.moduli

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @staticmethod
    @functools.lru_cache(maxsize=8)
    def build(parms: EncryptionParameters, engine: str = "stage") -> "BFVContext":
        """engine: NTT implementation ("stage" | "four" | "four4");
        all NTT-domain state in this context uses that engine's spectrum
        order, so a context is internally consistent by construction."""
        err = parms.validate()
        if err:
            raise ValueError(f"invalid encryption parameters: {err}")
        moduli = [Modulus(q) for q in parms.coeff_modulus]
        tables = ntt.build_tables(moduli, parms.poly_modulus_degree, engine=engine)
        t = parms.plain_modulus
        q = 1
        for m in moduli:
            q *= m.value
        delta = q // t
        q_mod_t = q % t

        def residue_const(value: int):
            """Lift a big int to per-limb residues, shaped [L, 1]."""
            vals = [[value % m.value] for m in moduli]
            return ntt.to_device(np.array(vals, dtype=object), tables)

        delta_mod_q = residue_const(delta)
        # Shoup companions, host-computed per limb.
        shoup_bits = 32 if tables.profile == "m31" else 64
        sh = [[((delta % m.value) << shoup_bits) // m.value] for m in moduli]
        delta_shoup = ntt.to_device(np.array(sh, dtype=object), tables)

        qhat = []
        qhat_inv = []
        for m in moduli:
            h = q // m.value
            qhat.append(h)
            qhat_inv.append(pow(h % m.value, -1, m.value))

        return BFVContext(
            parms=parms,
            tables=tables,
            t=t,
            q=q,
            delta=delta,
            q_mod_t=q_mod_t,
            delta_mod_q=delta_mod_q,
            delta_shoup=delta_shoup,
            t_mod_q=residue_const(t),
            q_mod_t_limbs=tuple(_limbs_const(q_mod_t, 2)),
            addend_limbs=tuple(_limbs_const((t + 1) // 2, 2)),
            mu_t_limbs=tuple(_limbs_const((1 << 128) // t, 4)),
            t_limbs=tuple(_limbs_const(t, 2)),
            qhat=tuple(qhat),
            qhat_inv=tuple(qhat_inv),
        )

    # ------------------------------------------------------------------
    # Device-side plaintext handling
    # ------------------------------------------------------------------

    def reduce_u64_to_rns(self, lo, hi):
        """(lo, hi) u32 arrays [..., n] of 64-bit values -> residues [..., L, n]."""
        L = self.L
        lo_b = jnp.broadcast_to(lo[..., None, :], lo.shape[:-1] + (L, lo.shape[-1]))
        hi_b = jnp.broadcast_to(hi[..., None, :], hi.shape[:-1] + (L, hi.shape[-1]))
        if self.tables.profile == "m31":
            q = self.tables.q[:, None]
            mu_lo, mu_hi = (m[:, None] for m in self.tables.mu)
            return mm.m31.reduce64(lo_b, hi_b, q, mu_lo, mu_hi)
        q = jax.tree.map(lambda a: a[:, None], self.tables.q)
        ratio = tuple(m[:, None] for m in self.tables.mu)
        zero = jnp.zeros_like(lo_b)
        return mm.m62.reduce128((lo_b, hi_b, zero, zero), q, ratio)

    def scale_plain(self, m_lo, m_hi):
        """round(q*m/t) mod q_i for plaintext coeff pairs [..., n].

        This is the encryption-time message scaling (SEAL's
        ``multiply_add_plain_with_scaling_variant`` semantics).
        """
        # fix = floor(((q mod t)*m + (t+1)//2) / t), exact.
        z = mm.comba_mul([m_lo, m_hi], list(self.q_mod_t_limbs))  # 4 limbs
        zero = jnp.zeros_like(m_lo)
        addend = [jnp.broadcast_to(a, m_lo.shape) for a in self.addend_limbs]
        z = mm.limbs_add(z, addend + [zero, zero])
        prod = mm.comba_mul(z, list(self.mu_t_limbs))  # 8 limbs
        est = [prod[4], prod[5]]
        for _ in range(2):
            et = mm.comba_mul(est, list(self.t_limbs), out_limbs=2)
            r = mm.m62._sub_raw((z[0], z[1]), (et[0], et[1]))
            ge = mm.m62._geq(r, (
                jnp.broadcast_to(self.t_limbs[0], m_lo.shape),
                jnp.broadcast_to(self.t_limbs[1], m_lo.shape),
            ))
            inc = est[0] + ge.astype(jnp.uint32)
            est = [inc, est[1] + (inc < est[0]).astype(jnp.uint32)]
        fix = self.reduce_u64_to_rns(est[0], est[1])
        m_rns = self.reduce_u64_to_rns(m_lo, m_hi)

        p = self.prof
        q2 = self.tables.q_b(1)
        dm = p.mulmod_shoup(m_rns, self.delta_mod_q, self.delta_shoup, q2)
        return p.add(dm, fix, q2)

    def lift_plain_centered(self, m_lo, m_hi):
        """Centered lift of plaintext coeffs into R_q for multiply_plain.

        Coefficients >= (t+1)/2 represent negatives: lift to m - t mod q_i
        (SEAL's plain_upper_half semantics).
        """
        m_rns = self.reduce_u64_to_rns(m_lo, m_hi)
        thr = (self.t + 1) // 2
        thr_lo = jnp.uint32(thr & 0xFFFFFFFF)
        thr_hi = jnp.uint32(thr >> 32)
        is_upper = (m_hi > thr_hi) | ((m_hi == thr_hi) & (m_lo >= thr_lo))
        p = self.prof
        q2 = self.tables.q_b(1)
        shifted = p.sub(m_rns, self.t_mod_q, q2)
        mask = is_upper[..., None, :]
        return jax.tree.map(lambda a, b: jnp.where(mask, a, b), shifted, m_rns)

    # ------------------------------------------------------------------
    # Host-side CRT composition (used by decryption)
    # ------------------------------------------------------------------

    def crt_compose(self, residues: np.ndarray) -> list[int]:
        """residues: host object/u64 array [L, n] -> python ints [n] in [0, q)."""
        L, n = residues.shape
        out = [0] * n
        for i in range(L):
            qi = self.moduli[i].value
            yi = self.qhat_inv[i]
            hi = self.qhat[i]
            row = residues[i]
            for j in range(n):
                out[j] += (int(row[j]) * yi % qi) * hi
        return [v % self.q for v in out]

    def decode_plain_from_ct_value(self, residues: np.ndarray) -> list[int]:
        """[L, n] residues of x = (c0 + c1 s) mod q -> round(t*x/q) mod t."""
        xs = self.crt_compose(residues)
        t, q = self.t, self.q
        return [((x * t + q // 2) // q) % t for x in xs]
