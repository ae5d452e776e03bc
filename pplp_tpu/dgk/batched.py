"""Batched DGK operations: the fused-kernel comparison path.

Where the reference executes one GMP modexp at a time (``dgk.cc:33-75``),
these run B-wide on device lanes via ``modexp.MontgomeryCtx``: batch encrypt,
batch decrypt (shared-exponent c^vpq + hash-map table lookup), and the full
blinded-distance comparison pipeline for 10k+ parallel checks
(BASELINE.md config[2]).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .dgk import DGKPrivateKey, DGKPublicKey
from .modexp import MontgomeryCtx, exp_to_bits, from_digits, to_digits

__all__ = ["DGKBatch", "DGKDeviceTable"]


@dataclass(frozen=True, eq=False)
class DGKBatch:
    pub: DGKPublicKey
    mc: MontgomeryCtx

    @staticmethod
    def build(pub: DGKPublicKey) -> "DGKBatch":
        return DGKBatch(pub=pub, mc=MontgomeryCtx.build(pub.n))

    def _dig(self, ints):
        return jnp.asarray(to_digits(ints, self.mc.D))

    def encrypt_batch(self, ms, rs):
        """[B] messages (< u) + randomness -> [B, D] ciphertext digits.

        c = g^m * h^r mod n; both exponentiations share their base, so each
        scan step squares once ([1,D]) and multiplies lane-wise.
        """
        mc = self.mc
        l_bits = max(int(m).bit_length() for m in ms) or 1
        r_bits = max(int(r).bit_length() for r in rs) or 1
        gm = mc.powmod(self._dig([self.pub.g]), jnp.asarray(exp_to_bits(ms, l_bits)))
        hr = mc.powmod(self._dig([self.pub.h]), jnp.asarray(exp_to_bits(rs, r_bits)))
        return mc.mulmod(gm, hr)

    def decrypt_batch(self, priv: DGKPrivateKey, cts) -> list[int]:
        """[B, D] ciphertext digits -> messages, via shared-exponent c^vpq
        then the hash-map table (host O(1) per lane)."""
        cv = self.mc.powmod_shared_exp(cts, priv.vpq)
        out = []
        for v in from_digits(np.asarray(cv)):
            out.append(priv.rtab[v])
        return out

    def build_device_table(self, priv: DGKPrivateKey) -> "DGKDeviceTable":
        """Precompute the on-device decrypt table (once per private key)."""
        return DGKDeviceTable.build(priv, self.mc.D)

    def decrypt_batch_device(self, priv: DGKPrivateKey, dtab: "DGKDeviceTable",
                             cts):
        """Fully device-resident decrypt: c^vpq, 64-bit fingerprint, probed
        lookup in the device hash table -> [B] u32 messages.

        Replaces the reference's per-ciphertext linear table scan
        (dgk.cc:62-74) with one jitted program; the host hash-map path
        (``decrypt_batch``) remains as the oracle."""
        cv = self.mc.powmod_shared_exp(cts, priv.vpq)
        return dtab.lookup(cv)

    def build_bsgs_table(self, priv: DGKPrivateKey) -> "DGKDeviceTable":
        """Baby-step table {G^j : j < ceil(sqrt(u))} — O(sqrt(u)) memory,
        vs the full u-entry decrypt table."""
        import math

        G = pow(priv.g, priv.vpq, priv.n)
        m_steps = math.isqrt(self.pub.u) + 1
        table, acc = {}, 1
        for j in range(m_steps):
            table[acc] = j
            acc = acc * G % priv.n
        return DGKDeviceTable.from_map(table, self.mc.D)

    def decrypt_batch_device_bsgs(self, priv: DGKPrivateKey,
                                  btab: "DGKDeviceTable", cts):
        """Device decrypt via baby-step/giant-step — O(sqrt(u)) table.

        The device counterpart of the reference's ph.cc dlog path
        (compute_dlog_bsgs, src/test/dgk/src/ph.cc): giant steps multiply by
        G^{-m} on device and probe the fingerprint table; ~sqrt(u) batched
        Montgomery multiplies total."""
        import math

        mc = self.mc
        u = self.pub.u
        m_steps = math.isqrt(u) + 1
        G = pow(priv.g, priv.vpq, priv.n)
        # Montgomery-domain giant step: mont_mul(z_std, gR) = z*g keeps z in
        # the standard domain with ONE product per step (no per-step
        # to_mont), and lax.scan keeps the graph one block deep regardless
        # of sqrt(u) (an unrolled loop of ~257 block-CIOS products is an
        # XLA:CPU compile blowup).
        giant_m = mc.to_mont(
            jnp.asarray(to_digits([pow(G, -m_steps, priv.n)], mc.D))
        )
        z = mc.powmod_shared_exp(cts, priv.vpq)
        miss = jnp.uint32(DGKDeviceTable.MISS)
        out = jnp.full(z.shape[0], miss, jnp.uint32)
        n_giant = (u + m_steps - 1) // m_steps + 1

        def body(carry, i):
            z, out = carry
            j = btab.lookup(z)
            hit = (j != miss) & (out == miss)
            out = jnp.where(hit, i * jnp.uint32(m_steps) + j, out)
            return (mc.mont_mul(z, giant_m), out), None

        (_, out), _ = jax.lax.scan(
            body, (z, out), jnp.arange(n_giant, dtype=jnp.uint32)
        )
        return out

    # -- the comparison/proximity pipeline ------------------------------

    def blind_distance_batch(self, c1, c2, c3, xb: int, yb: int,
                             s_blind: int, cz, cr):
        """Server side of the DGK pplp flow, batched:
        ((c1 * c2^xb * c3^yb)^s) * cz * cr  over [B, D] ciphertexts.

        The whole chain runs in the Montgomery domain: 5 conversions in, one
        out, products stay in-domain (mont(aR, bR) = abR) — vs a to/from
        round trip inside every powmod/mulmod (round-4: saves ~10 of ~95
        2048-bit Montgomery products per call)."""
        mc = self.mc
        c1m, c2m, c3m = mc.to_mont(c1), mc.to_mont(c2), mc.to_mont(c3)
        czm, crm = mc.to_mont(cz), mc.to_mont(cr)
        t2 = mc.powmod_shared_exp_mont(c2m, xb)
        t3 = mc.powmod_shared_exp_mont(c3m, yb)
        acc = mc.mont_mul(mc.mont_mul(c1m, t2), t3)
        acc = mc.powmod_shared_exp_mont(acc, s_blind)
        return mc.from_mont(mc.mont_mul(mc.mont_mul(acc, czm), crm))


# -- device decrypt table ------------------------------------------------

_FP_A1 = np.uint32(0x9E3779B1)   # golden-ratio odd multipliers
_FP_A2 = np.uint32(0x85EBCA77)
_PROBE_MAX = 32


def _fp_host(digits16: np.ndarray, mult: np.uint32) -> np.ndarray:
    """Horner fold of little-endian u16 digits -> u32 fingerprints. [E, D2]"""
    acc = np.zeros(digits16.shape[0], np.uint32)
    for i in range(digits16.shape[1] - 1, -1, -1):
        acc = acc * mult + digits16[:, i].astype(np.uint32)
    return acc


def _fp_device(digs, mult):
    """Same fold on device over [B, D] u32 16-bit-digit arrays."""
    acc = jnp.zeros(digs.shape[:-1], jnp.uint32)
    m = jnp.uint32(mult)
    for i in range(digs.shape[-1] - 1, -1, -1):
        acc = acc * m + digs[..., i]
    return acc


@dataclass(frozen=True, eq=False)
class DGKDeviceTable:
    """Open-addressed (linear probe) fingerprint table of {g^(vpq·m) : m < u}.

    Entries are 64-bit fingerprints (two independent u32 Horner folds of the
    2048-bit value's 16-bit digits); a lookup gathers ``probes`` slots and
    selects the first two-sided match. False-match probability ~ u·2^-64."""

    size: int
    probes: int
    fp1: jnp.ndarray   # [S] u32
    fp2: jnp.ndarray   # [S] u32
    msg: jnp.ndarray   # [S] u32 (0xFFFFFFFF = empty)

    MISS = np.uint32(0xFFFFFFFF)

    @staticmethod
    def build(priv: DGKPrivateKey, D: int) -> "DGKDeviceTable":
        if priv.rtab is None:
            priv.init_table()
        return DGKDeviceTable.from_map(priv.rtab, D)

    @staticmethod
    def from_map(table: dict, D: int) -> "DGKDeviceTable":
        """Build from any {group element -> u32 message/index} map."""
        u = len(table)
        size = 1 << max(4, (u * 4 - 1).bit_length())  # load factor <= 0.25
        nbytes = D * 2
        vals = np.frombuffer(
            b"".join(int(v).to_bytes(nbytes, "little") for v in table),
            dtype="<u2",
        ).reshape(u, D).astype(np.uint16)
        fp1 = _fp_host(vals, _FP_A1)
        fp2 = _fp_host(vals, _FP_A2)
        pairs = set(zip(fp1.tolist(), fp2.tolist()))
        if len(pairs) != u:  # pragma: no cover - probability ~2^-33
            raise RuntimeError("fingerprint collision in DGK table; rebuild")
        msgs = np.fromiter(table.values(), np.uint32, count=u)
        t_fp1 = np.zeros(size, np.uint32)
        t_fp2 = np.zeros(size, np.uint32)
        t_msg = np.full(size, DGKDeviceTable.MISS, np.uint32)
        mask = size - 1
        probes = 1
        for f1, f2, m in zip(fp1, fp2, msgs):
            idx = int(f1) & mask
            steps = 1
            while t_msg[idx] != DGKDeviceTable.MISS:
                idx = (idx + 1) & mask
                steps += 1
            if steps > _PROBE_MAX:  # pragma: no cover
                raise RuntimeError("probe chain too long; grow the table")
            probes = max(probes, steps)
            t_fp1[idx], t_fp2[idx], t_msg[idx] = f1, f2, m
        return DGKDeviceTable(
            size=size, probes=probes,
            fp1=jnp.asarray(t_fp1), fp2=jnp.asarray(t_fp2),
            msg=jnp.asarray(t_msg),
        )

    def lookup(self, digs):
        """[B, D] digit arrays -> [B] u32 messages (MISS when absent)."""
        f1 = _fp_device(digs, _FP_A1)
        f2 = _fp_device(digs, _FP_A2)
        mask = jnp.uint32(self.size - 1)
        idx = f1 & mask
        out = jnp.full(f1.shape, DGKDeviceTable.MISS, jnp.uint32)
        for _ in range(self.probes):
            hit = (self.fp1[idx] == f1) & (self.fp2[idx] == f2)
            out = jnp.where(hit & (out == DGKDeviceTable.MISS),
                            self.msg[idx], out)
            idx = (idx + jnp.uint32(1)) & mask
        return out
