"""Protocol roles A (client) and B (server) as transport-agnostic sessions.

Message sequence (SURVEY.md §3.2, mirroring client.cc/server.cc):

    client                                server
      parms ------------------------------->   (raw bytes)
      ct(u), ct(2xa), ct(2ya) ------------->   (framed)
      <---------------------- w64 ‖ BF blob    (framed)
      <------------------- blind-distance ct   (framed)
      decrypt + BF probe -> near/far

The public key never crosses the wire in the interactive protocol (the server
only needs ct x plaintext ops) — the "leg" benchmark variant adds a pk message
for parity with ``test_client_leg`` (``src/test/test_client.cc:130-142``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import jax

from ..bfv import (
    BFVContext,
    Decryptor,
    Encryptor,
    Evaluator,
    KeyGenerator,
    Plaintext,
)
from ..bfv.ciphertext import Ciphertext
from ..bfv.serialize import (
    load_ciphertext,
    load_parms,
    save_ciphertext,
    save_parms,
)
from ..primitives import Blinding, BloomFilter, BloomParameters, blind_distance_keys, pack_key
from ..utils.hexcodec import get_bitlen, hex_string_to_uint, uint64_to_hex_string
from .config import ProtocolConfig

__all__ = ["ProximityClient", "ProximityServer", "send_bf"]


def send_bf(chan, server) -> int:
    """Send w || BF, streaming the table when the channel supports it (the
    Python Channel does; the ctypes native channel falls back to one-shot).
    Wire bytes are identical either way."""
    if hasattr(chan, "send_frame_stream"):
        return chan.send_frame_stream(
            server.bf_message_size(), server.bf_message_chunks()
        )
    return chan.send_frame(server.bf_message())


def _rng_key(seed):
    import secrets

    return jax.random.key(secrets.randbits(62) if seed is None else seed)


class ProximityClient:
    """Role A: owns the keys and coordinates (xa, ya)."""

    def __init__(self, cfg: ProtocolConfig):
        self.cfg = cfg
        self._key = _rng_key(cfg.seed)
        self.parms = cfg.encryption_parameters()
        self.ctx = BFVContext.build(self.parms)
        self.is_near: bool | None = None
        self.blind_distance: int | None = None

    def parms_message(self) -> bytes:
        return save_parms(self.parms)

    def keygen(self):
        from .jitted import keygen_fn, make_public_key, make_secret_key

        self._key, sub = jax.random.split(self._key)
        out = keygen_fn(self.ctx)(sub)
        self.sk = make_secret_key(out)
        self.pk = make_public_key(out)
        self.encryptor = Encryptor(self.ctx, self.pk)
        self.decryptor = Decryptor(self.ctx, self.sk)

    def ciphertext_messages(self) -> list[bytes]:
        """Encrypt u = xa^2 + ya^2, 2*xa, 2*ya (demo.cc:131-140).

        All three encryptions run as one jitted graph (one device dispatch);
        the per-message key chain matches the eager path bit-for-bit.
        """
        import numpy as np

        from .jitted import encrypt_batch_fn

        cfg = self.cfg
        u = cfg.xa * cfg.xa + cfg.ya * cfg.ya
        values = (u, cfg.xa << 1, cfg.ya << 1)
        subs = []
        for _ in values:
            self._key, sub = jax.random.split(self._key)
            subs.append(sub)
        pairs = [
            Plaintext(uint64_to_hex_string(v), n=self.ctx.n).pair_u32(self.ctx.n)
            for v in values
        ]
        m_lo = jax.numpy.asarray(np.stack([p[0] for p in pairs]))
        m_hi = jax.numpy.asarray(np.stack([p[1] for p in pairs]))
        pk = self.pk
        stacked = encrypt_batch_fn(self.ctx)(
            pk.pk0_ntt, pk.pk1_ntt, pk.pk0_shoup, pk.pk1_shoup,
            m_lo, m_hi, jax.numpy.stack(subs),
        )
        return [
            save_ciphertext(
                Ciphertext(jax.tree.map(lambda x: x[i], stacked), "coeff"),
                self.ctx,
            )
            for i in range(len(values))
        ]

    def receive_bf(self, blob: bytes):
        (self.w,) = struct.unpack_from("<Q", blob, 0)
        self.bf = BloomFilter.deserialize(blob[8:], index_mode=self.cfg.bf_index_mode)

    def receive_blind_distance(self, blob: bytes) -> bool:
        from ..bfv.plaintext import Plaintext as _Plaintext
        from ..ops import ntt as _ntt
        from .jitted import ct_value_fn

        ct = load_ciphertext(blob, self.ctx)
        residues = ct_value_fn(self.ctx)(
            self.sk.s_ntt, self.sk.s_shoup, ct.polys
        )
        import numpy as np

        coeffs = self.ctx.decode_plain_from_ct_value(
            np.asarray(_ntt.to_numpy(residues, self.ctx.tables), dtype=object)
        )
        plain = _Plaintext(coeffs)
        # The protocol's blind distance is the constant coefficient. A healthy
        # decryption is a constant polynomial; nonzero higher coefficients
        # mean the noise budget was exhausted (flagged, not crashed).
        self.decrypt_consistent = plain.significant_coeff_count() <= 1
        self.blind_distance = int(plain.coeffs[0]) if plain.coeffs else 0
        key = pack_key(self.blind_distance, self.w, get_bitlen(self.w))
        self.is_near = self.bf.contains_u64(key)
        return self.is_near


class ProximityServer:
    """Role B: owns (xb, yb), the blinding values, and the Bloom filter."""

    def __init__(self, cfg: ProtocolConfig, blinding: Blinding | None = None):
        self.cfg = cfg
        self._blinding = blinding  # resolved lazily (needs parms for q)

    def _noise_aware_s_bits(self) -> int:
        """Cap log2(s) so s * max(xb,yb) * nu_fresh < Delta/2.

        The blind-distance noise is ~ s*(nu1 + xb*nu2 + yb*nu3); fresh RLWE
        noise here has ||nu||_inf well under 2^16 for n <= 32768 (ternary u
        convolved with CBD(21) noise). Margin bits cover the sum and rounding.
        """
        from ..utils.hexcodec import get_bitlen

        delta_bits = self.ctx.delta.bit_length()
        coord_bits = get_bitlen(max(self.cfg.xb, self.cfg.yb, 1))
        nu_bits = 16
        margin = 3
        return delta_bits - 1 - coord_bits - nu_bits - margin

    @property
    def blinding(self) -> Blinding:
        if self._blinding is None:
            cfg = self.cfg
            if cfg.safe_blinding:
                self._blinding = Blinding.for_protocol(
                    cfg.plain_modulus_bits,
                    cfg.sq_radius,
                    cfg.seed,
                    max_s_bits=self._noise_aware_s_bits(),
                )
            else:
                self._blinding = (
                    Blinding.sample()
                    if cfg.seed is None
                    else Blinding.deterministic(cfg.seed)
                )
        return self._blinding

    def receive_parms(self, blob: bytes):
        self.parms = load_parms(blob)
        err = self.parms.validate()
        assert not err, f"received invalid parameters: {err}"
        self.ctx = BFVContext.build(self.parms)
        self.evaluator = Evaluator(self.ctx)

    def build_bloom_filter(self):
        """Hot loop #1: r^2 blinded-key inserts, device-batched."""
        cfg = self.cfg
        p = BloomParameters(
            projected_element_count=cfg.sq_radius,
            false_positive_probability=cfg.false_positive_probability,
            random_seed=cfg.bf_seed,
            index_mode=cfg.bf_index_mode,
        )
        assert p.compute_optimal_parameters()
        self.bf = BloomFilter(p)
        for klo, khi, count in blind_distance_keys(self.blinding, cfg.sq_radius):
            self.bf.insert_u64_batch(klo, khi, count=count)

    def bf_message(self) -> bytes:
        return struct.pack("<Q", self.blinding.w) + self.bf.serialize()

    def bf_message_size(self) -> int:
        return 8 + self.bf.compute_serialization_size()

    def bf_message_chunks(self):
        """Chunked form of ``bf_message`` (same bytes): the packed table is
        fetched device->host slice by slice while earlier slices go out on
        the wire (send_bf / Channel.send_frame_stream)."""
        yield struct.pack("<Q", self.blinding.w)
        yield from self.bf.iter_serialized()

    def receive_ciphertexts(self, blobs: list[bytes]):
        self.c1, self.c2, self.c3 = (
            load_ciphertext(b, self.ctx) for b in blobs
        )

    def blind_distance_message(self) -> bytes:
        """Homomorphic blind distance (demo.cc:148-160):

        c1 <- s*(u + z - 2*xa*xb - 2*ya*yb) + s*r = s*(d^2 + r)
        """
        from ..bfv.ciphertext import Ciphertext
        from .jitted import blind_distance_fn, plain_pair

        cfg, bl = self.cfg, self.blinding
        t, n = self.ctx.t, self.ctx.n
        z = cfg.xb * cfg.xb + cfg.yb * cfg.yb
        out = blind_distance_fn(self.ctx)(
            self.c1.polys, self.c2.polys, self.c3.polys,
            plain_pair(z, t, n), plain_pair(cfg.xb, t, n),
            plain_pair(cfg.yb, t, n), plain_pair(bl.s, t, n),
            plain_pair(bl.s * bl.r, t, n),
        )
        return save_ciphertext(Ciphertext(tuple(out), "coeff"), self.ctx)
