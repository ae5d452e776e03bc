"""Blinding values (r, s, w) and blinded-distance key packing.

Reference semantics (``/root/reference/src/demo.cc:115-125``): the server draws
r (4 bytes), s (4 bytes), w (2 bytes); for every candidate squared distance
di < radius^2 it inserts key = ((s*(di+r) mod 2^64) << bitlen(w)) | w into the
Bloom filter. The client later probes ((blind_distance << bitlen(w)) | w).

The insert-key generation — the reference's hot loop #1, up to 67M sequential
iterations — is produced here as vectorized u32-lane chunks for the device
batch insert path.
"""

from __future__ import annotations

import functools
import secrets
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..utils.hexcodec import get_bitlen

__all__ = ["Blinding", "pack_key", "blind_distance_keys"]

_M64 = (1 << 64) - 1


@dataclass(frozen=True)
class Blinding:
    r: int  # 4 random bytes
    s: int  # 4 random bytes
    w: int  # 2 random bytes

    @property
    def w_len(self) -> int:
        return get_bitlen(self.w)

    @staticmethod
    def sample(rng: "secrets | None" = None) -> "Blinding":
        """Fresh blinding values (crypto RNG, like seal::random_bytes)."""
        return Blinding(
            r=secrets.randbits(32), s=secrets.randbits(32), w=secrets.randbits(16)
        )

    @staticmethod
    def deterministic(seed: int) -> "Blinding":
        """Reproducible blinding for tests/benchmarks (determinism hook)."""
        x = (seed * 0x9E3779B97F4A7C15 + 1) & _M64
        return Blinding(r=x & 0xFFFFFFFF, s=(x >> 16) & 0xFFFFFFFF, w=(x >> 48) & 0xFFFF)

    @staticmethod
    def for_protocol(
        t_bits: int,
        sq_radius: int,
        seed: int | None = None,
        max_s_bits: int | None = None,
    ) -> "Blinding":
        """Blinding bounded so s*(d^2 + r) < t for every near-range d^2.

        The reference draws full 32-bit s and r (demo.cc:115-118) but probes
        the Bloom filter with the mod-t blind distance while inserting mod-2^64
        keys (the "modulus mismatch hazard", SURVEY.md §4) — with random
        32-bit draws s*(d^2+r) usually exceeds t = 2^56 and near-detection
        silently fails. This constructor keeps the protocol sound: r gets up
        to 20 bits and s fills the headroom below t.
        """
        base = Blinding.deterministic(seed) if seed is not None else Blinding.sample()
        r_bits = min(20, max(8, t_bits // 2 - get_bitlen(sq_radius)))
        r = base.r & ((1 << r_bits) - 1)
        span_bits = get_bitlen(max(sq_radius - 1, 0) + (1 << r_bits))
        s_bits = max(1, t_bits - span_bits - 1)
        if max_s_bits is not None:
            # Noise-budget cap: the homomorphic result carries noise about
            # s * coord * nu_fresh, which must stay below Delta/2 (see
            # ProximityServer._noise_aware_s_bits).
            s_bits = max(1, min(s_bits, max_s_bits))
        s = base.s & ((1 << s_bits) - 1)
        return Blinding(r=r, s=s | 1, w=base.w)  # s odd => nonzero


def pack_key(bd: int, w: int, w_len: int) -> int:
    """((bd << w_len) | w) mod 2^64 — the BF key format."""
    return ((int(bd) << w_len) | w) & _M64


@functools.lru_cache(maxsize=4)
def _keys_chunk_fn(chunk: int):
    """ONE jitted executable per chunk size: all per-run variation (s, w,
    r, start, limit, and w_len) is traced scalars, so every radius of a
    sweep — and every fresh blinding — dispatches through a single compile
    (w_len baked into the trace would recompile whenever the blinding
    changed)."""

    @jax.jit
    def run(s, w, r_lo, start, limit, w_len):
        di = start + jnp.arange(chunk, dtype=jnp.uint32)
        # Clamp the tail to the last valid di: the repeated key is already
        # in the filter, and OR-scatter inserts are idempotent.
        di = jnp.minimum(di, limit - jnp.uint32(1))
        # di + r as a 33-bit value (the reference adds in uint64).
        add_lo = di + r_lo
        add_hi = (add_lo < di).astype(jnp.uint32)
        # bd = s * (di + r) mod 2^64.
        from ..ops.modmath import mul32

        bd_lo, bd_hi = mul32(s, add_lo)
        bd_hi = bd_hi + s * add_hi
        # key = (bd << w_len) | w.  w_len = bitlen(w) is 0 only when w = 0,
        # so the OR with w is correct in every branch; the complementary
        # shift is clamped to 31 and masked out at w_len = 0 (shift-by-32
        # is undefined in XLA).
        klo = (bd_lo << w_len) | w
        comp = jnp.minimum(jnp.uint32(32) - w_len, jnp.uint32(31))
        spill = jnp.where(w_len > 0, bd_lo >> comp, jnp.uint32(0))
        khi = (bd_hi << w_len) | spill
        return klo, khi

    return run


def blind_distance_keys(blinding: Blinding, sq_radius: int, chunk: int = 1 << 20):
    """Yield (klo, khi, count) for di in [0, sq_radius), in fixed-size chunks.

    bd = s * (di + r) mod 2^64; key = (bd << w_len) | w.

    Arrays are u32 device arrays of a FIXED power-of-two size (the final
    chunk is padded by clamping di — idempotent under BF insert); ``count``
    is how many leading entries are fresh keys. Fixed shapes + traced
    scalars mean one compiled executable covers every radius of a sweep.

    The chunk is the SAME for every radius (sizing it to
    next_pow2(sq_radius) recompiled the key-gen and insert executables at
    every radius, and those compiles dominated the whole tc/ts sweep).
    Small radii pad up to one chunk; the scatter is idempotent and the
    calls pipeline, so padding costs only device time.
    """
    chunk = min(chunk, 1 << 16)
    fn = _keys_chunk_fn(chunk)
    s = jnp.uint32(blinding.s)
    w = jnp.uint32(blinding.w)
    w_len = jnp.uint32(blinding.w_len)
    r_lo = jnp.uint32(blinding.r & 0xFFFFFFFF)
    limit = jnp.uint32(sq_radius)
    for start in range(0, sq_radius, chunk):
        klo, khi = fn(s, w, r_lo, jnp.uint32(start), limit, w_len)
        yield klo, khi, min(chunk, sq_radius - start)
