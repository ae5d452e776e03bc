"""Bloom filter, bit-compatible with the reference's Partow-derived filter.

The reference vendors the Open Bloom Filter with pplp-added packed binary
(de)serialization (``/root/reference/include/bloomfilter.h``). Serialized
filters cross the wire between the two protocol roles, so this implementation
reproduces the exact observable behavior — parameter optimization
(``bloom_parameters::compute_optimal_parameters``, bloomfilter.h:98-151), salt
schedule (``generate_unique_salt``, :459-525), the AP hash chain (``hash_ap``,
:527-583), bit indexing (:452-457), and the packed wire format
(``bf_hdr`` ‖ salts ‖ bit table, :218-278) — while replacing the scalar
insert/contains loops (the reference's hot loop #1: up to 67M inserts,
``src/server.cc:95-98``) with batched device kernels: all (key × salt) hashes
are computed as vectorized u32 lane ops and scattered into a device bit table.
"""

from __future__ import annotations

import functools
import math
import struct
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["BloomParameters", "BloomFilter", "CompressibleBloomFilter"]

BITS_PER_CHAR = 8

# Partow's public predefined salt table (bloomfilter.h:468-490).
_PREDEF_SALT = [
    0xAAAAAAAA, 0x55555555, 0x33333333, 0xCCCCCCCC, 0x66666666, 0x99999999,
    0xB5B5B5B5, 0x4B4B4B4B, 0xAA55AA55, 0x55335533, 0x33CC33CC, 0xCC66CC66,
    0x66996699, 0x99B599B5, 0xB54BB54B, 0x4BAA4BAA, 0xAA33AA33, 0x55CC55CC,
    0x33663366, 0xCC99CC99, 0x66B566B5, 0x994B994B, 0xB5AAB5AA, 0xAAAAAA33,
    0x555555CC, 0x33333366, 0xCCCCCC99, 0x666666B5, 0x9999994B, 0xB5B5B5AA,
    0xFFFFFFFF, 0xFFFF0000, 0xB823D5EB, 0xC1191CDF, 0xF623AEB3, 0xDB58499F,
    0xC8D42E70, 0xB173F616, 0xA91A5967, 0xDA427D63, 0xB1E8A2EA, 0xF6C0D155,
    0x4909FEA3, 0xA68CC6A7, 0xC395E782, 0xA26057EB, 0x0CD5DA28, 0x467C5492,
    0xF15E6982, 0x61C6FAD3, 0x9615E352, 0x6E9E355A, 0x689B563E, 0x0C9831A8,
    0x6753C18B, 0xA622689B, 0x8CA63C47, 0x42CC2884, 0x8E89919B, 0x6EDBD7D3,
    0x15B6796C, 0x1D6FDFE4, 0x63FF9092, 0xE7401432, 0xEFFE9412, 0xAEAEDF79,
    0x9F245A31, 0x83C136FC, 0xC3DA4A8C, 0xA5112C8C, 0x5271F491, 0x9A948DAB,
    0xCEE59A8D, 0xB5F525AB, 0x59D13217, 0x24E7C331, 0x697C2103, 0x84B0A460,
    0x86156DA9, 0xAEF2AC68, 0x23243DA5, 0x3F649643, 0x5FA495A8, 0x67710DF8,
    0x9A6C499E, 0xDCFB0227, 0x46A43433, 0x1832B07A, 0xC46AFF3C, 0xB9C8FFF0,
    0xC9500467, 0x34431BDF, 0xB652432B, 0xE367F12B, 0x427F4C1B, 0x224C006E,
    0x2E7E5A89, 0x96F99AA5, 0x0BEB452A, 0x2FD87C39, 0x74B2E1FB, 0x222EFD24,
    0xF357F60C, 0x440FCB1E, 0x8BBE030F, 0x6704DC29, 0x1144D12F, 0x948B1355,
    0x6D8FD7E9, 0x1C11A014, 0xADD1592F, 0xFB3C712E, 0xFC77642F, 0xF9C4CE8C,
    0x31312FB9, 0x08B0DD79, 0x318FA6E7, 0xC040D23D, 0xC0589AA7, 0x0CA5C075,
    0xF874B172, 0x0CF914D5, 0x784D3280, 0x4E8CFEBC, 0xC569F575, 0xCDB2A091,
    0x2CC016B4, 0x5C5F4421,
]

_M32 = 0xFFFFFFFF
_HDR = struct.Struct("<IQQQQd")  # packed bf_hdr (bloomfilter.h:218-225)


@dataclass
class BloomParameters:
    """Mirror of ``bloom_parameters`` with identical optimization math.

    ``index_mode`` selects how a hash maps to a bit index:
      * "reference" — exactly Partow/pplp: ``hash % table_size``. For the
        protocol's shifted keys ((bd << w_len) | w) the AP hash is affine in
        the key, its low w_len bits are constant, and since table_size shares
        a power-of-two factor with the key stride each salt can only reach a
        tiny fraction of slots — the reference silently runs with a massively
        inflated false-positive rate.
      * "mixed" (sound default for this framework's protocols) — applies a
        32-bit avalanche finalizer (murmur3 fmix32) to the hash before
        indexing, restoring uniformity. Wire format is unchanged; both roles
        must agree on the mode (protocol config carries it).
    """

    projected_element_count: int = 10000
    false_positive_probability: float = 1.0 / 10000
    random_seed: int = 0xA5A5A5A55A5A5A5A
    minimum_size: int = 1
    maximum_size: int = (1 << 64) - 1
    minimum_number_of_hashes: int = 1
    maximum_number_of_hashes: int = (1 << 32) - 1
    index_mode: str = "reference"
    number_of_hashes: int = field(default=0, init=False)
    table_size: int = field(default=0, init=False)

    def compute_optimal_parameters(self) -> bool:
        if (
            self.projected_element_count == 0
            or self.false_positive_probability < 0.0
            or self.random_seed in (0, (1 << 64) - 1)
        ):
            return False
        min_m = math.inf
        min_k = 0.0
        k = 1.0
        while k < 1000.0:
            numerator = -k * self.projected_element_count
            denominator = math.log(
                1.0 - self.false_positive_probability ** (1.0 / k)
            )
            curr_m = numerator / denominator
            if curr_m < min_m:
                min_m = curr_m
                min_k = k
            k += 1.0
        self.number_of_hashes = int(min_k)
        self.table_size = int(min_m)
        rem = self.table_size % BITS_PER_CHAR
        if rem:
            self.table_size += BITS_PER_CHAR - rem
        self.number_of_hashes = min(
            max(self.number_of_hashes, self.minimum_number_of_hashes),
            self.maximum_number_of_hashes,
        )
        self.table_size = min(max(self.table_size, self.minimum_size), self.maximum_size)
        return True


def _hash_ap_bytes(data: bytes, h: int) -> int:
    """Reference AP hash over a byte string (host scalar path)."""
    i = 0
    loop = 0
    remaining = len(data)
    while remaining >= 8:
        i1 = int.from_bytes(data[i : i + 4], "little")
        i2 = int.from_bytes(data[i + 4 : i + 8], "little")
        h ^= ((h << 7) & _M32) ^ ((i1 * (h >> 3)) & _M32) ^ (
            (~(((h << 11) & _M32) + (i2 ^ (h >> 5)))) & _M32
        )
        h &= _M32
        i += 8
        remaining -= 8
    if remaining >= 4:
        v = int.from_bytes(data[i : i + 4], "little")
        if loop & 1:
            h ^= ((h << 7) & _M32) ^ ((v * (h >> 3)) & _M32)
        else:
            h ^= (~(((h << 11) & _M32) + (v ^ (h >> 5)))) & _M32
        h &= _M32
        loop += 1
        i += 4
        remaining -= 4
    if remaining >= 2:
        v = int.from_bytes(data[i : i + 2], "little")
        if loop & 1:
            h ^= ((h << 7) & _M32) ^ ((v * (h >> 3)) & _M32)
        else:
            h ^= (~(((h << 11) & _M32) + (v ^ (h >> 5)))) & _M32
        h &= _M32
        loop += 1
        i += 2
        remaining -= 2
    if remaining:
        h = (h + ((data[i] ^ ((h * 0xA5A5A5A5) & _M32)) + loop)) & _M32
    return h


def _fmix32_int(h: int) -> int:
    """murmur3 32-bit finalizer (host scalar)."""
    h &= _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


def _fmix32_vec(h):
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> 16)


def _hash_ap_u64_vec(klo, khi, salts):
    """Vectorized AP hash of 8-byte little-endian keys: [S,1] x [K] -> [S,K].

    Exactly one 8-byte iteration of the reference chain (bloomfilter.h:533-543)
    with i1 = low word, i2 = high word.
    """
    h = salts[:, None]
    i1 = klo[None, :]
    i2 = khi[None, :]
    return h ^ ((h << 7) ^ i1 * (h >> 3) ^ (~((h << 11) + (i2 ^ (h >> 5)))))


def _indices(klo, khi, salts, table_size, mixed: bool):
    h = _hash_ap_u64_vec(klo, khi, salts)
    if mixed:
        h = _fmix32_vec(h)
    return h % table_size


@functools.lru_cache(maxsize=64)
def _insert_scan_fn(mixed: bool, nchunks: int, chunk: int):
    """Jitted whole-batch insert: hash x salts -> index -> OR-scatter, with
    the table size traced so every sweep radius reuses one executable (the
    bit-table length still specializes the compile, once per radius)."""

    def _one(bits, lo, hi, salts, ts):
        idx = _indices(lo, hi, salts, ts, mixed).ravel()
        return bits.at[idx].set(jnp.uint8(1))

    @jax.jit
    def run(bits, klo2, khi2, salts, ts):
        if nchunks == 1:
            return _one(bits, klo2[0], khi2[0], salts, ts)

        def body(b, kc):
            return _one(b, kc[0], kc[1], salts, ts), None

        bits, _ = jax.lax.scan(body, bits, (klo2, khi2))
        return bits

    return run


@functools.lru_cache(maxsize=8)
def _contains_fn(mixed: bool):
    @jax.jit
    def run(bits, klo, khi, salts, ts):
        idx = _indices(klo, khi, salts, ts, mixed)
        return jnp.all(bits[idx] != 0, axis=0)

    return run


def _chain_indices(klo, khi, salts, sizes, mixed: bool):
    h = _hash_ap_u64_vec(klo, khi, salts)
    if mixed:
        h = _fmix32_vec(h)
    for s in sizes:
        h = h % jnp.uint32(s)
    return h


@functools.lru_cache(maxsize=16)
def _chain_insert_fn(mixed: bool, sizes: tuple):
    @jax.jit
    def run(bits, klo, khi, salts):
        idx = _chain_indices(klo, khi, salts, sizes, mixed).ravel()
        return bits.at[idx].set(jnp.uint8(1))

    return run


@functools.lru_cache(maxsize=16)
def _chain_contains_fn(mixed: bool, sizes: tuple):
    @jax.jit
    def run(bits, klo, khi, salts):
        idx = _chain_indices(klo, khi, salts, sizes, mixed)
        return jnp.all(bits[idx] != 0, axis=0)

    return run


@functools.lru_cache(maxsize=16)
def _pack_bits_fn(m: int):
    """Device-side little-endian packbits (matches np.packbits bitorder).

    Lane-aligned formulation: the obvious reshape(-1, 8) + weighted sum made
    the AOT compiler pick a one-element-per-tile layout (a 20 GB allocation
    for a 5 Mbit table — observed killing the r=512 sweep serialize).
    Reshaping to [rows, 128] keeps the minor axis a full vector register;
    byte k of a row gathers lanes k, k+8, ..., k+120 via strided lane
    slices, all in uint8."""
    pad = (-m) % 1024

    @jax.jit
    def run(bits):
        if pad:
            bits = jnp.concatenate([bits, jnp.zeros(pad, jnp.uint8)])
        b2 = bits.reshape(-1, 128)  # [rows, 128] u8, lane-aligned
        acc = None
        for k in range(8):
            part = b2[:, k::8] << jnp.uint8(k)  # [rows, 16]
            acc = part if acc is None else acc | part
        out = acc.reshape(-1)
        return out[: (m + 7) // 8]

    return run


class BloomFilter:
    """Bit-compatible Bloom filter with device-batched hot paths."""

    def __init__(self, params: BloomParameters | None = None):
        if params is None:
            self.salt_count = 0
            self.table_size = 0
            self.projected_element_count = 0
            self.inserted_element_count = 0
            self.random_seed = 0
            self.desired_fpp = 0.0
            self.salts = np.zeros(0, np.uint32)
            self.bit_table = np.zeros(0, np.uint8)
            self._device_bits = None
            self.index_mode = "reference"
            return
        assert params.table_size, "call compute_optimal_parameters() first"
        self.projected_element_count = params.projected_element_count
        self.inserted_element_count = 0
        self.random_seed = (params.random_seed * 0xA5A5A5A5 + 1) % (1 << 64)
        self.desired_fpp = params.false_positive_probability
        self.salt_count = params.number_of_hashes
        self.table_size = params.table_size
        self.index_mode = params.index_mode
        self.salts = self._generate_unique_salt()
        self.bit_table = np.zeros(self.table_size // BITS_PER_CHAR, np.uint8)
        self._device_bits = None  # lazily-materialized jnp uint8 [table_size]

    # -- salt schedule (bloomfilter.h:459-525) --------------------------

    def _generate_unique_salt(self) -> np.ndarray:
        if self.salt_count > len(_PREDEF_SALT):
            raise NotImplementedError(
                "salt_count > 128 requires libc rand() replication; the "
                "reference never exceeds 128 (fpp >= 1e-38)"
            )
        salts = [int(s) for s in _PREDEF_SALT[: self.salt_count]]
        seed32 = self.random_seed & _M32
        for i in range(len(salts)):
            # Sequential in-place mixing — later entries see mixed neighbors.
            salts[i] = (salts[i] * salts[(i + 3) % len(salts)] + seed32) & _M32
        return np.asarray(salts, np.uint32)

    # -- host scalar paths (exact reference semantics) ------------------

    def _indices(self, data: bytes):
        for s in self.salts:
            h = _hash_ap_bytes(data, int(s))
            if self.index_mode == "mixed":
                h = _fmix32_int(h)
            yield h % self.table_size

    def insert_bytes(self, data: bytes):
        self._sync_host()
        for bit_index in self._indices(data):
            self.bit_table[bit_index // 8] |= 1 << (bit_index % 8)
        self.inserted_element_count += 1
        self._device_bits = None

    def contains_bytes(self, data: bytes) -> bool:
        self._sync_host()
        return all(
            self.bit_table[b // 8] & (1 << (b % 8)) for b in self._indices(data)
        )

    def insert_u64(self, key: int):
        self.insert_bytes(int(key).to_bytes(8, "little"))

    def contains_u64(self, key: int) -> bool:
        return self.contains_bytes(int(key).to_bytes(8, "little"))

    # -- device batch paths (the hot loop) -------------------------------

    def _bits_device(self):
        if self._device_bits is None:
            if self.inserted_element_count == 0 and not self.bit_table.any():
                # Fresh filter: build zeros ON device (at r=4096 the unpacked
                # table is ~320 MB — never ship that through the host link).
                self._device_bits = jnp.zeros(self.table_size, jnp.uint8)
            else:
                bits = np.unpackbits(self.bit_table, bitorder="little")
                self._device_bits = jnp.asarray(bits)
        return self._device_bits

    def _salts_device(self):
        if getattr(self, "_salts_dev", None) is None:
            self._salts_dev = jnp.asarray(self.salts)
        return self._salts_dev

    def _idx_batch(self, klo, khi):
        assert self.table_size < (1 << 32), "device path needs u32 indices"
        h = _hash_ap_u64_vec(jnp.asarray(klo), jnp.asarray(khi), self._salts_device())
        if self.index_mode == "mixed":
            h = _fmix32_vec(h)
        return h % jnp.uint32(self.table_size)

    # Fixed chunk so the scatter kernel compiles ONCE for every radius of a
    # sweep (r^2 inserts vary 16..4096^2): the last chunk is padded by
    # REPEATING keys — an OR-scatter is idempotent, so padding is free.
    _INSERT_CHUNK = 1 << 20

    def insert_u64_batch(self, klo, khi, count: int | None = None):
        """Insert u64 keys given as u32 (lo, hi) device arrays [K].

        ``count`` marks how many leading keys are fresh (the tail of a padded
        chunk repeats valid keys — see ``blind_distance_keys``); it only
        affects ``inserted_element_count``, never the bit table.

        The whole pipeline (hash x salts, index, scatter) is ONE jitted call
        per chunk with the table size traced, so a radius sweep re-dispatches
        cached executables instead of recompiling eager ops per radius.
        """
        klo = jnp.ravel(jnp.asarray(klo))
        khi = jnp.ravel(jnp.asarray(khi))
        n = klo.shape[-1] if count is None else int(count)
        size = klo.shape[-1]
        chunk = min(self._INSERT_CHUNK, 1 << max(4, (size - 1).bit_length()))
        pad = (-size) % chunk
        if pad:
            klo = jnp.concatenate([klo, jnp.broadcast_to(klo[:1], (pad,))])
            khi = jnp.concatenate([khi, jnp.broadcast_to(khi[:1], (pad,))])
        nchunks = (size + pad) // chunk
        fn = _insert_scan_fn(self.index_mode == "mixed", nchunks, chunk)
        self._device_bits = fn(
            self._bits_device(),
            klo.reshape(nchunks, chunk),
            khi.reshape(nchunks, chunk),
            self._salts_device(),
            jnp.uint32(self.table_size),
        )
        self.inserted_element_count += n
        self._host_dirty = True

    def contains_u64_batch(self, klo, khi):
        """Membership for a batch of u64 keys -> bool array [K]."""
        fn = _contains_fn(self.index_mode == "mixed")
        return fn(
            self._bits_device(),
            jnp.asarray(klo),
            jnp.asarray(khi),
            self._salts_device(),
            jnp.uint32(self.table_size),
        )

    def _sync_host(self):
        if self._device_bits is not None and getattr(self, "_host_dirty", False):
            # Pack bits -> bytes ON device: 8x less host-link traffic.
            packed = _pack_bits_fn(int(self._device_bits.shape[0]))(self._device_bits)
            self.bit_table = np.asarray(jax.device_get(packed))
            self._host_dirty = False

    # -- set algebra (bloomfilter.h:410-444) ----------------------------

    def _compatible(self, other) -> bool:
        return (
            self.salt_count == other.salt_count
            and self.table_size == other.table_size
            and self.random_seed == other.random_seed
        )

    def __iand__(self, other):
        if self._compatible(other):
            self._sync_host()
            other._sync_host()
            self.bit_table &= other.bit_table
            self._device_bits = None
        return self

    def __ior__(self, other):
        if self._compatible(other):
            self._sync_host()
            other._sync_host()
            self.bit_table |= other.bit_table
            self._device_bits = None
        return self

    def __ixor__(self, other):
        if self._compatible(other):
            self._sync_host()
            other._sync_host()
            self.bit_table ^= other.bit_table
            self._device_bits = None
        return self

    def clear(self):
        self._sync_host()
        self.bit_table[:] = 0
        self.inserted_element_count = 0
        self._device_bits = None

    def effective_fpp(self) -> float:
        k = len(self.salts)
        return (1.0 - math.exp(-1.0 * k * self.inserted_element_count / self.table_size)) ** k

    # -- wire format (bloomfilter.h:218-278) ----------------------------

    def compute_serialization_size(self) -> int:
        return _HDR.size + 4 * len(self.salts) + self.table_size // 8

    def _header_bytes(self) -> bytes:
        return _HDR.pack(
            self.salt_count,
            self.table_size,
            self.projected_element_count,
            self.inserted_element_count,
            self.random_seed,
            self.desired_fpp,
        ) + self.salts.tobytes()

    def serialize(self) -> bytes:
        self._sync_host()
        return self._header_bytes() + self.bit_table.tobytes()

    def iter_serialized(self, chunk_bytes: int = 16 << 20):
        """Yield the exact ``serialize()`` byte stream incrementally.

        When the table lives on device, the packed bit table is fetched in
        ``chunk_bytes`` slices with ``copy_to_host_async`` issued for ALL
        slices up front, so later chunks cross the device-to-host link
        WHILE earlier chunks are being consumed — e.g. written to a socket
        (``Channel.send_frame_stream``). At r=8192 the table is 161 MB;
        overlap hides its fetch behind the wire transfer. Also refreshes the host
        ``bit_table`` cache, so a later ``serialize()`` is free."""
        yield self._header_bytes()
        if self._device_bits is None or not getattr(self, "_host_dirty", False):
            table = self.bit_table.tobytes()
            for off in range(0, len(table), chunk_bytes):
                yield table[off : off + chunk_bytes]
            return
        import jax

        packed = _pack_bits_fn(int(self._device_bits.shape[0]))(self._device_bits)
        nbytes = int(packed.shape[0])
        rows = max(1, (nbytes + chunk_bytes - 1) // chunk_bytes)
        dev_rows = [
            packed[i * chunk_bytes : min((i + 1) * chunk_bytes, nbytes)]
            for i in range(rows)
        ]
        for r in dev_rows:
            try:
                r.copy_to_host_async()
            except Exception:  # backend without async copies: sync fallback
                break
        host_rows = []
        for r in dev_rows:
            h = np.asarray(jax.device_get(r))
            host_rows.append(h)
            yield h.tobytes()
        self.bit_table = np.concatenate(host_rows) if host_rows else self.bit_table
        self._host_dirty = False

    @classmethod
    def deserialize(cls, buf: bytes, index_mode: str = "reference") -> "BloomFilter":
        bf = cls()
        bf.index_mode = index_mode
        (
            bf.salt_count,
            bf.table_size,
            bf.projected_element_count,
            bf.inserted_element_count,
            bf.random_seed,
            bf.desired_fpp,
        ) = _HDR.unpack_from(buf, 0)
        off = _HDR.size
        bf.salts = np.frombuffer(buf, np.uint32, bf.salt_count, off).copy()
        off += 4 * bf.salt_count
        bf.bit_table = np.frombuffer(buf, np.uint8, bf.table_size // 8, off).copy()
        bf._device_bits = None
        return bf

    def __eq__(self, other):
        if not isinstance(other, BloomFilter):
            return NotImplemented
        self._sync_host()
        other._sync_host()
        return (
            self._compatible(other)
            and self.inserted_element_count == other.inserted_element_count
            and (self.bit_table == other.bit_table).all()
        )


class CompressibleBloomFilter(BloomFilter):
    """Partow's ``compressible_bloom_filter`` (bloomfilter.h:613-688):
    the bit table can shrink after construction; lookups chain the modulus
    through every historical size so old insertions keep resolving.

    ``compress(percentage)`` folds the table (OR of wrapped cells) to
    (100-percentage)% of its current size, byte-aligned; returns False (and
    leaves the filter unchanged) for out-of-range or degenerate requests."""

    def __init__(self, params: BloomParameters | None = None):
        super().__init__(params)
        self.size_list = [self.table_size] if self.table_size else []

    def _index_chain(self, h: int) -> int:
        for s in self.size_list:
            h %= s
        return h

    def _indices(self, data: bytes):
        for s in self.salts:
            h = _hash_ap_bytes(data, int(s))
            if self.index_mode == "mixed":
                h = _fmix32_int(h)
            yield self._index_chain(h)

    def _idx_batch(self, klo, khi):
        assert self.table_size < (1 << 32)
        salts = jnp.asarray(self.salts)
        h = _hash_ap_u64_vec(jnp.asarray(klo), jnp.asarray(khi), salts)
        if self.index_mode == "mixed":
            h = _fmix32_vec(h)
        for s in self.size_list:
            h = h % jnp.uint32(s)
        return h

    # The compressible variant indexes through the historical size chain, so
    # the base class's single-mod jitted kernels don't apply; these chain
    # versions are jit-cached per (index_mode, size chain). Not the 67M-insert
    # hot path, so no chunking.

    def insert_u64_batch(self, klo, khi, count: int | None = None):
        klo = jnp.ravel(jnp.asarray(klo))
        khi = jnp.ravel(jnp.asarray(khi))
        n = klo.shape[-1] if count is None else int(count)
        fn = _chain_insert_fn(self.index_mode == "mixed", tuple(self.size_list))
        self._device_bits = fn(self._bits_device(), klo, khi, self._salts_device())
        self.inserted_element_count += n
        self._host_dirty = True

    def contains_u64_batch(self, klo, khi):
        fn = _chain_contains_fn(self.index_mode == "mixed", tuple(self.size_list))
        return fn(
            self._bits_device(),
            jnp.asarray(klo),
            jnp.asarray(khi),
            self._salts_device(),
        )

    def serialize(self) -> bytes:
        """Base wire format ‖ u16 size-chain length ‖ u64 sizes."""
        base = super().serialize()
        import struct as _struct

        tail = _struct.pack("<H", len(self.size_list))
        tail += b"".join(_struct.pack("<Q", sz) for sz in self.size_list)
        return base + tail

    @classmethod
    def deserialize(cls, buf: bytes, index_mode: str = "reference"):
        import struct as _struct

        bf = super().deserialize(buf, index_mode)
        # super() returns a CompressibleBloomFilter (cls-aware) but via
        # __init__(None), so reconstruct the size chain from the tail.
        off = _HDR.size + 4 * bf.salt_count
        # bit_table length is the CURRENT (possibly compressed) table size.
        off += bf.table_size // 8
        (n_sizes,) = _struct.unpack_from("<H", buf, off)
        off += 2
        bf.size_list = [
            _struct.unpack_from("<Q", buf, off + 8 * i)[0] for i in range(n_sizes)
        ]
        assert bf.size_list and bf.size_list[-1] == bf.table_size
        return bf

    def compute_serialization_size(self) -> int:
        return super().compute_serialization_size() + 2 + 8 * len(self.size_list)

    def iter_serialized(self, chunk_bytes: int = 16 << 20):
        # The compressible wire format interleaves the size chain; stream it
        # from the fully-serialized bytes (tables are small post-compress).
        data = self.serialize()
        for off in range(0, len(data), chunk_bytes):
            yield data[off : off + chunk_bytes]

    def compress(self, percentage: float) -> bool:
        if not (0.0 < percentage < 100.0):
            return False
        self._sync_host()
        original = self.table_size
        new_size = int(original * (1.0 - percentage / 100.0))
        new_size -= new_size % BITS_PER_CHAR
        if new_size < BITS_PER_CHAR or new_size >= original:
            return False
        bits = np.unpackbits(self.bit_table, bitorder="little")[:original]
        folded = np.zeros(new_size, np.uint8)
        idx = np.arange(original) % new_size
        np.bitwise_or.at(folded, idx, bits)
        self.bit_table = np.packbits(folded, bitorder="little")
        self.table_size = new_size
        self.size_list.append(new_size)
        self._device_bits = None
        return True
