"""Batched proximity pipeline: one jittable device step over a sharded batch.

This is the framework's "training step" analogue (BASELINE.md config[3]: 100k
encrypted distance+radius checks): for a batch of B independent proximity
queries, run the server's homomorphic blind-distance evaluation AND the
client's decryption dot-product entirely on device:

    bd_ct = s*(c1 + z - xb*c2 - yb*c3) + s*r          (ct x plain ops)
    x     = bd_ct.c0 + bd_ct.c1 * sk                  (decrypt device part)

Inputs/outputs are [B, L, n] residue arrays sharded over ('dp','limb','coeff').
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..bfv import Ciphertext, Decryptor, Evaluator, Plaintext
from ..bfv.encryptor import Encryptor
from ..utils.hexcodec import uint64_to_hex_string

__all__ = [
    "build_batched_pipeline",
    "build_packed_pipeline",
    "build_packed_pipeline_bf",
    "make_batch_inputs",
    "make_packed_inputs",
]


def _plain_pairs(ctx, value: int, full: bool = False):
    """Constant-poly pairs; full=True replicates the value in every
    coefficient (for coefficient-packed batches, where additive terms must
    reach every slot)."""
    if full:
        m = np.full(ctx.n, value % ctx.t, np.uint64)
        return (
            jnp.asarray((m & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((m >> np.uint64(32)).astype(np.uint32)),
        )
    lo, hi = Plaintext(uint64_to_hex_string(value % ctx.t), n=ctx.n).pair_u32(ctx.n)
    return jnp.asarray(lo), jnp.asarray(hi)


def build_batched_pipeline(
    ctx, sk, xb: int, yb: int, s_blind: int, r_blind: int, packed: bool = False
):
    """Returns fn(c1_polys, c2_polys, c3_polys) -> residues [B, L, n].

    The returned function is pure and jittable; ciphertext args are the
    ``polys`` tuples of coefficient-domain ciphertexts. packed=True makes the
    additive terms (z, s*r) reach every coefficient slot.
    """
    ev = Evaluator(ctx)
    dec = Decryptor(ctx, sk)
    z_p = _plain_pairs(ctx, xb * xb + yb * yb, full=packed)
    xb_p = _plain_pairs(ctx, xb)
    yb_p = _plain_pairs(ctx, yb)
    s_p = _plain_pairs(ctx, s_blind)
    sr_p = _plain_pairs(ctx, s_blind * r_blind, full=packed)

    def step(c1_polys, c2_polys, c3_polys):
        c1 = Ciphertext(c1_polys, "coeff")
        c2 = Ciphertext(c2_polys, "coeff")
        c3 = Ciphertext(c3_polys, "coeff")
        c1 = ev.add_plain(c1, z_p)
        c2 = ev.multiply_plain(c2, xb_p)
        c3 = ev.multiply_plain(c3, yb_p)
        c1 = ev.sub(c1, ev.add(c2, c3))
        c1 = ev.multiply_plain(c1, s_p)
        c1 = ev.add_plain(c1, sr_p)
        return dec.ct_value_rns(c1)

    return step


def build_packed_pipeline(ctx, sk, xb: int, yb: int, s_blind: int, r_blind: int):
    """Coefficient-packed pipeline: n proximity checks per ciphertext row.

    Every coefficient j of the plaintext carries one client's (u_j, 2xa_j,
    2ya_j); the server's ops are scalar plain multiplies/adds, which act
    coefficient-wise, so one [B, L, n] ciphertext batch evaluates B*n
    independent checks. Returns fn(c1, c2, c3 polys) -> blind distances
    [B, n] mod t (device BEHZ decode; requires t < 2^30).
    """
    from ..bfv.rns_decrypt import RnsDecoder

    step = build_batched_pipeline(ctx, sk, xb, yb, s_blind, r_blind, packed=True)
    decoder = RnsDecoder(ctx)

    def packed(c1_polys, c2_polys, c3_polys):
        return decoder.decode_mod_t(step(c1_polys, c2_polys, c3_polys))

    return packed


def build_packed_pipeline_bf(
    ctx, sk, xb: int, yb: int, s_blind: int, r_blind: int,
    w: int, w_len: int, mixed: bool = True,
):
    """Full BASELINE config[3] pipeline: homo eval + device decode + blinded
    BF-key formation + Bloom membership probe, one jittable step.

    The reference ends every proximity check with
    ``bf.contains((bd << w_len) | w)`` (``/root/reference/src/demo.cc:171-177``);
    this chains that probe onto the packed decode so the benchmarked step is
    the whole protocol tail. Returns
    ``fn(c1_polys, c2_polys, c3_polys, bits, salts, table_size) -> bool [B, n]``
    where ``bits``/``salts``/``table_size`` come from a
    :class:`~pplp_tpu.primitives.bloom.BloomFilter`'s device views, so filter
    contents change without recompiling. Requires t < 2^30 and 0 < w_len < 32.
    """
    from ..primitives.bloom import _indices

    assert 0 < w_len < 32
    step = build_packed_pipeline(ctx, sk, xb, yb, s_blind, r_blind)

    def fn(c1_polys, c2_polys, c3_polys, bits, salts, table_size):
        bd = step(c1_polys, c2_polys, c3_polys)  # [B, n] u32 mod t
        # key = (bd << w_len) | w as u64 split into u32 words (w < 2^w_len).
        klo = (bd << jnp.uint32(w_len)) | jnp.uint32(w)
        khi = bd >> jnp.uint32(32 - w_len)
        idx = _indices(klo.ravel(), khi.ravel(), salts, table_size, mixed)
        near = jnp.all(bits[idx] != 0, axis=0)
        return near.reshape(bd.shape)

    return fn


def _encrypt3_jit(encryptor: Encryptor, pairs, xa, ya, key):
    """The three protocol encryptions under ONE compiled graph: eager
    encrypt_pairs is ~15 dispatches each, one jit makes them one."""

    def enc3(m1, m2, m3, k):
        k1, k2, k3 = jax.random.split(k, 3)
        return (
            encryptor.encrypt_pairs(*m1, k1).polys,
            encryptor.encrypt_pairs(*m2, k2).polys,
            encryptor.encrypt_pairs(*m3, k3).polys,
        )

    return jax.jit(enc3)(
        pairs(xa * xa + ya * ya),
        pairs(xa * np.uint64(2)),
        pairs(ya * np.uint64(2)),
        key,
    )


def make_packed_inputs(ctx, encryptor: Encryptor, xa, ya, key):
    """Encrypt N = B*n client coordinate pairs packed into coefficients.

    xa, ya: uint arrays [N] with N a multiple of n. Returns the three
    ciphertext poly tuples with [B, L, n] leaves.
    """
    xa = np.asarray(xa, np.uint64)
    ya = np.asarray(ya, np.uint64)
    n = ctx.n
    assert xa.size % n == 0
    B = xa.size // n

    def pairs(vals):
        m = (vals % np.uint64(ctx.t)).reshape(B, n)
        return (
            jnp.asarray((m & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((m >> np.uint64(32)).astype(np.uint32)),
        )

    return _encrypt3_jit(encryptor, pairs, xa, ya, key)


def make_batch_inputs(ctx, encryptor: Encryptor, xa, ya, key):
    """Encrypt a batch of client coordinates -> three ciphertext poly tuples.

    xa, ya: int arrays [B]. Returns (c1.polys, c2.polys, c3.polys) with
    [B, L, n]-shaped leaves.
    """
    xa = np.asarray(xa, np.uint64)
    ya = np.asarray(ya, np.uint64)
    B = xa.shape[0]
    n = ctx.n

    def pairs(vals):
        m = np.zeros((B, n), np.uint64)
        m[:, 0] = vals % np.uint64(ctx.t)
        return (
            jnp.asarray((m & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((m >> np.uint64(32)).astype(np.uint32)),
        )

    return _encrypt3_jit(encryptor, pairs, xa, ya, key)
