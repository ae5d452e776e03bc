"""Stable binary wire/checkpoint format for parameters and ciphertexts.

The reference ships SEAL's opaque streams over the socket
(``parms.save``/``ct.save``, ``/root/reference/src/client.cc:92-123``); this
framework defines its own versioned little-endian format (SURVEY.md §5
"checkpoint/resume": the wire serialization *is* the persistence format and
must be stable across hosts).

Coefficient packing: per-limb residues are packed to the minimal byte width of
the limb's modulus (SEAL-style compactness) rather than 8 bytes each.
"""

from __future__ import annotations

import struct

import numpy as np

from ..ops import ntt
from .ciphertext import Ciphertext
from .context import BFVContext
from .params import SCHEME_BFV, EncryptionParameters


def _jit_inverse(tb):
    """One-compile NTT inverse for serialization (memoized on the tables).

    Eager ``ntt.inverse`` dispatches every butterfly stage as its own op,
    and each unique op pays its own compile. One jitted executable is one
    compile, persistent-cacheable, one dispatch."""
    fn = getattr(tb, "_ser_inv_jit", None)
    if fn is None:
        import jax

        fn = jax.jit(lambda p: ntt.inverse(p, tb))
        tb._ser_inv_jit = fn
    return fn


def _jit_forward(tb):
    fn = getattr(tb, "_ser_fwd_jit", None)
    if fn is None:
        import jax

        fn = jax.jit(lambda p: ntt.forward(p, tb))
        tb._ser_fwd_jit = fn
    return fn

__all__ = [
    "save_parms",
    "load_parms",
    "save_ciphertext",
    "load_ciphertext",
    "save_public_key",
    "load_public_key",
    "save_secret_key",
    "load_secret_key",
    "save_kswitch_keys",
    "load_kswitch_keys",
    "save_sp_keys",
    "load_sp_keys",
]

_MAGIC_PARMS = b"PPLPprm1"
_MAGIC_CT = b"PPLPctx1"
_MAGIC_PK = b"PPLPpub1"
_MAGIC_SK = b"PPLPsec1"


def save_parms(parms: EncryptionParameters) -> bytes:
    out = [
        _MAGIC_PARMS,
        struct.pack(
            "<BQQH",
            0 if parms.scheme == SCHEME_BFV else 255,
            parms.poly_modulus_degree,
            parms.plain_modulus,
            len(parms.coeff_modulus),
        ),
    ]
    for q in parms.coeff_modulus:
        out.append(struct.pack("<Q", q))
    return b"".join(out)


def load_parms(buf: bytes) -> EncryptionParameters:
    assert buf[:8] == _MAGIC_PARMS, "bad parms magic"
    scheme, n, t, L = struct.unpack_from("<BQQH", buf, 8)
    off = 8 + struct.calcsize("<BQQH")
    chain = struct.unpack_from(f"<{L}Q", buf, off)
    return EncryptionParameters(
        SCHEME_BFV if scheme == 0 else "?", n, tuple(chain), t
    )


def _limb_widths(ctx: BFVContext) -> list[int]:
    return [(m.bit_count + 7) // 8 for m in ctx.moduli]


def _pack_residues(res: np.ndarray, widths) -> bytes:
    """res: u64 [L, n] -> per-limb minimal-width little-endian bytes."""
    parts = []
    for li, w in enumerate(widths):
        full = res[li].astype("<u8").tobytes()
        b = np.frombuffer(full, np.uint8).reshape(-1, 8)[:, :w]
        parts.append(b.tobytes())
    return b"".join(parts)


def _unpack_residues(buf: bytes, off: int, n: int, widths) -> tuple[np.ndarray, int]:
    rows = []
    for w in widths:
        raw = np.frombuffer(buf, np.uint8, n * w, off).reshape(n, w)
        full = np.zeros((n, 8), np.uint8)
        full[:, :w] = raw
        rows.append(np.frombuffer(full.tobytes(), "<u8"))
        off += n * w
    return np.stack(rows), off


def save_ciphertext(ct: Ciphertext, ctx: BFVContext) -> bytes:
    assert ct.domain == "coeff"
    widths = _limb_widths(ctx)
    out = [_MAGIC_CT, struct.pack("<QHB", ctx.n, ctx.L, ct.size)]
    for poly in ct.polys:
        res = ntt.to_numpy(poly, ctx.tables)
        out.append(_pack_residues(res, widths))
    return b"".join(out)


def save_public_key(pk, ctx: BFVContext) -> bytes:
    """Public key wire format: COEFFICIENT-domain pk0 ‖ pk1 residues.

    Keys live on-device in NTT domain, whose spectrum order is an internal
    property of the context's NTT engine; the wire format stores coefficient
    order so keys interoperate across engines/hosts.
    """
    widths = _limb_widths(ctx)
    out = [_MAGIC_PK, struct.pack("<QH", ctx.n, ctx.L)]
    for poly in (pk.pk0_ntt, pk.pk1_ntt):
        coeff = _jit_inverse(ctx.tables)(poly)
        out.append(_pack_residues(ntt.to_numpy(coeff, ctx.tables), widths))
    return b"".join(out)


def load_public_key(buf: bytes, ctx: BFVContext):
    from .keys import PublicKey, _shoup

    assert buf[:8] == _MAGIC_PK, "bad public key magic"
    n, L = struct.unpack_from("<QH", buf, 8)
    assert n == ctx.n and L == ctx.L, "public key/context mismatch"
    off = 8 + struct.calcsize("<QH")
    widths = _limb_widths(ctx)
    polys = []
    for _ in range(2):
        res, off = _unpack_residues(buf, off, n, widths)
        polys.append(_jit_forward(ctx.tables)(ntt.to_device(res, ctx.tables)))
    return PublicKey(
        pk0_ntt=polys[0],
        pk1_ntt=polys[1],
        pk0_shoup=_shoup(ctx, polys[0]),
        pk1_shoup=_shoup(ctx, polys[1]),
    )


def save_secret_key(sk, ctx: BFVContext) -> bytes:
    widths = _limb_widths(ctx)
    coeff = _jit_inverse(ctx.tables)(sk.s_ntt)
    return b"".join(
        [
            _MAGIC_SK,
            struct.pack("<QH", ctx.n, ctx.L),
            _pack_residues(ntt.to_numpy(coeff, ctx.tables), widths),
        ]
    )


def load_secret_key(buf: bytes, ctx: BFVContext):
    from .keys import SecretKey, _shoup

    assert buf[:8] == _MAGIC_SK, "bad secret key magic"
    n, L = struct.unpack_from("<QH", buf, 8)
    assert n == ctx.n and L == ctx.L, "secret key/context mismatch"
    off = 8 + struct.calcsize("<QH")
    res, off = _unpack_residues(buf, off, n, _limb_widths(ctx))
    s = _jit_forward(ctx.tables)(ntt.to_device(res, ctx.tables))
    return SecretKey(s_ntt=s, s_shoup=_shoup(ctx, s))


def load_ciphertext(buf: bytes, ctx: BFVContext) -> Ciphertext:
    assert buf[:8] == _MAGIC_CT, "bad ciphertext magic"
    n, L, k = struct.unpack_from("<QHB", buf, 8)
    assert n == ctx.n and L == ctx.L, "ciphertext/context mismatch"
    off = 8 + struct.calcsize("<QHB")
    widths = _limb_widths(ctx)
    polys = []
    for _ in range(k):
        res, off = _unpack_residues(buf, off, n, widths)
        polys.append(ntt.to_device(res, ctx.tables))
    return Ciphertext(tuple(polys), "coeff")


# -- key-switching keys (relin / Galois; gadget and special-prime) ----------

_MAGIC_KSW = b"PPLPksw1"
_MAGIC_SPK = b"PPLPspk1"


def save_kswitch_keys(keys, ctx: BFVContext) -> bytes:
    """RNS-gadget KSwitchKeys (behz): k digit rows of (b, a), stored in
    coefficient order so they interoperate across NTT engines (SEAL's
    RelinKeys::save counterpart)."""
    import jax

    widths = _limb_widths(ctx)
    k = int(jax.tree.leaves(keys.k0)[0].shape[0])
    out = [_MAGIC_KSW, struct.pack("<QHH", ctx.n, ctx.L, k)]
    for rows in (keys.k0, keys.k1):
        for i in range(k):
            row = jax.tree.map(lambda a: a[i], rows)
            coeff = _jit_inverse(ctx.tables)(row)
            out.append(_pack_residues(ntt.to_numpy(coeff, ctx.tables), widths))
    return b"".join(out)


def load_kswitch_keys(buf: bytes, ctx: BFVContext):
    import jax
    import jax.numpy as jnp

    from .behz import KSwitchKeys
    from .keys import _shoup

    assert buf[:8] == _MAGIC_KSW, "bad kswitch magic"
    n, L, k = struct.unpack_from("<QHH", buf, 8)
    assert n == ctx.n and L == ctx.L, "kswitch keys/context mismatch"
    off = 8 + struct.calcsize("<QHH")
    widths = _limb_widths(ctx)
    stacks = []
    for _ in range(2):
        rows = []
        for _ in range(k):
            res, off = _unpack_residues(buf, off, n, widths)
            rows.append(_jit_forward(ctx.tables)(ntt.to_device(res, ctx.tables)))
        stacks.append(rows)
    stack = lambda rows: jax.tree.map(lambda *xs: jnp.stack(xs), *rows)
    shoup = lambda rows: jax.tree.map(
        lambda *xs: jnp.stack(xs), *[_shoup(ctx, r) for r in rows]
    )
    # Reconstruct the gadget groups from the digit count (keys are always
    # built with contiguous equal-width groups): D == L is the per-limb
    # gadget; D < L implies width ceil(L/D).
    from .behz import _digit_groups

    width = (L + k - 1) // k
    groups = _digit_groups(L, width)
    return KSwitchKeys(
        k0=stack(stacks[0]), k0_shoup=shoup(stacks[0]),
        k1=stack(stacks[1]), k1_shoup=shoup(stacks[1]),
        groups=groups,
    )


def save_sp_keys(spk, ctx: BFVContext) -> bytes:
    """Special-prime SPKeys: k digit rows of (b, a) over Q∪{P}."""
    import jax

    ctx_qp = spk.ctx_qp
    widths = _limb_widths(ctx_qp)
    k = int(jax.tree.leaves(spk.k0)[0].shape[0])
    out = [_MAGIC_SPK, struct.pack("<QHHQ", ctx.n, ctx.L, k, spk.P)]
    for rows in (spk.k0, spk.k1):
        for i in range(k):
            row = jax.tree.map(lambda a: a[i], rows)
            coeff = _jit_inverse(ctx_qp.tables)(row)
            out.append(_pack_residues(ntt.to_numpy(coeff, ctx_qp.tables), widths))
    return b"".join(out)


def load_sp_keys(buf: bytes, ctx: BFVContext):
    import jax

    from .keyswitch import make_sp_keys

    assert buf[:8] == _MAGIC_SPK, "bad sp-keys magic"
    n, L, k, P = struct.unpack_from("<QHHQ", buf, 8)
    assert n == ctx.n and L == ctx.L, "sp keys/context mismatch"
    ctx_qp = BFVContext.build(
        ctx.parms.with_coeff_modulus(
            tuple(m.value for m in ctx.moduli) + (int(P),)
        ),
        engine=ctx.tables.engine,
    )
    off = 8 + struct.calcsize("<QHHQ")
    widths = _limb_widths(ctx_qp)
    stacks = []
    for _ in range(2):
        rows = []
        for _ in range(k):
            res, off = _unpack_residues(buf, off, n, widths)
            rows.append(
                _jit_forward(ctx_qp.tables)(ntt.to_device(res, ctx_qp.tables))
            )
        stacks.append(rows)
    return make_sp_keys(ctx, ctx_qp, int(P), stacks[0], stacks[1])
