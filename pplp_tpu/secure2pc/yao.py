"""Yao garbled circuits for the A2Y comparison: free-XOR + point-and-permute.

Completes the ABY-parity story for the pplp predicates: the reference's
arith+Yao variants (src/aby/circ_ay/pplp.cpp:115-139) convert the shared
distance to Yao sharing and evaluate GT inside the garbled circuit, so no
party ever sees the blinded distance. This module does the same between two
real parties:

  * wires carry 16-byte labels; XOR gates are free (global offset R, lsb(R)=1
    is the point-and-permute bit);
  * AND gates use half-gates (Zahur-Rosulek-Evans): two SHA-256-encrypted
    ciphertexts per gate, free-XOR compatible;
  * the evaluator's input labels arrive by oblivious transfer (ot.iknp_*),
    the garbler's by direct send;
  * the circuit is the 32-bit A2Y adder (1 AND/bit via the free-XOR full
    adder) followed by a 32-bit LT borrow chain (1 AND/bit), so
    "x0 + x1 < thr" costs 64 ANDs per instance.

The batched in-process path (circuits.py) remains the device-vectorized fast
path; this is the two-party transport-faithful one.
"""

from __future__ import annotations

import hashlib
import random

import numpy as np

from . import ot

__all__ = [
    "yao_lt_garbler",
    "yao_lt_evaluator",
    "yao_any_negative_garbler",
    "yao_any_negative_evaluator",
]

LBYTES = 16
NBITS = 32


def _h(a: bytes, b: bytes, gid: int) -> bytes:
    return hashlib.sha256(
        b"pplp-yao" + gid.to_bytes(4, "little") + a + b
    ).digest()[:LBYTES]


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


class _Garble:
    """Garbler state for one circuit instance."""

    def __init__(self, rng: random.Random):
        r = bytearray(rng.randbytes(LBYTES))
        r[0] |= 1  # lsb(R) = 1: permute bit flips with the truth value
        self.R = bytes(r)
        self.rng = rng
        self.gid = 0
        self.tables: list[bytes] = []

    def wire(self) -> bytes:
        return self.rng.randbytes(LBYTES)

    def xor(self, a: bytes, b: bytes) -> bytes:
        return _xor(a, b)

    def not_(self, a: bytes) -> bytes:
        return _xor(a, self.R)

    def and_(self, a0: bytes, b0: bytes) -> bytes:
        """Garble an AND gate with half-gates (Zahur–Rosulek–Evans): two
        ciphertexts per gate, free-XOR compatible. Returns the output
        0-label and appends the (TG ‖ TE) table."""
        gid = self.gid
        self.gid += 1
        R = self.R
        a1 = _xor(a0, R)
        b1 = _xor(b0, R)
        pa = a0[0] & 1
        pb = b0[0] & 1
        zero = b"\x00" * LBYTES
        # Garbler half: computes a AND pb.
        ha0 = _h(a0, zero, 2 * gid)
        ha1 = _h(a1, zero, 2 * gid)
        tg = _xor(ha0, ha1)
        if pb:
            tg = _xor(tg, R)
        wg0 = _xor(ha0, tg) if pa else ha0
        # Evaluator half: computes a AND (b xor pb).
        hb0 = _h(b0, zero, 2 * gid + 1)
        hb1 = _h(b1, zero, 2 * gid + 1)
        te = _xor(_xor(hb0, hb1), a0)
        we0 = _xor(hb0, _xor(te, a0)) if pb else hb0
        self.tables.append(tg + te)
        return _xor(wg0, we0)


class _Eval:
    """Evaluator state: consumes tables in garbling order."""

    def __init__(self, tables: list[bytes]):
        self.tables = tables
        self.gid = 0

    def xor(self, a: bytes, b: bytes) -> bytes:
        return _xor(a, b)

    def not_(self, a: bytes) -> bytes:
        return a  # semantics flip only; the label is the same wire

    def and_(self, a: bytes, b: bytes) -> bytes:
        tbl = self.tables[self.gid]
        gid = self.gid
        self.gid += 1
        tg = tbl[:LBYTES]
        te = tbl[LBYTES:]
        zero = b"\x00" * LBYTES
        sa = a[0] & 1
        sb = b[0] & 1
        wg = _h(a, zero, 2 * gid)
        if sa:
            wg = _xor(wg, tg)
        we = _h(b, zero, 2 * gid + 1)
        if sb:
            we = _xor(we, _xor(te, a))
        return _xor(wg, we)


def _circuit(g, e_bits, g_bits, t_bits, zero):
    """(x0 + x1 mod 2^32) < thr as labels.

    e_bits = evaluator-share input wires, g_bits = garbler-share wires,
    t_bits = threshold wires, ``zero`` = a constant-0 wire label.

    Full adder (1 AND/bit):  s = a^b^c;  c' = c ^ ((a^c) & (b^c)).
    LT borrow (1 AND/bit):   br' = br ^ ((~s ^ br) & (t ^ br)).
    NOT is label^R for the garbler and a no-op for the evaluator (free-XOR
    complement relabeling), so both sides run this one function with their
    own gate primitives."""
    c = zero
    s_bits = []
    for i in range(NBITS):
        a, b = e_bits[i], g_bits[i]
        ac = g.xor(a, c)
        bc = g.xor(b, c)
        s_bits.append(g.xor(ac, b))
        c = g.xor(c, g.and_(ac, bc))
    br = zero
    for i in range(NBITS):
        x = g.xor(g.not_(s_bits[i]), br)
        y = g.xor(t_bits[i], br)
        br = g.xor(br, g.and_(x, y))
    return br


def _adder_msb(g, e_bits, g_bits, zero):
    """MSB of (x0 + x1 mod 2^32): the sign bit of the shared value."""
    c = zero
    s = None
    for i in range(NBITS):
        a, b = e_bits[i], g_bits[i]
        ac = g.xor(a, c)
        bc = g.xor(b, c)
        s = g.xor(ac, b)
        if i < NBITS - 1:
            c = g.xor(c, g.and_(ac, bc))
    return s


def _or(g, a, b):
    """OR via free NOTs + one AND: a|b = ~(~a & ~b)."""
    return g.not_(g.and_(g.not_(a), g.not_(b)))


def _bits_of(v: int):
    return [(int(v) >> i) & 1 for i in range(NBITS)]


def yao_lt_garbler(ch, share: np.ndarray, thr: int, group: ot.SchnorrGroup,
                   rng: random.Random) -> np.ndarray:
    """Garbler (role 1): holds share x1 [B]; computes x0+x1 < thr jointly.

    Returns bool[B] (both parties learn the bit, as in ABY's ALL output)."""
    share = np.atleast_1d(np.asarray(share)).astype(np.uint64)
    B = len(share)
    ot_pairs0, ot_pairs1 = [], []
    blob_tables = bytearray()
    blob_ginputs = bytearray()
    out_permute = bytearray()
    for n in range(B):
        gb = _Garble(rng)
        e_w = [gb.wire() for _ in range(NBITS)]
        g_w = [gb.wire() for _ in range(NBITS)]
        t_w = [gb.wire() for _ in range(NBITS)]
        zero = gb.wire()
        out0 = _circuit(gb, e_w, g_w, t_w, zero)
        # Evaluator obtains e-labels by OT; garbler sends its own + thr +
        # zero labels in the clear (labels reveal nothing).
        for w in e_w:
            ot_pairs0.append(w)
            ot_pairs1.append(_xor(w, gb.R))
        for bit, w in zip(_bits_of(share[n]), g_w):
            blob_ginputs += _xor(w, gb.R) if bit else w
        for bit, w in zip(_bits_of(thr), t_w):
            blob_ginputs += _xor(w, gb.R) if bit else w
        blob_ginputs += zero
        blob_tables += b"".join(gb.tables)
        out_permute.append(out0[0] & 1)
    ch.send_frame(bytes(blob_tables))
    ch.send_frame(bytes(blob_ginputs))
    ch.send_frame(bytes(out_permute))
    # OT: evaluator chooses with its share bits; pads encrypt the labels.
    m = B * NBITS
    p0, p1 = ot.iknp_send(ch, group, m, rng)
    enc = bytearray()
    for i in range(m):
        enc += _xor(p0[i], ot_pairs0[i])
        enc += _xor(p1[i], ot_pairs1[i])
    ch.send_frame(bytes(enc))
    # Evaluator reports the output bits (ABY "ALL" output).
    result = np.frombuffer(ch.recv_frame(), np.uint8)[:B].astype(bool)
    return result


def yao_lt_evaluator(ch, share: np.ndarray, group: ot.SchnorrGroup,
                     rng: random.Random) -> np.ndarray:
    """Evaluator (role 0): holds share x0 [B]. Returns bool[B]."""
    share = np.atleast_1d(np.asarray(share)).astype(np.uint64)
    B = len(share)
    n_ands = 2 * NBITS
    tbl_bytes = 2 * LBYTES
    blob_tables = ch.recv_frame()
    blob_ginputs = ch.recv_frame()
    out_permute = ch.recv_frame()
    choices = np.array(
        [b for v in share for b in _bits_of(v)], np.uint8
    )
    pads = ot.iknp_recv(ch, group, choices, rng)
    enc = ch.recv_frame()
    e_labels = []
    for i, c in enumerate(choices):
        off = (2 * i + int(c)) * LBYTES
        e_labels.append(_xor(pads[i], enc[off : off + LBYTES]))
    results = np.zeros(B, np.uint8)
    tb_per = n_ands * tbl_bytes
    gi_per = (2 * NBITS + 1) * LBYTES
    for n in range(B):
        tables = [
            blob_tables[n * tb_per + k * tbl_bytes : n * tb_per + (k + 1) * tbl_bytes]
            for k in range(n_ands)
        ]
        ev = _Eval(tables)
        gi = blob_ginputs[n * gi_per : (n + 1) * gi_per]
        g_w = [gi[i * LBYTES : (i + 1) * LBYTES] for i in range(NBITS)]
        t_w = [gi[(NBITS + i) * LBYTES : (NBITS + i + 1) * LBYTES] for i in range(NBITS)]
        zero = gi[2 * NBITS * LBYTES :]
        e_w = e_labels[n * NBITS : (n + 1) * NBITS]
        out = _circuit(ev, e_w, g_w, t_w, zero)
        results[n] = (out[0] & 1) ^ out_permute[n]
    ch.send_frame(results.tobytes())
    return results.astype(bool)


def yao_any_negative_garbler(ch, shares: np.ndarray, group: ot.SchnorrGroup,
                             rng: random.Random) -> np.ndarray:
    """Garbler (role 1): shares [B, E] of E orient values per instance.
    Jointly computes OR_e msb(x0+x1) — "any edge negative" — without
    opening any orient value. Returns bool[B]."""
    shares = np.atleast_2d(np.asarray(shares)).astype(np.uint64)
    B, E = shares.shape
    ot_pairs0, ot_pairs1 = [], []
    blob_tables = bytearray()
    blob_ginputs = bytearray()
    out_permute = bytearray()
    for n in range(B):
        gb = _Garble(rng)
        zero = gb.wire()
        msbs = []
        for e in range(E):
            e_w = [gb.wire() for _ in range(NBITS)]
            g_w = [gb.wire() for _ in range(NBITS)]
            for w in e_w:
                ot_pairs0.append(w)
                ot_pairs1.append(_xor(w, gb.R))
            for bit, w in zip(_bits_of(shares[n, e]), g_w):
                blob_ginputs += _xor(w, gb.R) if bit else w
            msbs.append(_adder_msb(gb, e_w, g_w, zero))
        out = msbs[0]
        for m_ in msbs[1:]:
            out = _or(gb, out, m_)
        blob_ginputs += zero
        blob_tables += b"".join(gb.tables)
        out_permute.append(out[0] & 1)
    ch.send_frame(bytes(blob_tables))
    ch.send_frame(bytes(blob_ginputs))
    ch.send_frame(bytes(out_permute))
    m = B * E * NBITS
    p0, p1 = ot.iknp_send(ch, group, m, rng)
    enc = bytearray()
    for i in range(m):
        enc += _xor(p0[i], ot_pairs0[i])
        enc += _xor(p1[i], ot_pairs1[i])
    ch.send_frame(bytes(enc))
    return np.frombuffer(ch.recv_frame(), np.uint8)[:B].astype(bool)


def yao_any_negative_evaluator(ch, shares: np.ndarray, group: ot.SchnorrGroup,
                               rng: random.Random) -> np.ndarray:
    """Evaluator (role 0) counterpart of ``yao_any_negative_garbler``."""
    shares = np.atleast_2d(np.asarray(shares)).astype(np.uint64)
    B, E = shares.shape
    n_ands = E * (NBITS - 1) + (E - 1)
    tbl_bytes = 2 * LBYTES
    blob_tables = ch.recv_frame()
    blob_ginputs = ch.recv_frame()
    out_permute = ch.recv_frame()
    choices = np.array(
        [b for n in range(B) for e in range(E) for b in _bits_of(shares[n, e])],
        np.uint8,
    )
    pads = ot.iknp_recv(ch, group, choices, rng)
    enc = ch.recv_frame()
    e_labels = []
    for i, c in enumerate(choices):
        off = (2 * i + int(c)) * LBYTES
        e_labels.append(_xor(pads[i], enc[off : off + LBYTES]))
    results = np.zeros(B, np.uint8)
    tb_per = n_ands * tbl_bytes
    gi_per = (E * NBITS + 1) * LBYTES
    for n in range(B):
        tables = [
            blob_tables[n * tb_per + k * tbl_bytes : n * tb_per + (k + 1) * tbl_bytes]
            for k in range(n_ands)
        ]
        ev = _Eval(tables)
        gi = blob_ginputs[n * gi_per : (n + 1) * gi_per]
        zero = gi[E * NBITS * LBYTES :]
        msbs = []
        for e in range(E):
            g_w = [
                gi[(e * NBITS + i) * LBYTES : (e * NBITS + i + 1) * LBYTES]
                for i in range(NBITS)
            ]
            e_w = e_labels[(n * E + e) * NBITS : (n * E + e + 1) * NBITS]
            msbs.append(_adder_msb(ev, e_w, g_w, zero))
        out = msbs[0]
        for m_ in msbs[1:]:
            out = _or(ev, out, m_)
        results[n] = (out[0] & 1) ^ out_permute[n]
    ch.send_frame(results.tobytes())
    return results.astype(bool)
