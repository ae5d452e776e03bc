"""End-to-end check that the system runs on an NVIDIA GPU.

    python chip_smoke.py                # one GPU: kernel checks + main path
    python chip_smoke.py --four-cards   # four GPUs: the sharded n=32768 phase only
    python chip_smoke.py --rehearse     # CPU at tiny sizes, same phases

Every phase runs in this one process (a JAX process reserves most of a card's
memory, so a second one on the same card would fail for want of it).

Phase A compares each device computation with a plain reference at the widths
the system's users run, with tolerance 0: every device operation here is
modular u32 arithmetic, so results are bit-exact or wrong.

  A1 NTT, "four" engine: n=8192, 3 x 30-bit primes, batch 10240, chunked
     forward+inverse identity on every row, negacyclic products against a
     host big-integer product, "four" against "stage" products on every row.
  A2 NTT, "stage" engine on the SEAL BFVDefault chain at n=8192 (the CLI
     default): round trip on every row and host-checked products.
  A3 BEHZ mult+relin: n=4096, "tpu" chain, batch 256, production relin
     gadget, real encryptions; decrypt(product) equals the plaintext product
     mod t on every row and the size-3 product equals tests/bfv_oracle.py.
  A4 DGK: k=2048, batch 10000, blinded comparisons against Python-int DGK
     (ciphertexts and decryptions) on a sample of rows.
  A5 Bloom: the protocol's r=2048 filter (r^2 = 4,194,304 keys); device bit
     table and device probe against a NumPy reference, itself checked
     against the scalar host hash.

Phase B drives the main path through ``pplp_tpu.cli.main``: ``demo`` at the
reference defaults at a near and a far pair, then one served ``ts``/``tc``
sweep (leg and opt, n=8192) as two threads over a localhost TCP socket.

Each phase prints its shapes, wall time, XLA compile time (including reads of
the persistent compile cache) and the device's peak memory so far. The last
line of stdout is one JSON object naming the device; any failure raises and
the exit code is non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import socket
import sys
import threading
import time

# --rehearse and --four-cards are read before JAX starts: the rehearsal asks
# for the CPU (with four virtual devices for --four-cards) explicitly.
_ARGS = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
_ARGS.add_argument("--four-cards", action="store_true",
                   help="run only the sharded phase on four GPUs")
_ARGS.add_argument("--rehearse", action="store_true",
                   help="run the same phases on the CPU at tiny sizes")

FULL = dict(
    ntt_n=8192, ntt_batch=10240, ntt_chunk=1024, host_rows=4,
    behz_n=4096, behz_batch=256, oracle_rows=2,
    dgk_k=2048, dgk_t=320, dgk_batch=10000, dgk_sample=64,
    bloom_r=2048, bloom_nonmembers=100_000,
    demo=["-d", "13", "-b", "56", "--profile", "seal"],
    sweep=["-d", "13", "-b", "56"], sweep_profile="seal", sweep_max_r=2048,
    dist_n=32768,
)
REHEARSE = dict(
    ntt_n=1024, ntt_batch=16, ntt_chunk=8, host_rows=2,
    behz_n=1024, behz_batch=4, oracle_rows=1,
    dgk_k=512, dgk_t=160, dgk_batch=16, dgk_sample=8,
    bloom_r=64, bloom_nonmembers=1000,
    demo=["-d", "12", "-b", "40", "--profile", "tpu"],
    sweep=["-d", "12", "-b", "40"], sweep_profile="tpu", sweep_max_r=256,
    dist_n=1024,
)


def _log(msg: str) -> None:
    print(msg, flush=True)


class _CompileClock:
    """Sums XLA backend compile time (cache reads included) per phase."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.total = 0.0
        self._lock = threading.Lock()

    def __call__(self, event, duration_secs, **_):
        if event == self.EVENT:
            with self._lock:
                self.total += duration_secs


class Phases:
    def __init__(self, jax, clock: _CompileClock):
        self.jax = jax
        self.clock = clock
        self.compile_total = 0.0

    def _peak(self) -> str:
        stats = self.jax.devices()[0].memory_stats()
        if not stats or "peak_bytes_in_use" not in stats:
            return "not reported"
        return str(stats["peak_bytes_in_use"])

    @contextlib.contextmanager
    def run(self, name: str, shapes: str):
        c0, t0 = self.clock.total, time.perf_counter()
        yield
        wall = time.perf_counter() - t0
        comp = self.clock.total - c0
        self.compile_total += comp
        _log(f"phase {name}: {shapes}; wall {wall:.3f} s; compile {comp:.3f} s; "
             f"peak_bytes_in_use {self._peak()}")


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- host references ---------------------------------------------------------


def host_negacyclic(a, b, q: int):
    """(a * b) mod (x^n + 1) mod q for u64 rows a, b (< 2^57), as a u64
    array, through one Python big-integer product (Kronecker substitution
    with 128-bit slots: n * q^2 < 2^128 for every chain used here)."""
    import numpy as np

    n = len(a)

    def pack(v):
        buf = np.zeros((n, 16), np.uint8)
        buf[:, :8] = np.ascontiguousarray(v, dtype="<u8").view(np.uint8).reshape(n, 8)
        return int.from_bytes(buf.tobytes(), "little")

    raw = np.frombuffer(
        (pack(a) * pack(b)).to_bytes(2 * n * 16, "little"), np.uint8
    ).reshape(2 * n, 16)
    lo = raw[:, :8].copy().view("<u8").ravel().tolist()
    hi = raw[:, 8:].copy().view("<u8").ravel().tolist()
    coef = [x | (y << 64) for x, y in zip(lo, hi)]
    return np.array([(coef[i] - coef[i + n]) % q for i in range(n)], np.uint64)


def np_bloom_indices(klo, khi, salt, table_size: int):
    """NumPy mirror of the protocol's "mixed" Bloom index for one salt."""
    import numpy as np

    h = np.uint32(salt)
    with np.errstate(over="ignore"):
        h = h ^ ((h << np.uint32(7)) ^ (klo * (h >> np.uint32(3)))
                 ^ ~((h << np.uint32(11)) + (khi ^ (h >> np.uint32(5)))))
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    return h % np.uint32(table_size)


# -- phase A -----------------------------------------------------------------


def _random_residues(jax, key, shape, moduli):
    """Uniform-ish residues < q_i on device; (lo, hi) pairs for >32-bit q."""
    import numpy as np

    jnp = jax.numpy
    if all(q < 1 << 32 for q in moduli):
        q = jnp.asarray(np.array(moduli, np.uint32))[:, None]
        return jax.random.bits(key, shape, jnp.uint32) % q
    k_lo, k_hi = jax.random.split(key)
    q_hi = jnp.asarray(np.array([q >> 32 for q in moduli], np.uint32))[:, None]
    lo = jax.random.bits(k_lo, shape, jnp.uint32)
    hi = jax.random.bits(k_hi, shape, jnp.uint32) % q_hi  # hi*2^32+lo < q
    return lo, hi


def _check_host_products(a, b, prod, tb, rows: int, label: str):
    """The first ``rows`` device products equal host big-integer products."""
    import jax

    from pplp_tpu.ops import ntt

    qs = [m.value for m in tb.moduli]
    ha, hb, hp = (ntt.to_numpy(jax.tree.map(lambda t: t[:rows], v), tb)
                  for v in (a, b, prod))
    for r in range(rows):
        for li, q in enumerate(qs):
            want = host_negacyclic(ha[r, li], hb[r, li], q)
            _check((hp[r, li] == want).all(),
                   f"{label}: row {r} limb {li} differs from the host product")


def phase_ntt_four(jax, S, ph):
    from pplp_tpu.ops import ntt
    from pplp_tpu.ops.primes import Modulus, get_primes

    jnp = jax.numpy
    n, B, C = S["ntt_n"], S["ntt_batch"], S["ntt_chunk"]
    moduli = [Modulus(q) for q in get_primes(30, 3, n)]
    tb4 = ntt.build_tables(moduli, n, engine="four")
    tbs = ntt.build_tables(moduli, n, engine="stage")
    shapes = f"n={n} limbs=3x30-bit batch={B} chunk={C}"
    with ph.run("A1.ntt_four", shapes):
        x = _random_residues(jax, jax.random.key(11), (B, 3, n), [m.value for m in moduli])
        y = jnp.roll(x, 1, axis=0)

        @jax.jit
        def roundtrip_ok(v):
            back = ntt.inverse_chunked(ntt.forward_chunked(v, tb4, C), tb4, C)
            return jnp.array_equal(back, v)

        _check(bool(roundtrip_ok(x)), "four: inverse(forward(x)) != x")

        def polymul(tb):
            return jax.jit(lambda a, b: ntt._map_chunks(
                lambda ab: ntt.negacyclic_polymul(ab[0], ab[1], tb), (a, b), C))

        p4 = polymul(tb4)(x, y)
        ps = polymul(tbs)(x, y)
        _check(bool(jax.jit(jnp.array_equal)(p4, ps)),
               "four and stage negacyclic products differ")
        _check_host_products(x, y, p4, tb4, S["host_rows"], "four")


def phase_ntt_stage_seal(jax, S, ph):
    from pplp_tpu.bfv import EncryptionParameters
    from pplp_tpu.ops import ntt
    from pplp_tpu.ops.primes import Modulus, get_primes

    n, B, C = S["ntt_n"], S["ntt_batch"], S["ntt_chunk"]
    if n >= 4096:
        chain = EncryptionParameters.bfv(n, 1 << 56, profile="seal").coeff_modulus
    else:  # rehearsal: a short wide-prime chain on the same m62 code path
        chain = get_primes(44, 3, n)
    moduli = [Modulus(q) for q in chain]
    L = len(moduli)
    tb = ntt.build_tables(moduli, n, engine="stage")
    bits = "+".join(str(q.bit_length()) for q in chain)
    with ph.run("A2.ntt_stage_seal", f"n={n} limbs={L} ({bits} bits) batch={B} chunk={C}"):
        x = _random_residues(jax, jax.random.key(12), (B, L, n), chain)
        y = jax.tree.map(lambda a: jax.numpy.roll(a, 1, axis=0), x)

        @jax.jit
        def roundtrip_ok(v):
            back = ntt.inverse_chunked(ntt.forward_chunked(v, tb, C), tb, C)
            eq = jax.tree.map(jax.numpy.array_equal, back, v)
            return eq[0] & eq[1]

        _check(bool(roundtrip_ok(x)), "stage/seal: inverse(forward(x)) != x")
        rows = S["host_rows"]
        head = lambda v: jax.tree.map(lambda a: a[:rows], v)
        prod = jax.jit(lambda a, b: ntt.negacyclic_polymul(a, b, tb))(head(x), head(y))
        _check_host_products(head(x), head(y), prod, tb, rows, "stage/seal")


def _load_oracle():
    """tests/bfv_oracle.py by path: an installed package named ``tests``
    would shadow the checkout's test directory."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "bfv_oracle.py")
    spec = importlib.util.spec_from_file_location("bfv_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def phase_behz(jax, S, ph):
    import numpy as np

    from pplp_tpu.bfv import BFVContext, Decryptor, EncryptionParameters, Encryptor
    from pplp_tpu.bfv.behz import (
        RnsMultiplier,
        create_relin_keys,
        default_relin_width,
        relinearize,
    )
    from pplp_tpu.bfv.ciphertext import Ciphertext
    from pplp_tpu.bfv.keys import make_sk_pk_jit
    from pplp_tpu.bfv.rns_decrypt import get_decoder
    from pplp_tpu.ops import ntt
    from pplp_tpu.ops.primes import get_primes

    OracleBFV = _load_oracle().OracleBFV
    jnp = jax.numpy
    n, B, t = S["behz_n"], S["behz_batch"], 1 << 16
    if n >= 4096:
        parms = EncryptionParameters.bfv(n, t, profile="tpu")
    else:  # rehearsal: a short chain with room for one multiply
        parms = EncryptionParameters.bfv(
            n, t, coeff_modulus=get_primes(28, 2, n) + get_primes(27, 2, n))
    ctx = BFVContext.build(parms, engine="four")
    width = default_relin_width(ctx)
    shapes = f"n={n} L={ctx.L} t=2^16 batch={B} relin_width={width}"
    with ph.run("A3.behz_mult_relin", shapes):
        sk, pk = make_sk_pk_jit(ctx, 21)
        rlk = jax.jit(lambda k: create_relin_keys(ctx, sk, k))(jax.random.key(22))
        enc, dec = Encryptor(ctx, pk), Decryptor(ctx, sk)
        mul = RnsMultiplier(ctx)
        rng = np.random.default_rng(23)
        ma = rng.integers(0, t, size=(B, n), dtype=np.uint64)
        mb = rng.integers(0, t, size=(B, n), dtype=np.uint64)

        @jax.jit
        def encrypt2(a, b, key):
            k1, k2 = jax.random.split(key)
            z = jnp.zeros_like(a)
            return enc.encrypt_pairs(a, z, k1).polys, enc.encrypt_pairs(b, z, k2).polys

        pa, pb = encrypt2(jnp.asarray(ma.astype(np.uint32)),
                          jnp.asarray(mb.astype(np.uint32)), jax.random.key(24))
        ct1, ct2 = Ciphertext(pa, "coeff"), Ciphertext(pb, "coeff")
        mult_relin = jax.jit(lambda a, b: relinearize(ctx, mul.multiply(a, b), rlk).polys)
        out = Ciphertext(mult_relin(ct1, ct2), "coeff")
        decoder = get_decoder(ctx)
        got = np.asarray(jax.jit(
            lambda c: decoder.decode_mod_t(dec.ct_value_rns(c)))(out))
        for r in range(B):
            want = host_negacyclic(ma[r], mb[r], t)
            _check((got[r].astype(np.uint64) == want).all(),
                   f"behz: decrypt(product) of row {r} != plaintext product")

        # Oracle rows: the size-3 product equals the big-integer BEHZ mirror,
        # and the host CRT decryption agrees with the device decoder.
        k = S["oracle_rows"]
        oracle = OracleBFV(n, t, [m.value for m in ctx.moduli])
        head = lambda c: Ciphertext(jax.tree.map(lambda a: a[:k], c.polys), "coeff")
        prod3 = jax.jit(mul.multiply)(head(ct1), head(ct2))

        def ints(poly, r):
            return ctx.crt_compose(np.asarray(ntt.to_numpy(poly[r], ctx.tables), dtype=object))

        for r in range(k):
            want3 = oracle.multiply(
                tuple(ints(p, r) for p in ct1.polys), tuple(ints(p, r) for p in ct2.polys))
            _check([ints(p, r) for p in prod3.polys] == [list(w) for w in want3],
                   f"behz: size-3 product of row {r} != bfv_oracle")
            host = dec.decrypt(Ciphertext(tuple(p[r] for p in out.polys), "coeff"))
            _check(host.coeffs[:n] == [int(v) for v in got[r]],
                   f"behz: host decryption of row {r} != device decoder")


def phase_dgk(jax, S, ph):
    import random

    from pplp_tpu.dgk import dgk_gen_keys
    from pplp_tpu.dgk.batched import DGKBatch
    from pplp_tpu.dgk.dgk import dgk_decrypt, dgk_random_num
    from pplp_tpu.dgk.modexp import from_digits

    k, tbits, B = S["dgk_k"], S["dgk_t"], S["dgk_batch"]
    xb, yb, s_blind = 123321, 123654, 37
    with ph.run("A4.dgk", f"k={k} t={tbits} l=16 batch={B} sample={S['dgk_sample']}"):
        priv, pub = dgk_gen_keys(k, tbits, 16, seed=5, init_table=True)
        dbatch = DGKBatch.build(pub)
        rng = random.Random(0)
        msgs, cts = [], []
        for _ in range(3):
            ms = [rng.randrange(0, pub.u) for _ in range(B)]
            rs = [dgk_random_num(int(2.5 * tbits), rng) for _ in range(B)]
            msgs.append(ms)
            cts.append(dbatch.encrypt_batch(ms, rs))
        c1, c2, c3 = cts
        blind = jax.jit(lambda a, b, c, z, r: dbatch.blind_distance_batch(
            a, b, c, xb, yb, s_blind, z, r))
        out = blind(c1, c2, c3, c1, c2)  # cz = c1, cr = c2
        dtab = dbatch.build_device_table(priv)
        dec = jax.jit(lambda c: dbatch.decrypt_batch_device(priv, dtab, c))(out)
        import numpy as np

        dec = np.asarray(dec)
        rows = sorted(random.Random(1).sample(range(B), S["dgk_sample"]))
        pick = lambda a: np.asarray(a)[rows]
        h1, h2, h3, hout = (from_digits(pick(a)) for a in (c1, c2, c3, out))
        nn, u = pub.n, pub.u
        for j, r in enumerate(rows):
            acc = h1[j] * pow(h2[j], xb, nn) * pow(h3[j], yb, nn) % nn
            want_c = pow(acc, s_blind, nn) * h1[j] * h2[j] % nn
            _check(hout[j] == want_c, f"dgk: blinded ciphertext of row {r} differs")
            want_m = dgk_decrypt(priv, want_c)
            m1, m2, m3 = (m[r] for m in msgs)
            _check(want_m == (s_blind * (m1 + xb * m2 + yb * m3) + m1 + m2) % u,
                   f"dgk: Python-int decryption of row {r} breaks the homomorphism")
            _check(int(dec[r]) == want_m, f"dgk: device decryption of row {r} differs")


def phase_bloom(jax, S, ph):
    import numpy as np

    from pplp_tpu.primitives.blinding import Blinding
    from pplp_tpu.protocol.config import ProtocolConfig
    from pplp_tpu.protocol.roles import ProximityServer

    r = S["bloom_r"]
    K = r * r
    cfg = ProtocolConfig(radius=r, false_positive_probability=1e-4, seed=7)
    bl = Blinding.for_protocol(cfg.plain_modulus_bits, K, seed=7)
    with ph.run("A5.bloom", f"r={r} keys={K} fpp=1e-4 nonmembers={S['bloom_nonmembers']}"):
        server = ProximityServer(cfg, blinding=bl)
        server.build_bloom_filter()
        bf = server.bf
        ts = bf.table_size
        # Host keys: ((s*(di + r)) mod 2^64 << w_len | w) mod 2^64.
        di = np.arange(K, dtype=np.uint64)
        with np.errstate(over="ignore"):
            bd = np.uint64(bl.s) * (di + np.uint64(bl.r))
            keys = (bd << np.uint64(bl.w_len)) | np.uint64(bl.w)
        rng = np.random.default_rng(8)
        non = rng.integers(0, 1 << 63, size=S["bloom_nonmembers"], dtype=np.uint64) * 2 + 1
        split = lambda k: ((k & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                           (k >> np.uint64(32)).astype(np.uint32))
        klo, khi = split(keys)
        nlo, nhi = split(non)

        # The NumPy index mirror agrees with the scalar reference hash.
        probe = list(range(0, K, max(1, K // 200)))
        for i in probe[:200]:
            data = int(keys[i]).to_bytes(8, "little")
            idx = [int(np_bloom_indices(klo[i:i + 1], khi[i:i + 1], s, ts)[0])
                   for s in bf.salts]
            _check(idx == list(bf._indices(data)), f"bloom: numpy index of key {i}")

        host_bits = np.zeros(ts, np.uint8)
        for s in bf.salts:
            host_bits[np_bloom_indices(klo, khi, s, ts)] = 1
        _check(np.array_equal(np.asarray(bf._bits_device()), host_bits),
               "bloom: device bit table != host bit table")

        def host_member(lo, hi):
            out = np.ones(len(lo), bool)
            for s in bf.salts:
                out &= host_bits[np_bloom_indices(lo, hi, s, ts)] != 0
            return out

        dev_in = np.asarray(bf.contains_u64_batch(klo, khi))
        dev_out = np.asarray(bf.contains_u64_batch(nlo, nhi))
        _check(dev_in.all(), "bloom: an inserted key is missing on device")
        _check(np.array_equal(dev_out, host_member(nlo, nhi)),
               "bloom: device probe != host membership for non-members")
        for i in range(50):
            _check(bf.contains_u64(int(non[i])) == bool(dev_out[i]),
                   f"bloom: scalar host probe of non-member {i}")
        _log(f"  bloom table {ts} bits, {len(bf.salts)} salts, "
             f"{int(dev_out.sum())} of {len(non)} non-members test positive")


# -- phase B -----------------------------------------------------------------


class _Tee(io.TextIOBase):
    """stdout that also keeps a copy (the sweep's verdict lines)."""

    def __init__(self, out):
        self.out, self.buf, self._lock = out, [], threading.Lock()

    def write(self, s):
        with self._lock:
            self.buf.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def phase_demo(S, ph):
    from pplp_tpu.cli import main as cli_main

    pairs = (("near", 1000, 1000, 1050, 1060, 128), ("far", 1234, 1212, 1000, 1000, 128))
    for label, xa, ya, xb, yb, r in pairs:
        near = (xa - xb) ** 2 + (ya - yb) ** 2 < r * r
        argv = ["demo", "-x", str(xa), "-y", str(ya), "-u", str(xb), "-v", str(yb),
                "-r", str(r), "--seed", "3", *S["demo"]]
        with ph.run(f"B1.demo_{label}", " ".join(argv)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(argv)
            lines = buf.getvalue().splitlines()
            _check(rc == 0, f"demo exited {rc}")
            verdict = [ln for ln in lines if ln in ("near", "far")]
            _check(verdict == ["near" if near else "far"],
                   f"demo verdict {verdict} != oracle {'near' if near else 'far'}")
            _log(f"  demo {label}: {verdict[0]} (oracle agrees); "
                 + next(ln for ln in lines if ln.startswith("Time measured")))


CSV_HEADS = {
    "client_leg": "radius,d_setParms,d_kGen,d_sendPk,d_sendParms,d_recvBF,d_enc,"
    "d_sendCip,d_recvBD,d_dec,d_stage1,d_stage2,d_stage3,d_total,d_totalCalc,"
    "d_totalTraffic,c_sendParms,c_sendPk,c_sendCips,c_recvBF,c_recvBD,"
    "c_totalSend,c_totalRecv,c_total",
    "client_opt": "radius,d_setParms,d_sendParms,d_kGen,d_enc,d_sendCip,d_recvBF,"
    "d_recvBD,d_dec,d_stage1,d_stage2,d_stage3,d_total,d_totalCalc,"
    "d_totalTraffic,c_sendParms,c_sendPk,c_sendCips,c_recvBF,c_recvBD,"
    "c_totalSend,c_totalRecv,c_total",
    "server_leg": "radius,d_recvParms,d_recvPk,d_setParms,d_setBF,d_sendBF,"
    "d_recvCips,d_homoCalc,d_sendBD,d_stage1,d_stage2,d_stage3,d_total,"
    "d_totalTraffic,d_totalCalc",
    "server_opt": "radius,d_recvParms,d_setParms,d_setBF,d_recvCips,d_homoCalc,"
    "d_sendBF,d_sendBD,d_stage1,d_stage2,d_stage3,d_total,d_totalTraffic,"
    "d_totalCalc",
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_listening(port: int, timeout_s: float, alive) -> None:
    """Block until 127.0.0.1:port is in LISTEN state (Linux /proc/net/tcp)."""
    want = f"0100007F:{port:04X}"
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        with open("/proc/net/tcp") as f:
            for line in f.readlines()[1:]:
                cols = line.split()
                if cols[1] == want and cols[3] == "0A":
                    return
        _check(alive(), "ts exited before it listened")
        time.sleep(0.05)
    raise TimeoutError(f"ts did not listen on port {port} within {timeout_s} s")


def phase_sweep(S, ph, out_dir: str):
    from pplp_tpu.benchmark.sweep import RADIUS_SWEEP
    from pplp_tpu.cli import main as cli_main

    os.makedirs(out_dir, exist_ok=True)
    paths = {k: os.path.join(out_dir, f"{k}.csv") for k in CSV_HEADS}
    for p in paths.values():
        if os.path.exists(p):
            os.remove(p)
    port = _free_port()
    xa, ya, xb, yb = 123456789, 132456888, 123456888, 132456777
    radii = [r for r in RADIUS_SWEEP if r <= S["sweep_max_r"]]
    os.environ["PPLP_SWEEP_MAX_RADIUS"] = str(S["sweep_max_r"])
    net = ["-H", "127.0.0.1", "-p", str(port)]
    ts_argv = ["ts", *net, "-x", str(xb), "-y", str(yb), "--profile", S["sweep_profile"],
               "--out-leg", paths["server_leg"], "--out-opt", paths["server_opt"]]
    tc_argv = ["tc", *net, "-x", str(xa), "-y", str(ya), *S["sweep"],
               "--profile", S["sweep_profile"],
               "--out-leg", paths["client_leg"], "--out-opt", paths["client_opt"]]
    shapes = f"radii {radii[0]}..{radii[-1]} leg+opt {' '.join(S['sweep'])} " \
             f"--profile {S['sweep_profile']} over localhost TCP"
    with ph.run("B2.sweep_ts_tc", shapes):
        ts_result = {}

        def serve():
            try:
                ts_result["rc"] = cli_main(ts_argv)
            except BaseException as e:  # surfaced below, in the main thread
                ts_result["err"] = e

        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            th = threading.Thread(target=serve, name="ts")
            th.start()
            try:
                _wait_listening(port, 900, th.is_alive)
                rc = cli_main(tc_argv)
            finally:
                th.join(timeout=900)
        _check(not th.is_alive(), "ts did not finish")
        if "err" in ts_result:
            raise ts_result["err"]
        _check(rc == 0 and ts_result.get("rc") == 0, f"tc rc {rc}, ts rc {ts_result}")
        d2 = (xa - xb) ** 2 + (ya - yb) ** 2
        lines = "".join(tee.buf).splitlines()
        for variant in ("leg", "opt"):
            got = {}
            for ln in lines:
                parts = ln.split()
                if parts[:2] == ["tc", variant]:
                    got[int(parts[2].split("=")[1])] = parts[-1]
            want = {r: "near" if d2 < r * r else "far" for r in radii}
            _check(got == want, f"sweep {variant} verdicts {got} != oracle {want}")
        for name, p in paths.items():
            with open(p) as f:
                rows = f.read().strip().split("\n")
            _check(rows[0] == CSV_HEADS[name], f"{name}.csv header differs")
            _check([int(r.split(",")[0]) for r in rows[1:]] == radii,
                   f"{name}.csv rows are not one per radius")


# -- four cards --------------------------------------------------------------


def phase_four_cards(jax, S, ph):
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pplp_tpu.bfv import BFVContext, EncryptionParameters
    from pplp_tpu.bfv.behz import RnsMultiplier, make_keys_jit, relinearize
    from pplp_tpu.bfv.ciphertext import Ciphertext
    from pplp_tpu.ops import ntt4
    from pplp_tpu.ops.primes import get_primes
    from pplp_tpu.parallel.behz_dist import DistMultiplier
    from pplp_tpu.parallel.mesh import factor_devices, make_mesh
    from pplp_tpu.parallel.ntt_dist import coeff_view, flat_view, make_dist_ntt

    devices = jax.devices()
    _check(len(devices) >= 4, f"--four-cards needs 4 devices, found {len(devices)}")
    devices = devices[:4]
    dp, limb, coeff = factor_devices(4)
    _check(coeff > 1, "the four-device mesh must shard coefficients")
    mesh = make_mesh(devices, dp, limb, coeff)
    n = S["dist_n"]
    parms = EncryptionParameters.bfv(n, 1 << 16, coeff_modulus=get_primes(28, 3, n))
    ctx = BFVContext.build(parms, engine="four")
    B = 2
    shapes = f"n={n} L=3x28-bit batch={B} mesh dp={dp} limb={limb} coeff={coeff}"
    with ph.run("C1.dist_mult_relin", shapes):
        _, rlk = make_keys_jit(ctx, 41)
        moduli = [m.value for m in ctx.moduli]
        key1, key2 = jax.random.split(jax.random.key(42))
        ct1 = Ciphertext(tuple(_random_residues(jax, k, (B, 3, n), moduli)
                               for k in jax.random.split(key1)), "coeff")
        ct2 = Ciphertext(tuple(_random_residues(jax, k, (B, 3, n), moduli)
                               for k in jax.random.split(key2)), "coeff")
        dist = DistMultiplier(ctx, rlk, mesh)
        got = dist.multiply_relinearize(ct1, ct2)
        mul = RnsMultiplier(ctx)
        one = jax.tree.map(lambda a: jax.device_put(a, devices[0]), (ct1, ct2))
        want = jax.jit(lambda a, b: relinearize(ctx, mul.multiply(a, b), rlk).polys)(*one)
        for w, g in zip(want, got.polys):
            _check(np.array_equal(np.asarray(w), np.asarray(g)),
                   "sharded mult+relin != single-device mult+relin")
    with ph.run("C2.dist_ntt", shapes):
        tb4 = ctx.tables.four_step
        fwd, inv = make_dist_ntt(tb4, mesh, batch_axis="dp")
        x = jax.device_put(ct1.polys[0], devices[0])
        ref = jax.jit(lambda v: ntt4.forward4(v, tb4))(x)
        xv = jax.device_put(coeff_view(x, tb4),
                            NamedSharding(mesh, P("dp", None, None, "coeff")))
        spec = jax.jit(fwd)(xv)
        _check(np.array_equal(np.asarray(flat_view(spec)), np.asarray(ref)),
               "sharded forward NTT != single-device forward NTT")
        back = jax.jit(inv)(spec)
        _check(np.array_equal(np.asarray(flat_view(back)), np.asarray(x)),
               "sharded inverse(forward(x)) != x")


# -- main --------------------------------------------------------------------


def result_line(devices) -> str:
    """The last line of stdout: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def main(argv=None) -> int:
    args = _ARGS.parse_args(argv)
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four_cards:
            os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                       + " --xla_force_host_platform_device_count=4")
    import jax

    import pplp_tpu  # noqa: F401  (fails outside a checkout, before any output)
    from pplp_tpu.utils.chipstate import enable_compile_cache, gpu_name_and_power_limit

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r} "
              f"(use --rehearse for the CPU rehearsal)", file=sys.stderr)
        return 2
    cache_dir = enable_compile_cache()
    clock = _CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock)
    card = gpu_name_and_power_limit() if dev.platform == "gpu" else "none (CPU rehearsal)"
    _log(f"card (nvidia-smi name, power.limit): {card}")
    _log(f"device_kind: {dev.device_kind}; devices: {len(jax.devices())}")
    _log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    _log(f"compile cache: {cache_dir}")

    S = REHEARSE if args.rehearse else FULL
    ph = Phases(jax, clock)
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(jax, S, ph)
    else:
        phase_ntt_four(jax, S, ph)
        phase_ntt_stage_seal(jax, S, ph)
        phase_behz(jax, S, ph)
        phase_dgk(jax, S, ph)
        phase_bloom(jax, S, ph)
        phase_demo(S, ph)
        out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "chiprun_out", "chip_smoke")
        phase_sweep(S, ph, out_dir)
    _log(f"total: wall {time.perf_counter() - t0:.3f} s; "
         f"compile {ph.compile_total:.3f} s; card {card}")
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
