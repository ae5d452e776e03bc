"""The tc/ts benchmark pair: radius sweep over leg + opt protocol variants.

Reproduces ``src/test/test_client.cc`` / ``test_server.cc``: for radius in
16, 32, ..., 4096 run the instrumented protocol twice — "leg" (legacy: pk is
transmitted, parms sent after keygen) and "opt" (no pk transfer, parms sent
before keygen) — and emit client_leg/client_opt/server_leg/server_opt CSVs
with the reference's exact schemas.
"""

from __future__ import annotations

import struct
import time

from ..protocol.config import ProtocolConfig
from ..protocol.roles import ProximityClient, ProximityServer
from ..protocol.transport import Channel
from ..bfv.serialize import save_public_key, load_public_key
from .harness import (
    DurationClient,
    DurationServer,
    TrafficLoad,
    parse2csv_client_leg,
    parse2csv_client_opt,
    parse2csv_server_leg,
    parse2csv_server_opt,
)

__all__ = [
    "RADIUS_SWEEP",
    "test_client_leg",
    "test_client_opt",
    "test_server_leg",
    "test_server_opt",
    "tc_main",
    "ts_main",
]

RADIUS_SWEEP = [16 << i for i in range(9)]  # 16..4096 (test_client.cc:52-69)


def _radii(args):
    """Reference sweep by default; PPLP_SWEEP_MAX_RADIUS trims it (smoke
    runs: the r=4096 Bloom build inserts 16.7M keys)."""
    import os

    cap = int(os.environ.get("PPLP_SWEEP_MAX_RADIUS", "0"))
    return [r for r in RADIUS_SWEEP if not cap or r <= cap]


def _announce_radii(chan, radii):
    """tc leads the sweep: the radius list crosses the wire once so both
    sides always iterate the same sweep regardless of local env."""
    import struct

    chan.send_frame(struct.pack(f"<H{len(radii)}I", len(radii), *radii))


def _recv_radii(chan):
    import struct

    buf = chan.recv_frame()
    (n,) = struct.unpack_from("<H", buf, 0)
    return list(struct.unpack_from(f"<{n}I", buf, 2))

_ns = time.perf_counter_ns


class _Stages:
    def __init__(self):
        self.ns = {}
        self.t_begin = _ns()

    def timed(self, name):
        outer = self

        class _T:
            def __enter__(self):
                self.t0 = _ns()

            def __exit__(self, *exc):
                outer.ns[name] = _ns() - self.t0

        return _T()

    def total(self):
        return _ns() - self.t_begin


def _client_cfg(radius, xa, ya, d_bits, b_bits, profile):
    return ProtocolConfig(
        xa=xa,
        ya=ya,
        radius=radius,
        plain_modulus_bits=b_bits,
        poly_modulus_degree_bits=d_bits,
        false_positive_probability=1e-4,  # test_server.cc:118 parity
        profile=profile,
    )


def _run_client(chan: Channel, cfg: ProtocolConfig, send_pk: bool):
    st = _Stages()
    sent0 = chan.bytes_sent
    with st.timed("setParms"):
        client = ProximityClient(cfg)
    if not send_pk:  # opt: parms go out before keygen
        with st.timed("sendParms"):
            c_sendParms = chan.send_frame(client.parms_message())
    with st.timed("kGen"):
        client.keygen()
    if send_pk:  # leg: parms after keygen, then pk
        with st.timed("sendParms"):
            c_sendParms = chan.send_frame(client.parms_message())
        with st.timed("sendPk"):
            c_sendPk = chan.send_frame(save_public_key(client.pk, client.ctx))
    else:
        c_sendPk = 0
        st.ns["sendPk"] = 0
    with st.timed("enc"):
        blobs = client.ciphertext_messages()
    with st.timed("sendCip"):
        c_sendCips = sum(chan.send_frame(b) for b in blobs)
    with st.timed("recvBF"):
        bf_blob = chan.recv_frame()
        client.receive_bf(bf_blob)
    c_recvBF = len(bf_blob)
    with st.timed("recvBD"):
        bd_blob = chan.recv_frame()
    c_recvBD = len(bd_blob)
    with st.timed("dec"):
        client.receive_blind_distance(bd_blob)
    d_total = st.total()

    s = st.ns
    if send_pk:
        stage1 = s["setParms"] + s["kGen"]
        stage2 = 0
        stage3 = s["enc"] + s["dec"]
    else:
        stage1 = s["setParms"] + s["kGen"] + s["enc"]
        stage2 = 0
        stage3 = s["dec"]
    dur = DurationClient(
        d_setParms=s["setParms"],
        d_kGen=s["kGen"],
        d_enc=s["enc"],
        d_sendPk=s["sendPk"],
        d_sendParms=s["sendParms"],
        d_sendCip=s["sendCip"],
        d_recvBF=s["recvBF"],
        d_recvBD=s["recvBD"],
        d_dec=s["dec"],
        d_stage1=stage1,
        d_stage2=stage2,
        d_stage3=stage3,
        d_total=d_total,
        d_totalCalc=stage1 + stage2 + stage3,
        d_totalTraffic=0,
    )
    c_totalSend = c_sendParms + c_sendPk + c_sendCips
    c_totalRecv = c_recvBF + c_recvBD
    traffic = TrafficLoad(
        c_sendParms=c_sendParms,
        c_sendPk=c_sendPk,
        c_sendCips=c_sendCips,
        c_recvBF=c_recvBF,
        c_recvBD=c_recvBD,
        c_totalSend=c_totalSend,
        c_totalRecv=c_totalRecv,
        c_total=c_totalSend + c_totalRecv,
    )
    return traffic, dur, client


def test_client_leg(chan, radius, xa, ya, d_bits, b_bits, profile="seal"):
    cfg = _client_cfg(radius, xa, ya, d_bits, b_bits, profile)
    t, d, _ = _run_client(chan, cfg, send_pk=True)
    return t, d


def test_client_opt(chan, radius, xa, ya, d_bits, b_bits, profile="seal"):
    cfg = _client_cfg(radius, xa, ya, d_bits, b_bits, profile)
    t, d, _ = _run_client(chan, cfg, send_pk=False)
    return t, d


def _run_server(chan: Channel, cfg: ProtocolConfig, recv_pk: bool):
    st = _Stages()
    server = ProximityServer(cfg)
    with st.timed("recvParms"):
        parms_blob = chan.recv_frame()
    if recv_pk:
        with st.timed("recvPk"):
            pk_blob = chan.recv_frame()
    else:
        st.ns["recvPk"] = 0
    with st.timed("setParms"):
        server.receive_parms(parms_blob)
        if recv_pk:
            load_public_key(pk_blob, server.ctx)  # parity: parsed, unused
    with st.timed("setBF"):
        server.build_bloom_filter()
    with st.timed("recvCips"):
        server.receive_ciphertexts([chan.recv_frame() for _ in range(3)])
    with st.timed("homoCalc"):
        bd_blob = server.blind_distance_message()
    with st.timed("sendBF"):
        from ..protocol.roles import send_bf

        send_bf(chan, server)
    with st.timed("sendBD"):
        chan.send_frame(bd_blob)
    d_total = st.total()

    s = st.ns
    if recv_pk:  # leg stage split (test_server.cc:217-219)
        stage1, stage2, stage3 = s["setParms"], s["setBF"], s["homoCalc"]
    else:  # opt split (test_server.cc:365-367)
        stage1, stage2, stage3 = s["setParms"] + s["setBF"], s["homoCalc"], 0
    return DurationServer(
        d_recvParms=s["recvParms"],
        d_recvPk=s["recvPk"],
        d_setParms=s["setParms"],
        d_setBF=s["setBF"],
        d_sendBF=s["sendBF"],
        d_recvCips=s["recvCips"],
        d_homoCalc=s["homoCalc"],
        d_sendBD=s["sendBD"],
        d_stage1=stage1,
        d_stage2=stage2,
        d_stage3=stage3,
        d_total=d_total,
        d_totalTraffic=0,
        d_totalCalc=stage1 + stage2 + stage3,
    )


def test_server_leg(chan, radius, xb, yb, profile="seal"):
    cfg = ProtocolConfig(
        xb=xb, yb=yb, radius=radius, false_positive_probability=1e-4, profile=profile
    )
    return _run_server(chan, cfg, recv_pk=True)


def test_server_opt(chan, radius, xb, yb, profile="seal"):
    cfg = ProtocolConfig(
        xb=xb, yb=yb, radius=radius, false_positive_probability=1e-4, profile=profile
    )
    return _run_server(chan, cfg, recv_pk=False)


def _prewarm(args, role: str):
    """One untimed in-process protocol round before the first connect.

    The sweep's first timed radius otherwise absorbs BOTH processes'
    startup (jax/device init, stage executables, compile-cache reads),
    which dwarfs one radius' steady-state time. The reference's own
    first radius measures only protocol work (test_client.cc:52-69), so
    pre-warming is parity, not flattery. Disable with PPLP_SWEEP_PREWARM=0.
    """
    import os
    import time as _time

    if os.environ.get("PPLP_SWEEP_PREWARM", "1") == "0":
        return
    from ..protocol.demo import run_local_demo

    t0 = _time.perf_counter()
    # ts has no -d/-b (the client sends its parms): it warms the client's
    # defaults, the configuration a default tc sends.
    cfg = ProtocolConfig(
        radius=16,
        plain_modulus_bits=getattr(
            args, "plain_modulus_bits", ProtocolConfig.plain_modulus_bits
        ),
        poly_modulus_degree_bits=getattr(
            args, "poly_modulus_degree", ProtocolConfig.poly_modulus_degree_bits
        ),
        false_positive_probability=1e-4,
        profile=args.profile,
    )
    run_local_demo(cfg, verbose=False)
    # The leg variant additionally serializes the public key; warm those
    # two executables too (one compile each).
    client = ProximityClient(cfg)
    client.keygen()
    load_public_key(save_public_key(client.pk, client.ctx), client.ctx)
    print(f"{role} prewarm done in {_time.perf_counter() - t0:.1f}s")


def tc_main(args) -> int:
    """Benchmark client: sweep leg then opt, write client_leg/opt CSVs."""
    from ..protocol.transport import connect_to_server

    _prewarm(args, "tc")
    chan = connect_to_server(args.host, args.port, ipv6=args.ipv6)
    try:
        radii = _radii(args)
        _announce_radii(chan, radii)
        for variant, send_pk, emit, fname in (
            ("leg", True, parse2csv_client_leg, args.out_leg),
            ("opt", False, parse2csv_client_opt, args.out_opt),
        ):
            for i, radius in enumerate(radii):
                cfg = _client_cfg(
                    radius, args.xa, args.ya, args.poly_modulus_degree,
                    args.plain_modulus_bits, args.profile,
                )
                t, d, client = _run_client(chan, cfg, send_pk=send_pk)
                emit(fname, radius, i == 0, t, d)
                verdict = "near" if client.is_near else "far"
                print(
                    f"tc {variant} radius={radius} "
                    f"total={d.d_total/1e9:.3f}s {verdict}"
                )
    finally:
        chan.close()
    return 0


def ts_main(args) -> int:
    """Benchmark server: counterpart of tc_main, writes server_leg/opt CSVs."""
    from ..protocol.transport import connect_to_client

    _prewarm(args, "ts")  # before bind: LISTEN then signals readiness
    chan = connect_to_client(args.host, args.port, ipv6=args.ipv6)
    try:
        radii = _recv_radii(chan)
        for variant, fn, emit, fname in (
            ("leg", test_server_leg, parse2csv_server_leg, args.out_leg),
            ("opt", test_server_opt, parse2csv_server_opt, args.out_opt),
        ):
            for i, radius in enumerate(radii):
                d = fn(chan, radius, args.xb, args.yb, args.profile)
                emit(fname, radius, i == 0, d)
                print(f"ts {variant} radius={radius} total={d.d_total/1e9:.3f}s")
    finally:
        chan.close()
    return 0
