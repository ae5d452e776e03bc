"""Command-line entry points mirroring the reference's five binaries.

    python -m pplp_tpu.cli demo    (./pplp  — local both-roles run)
    python -m pplp_tpu.cli client  (./client)
    python -m pplp_tpu.cli server  (./server)
    python -m pplp_tpu.cli tc      (./tc — benchmark client, CSV out)
    python -m pplp_tpu.cli ts      (./ts — benchmark server, CSV out)

Flags keep the reference's names, defaults, and range validations
(``include/cmdline.h`` + per-binary add<> calls); the short ``-h`` for host is
renamed ``-H`` because ``-h`` is help here.
"""

from __future__ import annotations

import argparse
import sys

COORD_MAX = 1 << 27


def _ranged(lo, hi, cast=int):
    def check(s):
        v = cast(s)
        if not (lo <= v <= hi):
            raise argparse.ArgumentTypeError(f"value {v} out of range [{lo}, {hi}]")
        return v

    return check


def _add_net(p):
    p.add_argument("--host", "-H", default="127.0.0.1", help="ip of server")
    p.add_argument("--port", "-p", type=_ranged(1, 65535), default=51022)
    p.add_argument("--ipv6", "-6", action="store_true", help="use ipv6")


def _add_bfv(p):
    p.add_argument(
        "--plain_modulus_bits", "-b", type=_ranged(1, 56), default=56,
        help="bit length of plain modulus",
    )
    p.add_argument(
        "--poly_modulus_degree", "-d", type=_ranged(12, 15), default=13,
        help="set degree of polynomial(2^d)",
    )
    p.add_argument(
        "--profile", choices=["seal", "tpu"], default="seal",
        help="coeff-modulus chain profile",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="pplp", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="local both-roles proximity run (./pplp)")
    d.add_argument("--xa", "-x", type=_ranged(0, COORD_MAX), default=1234)
    d.add_argument("--ya", "-y", type=_ranged(0, COORD_MAX), default=1212)
    d.add_argument("--xb", "-u", type=_ranged(0, COORD_MAX), default=1000)
    d.add_argument("--yb", "-v", type=_ranged(0, COORD_MAX), default=1000)
    d.add_argument("--radius", "-r", type=_ranged(1, 8192), default=128)
    d.add_argument("--print_bf", "-g", type=int, default=0)
    d.add_argument("--seed", type=int, default=None)
    _add_bfv(d)

    c = sub.add_parser("client", help="interactive network client (./client)")
    _add_net(c)
    c.add_argument("--xa", "-x", type=_ranged(0, COORD_MAX), default=123456789)
    c.add_argument("--ya", "-y", type=_ranged(0, COORD_MAX), default=132456888)
    c.add_argument("--radius", "-r", type=_ranged(1, 8192), default=128)
    _add_bfv(c)

    s = sub.add_parser("server", help="interactive network server (./server)")
    _add_net(s)
    s.add_argument("--xb", "-x", type=_ranged(0, COORD_MAX), default=123456888)
    s.add_argument("--yb", "-y", type=_ranged(0, COORD_MAX), default=132465777)
    s.add_argument("--radius", "-r", type=_ranged(1, 8192), default=128)
    s.add_argument("--profile", choices=["seal", "tpu"], default="seal")

    tc = sub.add_parser("tc", help="benchmark client: radius sweep -> CSV (./tc)")
    _add_net(tc)
    tc.add_argument("--xa", "-x", type=_ranged(0, COORD_MAX), default=123456789)
    tc.add_argument("--ya", "-y", type=_ranged(0, COORD_MAX), default=132456888)
    _add_bfv(tc)
    tc.add_argument("--out-leg", default="./client_leg.csv")
    tc.add_argument("--out-opt", default="./client_opt.csv")

    ts = sub.add_parser("ts", help="benchmark server: radius sweep -> CSV (./ts)")
    _add_net(ts)
    ts.add_argument("--xb", "-x", type=_ranged(0, COORD_MAX), default=123456888)
    ts.add_argument("--yb", "-y", type=_ranged(0, COORD_MAX), default=132456777)
    ts.add_argument("--profile", choices=["seal", "tpu"], default="seal")
    ts.add_argument("--out-leg", default="./server_leg.csv")
    ts.add_argument("--out-opt", default="./server_opt.csv")

    tp = sub.add_parser(
        "2pc", help="two-party circle/polygon predicate (ABY mytest)"
    )
    tp.add_argument("--role", "-r", type=_ranged(0, 1), required=True,
                    help="0 = server (listens), 1 = client (connects)")
    tp.add_argument("--address", "-a", default="127.0.0.1")
    tp.add_argument("--port", "-p", type=_ranged(1, 65535), default=7766)
    # no "-6" short flag here: it makes argparse treat negative numbers as
    # options, and 2pc coordinates are legitimately negative.
    tp.add_argument("--ipv6", action="store_true")
    tp.add_argument("--circuit", choices=["circle", "poly"], default="circle")
    tp.add_argument("--compare", choices=["open", "yao"], default="yao")
    tp.add_argument("-x", type=int, default=0, help="own point x")
    tp.add_argument("-y", type=int, default=0, help="own point y")
    tp.add_argument("--radius", type=_ranged(1, 1 << 15), default=128)
    tp.add_argument("--ax", default="", help="polygon vertex x list (server)")
    tp.add_argument("--ay", default="", help="polygon vertex y list (server)")
    tp.add_argument("--otp-bits", type=int, default=2048,
                    help="base-OT group size (512 for tests)")
    tp.add_argument("--seed", type=int, default=None)

    return ap


def demo_main(args) -> int:
    from .protocol import ProtocolConfig, run_local_demo

    cfg = ProtocolConfig(
        xa=args.xa,
        ya=args.ya,
        xb=args.xb,
        yb=args.yb,
        radius=args.radius,
        plain_modulus_bits=args.plain_modulus_bits,
        poly_modulus_degree_bits=args.poly_modulus_degree,
        profile=args.profile,
        seed=args.seed,
    )
    res = run_local_demo(cfg, print_bf=bool(args.print_bf))
    return 0 if res is not None else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .utils.chipstate import enable_compile_cache

    # Every protocol process of one checkout shares its compiled stages.
    enable_compile_cache()
    if args.cmd == "demo":
        return demo_main(args)
    if args.cmd == "client":
        from .protocol.netmain import client_main

        return client_main(args)
    if args.cmd == "server":
        from .protocol.netmain import server_main

        return server_main(args)
    if args.cmd == "tc":
        from .benchmark.sweep import tc_main

        return tc_main(args)
    if args.cmd == "ts":
        from .benchmark.sweep import ts_main

        return ts_main(args)
    if args.cmd == "2pc":
        from .secure2pc.climain import twopc_main

        return twopc_main(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
