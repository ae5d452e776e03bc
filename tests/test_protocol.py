"""End-to-end protocol tests: the clear-computation oracle applied to the
full two-party message flow (the reference's only systematic check — SURVEY.md
§4.4 — applied everywhere)."""

import pytest

from pplp_tpu.protocol import ProtocolConfig, run_local_demo


def small_cfg(**kw):
    # n=4096 with the `tpu` profile keeps CI fast; coordinates default small.
    base = dict(
        poly_modulus_degree_bits=12,
        plain_modulus_bits=40,
        profile="tpu",
        seed=1234,
        false_positive_probability=1e-6,
    )
    base.update(kw)
    return ProtocolConfig(**base)


@pytest.mark.parametrize(
    "xa,ya,xb,yb,radius,expect_near",
    [
        (1234, 1212, 1000, 1000, 128, False),   # d^2 = 99680 > 128^2
        (1234, 1212, 1000, 1000, 320, True),    # d^2 = 99680 < 320^2 = 102400
        (500, 500, 500, 500, 1, True),          # identical points
        (0, 0, 100, 0, 100, False),             # boundary: d^2 == r^2 -> far
        (0, 0, 100, 0, 101, True),
    ],
)
def test_demo_verdicts_match_clear_oracle(xa, ya, xb, yb, radius, expect_near):
    cfg = small_cfg(xa=xa, ya=ya, xb=xb, yb=yb, radius=radius)
    res = run_local_demo(cfg, verbose=False)
    d2 = (xa - xb) ** 2 + (ya - yb) ** 2
    assert (d2 < radius * radius) == expect_near  # oracle self-check
    assert res.is_near == expect_near
    # Blind distance is s*(d^2 + r) mod t.
    from pplp_tpu.primitives import Blinding

    bl = Blinding.for_protocol(cfg.plain_modulus_bits, cfg.sq_radius, cfg.seed)
    assert res.blind_distance == (bl.s * (d2 + bl.r)) % cfg.plain_modulus


@pytest.mark.slow
def test_demo_seal_profile():
    cfg = ProtocolConfig(
        poly_modulus_degree_bits=12,
        plain_modulus_bits=30,
        profile="seal",
        seed=7,
        radius=64,
        false_positive_probability=1e-6,
    )
    res = run_local_demo(cfg, verbose=False)
    assert res.is_near is False
    assert set(res.stage_ns) == {"setParms", "kGen", "setBF", "enc", "homoCalc", "dec"}


def test_wire_blobs_roundtrip():
    # Drive the roles directly, asserting each message parses standalone.
    from pplp_tpu.protocol.roles import ProximityClient, ProximityServer

    cfg = small_cfg(radius=32)
    client = ProximityClient(cfg)
    server = ProximityServer(cfg)
    server.receive_parms(client.parms_message())
    client.keygen()
    server.build_bloom_filter()
    server.receive_ciphertexts(client.ciphertext_messages())
    client.receive_bf(server.bf_message())
    assert client.w == server.blinding.w
    assert client.bf == server.bf
    client.receive_blind_distance(server.blind_distance_message())
    assert client.is_near is False
