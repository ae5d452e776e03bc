"""Multi-process multi-host smoke (SURVEY §4(c); VERDICT r1 item 6).

Mirrors the reference's two-processes-on-127.0.0.1 integration pattern
(/root/reference/src/client.cc:27) at the jax.distributed level: two local
processes, 4 virtual CPU devices each, one 8-device global mesh; the
distributed NTT's all-to-all crosses the process boundary where the network
between hosts would sit.
"""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

_SCRIPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "scripts", "multiproc_smoke.py",
)


def test_two_process_distributed_ntt():
    port = "37911"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # script sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, _SCRIPT, str(rank), "2", port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for rank in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=280)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-2000:]}"
        assert f"MULTIPROC OK rank={rank} devices=8" in out
