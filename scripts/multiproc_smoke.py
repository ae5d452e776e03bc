"""Two-process jax.distributed smoke: the SURVEY §4(c) pattern.

The reference integration-tests its two-party protocol as two processes on
127.0.0.1 (/root/reference/src/client.cc:27). The analogous multi-HOST test
for this framework: two jax.distributed processes on localhost, each with 4
virtual CPU devices, forming one 8-device global mesh; the distributed NTT's
all-to-all then crosses the process (i.e. "host") boundary over the
coordination channel exactly where the network between hosts would sit.

Run (from tests/test_multiproc.py or by hand):
    python scripts/multiproc_smoke.py <rank> <nproc> <port>
Prints "MULTIPROC OK rank=N" on success.
"""

import os
import sys

rank, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_cpu_collectives_implementation", "gloo")

import numpy as np  # noqa: E402

# Initialize the distributed runtime BEFORE any backend-touching import
# (pplp_tpu modules build device constants at import time).
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
    process_id=rank,
)

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pplp_tpu.ops import ntt4  # noqa: E402
from pplp_tpu.ops.primes import Modulus, get_primes  # noqa: E402
from pplp_tpu.parallel.ntt_dist import (  # noqa: E402
    coeff_view,
    make_dist_ntt,
)
assert jax.process_count() == nproc
devices = jax.devices()
assert len(devices) == 4 * nproc, devices

N, L = 1024, 2
moduli = [Modulus(q) for q in get_primes(28, L, N)]
tb = ntt4.build_tables4(moduli, N)
mesh = Mesh(np.array(devices).reshape(len(devices)), ("coeff",))
fwd, inv = make_dist_ntt(tb, mesh)

rng = np.random.default_rng(0)  # same seed on all ranks: same global array
qs = np.array([m.value for m in moduli], np.uint64)[:, None]
x_host = (
    rng.integers(0, 1 << 62, size=(L, N)).astype(np.uint64) % qs
).astype(np.uint32)

sh = NamedSharding(mesh, P(None, None, None, "coeff"))
xv = coeff_view(x_host, tb)[None]  # [1, L, C1, C2]
# Each process contributes the lanes its local devices own.
garr = jax.make_array_from_callback(xv.shape, sh, lambda idx: xv[idx])
back = jax.jit(inv)(jax.jit(fwd)(garr))
jax.block_until_ready(back)

for shard in back.addressable_shards:
    want = xv[shard.index]
    got = np.asarray(shard.data)
    assert np.array_equal(want, got), f"rank {rank}: shard mismatch"

print(f"MULTIPROC OK rank={rank} devices={len(devices)}", flush=True)
