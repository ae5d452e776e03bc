"""Multi-host setup (SURVEY.md §2: multi-host pod runs one role's compute).

The reference's "cluster" story is two processes on a TCP socket
(README.md:62-68). Here, one protocol role can span several hosts:
``jax.distributed`` coordinates the hosts over the data-center network,
device collectives run between the devices (NVLink within a GPU host), and
the role-to-role link stays the framed TCP channel.

Usage on each host (the coordinator address, process count and rank are
always given explicitly; nothing is discovered from the environment):

    from pplp_tpu.parallel.distributed import initialize_multihost, global_mesh
    initialize_multihost(coordinator="10.0.0.1:8476", num_processes=2,
                         process_id=<rank>)
    mesh = global_mesh()            # dp x limb x coeff over ALL devices

Tested single-host via the 8-device virtual CPU mesh (tests/test_parallel.py)
and ``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

import jax

from .mesh import factor_devices, make_mesh

__all__ = ["initialize_multihost", "global_mesh", "local_batch_slice"]


def initialize_multihost(coordinator: str, num_processes: int, process_id: int):
    """jax.distributed.initialize with an explicit topology."""
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(dp=None, limb=None, coeff=None):
    """Mesh over every device in the (possibly multi-host) runtime."""
    devices = jax.devices()
    if dp is None or limb is None or coeff is None:
        dp, limb, coeff = factor_devices(len(devices))
    return make_mesh(devices, dp, limb, coeff)


def local_batch_slice(global_batch: int, mesh) -> slice:
    """The [start, stop) batch rows this process feeds into a dp-sharded
    global array (jax.make_array_from_process_local_data helper)."""
    nproc = jax.process_count()
    per = global_batch // nproc
    pid = jax.process_index()
    return slice(pid * per, (pid + 1) * per)
