"""Mesh construction and ciphertext shardings.

A ciphertext batch is laid out [B, L, n] (batch, RNS limb, coefficient) and
sharded over a 3-axis mesh ('dp', 'limb', 'coeff'). RNS limbs never
communicate in NTT/pointwise ops, so 'limb' is pure tensor parallelism; the
'coeff' axis carries the NTT's one all-to-all exchange per transform
(parallel/ntt_dist.py). On cards joined all to all (NVLink) the exchange has
no preferred neighbours, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "ct_spec", "ct_sharding", "factor_devices"]


def factor_devices(n: int) -> tuple[int, int, int]:
    """Split n devices into (dp, limb, coeff): coefficients shard first (up
    to 4 ways, so four devices carry the all-to-all NTT), then 2-way dp, and
    the remaining factor goes to the limb axis."""
    coeff = 1
    while coeff < 4 and n % (2 * coeff) == 0:
        coeff *= 2
    n //= coeff
    dp = 2 if n % 2 == 0 else 1
    return dp, n // dp, coeff


def make_mesh(devices=None, dp=None, limb=None, coeff=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    total = len(devices)
    if dp is None or limb is None or coeff is None:
        dp, limb, coeff = factor_devices(total)
    assert dp * limb * coeff == total, "mesh axes must use all devices"
    import numpy as np

    arr = np.asarray(devices).reshape(dp, limb, coeff)
    return Mesh(arr, axis_names=("dp", "limb", "coeff"))


def ct_spec(batched: bool = True) -> P:
    """PartitionSpec for [B, L, n] (or [L, n]) residue arrays."""
    return P("dp", "limb", "coeff") if batched else P("limb", "coeff")


def ct_sharding(mesh: Mesh, batched: bool = True) -> NamedSharding:
    return NamedSharding(mesh, ct_spec(batched))
