"""Device-mesh construction for 2-D (j, i) spatial domain decomposition.

The reference decomposes the domain 1-D along j across 3 GPUs with
host-staged halos (reference: advance_mu_t_no_async.cu:87-162).  This
design generalizes to a 2-D ``(j, i)`` mesh: shardings are expressed with
``jax.sharding.NamedSharding`` and the step runs under ``shard_map``, so
XLA compiles the halo exchange into device-to-device collectives (NCCL on
GPUs, where every card of a host reaches every other over NVLink).  The
vertical dimension k is never sharded (column scans are device-local).
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

#: mesh axis names: j (outer / slab) and i (lane) decomposition
AXES = ("j", "i")


def factor_near_square(n: int) -> tuple[int, int]:
    """Factor ``n = a*b`` with a >= b and a/b minimal — a near-square mesh
    maximizes the volume-to-halo-surface ratio of each shard."""
    b = int(math.isqrt(n))
    while n % b:
        b -= 1
    return n // b, b


def make_mesh(
    devices: list | None = None, shape: tuple[int, int] | None = None
) -> Mesh:
    """Build a ``(j, i)`` mesh over ``devices`` (default: all).

    ``shape`` fixes (nj, ni) explicitly; otherwise a near-square
    factorization is used with the larger factor on j (the outer dimension,
    which benefits most from contiguous slabs).
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = factor_near_square(len(devices))
    nj, ni = shape
    if nj * ni != len(devices):
        raise ValueError(f"mesh shape {shape} != device count {len(devices)}")
    dev_array = np.asarray(devices).reshape(nj, ni)
    return Mesh(dev_array, AXES)


def make_mesh_1d(devices: list | None = None) -> Mesh:
    """A 1-axis ``("j",)`` mesh: the reference orchestrator's 1-D j-slab
    decomposition (the loops treat the missing i axis as unsharded)."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.asarray(devices), ("j",))


def _ispec(mesh: Mesh):
    return "i" if "i" in mesh.shape else None


def sharding3(mesh: Mesh) -> NamedSharding:
    """Sharding for (j, k, i) fields: j and i sharded, k device-local."""
    return NamedSharding(mesh, P("j", None, _ispec(mesh)))


def sharding2(mesh: Mesh) -> NamedSharding:
    """Sharding for (j, i) fields."""
    return NamedSharding(mesh, P("j", _ispec(mesh)))


def replicated(mesh: Mesh) -> NamedSharding:
    """Sharding for per-level vectors and scalars: replicated."""
    return NamedSharding(mesh, P())
