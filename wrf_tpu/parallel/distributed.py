"""Multi-host bring-up: one process per host over a global device mesh.

Single-host runs need none of this — ``make_mesh`` over ``jax.devices()``
is enough.  On a multi-host slice, each host process calls
:func:`initialize` once, builds the global mesh with :func:`global_mesh`,
and feeds its host-local slab of every field through
:func:`host_local_arrays`; ``SmallStepLoop``/``RK3Integrator`` then run
unchanged (the programs are SPMD and mesh-shape-agnostic — the same code
is validated on virtual multi-device meshes in CI, and the collectives are
nearest-neighbor ``ppermute`` exchanges).

The recipe is validated across TRUE process boundaries on the CPU:
``tools/multihost_check.py`` runs two OS processes (4 virtual CPU devices
each) through ``jax.distributed.initialize`` + Gloo collectives, builds
the global (2, 4) mesh, assembles per-process j-slabs with
:func:`host_local_arrays`, and proves both production loops BIT-equal to
the identical program run single-process on the same mesh
(``tests/test_sharded.py::test_multihost_two_process`` gates it in CI;
``test_distributed_helpers`` keeps the single-process degenerate path).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import make_mesh


def initialize(**kwargs) -> None:
    """Initialize the JAX distributed runtime (idempotent wrapper).

    Pass ``coordinator_address``, ``num_processes`` and ``process_id``
    unless the cluster environment provides them; kwargs pass through.  Explicit configuration errors surface; only the
    single-process no-coordinator case (and double initialization) are
    tolerated silently so the same entry point runs everywhere."""
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        # Benign only in the auto-detected single-process case: double
        # initialization, or a backend already brought up locally.  With an
        # explicit cluster config every RuntimeError (coordinator
        # connection/config failure included) must surface — swallowing it
        # would silently leave a process-local device view and fail later
        # in host_local_arrays with an obscure error.
        if kwargs:
            raise
        msg = str(e).lower()
        if ("already initialized" not in msg
                and "should only be called once" not in msg
                and "before any jax calls" not in msg):
            # "should only be called once" is jax 0.9's actual
            # double-initialization wording; older releases said
            # "already initialized"
            raise
    except ValueError:
        if kwargs:
            raise  # the caller explicitly configured a cluster: surface it
        # single-process environment with no coordinator: stay local


def global_mesh(shape: tuple[int, int] | None = None) -> Mesh:
    """(j, i) mesh over every device of every process."""
    devices = jax.devices()
    if shape is None:
        nj = int(math.sqrt(len(devices)))
        while len(devices) % nj:
            nj -= 1
        shape = (nj, len(devices) // nj)
    return make_mesh(devices, shape)


def process_local_block(sharding: NamedSharding,
                        global_shape: tuple) -> tuple[slice, ...]:
    """This process's contiguous index block of a globally-sharded array
    — the union of its addressable devices' shard slices.  Works for any
    process layout over the mesh (1-D j-slabs AND 2-D process grids: with
    row-major device enumeration each process's shards always tile a
    contiguous block)."""
    pid = jax.process_index()
    mine = [idx for d, idx in
            sharding.devices_indices_map(tuple(global_shape)).items()
            if d.process_index == pid]
    assert mine, "process owns no shard of this sharding"
    out = []
    for a in range(len(global_shape)):
        starts = [ix[a].start or 0 for ix in mine]
        stops = [global_shape[a] if ix[a].stop is None else ix[a].stop
                 for ix in mine]
        out.append(slice(min(starts), max(stops)))
    return tuple(out)


def host_local_arrays(mesh: Mesh, arrays: dict[str, np.ndarray],
                      shardings: dict[str, NamedSharding],
                      global_shapes: dict[str, tuple] | None = None) -> dict:
    """Assemble global jax.Arrays from per-host local blocks.

    ``arrays`` holds each field's HOST-LOCAL block, already padded to
    mesh-divisible global sizes like ``pad_to_mesh`` does.  Replicated
    (1-D) fields pass the full vector on every host.

    Without ``global_shapes`` hosts must own contiguous j-slabs (1-D
    process layout over the outer mesh axis; the global j extent is
    inferred as ``local_rows * process_count``).  With ``global_shapes``
    (field name -> global shape) any process layout works — each host
    passes the block :func:`process_local_block` names."""
    out = {}
    for name, arr in arrays.items():
        sh = shardings[name]
        if sh.spec == P():
            out[name] = jax.device_put(jnp.asarray(arr, jnp.float32), sh)
            continue
        if global_shapes is not None:
            gshape = tuple(global_shapes[name])
        else:
            # hosts own contiguous j-slabs (j is the outer mesh axis)
            gshape = (arr.shape[0] * jax.process_count(),) + arr.shape[1:]
        out[name] = jax.make_array_from_process_local_data(
            sh, np.asarray(arr, np.float32), gshape
        )
    return out
