"""Halo exchange over the device mesh.

The reference stages 3-row j halos from the host once per kernel launch
(reference: advance_mu_t_no_async.cu:136-160, 245-306); devices never talk to
each other.  Here the 1-cell halo the stencil actually needs (the kernel's
reads are ±1 in i and j, SURVEY.md §2) is exchanged directly between
neighbor devices with ``lax.ppermute``, which XLA lowers to device-to-device
collective-permutes (NCCL on GPUs).  Wrap-around rows that land on global-domain edges
carry garbage and are excluded by the compute-window masks — every shard runs
the identical SPMD program.

These helpers run *inside* ``shard_map``: they take the local block and
return the block padded by one halo cell on the decomposed axes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _perm_shift(axis_name: str, shift: int) -> list[tuple[int, int]]:
    """Ring permutation sending each shard's slice to ``shard + shift``."""
    n = lax.axis_size(axis_name)
    return [(s, (s + shift) % n) for s in range(n)]


def exchange_axis(x: jax.Array, axis: int, axis_name: str) -> jax.Array:
    """Pad ``x`` with one halo cell on both sides of ``axis``, filled with
    the neighboring shards' edge cells (ring exchange; edges masked)."""
    lo = lax.slice_in_dim(x, 0, 1, axis=axis)
    hi = lax.slice_in_dim(x, x.shape[axis] - 1, x.shape[axis], axis=axis)
    # our top row goes to the next shard's bottom halo, and vice versa
    from_prev = lax.ppermute(hi, axis_name, _perm_shift(axis_name, +1))
    from_next = lax.ppermute(lo, axis_name, _perm_shift(axis_name, -1))
    return jnp.concatenate([from_prev, x, from_next], axis=axis)


def pad_axis(x: jax.Array, axis: int) -> jax.Array:
    """Pad one zero cell on both sides of ``axis`` (unsharded axes, so all
    shards keep congruent shapes)."""
    pads = [(0, 0, 0)] * x.ndim
    pads[axis] = (1, 1, 0)
    return lax.pad(x, jnp.zeros((), x.dtype), pads)


def with_halo(x: jax.Array, *, j_axis: int, i_axis: int,
              j_sharded: bool, i_sharded: bool) -> jax.Array:
    """Return the local block padded by a 1-cell halo in j and i —
    exchanged with mesh neighbors on sharded axes, zero-padded otherwise."""
    x = exchange_axis(x, j_axis, "j") if j_sharded else pad_axis(x, j_axis)
    x = exchange_axis(x, i_axis, "i") if i_sharded else pad_axis(x, i_axis)
    return x


def refresh_axis(xp: jax.Array, axis: int, axis_name: str,
                 n_interior: int | None = None) -> jax.Array:
    """Refresh the 1-cell halo of an ALREADY-padded local block along
    ``axis`` from the neighbors' interior edges (in-loop exchange for fields
    that changed during a scan step).  Compiles to in-place dynamic updates
    inside ``lax.scan`` carries.

    ``n_interior``: owned extent (halo cells sit at 0 and n_interior+1);
    defaults to ``shape[axis] - 2`` — pass it when extra alignment padding
    follows the high halo row.
    """
    n_int = (xp.shape[axis] - 2) if n_interior is None else n_interior
    lo_int = lax.slice_in_dim(xp, 1, 2, axis=axis)               # first owned
    hi_int = lax.slice_in_dim(xp, n_int, n_int + 1, axis=axis)   # last owned
    from_prev = lax.ppermute(hi_int, axis_name, _perm_shift(axis_name, +1))
    from_next = lax.ppermute(lo_int, axis_name, _perm_shift(axis_name, -1))
    starts_lo = [0] * xp.ndim
    starts_hi = [0] * xp.ndim
    starts_hi[axis] = n_int + 1
    xp = lax.dynamic_update_slice(xp, from_prev, starts_lo)
    return lax.dynamic_update_slice(xp, from_next, starts_hi)


def halo3(x: jax.Array, j_sharded: bool = True, i_sharded: bool = True) -> jax.Array:
    """(j, k, i) local block -> (j+2, k, i+2)."""
    return with_halo(x, j_axis=0, i_axis=2, j_sharded=j_sharded, i_sharded=i_sharded)


def halo2(x: jax.Array, j_sharded: bool = True, i_sharded: bool = True) -> jax.Array:
    """(j, i) local block -> (j+2, i+2)."""
    return with_halo(x, j_axis=0, i_axis=1, j_sharded=j_sharded, i_sharded=i_sharded)
