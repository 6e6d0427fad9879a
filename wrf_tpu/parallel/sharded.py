"""SPMD advance_mu_t over a 2-D (j, i) device mesh.

Replacement for the reference's multi-GPU orchestrator
(advance_mu_t_no_async.cu:35-424).  Where the reference synthesizes per-GPU
j-slab bounds on the host and stages 3-row halos through ``cudaMemcpy``, here:

  * global state lives as ``jax.Array`` with ``NamedSharding`` over the mesh
    — the decomposition is 2-D ``(j, i)`` instead of 1-D j-slabs;
  * the step runs under ``jax.shard_map``; the 1-cell halo each stencil
    needs is exchanged device-to-device with ``lax.ppermute`` (NCCL on
    GPUs), never through the host;
  * per-shard boundary handling is *mask-based*: every shard runs the same
    program, and the BC-aware window masks (computed from each shard's
    global offset) make only global-edge shards apply the bound shrink —
    this replaces the reference's per-GPU ``jds_g/jts_g/jde_g/jte_g`` bound
    synthesis (advance_mu_t_no_async.cu:108-162);
  * the vertical dimension stays device-local (column reduction + scan),
    the decomposition the reference also chose (one thread owns a full
    column);
  * the substep is the plain XLA path (``kernel="xla"``, this loop's
    default) or the fused column kernel (``kernel="triton"``,
    ops/substep_triton.py) — both run on identical halo-padded local
    blocks.

Multi-step structure: halo construction is hoisted OUT of the device-resident
``lax.scan``.  advance_mu_t never reads neighbor values of its in/out fields
(SURVEY.md §3.4 — all neighbor reads are of constant inputs), so one exchange
before the loop is exact; the carried state keeps its (stale, never-read,
masked) halo rows and only the final interior is returned.  When the
surrounding acoustic loop later updates the winds per step (advance_uv),
per-step exchange of just those fields slots into the scan body.

Arrays here are *ring-shaped*: the staggered domain extents plus a 1-cell
boundary ring, ``(jde+2, kdim, ide+2)``.  The ring carries caller-provided
lateral-boundary data — the same contract as the reference's memory window
(domain + halo padding), which the kernel reads at domain edges whenever the
BC flags do not shrink the window (periodic/open cases).  Arrays are
zero-padded up to mesh-divisible sizes; padding is excluded by the masks.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..grid import ConfigFlags, GridBounds
from ..ops.advance_mu_t_jnp import advance_mu_t_impl
from . import halo
from .mesh import replicated, sharding2, sharding3

F = jnp.float32

#: the ten 3-D and nine 2-D fields of the kernel signature, in argument order
FIELDS_3D = ("ww", "ww_1", "u", "u_1", "v", "v_1", "t", "t_1", "t_ave", "ft")
FIELDS_2D = ("mu", "mut", "muu", "muv", "mu_tend",
             "msfuy", "msfvx_inv", "msftx", "msfty")
FIELDS_1D = ("dnw", "fnm", "fnp", "rdnw")
SCALARS = ("rdx", "rdy", "dts", "epssm")
STATE_KEYS = ("ww", "mu", "t", "t_ave")  # carried between small steps

#: width of the caller-provided global boundary ring carried by sharded state
RING = 1

#: substep implementations: the plain XLA path and the fused column kernel
KERNELS = ("xla", "triton")


def domain_window(nx: int, ny: int, nz: int, flags: ConfigFlags):
    """BC-aware compute window in 0-based *ring* coordinates (domain
    coordinates shifted by the RING offset)."""
    i0, i1, j0, j1, k0, k1 = GridBounds.for_domain(nx, ny, nz, halo=0).loop_bounds(flags)
    return (i0 + RING, i1 + RING, j0 + RING, j1 + RING, k0, k1)


def pad_to_mesh(x: np.ndarray | jax.Array, mesh: Mesh) -> jax.Array:
    """Zero-pad the decomposed axes up to multiples of the mesh shape."""
    nj, ni = mesh.shape["j"], mesh.shape.get("i", 1)
    if x.ndim == 3:
        pj = (-x.shape[0]) % nj
        pi = (-x.shape[2]) % ni
        return jnp.pad(jnp.asarray(x, F), ((0, pj), (0, 0), (0, pi)))
    if x.ndim == 2:
        pj = (-x.shape[0]) % nj
        pi = (-x.shape[1]) % ni
        return jnp.pad(jnp.asarray(x, F), ((0, pj), (0, pi)))
    return jnp.asarray(x, F)


def substep_fn(kernel: str, interpret: bool = False):
    """The mu/t (+ w) substep on halo-padded local blocks: ``kernel="xla"``
    is :func:`advance_mu_t_impl` (w/pp by the caller's ``advance_w_jnp``),
    ``"triton"`` the fused column kernel.  ``interpret`` runs the kernel in
    the Pallas interpreter; only tests ask for it."""
    if kernel == "xla":
        if interpret:
            raise ValueError("interpret applies to kernel='triton' only")
        return advance_mu_t_impl
    if kernel == "triton":
        from ..ops.substep_triton import substep_triton

        def run(*, kde, **kw):
            del kde
            return substep_triton(**kw, interpret=interpret)
        return run
    raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")


def local_masks(window, j_off, i_off, nj: int, ni: int):
    """Boolean window masks of a halo-padded local block whose row/column 0
    sits at global ring coordinates ``(j_off, i_off)``."""
    i0, i1, j0, j1 = window[:4]
    i_idx = i_off + jnp.arange(ni)
    j_idx = j_off + jnp.arange(nj)
    return (i_idx >= i0) & (i_idx <= i1), (j_idx >= j0) & (j_idx <= j1)


class ShardedAdvanceMuT:
    """Compiled SPMD small-step loop over a device mesh.

    Build once per (mesh, domain, flags, n_steps); call with ring-shaped
    global arrays.  ``n_steps > 1`` runs a device-resident ``lax.scan`` over
    the carried state (ww, mu, t, t_ave) without returning to host — the
    multi-step capability the reference's one-launch design lacks
    (SURVEY.md §2 'Distributed communication backend').

    ``kernel``: "xla" (default: on this mu/t-only loop XLA beat the fused
    kernel on the card at 74x61x32 and 512x512x50) or "triton"
    (ops/substep_triton.py, GPU only).
    ``vary_winds`` rescales u/v by (1 + 1e-7*step) each step — the full
    acoustic loop updates the winds every small step (advance_uv), so
    benchmarks set this to keep XLA from hoisting the physics out of the
    scan.
    """

    def __init__(self, mesh: Mesh, nx: int, ny: int, nz: int,
                 flags: ConfigFlags, n_steps: int = 1,
                 kernel: str = "xla", vary_winds: bool = False,
                 interpret: bool = False):
        self.mesh = mesh
        self.flags = flags
        self.domain = (nx, ny, nz)
        self.n_steps = n_steps
        self.kernel = kernel
        window = domain_window(nx, ny, nz, flags)
        self.window = window
        k0, k1 = window[4], window[5]
        step_impl = substep_fn(kernel, interpret)

        s3, s2, rep = sharding3(mesh), sharding2(mesh), replicated(mesh)
        self.shardings = {**{n: s3 for n in FIELDS_3D},
                          **{n: s2 for n in FIELDS_2D},
                          **{n: rep for n in FIELDS_1D}}

        has_i_axis = "i" in mesh.shape
        ip = "i" if has_i_axis else None
        in_specs = ({n: self.shardings[n].spec for n in
                     FIELDS_3D + FIELDS_2D + FIELDS_1D},
                    {n: P() for n in SCALARS})
        out_specs = {n: (P("j", None, ip) if n in
                         ("ww", "t", "t_ave") else P("j", ip))
                     for n in ("ww", "mu", "muave", "muts", "mudf", "t", "t_ave")}
        j_shards, i_shards = mesh.shape["j"], mesh.shape.get("i", 1)

        def local_loop(arrs: dict[str, jax.Array], scalars: dict[str, jax.Array]):
            """Whole multi-step loop for one shard (runs under shard_map)."""
            nj_loc, K, ni_loc = arrs["ww"].shape
            j_sh, i_sh = j_shards > 1, i_shards > 1

            # ---- one-time halo construction (ppermute) ------------------
            padded: dict[str, jax.Array] = {}
            for name in FIELDS_3D:
                padded[name] = halo.halo3(arrs[name], j_sharded=j_sh, i_sharded=i_sh)
            for name in FIELDS_2D:
                padded[name] = halo.halo2(arrs[name], j_sharded=j_sh, i_sharded=i_sh)
            for name in FIELDS_1D:
                padded[name] = arrs[name]

            # this shard's padded-local-row 0 in global ring coordinates
            j_off = jax.lax.axis_index("j") * nj_loc - 1
            i_off = ((jax.lax.axis_index("i") * ni_loc - 1)
                     if has_i_axis else -1)
            i_mask, j_mask = local_masks(window, j_off, i_off,
                                         nj_loc + 2, ni_loc + 2)

            def step_fn(ins, wscale):
                ins = {**ins, "u": ins["u"] * wscale, "v": ins["v"] * wscale}
                return step_impl(
                    **ins, **scalars, i_mask=i_mask, j_mask=j_mask,
                    k0=k0, k1=k1, kde=nz - 1,
                )

            const = {k: v for k, v in padded.items() if k not in STATE_KEYS}
            state0 = {k: padded[k] for k in STATE_KEYS}

            def wscale_at(n):
                if not vary_winds:
                    return F(1.0)
                return F(1.0) + F(1e-7) * n.astype(F)

            state = state0
            if n_steps > 1:
                def body(state, n):
                    out = step_fn({**const, **state}, wscale_at(n))
                    return {k: out[k] for k in STATE_KEYS}, None

                state, _ = jax.lax.scan(body, state, jnp.arange(n_steps - 1))
            out = step_fn({**const, **state},
                          wscale_at(jnp.asarray(n_steps - 1)))

            # drop halo rows/cols -> owned interior
            res = {}
            for name, val in out.items():
                if val.ndim == 3:
                    res[name] = val[1 : 1 + nj_loc, :, 1 : 1 + ni_loc]
                else:
                    res[name] = val[1 : 1 + nj_loc, 1 : 1 + ni_loc]
            return res

        sharded_loop = jax.shard_map(
            local_loop, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
        self._run = jax.jit(sharded_loop)

    def prepare(self, arrays: dict[str, np.ndarray]) -> dict[str, jax.Array]:
        """Pad ring-shaped arrays to mesh-divisible sizes and place them
        with the step's shardings."""
        out = {}
        for name in FIELDS_3D + FIELDS_2D:
            out[name] = jax.device_put(
                pad_to_mesh(arrays[name], self.mesh), self.shardings[name]
            )
        for name in FIELDS_1D:
            out[name] = jax.device_put(
                jnp.asarray(arrays[name], F), self.shardings[name]
            )
        return out

    def __call__(self, arrays: dict[str, Any], rdx, rdy, dts, epssm):
        scalars = {"rdx": jnp.asarray(rdx, F), "rdy": jnp.asarray(rdy, F),
                   "dts": jnp.asarray(dts, F), "epssm": jnp.asarray(epssm, F)}
        out = self._run(arrays, scalars)
        nx, ny, _ = self.domain
        # strip the mesh padding and the boundary ring -> domain-shaped
        trimmed = {}
        for name, val in out.items():
            if val.ndim == 3:
                trimmed[name] = val[RING : ny + RING, :, RING : nx + RING]
            else:
                trimmed[name] = val[RING : ny + RING, RING : nx + RING]
        return trimmed


# ---------------------------------------------------------------------- #
# Memory-window <-> ring-shaped conversion (fixture interop)
# ---------------------------------------------------------------------- #
def case_to_domain(case, with_w: bool = False) -> dict[str, np.ndarray]:
    """Extract ring-shaped arrays (staggered extents + the 1-cell boundary
    ring of lateral-BC data) from a fixture Case's memory-window arrays.
    ``with_w`` additionally extracts the vertical-acoustics state
    (w, pp, rdn) for the advance_w substep."""
    b = case.bounds
    j0, j1 = b.mem(b.jds, "j") - RING, b.mem(b.jde, "j") + RING
    i0, i1 = b.mem(b.ids, "i") - RING, b.mem(b.ide, "i") + RING
    kw = case.kernel_kwargs()
    if with_w:
        f = case.fields
        kw = {**kw, "w": f["grid_w"], "pp": f["grid_pp"], "rdn": f["grid_rdn"]}
    names = FIELDS_3D + FIELDS_2D + FIELDS_1D
    if with_w:
        names = names + ("w", "pp", "rdn")
    out = {}
    for name in names:
        arr = np.asarray(kw[name])
        if arr.ndim == 3:
            out[name] = arr[j0 : j1 + 1, :, i0 : i1 + 1]
        elif arr.ndim == 2:
            out[name] = arr[j0 : j1 + 1, i0 : i1 + 1]
        else:
            out[name] = arr
    return out


def embed_outputs(case, out_dom: dict) -> dict:
    """Embed a loop's domain-shaped outputs back into memory-window arrays
    for comparison against memory-window goldens: carried state embeds into
    its own input field, derived 2-D/3-D outputs into zeros."""
    kw = case.kernel_kwargs()
    out = {}
    for name, val in out_dom.items():
        arr = np.asarray(val)
        if name in ("ww", "mu", "t", "t_ave", "u", "v"):
            like = np.asarray(kw[name])
        elif name in ("w", "pp"):
            like = np.asarray(case.fields["grid_" + name])
        else:
            shape = case.bounds.shape3 if arr.ndim == 3 else case.bounds.shape2
            like = np.zeros(shape, dtype=np.float32)
        out[name] = embed_domain(arr, like, case.bounds)
    return out


def embed_domain(dom: np.ndarray, like: np.ndarray, bounds: GridBounds) -> np.ndarray:
    """Embed a domain-shaped result back into a memory-window array ``like``
    for comparison against memory-window goldens."""
    out = np.array(like, copy=True)
    j0, i0 = bounds.mem(bounds.jds, "j"), bounds.mem(bounds.ids, "i")
    if dom.ndim == 3:
        out[j0 : j0 + dom.shape[0], :, i0 : i0 + dom.shape[2]] = dom
    else:
        out[j0 : j0 + dom.shape[0], i0 : i0 + dom.shape[1]] = dom
    return out
