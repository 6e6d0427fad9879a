"""advance_mu_t, the plain JAX path (pure jnp / XLA).

This is NOT a translation of the reference loops: the update is expressed as
whole-array operations over the ``(j, k, i)`` memory window so XLA can fuse
the entire small step into a handful of bandwidth-bound vector loops.

Key design moves (vs the reference's per-j-row loop nest,
module_small_step_em.f90:112-250):

  * Boundary-condition-aware loop bounds become *masks* so every shard of an
    SPMD program runs the identical computation — only shards holding a
    global domain edge apply the shrink.  Masks arrive as per-axis boolean
    vectors so the same core works on one device and under ``shard_map``.
  * The vertical column reduction (dmdt) and scan (ww) stay device-local
    along k: the reduction is one ``sum`` over the k axis, the scan one
    ``cumsum``; k is never sharded (SURVEY.md §5).
  * ±1 stencil neighbors are static slices of the halo-padded memory window
    (``jnp.roll``), never gathers.
  * Everything is float32 throughout, matching the reference's
    determinism-for-comparability policy.

The ww/theta data dependence (Phase B reads the *new* ww) is preserved by
construction (SURVEY.md §3.4).
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import ConfigFlags, GridBounds

F = jnp.float32


def window_masks(bounds: GridBounds, flags: ConfigFlags) -> tuple[np.ndarray, np.ndarray]:
    """Per-axis boolean masks for the BC-aware compute window (single-tile
    case: the tile sees the whole domain)."""
    i0, i1, j0, j1, _, _ = bounds.loop_bounds(flags)
    i_mask = np.zeros(bounds.idim, dtype=bool)
    i_mask[i0 : i1 + 1] = True
    j_mask = np.zeros(bounds.jdim, dtype=bool)
    j_mask[j0 : j1 + 1] = True
    return i_mask, j_mask


def _shift_m1(a: jax.Array, axis: int) -> jax.Array:
    """a[..., x-1, ...]: value of the -1 neighbor (edge rows are masked)."""
    return jnp.roll(a, 1, axis=axis)


def _shift_p1(a: jax.Array, axis: int) -> jax.Array:
    """a[..., x+1, ...]: value of the +1 neighbor (edge rows are masked)."""
    return jnp.roll(a, -1, axis=axis)


def advance_mu_t_impl(
    *,
    ww: jax.Array,        # (j, k, i)  in/out — small-step omega
    ww_1: jax.Array,      # (j, k, i)  in     — large-step omega (coupled)
    u: jax.Array,         # (j, k, i)  in     — coupled u momentum
    u_1: jax.Array,       # (j, k, i)  in     — u at large step
    v: jax.Array,
    v_1: jax.Array,
    mu: jax.Array,        # (j, i)     in/out — column-mass perturbation
    mut: jax.Array,       # (j, i)     in     — base-state column mass
    muu: jax.Array,       # (j, i)     in     — mu at u points
    muv: jax.Array,       # (j, i)     in     — mu at v points
    t: jax.Array,         # (j, k, i)  in/out — perturbation theta
    t_1: jax.Array,       # (j, k, i)  in     — theta at large step
    t_ave: jax.Array,     # (j, k, i)  in/out — theta time-average buffer
    ft: jax.Array,        # (j, k, i)  in     — theta large-step tendency
    mu_tend: jax.Array,   # (j, i)     in
    rdx: jax.Array | float,
    rdy: jax.Array | float,
    dts: jax.Array | float,
    epssm: jax.Array | float,
    dnw: jax.Array,       # (k,)
    fnm: jax.Array,
    fnp: jax.Array,
    rdnw: jax.Array,
    msfuy: jax.Array,     # (j, i) map-scale factors
    msfvx_inv: jax.Array,
    msftx: jax.Array,
    msfty: jax.Array,
    i_mask: jax.Array,    # (i,) bool — BC-aware window along i
    j_mask: jax.Array,    # (j,) bool
    k0: int,              # static: first active k level (0-based memory)
    k1: int,              # static: last active k level = kte-1
    kde: int,             # static: domain-top k index (wdtn = 0 there)
    capture_intermediates: bool = False,
) -> dict[str, jax.Array]:
    """One acoustic small step; returns new ``ww, mu, muave, muts, mudf, t,
    t_ave``.  Cells outside the window keep input values (zeros for the
    pure outputs), bit-matching the golden-path convention."""
    rdx, rdy = F(rdx), F(rdy)
    dts, epssm = F(dts), F(epssm)

    mask2 = (j_mask[:, None] & i_mask[None, :])           # (j, i)
    mask2f = mask2[:, None, :]                             # (j, 1, i)
    nk = k1 - k0 + 1

    # ---- Phase A: horizontal mass-flux divergence -----------------------
    # forward differences read the staggered i+1 / j+1 neighbors;
    # association matches the golden path: (muv*v_1)*msfvx_inv, (muu*u_1)/msfuy
    vflux = v + (muv[:, None, :] * v_1) * msfvx_inv[:, None, :]
    uflux = u + (muu[:, None, :] * u_1) / msfuy[:, None, :]

    dvdxi = (msftx * msfty)[:, None, :] * (
        rdy * (_shift_p1(vflux, 0) - vflux)
        + rdx * (_shift_p1(uflux, 2) - uflux)
    )
    dvdxi_act = dvdxi[:, k0 : k1 + 1, :]                   # (j, nk, i)

    # device-local column reduction (never sharded along k)
    dmdt = jnp.sum(dnw[None, k0 : k1 + 1, None] * dvdxi_act, axis=1)  # (j, i)

    # ---- mu update with epsilon off-centering ---------------------------
    tend = dmdt + mu_tend
    mu_new = mu + dts * tend
    muave_new = F(0.5) * ((F(1.0) + epssm) * mu_new + (F(1.0) - epssm) * mu)
    muts_new = mut + mu_new
    mu_out = jnp.where(mask2, mu_new, mu)
    mudf_out = jnp.where(mask2, tend, F(0.0))
    muts_out = jnp.where(mask2, muts_new, F(0.0))
    muave_out = jnp.where(mask2, muave_new, F(0.0))

    # ---- ww vertical scan (device-local cumulative sum along k) -----------
    # ww(k) = ww(k-1) - dnw(k-1)*(dmdt + dvdxi(k-1) + mu_tend)/msfty,
    # integrated up from the input surface level, then minus ww_1.
    steps_k = (
        -dnw[None, k0:k1, None]
        * (dmdt[:, None, :] + dvdxi[:, k0:k1, :] + mu_tend[:, None, :])
        / msfty[:, None, :]
    )                                                      # (j, nk-1, i)
    ww_base = ww[:, k0 : k0 + 1, :]
    ww_scan = jnp.concatenate(
        [ww_base, ww_base + jnp.cumsum(steps_k, axis=1)], axis=1
    )                                                      # (j, nk, i)
    ww_upd = ww_scan - ww_1[:, k0 : k1 + 1, :]
    ww_full = jnp.concatenate(
        [ww[:, :k0, :], ww_upd, ww[:, k1 + 1 :, :]], axis=1
    )
    ww_out = jnp.where(mask2f, ww_full, ww)

    # Debug capture of the phase-A outputs before the theta phase — the
    # analog of the reference's mid-kernel "*_before_theta.bin" dumps
    # (module_small_step_em.f90:175-189), for phase-by-phase bisection of
    # numerical divergence.
    captured = {}
    if capture_intermediates:
        captured = {
            "muave_before_theta": muave_out,
            "mu_before_theta": mu_out,
            "mudf_before_theta": mudf_out,
            "muts_before_theta": muts_out,
            "ww_before_theta": ww_out,
        }

    # ---- Phase B: theta pre-update (tendency uncoupling) -----------------
    t_half = t + (msfty * dts)[:, None, :] * ft
    t_ave_out = jnp.where(mask2f & _k_window(t, k0, k1), t, t_ave)

    # ---- vertical flux interpolant wdtn on w levels ----------------------
    # wdtn(k) = ww(k) * (fnm(k)*t_1(k) + fnp(k)*t_1(k-1)); zero at the
    # surface (k0) and the domain top (kde).
    interp = fnm[None, :, None] * t_1 + fnp[None, :, None] * _shift_m1(t_1, 1)
    wdtn_mid = ww_out * interp                              # valid for k0+1..k1
    # the fill range k0+1..k1 never reaches kde (kde >= kte > k1), so the
    # zero at the domain top holds by construction
    kmask = np.zeros((ww.shape[1],), dtype=bool)
    kmask[k0 + 1 : k1 + 1] = True
    wdtn = jnp.where(jnp.asarray(kmask)[None, :, None], wdtn_mid, F(0.0))

    # ---- theta advection update ------------------------------------------
    fy = _shift_p1(v, 0) * (_shift_p1(t_1, 0) + t_1) - v * (t_1 + _shift_m1(t_1, 0))
    fx = _shift_p1(u, 2) * (_shift_p1(t_1, 2) + t_1) - u * (t_1 + _shift_m1(t_1, 2))
    horiz = msftx[:, None, :] * (F(0.5) * rdy * fy + F(0.5) * rdx * fx)
    # vert(k) = rdnw(k) * (wdtn(k+1) - wdtn(k)); wdtn(kde) == 0 supplies the
    # top boundary when k1 = kde-1.
    vert = rdnw[None, :, None] * (_shift_p1(wdtn, 1) - wdtn)
    t_new = t_half - (dts * msfty)[:, None, :] * (horiz + vert)
    t_out = jnp.where(mask2f & _k_window(t, k0, k1), t_new, t)

    return {
        "ww": ww_out,
        "mu": mu_out,
        "muave": muave_out,
        "muts": muts_out,
        "mudf": mudf_out,
        "t": t_out,
        "t_ave": t_ave_out,
        **captured,
    }


#: jitted entry point (k bounds are compile-time constants)
advance_mu_t_core = jax.jit(
    advance_mu_t_impl,
    static_argnames=("k0", "k1", "kde", "capture_intermediates"),
)


def _k_window(ref3: jax.Array, k0: int, k1: int) -> jax.Array:
    """(1, k, 1) boolean mask selecting levels k0..k1 (static)."""
    km = np.zeros((ref3.shape[1],), dtype=bool)
    km[k0 : k1 + 1] = True
    return jnp.asarray(km)[None, :, None]


def advance_mu_t_jnp(
    *, flags: ConfigFlags, bounds: GridBounds, **arrays: Any
) -> dict[str, jax.Array]:
    """Single-tile convenience wrapper: builds the window masks from the
    index triples and invokes the jitted core."""
    _, _, _, _, k0, k1 = bounds.loop_bounds(flags)
    i_mask, j_mask = window_masks(bounds, flags)
    return advance_mu_t_core(
        i_mask=jnp.asarray(i_mask),
        j_mask=jnp.asarray(j_mask),
        k0=k0,
        k1=k1,
        kde=bounds.mem(bounds.kde, "k"),
        **{k: (jnp.asarray(v, dtype=F) if hasattr(v, "ndim") or isinstance(v, np.ndarray) else v)
           for k, v in arrays.items()},
    )
