"""advance_w: the vertically-implicit acoustic w/pressure substep.

The reference sample contains only the horizontally-explicit mu/theta
substep (advance_mu_t).  Full WRF treats the VERTICAL acoustic modes
implicitly every small step (``advance_w`` in dyn_em/module_small_step_em.F
builds a per-column tridiagonal system and solves it with the Thomas
algorithm), because the vertical grid spacing is far smaller than the
horizontal and explicit vertical acoustics would collapse the timestep.
This module provides the framework's vertically-implicit substep as a
*linearized vertical acoustic system* — the same computational pattern
(coefficient build -> downward elimination -> upward substitution, one
tridiagonal solve per column) with simplified linearized coefficients:

    dw/dt  = -cw * rdn(k)  * (pp(k) - pp(k-1))  + gw * t(k)   (interfaces)
    dpp/dt = -cw * rdnw(k) * (w(k+1) - w(k))                  (centers)

off-centered in time like WRF's small step (beta = (1+epssm)/2 on the new
level, 1-beta on the old; the surface interface w(k0) is rigid — treated
as zero inside the substep, the carried value passes through inert).  Substituting the pp update into the w equation
yields, per column, the tridiagonal system

    -A(k) w'(k-1) + (1 + A(k) + B(k)) w'(k) - B(k) w'(k+1) = rhs(k)

with A(k) = (cw*dts*beta)^2 * rdn(k) * rdnw(k-1), B(k) likewise with
rdnw(k), and rigid-lid boundary conditions w'(k0) = w'(ktop) = 0.  ``gw*t``
is the buoyancy-like coupling to the theta perturbation computed by
advance_mu_t in the same substep (column-local — the solve needs NO halo
exchange, exactly why WRF keeps k on-node and so do we: SURVEY.md §5
"long-context analog").

Layout: w and pp ride the usual (J, K, I) arrays; w(k) lives on the
interface below mass level k (w(k0) is the surface), pp(k) at centers.
Updates apply on the mass window interior; outside it both fields pass
through unchanged.

Tiers: FP-order-exact numpy golden path (vectorized over (j, i); k
sequential) + the native C++ oracle (bit-identical) + a masked SPMD jnp
path + the fused column kernel (ops/substep_triton.py: Thomas sweeps inside
each program).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

F32 = np.float32

#: default linearized vertical sound speed (cw) and buoyancy coupling (gw).
#: cw multiplies rdn ~ K/1 (eta units), so the implicit gain A ~ (cw*dts*K)^2
#: is unconditionally stable (that is the point of the implicit solve); gw is
#: scaled so the theta coupling perturbs w at O(1e-3) per substep at fixture
#: scales (t ~ 1e4).
DEFAULT_CW = 0.02
DEFAULT_GW = 1e-7


def rdn_from_dnw(dnw: np.ndarray) -> np.ndarray:
    """Interface spacing reciprocals: dn(k) = 0.5*(dnw(k) + dnw(k-1)),
    rdn(k) = 1/dn(k), zero at k=0 (no interface below the surface)."""
    dnw = np.asarray(dnw, F32)
    rdn = np.zeros_like(dnw)
    dn = F32(0.5) * (dnw[1:] + dnw[:-1])
    nz = np.nonzero(dn)[0]
    rdn[1:][nz] = (F32(1.0) / dn[nz]).astype(F32)
    return rdn


def advance_w_numpy(*, w, pp, t, rdn, rdnw, dts, epssm, window,
                    k0: int, k1: int, cw=DEFAULT_CW, gw=DEFAULT_GW):
    """Golden-path vertically-implicit substep; returns (w_new, pp_new).

    ``window`` is the mass window (i0, i1, j0, j1); vertical levels
    [k0, k1] are active, with rigid-lid BCs w(k0) = w(k1+1 -> clamped) = 0
    enforced on the implicit solve (w(k0) stays whatever the input carries;
    the solve updates interior interfaces k0+1..k1).
    """
    dts, epssm = F32(dts), F32(epssm)
    cw, gw = F32(cw), F32(gw)
    beta = F32(0.5) * (F32(1.0) + epssm)
    alfa = F32(1.0) - beta

    i0, i1, j0, j1 = window
    js, isl = slice(j0, j1 + 1), slice(i0, i1 + 1)
    w = np.array(w, dtype=F32, copy=True)
    pp = np.array(pp, dtype=F32, copy=True)
    t = np.asarray(t, F32)
    rdn = np.asarray(rdn, F32)
    rdnw = np.asarray(rdnw, F32)

    wv = w[js, :, isl]      # views into the output arrays
    ppv = pp[js, :, isl]
    tv = t[js, :, isl]

    c = cw * dts
    # old-level RHS pieces, computed level-sequentially (FP-order exact)
    nj, K, ni = wv.shape
    # divergence at centers: dv(k) = rdnw(k) * (w(k+1) - w(k)), zero above k1
    dv = np.zeros_like(wv)
    dv[:, k0, :] = rdnw[k0] * (wv[:, k0 + 1, :] - F32(0.0))
    for k in range(k0 + 1, k1):
        dv[:, k, :] = rdnw[k] * (wv[:, k + 1, :] - wv[:, k, :])
    dv[:, k1, :] = rdnw[k1] * (F32(0.0) - wv[:, k1, :])

    # rhs(k) = w(k) + c*beta*rdn(k)*(c*(dv(k) - dv(k-1)))  <- from pp^{n+1}
    #        - c*rdn(k)*(pp(k) - pp(k-1)) + dts*gw*t(k)
    # (the explicit part of the off-centering folds into the single
    #  c*rdn*(pp_k - pp_{k-1}) term because pp^{n+1} substitution already
    #  carries beta*dpp; see module docstring derivation)
    a = np.zeros(K, dtype=F32)   # sub-diagonal coefficient A(k)
    b = np.zeros(K, dtype=F32)   # super-diagonal coefficient B(k)
    for k in range(k0 + 1, k1 + 1):
        a[k] = (c * beta) * (c * beta) * rdn[k] * rdnw[k - 1]
        b[k] = (c * beta) * (c * beta) * rdn[k] * rdnw[k]

    rhs = np.zeros_like(wv)
    for k in range(k0 + 1, k1 + 1):
        rhs[:, k, :] = (
            wv[:, k, :]
            - (c * rdn[k]) * (ppv[:, k, :] - ppv[:, k - 1, :])
            + (((c * beta) * (c * alfa)) * rdn[k]) * (dv[:, k, :] - dv[:, k - 1, :])
            + (dts * gw) * tv[:, k, :]
        )

    # Thomas algorithm: diag(k) = 1 + a(k) + b(k), sub = -a(k), sup = -b(k)
    cp = np.zeros_like(wv)   # modified super-diagonal
    dp = np.zeros_like(wv)   # modified rhs
    w_new = np.zeros_like(wv)
    for k in range(k0 + 1, k1 + 1):
        diag = F32(1.0) + a[k] + b[k]
        if k == k0 + 1:
            denom = diag
            cp[:, k, :] = -b[k] / denom
            dp[:, k, :] = rhs[:, k, :] / denom
        else:
            denom = diag + a[k] * cp[:, k - 1, :]
            cp[:, k, :] = -b[k] / denom
            dp[:, k, :] = (rhs[:, k, :] + a[k] * dp[:, k - 1, :]) / denom
    w_new[:, k1, :] = dp[:, k1, :]
    for k in range(k1 - 1, k0, -1):
        w_new[:, k, :] = dp[:, k, :] - cp[:, k, :] * w_new[:, k + 1, :]
    # rigid lid: w(k0) keeps its input value (surface condition owned by
    # the caller), interfaces above k1 untouched.

    # pp update from the off-centered divergence of the NEW w
    dv_new = np.zeros_like(wv)
    for k in range(k0, k1):
        dv_new[:, k, :] = rdnw[k] * (w_new[:, k + 1, :] - w_new[:, k, :])
    dv_new[:, k1, :] = rdnw[k1] * (F32(0.0) - w_new[:, k1, :])

    for k in range(k0, k1 + 1):
        ppv[:, k, :] = ppv[:, k, :] - c * (
            beta * dv_new[:, k, :] + alfa * dv[:, k, :]
        )
    for k in range(k0 + 1, k1 + 1):
        wv[:, k, :] = w_new[:, k, :]
    return w, pp


def advance_w_jnp(*, w, pp, t, rdn, rdnw, dts, epssm, window,
                  k0: int, k1: int, offsets=(0, 0),
                  cw=DEFAULT_CW, gw=DEFAULT_GW):
    """Masked SPMD vertically-implicit substep on (halo-padded) local
    blocks; same contract as the fused column kernel (global ``window`` +
    ``offsets``).  The tridiagonal sweeps run as ``lax.scan`` over k —
    device-local, no communication."""
    F = jnp.float32
    dts, epssm = F(dts), F(epssm)
    cw, gw = F(cw), F(gw)
    beta = F(0.5) * (F(1.0) + epssm)
    alfa = F(1.0) - beta
    c = cw * dts

    w = jnp.asarray(w, F)
    pp = jnp.asarray(pp, F)
    t = jnp.asarray(t, F)
    rdn = jnp.asarray(rdn, F)
    rdnw = jnp.asarray(rdnw, F)
    J, K, I = w.shape
    j_off, i_off = offsets
    i0, i1, j0, j1 = window
    i_idx = i_off + jnp.arange(I)
    j_idx = j_off + jnp.arange(J)
    mask2 = ((i_idx >= i0) & (i_idx <= i1))[None, :] \
        & ((j_idx >= j0) & (j_idx <= j1))[:, None]          # (J, I)
    mask = mask2[:, None, :]                                  # (J, 1, I)
    kv = jnp.arange(K)
    k_int = ((kv > k0) & (kv <= k1))[None, :, None]           # interfaces
    k_cen = ((kv >= k0) & (kv <= k1))[None, :, None]          # centers

    rdn3 = rdn[None, :, None]
    rdnw3 = rdnw[None, :, None]
    a3 = jnp.where(k_int, ((c * beta) * (c * beta)) * rdn3
                   * jnp.roll(rdnw3, 1, 1), F(0.0))
    b3 = jnp.where(k_int, ((c * beta) * (c * beta)) * rdn3 * rdnw3, F(0.0))

    # center divergence of the old w (w above k1 treated as 0)
    w_act = jnp.where(k_int, w, F(0.0))   # surface interface treated as 0
    w_up = jnp.where((kv < k1)[None, :, None],
                     jnp.roll(w_act, -1, 1), F(0.0))
    dv = jnp.where(k_cen, rdnw3 * (w_up - w_act), F(0.0))

    pp_dn = jnp.roll(pp, 1, 1)
    dv_dn = jnp.roll(dv, 1, 1)
    rhs = jnp.where(
        k_int,
        w + (-(c * rdn3)) * (pp - pp_dn)
        + (((c * beta) * (c * alfa)) * rdn3) * (dv - dv_dn)
        + (dts * gw) * t,
        F(0.0),
    )

    # Thomas sweeps over k (sequential scans; K is device-local)
    def fwd(carry, xs):
        cp_km1, dp_km1 = carry
        ak, bk, rk, is_first = xs
        diag = F(1.0) + ak + bk
        denom = jnp.where(is_first, diag, diag + ak * cp_km1)
        cp_k = -bk / denom
        dp_k = jnp.where(is_first, rk / denom,
                         (rk + ak * dp_km1) / denom)
        return (cp_k, dp_k), (cp_k, dp_k)

    zeros2 = jnp.zeros((J, I), F)
    ks = jnp.arange(K)
    xs = (jnp.moveaxis(a3 * jnp.ones_like(w), 1, 0),
          jnp.moveaxis(b3 * jnp.ones_like(w), 1, 0),
          jnp.moveaxis(rhs, 1, 0),
          (ks == k0 + 1).astype(F)[:, None, None] * jnp.ones((K, J, I), F))
    (_, _), (cps, dps) = jax.lax.scan(fwd, (zeros2, zeros2), xs)

    def bwd(carry, xs):
        w_kp1 = carry
        cp_k, dp_k, active = xs
        w_k = jnp.where(active > 0, dp_k - cp_k * w_kp1, F(0.0))
        return w_k, w_k

    active = ((ks > k0) & (ks <= k1)).astype(F)[:, None, None] \
        * jnp.ones((K, J, I), F)
    _, w_rev = jax.lax.scan(bwd, zeros2, (cps[::-1], dps[::-1], active[::-1]))
    w_sol = jnp.moveaxis(w_rev[::-1], 0, 1)   # (J, K, I)

    w_new = jnp.where(k_int & mask, w_sol, w)

    # pp update from the off-centered divergence of the new w
    wn_act = jnp.where(k_int, w_new, F(0.0))   # surface interface -> 0
    wn_up = jnp.where((kv < k1)[None, :, None],
                      jnp.roll(wn_act, -1, 1), F(0.0))
    dv_new = jnp.where(k_cen, rdnw3 * (wn_up - wn_act), F(0.0))
    pp_new = jnp.where(k_cen & mask,
                       pp - c * (beta * dv_new + alfa * dv), pp)
    return w_new, pp_new
