"""Fused column substep for NVIDIA GPUs: advance_mu_t (+ advance_w) in one
Pallas kernel on the Triton route.

The XLA path (``advance_mu_t_jnp`` + ``advance_w``) materialises its large
intermediates (dvdxi, the mass fluxes, wdtn) in device memory, runs the ww
scan as a ``cumsum`` on the middle axis of ``(j, k, i)`` and the Thomas
sweeps as two ``lax.scan`` loops of one small launch per level.  This
kernel follows the reference CUDA design instead: one program owns a tile
of ``(j, i)`` columns (i across threads, so every level's load is
coalesced) and walks k sequentially inside the program.

Per program, three sweeps over k:

  A. k0..k1: horizontal mass-flux divergence dvdxi(k) -> scratch, and the
     column sum dmdt; then the 2-D mu/muave/muts/mudf update.
  B. 0..K-1: the ww scan carried in registers, wdtn one level ahead, the
     theta update; with ``w``/``pp`` also the right-hand side and forward
     elimination of the vertically-implicit solve (modified rhs -> scratch).
  C. K-1..0 (``w``/``pp`` only): back substitution and the pp update.

Neighbour reads (i±1, j±1) are loads at clamped index vectors, so every
load is in bounds and needs no mask; L1/L2 serve the reuse between
neighbouring programs.  Stores are masked to the array, so ragged tiles
need no padding.  Nothing is carried between programs.  The Thomas
coefficients depend on k only; the wrapper computes them once per call.

Same array contract as :func:`advance_mu_t_impl` (halo-padded local blocks,
boolean window masks) and the same update formulas; results agree with the
XLA path to fp32 rounding (FMA contraction and summation order differ).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .advance_w import DEFAULT_CW, DEFAULT_GW

F = jnp.float32

#: column tile (j rows, i lanes) and warps per program: of eight tiles
#: timed on an H100 (512x512x50 and 1500x1500x50, coupled with and
#: without w), the fastest overall
BLOCK = (4, 64)
NUM_WARPS = 4

_IN3 = ("ww", "ww_1", "u", "u_1", "v", "v_1", "t", "t_1", "t_ave", "ft")
_IN2 = ("mu", "mut", "muu", "muv", "mu_tend",
        "msfuy", "msfvx_inv", "msftx", "msfty")
_IN1 = ("dnw", "fnm", "fnp", "rdnw")
_OUT = ("ww", "mu", "muave", "muts", "mudf", "t", "t_ave")


def _kernel(*refs, K, k0, k1, BJ, BI, with_w, cw, gw):
    n_in = len(_IN3) + len(_IN2) + len(_IN1) + 3 + (6 if with_w else 0)
    ins, outs = refs[:n_in], refs[n_in:]
    it = iter(ins)
    r3 = {n: next(it) for n in _IN3}
    r2 = {n: next(it) for n in _IN2}
    r1 = {n: next(it) for n in _IN1}
    jm_ref, im_ref, sc_ref = next(it), next(it), next(it)
    if with_w:
        w_ref, pp_ref, rdn_ref, a_ref, cp_ref, den_ref = (
            next(it) for _ in range(6))
    it = iter(outs)
    o = {n: next(it) for n in _OUT}
    if with_w:
        o["w"], o["pp"] = next(it), next(it)
    dv_s = next(it)
    dp_s = next(it) if with_w else None

    J, _, I = r3["ww"].shape
    shape = (BJ, BI)
    j = pl.program_id(0) * BJ + lax.broadcasted_iota(jnp.int32, shape, 0)
    i = pl.program_id(1) * BI + lax.broadcasted_iota(jnp.int32, shape, 1)
    inb = (j < J) & (i < I)
    jc, ic = jnp.minimum(j, J - 1), jnp.minimum(i, I - 1)
    jn, ie = jnp.minimum(j + 1, J - 1), jnp.minimum(i + 1, I - 1)
    js, iw = jnp.clip(j - 1, 0, J - 1), jnp.clip(i - 1, 0, I - 1)

    def ld3(ref, jj, k, ii):
        return plgpu.load(ref.at[jj, k, ii])

    def ld2(ref, jj=jc, ii=ic):
        return plgpu.load(ref.at[jj, ii])

    def st3(ref, k, val):
        plgpu.store(ref.at[j, k, i], val, mask=inb)

    def st2(ref, val):
        plgpu.store(ref.at[j, i], val, mask=inb)

    m2 = (ld2(jm_ref, jj=jc, ii=jnp.zeros_like(ic)) != 0) & (
        ld2(im_ref, jj=jnp.zeros_like(jc), ii=ic) != 0)
    rdx, rdy, dts, epssm = sc_ref[0], sc_ref[1], sc_ref[2], sc_ref[3]

    # ---- A: mass-flux divergence, column sum, mu update ---------------
    muu_c, muu_e = ld2(r2["muu"]), ld2(r2["muu"], ii=ie)
    msfuy_c, msfuy_e = ld2(r2["msfuy"]), ld2(r2["msfuy"], ii=ie)
    muv_c, muv_n = ld2(r2["muv"]), ld2(r2["muv"], jj=jn)
    mvx_c, mvx_n = ld2(r2["msfvx_inv"]), ld2(r2["msfvx_inv"], jj=jn)
    msftx_c, msfty_c = ld2(r2["msftx"]), ld2(r2["msfty"])
    mfac = msftx_c * msfty_c

    def sweep_a(k, dmdt):
        u, u1, v, v1 = r3["u"], r3["u_1"], r3["v"], r3["v_1"]
        vflux_c = ld3(v, jc, k, ic) + (muv_c * ld3(v1, jc, k, ic)) * mvx_c
        vflux_n = ld3(v, jn, k, ic) + (muv_n * ld3(v1, jn, k, ic)) * mvx_n
        uflux_c = ld3(u, jc, k, ic) + (muu_c * ld3(u1, jc, k, ic)) / msfuy_c
        uflux_e = ld3(u, jc, k, ie) + (muu_e * ld3(u1, jc, k, ie)) / msfuy_e
        dvdxi = mfac * (rdy * (vflux_n - vflux_c) + rdx * (uflux_e - uflux_c))
        st3(dv_s, k, dvdxi)
        return dmdt + r1["dnw"][k] * dvdxi

    dmdt = lax.fori_loop(k0, k1 + 1, sweep_a, jnp.zeros(shape, F))

    mu_c, mu_tend_c = ld2(r2["mu"]), ld2(r2["mu_tend"])
    tend = dmdt + mu_tend_c
    mu_new = mu_c + dts * tend
    muave = F(0.5) * ((F(1.0) + epssm) * mu_new + (F(1.0) - epssm) * mu_c)
    st2(o["mu"], jnp.where(m2, mu_new, mu_c))
    st2(o["mudf"], jnp.where(m2, tend, F(0.0)))
    st2(o["muts"], jnp.where(m2, ld2(r2["mut"]) + mu_new, F(0.0)))
    st2(o["muave"], jnp.where(m2, muave, F(0.0)))

    # ---- B: ww scan, wdtn, theta (+ implicit-w forward elimination) ----
    if with_w:
        c = F(cw) * dts
        beta = F(0.5) * (F(1.0) + epssm)
        alfa = F(1.0) - beta
        cbca = (c * beta) * (c * alfa)
        dtsgw = dts * F(gw)

    def k_int(k):           # w interfaces updated by the implicit solve
        return (k > k0) & (k <= k1)

    def k_cen(k):           # active mass levels
        return (k >= k0) & (k <= k1)

    def sweep_b(k, carry):
        ws, wd_k, t1_k = carry[:3]
        kn = jnp.minimum(k + 1, K - 1)
        act = m2 & k_cen(k)
        ww_k = ld3(r3["ww"], jc, k, ic)
        st3(o["ww"], k, jnp.where(act, ws - ld3(r3["ww_1"], jc, k, ic), ww_k))

        # the scan value one level up, and wdtn there
        step = (k >= k0) & (k < k1)
        dvd = ld3(dv_s, jc, jnp.clip(k, k0, k1), ic)
        ws_n = jnp.where(step, ws + (-r1["dnw"][k]) * (dmdt + dvd + mu_tend_c)
                         / msfty_c, ws)
        t1_n = ld3(r3["t_1"], jc, kn, ic)
        interp = r1["fnm"][kn] * t1_n + r1["fnp"][kn] * t1_k
        wd_n = jnp.where(step, (ws_n - ld3(r3["ww_1"], jc, kn, ic)) * interp,
                         F(0.0))

        t1 = r3["t_1"]
        fy = (ld3(r3["v"], jn, k, ic) * (ld3(t1, jn, k, ic) + t1_k)
              - ld3(r3["v"], jc, k, ic) * (t1_k + ld3(t1, js, k, ic)))
        fx = (ld3(r3["u"], jc, k, ie) * (ld3(t1, jc, k, ie) + t1_k)
              - ld3(r3["u"], jc, k, ic) * (t1_k + ld3(t1, jc, k, iw)))
        horiz = msftx_c * (F(0.5) * rdy * fy + F(0.5) * rdx * fx)
        vert = r1["rdnw"][k] * (wd_n - wd_k)
        t_k = ld3(r3["t"], jc, k, ic)
        t_half = t_k + (msfty_c * dts) * ld3(r3["ft"], jc, k, ic)
        t_new = jnp.where(act, t_half - (dts * msfty_c) * (horiz + vert), t_k)
        st3(o["t"], k, t_new)
        st3(o["t_ave"], k,
            jnp.where(act, t_k, ld3(r3["t_ave"], jc, k, ic)))
        if not with_w:
            return ws_n, wd_n, t1_n

        w_k, pp_km1, dv_km1, dp_km1 = carry[3:]
        w_n = ld3(w_ref, jc, kn, ic)
        w_up = jnp.where(k_int(k + 1) & (k < k1), w_n, F(0.0))
        w_act = jnp.where(k_int(k), w_k, F(0.0))
        dv_k = jnp.where(k_cen(k), r1["rdnw"][k] * (w_up - w_act), F(0.0))
        pp_k = ld3(pp_ref, jc, k, ic)
        rdn_k = rdn_ref[k]
        rhs = jnp.where(
            k_int(k),
            w_k + (-(c * rdn_k)) * (pp_k - pp_km1)
            + (cbca * rdn_k) * (dv_k - dv_km1) + dtsgw * t_new,
            F(0.0))
        dp_k = (rhs + a_ref[k] * dp_km1) / den_ref[k]
        st3(dp_s, k, dp_k)
        return ws_n, wd_n, t1_n, w_n, pp_k, dv_k, dp_k

    zeros = jnp.zeros(shape, F)
    carry = (ld3(r3["ww"], jc, k0, ic), zeros, ld3(r3["t_1"], jc, 0, ic))
    if with_w:
        carry += (ld3(w_ref, jc, 0, ic), zeros, zeros, zeros)
    lax.fori_loop(0, K, sweep_b, carry)
    if not with_w:
        return

    # ---- C: back substitution and the pp update -----------------------
    def sweep_c(n, carry):
        wsol_up, wold_up = carry
        k = K - 1 - n
        w_k = ld3(w_ref, jc, k, ic)
        wsol = jnp.where(k_int(k),
                         ld3(dp_s, jc, k, ic) - cp_ref[k] * wsol_up, F(0.0))
        st3(o["w"], k, jnp.where(k_int(k) & m2, wsol, w_k))
        dv_new = jnp.where(k_cen(k), r1["rdnw"][k] * (wsol_up - wsol), F(0.0))
        w_up = jnp.where(k_int(k + 1) & (k < k1), wold_up, F(0.0))
        w_act = jnp.where(k_int(k), w_k, F(0.0))
        dv_old = jnp.where(k_cen(k), r1["rdnw"][k] * (w_up - w_act), F(0.0))
        pp_k = ld3(pp_ref, jc, k, ic)
        st3(o["pp"], k, jnp.where(k_cen(k) & m2,
                                  pp_k - c * (beta * dv_new + alfa * dv_old),
                                  pp_k))
        return wsol, w_k

    lax.fori_loop(0, K, sweep_c, (zeros, zeros))


def thomas_coefficients(rdn, rdnw, dts, epssm, k0: int, k1: int,
                        cw=DEFAULT_CW):
    """Column-independent coefficients of the implicit w solve: the
    sub-diagonal ``a(k)``, the modified super-diagonal ``cp(k)`` and the
    elimination denominator ``den(k)``, each ``(K,)``, computed with the
    same operations as :func:`advance_w_jnp`'s forward sweep."""
    dts, epssm = F(dts), F(epssm)
    beta = F(0.5) * (F(1.0) + epssm)
    c = F(cw) * dts
    rdn, rdnw = jnp.asarray(rdn, F), jnp.asarray(rdnw, F)
    kv = jnp.arange(rdn.shape[0])
    k_int = (kv > k0) & (kv <= k1)
    a = jnp.where(k_int, ((c * beta) * (c * beta)) * rdn
                  * jnp.roll(rdnw, 1), F(0.0))
    b = jnp.where(k_int, ((c * beta) * (c * beta)) * rdn * rdnw, F(0.0))

    def fwd(cp_km1, xs):
        ak, bk, first = xs
        diag = F(1.0) + ak + bk
        den = jnp.where(first, diag, diag + ak * cp_km1)
        cp = -bk / den
        return cp, (cp, den)

    _, (cp, den) = lax.scan(fwd, F(0.0), (a, b, kv == k0 + 1))
    return a, cp, den


def substep_triton(*, ww, ww_1, u, u_1, v, v_1, mu, mut, muu, muv,
                   t, t_1, t_ave, ft, mu_tend, rdx, rdy, dts, epssm,
                   dnw, fnm, fnp, rdnw, msfuy, msfvx_inv, msftx, msfty,
                   i_mask, j_mask, k0: int, k1: int,
                   w=None, pp=None, rdn=None,
                   cw=DEFAULT_CW, gw=DEFAULT_GW,
                   interpret: bool = False):
    """One fused advance_mu_t substep (and, with ``w``/``pp``/``rdn``, the
    advance_w substep on the theta it produces) on halo-padded local
    blocks.  Returns the :func:`advance_mu_t_impl` output dict, plus
    ``w``/``pp`` when they are given.  ``interpret`` runs the kernel in the
    Pallas interpreter (tests on the CPU); the caller chooses it."""
    with_w = w is not None
    J, K, I = ww.shape
    BJ, BI = BLOCK
    a3 = {"ww": ww, "ww_1": ww_1, "u": u, "u_1": u_1, "v": v, "v_1": v_1,
          "t": t, "t_1": t_1, "t_ave": t_ave, "ft": ft}
    a2 = {"mu": mu, "mut": mut, "muu": muu, "muv": muv, "mu_tend": mu_tend,
          "msfuy": msfuy, "msfvx_inv": msfvx_inv, "msftx": msftx,
          "msfty": msfty}
    a1 = {"dnw": dnw, "fnm": fnm, "fnp": fnp, "rdnw": rdnw}
    args = ([jnp.asarray(a3[n], F) for n in _IN3]
            + [jnp.asarray(a2[n], F) for n in _IN2]
            + [jnp.asarray(a1[n], F) for n in _IN1]
            + [jnp.asarray(j_mask, jnp.int32)[:, None],
               jnp.asarray(i_mask, jnp.int32)[None, :],
               jnp.stack([F(rdx), F(rdy), F(dts), F(epssm)])])
    s3 = jax.ShapeDtypeStruct((J, K, I), F)
    s2 = jax.ShapeDtypeStruct((J, I), F)
    out_shape = [s3, s2, s2, s2, s2, s3, s3]
    if with_w:
        args += [jnp.asarray(w, F), jnp.asarray(pp, F), jnp.asarray(rdn, F),
                 *thomas_coefficients(rdn, rdnw, dts, epssm, k0, k1, cw)]
        out_shape += [s3, s3]
    out_shape += [s3] + ([s3] if with_w else [])   # dvdxi, dp scratch

    kernel = functools.partial(_kernel, K=K, k0=k0, k1=k1, BJ=BJ, BI=BI,
                               with_w=with_w, cw=cw, gw=gw)
    res = pl.pallas_call(
        kernel, out_shape=out_shape,
        grid=(pl.cdiv(J, BJ), pl.cdiv(I, BI)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="wrf_substep_w" if with_w else "wrf_substep",
    )(*args)
    return dict(zip(_OUT + (("w", "pp") if with_w else ()), res))
