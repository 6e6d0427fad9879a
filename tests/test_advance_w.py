"""Vertically-implicit w/pp substep (advance_w): tier agreement and the
coupled loop with the vertical-acoustics substep enabled."""

import jax
import numpy as np
import pytest

from tests.conftest import outputs_allclose
from wrf_tpu.io import fixtures
from wrf_tpu.models.small_step import SmallStepLoop, small_step_golden
from wrf_tpu.ops.advance_w import (
    DEFAULT_CW, DEFAULT_GW, advance_w_jnp, advance_w_numpy, rdn_from_dnw,
)
from wrf_tpu.parallel.mesh import make_mesh
from wrf_tpu.parallel.sharded import case_to_domain, embed_outputs


def _w_args(case):
    kw = case.kernel_kwargs()
    i0, i1, j0, j1, k0, k1 = case.bounds.loop_bounds(case.flags)
    f = case.fields
    return dict(
        w=f["grid_w"], pp=f["grid_pp"], t=kw["t_1"],
        rdn=f["grid_rdn"], rdnw=kw["rdnw"],
        dts=case.dts, epssm=case.epssm,
        window=(i0, i1, j0, j1), k0=k0, k1=k1,
    )


def test_rdn_from_dnw(small_case):
    dnw = np.asarray(small_case.kernel_kwargs()["dnw"])
    rdn = rdn_from_dnw(dnw)
    assert rdn[0] == 0.0
    k = 3
    assert rdn[k] == np.float32(1.0) / (np.float32(0.5) * (dnw[k] + dnw[k - 1]))


def test_advance_w_jnp_matches_numpy(small_case):
    args = _w_args(small_case)
    wn, ppn = advance_w_numpy(**args)
    wj, ppj = advance_w_jnp(**args)
    assert (wn != np.asarray(args["w"])).any(), "w never moved"
    np.testing.assert_allclose(np.asarray(wj), wn, rtol=2e-6, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ppj), ppn, rtol=2e-6, atol=1e-4)


def test_advance_w_native_bitwise(small_case):
    from wrf_tpu.native import advance_w_native
    case = small_case
    args = _w_args(case)
    wn, ppn = advance_w_numpy(**args)
    wc, ppc = advance_w_native(
        w=args["w"], pp=args["pp"], t=args["t"], rdn=args["rdn"],
        rdnw=args["rdnw"], dts=case.dts, epssm=case.epssm,
        cw=DEFAULT_CW, gw=DEFAULT_GW, flags=case.flags, bounds=case.bounds,
    )
    assert (wn == wc).all(), "w differs bitwise"
    assert (ppn == ppc).all(), "pp differs bitwise"


def test_advance_w_preserves_outside_window(small_case):
    args = _w_args(small_case)
    i0, i1, j0, j1 = args["window"]
    k0 = args["k0"]
    wn, ppn = advance_w_numpy(**args)
    w0, pp0 = np.asarray(args["w"]), np.asarray(args["pp"])
    assert (wn[:j0] == w0[:j0]).all()
    assert (wn[:, :, :i0] == w0[:, :, :i0]).all()
    assert (ppn[j1 + 1 :] == pp0[j1 + 1 :]).all()
    # surface interface is inert
    assert (wn[:, k0, :] == w0[:, k0, :]).all()


def test_implicit_stability(small_case):
    """The implicit solve is unconditionally stable: 300 substeps of the
    pure vertical system stay bounded (the explicit analog diverges)."""
    args = _w_args(small_case)
    w, pp = args.pop("w"), args.pop("pp")
    args["gw"] = 0.0  # isolate the acoustic system from the theta forcing
    amp0 = float(np.abs(pp).max())
    for _ in range(300):
        w, pp = advance_w_numpy(w=w, pp=pp, **args)
    assert np.isfinite(w).all() and np.isfinite(pp).all()
    assert float(np.abs(pp).max()) < 10 * amp0


def test_fused_kernel_matches_composition(small_case, monkeypatch):
    """One fused kernel call (Pallas interpreter, ragged (2, 8) column
    tiles) == advance_mu_t golden followed by advance_w golden on the
    updated theta."""
    import jax.numpy as jnp

    from wrf_tpu.ops import substep_triton as kernel_module
    from wrf_tpu.ops.advance_mu_t_jnp import window_masks
    from wrf_tpu.ops.reference_numpy import advance_mu_t_numpy
    from wrf_tpu.ops.substep_triton import substep_triton
    monkeypatch.setattr(kernel_module, "BLOCK", (2, 8))
    case = small_case
    kw = case.kernel_kwargs()
    i0, i1, j0, j1, k0, k1 = case.bounds.loop_bounds(case.flags)
    f = case.fields
    gold = advance_mu_t_numpy(**kw)
    wg, ppg = advance_w_numpy(
        w=f["grid_w"], pp=f["grid_pp"], t=gold["t"], rdn=f["grid_rdn"],
        rdnw=kw["rdnw"], dts=case.dts, epssm=case.epssm,
        window=(i0, i1, j0, j1), k0=k0, k1=k1,
    )
    names = ("ww", "ww_1", "u", "u_1", "v", "v_1", "mu", "mut", "muu", "muv",
             "t", "t_1", "t_ave", "ft", "mu_tend", "dnw", "fnm", "fnp",
             "rdnw", "msfuy", "msfvx_inv", "msftx", "msfty", "rdx", "rdy",
             "dts", "epssm")
    i_mask, j_mask = (jnp.asarray(m)
                      for m in window_masks(case.bounds, case.flags))
    out = substep_triton(
        **{k: kw[k] for k in names}, i_mask=i_mask, j_mask=j_mask,
        k0=k0, k1=k1, w=f["grid_w"], pp=f["grid_pp"], rdn=f["grid_rdn"],
        cw=DEFAULT_CW, gw=DEFAULT_GW, interpret=True,
    )
    outputs_allclose(
        {n: out[n] for n in ("ww", "t", "mu", "w", "pp")},
        {"ww": gold["ww"], "t": gold["t"], "mu": gold["mu"],
         "w": wg, "pp": ppg},
        rtol=5e-5, atol_scale=2e-6,
    )


def loop_with_w_vs_golden(case, mesh_shape, steps, kernel, **tol):
    mesh = make_mesh(jax.devices()[: mesh_shape[0] * mesh_shape[1]], mesh_shape)
    nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
    loop = SmallStepLoop(mesh, nx, ny, nz, case.flags, n_steps=steps,
                         kernel=kernel, with_w=True,
                         interpret=kernel == "triton")
    arrays = loop.prepare(case_to_domain(case, with_w=True))
    got_dom = loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)

    gold = small_step_golden(case, steps, with_w=True)
    got = embed_outputs(case, got_dom)
    outputs_allclose(got, gold, **tol)


@pytest.mark.parametrize("mesh_shape,kernel", [
    ((4, 2), "triton"),   # the default kernel, sharded: quick
    ((1, 1), "xla"),      # the XLA path, single: quick
    pytest.param((4, 2), "xla", marks=pytest.mark.full),
    pytest.param((1, 1), "triton", marks=pytest.mark.full),
])
def test_coupled_loop_with_w(small_case, mesh_shape, kernel):
    """Full coupled loop (uv + mu/t + implicit w) reassembles to the golden
    loop across mesh decompositions."""
    loop_with_w_vs_golden(small_case, mesh_shape, steps=5, kernel=kernel,
                          rtol=5e-5, atol_scale=2e-6)


@pytest.mark.full
def test_coupled_loop_with_w_100_steps(small_case):
    loop_with_w_vs_golden(small_case, (2, 4), steps=100, kernel="triton",
                          rtol=2e-4, atol_scale=2e-5)
