"""Long-horizon integration: the nudging closure (models/tendencies.py).

The degenerate RK3 shell diverges after ~2 large steps; the consistent
closure (base-state snapshot + nudging tendencies + balanced base winds)
must sustain 100 large steps with bounded state and total-mass drift, and
the mesh-decomposed loop must track the golden path over a multi-step
horizon."""

import dataclasses

import jax
import numpy as np
import pytest

from tests.conftest import outputs_allclose
from wrf_tpu.io import fixtures
from wrf_tpu.models.rk3 import RK3Integrator, rk3_golden_run
from wrf_tpu.models.tendencies import NudgingTendencies, golden_nudging_fn
from wrf_tpu.parallel.mesh import make_mesh
from wrf_tpu.parallel.sharded import case_to_domain


@pytest.fixture(scope="module")
def balanced_case():
    return fixtures.make_case(20, 18, 8, halo=2, seed=7, amplitude=1e-2,
                              balanced=True)


def test_balanced_base_flux_nondivergent(balanced_case):
    """The minted base winds recouple to a discretely non-divergent mass
    flux: rdx*d_i(U) + rdy*d_j(V) ~ 0 at every interior cell."""
    f = balanced_case.fields
    U = (f["grid_muu"][:, None, :] * f["grid_u_save"]
         / f["grid_msfuy"][:, None, :])
    V = (f["grid_muv"][:, None, :] * f["grid_v_save"]
         * f["grid_msfvx_inv"][:, None, :])
    rdx, rdy = np.float32(balanced_case.rdx), np.float32(balanced_case.rdy)
    div = (rdx * (U[:-1, :, 1:] - U[:-1, :, :-1])
           + rdy * (V[1:, :, :-1] - V[:-1, :, :-1]))
    # the telescoping cancellation is exact in real arithmetic; the fp32
    # residual comes from the uncouple/recouple round-trip (~2 ulp of the
    # flux) entering the rdx/rdy-scaled differences
    flux_scale = float(np.abs(U).max())
    assert float(np.abs(div).max()) < 20 * flux_scale * 1.2e-7 * float(rdx)


def test_golden_closure_100_large_steps(balanced_case):
    """100 RK3 large steps on the golden path: state bounded (no growth
    over the initial scale), total dry mass drift < 2e-6."""
    case = balanced_case
    dt = case.dts * 6
    masses, maxts = [], []

    def diag(step, out):
        masses.append(float(np.sum(out["muts"], dtype=np.float64)))
        maxts.append(float(np.abs(out["t"]).max()))

    out = rk3_golden_run(
        case, 100, acoustic_steps=6, smdiv=0.1, snapshot="base",
        tendency_fn=golden_nudging_fn(case, dt, tau_steps=5.0),
        rayleigh_uv=0.1, diag_cb=diag)
    assert np.isfinite(out["t"]).all()
    t0 = float(np.abs(case.fields["grid_t_2"]).max())
    assert max(maxts) < 3.0 * t0, f"state grew: {max(maxts):.3e} vs {t0:.3e}"
    drift = max(abs(m - masses[0]) / abs(masses[0]) for m in masses)
    assert drift < 2e-6, f"total-mass drift {drift:.2e}"


def test_degenerate_shell_still_diverges(balanced_case):
    """Control: the stage-snapshot shell blows up within a few steps on
    the same fixture (documents WHY the closure exists)."""
    out = rk3_golden_run(balanced_case, 4, acoustic_steps=6,
                         snapshot="stage")
    assert (not np.isfinite(out["t"]).all()
            or float(np.abs(out["t"]).max())
            > 1e3 * float(np.abs(balanced_case.fields["grid_t_2"]).max()))


@pytest.mark.full
@pytest.mark.parametrize("kernel", ["xla", "triton"])
def test_mesh_closure_matches_golden(balanced_case, kernel):
    """10 closed-loop large steps: the mesh-decomposed integrator with
    NudgingTendencies tracks the golden path (the run_sim long-horizon
    configuration, cross-checked end to end)."""
    case = balanced_case
    mesh = make_mesh(jax.devices(), (4, 2))
    nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
    dt = case.dts * 6
    rk3 = RK3Integrator(mesh, nx, ny, nz, case.flags, acoustic_steps=6,
                        kernel=kernel, smdiv=0.1, snapshot="base",
                        interpret=kernel == "triton")
    arrays = rk3.prepare(case_to_domain(case))
    fn = NudgingTendencies(arrays, dt, tau_steps=5.0, rayleigh_uv=0.1)

    n_large = 10
    for _ in range(n_large):
        out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                       tendency_fn=fn)
        for name in ("ww", "mu", "t", "t_ave", "u", "v"):
            val = out[name]
            if val.ndim == 3:
                arrays[name] = arrays[name].at[1:1 + ny, :, 1:1 + nx].set(val)
            else:
                arrays[name] = arrays[name].at[1:1 + ny, 1:1 + nx].set(val)
        fn.damp_winds(arrays)

    gold = rk3_golden_run(
        case, n_large, acoustic_steps=6, smdiv=0.1, snapshot="base",
        tendency_fn=golden_nudging_fn(case, dt, tau_steps=5.0),
        rayleigh_uv=0.1)
    # compare over the domain region only: the memory-window frame outside
    # it is fixture halo the mesh state never carries (the golden path
    # Rayleigh-damps those pass-through cells, the mesh has no such cells)
    b = case.bounds
    j0, j1 = b.mem(b.jds, "j"), b.mem(b.jde, "j")
    i0, i1 = b.mem(b.ids, "i"), b.mem(b.ide, "i")
    got, gld = {}, {}
    for name in ("ww", "mu", "t", "t_ave", "u", "v"):
        g = np.asarray(gold[name])
        gld[name] = (g[j0:j1 + 1, :, i0:i1 + 1] if g.ndim == 3
                     else g[j0:j1 + 1, i0:i1 + 1])
        got[name] = np.asarray(out[name])
        assert got[name].shape == gld[name].shape
    outputs_allclose(got, gld, rtol=2e-4, atol_scale=2e-5)


def test_tau_floor_enforced(balanced_case):
    with pytest.raises(ValueError, match="tau_steps"):
        NudgingTendencies({"t": None, "mu": None}, 12.0, tau_steps=1.0)
