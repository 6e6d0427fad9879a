"""RK3 shell tests: mesh-decomposed RK3 step vs the golden-path RK3."""

import jax
import numpy as np
import pytest

from tests.conftest import outputs_allclose
from wrf_tpu.models.rk3 import RK3Integrator, rk3_golden, rk3_stages
from wrf_tpu.parallel.mesh import make_mesh
from wrf_tpu.parallel.sharded import case_to_domain, embed_domain, embed_outputs


def test_stage_schedule():
    assert rk3_stages(6) == ((1.0 / 3.0, 1), (0.5, 3), (1.0, 6))
    assert rk3_stages(4) == ((1.0 / 3.0, 1), (0.5, 2), (1.0, 4))


def test_default_snapshot_is_stable_mode():
    """The constructor default must be the stable base-state closure —
    stage mode amplifies ~5e4x/step and is opt-in only (rk3.py docstring)."""
    import inspect

    assert inspect.signature(RK3Integrator.__init__).parameters[
        "snapshot"].default == "base"
    assert inspect.signature(rk3_golden).parameters["snapshot"].default \
        == "base"


def test_rk3_matches_golden(small_case):
    case = small_case
    mesh = make_mesh(jax.devices(), (4, 2))
    nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
    # explicit opt-in: stage mode is the bounded-horizon structure test
    # (one large step), never the default (rk3.py docstring)
    rk3 = RK3Integrator(mesh, nx, ny, nz, case.flags, acoustic_steps=4,
                        kernel="xla", snapshot="stage")
    arrays = rk3.prepare(case_to_domain(case))
    dt = case.dts * 4
    out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm)

    gold = rk3_golden(case, acoustic_steps=4, dt=dt, snapshot="stage")
    kw = case.kernel_kwargs()
    got = {}
    for name in ("ww", "mu", "t", "t_ave", "u", "v"):
        got[name] = embed_domain(np.asarray(out[name]), np.asarray(kw[name]),
                                 case.bounds)
    outputs_allclose(got, {k: gold[k] for k in got},
                     rtol=5e-5, atol_scale=2e-6)


@pytest.mark.full
def test_rk3_with_w_matches_golden(small_case):
    """RK3 over the full substep (uv + mu/t + implicit w), fused kernel."""
    case = small_case
    mesh = make_mesh(jax.devices()[:4], (2, 2))
    nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
    rk3 = RK3Integrator(mesh, nx, ny, nz, case.flags, acoustic_steps=4,
                        kernel="triton", with_w=True, interpret=True)
    arrays = rk3.prepare(case_to_domain(case, with_w=True))
    dt = case.dts * 4
    out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm)

    gold = rk3_golden(case, acoustic_steps=4, dt=dt, with_w=True)
    names = ("ww", "mu", "t", "t_ave", "u", "v", "w", "pp")
    got = embed_outputs(case, {n: out[n] for n in names})
    outputs_allclose(got, {k: gold[k] for k in got},
                     rtol=5e-5, atol_scale=2e-6)


def test_rk3_tendency_hook(small_case):
    """The hook can rescale the slow tendencies and sees provisional outputs."""
    case = small_case
    mesh = make_mesh(jax.devices()[:1], (1, 1))
    nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
    rk3 = RK3Integrator(mesh, nx, ny, nz, case.flags, acoustic_steps=2,
                        kernel="xla")
    arrays = rk3.prepare(case_to_domain(case))
    seen = []

    def hook(stage, prev_out, stage_arrays):
        seen.append((stage, prev_out is not None))
        return {"ft": stage_arrays["ft"] * 0.0}

    out = rk3.step(arrays, case.rdx, case.rdy, case.dts * 2, case.epssm,
                   tendency_fn=hook)
    assert seen == [(0, False), (1, True), (2, True)]
    assert np.isfinite(np.asarray(out["t"])).all()


from wrf_tpu.io import fixtures as _fixtures


@pytest.fixture(scope="module")
def balanced_case():
    return _fixtures.make_case(20, 18, 8, halo=2, seed=7, amplitude=1e-2,
                               balanced=True)


@pytest.mark.full
def test_multi_step_matches_host_stepping(balanced_case):
    """The device-resident large-step scan (multi_step) is bit-identical
    to host-stepped rk3.step + merge over the same horizon, and its
    in-graph diagnostics match host-computed sums."""
    import jax
    import jax.numpy as jnp

    from wrf_tpu.models.tendencies import NudgingTendencies
    from wrf_tpu.parallel.mesh import make_mesh
    from wrf_tpu.parallel.sharded import case_to_domain

    case = balanced_case
    nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
    mesh = make_mesh(jax.devices()[:4], (2, 2))
    rk3 = RK3Integrator(mesh, nx, ny, nz, case.flags, acoustic_steps=4,
                        kernel="xla", smdiv=0.1, snapshot="base")
    arrays = rk3.prepare(case_to_domain(case))
    dt = case.dts * 4
    fn = NudgingTendencies(arrays, dt, tau_steps=5.0)

    # host-stepped reference: 3 steps of step() + interior merge + damping
    host = dict(arrays)
    host_diag = []
    for _ in range(3):
        out = rk3.step(host, case.rdx, case.rdy, dt, case.epssm,
                       tendency_fn=fn)
        for name in rk3._EVOLVED:
            if name in out and name in host:
                v = out[name]
                if v.ndim == 3:
                    host[name] = host[name].at[1:1 + ny, :, 1:1 + nx].set(v)
                else:
                    host[name] = host[name].at[1:1 + ny, 1:1 + nx].set(v)
        fn.damp_winds(host)
        host_diag.append(float(jnp.sum(out["mu"])))
    fn._step_tend = None

    fused, diags = rk3.multi_step(arrays, 3, case.rdx, case.rdy, dt,
                                  case.epssm, tendency_fn=fn)
    assert diags.shape == (3, 2)
    assert np.isfinite(diags).all()
    # within-a-few-ulp agreement, not bit-equality: XLA fuses the inlined
    # step differently inside the scan than across eager dispatch
    # boundaries (measured: last-ulp scatter on <5% of elements)
    for name in ("t", "mu", "u", "v", "ww"):
        a, b = np.asarray(fused[name]), np.asarray(host[name])
        scale = np.max(np.abs(b)) or 1.0
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * scale,
                                   err_msg=name)
    np.testing.assert_allclose(diags[:, 0], np.asarray(host_diag,
                                                       dtype=np.float32),
                               rtol=1e-5)
    # the closure object is restored for host-side reuse after tracing
    assert hasattr(fn.ref_t, "dtype") and fn._step_tend is None
