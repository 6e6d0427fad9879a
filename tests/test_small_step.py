"""Flagship-model tests: the acoustic small-step loop (uv + mu/t substeps)
with per-substep halo exchange, vs the numpy golden loop."""

import jax
import numpy as np
import pytest

from tests.conftest import outputs_allclose
from wrf_tpu.io import fixtures
from wrf_tpu.models.small_step import SmallStepLoop, small_step_golden
from wrf_tpu.ops.advance_uv import advance_uv_jnp, advance_uv_numpy
from wrf_tpu.parallel.mesh import make_mesh
from wrf_tpu.parallel.sharded import case_to_domain, embed_domain


def test_advance_uv_jnp_matches_numpy(small_case):
    case = small_case
    kw = case.kernel_kwargs()
    i0, i1, j0, j1, _, _ = case.bounds.loop_bounds(case.flags)
    args = dict(
        u=kw["u"], v=kw["v"], mu=kw["mu"], muu=kw["muu"], muv=kw["muv"],
        msfuy=kw["msfuy"], msfvx_inv=kw["msfvx_inv"],
        rdx=kw["rdx"], rdy=kw["rdy"], dts=kw["dts"],
        window=(i0, i1, j0, j1),
    )
    ug, vg = advance_uv_numpy(**args)
    uj, vj = advance_uv_jnp(**args)
    np.testing.assert_allclose(np.asarray(uj), ug, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(vj), vg, rtol=1e-6)
    # winds actually moved somewhere
    assert (ug != np.asarray(kw["u"])).any()


def test_advance_uv_preserves_outside_window(small_case):
    case = small_case
    kw = case.kernel_kwargs()
    i0, i1, j0, j1, _, _ = case.bounds.loop_bounds(case.flags)
    ug, vg = advance_uv_numpy(
        u=kw["u"], v=kw["v"], mu=kw["mu"], muu=kw["muu"], muv=kw["muv"],
        msfuy=kw["msfuy"], msfvx_inv=kw["msfvx_inv"],
        rdx=kw["rdx"], rdy=kw["rdy"], dts=kw["dts"], window=(i0, i1, j0, j1),
    )
    # u updated only on interior edge points: i in [i0+1, i1], j in [j0, j1]
    assert (ug[:, :, : i0 + 1] == kw["u"][:, :, : i0 + 1]).all()
    assert (ug[:j0] == kw["u"][:j0]).all()
    assert (vg[: j0 + 1] == kw["v"][: j0 + 1]).all()


def sharded_loop_vs_golden(case, mesh_shape, steps, kernel="xla", **tol):
    mesh = make_mesh(jax.devices()[: mesh_shape[0] * mesh_shape[1]], mesh_shape)
    nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
    loop = SmallStepLoop(mesh, nx, ny, nz, case.flags, n_steps=steps,
                         kernel=kernel, interpret=kernel == "triton")
    arrays = loop.prepare(case_to_domain(case))
    got_dom = loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)

    gold = small_step_golden(case, steps)
    kw = case.kernel_kwargs()
    got = {}
    for name, val in got_dom.items():
        if name in ("ww", "mu", "t", "t_ave", "u", "v"):
            like = np.asarray(kw[name])
        else:
            like = np.zeros_like(gold[name])
        got[name] = embed_domain(np.asarray(val), like, case.bounds)
    outputs_allclose(got, gold, **tol)


@pytest.mark.parametrize("kernel", ["xla", "triton"])
@pytest.mark.parametrize("mesh_shape", [
    (4, 2),
    pytest.param((2, 4), marks=pytest.mark.full),
    (1, 1),
])
def test_small_step_loop_matches_golden(small_case, mesh_shape, kernel):
    """The full acoustic loop with per-substep halo exchange of mu/u/v
    reassembles to the golden loop — this is what validates the in-scan
    ppermute refresh (winds change every substep and cross shard edges)."""
    sharded_loop_vs_golden(small_case, mesh_shape, steps=5, kernel=kernel,
                           rtol=5e-5, atol_scale=2e-6)


@pytest.mark.parametrize("kernel", ["xla", "triton"])
def test_small_step_loop_periodic(periodic_case, kernel):
    """Periodic-x BCs exercise the widest masks."""
    sharded_loop_vs_golden(periodic_case, (2, 4), steps=5, kernel=kernel,
                           rtol=5e-5, atol_scale=2e-6)


def test_small_step_loop_open_bc(open_bc_case):
    """Open BCs make the window reach the ring rows — the fused kernel's
    clamped edge reads and pass-through cells carry real BC data there."""
    sharded_loop_vs_golden(open_bc_case, (2, 2), steps=5, kernel="triton",
                           rtol=5e-5, atol_scale=2e-6)


def test_small_step_100_steps_stability(small_case):
    """BASELINE acceptance shape: 100 coupled substeps stay finite and
    allclose to the golden loop."""
    sharded_loop_vs_golden(small_case, (4, 2), steps=100,
                           rtol=2e-4, atol_scale=2e-5)


def test_winds_feed_back(small_case):
    """The coupling is real: after N steps the mu field differs from the
    frozen-wind iteration (otherwise advance_uv would be dead code)."""
    case = small_case
    gold_coupled = small_step_golden(case, 10)
    from tests.test_advance_mu_t import run_steps
    from wrf_tpu.ops.reference_numpy import advance_mu_t_numpy
    gold_frozen = run_steps(advance_mu_t_numpy, case, steps=10)
    assert np.abs(gold_coupled["mu"] - gold_frozen["mu"]).max() > 1e-3


def test_native_coupled_loop_bitwise(small_case):
    """Native C++ coupled loop (advance_uv + advance_mu_t) is bit-identical
    to the numpy golden loop — the flagship model has a full native tier."""
    from wrf_tpu.native import advance_mu_t_native, advance_uv_native
    from wrf_tpu.ops.advance_uv import DEFAULT_CS2
    case = small_case
    kw = case.kernel_kwargs()
    state = {k: np.asarray(kw[k]) for k in
             ("ww", "mu", "t", "t_ave", "u", "v")}
    steps = 10
    out = dict(state)
    for _ in range(steps):
        u, v = advance_uv_native(
            u=state["u"], v=state["v"], mu=state["mu"],
            muu=kw["muu"], muv=kw["muv"],
            msfuy=kw["msfuy"], msfvx_inv=kw["msfvx_inv"],
            rdx=kw["rdx"], rdy=kw["rdy"], dts=kw["dts"], cs2=DEFAULT_CS2,
            flags=case.flags, bounds=case.bounds,
        )
        out = advance_mu_t_native(**{**kw, **state, "u": u, "v": v})
        state = {**{k: out[k] for k in ("ww", "mu", "t", "t_ave")},
                 "u": u, "v": v}
    gold = small_step_golden(case, steps)
    for name in ("ww", "mu", "t", "t_ave"):
        assert (out[name] == gold[name]).all(), f"{name} differs bitwise"
    assert (state["u"] == gold["u"]).all()
    assert (state["v"] == gold["v"]).all()


def test_divergence_damping_vs_golden(small_case):
    """Divergence damping (smdiv): the previous substep's mudf stiffens the
    wind update's pressure gradient — the consumer of the mudf field the
    reference computes but never uses (module_small_step_em.f90 'save for
    the div damping filter')."""
    case = small_case
    mesh = make_mesh(jax.devices()[:4], (2, 2))
    nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
    for kernel in ("triton", "xla"):
        loop = SmallStepLoop(mesh, nx, ny, nz, case.flags, n_steps=6,
                             kernel=kernel, smdiv=0.1,
                             interpret=kernel == "triton")
        arrays = loop.prepare(case_to_domain(case))
        got_dom = loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
        gold = small_step_golden(case, 6, smdiv=0.1)
        kw = case.kernel_kwargs()
        got = {}
        for name in ("ww", "mu", "t", "u", "v", "mudf"):
            like = (np.asarray(kw[name]) if name != "mudf"
                    else np.zeros_like(gold["mudf"]))
            got[name] = embed_domain(np.asarray(got_dom[name]), like,
                                     case.bounds)
        outputs_allclose(got, {k: gold[k] for k in got},
                         rtol=5e-5, atol_scale=2e-6)
    # damping actually does something
    undamped = small_step_golden(case, 6)
    assert np.abs(gold["u"] - undamped["u"]).max() > 1e-2


def test_native_uv_damping_bitwise(small_case):
    """Native damped wind substep is bit-identical to the numpy path."""
    from wrf_tpu.native import advance_uv_native
    case = small_case
    kw = case.kernel_kwargs()
    i0, i1, j0, j1, _, _ = case.bounds.loop_bounds(case.flags)
    rng = np.random.default_rng(5)
    mudf = (1e-1 * rng.standard_normal(np.asarray(kw["mu"]).shape)).astype(
        np.float32)
    args = dict(u=kw["u"], v=kw["v"], mu=kw["mu"], muu=kw["muu"],
                muv=kw["muv"], msfuy=kw["msfuy"], msfvx_inv=kw["msfvx_inv"],
                rdx=kw["rdx"], rdy=kw["rdy"], dts=kw["dts"])
    ug, vg = advance_uv_numpy(**args, window=(i0, i1, j0, j1),
                              mudf=mudf, smdiv=0.1)
    uc, vc = advance_uv_native(**args, cs2=25.0, mudf=mudf, smdiv=0.1,
                               flags=case.flags, bounds=case.bounds)
    assert (ug == uc).all() and (vg == vc).all()


@pytest.mark.full
def test_everything_on_50_steps(small_case):
    """Capstone: the full feature stack at once — 2-D mesh, the fused
    column kernel, divergence damping, the implicit w substep, 50 device-resident
    substeps — reassembles to the golden loop."""
    case = small_case
    mesh = make_mesh(jax.devices(), (4, 2))
    nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
    loop = SmallStepLoop(mesh, nx, ny, nz, case.flags, n_steps=50,
                         with_w=True, smdiv=0.1, kernel="triton",
                         interpret=True)
    arrays = loop.prepare(case_to_domain(case, with_w=True))
    got_dom = loop(arrays, case.rdx, case.rdy, case.dts, case.epssm)
    gold = small_step_golden(case, 50, with_w=True, smdiv=0.1)
    from wrf_tpu.parallel.sharded import embed_outputs
    outputs_allclose(embed_outputs(case, got_dom), gold,
                     rtol=1e-4, atol_scale=1e-5)


def test_fixture_amplitude_scaling():
    a1 = fixtures.make_case(12, 10, 6, halo=2, seed=3)
    a2 = fixtures.make_case(12, 10, 6, halo=2, seed=3, amplitude=0.5)
    import numpy as np
    u1 = np.asarray(a1.fields["grid_u_2"])
    u2 = np.asarray(a2.fields["grid_u_2"])
    np.testing.assert_allclose(u2, 0.5 * u1, rtol=1e-6)
    # non-dynamic fields untouched
    assert (np.asarray(a1.fields["grid_mut"])
            == np.asarray(a2.fields["grid_mut"])).all()


@pytest.mark.parametrize("shape,mesh_shape,with_w,want", [
    ((74, 61, 32), (1, 1), False, "xla"),       # small shard
    ((74, 61, 32), (1, 1), True, "triton"),     # the w solve
    ((512, 512, 50), (1, 1), False, "triton"),  # large shard
    ((512, 512, 50), (2, 2), False, "xla"),     # 4 shards of 258x258
])
def test_default_kernel_from_shape(shape, mesh_shape, with_w, want):
    """The loop picks the fused kernel where it was faster on the card —
    with the w solve, or on shards of at least TRITON_MIN_COLUMNS — and
    the XLA path otherwise.  Off a GPU a kernel pick is refused with a
    message that names the way out, never swapped for XLA."""
    from wrf_tpu.grid import ConfigFlags
    mesh = make_mesh(jax.devices()[: mesh_shape[0] * mesh_shape[1]],
                     mesh_shape)
    flags = ConfigFlags(specified=True)
    if want == "xla":
        assert SmallStepLoop(mesh, *shape, flags, with_w=with_w).kernel == want
    else:
        with pytest.raises(ValueError, match="needs a GPU.*kernel='xla'"):
            SmallStepLoop(mesh, *shape, flags, with_w=with_w)
        assert SmallStepLoop(mesh, *shape, flags, with_w=with_w,
                             kernel="xla").kernel == "xla"
