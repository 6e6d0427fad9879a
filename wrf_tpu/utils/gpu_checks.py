"""Checks that need the GPU: the fused column kernel compiled for the card.

The ``gpu``-marked tests call these functions, and ``chip_smoke.py`` runs
the same functions in process.  Each raises ``AssertionError`` on failure
and returns the worst scaled error it saw (1.0 is the tolerance edge).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..compare import compare

#: device-tier tolerance (compare.assert_outputs_allclose defaults)
RTOL, ATOL_SCALE = 2e-5, 1e-6


def worst_scaled(got: dict, want: dict, names=None, rtol=RTOL,
                 atol_scale=ATOL_SCALE) -> tuple[float, str]:
    """(worst scaled error, field) over ``names`` (default: shared keys)."""
    worst = (0.0, "")
    for n in names or sorted(got.keys() & want.keys()):
        r = compare(np.asarray(got[n]), np.asarray(want[n]), n, rtol=rtol,
                    atol_scale=atol_scale)
        worst = max(worst, (float(r.max_scaled_err), n))
    return worst


def kernel_matches_xla(nx: int = 40, ny: int = 36, nz: int = 16,
                       with_w: bool = True) -> float:
    """One compiled fused-kernel substep against the XLA path on a single
    tile at a small shape with ragged tile edges."""
    from ..io import fixtures
    from ..ops.advance_mu_t_jnp import advance_mu_t_impl, window_masks
    from ..ops.advance_w import advance_w_jnp
    from ..ops.substep_triton import substep_triton

    assert jax.devices()[0].platform == "gpu", "needs a GPU"
    case = fixtures.make_case(nx, ny, nz, halo=3, seed=5)
    kw = case.kernel_kwargs()
    b = case.bounds
    i0, i1, j0, j1, k0, k1 = b.loop_bounds(case.flags)
    i_mask, j_mask = (jnp.asarray(m) for m in window_masks(b, case.flags))
    arr = {k: jnp.asarray(v, jnp.float32) for k, v in kw.items()
           if hasattr(v, "ndim")}
    sc = {k: kw[k] for k in ("rdx", "rdy", "dts", "epssm")}
    f = case.fields
    wkw = ({"w": jnp.asarray(f["grid_w"]), "pp": jnp.asarray(f["grid_pp"]),
            "rdn": jnp.asarray(f["grid_rdn"])} if with_w else {})

    @jax.jit
    def xla(arr, wkw):
        out = advance_mu_t_impl(**arr, **sc, i_mask=i_mask, j_mask=j_mask,
                                k0=k0, k1=k1, kde=b.mem(b.kde, "k"))
        if wkw:
            out["w"], out["pp"] = advance_w_jnp(
                **wkw, t=out["t"], rdnw=arr["rdnw"], dts=sc["dts"],
                epssm=sc["epssm"], window=(i0, i1, j0, j1), k0=k0, k1=k1)
        return out

    @jax.jit
    def fused(arr, wkw):
        return substep_triton(**arr, **sc, **wkw, i_mask=i_mask,
                              j_mask=j_mask, k0=k0, k1=k1)

    want = jax.device_get(xla(arr, wkw))
    got = jax.device_get(fused(arr, wkw))
    err, name = worst_scaled(got, want)
    assert err <= 1.0, f"fused kernel vs XLA: {name} scaled error {err:.3f}"
    return err


def loop_matches_golden(kernel: str, nx: int = 40, ny: int = 36,
                        nz: int = 16, steps: int = 5) -> float:
    """The coupled+w loop (smdiv 0.1) on one device against the numpy
    golden loop."""
    from ..io import fixtures
    from ..models.small_step import SmallStepLoop, small_step_golden
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import case_to_domain, embed_outputs

    assert jax.devices()[0].platform == "gpu", "needs a GPU"
    case = fixtures.make_case(nx, ny, nz, halo=3, seed=6)
    b = case.bounds
    loop = SmallStepLoop(make_mesh(jax.devices()[:1], (1, 1)), b.ide, b.jde,
                         b.kdim, case.flags, n_steps=steps, kernel=kernel,
                         with_w=True, smdiv=0.1)
    out = loop(loop.prepare(case_to_domain(case, with_w=True)),
               case.rdx, case.rdy, case.dts, case.epssm)
    got = embed_outputs(case, jax.device_get(out))
    want = small_step_golden(case, steps, with_w=True, smdiv=0.1)
    err, name = worst_scaled(got, want)
    assert err <= 1.0, f"{kernel} loop vs golden: {name} scaled error {err:.3f}"
    return err


#: every check, by name (chip_smoke.py phase 6 runs them all)
CHECKS = {
    "kernel_matches_xla": lambda: kernel_matches_xla(),
    "kernel_matches_xla_no_w": lambda: kernel_matches_xla(with_w=False),
    "xla_loop_matches_golden": lambda: loop_matches_golden("xla"),
    "triton_loop_matches_golden": lambda: loop_matches_golden("triton"),
}
