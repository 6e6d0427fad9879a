"""One RK3 large step on the XLA path against the golden RK3 step: three
meshes, with and without the implicit w substep, over three acoustic
substep counts (stages of 1, ns/2 and ns substeps)."""

import jax
import pytest

from tests.conftest import outputs_allclose
from wrf_tpu.models.rk3 import RK3Integrator, rk3_golden
from wrf_tpu.parallel.mesh import make_mesh
from wrf_tpu.parallel.sharded import case_to_domain, embed_outputs


@pytest.mark.parametrize("acoustic_steps", [2, 4, 6])
@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (4, 2)])
def test_rk3_step(small_case, mesh_shape, with_w, acoustic_steps):
    case = small_case
    b = case.bounds
    mesh = make_mesh(jax.devices()[: mesh_shape[0] * mesh_shape[1]],
                     mesh_shape)
    rk3 = RK3Integrator(mesh, b.ide, b.jde, b.kdim, case.flags,
                        acoustic_steps=acoustic_steps, kernel="xla",
                        with_w=with_w)
    dt = case.dts * acoustic_steps
    out = rk3.step(rk3.prepare(case_to_domain(case, with_w=with_w)),
                   case.rdx, case.rdy, dt, case.epssm)
    gold = rk3_golden(case, acoustic_steps=acoustic_steps, dt=dt,
                      with_w=with_w)
    outputs_allclose(embed_outputs(case, jax.device_get(out)), gold,
                     rtol=5e-5, atol_scale=2e-6)
