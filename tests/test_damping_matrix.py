"""Divergence damping (WRF's namelist default smdiv=0.1) on the XLA loop:
three meshes under each lateral boundary condition, against the golden
loop."""

import pytest

from tests.conftest import loop_vs_golden


@pytest.mark.parametrize("bc_case", ["small_case", "periodic_case",
                                     "open_bc_case"])
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2), (4, 2)])
def test_damped_loop(request, mesh_shape, bc_case):
    loop_vs_golden(request.getfixturevalue(bc_case), mesh_shape, steps=6,
                   smdiv=0.1)
