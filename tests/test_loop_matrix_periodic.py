"""The XLA acoustic loop against the golden loop on every mesh shape, with
and without the implicit w substep, under periodic-x boundaries (the window reaches the i-edge ring cells)."""

import pytest

from tests.conftest import MESHES, loop_vs_golden


@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_loop_periodic(request, mesh_shape, with_w):
    case = request.getfixturevalue("periodic_case")
    loop_vs_golden(case, mesh_shape, with_w=with_w)
