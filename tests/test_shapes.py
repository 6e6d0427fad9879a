"""Shape fuzzing: the substep across awkward grid geometries.

Mask-based windows, clamped neighbour reads and ragged column tiles must
hold for any domain shape, not just the friendly benchmark sizes — these
sweeps pin the edge cases of the XLA path and of the fused column kernel
(Pallas interpreter on CPU) against the golden path."""

import jax.numpy as jnp
import pytest

from tests.conftest import outputs_allclose
from wrf_tpu.grid import ConfigFlags
from wrf_tpu.io import fixtures
from wrf_tpu.ops.advance_mu_t_jnp import advance_mu_t_impl, window_masks
from wrf_tpu.ops.reference_numpy import advance_mu_t_numpy
from wrf_tpu.ops import substep_triton as kernel_module
from wrf_tpu.ops.substep_triton import substep_triton

FIELDS = ("ww", "t", "t_ave", "mu", "muave", "muts", "mudf")


@pytest.fixture(autouse=True)
def small_tiles(monkeypatch):
    """(2, 8) column tiles: several ragged tiles even on these small grids."""
    monkeypatch.setattr(kernel_module, "BLOCK", (2, 8))


def substep_vs_golden(case, impl):
    kw = case.kernel_kwargs()
    b = case.bounds
    _, _, _, _, k0, k1 = b.loop_bounds(case.flags)
    i_mask, j_mask = (jnp.asarray(m) for m in window_masks(b, case.flags))
    args = {k: (jnp.asarray(v, jnp.float32) if hasattr(v, "ndim") else v)
            for k, v in kw.items() if k not in ("flags", "bounds")}
    if impl == "xla":
        out = advance_mu_t_impl(**args, i_mask=i_mask, j_mask=j_mask,
                                k0=k0, k1=k1, kde=b.mem(b.kde, "k"))
    else:
        out = substep_triton(**args, i_mask=i_mask, j_mask=j_mask, k0=k0,
                             k1=k1, interpret=True)
    outputs_allclose(out, advance_mu_t_numpy(**kw), rtol=5e-5,
                     atol_scale=2e-6, fields=FIELDS)


@pytest.mark.parametrize("impl", ["xla", "triton"])
@pytest.mark.parametrize("shape,halo", [
    ((33, 17, 12), 1),   # odd extents, minimal halo
    ((13, 29, 7), 2),    # nx < ny, tiny K
    ((65, 9, 24), 3),    # few j rows vs large halo
    ((129, 11, 9), 2),   # wide i, shallow
])
def test_odd_shapes(shape, halo, impl):
    nx, ny, nz = shape
    case = fixtures.make_case(nx, ny, nz, halo=halo, seed=nx + ny)
    substep_vs_golden(case, impl)


@pytest.mark.parametrize("block", [(1, 8), (2, 16), (4, 4), (8, 32)])
def test_kernel_tile_sizes(small_case, block, monkeypatch):
    """Every column tile, including tiles larger than the domain and tiles
    that leave a ragged last row or lane block."""
    monkeypatch.setattr(kernel_module, "BLOCK", block)
    substep_vs_golden(small_case, "triton")


@pytest.mark.parametrize("impl", ["xla", "triton"])
def test_odd_shape_periodic(impl):
    case = fixtures.make_case(
        21, 15, 10, halo=2, seed=9,
        flags=ConfigFlags(periodic_x=True, specified=True),
    )
    substep_vs_golden(case, impl)
