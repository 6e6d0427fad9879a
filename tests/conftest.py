"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding correctness is proven on host-platform virtual devices (the same
XLA SPMD partitioner as on GPUs), mirroring the reference's pattern of
validating its 3-GPU decomposition on a single host against the scalar
oracle (SURVEY.md §4).  ``JAX_PLATFORMS`` defaults to ``cpu``; a value that
is already set is kept, so the ``gpu``-marked tests run on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# Persistent XLA compilation cache: the quick tier's dominant cost is CPU
# compilation of the 8-device SPMD programs, identical run over run; keys
# include the HLO hash, so source changes invalidate automatically.
from wrf_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()

import pytest  # noqa: E402

from wrf_tpu.grid import ConfigFlags  # noqa: E402
from wrf_tpu.io import fixtures  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/")


@pytest.fixture(scope="session")
def small_case():
    """Small deterministic case used across tiers (fast: 20×18×8)."""
    return fixtures.make_case(20, 18, 8, halo=2, seed=7)


@pytest.fixture(scope="session")
def reference_size_case():
    """The reference fixture grid: 74×61×32 (BASELINE.md)."""
    return fixtures.make_case(74, 61, 32, halo=3, seed=2026)


@pytest.fixture(scope="session")
def periodic_case():
    return fixtures.make_case(
        20, 18, 8, halo=2, seed=11,
        flags=ConfigFlags(periodic_x=True, specified=True),
    )


@pytest.fixture(scope="session")
def open_bc_case():
    """No BC shrink at all (not specified/nested)."""
    return fixtures.make_case(
        20, 18, 8, halo=2, seed=13,
        flags=ConfigFlags(periodic_x=False, specified=False, nested=False),
    )


def outputs_allclose(a: dict, b: dict, rtol=2e-5, atol_scale=1e-6, fields=None):
    """Assert two output dicts agree within fp32 tolerances — delegates to
    the framework's shared element-wise acceptance function, so the test
    suite and the CLI driver gate on the same formula."""
    from wrf_tpu.compare import assert_outputs_allclose

    assert_outputs_allclose(a, b, rtol=rtol, atol_scale=atol_scale,
                            fields=fields)


#: every mesh shape the decomposition matrices run on (8 virtual devices)
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4), (4, 2), (2, 4),
          (8, 1), (1, 8)]


def loop_vs_golden(case, mesh_shape, steps=5, *, kernel="xla",
                   with_w=False, smdiv=0.0, rtol=5e-5, atol_scale=2e-6):
    """Run SmallStepLoop on a ``mesh_shape`` mesh and assert it reassembles
    to the numpy golden loop (``kernel="triton"`` runs interpreted)."""
    from wrf_tpu.models.small_step import SmallStepLoop, small_step_golden
    from wrf_tpu.parallel.mesh import make_mesh
    from wrf_tpu.parallel.sharded import case_to_domain, embed_outputs

    mesh = make_mesh(jax.devices()[: mesh_shape[0] * mesh_shape[1]],
                     mesh_shape)
    b = case.bounds
    loop = SmallStepLoop(mesh, b.ide, b.jde, b.kdim, case.flags,
                         n_steps=steps, kernel=kernel, with_w=with_w,
                         smdiv=smdiv, interpret=kernel == "triton")
    out = loop(loop.prepare(case_to_domain(case, with_w=with_w)),
               case.rdx, case.rdy, case.dts, case.epssm)
    gold = small_step_golden(case, steps, with_w=with_w, smdiv=smdiv)
    outputs_allclose(embed_outputs(case, jax.device_get(out)), gold,
                     rtol=rtol, atol_scale=atol_scale)
