"""L3 parallel tests: shard_map 2-D decomposition on a virtual 8-device mesh.

Pattern copied from the reference's validation of its 3-GPU decomposition:
the reassembled global result of the N-device run must match the single-tile
scalar oracle on the same host (SURVEY.md §4 'Multi-device without a
cluster')."""

import jax
import numpy as np
import pytest

from tests.conftest import outputs_allclose
from wrf_tpu.grid import ConfigFlags
from wrf_tpu.io import fixtures
from wrf_tpu.native import advance_mu_t_native
from wrf_tpu.parallel.mesh import factor_near_square, make_mesh
from wrf_tpu.parallel.sharded import (
    ShardedAdvanceMuT, case_to_domain, embed_domain,
)


def run_native_steps(case, steps):
    kw = case.kernel_kwargs()
    state = {k: kw[k] for k in ("ww", "mu", "t", "t_ave")}
    out = dict(state)
    for _ in range(steps):
        out = advance_mu_t_native(**{**kw, **state})
        state = {k: out[k] for k in ("ww", "mu", "t", "t_ave")}
    return out


def sharded_vs_oracle(case, mesh_shape, steps=1, kernel="xla", **tol):
    mesh = make_mesh(jax.devices()[: mesh_shape[0] * mesh_shape[1]], mesh_shape)
    nx, ny = case.bounds.ide, case.bounds.jde
    nz = case.bounds.kdim
    step = ShardedAdvanceMuT(mesh, nx, ny, nz, case.flags, n_steps=steps,
                             kernel=kernel, interpret=kernel == "triton")
    dom = case_to_domain(case)
    arrays = step.prepare(dom)
    got_dom = step(arrays, case.rdx, case.rdy, case.dts, case.epssm)

    gold = run_native_steps(case, steps)
    got = {}
    for name, val in got_dom.items():
        like = case.kernel_kwargs()[name] if name in ("ww", "mu", "t", "t_ave") \
            else np.zeros_like(gold[name])
        got[name] = embed_domain(np.asarray(val), like, case.bounds)
    outputs_allclose(got, gold, **tol)


def test_mesh_factorization():
    assert factor_near_square(8) == (4, 2)
    assert factor_near_square(6) == (3, 2)
    assert factor_near_square(7) == (7, 1)
    assert factor_near_square(16) == (4, 4)


KERNELS = ["xla", "triton"]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4), (8, 1), (1, 8), (2, 2)])
def test_sharded_matches_oracle(small_case, mesh_shape, kernel):
    """2-D (j,i) decomposition reassembles to the scalar oracle's result."""
    sharded_vs_oracle(small_case, mesh_shape, steps=1, kernel=kernel)


@pytest.mark.parametrize("kernel", KERNELS)
def test_sharded_periodic(periodic_case, kernel):
    sharded_vs_oracle(periodic_case, (2, 4), steps=1, kernel=kernel)


@pytest.mark.parametrize("kernel", KERNELS)
def test_sharded_open_bc(open_bc_case, kernel):
    sharded_vs_oracle(open_bc_case, (4, 2), steps=1, kernel=kernel)


@pytest.mark.parametrize("kernel", KERNELS)
def test_sharded_multi_step_scan(small_case, kernel):
    """Device-resident 10-step scan matches 10 oracle iterations."""
    sharded_vs_oracle(small_case, (4, 2), steps=10, kernel=kernel,
                      rtol=5e-5, atol_scale=2e-6)


@pytest.mark.parametrize("kernel", KERNELS)
def test_sharded_indivisible_domain(kernel):
    """Domain not divisible by the mesh: zero-padding + masks handle it."""
    case = fixtures.make_case(19, 13, 6, halo=2, seed=21)
    sharded_vs_oracle(case, (4, 2), steps=1, kernel=kernel)


def test_sharded_reference_size(reference_size_case):
    """74x61x32 on 8 virtual devices (BASELINE configs[3] pattern)."""
    sharded_vs_oracle(reference_size_case, (4, 2), steps=1)


def test_sharded_single_device_triton(small_case):
    """mesh (1,1) — the one-card bench path."""
    sharded_vs_oracle(small_case, (1, 1), steps=3, kernel="triton")


def test_distributed_helpers(small_case):
    """Single-process degenerate path of the multi-host bring-up helpers:
    global mesh over all devices, per-host slabs assemble to the same
    global arrays prepare() would build."""
    import numpy as np
    from wrf_tpu.parallel import distributed
    from wrf_tpu.parallel.sharded import ShardedAdvanceMuT, case_to_domain

    distributed.initialize()
    mesh = distributed.global_mesh()
    assert set(mesh.shape) == {"j", "i"}

    case = small_case
    nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
    step = ShardedAdvanceMuT(mesh, nx, ny, nz, case.flags, n_steps=2,
                             kernel="xla")
    dom = case_to_domain(case)
    ref = step.prepare(dom)

    from wrf_tpu.parallel.sharded import pad_to_mesh
    slabs = {n: np.asarray(pad_to_mesh(a, mesh)) for n, a in dom.items()}
    built = distributed.host_local_arrays(mesh, slabs, step.shardings)
    for name in built:
        np.testing.assert_array_equal(np.asarray(built[name]),
                                      np.asarray(ref[name]), err_msg=name)
    out = step(built, case.rdx, case.rdy, case.dts, case.epssm)
    assert np.isfinite(np.asarray(out["t"])).all()


@pytest.mark.full
def test_multihost_two_process():
    """TRUE multi-process run of the multi-host bring-up recipe: two OS
    processes (Gloo CPU collectives, 4 devices each) must reproduce the
    single-process (2,4)-mesh result BIT-exactly for both production
    loops (tools/multihost_check.py does the orchestration)."""
    import subprocess
    import sys as _sys
    from pathlib import Path

    tool = Path(__file__).resolve().parents[1] / "tools" / "multihost_check.py"
    r = subprocess.run([_sys.executable, str(tool)], capture_output=True,
                       text=True, timeout=1100,
                       env={k: v for k, v in __import__("os").environ.items()
                            if k not in ("XLA_FLAGS", "JAX_PLATFORMS")})
    assert r.returncode == 0 and "MULTIHOST OK" in r.stdout, (
        r.stdout[-2000:] + r.stderr[-2000:])


@pytest.mark.full
def test_multihost_four_process_2d_grid():
    """4 OS processes x 2 devices on the (2, 4) mesh — a TRUE 2-D process
    grid: every j row of the mesh spans two processes, so the i-axis halo
    exchange also crosses process boundaries and the per-process blocks
    are 2-D (distributed.process_local_block), not j-slabs.  Must be
    BIT-equal to the single-process run (tools/multihost_check.py)."""
    import subprocess
    import sys as _sys
    from pathlib import Path

    tool = Path(__file__).resolve().parents[1] / "tools" / "multihost_check.py"
    r = subprocess.run([_sys.executable, str(tool), "--nproc", "4"],
                       capture_output=True, text=True, timeout=1100,
                       env={k: v for k, v in __import__("os").environ.items()
                            if k not in ("XLA_FLAGS", "JAX_PLATFORMS")})
    assert r.returncode == 0 and "MULTIHOST OK (4 processes)" in r.stdout, (
        r.stdout[-2000:] + r.stderr[-2000:])
