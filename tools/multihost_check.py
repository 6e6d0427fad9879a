"""TRUE multi-process validation of the multi-host bring-up helpers.

The multi-host recipe (`parallel/distributed.py`) runs here for real:
TWO OS processes, each owning 4 virtual CPU devices, joined through
`jax.distributed.initialize` (XLA's Gloo CPU collectives), building the
global (2, 4) mesh and assembling per-process j-slabs with
`host_local_arrays`.  The mu_t scan loop (xla kernel, 4 substeps with
in-scan ppermute halo refresh), the coupled small-step loop (xla kernel,
3 substeps) and one closed-loop RK3 large step (base-state
snapshot + nudging tendencies) then run UNCHANGED across the process
boundary.

Acceptance is BIT-equality against the identical program run
single-process on the same (2, 4) mesh over the same 8 devices — only
process placement differs, so any divergence is a distributed-runtime
bug, not tolerance noise.

Usage: python tools/multihost_check.py            # 2 procs x 4 devices
       python tools/multihost_check.py --nproc 4  # 4 procs x 2 devices:
           a TRUE 2-D process grid — the (2, 4) mesh's j rows each span
           two processes, so the i-axis halo exchange ALSO crosses a
           process boundary and per-process blocks are 2-D (extracted via
           distributed.process_local_block), not j-slabs
       (internal: ... ref OUT.npz | worker PID NPROC OUT.npz)

The same-box Gloo transport stands in for the network between hosts —
what it validates is the recipe and the SPMD program, not wire
performance.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NPROC = 2          # overridden by --nproc / the worker argv
TOTAL_DEVICES = 8  # fixed (2, 4) mesh; DEV_PER_PROC = 8 // NPROC


def _setup_jax(dev_per_proc):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={dev_per_proc}"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _compute(jax, mesh, *, multihost: bool):
    """Both loops on ``mesh``; returns {name: np.ndarray} (globally
    gathered when ``multihost``)."""
    import numpy as np

    from wrf_tpu.io import fixtures
    from wrf_tpu.models.small_step import SmallStepLoop
    from wrf_tpu.parallel import distributed
    from wrf_tpu.parallel.sharded import (
        ShardedAdvanceMuT, case_to_domain, pad_to_mesh,
    )

    def assemble(loop, dom):
        """Per-process local blocks -> global arrays (the multi-host
        path), or the single-process prepare().  Blocks are extracted via
        the sharding's own device->index map (process_local_block), so
        the SAME code serves 1-D j-slab process layouts and 2-D process
        grids (--nproc 4)."""
        if not multihost:
            return loop.prepare(dom)
        blocks = {}
        gshapes = {}
        n_sharded = 0
        for name, arr in dom.items():
            padded = np.asarray(pad_to_mesh(arr, mesh))
            sh = loop.shardings[name]
            if not sh.spec:            # replicated: full vector everywhere
                blocks[name] = padded
                continue
            blocks[name] = padded[
                distributed.process_local_block(sh, padded.shape)]
            gshapes[name] = padded.shape
            n_sharded += 1
        assert n_sharded, "no sharded fields?"
        return distributed.host_local_arrays(mesh, blocks, loop.shardings,
                                             global_shapes=gshapes)

    def record(tag, out, names=("t", "mu", "ww")):
        for name in names:
            val = out[name]
            if multihost:
                from jax.experimental import multihost_utils
                val = multihost_utils.process_allgather(val, tiled=True)
            results[f"{tag}/{name}"] = np.asarray(val)

    results = {}
    for tag, coupled, dims, steps in (("mu_t", False, (40, 36, 12), 4),
                                      ("coupled", True, (24, 20, 8), 3)):
        nx, ny, nz = dims
        case = fixtures.make_case(nx, ny, nz, halo=3, seed=7)
        if coupled:
            loop = SmallStepLoop(mesh, nx, ny, nz, case.flags,
                                 n_steps=steps, kernel="xla")
        else:
            loop = ShardedAdvanceMuT(mesh, nx, ny, nz, case.flags,
                                     n_steps=steps, kernel="xla",
                                     vary_winds=True)
        out = loop(assemble(loop, case_to_domain(case)),
                   case.rdx, case.rdy, case.dts, case.epssm)
        record(tag, out)

    # the production shell unchanged: one closed-loop RK3 large step
    # (base-state snapshot + nudging tendencies) across the processes
    from wrf_tpu.models.rk3 import RK3Integrator
    from wrf_tpu.models.tendencies import NudgingTendencies

    case = fixtures.make_case(24, 20, 8, halo=3, seed=9, amplitude=1e-2,
                              balanced=True)
    rk3 = RK3Integrator(mesh, 24, 20, 8, case.flags, acoustic_steps=2,
                        kernel="xla", snapshot="base")
    arrays = assemble(rk3.loops[0], case_to_domain(case))
    dt = case.dts * 2
    out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm,
                   tendency_fn=NudgingTendencies(arrays, dt,
                                                 tau_steps=5.0))
    record("rk3", out, names=("t", "mu"))
    return results


def _mesh_2x4(jax):
    from wrf_tpu.parallel.mesh import make_mesh

    return make_mesh(jax.devices()[:8], (2, 4))


def main_ref(out_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    jax = _setup_jax(TOTAL_DEVICES)
    import numpy as np

    np.savez(out_path, **_compute(jax, _mesh_2x4(jax), multihost=False))
    print("ref done", flush=True)


def main_worker(pid, nproc, out_path):
    jax = _setup_jax(TOTAL_DEVICES // nproc)
    # per-layout port so a lingering coordinator from the other variant
    # (CI runs both) can never be joined by mistake
    coord = f"localhost:{9915 + nproc}"
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=nproc, process_id=pid)
    assert len(jax.devices()) == TOTAL_DEVICES
    import numpy as np

    res = _compute(jax, _mesh_2x4(jax), multihost=True)
    if pid == 0:
        np.savez(out_path, **res)
    print(f"worker {pid} done", flush=True)


def main(nproc=NPROC):
    import numpy as np

    here = os.path.abspath(__file__)
    tmp = f"/tmp/wrf_tpu_multihost_{nproc}p"
    os.makedirs(tmp, exist_ok=True)
    ref_npz, mh_npz = f"{tmp}/ref.npz", f"{tmp}/mh.npz"
    subprocess.run([sys.executable, here, "ref", ref_npz], check=True)
    procs = [subprocess.Popen([sys.executable, here, "worker", str(i),
                               str(nproc), mh_npz]) for i in range(nproc)]
    for p in procs:
        assert p.wait(timeout=1200) == 0, "worker failed"
    ref, mh = np.load(ref_npz), np.load(mh_npz)
    for name in ref.files:
        np.testing.assert_array_equal(mh[name], ref[name], err_msg=name)
        print(f"OK   {name}: {nproc}-process == single-process (bit-equal, "
              f"{ref[name].shape})", flush=True)
    print(f"MULTIHOST OK ({nproc} processes)")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "ref":
        main_ref(sys.argv[2])
    elif len(sys.argv) > 1 and sys.argv[1] == "worker":
        main_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif len(sys.argv) > 2 and sys.argv[1] == "--nproc":
        main(int(sys.argv[2]))
    else:
        main()
