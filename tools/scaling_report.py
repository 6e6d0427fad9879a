"""Scaling report: inspect the compiled SPMD program across mesh shapes.

Compiles the coupled acoustic loop for several virtual mesh shapes and
reports, per substep, the collective operations XLA actually emitted
(collective-permutes and their byte volumes) — the communication side of
the weak-scaling story, checkable without several GPUs.  Run on the CPU
backend:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tools/scaling_report.py [nx ny nz steps]
"""

import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

from wrf_tpu.io import fixtures  # noqa: E402
from wrf_tpu.models.small_step import SmallStepLoop  # noqa: E402
from wrf_tpu.parallel.mesh import make_mesh  # noqa: E402
from wrf_tpu.parallel.sharded import case_to_domain  # noqa: E402


def analyze(case, mesh_shape, steps, with_w=False):
    n_dev = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(jax.devices()[:n_dev], mesh_shape)
    nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
    loop = SmallStepLoop(mesh, nx, ny, nz, case.flags, n_steps=steps,
                         kernel="xla", with_w=with_w)
    arrays = loop.prepare(case_to_domain(case, with_w=with_w))
    hlo = loop.lower(arrays, case.rdx, case.rdy, case.dts,
                     case.epssm).compile().as_text()

    # collective-permutes inside vs outside the while (scan) body
    # body detection keys on COMPUTATION DEFINITION lines (ending in
    # "{"), never on call sites mentioning the body's name — XLA names
    # the scan body "wide.*region_N" today, "%while_body.N" under other
    # naming schemes, and an ENTRY line "while(..., body=%while_body)"
    # must not flip the flag
    in_loop, setup, bytes_in_loop = 0, 0, 0
    in_body = False
    for line in hlo.splitlines():
        if line.rstrip().endswith("{") and (
                re.match(r"\s*%?wide.*region", line)
                or re.match(r"\s*%?while_body", line)):
            in_body = True
        if line.startswith("}"):
            in_body = False
        m = re.search(r"collective-permute[^(]*\(", line)
        if not m:
            continue
        shape = re.search(r"= (?:\()?f32\[([0-9,]*)\]", line)
        nel = 1
        if shape and shape.group(1):
            for d in shape.group(1).split(","):
                nel *= int(d)
        if in_body:
            in_loop += 1
            bytes_in_loop += 4 * nel
        else:
            setup += 1
    return dict(mesh=mesh_shape, collectives_per_substep=in_loop,
                halo_bytes_per_substep=bytes_in_loop, setup_collectives=setup)


def main():
    args = [int(a) for a in sys.argv[1:5]]
    nx, ny, nz, steps = args + [64, 64, 16, 4][len(args):]
    case = fixtures.make_case(nx, ny, nz, halo=2, seed=5)
    print(f"domain {nx}x{ny}x{nz}, {steps} substeps per compile")
    for shape in ((1, 1), (2, 2), (4, 2), (8, 1)):
        r = analyze(case, shape, steps)
        per_shard = (f"{r['halo_bytes_per_substep'] / 1024:.1f} KiB"
                     if r["halo_bytes_per_substep"] else "0")
        print(f"  mesh {shape}: {r['collectives_per_substep']} in-scan "
              f"collective-permutes/substep moving {per_shard}/shard, "
              f"{r['setup_collectives']} one-time setup collectives")
    print("(volumes are per shard per substep and independent of mesh "
          "size)")


if __name__ == "__main__":
    main()
