"""Benchmark: acoustic substep time on one GPU, at the repository's shapes.

    python3 bench.py [--kernel triton|xla] [--rows NAME,...]

Each row times a device-resident loop (``ShardedAdvanceMuT`` for the mu/t
rows, ``SmallStepLoop`` for the coupled rows) on one card.  A row's time is
the marginal ``(T(n2) - T(n1)) / (n2 - n1)`` of two step counts, each call
ended by ``jax.block_until_ready`` and best of ``repeats``: the loop's
prologue (halo construction) and the dispatch cancel, compilation is
excluded by a warm-up call.

Prints one JSON record per row as it completes and a summary record last.
Every record names the device (JAX platform, ``device_kind``, count) and
the card's ``nvidia-smi`` name and power limit.  The run fails when JAX
finds no GPU, and exits non-zero when any row fails.

Baseline: the reference's published CUDA number — 74x61x32 grid in 0.051 ms
on 3x GTX-680 (reference README.md:16-24) = 2.833e9 grid-points/s for the
whole 3-GPU desktop.  ``vs_baseline`` is one card's grid-points/s over that.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import numpy as np

REFERENCE_GPS = 144448 / 51e-6  # 74*61*32 points / 0.051 ms

#: (name, nx, ny, nz, coupled, with_w, (n1, n2))
SPECS = [
    ("ref-grid 74x61x32 mu_t", 74, 61, 32, False, False, (200, 1000)),
    ("mu_t 512x512x50", 512, 512, 50, False, False, (20, 100)),
    ("coupled 512x512x50", 512, 512, 50, True, False, (20, 100)),
    ("coupled+w 512x512x50", 512, 512, 50, True, True, (20, 100)),
    ("coupled CONUS 1500x1500x50", 1500, 1500, 50, True, False, (5, 25)),
]


def build(mesh, case, steps: int, *, coupled: bool, with_w: bool,
          kernel: str | None = None, interpret: bool = False):
    """``(run, kernel)``: a callable that runs ``steps`` substeps and waits
    for the device, and the substep path it uses (``None``: the loop's
    default; ``interpret``: the Triton kernel in the Pallas interpreter,
    for tests on the CPU)."""
    from wrf_tpu.models.small_step import SmallStepLoop
    from wrf_tpu.parallel.sharded import ShardedAdvanceMuT, case_to_domain

    b = case.bounds
    dims = (b.ide, b.jde, b.kdim)
    kw = {"interpret": interpret, **({"kernel": kernel} if kernel else {})}
    if coupled:
        loop = SmallStepLoop(mesh, *dims, case.flags, n_steps=steps,
                             with_w=with_w, **kw)
        arrays = loop.prepare(case_to_domain(case, with_w=with_w))
    else:
        loop = ShardedAdvanceMuT(mesh, *dims, case.flags, n_steps=steps,
                                 vary_winds=True, **kw)
        arrays = loop.prepare(case_to_domain(case))
    scalars = (case.rdx, case.rdy, case.dts, case.epssm)

    def run():
        return jax.block_until_ready(loop(arrays, *scalars))

    return run, loop.kernel


def marginal(make_run, n1: int, n2: int, repeats: int = 5) -> float:
    """Per-substep seconds by the two-step-count difference."""
    times = {}
    for steps in (n1, n2):
        run = make_run(steps)
        out = run()  # compile + warm up
        if not all(np.isfinite(np.asarray(v)).all() for v in out.values()):
            raise FloatingPointError(f"non-finite state at steps={steps}")
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        times[steps] = best
    return (times[n2] - times[n1]) / (n2 - n1)


def nvidia_smi() -> str:
    """``name, power.limit`` of the card (a child process, off JAX)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60,
                       check=True)
    return r.stdout.strip()


def device_record(card: str) -> dict:
    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "nvidia_smi": card}


def bench_row(spec, mesh, kernel: str | None = None, repeats: int = 5,
              counts=None, dims=None, interpret: bool = False) -> dict:
    """Time one ``SPECS`` row; ``counts`` and ``dims`` override its step
    counts and grid (tests run the rows small on the CPU)."""
    from wrf_tpu.io import fixtures

    name, nx, ny, nz, coupled, with_w, (n1, n2) = spec
    n1, n2 = counts or (n1, n2)
    nx, ny, nz = dims or (nx, ny, nz)
    case = fixtures.make_case(nx, ny, nz, halo=3, seed=42)
    t0 = time.perf_counter()
    used = []

    def make_run(steps):
        run, used_kernel = build(mesh, case, steps, coupled=coupled,
                                 with_w=with_w, kernel=kernel,
                                 interpret=interpret)
        used.append(used_kernel)
        return run

    per = marginal(make_run, n1, n2, repeats)
    pts = nx * ny * nz
    return {"config": name, "kernel": used[0],
            "ms_per_substep": per * 1e3,
            "gpts_per_s": pts / per,
            "vs_baseline": pts / per / REFERENCE_GPS,
            "steps": [n1, n2], "t_s": time.perf_counter() - t0}


def run_rows(specs, mesh, kernel: str | None, device: dict, **row_kw):
    """Time every row, printing each record; a failed row is recorded
    with its error and named in the returned ``failed`` list."""
    records, failed = [], []
    for spec in specs:
        try:
            rec = bench_row(spec, mesh, kernel, **row_kw)
        except Exception as e:
            failed.append(spec[0])
            rec = {"config": spec[0], "error": f"{type(e).__name__}: {e}"}
        rec["device"] = device
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records, failed


def main(argv=None) -> int:
    from wrf_tpu.parallel.mesh import make_mesh
    from wrf_tpu.utils import compile_cache

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernel", default=None, choices=["triton", "xla"],
                   help="substep path for every row (default: each loop's "
                        "own choice)")
    p.add_argument("--rows", default=None,
                   help="comma-separated row names (default: all)")
    args = p.parse_args(argv)

    if jax.devices()[0].platform != "gpu":
        print(f"bench: no GPU (JAX platform {jax.devices()[0].platform!r})",
              file=sys.stderr)
        return 2
    compile_cache.enable()
    device = device_record(nvidia_smi())
    specs = [s for s in SPECS
             if args.rows is None or s[0] in args.rows.split(",")]
    mesh = make_mesh(jax.devices()[:1], (1, 1))
    records, failed = run_rows(specs, mesh, args.kernel, device)
    print(json.dumps({
        "metric": "acoustic substep ms (one card, device-resident loop)",
        "device": device,
        "rows": [[r["config"], r.get("ms_per_substep")] for r in records],
        "failed": failed,
    }), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
