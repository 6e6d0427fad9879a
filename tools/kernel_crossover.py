"""Where the fused column kernel overtakes the XLA path on the coupled loop
without the w solve: ms per substep of both on one GPU, at square grids.

    python3 tools/kernel_crossover.py [--sizes 256,320,384,448] [--nz 50]
                                      [--runs 5]

Both loops are built and compiled once per size, then timed in ``runs``
alternating turns each (xla, triton, then triton, xla, ...).  A turn is
the marginal of two step counts as in ``bench.py``, each count best of
three calls ended by ``jax.block_until_ready``.  Prints one JSON record
per size with every turn and the medians, and the card's ``nvidia-smi``
name and power limit; ``small_step.TRITON_MIN_COLUMNS`` is read off these
records.  Exits non-zero without a GPU.
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import bench  # noqa: E402
from wrf_tpu.io import fixtures  # noqa: E402
from wrf_tpu.parallel.mesh import make_mesh  # noqa: E402

COUNTS = (20, 100)


def turn(runs: dict) -> float:
    """Marginal ms per substep of one kernel's two pre-built loops."""
    best = {}
    for n, run in runs.items():
        best[n] = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            best[n] = min(best[n], time.perf_counter() - t0)
    n1, n2 = COUNTS
    return (best[n2] - best[n1]) / (n2 - n1) * 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", default="256,320,384,448")
    p.add_argument("--nz", type=int, default=50)
    p.add_argument("--runs", type=int, default=5)
    args = p.parse_args(argv)

    if jax.devices()[0].platform != "gpu":
        print("kernel_crossover: no GPU", file=sys.stderr)
        return 2
    card = bench.nvidia_smi()
    mesh = make_mesh(jax.devices()[:1], (1, 1))
    for n in (int(s) for s in args.sizes.split(",")):
        case = fixtures.make_case(n, n, args.nz, halo=3, seed=42)
        runs = {k: {c: bench.build(mesh, case, c, coupled=True, with_w=False,
                                   kernel=k)[0] for c in COUNTS}
                for k in ("xla", "triton")}
        for by_count in runs.values():
            for run in by_count.values():
                run()  # compile + warm up
        turns = {"xla": [], "triton": []}
        for r in range(args.runs):
            for k in (("xla", "triton") if r % 2 == 0 else ("triton", "xla")):
                turns[k].append(turn(runs[k]))
        print(json.dumps({
            "grid": [n, n, args.nz], "loop": "coupled, no w",
            "median_ms": {k: statistics.median(v) for k, v in turns.items()},
            "turns_ms": turns, "nvidia_smi": card}), flush=True)
        del runs
    return 0


if __name__ == "__main__":
    sys.exit(main())
