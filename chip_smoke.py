#!/usr/bin/env python3
"""Smoke run of the main path on one NVIDIA GPU, in one process.

    python3 chip_smoke.py            # phases 1-6 on one card
    python3 chip_smoke.py --four     # the four-card mesh phase only

Phases (any failure ends the run with a non-zero exit code):

1. device: a GPU must be present; prints the card, JAX, XLA_FLAGS, the
   compile cache and ``nvidia-smi``'s name and power limit;
2. golden gate at the reference grid 74x61x32: 100 coupled+w substeps
   (smdiv 0.1) against the numpy golden loop, and the verification
   driver's ``xla`` tier on a minted fixture;
3. main path at 512x512x50: ``run_sim`` for 10 RK3 large steps (``--with-w
   --closure nudge --steps-per-sync 10``), then 5 coupled+w substeps
   against the golden loop;
4. CONUS scale 1500x1500x50, built in memory: the coupled loop and 2 RK3
   large steps, its memory analysis, and one substep against the golden
   loop;
5. the fused column kernel against the golden loop and the XLA path at
   the three widths, with both timed;
6. the checks the ``gpu``-marked tests run.

Timings printed here are smoke readings, not benchmark records.  The last
line is the contract record ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import jax
import numpy as np

from wrf_tpu.compare import compare
from wrf_tpu.io import checkpoint, fixtures
from wrf_tpu.models.rk3 import RK3Integrator
from wrf_tpu.models.small_step import SmallStepLoop, small_step_golden
from wrf_tpu.ops.reference_numpy import advance_mu_t_numpy
from wrf_tpu.parallel.mesh import make_mesh
from wrf_tpu.parallel.sharded import case_to_domain, embed_outputs
from wrf_tpu.utils import compile_cache, gpu_checks

#: device-tier tolerance (compare.assert_outputs_allclose defaults)
RTOL, ATOL_SCALE = gpu_checks.RTOL, gpu_checks.ATOL_SCALE
#: the 100-substep gate: three times the device tier.  float32 rounding
#: compounds over the substeps: after 100 coupled+w substeps at 74x61x32
#: the numpy golden loop itself sits 1.56 device-tier floors (mudf; w 1.31)
#: from the same loop in float64, so two correct float32 loops can sit up
#: to 3.1 floors apart
LONG_RTOL, LONG_ATOL_SCALE = 3 * RTOL, 3 * ATOL_SCALE


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    """``name, power.limit`` of the card, read by a child that stays off
    JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def check_fields(phase: str, got: dict, want: dict, names=None,
                 rtol=RTOL, atol_scale=ATOL_SCALE, gate: bool = True) -> float:
    """Compare every field, print its worst scaled error and its scale
    (the absolute floor is ``atol_scale * max(1, max|want|)``), and
    (``gate``) fail past 1."""
    worst = 0.0
    bad = []
    for n in names or sorted(got.keys() & want.keys()):
        want_n = np.asarray(want[n])
        r = compare(np.asarray(got[n]), want_n, n, rtol=rtol,
                    atol_scale=atol_scale)
        worst = max(worst, r.max_scaled_err)
        log(phase, f"  {n:>6}: scaled_err={r.max_scaled_err:.4f} "
                   f"max_abs={r.max_abs_err:.3e} "
                   f"scale={max(1.0, float(np.abs(want_n).max())):.3e}")
        if not r.passed:
            bad.append(n)
    if bad and gate:
        raise AssertionError(f"{phase}: outside tolerance: {bad}")
    return worst


def ms_per_substep(loop, arrays, case, n_steps: int, reps: int = 3) -> float:
    """Best wall time of ``reps`` device-resident loop calls, each ended by
    ``block_until_ready``, over the substeps per call (warm-up excluded)."""
    sc = (case.rdx, case.rdy, case.dts, case.epssm)
    jax.block_until_ready(loop(arrays, *sc))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(arrays, *sc))
        best = min(best, time.perf_counter() - t0)
    return best / n_steps * 1e3


def one_card():
    return make_mesh(jax.devices()[:1], (1, 1))


def dims(case):
    b = case.bounds
    return b.ide, b.jde, b.kdim


def loop_vs_golden(phase, case, steps, *, kernel="triton", with_w=True,
                   smdiv=0.1, mesh=None, **tol):
    loop = SmallStepLoop(mesh or one_card(), *dims(case), case.flags,
                         n_steps=steps, kernel=kernel, with_w=with_w,
                         smdiv=smdiv)
    out = loop(loop.prepare(case_to_domain(case, with_w=with_w)),
               case.rdx, case.rdy, case.dts, case.epssm)
    got = embed_outputs(case, jax.device_get(out))
    want = small_step_golden(case, steps, with_w=with_w, smdiv=smdiv)
    if tol:
        log(phase, f"{kernel}, {steps} substeps; device tier:")
        check_fields(phase, got, want, gate=False)
        log(phase, f"gate at rtol={tol['rtol']:.0e} "
                   f"atol_scale={tol['atol_scale']:.0e}:")
    return check_fields(phase, got, want, **tol)


# ---------------------------------------------------------------------- #
def phase_device() -> dict:
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform {d.platform!r})")
    log("1", f"device_kind={d.device_kind} count={len(devs)} "
             f"jax={jax.__version__}")
    log("1", f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
             f"compile_cache={jax.config.jax_compilation_cache_dir}")
    card = nvidia_smi()
    print(f"nvidia-smi: {card}", flush=True)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def phase_golden_gate() -> None:
    case = fixtures.make_case(74, 61, 32, halo=3, seed=2026)
    t0 = time.perf_counter()
    for kernel in ("triton", "xla"):
        loop_vs_golden("2", case, 100, kernel=kernel, rtol=LONG_RTOL,
                       atol_scale=LONG_ATOL_SCALE)
        log("2", f"{kernel}: 100 coupled+w substeps vs golden: PASS")
    log("2", f"golden gate done ({time.perf_counter() - t0:.1f} s)")

    from wrf_tpu import driver
    with tempfile.TemporaryDirectory() as tmp:
        kw = case.kernel_kwargs()
        gold = advance_mu_t_numpy(**kw)
        fx = fixtures.write_case(case, os.path.join(tmp, "fx"), steps=1,
                                 golden=gold)
        rc = driver.main([str(fx), "--tier", "xla"])
    if rc != 0:
        raise AssertionError(f"driver --tier xla exited {rc}")
    log("2", "driver --tier xla on a minted fixture: PASS")


def phase_main_path(case512) -> None:
    from wrf_tpu import run_sim
    bal = fixtures.make_case(512, 512, 50, halo=3, seed=42, balanced=True,
                             amplitude=1e-2)
    with tempfile.TemporaryDirectory() as tmp:
        gold = advance_mu_t_numpy(**bal.kernel_kwargs())
        fx = fixtures.write_case(bal, os.path.join(tmp, "fx"), steps=1,
                                 golden=gold)
        ck = os.path.join(tmp, "ck")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run_sim.main([str(fx), "--steps", "10", "--with-w",
                               "--closure", "nudge", "--steps-per-sync", "10",
                               "--diagnostics", "--checkpoint-dir", ck])
        dt = time.perf_counter() - t0
        text = buf.getvalue()
        for line in text.splitlines():
            log("3", f"  run_sim| {line}")
        if rc != 0:
            raise AssertionError(f"run_sim exited {rc}")
        drifts = [abs(float(x)) for x in
                  re.findall(r"drift ([-+0-9.e]+)\)", text)]
        if len(drifts) != 10:
            raise AssertionError(f"expected 10 drift readings, got {drifts}")
        state, step, _ = checkpoint.load_checkpoint(
            os.path.join(ck, "step_000010"))
        finite = all(np.isfinite(v).all() for v in state.values())
    log("3", f"run_sim 10 large steps in {dt:.1f} s (incl. compile); "
             f"max |mass drift| {max(drifts):.3e}; state finite={finite}")
    if not finite or max(drifts) >= 1e-6:
        raise AssertionError("run_sim: non-finite state or mass drift >= 1e-6")

    loop_vs_golden("3", case512, 5)
    log("3", "5 coupled+w substeps at 512x512x50 vs golden: PASS")


def phase_conus(case) -> None:
    mesh = one_card()
    n = 4
    loop = SmallStepLoop(mesh, *dims(case), case.flags, n_steps=n)
    arrays = loop.prepare(case_to_domain(case))
    sc = (case.rdx, case.rdy, case.dts, case.epssm)
    compiled = loop.lower(arrays, *sc).compile()
    log("4", f"coupled loop memory_analysis: {compiled.memory_analysis()}")
    t0 = time.perf_counter()
    out = jax.block_until_ready(loop(arrays, *sc))
    log("4", f"{n} coupled substeps: {time.perf_counter() - t0:.1f} s "
             "(incl. compile)")
    if not all(np.isfinite(np.asarray(v)).all() for v in out.values()):
        raise AssertionError("CONUS coupled loop: non-finite state")
    del out, arrays, loop, compiled

    rk3 = RK3Integrator(mesh, *dims(case), case.flags, acoustic_steps=4)
    arrays = rk3.prepare(case_to_domain(case))
    dt = case.dts * 4
    t0 = time.perf_counter()
    for _ in range(2):
        out = rk3.step(arrays, case.rdx, case.rdy, dt, case.epssm)
        arrays = rk3.merge_evolved(arrays, out)
    jax.block_until_ready(arrays)
    log("4", f"2 RK3 large steps: {time.perf_counter() - t0:.1f} s "
             "(incl. compile)")
    if not all(np.isfinite(np.asarray(arrays[k])).all()
               for k in rk3._EVOLVED if k in arrays):
        raise AssertionError("CONUS RK3: non-finite state")
    del arrays, out, rk3
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log("4", f"peak_bytes_in_use={peak}")

    loop_vs_golden("4", case, 1, with_w=False, smdiv=0.0)
    log("4", "1 coupled substep at 1500x1500x50 vs golden: PASS")


def phase_kernel(cases, card: str) -> None:
    """The fused column kernel: compile, compare, time against XLA."""
    for label, case, with_w, n in cases:
        loop_vs_golden("5", case, 3, kernel="triton", with_w=with_w)
        loops = {}
        for kernel in ("xla", "triton"):
            lp = SmallStepLoop(one_card(), *dims(case), case.flags,
                               n_steps=n, kernel=kernel, with_w=with_w)
            loops[kernel] = (lp, lp.prepare(case_to_domain(case,
                                                           with_w=with_w)))
        sc = (case.rdx, case.rdy, case.dts, case.epssm)
        outs = {k: embed_outputs(case, jax.device_get(lp(a, *sc)))
                for k, (lp, a) in loops.items()}
        log("5", f"{label}: triton vs xla after {n} substeps")
        check_fields("5", outs["triton"], outs["xla"], rtol=LONG_RTOL,
                     atol_scale=LONG_ATOL_SCALE)
        del outs
        times = {"xla": [], "triton": []}
        for kernel in ("xla", "triton", "triton", "xla"):
            lp, a = loops[kernel]
            times[kernel].append(ms_per_substep(lp, a, case, n))
        log("5", f"{label}: ms/substep xla={min(times['xla']):.4f} "
                 f"triton={min(times['triton']):.4f} "
                 f"(runs {times}) [{card}]")
        del loops


def phase_gpu_checks() -> None:
    for name, fn in gpu_checks.CHECKS.items():
        log("6", f"{name}: worst scaled error {fn():.4f}")


def phase_four(card: str) -> dict:
    """512x512x50 coupled+w loop and one RK3 large step on meshes 2x2, 4x1
    and 1x4, each against the same program on one card."""
    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(devs)}")
    case = fixtures.make_case(512, 512, 50, halo=3, seed=42)
    sc = (case.rdx, case.rdy, case.dts, case.epssm)
    n = 20
    ref_mesh = one_card()

    def run_loop(mesh):
        lp = SmallStepLoop(mesh, *dims(case), case.flags, n_steps=n,
                           with_w=True, smdiv=0.1)
        arrays = lp.prepare(case_to_domain(case, with_w=True))
        out = jax.device_get(lp(arrays, *sc))
        return lp, arrays, out

    def run_rk3(mesh):
        rk3 = RK3Integrator(mesh, *dims(case), case.flags, acoustic_steps=6,
                            with_w=True, smdiv=0.1)
        arrays = rk3.prepare(case_to_domain(case, with_w=True))
        return jax.device_get(rk3.step(arrays, case.rdx, case.rdy,
                                       case.dts * 6, case.epssm))

    lp1, a1, ref = run_loop(ref_mesh)
    ref_rk3 = run_rk3(ref_mesh)
    log("4x", f"1 card: {ms_per_substep(lp1, a1, case, n):.4f} ms/substep "
              f"[{card}]")
    del lp1, a1
    for shape in ((2, 2), (4, 1), (1, 4)):
        mesh = make_mesh(devs[:4], shape)
        lp, arrays, out = run_loop(mesh)
        shards = {s.device for s in arrays["t"].addressable_shards}
        if len(shards) != 4:
            raise AssertionError(f"mesh {shape}: t spread over {shards}")
        log("4x", f"mesh {shape}: loop vs 1 card")
        check_fields("4x", out, ref)
        bit = all(np.array_equal(out[k], ref[k]) for k in ref)
        rk = run_rk3(mesh)
        log("4x", f"mesh {shape}: RK3 step vs 1 card")
        check_fields("4x", rk, ref_rk3)
        bit_rk = all(np.array_equal(rk[k], ref_rk3[k]) for k in ref_rk3)
        log("4x", f"mesh {shape}: bit-equal loop={bit} rk3={bit_rk}; "
                  f"{ms_per_substep(lp, arrays, case, n):.4f} ms/substep "
                  f"[{card}]")
        del lp, arrays
    return {"count": 4}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card mesh phase")
    p.add_argument("--phases", default="123456",
                   help="phases to run (default: all)")
    args = p.parse_args(argv)

    compile_cache.enable()
    t_start = time.perf_counter()
    device = phase_device()
    card = nvidia_smi()
    tag = card.splitlines()[0]   # one line per card; they share a host
    if args.four:
        device.update(phase_four(tag))
    else:
        case512 = case1500 = None
        if "2" in args.phases:
            phase_golden_gate()
        if "3" in args.phases or "5" in args.phases:
            case512 = fixtures.make_case(512, 512, 50, halo=3, seed=42)
        if "3" in args.phases:
            phase_main_path(case512)
        if "4" in args.phases or "5" in args.phases:
            case1500 = fixtures.make_case(1500, 1500, 50, halo=3, seed=42)
        if "4" in args.phases:
            phase_conus(case1500)
        if "5" in args.phases:
            ref = fixtures.make_case(74, 61, 32, halo=3, seed=2026)
            phase_kernel([("74x61x32 coupled+w", ref, True, 200),
                          ("512x512x50 coupled", case512, False, 50),
                          ("512x512x50 coupled+w", case512, True, 50),
                          ("1500x1500x50 coupled", case1500, False, 10)],
                         tag)
        if "6" in args.phases:
            phase_gpu_checks()
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"nvidia-smi: {card}", flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
