"""Simulation driver: namelist-configured RK3 integration with checkpoints.

The reference ships verification drivers only (one substep, then diff);
this is the framework's *production* entry point — the piece a user of the
reference graduates to once their port verifies:

    python -m wrf_tpu.run_sim FIXTURE_DIR --namelist NML.json --steps 10 \\
        [--mesh JxI] [--with-w] [--checkpoint-dir CK --checkpoint-every N] \\
        [--resume] [--profile DIR]

* the grid/state comes from a fixture directory (the binary field-per-file
  format every tier shares);
* dynamics parameters come from the WRF namelist record
  (``config.dynamics_params``: dx/dy, time_step, time_step_sound, epssm,
  smdiv, BC flags) — a JSON file of record-field overrides, or the
  fixture's scalars when omitted;
* each large step is one RK3 triple over the mesh-decomposed acoustic
  loop; state checkpoints land in the comparator-diffable snapshot format
  (``io.checkpoint``) and ``--resume`` continues from the newest one;
* per-step wall-clock and grid-points/s are printed like the reference's
  timing lines; ``--profile`` wraps the run in a ``jax.profiler`` trace.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .config import GridConfigRecord, dynamics_params
from .io import checkpoint, fixtures
from .models.rk3 import RK3Integrator
from .parallel.sharded import case_to_domain


#: ring-shaped fields the RK3 step evolves (superset; w/pp when --with-w)
#: the evolved large-step state — RK3Integrator is the source of truth
_EVOLVED = RK3Integrator._EVOLVED


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("fixture_dir")
    p.add_argument("--namelist", default=None,
                   help="GridConfigRecord overrides: a JSON dict, or a "
                        "WRF Fortran namelist.input text file (&group "
                        "... / blocks; auto-detected)")
    p.add_argument("--steps", type=int, default=1, help="RK3 large steps")
    p.add_argument("--mesh", default=None,
                   help="JxI mesh shape (default: all visible devices, "
                        "factored near-square)")
    p.add_argument("--with-w", action="store_true",
                   help="include the vertically-implicit w/pp substep")
    p.add_argument("--kernel", default=None, choices=["triton", "xla"],
                   help="substep implementation: the fused column kernel "
                        "(Pallas on the Triton route, GPU only), or the "
                        "plain XLA path (any backend, e.g. the CPU); by "
                        "default the kernel with --with-w or on large "
                        "shards, XLA otherwise")
    p.add_argument("--closure", default="none", choices=["none", "nudge"],
                   help="slow-forcing closure: 'nudge' holds the *_1 "
                        "advecting fields at the base state and recomputes "
                        "ft/mu_tend as nudging tendencies every large step "
                        "(models/tendencies.py) — required for long "
                        "horizons; 'none' is the degenerate shell "
                        "(bounded horizons only)")
    p.add_argument("--tau-steps", type=float, default=5.0,
                   help="nudging relaxation time in large steps (>=3)")
    p.add_argument("--rayleigh-uv", type=float, default=0.1,
                   help="per-step Rayleigh damping factor on the "
                        "perturbation winds (closure=nudge)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=1)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler trace of the run")
    p.add_argument("--diagnostics", action="store_true",
                   help="print per-step physics diagnostics (total column "
                        "mass and its drift — advance_mu_t IS the mass-"
                        "conservation update, so drift beyond boundary "
                        "fluxes indicates trouble)")
    p.add_argument("--steps-per-sync", type=int, default=1, metavar="K",
                   help="device-resident large steps per host sync "
                        "(RK3Integrator.multi_step): K>1 scans K whole "
                        "large steps in ONE launch — no per-step "
                        "readback/dispatch — with per-step mass "
                        "diagnostics computed in-graph; checkpoints land "
                        "on sync boundaries")
    args = p.parse_args(argv)

    import jax
    from .parallel.mesh import make_mesh

    case, _ = fixtures.read_case(args.fixture_dir)
    if args.namelist:
        text = open(args.namelist).read()
        if text.lstrip().startswith("{"):
            rec = GridConfigRecord(**json.loads(text))
        else:
            from .config import read_namelist
            rec = read_namelist(text)
        dyn = dynamics_params(rec)
        flags = dyn["flags"]
    else:
        ns = 4
        dyn = dict(rdx=case.rdx, rdy=case.rdy, dts=case.dts,
                   epssm=case.epssm, smdiv=0.0, acoustic_steps=ns,
                   flags=case.flags)
        flags = case.flags
    dt = dyn["dts"] * dyn["acoustic_steps"]

    mesh_shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else None
    mesh = make_mesh(
        jax.devices()[: mesh_shape[0] * mesh_shape[1]] if mesh_shape else None,
        mesh_shape,
    )
    nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
    rk3 = RK3Integrator(mesh, nx, ny, nz, flags,
                        acoustic_steps=dyn["acoustic_steps"],
                        kernel=args.kernel, with_w=args.with_w,
                        smdiv=dyn["smdiv"],
                        snapshot="base" if args.closure == "nudge"
                        else "stage")

    dom = case_to_domain(case, with_w=args.with_w)
    start_step = 0
    dom = {k: np.array(v, copy=True) for k, v in dom.items()}
    # the nudging closure must relax toward the run's ORIGINAL base
    # state; snapshot it before any checkpoint is folded in, or a
    # resumed run would silently nudge toward the interrupted state
    base_ref = {"t": np.array(dom["t"], copy=True),
                "mu": np.array(dom["mu"], copy=True)}
    if args.resume and not args.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    if args.resume:
        from pathlib import Path

        def _step_no(p):
            try:
                return int(p.name.removeprefix("step_"))
            except ValueError:
                return None  # stray entry, not one of ours

        cks = [(n, p) for p in Path(args.checkpoint_dir).glob("step_*")
               if (n := _step_no(p)) is not None]
        if cks:
            newest = max(cks)[1]
            state, start_step, _ = checkpoint.load_checkpoint(newest)
            print(f"resuming from {newest} (step {start_step})")
            expected = {n for n in _EVOLVED if n in dom}
            missing = expected - state.keys()
            extra = state.keys() - expected
            if missing or extra:
                # e.g. resuming a --with-w checkpoint without --with-w (or
                # vice versa): continuity would silently differ
                raise SystemExit(
                    f"checkpoint field set differs from the configured "
                    f"state (missing from checkpoint: {sorted(missing)}; "
                    f"not configured: {sorted(extra)}) — rerun with the "
                    f"matching --with-w setting")
            for name, arr in state.items():
                dom[name] = arr

    b = case.bounds
    nx_d, ny_d = b.ide, b.jde
    n_pts = (b.ide - b.ids) * (b.jde - b.jds) * b.kdim

    # state stays DEVICE-RESIDENT across large steps: constants upload
    # once, the evolved interiors fold back into the ring arrays on device,
    # and only a scalar checksum syncs each step (full readback happens at
    # checkpoint boundaries only)
    arrays = rk3.prepare(dom)
    import jax.numpy as jnp

    tendency_fn = None
    if args.closure == "nudge":
        from .models.tendencies import NudgingTendencies
        tendency_fn = NudgingTendencies(arrays, dt,
                                        tau_steps=args.tau_steps,
                                        rayleigh_uv=args.rayleigh_uv)
        if start_step:
            # resumed run: arrays hold the checkpointed state, so rebuild
            # the relaxation reference from the pre-resume base snapshot
            # (continuity with the uninterrupted run)
            from .parallel.sharded import pad_to_mesh
            lo = rk3.loops[0]
            tendency_fn.ref_t = jax.device_put(
                pad_to_mesh(base_ref["t"], lo.mesh), lo.shardings["t"])
            tendency_fn.ref_mu = jax.device_put(
                pad_to_mesh(base_ref["mu"], lo.mesh), lo.shardings["mu"])

    def advance(arrays):
        out = rk3.step(arrays, dyn["rdx"], dyn["rdy"], dt, dyn["epssm"],
                       tendency_fn=tendency_fn)
        arrays = rk3.merge_evolved(arrays, out)
        if tendency_fn is not None:
            tendency_fn.damp_winds(arrays)
        return arrays, out

    def snapshot(arrays):
        """Ring-shaped host copies of the evolved state (mesh padding
        stripped) — the checkpoint/readback boundary."""
        state = {}
        for name in _EVOLVED:
            if name not in arrays:
                continue
            arr = np.asarray(arrays[name])
            state[name] = (arr[: ny_d + 2, :, : nx_d + 2] if arr.ndim == 3
                           else arr[: ny_d + 2, : nx_d + 2])
        return state

    from contextlib import nullcontext
    prof = (jax.profiler.trace(args.profile) if args.profile
            else nullcontext())
    mass0 = None

    if args.steps_per_sync > 1:
        # device-resident mode: K large steps per launch, diagnostics as
        # an in-graph time series (one readback per chunk).  Total dry
        # mass = constant sum(mut) + the per-step mass-perturbation sum.
        mut_sum = float(np.sum(
            np.asarray(arrays["mut"])[1 : 1 + ny_d, 1 : 1 + nx_d],
            dtype=np.float64))
        with prof:
            step = start_step
            while step < start_step + args.steps:
                n = min(args.steps_per_sync,
                        start_step + args.steps - step)
                t0 = time.perf_counter()
                arrays, diags = rk3.multi_step(
                    arrays, n, dyn["rdx"], dyn["rdy"], dt, dyn["epssm"],
                    tendency_fn=tendency_fn)
                dt_s = time.perf_counter() - t0
                if not np.isfinite(diags).all():
                    raise SystemExit(
                        f"non-finite state within steps "
                        f"{step + 1}-{step + n} (NaN tripwire); see "
                        "--closure nudge for long horizons")
                note = " (incl. compile)" if step == start_step else ""
                print(f"steps {step + 1}-{step + n}: {dt_s * 1e3:.1f} ms "
                      f"({dt_s / n * 1e3:.2f} ms/large-step, "
                      f"device-resident){note}", flush=True)
                if args.diagnostics:
                    for i in range(n):
                        pert = float(diags[i, 0])
                        mass = mut_sum + pert
                        if mass0 is None:
                            mass0 = mass if mass else 1.0
                        print(f"  step {step + i + 1}: total dry mass "
                              f"{mass:.10e} "
                              f"(drift {(mass - mass0) / abs(mass0):+.3e}),"
                              f" mass perturbation sum {pert:+.6e}",
                              flush=True)
                step += n
                # --checkpoint-every is honoured at sync-boundary
                # granularity: checkpoint when the chunk CROSSED a
                # multiple of the interval (or at the end of the run)
                crossed = (step // args.checkpoint_every
                           > (step - n) // args.checkpoint_every)
                final = step >= start_step + args.steps
                if args.checkpoint_dir and (crossed or final):
                    d = checkpoint.save_checkpoint(
                        f"{args.checkpoint_dir}/step_{step:06d}",
                        snapshot(arrays), step=step)
                    print(f"  checkpoint -> {d}", flush=True)
        return 0

    with prof:
        for step in range(start_step, start_step + args.steps):
            t0 = time.perf_counter()
            arrays, out = advance(arrays)
            checksum = float(jnp.sum(out["t"]))  # scalar readback = sync
            dt_s = time.perf_counter() - t0
            if not np.isfinite(checksum):
                raise SystemExit(
                    f"non-finite state at step {step + 1} (NaN tripwire). "
                    "The degenerate RK3 shell (--closure none) is unstable "
                    "over many large steps — the golden path diverges at "
                    "the same step (see models/rk3.py).  Re-run with "
                    "--closure nudge (base-state snapshot + nudging "
                    "tendencies, models/tendencies.py) for long horizons, "
                    "or integrate within a bounded large-step horizon.")
            per_sub = dt_s / sum(n for _, n in rk3.stages)
            note = " (incl. compile)" if step == start_step else ""
            print(f"step {step + 1}: {dt_s * 1e3:.1f} ms "
                  f"({per_sub * 1e3:.2f} ms/substep, "
                  f"{n_pts / per_sub:.3e} grid-points/s){note}", flush=True)
            if args.diagnostics:
                # total dry mass (mut + mu = muts summed over the domain):
                # advance_mu_t IS the mass-conservation update, so relative
                # drift beyond boundary fluxes indicates trouble
                mass = float(np.sum(np.asarray(out["muts"]),
                                    dtype=np.float64))
                pert = float(np.sum(np.asarray(out["mu"]),
                                    dtype=np.float64))
                if mass0 is None:
                    mass0 = mass if mass else 1.0
                print(f"  total dry mass {mass:.10e} "
                      f"(drift {(mass - mass0) / abs(mass0):+.3e}), "
                      f"mass perturbation sum {pert:+.6e}", flush=True)
            if args.checkpoint_dir and (step + 1) % args.checkpoint_every == 0:
                d = checkpoint.save_checkpoint(
                    f"{args.checkpoint_dir}/step_{step + 1:06d}",
                    snapshot(arrays), step=step + 1)
                print(f"  checkpoint -> {d}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
