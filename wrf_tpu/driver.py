"""CLI verification driver: load a golden fixture, run a tier, diff, time.

Framework analog of the reference's three driver executables
(advance_mu_t_driver.{f90,c,cu}): read every input field from the fixture
directory, run ``advance_mu_t`` for N small steps on the selected tier,
print the timing line, then the per-field comparison report (equal/diff
counts, max rel/abs error, max ULP, RMSE — the reference's metric suite).

Usage:
    python -m wrf_tpu.driver FIXTURE_DIR [--steps N] [--tier T] [--mesh JxI]
                             [--dump-intermediates DIR] [--interpret]

Tiers: numpy (golden path), native (C++ oracle), xla, triton (single-tile
device paths: the plain XLA substep and the fused column kernel),
sharded-xla / sharded-triton (mesh-decomposed, honours --mesh), coupled /
coupled-triton / coupled-native (the full acoustic small-step loop — uv +
mu/t, plus the vertically-implicit w substep under --with-w — verified
against the in-process golden loop; the device tiers honour --mesh).
``--interpret`` runs the triton tiers in the Pallas interpreter, which is
how they run on a machine without a GPU.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np

from .compare import compare
from .io import codec, fixtures

#: output-field -> golden file name (reference driver naming,
#: advance_mu_t_driver.c:247-257)
GOLDEN_FILES = {
    "ww": "grid_ww_output.bin",
    "t": "grid_t_2_output.bin",
    "t_ave": "t_2save_output.bin",
    "mu": "grid_mu_2_output.bin",
    "muave": "muave_output.bin",
    "muts": "grid_muts_output.bin",
    "mudf": "grid_mudf_output.bin",
}

#: the driver's acceptance gate — ELEMENT-WISE ``|a-g| <= atol + rtol*|g|``
#: with the absolute floor scaled per field (``atol_scale * max|golden|``),
#: the same formula the test suite asserts (compare.assert_outputs_allclose)
RTOL = 1e-4
ATOL_SCALE = 1e-5

#: every tier, in ``--tier all`` order ("+w" adds the implicit w substep)
TIERS = ("numpy", "native", "xla", "triton", "sharded-xla", "sharded-triton",
         "coupled", "coupled-triton", "coupled-native")
ALL = TIERS + ("coupled+w", "coupled-triton+w", "coupled-native+w")


def run_tier(case, steps: int, tier: str, mesh_shape=None,
             capture: bool = False, with_w: bool = False,
             interpret: bool = False):
    """Run `steps` small steps on the chosen tier; returns
    ``(outputs, seconds, golden_override)`` — ``golden_override`` is None
    for tiers verified against the fixture goldens, or the in-process
    golden outputs for the coupled-loop tiers.

    The timed window covers the step calls only, transfers excluded,
    matching the reference's timing policy."""
    kw = case.kernel_kwargs()

    if tier == "coupled-native":
        # the full coupled loop on the native C++ tier (advance_uv +
        # advance_mu_t + optional advance_w per substep), verified against
        # the numpy golden loop (bit-identical by construction)
        from .models.small_step import small_step_golden
        from .native import (advance_mu_t_native, advance_uv_native,
                             advance_w_native)
        from .ops.advance_uv import DEFAULT_CS2
        from .ops.advance_w import DEFAULT_CW, DEFAULT_GW
        state = {k: kw[k] for k in ("ww", "mu", "t", "t_ave", "u", "v")}
        if with_w:
            wst = {"w": case.fields["grid_w"], "pp": case.fields["grid_pp"]}
        out = dict(state)
        t0 = time.perf_counter()
        for _ in range(steps):
            u, v = advance_uv_native(
                u=state["u"], v=state["v"], mu=state["mu"],
                muu=kw["muu"], muv=kw["muv"], msfuy=kw["msfuy"],
                msfvx_inv=kw["msfvx_inv"], rdx=kw["rdx"], rdy=kw["rdy"],
                dts=kw["dts"], cs2=DEFAULT_CS2,
                flags=case.flags, bounds=case.bounds)
            out = advance_mu_t_native(**{**kw, **state, "u": u, "v": v})
            if with_w:
                wst["w"], wst["pp"] = advance_w_native(
                    w=wst["w"], pp=wst["pp"], t=out["t"],
                    rdn=case.fields["grid_rdn"], rdnw=kw["rdnw"],
                    dts=kw["dts"], epssm=kw["epssm"],
                    cw=DEFAULT_CW, gw=DEFAULT_GW,
                    flags=case.flags, bounds=case.bounds)
            state = {**{k: out[k] for k in ("ww", "mu", "t", "t_ave")},
                     "u": u, "v": v}
        dt = time.perf_counter() - t0
        out = {**out, "u": state["u"], "v": state["v"]}
        if with_w:
            out.update(wst)
        gold = small_step_golden(case, steps, with_w=with_w)
        return out, dt, gold

    if tier.startswith("coupled"):
        import jax
        from .models.small_step import SmallStepLoop, small_step_golden
        from .parallel.mesh import make_mesh
        from .parallel.sharded import case_to_domain, embed_outputs
        kernel = "triton" if tier.endswith("triton") else "xla"
        mesh = make_mesh(
            jax.devices()[: mesh_shape[0] * mesh_shape[1]] if mesh_shape else None,
            mesh_shape,
        )
        nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
        loop = SmallStepLoop(mesh, nx, ny, nz, case.flags, n_steps=steps,
                             kernel=kernel, with_w=with_w,
                             interpret=interpret and kernel == "triton")
        arrays = loop.prepare(case_to_domain(case, with_w=with_w))
        jax.block_until_ready(
            loop(arrays, case.rdx, case.rdy, case.dts, case.epssm))
        t0 = time.perf_counter()
        out_dom = jax.block_until_ready(
            loop(arrays, case.rdx, case.rdy, case.dts, case.epssm))
        dt = time.perf_counter() - t0
        out_dom = {k: np.asarray(v) for k, v in out_dom.items()}
        gold = small_step_golden(case, steps, with_w=with_w)
        return embed_outputs(case, out_dom), dt, gold

    if tier in ("numpy", "native"):
        if tier == "numpy":
            from .ops.reference_numpy import advance_mu_t_numpy as fn
        else:
            from .native import advance_mu_t_native as fn
        state = {k: kw[k] for k in ("ww", "mu", "t", "t_ave")}
        out = dict(state)
        t0 = time.perf_counter()
        for s in range(steps):
            cap = capture and s == steps - 1  # final substep's phase A
            out = fn(**{**kw, **state}, capture_intermediates=cap)
            state = {k: out[k] for k in ("ww", "mu", "t", "t_ave")}
        return out, time.perf_counter() - t0, None

    if tier in ("xla", "triton"):
        import jax
        import jax.numpy as jnp
        from .ops.advance_mu_t_jnp import advance_mu_t_impl, window_masks
        from .parallel.sharded import substep_fn
        b, flags = case.bounds, case.flags
        _, _, _, _, k0, k1 = b.loop_bounds(flags)
        arr = {k: jnp.asarray(v, jnp.float32) for k, v in kw.items()
               if hasattr(v, "ndim")}
        sc = {k: kw[k] for k in ("rdx", "rdy", "dts", "epssm")}
        i_mask, j_mask = (jnp.asarray(m) for m in window_masks(b, flags))
        if tier == "xla":
            impl = functools.partial(advance_mu_t_impl,
                                     capture_intermediates=capture)
        else:
            impl = substep_fn("triton", interpret)

        @jax.jit
        def step(ins):
            return impl(**ins, **sc, i_mask=i_mask, j_mask=j_mask,
                        k0=k0, k1=k1, kde=b.mem(b.kde, "k"))

        state = {k: arr[k] for k in ("ww", "mu", "t", "t_ave")}
        jax.block_until_ready(step({**arr, **state}))  # compile
        t0 = time.perf_counter()
        for _ in range(steps):
            out = step({**arr, **state})
            state = {k: out[k] for k in ("ww", "mu", "t", "t_ave")}
        out = jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        return {k: np.asarray(v) for k, v in out.items()}, dt, None

    if tier.startswith("sharded"):
        import jax
        from .parallel.mesh import make_mesh
        from .parallel.sharded import (
            ShardedAdvanceMuT, case_to_domain, embed_outputs,
        )
        kernel = "triton" if tier.endswith("triton") else "xla"
        mesh = make_mesh(
            jax.devices()[: mesh_shape[0] * mesh_shape[1]] if mesh_shape else None,
            mesh_shape,
        )
        nx, ny, nz = case.bounds.ide, case.bounds.jde, case.bounds.kdim
        step = ShardedAdvanceMuT(mesh, nx, ny, nz, case.flags,
                                 n_steps=steps, kernel=kernel,
                                 interpret=interpret and kernel == "triton")
        arrays = step.prepare(case_to_domain(case))
        jax.block_until_ready(
            step(arrays, case.rdx, case.rdy, case.dts, case.epssm))
        t0 = time.perf_counter()
        out_dom = jax.block_until_ready(
            step(arrays, case.rdx, case.rdy, case.dts, case.epssm))
        dt = time.perf_counter() - t0
        out_dom = {k: np.asarray(v) for k, v in out_dom.items()}
        return embed_outputs(case, out_dom), dt, None

    raise SystemExit(f"unknown tier {tier!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("fixture_dir")
    p.add_argument("--steps", type=int, default=None,
                   help="small steps (default: the fixture's steps.bin)")
    p.add_argument("--tier", default="xla", choices=TIERS + ("all",))
    p.add_argument("--with-w", action="store_true",
                   help="coupled tiers: include the vertically-implicit "
                        "w/pp substep")
    p.add_argument("--mesh", default=None, help="JxI mesh shape for sharded tiers")
    p.add_argument("--dump-intermediates", default=None, metavar="DIR",
                   help="write *_before_theta.bin phase-A captures of the "
                        "final substep (numpy, native and xla tiers)")
    p.add_argument("--interpret", action="store_true",
                   help="run the triton tiers in the Pallas interpreter")
    args = p.parse_args(argv)
    if (args.dump_intermediates
            and args.tier not in ("numpy", "native", "xla")):
        p.error("--dump-intermediates requires a capture-capable tier "
                "(numpy, native, xla)")

    case, fx_steps = fixtures.read_case(args.fixture_dir)
    steps = args.steps if args.steps is not None else fx_steps
    mesh_shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else None

    if args.tier == "all":
        # the reference's workflow of running every tier's driver side by
        # side, as one command: per tier, worst per-field result vs the
        # fixture goldens (single-substep tiers) or the in-process golden
        # loop (coupled tiers); "+w" rows add the vertically-implicit w/pp
        # substep
        golden = fixtures.read_golden(args.fixture_dir, case.bounds)
        failures = 0
        for tier in ALL:
            tier_w = tier.endswith("+w")
            tname = tier[:-2] if tier_w else tier
            try:
                out, dt, gold_ov = run_tier(case, steps, tname, mesh_shape,
                                            with_w=tier_w,
                                            interpret=args.interpret)
            except Exception as e:  # report, keep the matrix going
                failures += 1
                print(f"{tier:>20}: ERROR {type(e).__name__}: {e}")
                continue
            gold = gold_ov if gold_ov is not None else golden
            names = sorted(gold.keys() & out.keys()) if gold_ov is not None \
                else list(GOLDEN_FILES)
            results = [compare(out[n], gold[n], n, rtol=RTOL,
                               atol_scale=ATOL_SCALE) for n in names]
            worst = max(results, key=lambda r: r.max_scaled_err)
            ok = all(r.passed for r in results)
            failures += 0 if ok else 1
            print(f"{tier:>20}: {dt / steps * 1e3:9.3f} ms/step   "
                  f"worst field {worst.name}: max_abs={worst.max_abs_err:.3e}"
                  f" scaled_err={worst.max_scaled_err:.3f}   "
                  f"{'PASS' if ok else 'FAIL'}")
        if failures:
            print(f"FAILED: {failures} tier(s)")
        return 1 if failures else 0

    out, dt, gold_override = run_tier(
        case, steps, args.tier, mesh_shape,
        capture=bool(args.dump_intermediates), with_w=args.with_w,
        interpret=args.interpret)
    if args.dump_intermediates:
        from pathlib import Path
        d = Path(args.dump_intermediates)
        d.mkdir(parents=True, exist_ok=True)
        for name, val in out.items():
            if name.endswith("_before_theta"):
                codec.write_field(d / f"{name}.bin", np.asarray(val))

    b = case.bounds
    n_pts = (b.ide - b.ids) * (b.jde - b.jds) * b.kdim * steps
    print(f"advance_mu_t [{args.tier}]: {steps} step(s) in {dt * 1e3:.3f} ms "
          f"({dt / steps * 1e3:.4f} ms/step, {n_pts / dt:.3e} grid-points/s)")

    failures = 0
    if gold_override is not None:
        for name in sorted(gold_override.keys() & out.keys()):
            r = compare(out[name], gold_override[name],
                        f"{name} (golden loop)", rtol=RTOL,
                        atol_scale=ATOL_SCALE)
            print(r)
            if not r.passed:
                failures += 1
    else:
        golden = fixtures.read_golden(args.fixture_dir, case.bounds)
        for name, fname in GOLDEN_FILES.items():
            r = compare(out[name], golden[name], fname, rtol=RTOL,
                        atol_scale=ATOL_SCALE)
            print(r)
            if not r.passed:
                failures += 1
    if failures:
        print(f"FAILED: {failures} field(s) outside tolerance")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
