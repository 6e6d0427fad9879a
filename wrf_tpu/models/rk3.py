"""RK3 large-step shell around the acoustic small-step loop.

WRF integrates the large (advective) timestep with the Wicker–Skamarock
three-stage Runge–Kutta scheme; each stage re-evaluates the slow tendencies
and then sub-cycles the acoustic loop over the stage interval:

    stage 1: dt/3, 1 acoustic substep
    stage 2: dt/2, ns/2 substeps
    stage 3: dt,   ns substeps

with every stage restarting from the large-step-start state.  The reference
sample contains none of this (it runs one lone substep); this shell provides
the integration *structure* — the slow-tendency evaluation is a caller hook
(``tendency_fn``), since the physics/advection packages that would compute
real tendencies are out of scope for the sample's capability set.

The default hook keeps the supplied (fixture) tendencies, which makes stages
1 and 2 provisional-state evaluations that feed nothing — exactly the
degenerate case; supply a hook to close the loop.

Two snapshot modes govern the ``*_1`` advecting fields:

* ``snapshot="base"`` (the DEFAULT; the consistent minimal closure): the
  ``*_1`` fields stay at the prepared base state; the acoustic dynamics
  are then linear with constant coefficients and STABLE.  Combined with
  the nudging tendency closure (models/tendencies.py) and a balanced
  fixture this sustains unbounded large-step horizons — measured 100/100
  steps with total-mass drift < ~1e-6 (see tendencies.py).
* ``snapshot="stage"`` (opt-in, for bounded-horizon structure tests
  only): ``u_1 := u`` etc. at every stage start.  UNSTABLE over many
  large steps — the ``*_1`` slots expect UNCOUPLED winds (m/s) but
  receive the mass-coupled state (~5e4x larger), so the mass flux
  ``u + muu*u_1/msfuy`` amplifies ~5e4x per step regardless of
  amplitude.  It is what a naive closure would do; never the default.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..grid import ConfigFlags
from ..ops.advance_uv import DEFAULT_CS2
from .small_step import SmallStepLoop, small_step_golden

#: large-step fields re-snapshotted at every stage start (the *_1 inputs
#: and the time-average buffers)
_STAGE_SNAPSHOT = {"u_1": "u", "v_1": "v", "t_1": "t", "ww_1": "ww"}


def rk3_stages(acoustic_steps: int) -> tuple[tuple[float, int], ...]:
    """(stage_dt_fraction, substeps) per stage, WRF convention."""
    ns = max(2, acoustic_steps)
    return ((1.0 / 3.0, 1), (0.5, max(1, ns // 2)), (1.0, ns))


class RK3Integrator:
    """One RK3 large step over the mesh-decomposed acoustic loop.

    ``tendency_fn(stage, arrays) -> dict`` may replace the slow-tendency
    fields (``ft``, ``mu_tend``) before each stage; default keeps them.
    """

    def __init__(self, mesh, nx, ny, nz, flags: ConfigFlags,
                 acoustic_steps: int = 6, kernel: str | None = None,
                 cs2: float = DEFAULT_CS2, with_w: bool = False,
                 smdiv: float = 0.0, snapshot: str = "base",
                 interpret: bool = False):
        if snapshot not in ("stage", "base"):
            raise ValueError(f"bad snapshot mode {snapshot!r}")
        self.snapshot = snapshot
        self.stages = rk3_stages(acoustic_steps)
        self.loops = [
            SmallStepLoop(mesh, nx, ny, nz, flags, n_steps=n_sub,
                          kernel=kernel, cs2=cs2, with_w=with_w,
                          smdiv=smdiv, interpret=interpret)
            for (_, n_sub) in self.stages
        ]
        self.prepare = self.loops[0].prepare

    def step(self, arrays, rdx, rdy, dt, epssm,
             tendency_fn: Callable | None = None):
        """Advance one large step dt; returns the stage-3 outputs.

        ``arrays`` are prepared ring-shaped inputs; every stage restarts
        from them.  ``tendency_fn(stage, prev_stage_out, stage_arrays)``
        receives the previous stage's provisional (domain-shaped) outputs
        and returns replacement ring-shaped slow-tendency fields
        (``ft``/``mu_tend``)."""
        out = None
        for stage, ((frac, n_sub), loop) in enumerate(zip(self.stages, self.loops)):
            stage_arrays = dict(arrays)  # restart from step-start state
            if self.snapshot == "stage":
                for snap, src in _STAGE_SNAPSHOT.items():
                    stage_arrays[snap] = arrays[src]
            # "base": the *_1 advecting fields keep their prepared values
            if tendency_fn is not None:
                stage_arrays.update(tendency_fn(stage, out, stage_arrays))
            dts = (frac * dt) / n_sub
            out = loop(stage_arrays, rdx, rdy, dts, epssm)
        return out

    #: large-step evolved state (written back into the ring interior
    #: between steps; run_sim and multi_step share this list and
    #: merge_evolved as the single source of truth)
    _EVOLVED = ("ww", "mu", "t", "t_ave", "u", "v", "w", "pp")

    def merge_evolved(self, arrays, out):
        """Fold ``out``'s domain-shaped evolved fields back into the
        ring interiors of ``arrays`` (returns a new dict; works on full
        prepared dicts and on evolved-only state dicts alike)."""
        nx, ny, _ = self.loops[0].domain
        new = dict(arrays)
        for name in self._EVOLVED:
            if name not in out or name not in arrays:
                continue
            v = out[name]
            if v.ndim == 3:
                new[name] = arrays[name].at[1 : 1 + ny, :, 1 : 1 + nx].set(v)
            else:
                new[name] = arrays[name].at[1 : 1 + ny, 1 : 1 + nx].set(v)
        return new

    def multi_step(self, arrays, n_steps: int, rdx, rdy, dt, epssm,
                   tendency_fn: Callable | None = None):
        """Run ``n_steps`` large steps DEVICE-RESIDENT: one ``lax.scan``
        over the whole RK3 step (3 stage loops + evolved-state merge +
        closure damping + in-graph diagnostics), so no host round trip
        happens between large steps — the per-step readback/dispatch cost
        that dominates host-stepped ``run_sim`` wall time disappears.

        Returns ``(arrays, diags)``: the input dict with the evolved
        fields advanced ``n_steps``, and a float32 ``(n_steps, 2)`` array
        of per-step ``[sum(mu), sum(t[:, 0, :])]`` over the domain — the
        mass-perturbation series and a NaN-tripwire checksum.  The
        per-step sum itself is an in-graph f32 reduction (JAX runs with
        64-bit floats off); the caller adds the constant ``sum(mut)`` in f64, so the
        drift resolution is f32 quantization of the SMALL perturbation
        sum (~1e-13 of total mass at bench scale), not of the total —
        but the printed perturbation digits can differ from the
        host-stepped path's f64 sums in the last few places.

        The compiled program is cached per ``(n_steps, field set,
        tendency_fn identity)``; a NudgingTendencies closure's reference
        fields are passed as real arguments (not baked as constants), so
        one compile serves any reference state of the same shapes."""
        import jax
        import jax.numpy as jnp

        F32 = jnp.float32
        evolved = tuple(k for k in self._EVOLVED if k in arrays)
        if not hasattr(self, "_ms_cache"):
            self._ms_cache = {}
        key = (n_steps, evolved, id(tendency_fn))

        if key not in self._ms_cache:
            def run(const, state0, refs, rdx, rdy, dt, epssm):
                if tendency_fn is not None:
                    tendency_fn.ref_t = refs["t"]
                    tendency_fn.ref_mu = refs["mu"]

                def body(state, _):
                    out = self.step({**const, **state}, rdx, rdy, dt,
                                    epssm, tendency_fn=tendency_fn)
                    new = self.merge_evolved(state, out)
                    if tendency_fn is not None:
                        tendency_fn.damp_winds(new)
                    diag = jnp.stack([jnp.sum(out["mu"], dtype=F32),
                                      jnp.sum(out["t"][:, 0, :], dtype=F32)])
                    return new, diag

                return jax.lax.scan(body, state0, length=n_steps)

            self._ms_cache[key] = jax.jit(run)

        const = {k: v for k, v in arrays.items() if k not in evolved}
        state0 = {k: arrays[k] for k in evolved}
        refs = ({"t": tendency_fn.ref_t, "mu": tendency_fn.ref_mu}
                if tendency_fn is not None else {})
        saved = ((tendency_fn.ref_t, tendency_fn.ref_mu)
                 if tendency_fn is not None else None)
        try:
            state, diags = self._ms_cache[key](
                const, state0, refs, F32(rdx), F32(rdy), F32(dt), F32(epssm))
        finally:
            if tendency_fn is not None:
                # tracing rebinds the closure's refs/cache to tracers;
                # restore concrete state for any later host-stepped use
                tendency_fn.ref_t, tendency_fn.ref_mu = saved
                tendency_fn._step_tend = None
        return {**arrays, **state}, np.asarray(diags)


def rk3_golden(case, acoustic_steps: int = 6, dt: float | None = None,
               cs2: float = DEFAULT_CS2, with_w: bool = False,
               smdiv: float = 0.0, snapshot: str = "base"):
    """Golden-path RK3 step on memory-window arrays (single tile)."""
    import dataclasses
    dt = dt if dt is not None else case.dts * acoustic_steps
    snap = (("u", "grid_u_2"), ("v", "grid_v_2"), ("t", "grid_t_2"),
            ("ww", "grid_ww"), ("mu", "grid_mu_2"), ("t_ave", "t_2save"))
    if with_w:
        snap += (("w", "grid_w"), ("pp", "grid_pp"))
    start = {k: np.asarray(case.fields[n]) for k, n in snap}
    fields = dict(case.fields)
    out = None
    for (frac, n_sub) in rk3_stages(acoustic_steps):
        stage_fields = dict(fields)
        # restart from step-start state
        stage_fields["grid_u_2"] = start["u"]
        stage_fields["grid_v_2"] = start["v"]
        stage_fields["grid_t_2"] = start["t"]
        stage_fields["grid_ww"] = start["ww"]
        stage_fields["grid_mu_2"] = start["mu"]
        stage_fields["t_2save"] = start["t_ave"]
        if snapshot == "stage":  # degenerate: *_1 := coupled state
            stage_fields["grid_u_save"] = start["u"]
            stage_fields["grid_v_save"] = start["v"]
            stage_fields["grid_t_save"] = start["t"]
            stage_fields["ww1"] = start["ww"]
        # "base": the *_1 advecting fields keep the fixture base state
        if with_w:
            stage_fields["grid_w"] = start["w"]
            stage_fields["grid_pp"] = start["pp"]
        stage_case = dataclasses.replace(
            case, fields=stage_fields, dts=(frac * dt) / n_sub
        )
        out = small_step_golden(stage_case, n_sub, cs2=cs2, with_w=with_w,
                                smdiv=smdiv)
    return out


def rk3_golden_run(case, n_large_steps: int, acoustic_steps: int = 6,
                   dt: float | None = None, cs2: float = DEFAULT_CS2,
                   with_w: bool = False, smdiv: float = 0.0,
                   snapshot: str = "base", tendency_fn=None,
                   rayleigh_uv: float = 0.0, diag_cb=None):
    """Multi-large-step golden integration with the closed-loop slow
    forcing — the FP-order-exact anchor for ``run_sim``'s long-horizon
    mode.  ``tendency_fn(fields) -> {"t_tend": ..., "mu_tend": ...}`` is
    recomputed once per large step (see
    :func:`wrf_tpu.models.tendencies.golden_nudging_fn`);
    ``rayleigh_uv`` damps the perturbation winds by ``1-r`` per step.
    ``diag_cb(step, out)``, if given, observes every step's outputs.
    Returns the final step's output dict.
    """
    import dataclasses
    dt = dt if dt is not None else case.dts * acoustic_steps
    fields = dict(case.fields)
    fold = (("u", "grid_u_2"), ("v", "grid_v_2"), ("t", "grid_t_2"),
            ("ww", "grid_ww"), ("mu", "grid_mu_2"), ("t_ave", "t_2save"))
    if with_w:
        fold += (("w", "grid_w"), ("pp", "grid_pp"))
    out = None
    for step in range(n_large_steps):
        if tendency_fn is not None:
            fields.update(tendency_fn(fields))
        out = rk3_golden(
            dataclasses.replace(case, fields=fields),
            acoustic_steps=acoustic_steps, dt=dt, cs2=cs2, with_w=with_w,
            smdiv=smdiv, snapshot=snapshot)
        for key, name in fold:
            fields[name] = out[key]
        if rayleigh_uv:
            d = np.float32(1.0 - rayleigh_uv)
            fields["grid_u_2"] = fields["grid_u_2"] * d
            fields["grid_v_2"] = fields["grid_v_2"] * d
        if diag_cb is not None:
            diag_cb(step, out)
    return out
