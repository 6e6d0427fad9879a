"""The acoustic small-step loop: advance_uv + advance_mu_t per substep.

The reference runs one advance_mu_t in isolation; the framework's flagship
model is the surrounding loop (BASELINE.json configs[2]): every acoustic
substep the winds respond to the mass field (advance_uv) and the mass/theta
fields respond to the winds (advance_mu_t), iterated device-resident under
``lax.scan`` across the mesh.

Each substep refreshes the 1-cell halos of mu (and mudf under divergence
damping), runs the wind update, refreshes the u/v halos, then runs the
mu/t substep and, with ``with_w``, the vertically-implicit w/pp substep.
``kernel="triton"`` runs them as one fused column kernel
(ops/substep_triton.py, GPU only); ``kernel="xla"`` runs the plain XLA
ops for both, on any backend.  By default the loop takes the kernel with
the w solve or on large shards, where it was faster on the card, and XLA
otherwise (:func:`default_kernel`).  The wind update is an elementwise
stencil that XLA fuses on either path.

Verification follows the house pattern: a numpy golden loop
(``small_step_golden``) runs the same substep sequence FP-order-exact on a
single tile; the mesh-decomposed loop must reassemble to it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..grid import ConfigFlags
from ..ops.advance_uv import DEFAULT_CS2, advance_uv_jnp, advance_uv_numpy
from ..ops.advance_w import DEFAULT_CW, DEFAULT_GW, advance_w_jnp, advance_w_numpy
from ..ops.reference_numpy import advance_mu_t_numpy
from ..parallel import halo
from ..parallel.mesh import replicated, sharding2, sharding3
from ..parallel.sharded import (
    FIELDS_1D, FIELDS_2D, FIELDS_3D, RING, SCALARS, domain_window,
    local_masks, pad_to_mesh, substep_fn,
)

F = jnp.float32

#: fields carried (and updated) across substeps
STATE_KEYS = ("ww", "mu", "t", "t_ave", "u", "v")

#: columns per shard from which the fused kernel beats the XLA path on the
#: loop without the w solve.  ``tools/kernel_crossover.py`` on an H100
#: 80GB HBM3 at 400 W, median of 5 alternating turns, XLA vs kernel ms
#: per substep: 320x320x50 0.319 vs 0.338, 384x384x50 0.453 vs 0.407.
#: The kernel's serial k walk is latency-bound on smaller shards.  With
#: the w solve the kernel won at every size measured, from 74x61x32 up.
TRITON_MIN_COLUMNS = 384 * 384


def default_kernel(mesh: Mesh, nx: int, ny: int, with_w: bool) -> str:
    """The substep path of a loop that names none: the fused kernel with
    the w solve or on shards of at least ``TRITON_MIN_COLUMNS`` columns,
    XLA otherwise.  The kernel runs on a GPU only, so where it is the pick
    on another platform the choice is refused, not changed."""
    columns = (-(-(ny + 2 * RING) // mesh.shape["j"])
               * -(-(nx + 2 * RING) // mesh.shape.get("i", 1)))
    if not with_w and columns < TRITON_MIN_COLUMNS:
        return "xla"
    platform = mesh.devices.flat[0].platform
    if platform != "gpu":
        raise ValueError(
            f"the default substep path here is the fused kernel, which needs "
            f"a GPU (mesh platform {platform!r}); pass kernel='xla' "
            f"(run_sim: --kernel xla)")
    return "triton"


def small_step_golden(case, steps: int, cs2: float = DEFAULT_CS2,
                      with_w: bool = False,
                      cw: float = DEFAULT_CW, gw: float = DEFAULT_GW,
                      smdiv: float = 0.0):
    """Golden-path acoustic loop on memory-window arrays (single tile).

    With ``with_w`` each substep also runs the vertically-implicit w/pp
    substep (advance_w) on the theta field the mu/t substep just produced.
    With ``smdiv`` the wind update applies divergence damping from the
    previous substep's mudf (zero on the first substep).
    """
    kw = case.kernel_kwargs()
    i0, i1, j0, j1, k0, k1 = case.bounds.loop_bounds(case.flags)
    window = (i0, i1, j0, j1)
    state = {k: np.asarray(kw[k]) for k in STATE_KEYS}
    out = dict(state)
    if with_w:
        f = case.fields
        wst = {"w": np.asarray(f["grid_w"]), "pp": np.asarray(f["grid_pp"])}
        rdn = np.asarray(f["grid_rdn"])
    mudf_prev = np.zeros_like(np.asarray(kw["mu"])) if smdiv else None
    for _ in range(steps):
        u, v = advance_uv_numpy(
            u=state["u"], v=state["v"], mu=state["mu"],
            muu=kw["muu"], muv=kw["muv"],
            msfuy=kw["msfuy"], msfvx_inv=kw["msfvx_inv"],
            rdx=kw["rdx"], rdy=kw["rdy"], dts=kw["dts"],
            window=window, cs2=cs2, mudf=mudf_prev, smdiv=smdiv,
        )
        out = advance_mu_t_numpy(**{**kw, **state, "u": u, "v": v})
        if with_w:
            wst["w"], wst["pp"] = advance_w_numpy(
                w=wst["w"], pp=wst["pp"], t=out["t"], rdn=rdn,
                rdnw=kw["rdnw"], dts=kw["dts"], epssm=kw["epssm"],
                window=window, k0=k0, k1=k1, cw=cw, gw=gw,
            )
        if smdiv:
            mudf_prev = out["mudf"]
        state = {**{k: out[k] for k in ("ww", "mu", "t", "t_ave")},
                 "u": u, "v": v}
    res = {**out, "u": state["u"], "v": state["v"]}
    if with_w:
        res.update(wst)
    return res


class SmallStepLoop:
    """Mesh-decomposed acoustic small-step loop (device-resident scan).

    Same array contract as :class:`~wrf_tpu.parallel.sharded.ShardedAdvanceMuT`
    (ring-shaped global arrays, ``prepare`` -> ``__call__``); additionally
    returns the final winds (and w/pp with ``with_w``).  ``kernel`` is
    "triton" (the fused column kernel, GPU only) or "xla"; the default
    picks by :func:`default_kernel` from ``with_w`` and the columns per
    shard.  ``interpret`` runs the Triton kernel in the Pallas interpreter
    (tests on the CPU).
    """

    def __init__(self, mesh: Mesh, nx: int, ny: int, nz: int,
                 flags: ConfigFlags, n_steps: int = 1,
                 kernel: str | None = None, cs2: float = DEFAULT_CS2,
                 with_w: bool = False,
                 cw: float = DEFAULT_CW, gw: float = DEFAULT_GW,
                 smdiv: float = 0.0, interpret: bool = False):
        self.mesh = mesh
        self.domain = (nx, ny, nz)
        self.with_w = with_w
        j_shards = mesh.shape["j"]
        i_shards = mesh.shape.get("i", 1)
        self.kernel = kernel = kernel or default_kernel(mesh, nx, ny, with_w)
        window = domain_window(nx, ny, nz, flags)
        self.window = window
        k0, k1 = window[4], window[5]
        step_impl = substep_fn(kernel, interpret)
        fused_w = with_w and kernel == "triton"

        has_i_axis = "i" in mesh.shape
        ip = "i" if has_i_axis else None
        F3 = FIELDS_3D + (("w", "pp") if with_w else ())
        F1 = FIELDS_1D + (("rdn",) if with_w else ())
        self._f3, self._f1 = F3, F1
        s3, s2, rep = sharding3(mesh), sharding2(mesh), replicated(mesh)
        self.shardings = {**{n: s3 for n in F3},
                          **{n: s2 for n in FIELDS_2D},
                          **{n: rep for n in F1}}
        in_specs = ({n: self.shardings[n].spec for n in
                     F3 + FIELDS_2D + F1},
                    {n: P() for n in SCALARS})
        out_names = ("ww", "mu", "muave", "muts", "mudf", "t", "t_ave", "u", "v")
        if with_w:
            out_names += ("w", "pp")
        out_specs = {n: (P("j", None, ip) if n in
                         ("ww", "t", "t_ave", "u", "v", "w", "pp")
                         else P("j", ip))
                     for n in out_names}

        def local_loop(arrs, scalars):
            nj_loc, K, ni_loc = arrs["ww"].shape
            j_sh = j_shards > 1
            i_sh = i_shards > 1

            padded = {}
            for name in F3:
                padded[name] = halo.halo3(arrs[name], j_sharded=j_sh, i_sharded=i_sh)
            for name in FIELDS_2D:
                padded[name] = halo.halo2(arrs[name], j_sharded=j_sh, i_sharded=i_sh)
            for name in F1:
                padded[name] = arrs[name]

            j_off = jax.lax.axis_index("j") * nj_loc - 1
            i_off = ((jax.lax.axis_index("i") * ni_loc - 1)
                     if has_i_axis else -1)
            i0, i1, j0, j1 = window[:4]
            offs = (j_off, i_off)
            i_mask, j_mask = local_masks(window, j_off, i_off,
                                         nj_loc + 2, ni_loc + 2)

            def refresh3(x):
                if j_sh:
                    x = halo.refresh_axis(x, 0, "j", n_interior=nj_loc)
                if i_sh:
                    x = halo.refresh_axis(x, 2, "i", n_interior=ni_loc)
                return x

            def refresh2(x):
                if j_sh:
                    x = halo.refresh_axis(x, 0, "j", n_interior=nj_loc)
                if i_sh:
                    x = halo.refresh_axis(x, 1, "i", n_interior=ni_loc)
                return x

            carry_keys = STATE_KEYS
            if with_w:
                carry_keys = carry_keys + ("w", "pp")
            if smdiv:
                carry_keys = carry_keys + ("mudf",)
                padded["mudf"] = jnp.zeros_like(padded["mu"])
            const = {k: v for k, v in padded.items() if k not in carry_keys}
            state0 = {k: padded[k] for k in carry_keys}

            def substep(state):
                mu_p = refresh2(state["mu"])
                mudf_p = refresh2(state["mudf"]) if smdiv else None
                u, v = advance_uv_jnp(
                    u=state["u"], v=state["v"], mu=mu_p,
                    muu=const["muu"], muv=const["muv"],
                    msfuy=const["msfuy"], msfvx_inv=const["msfvx_inv"],
                    rdx=scalars["rdx"], rdy=scalars["rdy"],
                    dts=scalars["dts"],
                    window=(i0, i1, j0, j1), offsets=offs, cs2=cs2,
                    mudf=mudf_p, smdiv=smdiv,
                )
                # the winds changed: advance_mu_t reads u(i+1)/v(j+1)
                u, v = refresh3(u), refresh3(v)
                ins = {k: v_ for k, v_ in {**const, **state}.items()
                       if k not in ("w", "pp", "rdn", "mudf")}
                ins = {**ins, "mu": mu_p, "u": u, "v": v}
                w_kw = ({"w": state["w"], "pp": state["pp"],
                         "rdn": const["rdn"], "cw": cw, "gw": gw}
                        if fused_w else {})
                out = step_impl(**ins, **w_kw, **scalars, i_mask=i_mask,
                                j_mask=j_mask, k0=k0, k1=k1, kde=nz - 1)
                out = {**out, "u": u, "v": v}
                if with_w and not fused_w:
                    # column-local: no halo refresh needed
                    w_n, pp_n = advance_w_jnp(
                        w=state["w"], pp=state["pp"], t=out["t"],
                        rdn=const["rdn"], rdnw=const["rdnw"],
                        dts=scalars["dts"], epssm=scalars["epssm"],
                        window=(i0, i1, j0, j1), offsets=offs,
                        k0=k0, k1=k1, cw=cw, gw=gw,
                    )
                    out = {**out, "w": w_n, "pp": pp_n}
                return {k: out[k] for k in carry_keys}, out

            state = state0
            if n_steps > 1:
                def body(state, _):
                    new_state, _out = substep(state)
                    return new_state, None
                state, _ = jax.lax.scan(body, state, length=n_steps - 1)
            _, out = substep(state)

            res = {}
            for name in out_names:
                val = out[name]
                if val.ndim == 3:
                    res[name] = val[1 : 1 + nj_loc, :, 1 : 1 + ni_loc]
                else:
                    res[name] = val[1 : 1 + nj_loc, 1 : 1 + ni_loc]
            return res

        self._run = jax.jit(jax.shard_map(
            local_loop, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        ))

    def prepare(self, arrays):
        out = {}
        for name in self._f3 + FIELDS_2D:
            out[name] = jax.device_put(
                pad_to_mesh(arrays[name], self.mesh), self.shardings[name]
            )
        for name in self._f1:
            out[name] = jax.device_put(
                jnp.asarray(arrays[name], F), self.shardings[name]
            )
        return out

    @staticmethod
    def _scalars(rdx, rdy, dts, epssm):
        return {"rdx": jnp.asarray(rdx, F), "rdy": jnp.asarray(rdy, F),
                "dts": jnp.asarray(dts, F), "epssm": jnp.asarray(epssm, F)}

    def lower(self, arrays, rdx, rdy, dts, epssm):
        """The jitted loop lowered for ``arrays``; ``.compile()`` gives
        its ``memory_analysis()`` and HLO."""
        return self._run.lower(arrays, self._scalars(rdx, rdy, dts, epssm))

    def __call__(self, arrays, rdx, rdy, dts, epssm):
        out = self._run(arrays, self._scalars(rdx, rdy, dts, epssm))
        nx, ny, _ = self.domain
        trimmed = {}
        for name, val in out.items():
            if val.ndim == 3:
                trimmed[name] = val[RING : ny + RING, :, RING : nx + RING]
            else:
                trimmed[name] = val[RING : ny + RING, RING : nx + RING]
        return trimmed
