#!/usr/bin/env python3
"""DFG 2D-2 unsteady cylinder benchmark via the banded projection engine.

Runs the full Schafer-Turek 2D-2 configuration (Re=100 on the cylinder
diameter, t in [0, T], dt=0.005 -- reference demo/dfg_benchmark.py:14-66)
on the curved isoparametric cylinder mesh with the gather-free planar
SBDF-2 projection step (assembly/fastop.py + solvers/planar_step.py).

Drag/lift are evaluated *inside the scan* from the monolithic BDF-2
momentum residual at the cylinder's constrained nodes (nodal reactions,
superconvergent) -- expressed entirely in banded-operator applications
(verified to 1e-13 against assembly/operators.MixedOperator.residual).
Steps run in jitted ``lax.scan`` chunks, so a 16k-step run costs
O(T/chunk) host round-trips instead of 2 device syncs per step.

Literature: c_D,max = 3.22-3.24, c_L,max = 0.99-1.01, St = 0.295-0.305.

Usage: python benchmarks/dfg_2d2.py [T_end] [resolution] [dt] [resume.npz]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # runnable from any cwd

import json
import os
import sys
import time

import numpy as np

CHUNK = 200  # scan steps per host round-trip


def main(t_end=80.0, resolution=1.3, dt=0.005, resume=None,
         base_only=False):
    import jax
    import jax.numpy as jnp
    from jax import lax

    from navierstokes_tpu import config
    from navierstokes_tpu.assembly.fastop import FastTaylorHood, conv_apply
    from navierstokes_tpu.fem.bcs import PressureBCType, VelocityBCType
    from navierstokes_tpu.fem.dirichlet import compile_dirichlet_bcs
    from navierstokes_tpu.fem.spaces import TaylorHoodSpace
    from navierstokes_tpu.mesh import channel_with_cylinder
    from navierstokes_tpu.solvers.planar_step import \
        build_planar_projection_step

    wake = float(os.environ.get("NS_DFG_WAKE", "1"))
    length = float(os.environ.get("NS_DFG_LENGTH", "22"))
    mesh, markers, bm = channel_with_cylinder(resolution, wake=wake,
                                              length=length)
    space = TaylorHoodSpace(mesh)
    print(f"cells={mesh.n_cells}, dofs={space.n_dofs}", flush=True)
    h = 4.1
    visc = 1.0 / 100.0

    def inlet(x):
        s = x[:, 1] / h
        return np.stack([6.0 * s * (1.0 - s), np.zeros(len(x))], axis=1)

    vbc, _ = compile_dirichlet_bcs(space, markers, [
        (VelocityBCType.function, bm["inlet"], inlet),
        (VelocityBCType.no_slip, bm["cylinder"], None),
        (VelocityBCType.no_slip, bm["upper wall"], None),
        (VelocityBCType.no_slip, bm["lower wall"], None)], [])
    pbc, _ = compile_dirichlet_bcs(space, markers, [], [
        (PressureBCType.constant, bm["outlet"], 0.0)])

    n_u = space.n_velocity_dofs
    v_mask = np.zeros(n_u, bool)
    v_mask[np.asarray(vbc.dofs)] = True
    v_vals = np.zeros(n_u)
    v_vals[np.asarray(vbc.dofs)] = vbc.values()
    p_mask = np.zeros(space.n_pnodes, bool)
    p_mask[np.asarray(pbc.dofs) - space.pressure_offset] = True

    fast = FastTaylorHood(space)
    to_planar = lambda flat: np.asarray(flat).reshape(
        space.n_unodes, space.dim).T[:, fast.permU]
    # AMG V-cycle on the pressure Poisson (symmetric Dirichlet outlet):
    # ~30 preconditioned iterations replace 250 Jacobi-CG sweeps per
    # step (NS_DFG_AMG=0 reverts to the Jacobi path)
    use_amg = os.environ.get("NS_DFG_AMG", "1") == "1"
    cg_iters = tuple(int(v) for v in os.environ.get(
        "NS_DFG_CG", "16,14,8" if use_amg else "18,250,10").split(","))
    rotational = os.environ.get("NS_DFG_SCHEME", "") == "rotational"
    # NS_DFG_OUTFLOW=neumann: natural (d phi/dn = 0) outflow pressure in
    # the projection Poisson instead of the phi = 0 Dirichlet pin -- the
    # pressure level floats (mean-free solve); forces and dP are
    # level-invariant.  Isolates the outflow-condition sensitivity of
    # the lift amplitude (docs/VALIDATION.md, sensitivity matrix).
    neumann_out = os.environ.get("NS_DFG_OUTFLOW", "") == "neumann"
    step = build_planar_projection_step(
        fast, visc=visc, dt=dt, cg_iters=cg_iters,
        vel_bc=(to_planar(v_mask), to_planar(v_vals)),
        pres_bc_mask=None if neumann_out
        else np.asarray(p_mask)[fast.permP],
        poisson_precond="amg" if use_amg else None,
        rotational=rotational)
    if neumann_out:
        print("outflow: natural (Neumann) pressure", flush=True)
    if rotational:
        print("scheme: rotational (Timmermans) pressure update", flush=True)

    # cylinder nodes in the engine's permuted numbering; the reaction is
    # the monolithic residual summed over them (banded operators only)
    cyl_nodes = np.asarray(space.facet_unodes(
        markers.ids_with_value(bm["cylinder"])))
    cyl_perm = jnp.asarray(fast.invU[cyl_nodes])

    # Schafer-Turek pressure-difference probes at the front/back stagnation
    # points (1.5, 2) / (2.5, 2): exact P1 interpolation in the containing
    # cells (cell + barycentric weights extracted once on the host; the
    # in-scan evaluation is a 3-point dot product).  With the even cylinder
    # polygon count both points are vertices and the weights are one-hot.
    # Literature (2D-2): dP(t0 + T/2) in [2.46, 2.50], t0 = time of max lift.
    from navierstokes_tpu.fem import elements
    probe_pts = np.array([[1.5, 2.0], [2.5, 2.0]])
    pcells, pxi = space._locate_cells(probe_pts)
    pN, _ = elements.tabulate(1, pxi, space.dim)
    probe_idx = jnp.asarray(fast.invP[space.cell_pnodes[np.asarray(pcells)]])
    probe_w = jnp.asarray(np.asarray(pN), config.default_dtype())

    def reaction(ops, u_new, p, u_n, u_nm1, a, k):
        # form the O(1) BDF combination FIRST, then apply M once: three
        # separate M terms scaled by a0/k = 300 amplify f32 round-off
        # ~300x into the nodal reactions (measured sigma = 0.034 on c_D
        # step-to-step -- larger than the physical per-step change)
        dudt = (a[0] * u_new + a[1] * u_n + a[2] * u_nm1) / k
        r = (ops.M.apply(dudt)
             + conv_apply(ops, u_new, 1.0)
             + visc * ops.K.apply(u_new)
             + jnp.stack([G.apply(p) for G in ops.G], axis=0))
        return -r[:, cyl_perm].sum(axis=1)

    dtype = config.default_dtype()
    one = lambda v: jnp.asarray(v, dtype)
    a1 = (one(1.0), one(-1.0), one(0.0))
    e1 = (one(1.0), one(0.0))
    a2 = (one(1.5), one(-2.0), one(0.5))
    e2 = (one(2.0), one(-1.0))
    kk = one(dt)

    # operators/masks enter the scan program as ARGUMENTS (a closure
    # would embed the band arrays as HLO constants)
    from navierstokes_tpu.solvers.planar_step import _step_core

    @jax.jit
    def chunk(ops, masks, state):
        def body(carry, _):
            u, u_old, p, phi = carry
            u_new, p_new, phi_new = _step_core(
                ops, masks, u, u_old, p, phi, a2, e2, None, kk, None,
                with_residuals=False, **step.static)
            F = reaction(ops, u_new, p_new, u, u_old, a2, kk)
            dP = (probe_w[0] @ p_new[probe_idx[0]]
                  - probe_w[1] @ p_new[probe_idx[1]])
            return (u_new, u, p_new, phi_new), \
                jnp.concatenate([2.0 * F, dP[None]])

        state, forces = lax.scan(body, state, None, length=CHUNK)
        return state, forces

    t_start = 0.0
    if resume is not None:
        data = np.load(resume)
        assert float(data["resolution"]) == resolution
        if "wake" in data:
            assert float(data["wake"]) == wake, (float(data["wake"]), wake)
        u = fast.permute_velocity(jnp.asarray(
            np.asarray(data["u"]).reshape(-1, space.dim).T, dtype))
        u_old = fast.permute_velocity(jnp.asarray(
            np.asarray(data["u_old"]).reshape(-1, space.dim).T, dtype))
        p = fast.permute_pressure(jnp.asarray(data["p"], dtype))
        phi = fast.permute_pressure(jnp.asarray(data["phi"], dtype))
        t_start = float(data["t"])
        print(f"resumed from t={t_start}", flush=True)
    else:
        # initial state: the (unstable) steady solution at Re=100 via a
        # Reynolds ramp, plus an antisymmetric wake perturbation seeding
        # the shedding instability (avoids the impulsive-start transient)
        from navierstokes_tpu.solvers import StationarySolver

        print("computing steady base flow (Reynolds ramp)...", flush=True)
        # backend-appropriate tolerance: the base flow only seeds the
        # transient (it is perturbed by O(0.25) wake blobs below)
        steady = StationarySolver(mesh, markers, tol=config.default_tol())
        steady.set_boundary_conditions(
            ((VelocityBCType.function, bm["inlet"], inlet),
             (VelocityBCType.no_slip, bm["cylinder"], None),
             (VelocityBCType.no_slip, bm["upper wall"], None),
             (VelocityBCType.no_slip, bm["lower wall"], None),
             (PressureBCType.constant, bm["outlet"], 0.0)))
        for Re in (20.0, 50.0, 100.0):
            steady.set_equation_coefficients(
                {"convective_term": 1.0, "viscous_term": 1.0 / Re,
                 "pressure_term": 1.0, "coriolis_term": None,
                 "euler_term": None, "body_force_term": None})
            steady.solve()
            print(f"  steady Re={Re} done", flush=True)
        u_steady, p_steady = space.split(steady.solution)

        coords = space.u_coords
        wake_env = (np.exp(-((coords[:, 1] - 2.0) / 0.8) ** 2)
                    * (coords[:, 0] > 2.5) * (coords[:, 0] < 16.0))
        street = np.sin(2.0 * np.pi * (coords[:, 0] - 2.5) / 3.3)
        perturb = np.zeros((space.n_unodes, 2))
        perturb[:, 1] = 0.25 * wake_env * street
        u0 = np.asarray(u_steady) + perturb
        u0.reshape(-1)[v_mask] = v_vals[v_mask]
        u = fast.permute_velocity(jnp.asarray(u0.T, dtype))
        u_old = u
        p = fast.permute_pressure(jnp.asarray(p_steady, dtype))
        phi = jnp.zeros_like(p)
        # one BDF-1 startup step outside the scan
        u_new, p, phi = step(u, u_old, p, phi, a1, e1)
        u_old, u = u, u_new
        t_start = dt
        if base_only:
            # save the perturbed started state for a device resume run --
            # the steady ramp is the fragile part at scale; computing it
            # on a float64 CPU and resuming on the GPU splits the risk
            os.makedirs("results", exist_ok=True)
            out = f"results/dfg_2d2_base_res{resolution:g}.npz"
            np.savez(out,
                     u=np.asarray(fast.unpermute_velocity(u).T.reshape(-1)),
                     u_old=np.asarray(
                         fast.unpermute_velocity(u_old).T.reshape(-1)),
                     p=np.asarray(fast.unpermute_pressure(p)),
                     phi=np.asarray(fast.unpermute_pressure(phi)),
                     t=t_start, resolution=resolution, wake=wake)
            print(f"base state saved to {out}", flush=True)
            return None

    n_steps = int(round((t_end - t_start) / dt))
    n_chunks = max(n_steps // CHUNK, 1)
    series = np.zeros((n_chunks * CHUNK, 4))
    state = (u, u_old, p, phi)

    os.makedirs("results", exist_ok=True)
    suffix = "" if resolution == 1.3 else f"_res{resolution:g}"
    if wake != 1.0:
        suffix += f"_w{wake:g}"
    if dt != 0.005:
        suffix += f"_dt{dt:g}"
    if length != 22.0:
        suffix += f"_L{length:g}"
    if os.environ.get("NS_DFG_SUFFIX"):
        suffix += "_" + os.environ["NS_DFG_SUFFIX"]
    prev = None
    if resume is not None:
        prev = np.loadtxt("results/dfg_2d2_coefficients%s.txt" % suffix) \
            if os.path.exists("results/dfg_2d2_coefficients%s.txt" % suffix) \
            else None
    if prev is not None and prev.ndim == 2 and prev.shape[1] < 4:
        # older series predate the dP column: pad with NaN
        pad = np.full((len(prev), 4 - prev.shape[1]), np.nan)
        prev = np.hstack([prev, pad])

    def save(series_done, st):
        uu, uo, pp, ff = st
        full = series_done if prev is None \
            else np.vstack([prev, series_done])
        np.savetxt(f"results/dfg_2d2_coefficients{suffix}.txt", full)
        np.savez(f"results/dfg_2d2_state{suffix}.npz",
                 u=np.asarray(fast.unpermute_velocity(uu).T.reshape(-1)),
                 u_old=np.asarray(
                     fast.unpermute_velocity(uo).T.reshape(-1)),
                 p=np.asarray(fast.unpermute_pressure(pp)),
                 phi=np.asarray(fast.unpermute_pressure(ff)),
                 t=series_done[-1, 0], resolution=resolution, wake=wake)

    t0 = time.time()
    for c in range(n_chunks):
        state, forces = chunk(step.ops, step.masks, state)
        f = np.asarray(forces)
        i0 = c * CHUNK
        series[i0:i0 + CHUNK, 0] = t_start + dt * np.arange(1, CHUNK + 1) \
            + c * CHUNK * dt
        series[i0:i0 + CHUNK, 1:] = f
        if not np.all(np.isfinite(f)):
            print("diverged", flush=True)
            series = series[:i0 + CHUNK]
            break
        if (c + 1) % 10 == 0:
            done = (c + 1) * CHUNK
            print(f"t={series[i0 + CHUNK - 1, 0]:7.2f}  "
                  f"c_D={f[-1, 0]:7.4f}  c_L={f[-1, 1]:8.4f}  "
                  f"[{(time.time() - t0) / done * 1e3:.2f} ms/step]",
                  flush=True)
            # periodic checkpoint: long runs survive wall-clock kills and
            # resume from the latest saved state
            save(series[:i0 + CHUNK], state)

    series = series[:np.count_nonzero(series[:, 0])]
    save(series, state)

    # evaluate over the final window (shedding fully developed)
    window = series[series[:, 0] > series[-1, 0] - 20.0]
    if len(window) > 100:
        cd_max = window[:, 1].max()
        cl_max = window[:, 2].max()
        cl = window[:, 2] - window[:, 2].mean()
        freqs = np.fft.rfftfreq(len(cl), d=dt)
        amp = np.abs(np.fft.rfft(cl))
        St = float(freqs[np.argmax(amp[1:]) + 1])
        result = {"cd_max": round(float(cd_max), 4),
                  "cl_max": round(float(cl_max), 4),
                  "strouhal": round(St, 4),
                  "dofs": space.n_dofs, "dt": dt,
                  "t_end": float(series[-1, 0]),
                  "lit_cd": [3.22, 3.24], "lit_cl": [0.99, 1.01],
                  "lit_st": [0.295, 0.305]}
        # certification-grade on-chip maxima: harmonic least-squares fit
        # (utils/signal.py) removes both the per-step f32 solver noise
        # AND the extreme-value bias of the raw max -- validated to
        # <=0.1% against f64 re-marches of the same trajectory
        # (docs/VALIDATION.md)
        try:
            from navierstokes_tpu.utils.signal import (periodic_eval,
                                                       periodic_fit)

            fit_d = periodic_fit(window[:, 0], window[:, 1], K=10)
            fit_l = periodic_fit(window[:, 0], window[:, 2], K=10)
            result["cd_max_fit"] = round(fit_d["max"], 4)
            result["cl_max_fit"] = round(fit_l["max"], 4)
            result["st_fit"] = round(fit_l["freq"], 4)
            result["fit_sigma"] = [round(fit_d["sigma"], 5),
                                   round(fit_l["sigma"], 5)]
            if np.all(np.isfinite(window[:, 3])):
                fit_p = periodic_fit(window[:, 0], window[:, 3], K=10,
                                     f0=fit_l["freq"], refine=1e-6)
                t_half = fit_l["argmax"] + 0.5 / fit_l["freq"]
                result["dP_fit"] = round(
                    float(periodic_eval(fit_p, t_half)[0]), 4)
        except Exception as exc:  # fit is advisory: never kill the run
            result["fit_error"] = str(exc)
        if St > 0:
            # noise-robust envelope: median of per-period maxima.  On
            # f32 chips the per-step reactions carry solver-truncation
            # noise scaling with alpha0/dt, which biases the global
            # window max upward; the median over whole shedding periods
            # is insensitive to it (validation-grade numbers still come
            # from f64 windows)
            T = 1.0 / St
            tw = window[:, 0]
            n_per = int((tw[-1] - tw[0]) / T)
            if n_per >= 2:
                cdm, clm = [], []
                for j in range(n_per):
                    seg = window[(tw >= tw[0] + j * T)
                                 & (tw < tw[0] + (j + 1) * T)]
                    if len(seg):
                        cdm.append(seg[:, 1].max())
                        clm.append(seg[:, 2].max())
                result["cd_max_median"] = round(float(np.median(cdm)), 4)
                result["cl_max_median"] = round(float(np.median(clm)), 4)
                result["n_periods"] = n_per
        # dP(t0 + T/2), t0 = time of max lift inside the window
        if np.all(np.isfinite(window[:, 3])) and St > 0:
            i0 = int(np.argmax(window[:, 2]))
            i_half = i0 + int(round(0.5 / St / dt))
            if i_half < len(window):
                result["dP"] = round(float(window[i_half, 3]), 4)
                result["lit_dP"] = [2.46, 2.50]
        print(json.dumps(result))
    return series


if __name__ == "__main__":
    args = [a for a in sys.argv[1:]
            if a not in ("--base-only", "--cpu")]
    base_only = "--base-only" in sys.argv[1:]
    if "--cpu" in sys.argv[1:]:
        # validation-grade run off the GPU: float64 CPU backend
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    t_end = float(args[0]) if len(args) > 0 else 80.0
    res = float(args[1]) if len(args) > 1 else 1.3
    dt = float(args[2]) if len(args) > 2 else 0.005
    resume = args[3] if len(args) > 3 else None
    main(t_end, res, dt, resume, base_only=base_only)
