#!/usr/bin/env python3
"""Lid-driven cavity at Re=1000: LU-free contract + Ghia refinement study.

The reference meets ||F||_2 <= 1e-10 at any Reynolds number a
workstation's sparse LU can factor (ns_solver_base.py:938-988, with the
Re-continuation of ns_problem.py:478-501).  This script demonstrates the
LU-free chain at Re=1000 on the device:

  1. Reynolds continuation with plain Picard->Newton (AMG-PCD FGMRES)
     while the steady Newton systems stay inside the PCD envelope;
  2. pseudo-transient continuation (solve_ptc) beyond it -- every system
     carries a sigma*M shift and stays solvable at any Re;
  3. Newton handoff (solve) from the PTC state once the iterate is inside
     the attraction basin -- on resolved meshes the full-accuracy finish;
  4. on float32 devices, solve_refined closes to the f64 1e-10 contract.

Also records the Ghia et al. (1982) centerline extrema over a mesh
refinement sequence (u_min -> -0.3829 at x=0.5).

Usage: python benchmarks/cavity_re1000.py [N ...]   (default 64 128)
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # runnable from any cwd

import json
import os
import sys
import time

import numpy as np


GHIA_RE1000 = {"u_min": -0.38289, "y_at_umin": 0.1717}


def _cavity_bcs():
    from navierstokes_tpu.fem.bcs import PressureBCType, VelocityBCType
    from navierstokes_tpu.mesh.generators import \
        HyperCubeBoundaryMarkers as M

    lid = lambda x: np.stack([np.ones(len(x)), np.zeros(len(x))], axis=1)
    return ((VelocityBCType.no_slip, M.left.value, None),
            (VelocityBCType.no_slip, M.right.value, None),
            (VelocityBCType.no_slip, M.bottom.value, None),
            (VelocityBCType.function, M.top.value, lid),
            (PressureBCType.mean_value, None, 0.0))


def centerline_umin(space, x_flat):
    u = np.asarray(x_flat[:space.n_velocity_dofs],
                   dtype=np.float64).reshape(-1, space.dim)
    coords = space.u_coords
    on_cl = np.abs(coords[:, 0] - 0.5) < 1e-9
    ys, ux = coords[on_cl, 1], u[on_cl, 0]
    order = np.argsort(ys)
    ys, ux = ys[order], ux[order]
    i = int(np.argmin(ux))
    return float(ux[i]), float(ys[i])


def _lattice_order(coords, m):
    """Permutation taking node order -> row-major (ix*(m+1)+iy) lattice
    order on a uniform unit-square grid with spacing 1/m."""
    ij = np.rint(coords * m).astype(int)
    key = ij[:, 0] * (m + 1) + ij[:, 1]
    order = np.argsort(key)
    assert np.array_equal(key[order], np.arange((m + 1) ** 2))
    return order


def _resample(grid_vals, m_from, m_to):
    """Bilinear resample (m_from+1)^2 lattice values to (m_to+1)^2."""
    grid = grid_vals.reshape(m_from + 1, m_from + 1, -1)
    s = np.linspace(0.0, m_from, m_to + 1)
    i0 = np.clip(np.floor(s).astype(int), 0, m_from - 1)
    w = s - i0
    gx = grid[i0] * (1 - w)[:, None, None] + grid[i0 + 1] * w[:, None, None]
    gy = (gx[:, i0] * (1 - w)[None, :, None]
          + gx[:, i0 + 1] * w[None, :, None])
    return gy.reshape((m_to + 1) ** 2, -1)


def interp_cavity_state(space1, x1, n1, space2, n2):
    """Bilinearly interpolate a flat mixed cavity state between uniform
    hyper_cube Taylor-Hood lattices (P2 nodes fill the half-step lattice
    i/(2n), P1 nodes the full-step lattice i/n) -- a coarse steady state
    seeds the fine march, so each refinement costs a short settle instead
    of a full transient."""
    dim = space1.dim
    u1 = x1[:dim * space1.n_unodes].reshape(space1.n_unodes, dim)
    p1 = x1[dim * space1.n_unodes:]
    u2 = np.empty((space2.n_unodes, dim))
    p2 = np.empty(space2.n_pnodes)
    u2[_lattice_order(space2.u_coords, 2 * n2)] = \
        _resample(u1[_lattice_order(space1.u_coords, 2 * n1)], 2 * n1, 2 * n2)
    p2[_lattice_order(space2.p_coords, n2)] = \
        _resample(p1[_lattice_order(space1.p_coords, n1), None],
                  n1, n2)[:, 0]
    return np.concatenate([u2.reshape(-1), p2])


def march_to_steady(n_cells, re_target=1000.0, dt=None, t_max=250.0,
                    cg_iters=(18, 300, 10), settle_tol=3e-6, x0=None,
                    _retries=2):
    """Banded SBDF-2 pseudo-time march to the steady cavity state.

    The device-side globalization: instead of the reference's LU-backed
    Reynolds continuation (ns_problem.py:478-501), ride the gather-free
    projection engine to the steady attractor -- the
    cavity is stable at Re=1000, so the transient path IS the continuation.
    Returns the mixed-space state vector (host float64) for the Newton /
    refinement stages plus the marched centerline extremum.

    ``x0``: optional flat mixed state (e.g. interpolated from a coarser
    lattice) seeding the march.  SBDF-2's explicit convection limits the
    advective CFL; on divergence (NaN) the march auto-retries at dt/2.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from navierstokes_tpu import config
    from navierstokes_tpu.assembly.fastop import FastTaylorHood
    from navierstokes_tpu.fem.dirichlet import compile_dirichlet_bcs
    from navierstokes_tpu.fem.spaces import TaylorHoodSpace
    from navierstokes_tpu.mesh import hyper_cube
    from navierstokes_tpu.solvers.planar_step import (
        _step_core, build_planar_projection_step)

    mesh, markers = hyper_cube(2, n_cells)
    space = TaylorHoodSpace(mesh)
    vbc, _ = compile_dirichlet_bcs(space, markers, list(_cavity_bcs()[:4]),
                                   [])
    n_u = space.n_velocity_dofs
    v_mask = np.zeros(n_u, bool)
    v_mask[np.asarray(vbc.dofs)] = True
    v_vals = np.zeros(n_u)
    v_vals[np.asarray(vbc.dofs)] = vbc.values()

    fast = FastTaylorHood(space)
    to_planar = lambda flat: np.asarray(flat).reshape(
        space.n_unodes, space.dim).T[:, fast.permU]
    if dt is None:
        # SBDF-2 convection is explicit: CFL on the P2 node spacing
        # h/2 = 1/(2 n) with |u| <= 1 (lid speed).  0.25 rather than the
        # advective limit: at Re=1000 the grid-Peclet modes see almost no
        # implicit viscous damping, and the extrapolated convection is
        # only neutrally stable on the imaginary axis (CFL 0.6 diverged
        # at t~30 on 64^2)
        dt = 0.25 / (2.0 * n_cells)
    # AMG V-cycle on the pressure Poisson: ~30 preconditioned iterations
    # replace the 300 Jacobi-CG sweeps per step (NS_CAVITY_AMG=0 reverts)
    use_amg = os.environ.get("NS_CAVITY_AMG", "1") == "1"
    if use_amg:
        cg_iters = (cg_iters[0], min(cg_iters[1], 30), cg_iters[2])
    step = build_planar_projection_step(
        fast, visc=1.0 / re_target, dt=dt, cg_iters=cg_iters,
        vel_bc=(to_planar(v_mask), to_planar(v_vals)), pres_bc_mask=None,
        poisson_precond="amg" if use_amg else None)

    dtype = config.default_dtype()
    one = lambda v: jnp.asarray(v, dtype)
    a1 = (one(1.0), one(-1.0), one(0.0))
    e1 = (one(1.0), one(0.0))
    a2 = (one(1.5), one(-2.0), one(0.5))
    e2 = (one(2.0), one(-1.0))
    kk = one(dt)

    # one scan chunk = one device dispatch; shorter chunks at large N
    # keep the progress reports and checkpoints frequent
    chunk_len = int(os.environ.get("NS_MARCH_CHUNK",
                                   "500" if n_cells <= 128 else "125"))

    @jax.jit
    def chunk(ops, masks, state):
        def body(carry, _):
            u, u_old, p, phi = carry
            u_new, p_new, phi_new = _step_core(
                ops, masks, u, u_old, p, phi, a2, e2, None, kk, None,
                with_residuals=False, **step.static)
            return (u_new, u, p_new, phi_new), None

        state, _ = lax.scan(body, state, None, length=chunk_len)
        return state

    # mid-march checkpoint: long marches at 256^2+ run for hours, so
    # progress is persisted every ``ckpt_every`` chunks and picked up on
    # relaunch (the permutation is deterministic
    # for a given lattice, so the permuted planar arrays round-trip)
    ckpt_path = f"results/cavity_march_ckpt_N{n_cells}.npz"
    ckpt_every = int(os.environ.get("NS_MARCH_CKPT_EVERY", "20"))
    start_chunk = 0
    state = None
    if os.path.exists(ckpt_path):
        d = np.load(ckpt_path)
        if float(d["dt"]) == dt:
            state = tuple(jnp.asarray(d[k], dtype)
                          for k in ("u", "u_old", "p", "phi"))
            done_steps = (int(d["done_steps"]) if "done_steps" in d
                          else int(d["done_chunks"]) * 500)
            start_chunk = done_steps // chunk_len
            print(f"[N={n_cells}] march resumed from checkpoint at "
                  f"t={start_chunk * chunk_len * dt:.1f}", flush=True)
        else:
            os.remove(ckpt_path)  # stale (e.g. pre-dt-halving retry)
    if state is None:
        if x0 is not None:
            u0 = np.array(x0[:space.n_velocity_dofs]).reshape(
                -1, space.dim)
            p0 = np.array(x0[space.n_velocity_dofs:])
        else:
            u0 = np.zeros((space.n_unodes, space.dim))
            p0 = np.zeros(space.n_pnodes)
        u0.reshape(-1)[v_mask] = v_vals[v_mask]
        u = fast.permute_velocity(jnp.asarray(u0.T, dtype))
        p = fast.permute_pressure(jnp.asarray(p0, dtype))
        phi = jnp.zeros_like(p)
        # BDF-1 startup
        u_new, p, phi = step(u, u, p, phi, a1, e1)
        state = (u_new, u, p, phi)

    t0 = time.time()
    n_chunks = int(np.ceil(t_max / (chunk_len * dt)))
    u_prev = np.asarray(state[0], np.float64)
    rate = np.inf
    done_chunks = start_chunk
    for c in range(start_chunk, n_chunks):
        state = chunk(step.ops, step.masks, state)
        done_chunks = c + 1
        u_now = np.asarray(state[0], np.float64)
        if not np.isfinite(u_now).all():
            if os.path.exists(ckpt_path):
                os.remove(ckpt_path)
            if _retries > 0:
                print(f"[N={n_cells}] march diverged at dt={dt:g}; "
                      "retrying at dt/2", flush=True)
                return march_to_steady(n_cells, re_target, dt / 2.0, t_max,
                                       cg_iters, settle_tol, x0,
                                       _retries - 1)
            raise RuntimeError(f"march diverged at N={n_cells}, dt={dt:g}")
        rate = float(np.max(np.abs(u_now - u_prev))) / (chunk_len * dt)
        u_prev = u_now
        if c == start_chunk or (c + 1) % 10 == 0 or rate < settle_tol:
            t_now = (c + 1) * chunk_len * dt
            ms = (time.time() - t0) / ((c + 1 - start_chunk)
                                       * chunk_len) * 1e3
            print(f"  march t={t_now:7.1f}  max|du/dt|={rate:.2e}  "
                  f"[{ms:.2f} ms/step]", flush=True)
        if (c + 1) % ckpt_every == 0 and rate >= settle_tol:
            os.makedirs("results", exist_ok=True)
            np.savez(ckpt_path, u=np.asarray(state[0]),
                     u_old=np.asarray(state[1]), p=np.asarray(state[2]),
                     phi=np.asarray(state[3]), dt=dt,
                     done_steps=(c + 1) * chunk_len)
        if rate < settle_tol:
            break
    if os.path.exists(ckpt_path):
        os.remove(ckpt_path)
    u_fin, _, p_fin, _ = state
    u_host = np.asarray(fast.unpermute_velocity(u_fin),
                        np.float64).T.reshape(-1)
    p_host = np.array(fast.unpermute_pressure(p_fin), np.float64)
    p_host -= p_host.mean()
    x = np.concatenate([u_host, p_host])
    u_min, y_at = centerline_umin(space, x)
    info = {"stage": "march", "dt": dt,
            "steps": done_chunks * chunk_len,
            "settle_rate": rate, "u_min": u_min, "y_at_umin": y_at,
            "seconds": round(time.time() - t0, 1)}
    print(f"[N={n_cells}] march done u_min={u_min:.4f} "
          f"(rate {rate:.1e}, {info['steps']} steps, "
          f"{info['seconds']}s)", flush=True)
    return x, info


def _build_solver(n_cells, re_target=1000.0, maxiter_newton=40):
    from navierstokes_tpu import config
    from navierstokes_tpu.fem.bcs import PressureBCType, VelocityBCType
    from navierstokes_tpu.mesh import hyper_cube
    from navierstokes_tpu.mesh.generators import \
        HyperCubeBoundaryMarkers as M
    from navierstokes_tpu.solvers import StationarySolver

    mesh, markers = hyper_cube(2, n_cells)
    solver = StationarySolver(mesh, markers, tol=config.default_tol(),
                              maxiter=maxiter_newton)
    lid = lambda x: np.stack([np.ones(len(x)), np.zeros(len(x))], axis=1)
    solver.set_boundary_conditions(
        ((VelocityBCType.no_slip, M.left.value, None),
         (VelocityBCType.no_slip, M.right.value, None),
         (VelocityBCType.no_slip, M.bottom.value, None),
         (VelocityBCType.function, M.top.value, lid),
         (PressureBCType.mean_value, None, 0.0)))
    solver.set_equation_coefficients(
        {"convective_term": 1.0, "viscous_term": 1.0 / re_target,
         "pressure_term": 1.0, "coriolis_term": None,
         "euler_term": None, "body_force_term": None})
    return solver


def run_stage(n_cells, stage, re_target=1000.0):
    """Run ONE solver stage; returns its info dict.

    The marched / intermediate states are bitwise round-tripped through
    ``results/cavity_stage_N{n}.npz`` (f64 host arrays), so a stage can
    resume from the previous one's saved state.
    """
    import jax.numpy as jnp

    from navierstokes_tpu import config

    solver = _build_solver(n_cells, re_target)
    solver._setup_problem()
    state_file = f"results/cavity_stage_N{n_cells}.npz"
    src = (f"results/cavity_steady_N{n_cells}.npz" if stage == "ptc"
           else state_file)
    x0 = np.load(src)["x"]
    solver._solution = jnp.asarray(x0, config.default_dtype())

    t0 = time.time()
    if stage == "ptc":
        solver.solve_ptc(tol=3e-5, sigma0=1.0, sigma_min=1e-3,
                         maxiter=200, lin_tol=1e-3)
        rec = solver.monitor.records[-1]
        info = {"stage": f"ptc Re={re_target:g}",
                "ptc_its": rec["iterations"],
                "linear_its": rec["linear_iterations"],
                "residual": float(rec["residual"])}
    elif stage == "ptc-deep":
        solver.solve_ptc(tol=3e-7, sigma0=0.5, sigma_min=1e-4,
                         maxiter=800, lin_tol=1e-4)
        rec = solver.monitor.records[-1]
        info = {"stage": f"ptc-deep Re={re_target:g}",
                "ptc_its": rec["iterations"],
                "residual": float(rec["residual"])}
    elif stage == "newton":
        solver.solve()
        rec = solver.monitor.records[-1]
        info = {"stage": f"newton-handoff Re={re_target:g}",
                "newton_its": rec.get("newton_iterations"),
                "residual": float(rec["residual"])}
    elif stage == "refined":
        solver.solve_refined(tol=1.0e-10)
        rec = solver.monitor.records[-1]
        info = {"stage": "refined", "refine_its": rec["iterations"],
                "residual_f64": float(rec["residual"])}
    else:
        raise SystemExit(f"unknown stage {stage!r}")
    info["seconds"] = round(time.time() - t0, 1)
    x = np.asarray(solver._solution, np.float64)
    u_min, y_at = centerline_umin(solver.space, x)
    info["u_min"], info["y_at_umin"] = u_min, y_at
    os.makedirs("results", exist_ok=True)
    np.savez(state_file, x=x, info=json.dumps(info))
    print("CAVITY_STAGE " + json.dumps(info), flush=True)
    return info


def run_cavity_staged(n_cells, re_target=1000.0):
    """March, then run the PTC / Newton / refined stages in turn, all in
    this process (one process per card)."""
    saved = f"results/cavity_steady_N{n_cells}.npz"
    log = {"n_cells": n_cells, "stages": []}
    if os.path.exists(saved):
        d = np.load(saved)
        info = json.loads(str(d["info"]))
        print(f"[N={n_cells}] reusing marched state {saved}", flush=True)
    else:
        x0, info = march_to_steady(n_cells, re_target)
        os.makedirs("results", exist_ok=True)
        np.savez(saved, x=x0, info=json.dumps(info))
    log["stages"].append(info)

    t0 = time.time()
    for stage, fallback in (("ptc", None), ("newton", "ptc-deep"),
                            ("refined", None)):
        try:
            info = run_stage(n_cells, stage, re_target)
        except (RuntimeError, AssertionError) as exc:
            if fallback is None:
                raise
            print(f"[N={n_cells}] stage {stage} declined ({exc}); "
                  f"falling back to {fallback}", flush=True)
            info = run_stage(n_cells, fallback, re_target)
        log["stages"].append(info)
        print(f"[N={n_cells}] {info['stage']}: "
              f"||F||={info.get('residual_f64', info.get('residual')):.2e} "
              f"({info['seconds']}s)", flush=True)
    log["u_min"] = info["u_min"]
    log["y_at_umin"] = info["y_at_umin"]
    log["ghia"] = GHIA_RE1000
    log["seconds"] = round(time.time() - t0, 1)
    print(json.dumps(log), flush=True)
    return log


def run_cavity(n_cells, re_target=1000.0, ramp=(100.0, 300.0),
               ptc_tol=3e-5, maxiter_newton=40, use_march=False):
    import jax.numpy as jnp

    from navierstokes_tpu import config
    from navierstokes_tpu.fem.bcs import PressureBCType, VelocityBCType
    from navierstokes_tpu.mesh import hyper_cube
    from navierstokes_tpu.mesh.generators import \
        HyperCubeBoundaryMarkers as M
    from navierstokes_tpu.solvers import StationarySolver

    mesh, markers = hyper_cube(2, n_cells)
    solver = StationarySolver(mesh, markers, tol=config.default_tol(),
                              maxiter=maxiter_newton)
    lid = lambda x: np.stack([np.ones(len(x)), np.zeros(len(x))], axis=1)
    solver.set_boundary_conditions(
        ((VelocityBCType.no_slip, M.left.value, None),
         (VelocityBCType.no_slip, M.right.value, None),
         (VelocityBCType.no_slip, M.bottom.value, None),
         (VelocityBCType.function, M.top.value, lid),
         (PressureBCType.mean_value, None, 0.0)))

    def set_re(re):
        solver.set_equation_coefficients(
            {"convective_term": 1.0, "viscous_term": 1.0 / re,
             "pressure_term": 1.0, "coriolis_term": None,
             "euler_term": None, "body_force_term": None})

    log = {"n_cells": n_cells, "stages": []}
    t0 = time.time()
    if use_march:
        # device-side globalization: banded transient march to the steady
        # attractor replaces the Newton Reynolds ramp (the cavity is
        # stable at Re=1000, so the transient path IS the continuation)
        saved = f"results/cavity_steady_N{n_cells}.npz"
        if os.path.exists(saved):
            d = np.load(saved)
            x0, info = d["x"], json.loads(str(d["info"]))
            print(f"[N={n_cells}] reusing marched state {saved}", flush=True)
        else:
            x0, info = march_to_steady(n_cells, re_target)
            os.makedirs("results", exist_ok=True)
            np.savez(saved, x=x0, info=json.dumps(info))
        log["stages"].append(info)
        set_re(re_target)
        solver._setup_problem()
        solver._solution = jnp.asarray(x0, config.default_dtype())
        sigma0, ptc_maxiter = 1.0, 200
    else:
        for re in ramp:
            set_re(re)
            solver.solve()
            rec = solver.monitor.records[-1]
            log["stages"].append(
                {"stage": f"newton Re={re:g}",
                 "newton_its": rec.get("newton_iterations"),
                 "residual": float(rec["residual"])})
            print(f"[N={n_cells}] Re={re:g} Newton done "
                  f"||F||={float(rec['residual']):.2e}", flush=True)
        sigma0, ptc_maxiter = 20.0, 400

    # stage 2: PTC at the target Reynolds number
    set_re(re_target)
    solver.solve_ptc(tol=ptc_tol, sigma0=sigma0, sigma_min=1e-3,
                     maxiter=ptc_maxiter, lin_tol=1e-3)
    rec = solver.monitor.records[-1]
    log["stages"].append({"stage": f"ptc Re={re_target:g}",
                          "ptc_its": rec["iterations"],
                          "linear_its": rec["linear_iterations"],
                          "residual": float(rec["residual"])})
    print(f"[N={n_cells}] PTC done ||F||={float(rec['residual']):.2e} "
          f"({rec['iterations']} steps)", flush=True)

    # stage 3: Newton handoff from the PTC iterate.  On meshes that do
    # not resolve the cell Peclet (<~2) the steady Newton systems sit
    # outside the PCD envelope -- deepen PTC instead and say so.
    try:
        solver.solve()
        rec = solver.monitor.records[-1]
        log["stages"].append({"stage": f"newton-handoff Re={re_target:g}",
                              "newton_its": rec.get("newton_iterations"),
                              "residual": float(rec["residual"])})
        print(f"[N={n_cells}] Newton handoff ||F||="
              f"{float(rec['residual']):.2e} "
              f"({rec.get('newton_iterations')} its)", flush=True)
    except (RuntimeError, AssertionError) as exc:
        print(f"[N={n_cells}] Newton handoff declined ({exc}); "
              "deepening PTC", flush=True)
        solver.solve_ptc(tol=3e-7, sigma0=0.5, sigma_min=1e-4,
                         maxiter=800, lin_tol=1e-4)
        rec = solver.monitor.records[-1]
        log["stages"].append({"stage": f"ptc-deep Re={re_target:g}",
                              "ptc_its": rec["iterations"],
                              "residual": float(rec["residual"])})
        print(f"[N={n_cells}] deep PTC ||F||="
              f"{float(rec['residual']):.2e}", flush=True)

    # stage 4: mixed-precision refinement to the f64 contract (no-op
    # check on an f64 backend)
    x = solver.solve_refined(tol=1.0e-10)
    rec = solver.monitor.records[-1]
    log["stages"].append({"stage": "refined",
                          "refine_its": rec["iterations"],
                          "residual_f64": float(rec["residual"])})
    print(f"[N={n_cells}] refined ||F||_f64="
          f"{float(rec['residual']):.2e}", flush=True)

    # Ghia centerline extrema: u_x along the vertical centerline x=0.5
    space = solver.space
    u = np.asarray(x[:space.n_velocity_dofs]).reshape(-1, space.dim)
    coords = space.u_coords
    on_cl = np.abs(coords[:, 0] - 0.5) < 1e-9
    ys = coords[on_cl, 1]
    ux = u[on_cl, 0]
    order = np.argsort(ys)
    ys, ux = ys[order], ux[order]
    i_min = int(np.argmin(ux))
    log["u_min"] = float(ux[i_min])
    log["y_at_umin"] = float(ys[i_min])
    log["ghia"] = GHIA_RE1000
    log["seconds"] = round(time.time() - t0, 1)
    print(json.dumps(log), flush=True)
    return log


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if "--cpu" in sys.argv[1:]:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    sizes = [int(a) for a in args] or [64, 128]
    if "--ghia" in sys.argv[1:]:
        # refinement table: march each size to steady and record the Ghia
        # centerline extremum.  Sizes cascade -- each fine march is seeded
        # by the bilinearly interpolated coarser steady state, so only the
        # coarsest pays the full transient
        from navierstokes_tpu.fem.spaces import TaylorHoodSpace
        from navierstokes_tpu.mesh import hyper_cube

        rows, prev = [], None
        for n in sizes:
            space_n = TaylorHoodSpace(hyper_cube(2, n)[0])
            x0 = None if prev is None else interp_cavity_state(
                prev[1], prev[2], prev[0], space_n, n)
            saved = f"results/cavity_steady_N{n}.npz"
            if os.path.exists(saved):
                d = np.load(saved)
                x, info = d["x"], json.loads(str(d["info"]))
                print(f"[N={n}] reusing {saved}", flush=True)
            else:
                x, info = march_to_steady(
                    n, t_max=(250.0 if x0 is None else 100.0), x0=x0)
                os.makedirs("results", exist_ok=True)
                np.savez(saved, x=x, info=json.dumps(info))
            prev = (n, space_n, x)
            rows.append({"n": n, "u_min": info["u_min"],
                         "y_at_umin": info["y_at_umin"],
                         "steps": info["steps"], "dt": info["dt"],
                         "seeded": x0 is not None,
                         "settle_rate": info["settle_rate"],
                         "seconds": info["seconds"]})
            print(json.dumps(rows[-1]), flush=True)
        print(json.dumps({"ghia_table": rows, "ghia": GHIA_RE1000}))
        return
    if "--march" in sys.argv[1:]:
        results = [run_cavity_staged(n) for n in sizes]
        print(json.dumps({"summary": [
            {"n": r["n_cells"], "u_min": r["u_min"],
             "residual_f64": r["stages"][-1]["residual_f64"]}
            for r in results]}))
        return
    use_march = False
    results = [run_cavity(n, use_march=use_march) for n in sizes]
    print(json.dumps({"summary": [
        {"n": r["n_cells"], "u_min": r["u_min"],
         "residual_f64": r["stages"][-1]["residual_f64"]}
        for r in results]}))


if __name__ == "__main__":
    main()
