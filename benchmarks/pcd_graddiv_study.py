#!/usr/bin/env python3
"""Re-envelope study: PCD vs grad-div/augmented-Lagrangian PCD.

Does an AL (grad-div) option extend direct
Newton+FGMRES solves past the Re ~ 300 stall of plain PCD
(docs/VALIDATION.md preconditioner table)?  For each Reynolds number the
cavity is solved by Reynolds continuation (each stage seeds the next);
per stage we record every linear solve's FGMRES iteration count.  A
stage "fails" when the nonlinear solve does not reach tol.

Usage: python benchmarks/pcd_graddiv_study.py [n] [gamma ...]
       (CPU f64; e.g. `python benchmarks/pcd_graddiv_study.py 64 0 1`)
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # runnable from any cwd

import json
import os
import sys
import time

import numpy as np


def run(n, gamma, re_stages):
    os.environ["NS_PCD_GRAD_DIV"] = str(gamma)
    from navierstokes_tpu.fem.bcs import VelocityBCType
    from navierstokes_tpu.mesh import HyperCubeBoundaryMarkers as M
    from navierstokes_tpu.mesh import hyper_cube
    from navierstokes_tpu.solvers import StationarySolver

    mesh, markers = hyper_cube(2, n)
    solver = StationarySolver(mesh, markers, tol=1e-10,
                              linear_solver="pcd")
    solver.set_boundary_conditions(
        ((VelocityBCType.no_slip, M.left.value, None),
         (VelocityBCType.no_slip, M.right.value, None),
         (VelocityBCType.no_slip, M.bottom.value, None),
         (VelocityBCType.constant, M.top.value, (1.0, 0.0))))

    rows = []
    for Re in re_stages:
        solver.set_equation_coefficients(
            {"convective_term": 1.0, "viscous_term": 1.0 / Re,
             "pressure_term": 1.0, "coriolis_term": None,
             "euler_term": None, "body_force_term": None})
        n0 = len(solver.monitor.records)
        t0 = time.time()
        try:
            solver.solve()
            ok = True
        except Exception as exc:
            ok = False
            err = f"{type(exc).__name__}: {exc}"
        wall = time.time() - t0
        lin = [r for r in solver.monitor.records[n0:]
               if r.get("kind") == "linear_solve"]
        its = [int(r.get("iterations", -1)) for r in lin]
        row = {"Re": Re, "gamma": gamma, "ok": ok,
               "newton_steps": len(its), "fgmres_its": its,
               "total_its": int(np.sum(its)) if its else 0,
               "wall_s": round(wall, 1)}
        if not ok:
            row["error"] = err
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not ok:
            break
    return rows


def main():
    # validation-grade study: f64 on the CPU backend
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    gammas = [float(g) for g in sys.argv[2:]] or [0.0, 1.0]
    re_stages = [float(v) for v in os.environ.get(
        "NS_PCD_STAGES", "100,215,300,464,700,1000").split(",")]
    all_rows = {}
    for g in gammas:
        print(f"# gamma = {g}, grid {n}^2", flush=True)
        all_rows[g] = run(n, g, re_stages)
    # durable-results rule: study output is committed documentation data
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "data",
        f"pcd_graddiv_{n}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump({str(g): r for g, r in all_rows.items()}, fh, indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
