#!/usr/bin/env python3
"""DFG 2D-1 steady cylinder benchmark (Re=20): drag/lift vs literature.

The stationary counterpart of the 2D-2 validation chain
(reference config: demo/dfg_benchmark.py geometry with the steady
Um=0.3 inlet of Schafer & Turek 1996).  Literature reference values:
c_D in [5.57, 5.59], c_L in [0.0104, 0.0110], dP in [0.1172, 0.1176]
(all x10 rescaled to this repo's unit-diameter geometry: coefficients
are dimensionless and unchanged; dP scales by Ubar^2 = 0.04).

The lift is 500x smaller than the drag and is the single most
geometry-sensitive quantity of the benchmark family: this script is the
cheap mesh-quality probe that exposed the res-2 cylinder ring artifact
behind the 2D-2 lift deficit (docs/VALIDATION.md) -- steady c_L across the
resolution ladder is non-monotonic (res 1.3: 0.01093 in, res 2:
0.01015 out, res 3: 0.01098 in) while c_D stays inside the interval
everywhere.

Usage: python benchmarks/dfg_2d1_steady.py [res ...]   (default ladder)
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # runnable from any cwd

import json
import sys


def run(res, pin_outlet=False):
    import numpy as np

    from navierstokes_tpu.fem.bcs import PressureBCType, VelocityBCType
    from navierstokes_tpu.mesh import channel_with_cylinder
    from navierstokes_tpu.solvers import StationarySolver

    h = 4.1

    def inlet(x):
        s = x[:, 1] / h
        # Um = 0.3 of the classic geometry -> 4*Um*s*(1-s), Re = 20
        return np.stack([1.2 * s * (1.0 - s), np.zeros(len(x))], axis=1)

    mesh, markers, bm = channel_with_cylinder(res)
    solver = StationarySolver(mesh, markers, tol=1e-10,
                              linear_solver="host_lu")
    bcs = [(VelocityBCType.function, bm["inlet"], inlet),
           (VelocityBCType.no_slip, bm["cylinder"], None),
           (VelocityBCType.no_slip, bm["upper wall"], None),
           (VelocityBCType.no_slip, bm["lower wall"], None)]
    if pin_outlet:
        bcs.append((PressureBCType.constant, bm["outlet"], 0.0))
    solver.set_boundary_conditions(tuple(bcs))
    solver.set_equation_coefficients(
        {"convective_term": 1.0, "viscous_term": 0.01,
         "pressure_term": 1.0, "coriolis_term": None,
         "euler_term": None, "body_force_term": None})
    solver.solve()
    F = solver.boundary_reaction_force(bm["cylinder"])
    # c = 2 F / (Ubar^2 D) with Ubar = 0.2, D = 1
    out = {"res": res, "dofs": solver.space.n_dofs,
           "cd": round(50.0 * float(F[0]), 5),
           "cl": round(50.0 * float(F[1]), 6),
           "lit_cd": [5.57, 5.59], "lit_cl": [0.0104, 0.0110]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    ladder = [float(a) for a in sys.argv[1:]] or [1.3, 2.0, 3.0]
    for r in ladder:
        run(r)
