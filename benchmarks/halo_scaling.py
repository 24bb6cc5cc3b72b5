"""Step-time vs device count for the halo-sharded projection step.

Runs the SAME transient Dirichlet channel (ProjectionSolver product API)
on 1 device (banded fast path) and on 2/4/8-device meshes (halo layer),
and prints per-step wall time plus the halo-exchange memory fractions.

On virtual CPU devices (XLA_FLAGS=--xla_force_host_platform_device_count)
all "devices" share the host's cores, so wall-clock does NOT show real
speedup -- the point of the table is (a) the halo path works end-to-end
at every device count, (b) per-device owned/halo sizes shrink as O(N/n),
(c) the collective volume (halo fraction) stays small.  Interconnect
timing needs real cards.

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python benchmarks/halo_scaling.py [n_cells_x] [steps]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # runnable from any cwd

import json
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from navierstokes_tpu.fem.bcs import (PressureBCType,  # noqa: E402
                                      VelocityBCType)
from navierstokes_tpu.mesh import hyper_rectangle  # noqa: E402
from navierstokes_tpu.mesh.generators import \
    HyperCubeBoundaryMarkers as M  # noqa: E402
from navierstokes_tpu.parallel.sharded import device_mesh  # noqa: E402
from navierstokes_tpu.solvers import ProjectionSolver  # noqa: E402
from navierstokes_tpu.timestepping import BDFTimeStepping  # noqa: E402


def build(dmesh, nx, ny):
    mesh, markers = hyper_rectangle((0.0, 0.0), (4.0, 1.0), (nx, ny))
    ts = BDFTimeStepping(0.0, 1e3, desired_start_time_step=0.01)
    solver = ProjectionSolver(mesh, markers, "standard", ts,
                              cg_iters=(20, 80, 10), cg_rtol=None,
                              device_mesh=dmesh)
    inlet = lambda x: np.stack(
        [x[:, 1] * (1 - x[:, 1]), np.zeros(len(x))], axis=1)
    solver.set_boundary_conditions(
        ((VelocityBCType.function, M.left.value, inlet),
         (VelocityBCType.no_slip, M.bottom.value, None),
         (VelocityBCType.no_slip, M.top.value, None),
         (PressureBCType.constant, M.right.value, 0.0)))
    solver.set_equation_coefficients(
        {"convective_term": 1.0, "viscous_term": 0.1,
         "pressure_term": 1.0})
    solver.set_initial_conditions({"velocity": (0.0, 0.0)})
    return solver, ts


def time_solver(solver, ts, steps):
    for _ in range(3):  # warmup / compile
        ts.update_coefficients()
        solver.solve()
        ts.advance_time()
        solver.advance_time()
    jax.block_until_ready(solver._u)
    t0 = time.perf_counter()
    for _ in range(steps):
        ts.update_coefficients()
        solver.solve()
        ts.advance_time()
        solver.advance_time()
    jax.block_until_ready(solver._u)
    return (time.perf_counter() - t0) / steps


def main():
    nx = int(sys.argv[1]) if len(sys.argv) > 1 else 96
    ny = nx // 4
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    n_avail = len(jax.devices())

    rows = []
    for ndev in (1, 2, 4, 8):
        if ndev > n_avail:
            break
        dmesh = None if ndev == 1 else device_mesh(ndev)
        solver, ts = build(dmesh, nx, ny)
        dt_step = time_solver(solver, ts, steps)
        row = {"n_devices": ndev,
               "path": solver._step_kind,
               "n_dofs": solver.space.n_dofs,
               "step_ms": round(dt_step * 1e3, 2)}
        if solver._step_kind == "halo":
            rep = solver._hops.halo_report()
            row["owned_u_per_dev"] = rep["u_nodes_per_device"]
            row["halo_u_per_dev"] = rep["u_halo_per_device"]
            row["halo_fraction"] = round(
                rep["u_halo_per_device"]
                / max(rep["u_nodes_per_device"], 1), 3)
        rows.append(row)
        print(json.dumps(row))
    return rows


if __name__ == "__main__":
    main()
