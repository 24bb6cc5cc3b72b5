"""ProjectionSolver: the fused fast path behind the product solver API.

Covers the fast path's reachability from the documented API and its
residual control: the solver lowers to the fused /
spectral step, supports time-dependent BCs and variable steps, and records
per-step CG residuals.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from navierstokes_tpu.fem.bcs import PressureBCType, VelocityBCType
from navierstokes_tpu.fem.spaces import axis_periodic
from navierstokes_tpu.mesh import HyperRectangleBoundaryMarkers as M
from navierstokes_tpu.mesh import hyper_cube, hyper_rectangle
from navierstokes_tpu.solvers import ProjectionSolver
from navierstokes_tpu.timestepping import BDFTimeStepping

GAMMA = 2.0 * np.pi


def _channel_solver(dt=0.01, inlet=None):
    mesh, markers = hyper_rectangle((0.0, 0.0), (5.0, 1.0), (20, 4))
    ts = BDFTimeStepping(0.0, 10.0, desired_start_time_step=dt)
    solver = ProjectionSolver(mesh, markers, "standard", ts,
                              cg_iters=(60, 600, 30), cg_rtol=1e-10)
    if inlet is None:
        inlet = lambda x: np.stack([x[:, 1] * (1 - x[:, 1]),
                                    np.zeros(len(x))], axis=1)
    solver.set_boundary_conditions(
        ((VelocityBCType.function, M.left.value, inlet),
         (VelocityBCType.no_slip, M.bottom.value, None),
         (VelocityBCType.no_slip, M.top.value, None),
         (PressureBCType.constant, M.right.value, 0.0)))
    solver.set_equation_coefficients(
        {"convective_term": 1.0, "viscous_term": 0.1, "pressure_term": 1.0})
    solver.set_initial_conditions({"velocity": (0.0, 0.0)})
    return solver, ts


def _run(solver, ts, n_steps, dts=None):
    for i in range(n_steps):
        if dts is not None:
            ts.set_desired_next_step_size(dts[i])
        ts.update_coefficients()
        solver.solve()
        ts.advance_time()
        solver.advance_time()


def test_projection_solver_channel_reaches_poiseuille():
    """Generic fused path through the solver API: transient channel settles
    onto the parabolic profile (the steady state of the scheme)."""
    solver, ts = _channel_solver(dt=0.05)
    _run(solver, ts, 120)
    assert solver._step_kind == "fast"   # gather-free banded engine (r3)
    space = solver.space
    u, p = space.split(np.asarray(solver.solution))
    u_exact = np.stack([space.u_coords[:, 1] * (1 - space.u_coords[:, 1]),
                        np.zeros(space.n_unodes)], axis=1)
    assert np.abs(u - u_exact).max() < 2e-4
    # residual monitoring: every step recorded and converged
    recs = [r for r in solver.monitor.records if r["kind"] == "linear_solve"]
    assert len(recs) == 120
    assert all(r["residual"] < 1e-6 for r in recs)


def test_projection_solver_time_dependent_inflow_variable_steps():
    """Per-step traced BC values + traced variable step sizes: the inflow
    amplitude follows sin(pi t) exactly at the inlet nodes."""
    amp = lambda t: np.sin(np.pi * t)

    def inlet(x, t=0.0):
        t = 0.0 if t is None else t
        base = np.stack([x[:, 1] * (1 - x[:, 1]), np.zeros(len(x))], axis=1)
        return amp(t) * base

    solver, ts = _channel_solver(dt=0.02, inlet=inlet)
    dts = [0.02, 0.02, 0.03, 0.025, 0.02]
    _run(solver, ts, len(dts), dts=dts)
    space = solver.space
    u, _ = space.split(np.asarray(solver.solution))
    inlet_nodes = np.nonzero(space.u_coords[:, 0] < 1e-12)[0]
    t = ts.current_time
    expected = amp(t) * space.u_coords[inlet_nodes, 1] \
        * (1 - space.u_coords[inlet_nodes, 1])
    assert np.abs(u[inlet_nodes, 0] - expected).max() < 1e-12


@pytest.mark.slow
def test_dfg_projection_problem_short_run():
    """The DFG 2D-3 demo class (Problem API + ProjectionSolver) runs on a
    coarse mesh: pulsating inflow actually applied, finite reaction
    forces recorded every step."""
    import sys
    sys.path.insert(0, "demo")
    from dfg_benchmark_projection import DFGBenchmark2D3Projection

    problem = DFGBenchmark2D3Projection(end_time=8.0, n_max_steps=4,
                                        resolution=6.0, dt=0.05)
    problem._postprocessing_frequency = 1
    problem.solve_problem()
    coeffs = np.asarray(problem.materialize_coefficients())
    assert len(coeffs) == 4
    assert np.isfinite(coeffs).all()

    solver = problem._get_solver()
    # fine unstructured meshes may exceed the banded-storage cap and fall
    # back to the cell-loop path; either hot path must work here
    assert solver._step_kind in ("fast", "generic")
    space = solver.space
    u, _ = space.split(np.asarray(solver.solution))
    inlet_nodes = np.nonzero(space.u_coords[:, 0] < 1e-9)[0]
    t = problem._time_stepping.current_time
    s = space.u_coords[inlet_nodes, 1] / 4.1
    expected = np.sin(np.pi * t / 8.0) * 6.0 * s * (1 - s)
    assert np.abs(u[inlet_nodes, 0] - expected).max() < 1e-10


def test_projection_solver_spectral_on_periodic_taylor_green():
    """Periodic structured mesh + mean-pressure constraint lowers to the
    exact spectral step and tracks the analytic decay."""
    mesh, markers = hyper_cube(2, 16)
    Re, dt, n_steps = 100.0, 5e-3, 20
    ts = BDFTimeStepping(0.0, 1.0, desired_start_time_step=dt)
    solver = ProjectionSolver(mesh, markers, "standard", ts)
    solver.set_periodic_boundary_conditions(
        [axis_periodic(0), axis_periodic(1)],
        (M.left.value, M.right.value, M.bottom.value, M.top.value))
    solver.set_boundary_conditions(
        ((PressureBCType.mean_value, None, 0.0),))
    solver.set_equation_coefficients(
        {"convective_term": 1.0, "viscous_term": 1.0 / Re,
         "pressure_term": 1.0})

    def tg(x, t=0.0):
        decay = np.exp(-2 * GAMMA ** 2 * t / Re)
        return decay * np.stack(
            [np.cos(GAMMA * x[:, 0]) * np.sin(GAMMA * x[:, 1]),
             -np.sin(GAMMA * x[:, 0]) * np.cos(GAMMA * x[:, 1])], axis=1)

    solver.set_initial_conditions({"velocity": tg})
    _run(solver, ts, n_steps)
    assert solver._step_kind == "spectral"

    space = solver.space
    from navierstokes_tpu.assembly.operators import MixedOperator

    u, _ = space.split(np.asarray(solver.solution))
    err = MixedOperator(space).l2_error_velocity(
        u, lambda x: tg(x, ts.current_time))
    assert err < 4e-3, err
