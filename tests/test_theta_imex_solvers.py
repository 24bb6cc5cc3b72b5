"""Theta-scheme and IMEX solvers on the Taylor-Green vortex.

These schemes exist in the reference only as coefficient generators
(never wired to a solver); here they drive full solves and are verified
against the analytic decay.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

from navierstokes_tpu.fem.bcs import PressureBCType
from navierstokes_tpu.fem.spaces import axis_periodic
from navierstokes_tpu.mesh import HyperCubeBoundaryMarkers, hyper_cube
from navierstokes_tpu.solvers import IMEXSolver, ThetaSolver
from navierstokes_tpu.timestepping import (GeneralThetaTimeStepping,
                                           IMEXTimeStepping, IMEXType,
                                           ThetaTimeSteppingType)

M = HyperCubeBoundaryMarkers
GAMMA = 2.0 * np.pi
RE = 100.0


def tg_velocity(x, t):
    d = np.exp(-2 * GAMMA ** 2 * t / RE)
    return d * np.stack([np.cos(GAMMA * x[:, 0]) * np.sin(GAMMA * x[:, 1]),
                         -np.sin(GAMMA * x[:, 0]) * np.cos(GAMMA * x[:, 1])],
                        axis=1)


def tg_pressure(x, t):
    d = np.exp(-4 * GAMMA ** 2 * t / RE)
    return -0.25 * d * (np.cos(2 * GAMMA * x[:, 0])
                        + np.cos(2 * GAMMA * x[:, 1]))


def run_taylor_green(SolverClass, time_stepping, n_points=16, n_steps=5,
                     dt=0.05):
    mesh, markers = hyper_cube(2, n_points)
    solver = SolverClass(mesh, markers, "standard", time_stepping)
    solver.set_periodic_boundary_conditions(
        [axis_periodic(0), axis_periodic(1)],
        (M.left.value, M.right.value, M.top.value, M.bottom.value))
    solver.set_boundary_conditions(((PressureBCType.mean_value, None, 0.0),))
    solver.set_equation_coefficients(
        {"convective_term": 1.0, "viscous_term": 1.0 / RE,
         "pressure_term": 1.0, "coriolis_term": None, "euler_term": None,
         "body_force_term": None})
    solver.set_initial_conditions({
        "velocity": lambda x: tg_velocity(x, 0.0),
        "pressure": lambda x: tg_pressure(x, 0.0)})
    ts = time_stepping
    for _ in range(n_steps):
        ts.update_coefficients()
        solver.solve()
        ts.advance_time()
        solver.advance_time()
    u, p = solver.space.split(solver.solution)
    err = solver.operator.l2_error_velocity(
        u, lambda x: tg_velocity(x, ts.current_time))
    return solver, err


def test_theta_crank_nicolson():
    ts = GeneralThetaTimeStepping(0.0, 1.0,
                                  ThetaTimeSteppingType.CrankNicolson,
                                  desired_start_time_step=0.05)
    _, err = run_taylor_green(ThetaSolver, ts)
    assert err < 3e-3, err


def test_theta_backward_euler_vs_crank_nicolson():
    ts = GeneralThetaTimeStepping(0.0, 1.0,
                                  ThetaTimeSteppingType.BackwardEuler,
                                  desired_start_time_step=0.2)
    _, err_be = run_taylor_green(ThetaSolver, ts, n_steps=3, dt=0.2)
    ts2 = GeneralThetaTimeStepping(0.0, 1.0,
                                   ThetaTimeSteppingType.CrankNicolson,
                                   desired_start_time_step=0.2)
    _, err_cn = run_taylor_green(ThetaSolver, ts2, n_steps=3, dt=0.2)
    # at a coarse dt the first-order scheme is far less accurate than CN
    assert err_be > 3.0 * err_cn, (err_be, err_cn)
    assert err_be < 0.1


def test_theta_fractional_step():
    ts = GeneralThetaTimeStepping(0.0, 1.0,
                                  ThetaTimeSteppingType.FractionalStep01,
                                  desired_start_time_step=0.1)
    _, err = run_taylor_green(ThetaSolver, ts, n_steps=3, dt=0.1)
    # strongly A-stable second-order scheme
    assert err < 3e-3, err


def _temporal_order(make_solver_and_ts, dt_coarse, t_end=0.2, n_points=16):
    """log2 ratio of *temporal* errors between dt and dt/2 runs.

    The error is measured against a dt/8 run of the same scheme on the
    same mesh, which removes the spatial discretization floor that masks
    the temporal order when comparing against the analytic solution
    (the analytic-error variant plateaus at the ~3e-4 spatial error of a
    24^2 mesh)."""
    import math

    fields = []
    for dt in (dt_coarse, dt_coarse / 2, dt_coarse / 8):
        SolverClass, ts = make_solver_and_ts(dt, t_end)
        n_steps = int(round(t_end / dt))
        solver, _ = run_taylor_green(SolverClass, ts, n_points=n_points,
                                     n_steps=n_steps, dt=dt)
        u, _ = solver.space.split(np.asarray(solver.solution))
        fields.append(u)
    ref = fields[-1]
    errors = [float(np.sqrt(np.mean((f - ref) ** 2))) for f in fields[:2]]
    return math.log2(errors[0] / errors[1]), errors


@pytest.mark.slow
def test_theta_crank_nicolson_temporal_order():
    """Crank-Nicolson is second order in dt (the theta schemes need an
    order-of-convergence proof -- this also pins
    the tableau normalization of solvers/theta.py)."""
    order, errs = _temporal_order(
        lambda dt, t_end: (ThetaSolver, GeneralThetaTimeStepping(
            0.0, t_end, ThetaTimeSteppingType.CrankNicolson,
            desired_start_time_step=dt)), dt_coarse=0.04)
    assert order > 1.7, (order, errs)


@pytest.mark.slow
def test_theta_fractional_step_temporal_order():
    """Fractional-step-theta (3 substeps, strongly A-stable) is second
    order in dt."""
    order, errs = _temporal_order(
        lambda dt, t_end: (ThetaSolver, GeneralThetaTimeStepping(
            0.0, t_end, ThetaTimeSteppingType.FractionalStep01,
            desired_start_time_step=dt)), dt_coarse=0.04)
    assert order > 1.7, (order, errs)


@pytest.mark.slow
def test_imex_sbdf2_temporal_order():
    order, errs = _temporal_order(
        lambda dt, t_end: (IMEXSolver, IMEXTimeStepping(
            0.0, t_end, IMEXType.SBDF2, desired_start_time_step=dt)),
        dt_coarse=0.02)
    assert order > 1.7, (order, errs)


@pytest.mark.slow
def test_imex_cnab_temporal_order():
    order, errs = _temporal_order(
        lambda dt, t_end: (IMEXSolver, IMEXTimeStepping(
            0.0, t_end, IMEXType.CNAB, desired_start_time_step=dt)),
        dt_coarse=0.02)
    assert order > 1.7, (order, errs)


def test_imex_sbdf2():
    ts = IMEXTimeStepping(0.0, 1.0, IMEXType.SBDF2,
                          desired_start_time_step=0.02)
    _, err = run_taylor_green(IMEXSolver, ts, n_steps=10, dt=0.02)
    assert err < 3e-3, err


def test_imex_cnab():
    ts = IMEXTimeStepping(0.0, 1.0, IMEXType.CNAB,
                          desired_start_time_step=0.02)
    _, err = run_taylor_green(IMEXSolver, ts, n_steps=10, dt=0.02)
    assert err < 3e-3, err
