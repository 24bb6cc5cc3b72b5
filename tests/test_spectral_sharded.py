"""Slab-sharded spectral projection step (multi-chip flagship path).

Multi-device coverage must extend beyond the halo
ProjectionSolver class and beyond toy shapes.  Here the spectral
class-grid step runs sharded over 8 virtual devices at 64^2 (37k DoF)
through both the raw step API and the ProjectionSolver product API, and
must match the single-device trajectory to roundoff while the
loop-carried state stays genuinely distributed (slab shardings asserted
per leaf, not just final values).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from navierstokes_tpu.fem.bcs import PressureBCType
from navierstokes_tpu.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu.mesh import HyperCubeBoundaryMarkers as M
from navierstokes_tpu.mesh import hyper_cube
from navierstokes_tpu.parallel.sharded import device_mesh
from navierstokes_tpu.structured import (PeriodicStructuredTH,
                                         build_spectral_projection_step)
from navierstokes_tpu.structured.grid import NotStructured
from navierstokes_tpu.structured.spectral import shard_spectral_step

GAMMA = 2.0 * np.pi


def _tg_velocity(x, t=0.0, Re=100.0):
    decay = np.exp(-2.0 * GAMMA ** 2 * t / Re)
    return decay * np.stack([
        np.cos(GAMMA * x[:, 0]) * np.sin(GAMMA * x[:, 1]),
        -np.sin(GAMMA * x[:, 0]) * np.cos(GAMMA * x[:, 1])], axis=1)


def _tg_pressure(x, t=0.0, Re=100.0):
    decay = np.exp(-4.0 * GAMMA ** 2 * t / Re)
    return -0.25 * decay * (np.cos(2 * GAMMA * x[:, 0])
                            + np.cos(2 * GAMMA * x[:, 1]))


def _setup(n=64):
    mesh, _ = hyper_cube(2, n)
    space = TaylorHoodSpace(mesh, periodic=[axis_periodic(0),
                                            axis_periodic(1)])
    sgrid = PeriodicStructuredTH(space)
    return space, sgrid


def test_sharded_step_matches_single_device_64sq():
    space, sgrid = _setup(64)
    step, init_state, read_state = build_spectral_projection_step(
        sgrid, visc=0.01, dt=1e-3)
    u0 = space.interpolate_velocity(_tg_velocity, t=None).reshape(-1)
    p0 = space.interpolate_pressure(_tg_pressure, t=None)
    al = tuple(jnp.asarray(v) for v in (1.5, -2.0, 0.5))
    et = tuple(jnp.asarray(v) for v in (2.0, -1.0))

    s1 = init_state(u0, u0, p0)
    for _ in range(8):
        s1 = step(s1, al, et)
    u1, p1 = read_state(s1)

    dmesh = device_mesh(8)
    sharded, shard_state = shard_spectral_step(step, sgrid, dmesh)
    s8 = shard_state(init_state(u0, u0, p0))
    # every state leaf is genuinely slab-sharded across the 8 devices
    for leaf in jax.tree.leaves(s8):
        assert "shard" in str(leaf.sharding.spec) or leaf.ndim <= 1, \
            (leaf.shape, leaf.sharding)
    for _ in range(8):
        s8 = sharded(s8, al, et)
    # ... and STAYS sharded through the jitted step (out_shardings pin)
    for leaf in jax.tree.leaves(s8):
        assert "shard" in str(leaf.sharding.spec) or leaf.ndim <= 1, \
            (leaf.shape, leaf.sharding)
    u8, p8 = read_state(s8)
    assert np.linalg.norm(u8 - u1) / np.linalg.norm(u1) < 1e-12
    assert np.linalg.norm(p8 - p1) / np.linalg.norm(p1) < 1e-12


def test_indivisible_grid_raises_not_structured():
    space, sgrid = _setup(12)  # 12 % 8 != 0
    step, *_ = build_spectral_projection_step(sgrid, visc=0.01, dt=1e-3)
    with pytest.raises(NotStructured):
        shard_spectral_step(step, sgrid, device_mesh(8))


def test_projection_solver_spectral_sharded_product_api():
    """The product API: ProjectionSolver(device_mesh=...) on a periodic
    enclosed problem lowers to the SHARDED spectral step and matches the
    single-device solver."""
    from navierstokes_tpu.solvers import ProjectionSolver
    from navierstokes_tpu.timestepping import BDFTimeStepping

    def build(dmesh):
        mesh, markers = hyper_cube(2, 32)
        ts = BDFTimeStepping(0.0, 1.0, desired_start_time_step=1e-2)
        solver = ProjectionSolver(mesh, markers, "standard", ts,
                                  device_mesh=dmesh)
        solver.set_periodic_boundary_conditions(
            [axis_periodic(0), axis_periodic(1)],
            (M.left.value, M.right.value, M.top.value, M.bottom.value))
        solver.set_boundary_conditions(
            ((PressureBCType.mean_value, None, 0.0),))
        solver.set_equation_coefficients(
            {"convective_term": 1.0, "viscous_term": 0.01,
             "pressure_term": 1.0})
        solver.set_initial_conditions({"velocity": _tg_velocity,
                                       "pressure": _tg_pressure})
        return solver, ts

    def run(solver, ts, n):
        for _ in range(n):
            ts.update_coefficients()
            solver.solve()
            ts.advance_time()
            solver.advance_time()
        return np.asarray(solver.solution)

    s1, ts1 = build(None)
    x1 = run(s1, ts1, 5)
    assert s1._step_kind == "spectral"

    s8, ts8 = build(device_mesh(8))
    x8 = run(s8, ts8, 5)
    assert s8._step_kind == "spectral"
    # internal state is sharded over the mesh
    for leaf in jax.tree.leaves(s8._spectral_state):
        assert "shard" in str(leaf.sharding.spec) or leaf.ndim <= 1
    np.testing.assert_allclose(x8, x1, atol=1e-11)
