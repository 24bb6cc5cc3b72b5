"""Cell-sharded mixed Jacobian: multi-device stationary Newton stack.

Stationary multi-device coverage: the mixed
saddle-point Jacobian action sharded over 8 virtual devices must equal
the single-device ``MixedOperator.linearize_at`` matvec to roundoff,
and a full PCD-FGMRES Newton system solved through
``MatrixFreePCD(ShardedMixedOperator(...))`` must reproduce the
single-device update.
"""

import pytest

import numpy as np

import jax
import jax.numpy as jnp

from navierstokes_tpu.assembly.operators import MixedOperator
from navierstokes_tpu.fem.bcs import VelocityBCType
from navierstokes_tpu.fem.dirichlet import compile_dirichlet_bcs
from navierstokes_tpu.fem.spaces import TaylorHoodSpace
from navierstokes_tpu.mesh import HyperCubeBoundaryMarkers as M
from navierstokes_tpu.mesh import hyper_cube
from navierstokes_tpu.parallel.sharded import device_mesh
from navierstokes_tpu.parallel.sharded_mixed import ShardedMixedOperator

SCALARS = {"cv": 1.0 / 100.0, "cc": 1.0, "cp": 1.0, "accel0": 0.0}


def _setup(n=10):
    mesh, markers = hyper_cube(2, n)
    space = TaylorHoodSpace(mesh)
    op = MixedOperator(space)
    vbc, _ = compile_dirichlet_bcs(space, markers, [
        (VelocityBCType.no_slip, M.left.value, None),
        (VelocityBCType.no_slip, M.right.value, None),
        (VelocityBCType.no_slip, M.bottom.value, None),
        (VelocityBCType.constant, M.top.value, (1.0, 0.0))], [])
    op.set_bc_dofs(np.asarray(vbc.dofs))
    return space, op, vbc


def test_sharded_jvp_matches_single_device():
    space, op, _ = _setup(12)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(space.n_dofs))
    v = jnp.asarray(rng.standard_normal(space.n_dofs))
    _, jvp_ref = op.linearize_at(x, SCALARS)
    sop = ShardedMixedOperator(op, device_mesh(8))
    _, jvp_sh = sop.linearize_at(x, SCALARS)
    a = np.asarray(jvp_ref(v))
    b = np.asarray(jvp_sh(v))
    assert np.linalg.norm(a - b) / np.linalg.norm(a) < 1e-13
    # Picard variant too
    _, jvp_ref_p = op.linearize_at(x, SCALARS, picard=True)
    _, jvp_sh_p = sop.linearize_at(x, SCALARS, picard=True)
    a = np.asarray(jvp_ref_p(v))
    b = np.asarray(jvp_sh_p(v))
    assert np.linalg.norm(a - b) / np.linalg.norm(a) < 1e-13


def test_pcd_newton_system_through_sharded_operator():
    from navierstokes_tpu.linalg.block_precond import MatrixFreePCD

    space, op, vbc = _setup(10)
    vals = jnp.asarray(vbc.values())
    x0 = jnp.zeros(space.n_dofs).at[jnp.asarray(
        np.asarray(vbc.dofs))].set(vals)
    rhs = -op.residual(x0, vals, SCALARS)

    ctx_ref = MatrixFreePCD(op, max_cycles=2)
    dx_ref, res_ref, its_ref = ctx_ref.solve(x0, rhs, SCALARS, tol=1e-10)

    sop = ShardedMixedOperator(op, device_mesh(8))
    ctx_sh = MatrixFreePCD(sop, max_cycles=2)
    dx_sh, res_sh, its_sh = ctx_sh.solve(x0, rhs, SCALARS, tol=1e-10)

    assert its_sh == its_ref
    assert float(res_sh) < 1e-9
    rel = float(jnp.linalg.norm(dx_sh - dx_ref)
                / jnp.linalg.norm(dx_ref))
    assert rel < 1e-10


def test_sharded_operator_refuses_several_gpus():
    """The cell-sharded Newton stack does not converge on several GPUs;
    it must refuse them up front rather than return a wrong solve."""
    import types

    _, op, _ = _setup(4)
    gpus = np.array([types.SimpleNamespace(platform="gpu")] * 4)
    fake = types.SimpleNamespace(axis_names=("shard",), devices=gpus)
    with pytest.raises(NotImplementedError, match="GPU"):
        ShardedMixedOperator(op, fake)


@pytest.mark.slow
def test_stationary_solver_device_mesh_full_solve():
    """The PRODUCT API -- a full Picard->Newton
    ``StationarySolver(device_mesh=...).solve()`` with the cell-sharded
    Jacobian inside PCD-FGMRES, matching the single-device solve."""
    from navierstokes_tpu.solvers import StationarySolver

    def cavity(dmesh):
        mesh, markers = hyper_cube(2, 16)
        s = StationarySolver(mesh, markers, "standard", tol=1e-10,
                             linear_solver="pcd", device_mesh=dmesh)
        s.set_boundary_conditions(
            ((VelocityBCType.no_slip, M.left.value, None),
             (VelocityBCType.no_slip, M.right.value, None),
             (VelocityBCType.no_slip, M.bottom.value, None),
             (VelocityBCType.constant, M.top.value, (1.0, 0.0))))
        s.set_equation_coefficients(
            {"convective_term": 1.0, "viscous_term": 1.0 / 50.0,
             "pressure_term": 1.0, "coriolis_term": None,
             "euler_term": None, "body_force_term": None})
        s.solve()
        return np.asarray(s.solution)

    x_single = cavity(None)
    x_sharded = cavity(device_mesh(8))
    scale = np.abs(x_single).max()
    # both converge the SAME nonlinear problem to ||F|| <= 1e-10; the
    # iterates differ only through collective summation order
    assert np.abs(x_sharded - x_single).max() < 1e-6 * scale


@pytest.mark.parametrize("restart", [8, 3])
def test_fgmres_device_cycles_to_the_solution(restart):
    """A full Krylov space converges in one cycle; a short restart needs
    several, each counted as ``restart`` matvecs."""
    from navierstokes_tpu.linalg.fgmres import fgmres_device

    A = jnp.diag(jnp.arange(1.0, 9.0))
    b = jnp.ones(8)
    x, res, its = fgmres_device(lambda v: A @ v, lambda v: v, b,
                                restart=restart, tol=1e-12, atol=0.0,
                                max_cycles=50)
    assert int(its) % restart == 0
    assert int(its) == 8 if restart == 8 else int(its) > 8
    assert float(res) < 1e-11
    assert np.allclose(np.asarray(x), 1.0 / np.arange(1.0, 9.0))
