"""Mixed-precision machinery: host float64 residual + iterative refinement.

SURVEY hard part #5: the reference's
||F|| <= 1e-10 contract is float64; float32 devices need a host-f64 residual.  The
framework's answer is float32 device Krylov + float64 host residual
accumulation (assembly/host_reference.py, StationarySolver.solve_refined).
"""

import pytest

import numpy as np

import jax.numpy as jnp

from navierstokes_tpu.assembly.host_reference import residual_f64
from navierstokes_tpu.fem.bcs import VelocityBCType
from navierstokes_tpu.mesh import HyperCubeBoundaryMarkers as M
from navierstokes_tpu.mesh import hyper_cube
from navierstokes_tpu.solvers import StationarySolver


def _cavity(n, Re, **kw):
    mesh, markers = hyper_cube(2, n)
    s = StationarySolver(mesh, markers, **kw)
    s.set_boundary_conditions(
        ((VelocityBCType.no_slip, M.left.value, None),
         (VelocityBCType.no_slip, M.right.value, None),
         (VelocityBCType.no_slip, M.bottom.value, None),
         (VelocityBCType.constant, M.top.value, (1.0, 0.0))))
    s.set_equation_coefficients(
        {"convective_term": 1.0, "viscous_term": 1.0 / Re,
         "pressure_term": 1.0, "coriolis_term": None, "euler_term": None,
         "body_force_term": None})
    return s


def test_host_residual_matches_device_kernels():
    """Same math, independent code path: NumPy f64 assembly agrees with
    the jitted device residual to roundoff (all convective forms)."""
    for form in ("standard", "rotational", "divergence", "skew_symmetric"):
        s = _cavity(8, 50.0, form_convective_term=form)
        s._setup_problem()
        op = s.operator
        scalars = s._scalars()
        bcv = s._bc_values()
        rng = np.random.default_rng(7)
        x = rng.standard_normal(s.space.n_dofs)
        r_dev = np.asarray(op.residual(jnp.asarray(x), bcv, scalars,
                                       0.0, None))
        r_host = residual_f64(s.space, x, s._bc_dofs_all,
                              np.asarray(bcv), scalars,
                              form_convective_term=form)
        err = np.abs(r_dev - r_host).max()
        assert err < 1e-12, (form, err)


@pytest.mark.slow
def test_solve_refined_reaches_f64_contract():
    """solve() to device precision, then refinement to ||F||_f64 <= 1e-10;
    monitor records the refinement trajectory."""
    s = _cavity(10, 100.0, linear_solver="pcd")
    x = s.solve_refined(tol=1e-10, maxiter=25)
    scalars = s._scalars()
    r = residual_f64(s.space, x, s._bc_dofs_all,
                     np.asarray(s._bc_values()), scalars)
    assert np.linalg.norm(r) <= 1e-10
    recs = [r_ for r_ in s.monitor.records
            if r_["kind"] == "mixed_precision_refinement"]
    assert recs and recs[-1]["residual"] <= 1e-10


def test_jacobian_f64_is_exact():
    """The central-difference element Jacobian (h=1) is EXACT for the
    at-most-quadratic Navier-Stokes residual: A v == (F(x+v)-F(x-v))/2
    for random v, including the identity rows at constrained dofs."""
    from navierstokes_tpu.assembly.host_reference import jacobian_f64

    s = _cavity(6, 50.0)
    s._setup_problem()
    scalars = s._scalars()
    bcv = np.asarray(s._bc_values(), dtype=np.float64)
    rng = np.random.default_rng(3)
    n = s.space.n_dofs
    x = rng.standard_normal(n)
    v = rng.standard_normal(n)
    A = jacobian_f64(s.space, x, s._bc_dofs_all, scalars)
    Fp = residual_f64(s.space, x + v, s._bc_dofs_all, bcv, scalars)
    Fm = residual_f64(s.space, x - v, s._bc_dofs_all, bcv, scalars)
    err = np.abs(A @ v - 0.5 * (Fp - Fm)).max()
    scale = np.abs(0.5 * (Fp - Fm)).max()
    assert err <= 1e-11 * max(scale, 1.0), (err, scale)


@pytest.mark.slow
def test_refined_traction_and_pressure_dirichlet_f32():
    """The f64 contract on the two BC classes that floor the plain f32
    refinement: a pressure-Dirichlet channel
    (residual direction below f32 resolution -> host-f64 LU corrections
    engage) and periodic Couette driven by a traction BC (the f64 host
    residual must include the boundary integral).  True float32
    subprocess."""
    import os
    import subprocess
    import sys

    code = r"""
import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np, jax.numpy as jnp
from navierstokes_tpu.fem.bcs import (PressureBCType, TractionBCType,
                                      VelocityBCType)
from navierstokes_tpu.mesh import HyperCubeBoundaryMarkers as M
from navierstokes_tpu.mesh import hyper_cube, hyper_rectangle
from navierstokes_tpu.fem.spaces import axis_periodic
from navierstokes_tpu.solvers import StationarySolver
from navierstokes_tpu.assembly.host_reference import residual_f64

coeffs = {'convective_term': 1.0, 'viscous_term': 1.0,
          'pressure_term': 1.0, 'coriolis_term': None, 'euler_term': None,
          'body_force_term': None}

# --- pressure-Dirichlet channel (floors at ~4.5e-7 without the LU path)
mesh, markers = hyper_rectangle((0.0, 0.0), (4.0, 1.0), (24, 6))
s = StationarySolver(mesh, markers, linear_solver='pcd')
profile = lambda x: np.stack([6.0 * x[:, 1] * (1.0 - x[:, 1]),
                              np.zeros(len(x))], axis=1)
s.set_boundary_conditions(
    ((VelocityBCType.function, M.left.value, profile),
     (VelocityBCType.no_slip, M.bottom.value, None),
     (VelocityBCType.no_slip, M.top.value, None),
     (PressureBCType.constant, M.right.value, 0.0)))
s.set_equation_coefficients(dict(coeffs))
x64 = s.solve_refined(tol=1e-10, maxiter=30)
r = residual_f64(s.space, x64, s._bc_dofs_all,
                 np.asarray(s._bc_values(), dtype=np.float64),
                 s._scalars(), extra_ru=s._traction_extra_ru_f64())
rn_channel = float(np.linalg.norm(r))
assert rn_channel <= 1e-10, rn_channel
rec = [r_ for r_ in s.monitor.records
       if r_['kind'] == 'mixed_precision_refinement'][-1]

# --- periodic Couette driven by a traction BC
mesh, markers = hyper_cube(2, 8)
s2 = StationarySolver(mesh, markers, linear_solver='pcd')
s2.set_periodic_boundary_conditions(
    axis_periodic(0, 0.0, 1.0), (M.left.value, M.right.value))
s2.set_boundary_conditions(
    ((VelocityBCType.no_slip, M.bottom.value, None),
     (TractionBCType.constant_component, M.top.value, 0, 1.0),
     (VelocityBCType.no_normal_flux, M.top.value, None)))
s2.set_equation_coefficients(dict(coeffs))
x64 = s2.solve_refined(tol=1e-10, maxiter=30)
r = residual_f64(s2.space, x64, s2._bc_dofs_all,
                 np.asarray(s2._bc_values(), dtype=np.float64),
                 s2._scalars(), extra_ru=s2._traction_extra_ru_f64())
rn_couette = float(np.linalg.norm(r))
assert rn_couette <= 1e-10, rn_couette
print('F32-BCCLASS-OK', rn_channel, rn_couette,
      'lu', rec['lu_factorizations'])
"""
    env = dict(os.environ)
    env.pop("JAX_ENABLE_X64", None)
    env["XLA_FLAGS"] = ""
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=1200)
    assert "F32-BCCLASS-OK" in out.stdout, (out.stdout[-2000:],
                                            out.stderr[-2000:])


@pytest.mark.slow
def test_refinement_in_true_f32_process():
    """The full mixed-precision path under float32 device numerics.

    Runs in a subprocess WITHOUT x64 (the in-suite tests run f64, where
    refinement is trivially exact).  Guards the round-2 fix chain: the
    unpinned mean-free formulation (a pinned pressure dof parks f32
    round-off in an O(N)-ill-conditioned direction and refinement stalls
    with lres = 0.9999) and the normalized correction solves.
    """
    import subprocess
    import sys

    code = r"""
import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np, jax.numpy as jnp
from navierstokes_tpu.fem.bcs import VelocityBCType
from navierstokes_tpu.mesh import HyperCubeBoundaryMarkers as M
from navierstokes_tpu.mesh import hyper_cube
from navierstokes_tpu.solvers import StationarySolver
from navierstokes_tpu.assembly.host_reference import residual_f64

mesh, markers = hyper_cube(2, 16)
s = StationarySolver(mesh, markers, linear_solver='pcd')
s.set_boundary_conditions(
    ((VelocityBCType.no_slip, M.left.value, None),
     (VelocityBCType.no_slip, M.right.value, None),
     (VelocityBCType.no_slip, M.bottom.value, None),
     (VelocityBCType.constant, M.top.value, (1.0, 0.0))))
s.set_equation_coefficients(
    {'convective_term': 1.0, 'viscous_term': 1.0 / 100.0,
     'pressure_term': 1.0, 'coriolis_term': None, 'euler_term': None,
     'body_force_term': None})
assert s._solution is None
x64 = s.solve_refined(tol=1e-10, maxiter=25)
assert x64.dtype == np.float64
r = residual_f64(s.space, x64, s._bc_dofs_all,
                 np.asarray(s._bc_values(), dtype=np.float64), s._scalars())
rn = float(np.linalg.norm(r))
assert rn <= 1e-10, rn
print('F32-REFINEMENT-OK', rn)
"""
    import os

    env = dict(os.environ)
    env.pop("JAX_ENABLE_X64", None)
    env["XLA_FLAGS"] = ""
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=1200)
    assert "F32-REFINEMENT-OK" in out.stdout, (out.stdout[-2000:],
                                               out.stderr[-2000:])
