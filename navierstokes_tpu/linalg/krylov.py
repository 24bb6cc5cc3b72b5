"""Device Krylov solvers.

These replace the PETSc LU / KSP solves of the reference
(``PETScLUSolver``, ns_solver_base.py:938; ``LinearVariationalSolver``,
ns_ipcs_solver.py:171,196) with jit-compiled iterative methods running on
the device: CG for the SPD sub-problems (pressure Poisson, mass matrices) and
(F)GMRES/BiCGStab for nonsymmetric systems.  All accept either a
``CSRMatrix`` / dense matrix or a matvec callable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _as_matvec(A):
    if callable(A) and not hasattr(A, "matvec"):
        return A
    if hasattr(A, "matvec"):
        return A.matvec
    A = jnp.asarray(A)
    return lambda x: A @ x


def jacobi_preconditioner(diag, floor=1e-30):
    """Inverse-diagonal preconditioner with a zero guard."""
    safe = jnp.where(jnp.abs(diag) > floor, diag, 1.0)
    inv = 1.0 / safe
    return lambda x: inv * x


def cg(A, b, x0=None, tol=1e-12, atol=0.0, maxiter=None, M=None):
    """Preconditioned conjugate gradients (jax.scipy backend).

    Returns ``(x, residual_norm)``.  A positive ``tol`` below the
    precision of ``b``'s dtype is raised to it: in float32 a 1e-14 target
    drives the recursive residual to underflow and CG's step to 0/0.
    """
    mv = _as_matvec(A)
    if maxiter is None:
        maxiter = 10 * len(b)
    if tol > 0.0:
        tol = max(tol, 8.0 * float(jnp.finfo(jnp.result_type(b)).eps))
    x, _ = jax.scipy.sparse.linalg.cg(mv, b, x0=x0, tol=tol, atol=atol,
                                      maxiter=maxiter, M=M)
    res = jnp.linalg.norm(b - mv(x))
    return x, res


def bicgstab(A, b, x0=None, tol=1e-12, atol=0.0, maxiter=None, M=None):
    mv = _as_matvec(A)
    if maxiter is None:
        maxiter = 10 * len(b)
    x, _ = jax.scipy.sparse.linalg.bicgstab(mv, b, x0=x0, tol=tol, atol=atol,
                                            maxiter=maxiter, M=M)
    res = jnp.linalg.norm(b - mv(x))
    return x, res


def gmres(A, b, x0=None, tol=1e-12, atol=0.0, maxiter=None, restart=60,
          M=None):
    mv = _as_matvec(A)
    if maxiter is None:
        maxiter = 20 * max(1, len(b) // restart)
    x, _ = jax.scipy.sparse.linalg.gmres(mv, b, x0=x0, tol=tol, atol=atol,
                                         restart=restart, maxiter=maxiter,
                                         M=M, solve_method="batched")
    res = jnp.linalg.norm(b - mv(x))
    return x, res


def masked_spd_solve(A_fn, b, bc_mask, bc_values, tol=1e-12, maxiter=None,
                     diag=None, M=None, x0=None):
    """Solve A x = b with Dirichlet constraints, preserving SPD structure.

    ``bc_mask``: (n,) bool, True at constrained dofs; ``bc_values``: full
    (n,) array carrying the constraint values at those dofs (other entries
    ignored).  Uses the projected operator

        A'(v) = free . A(free . v) + constrained . v

    with RHS  free . (b - A(g)) + constrained . g, then runs CG.

    ``diag``: Jacobi preconditioner from the operator diagonal; ``M``: an
    explicit preconditioner apply (e.g. an AMG V-cycle built on the
    symmetrically-pinned matrix) -- overrides ``diag``.  ``x0``: warm
    start (constrained entries are overwritten with the BC values).
    """
    free = jnp.where(bc_mask, 0.0, 1.0)
    g = jnp.where(bc_mask, bc_values, 0.0)

    def masked(v):
        return free * A_fn(free * v) + (1.0 - free) * v

    rhs = free * (b - A_fn(g)) + g
    if M is None and diag is not None:
        safe = jnp.where(free > 0.0, jnp.where(jnp.abs(diag) > 1e-30,
                                               diag, 1.0), 1.0)
        inv = 1.0 / safe

        def M(v):  # noqa: F811
            return inv * v

    start = g if x0 is None else free * x0 + g
    x, res = cg(masked, rhs, x0=start, tol=tol, maxiter=maxiter, M=M)
    return x, res
