"""Fully-jitted semi-implicit projection step (the cell-loop hot path).

One incremental-pressure-correction step with explicitly extrapolated
convection -- the scheme of the reference's own prototype
(scripts/test_ipcs.py:102-171: extrapolated convection, incremental
pressure Poisson, mass-matrix velocity correction), compiled into a single
XLA program: three Jacobi-preconditioned matrix-free CG solves whose
matvecs are precomputed element-matrix applications with transpose-gather
scatter (see parallel/sharded.py), optionally sharded over a device mesh.

Per step, for SBDF coefficients (alpha0, alpha1, alpha2) / extrapolation
(eta0, eta1) and step size k:

  1. Helmholtz:  (alpha0/k M + nu K) u* =
                   -(alpha1/k) M u_n - (alpha2/k) M u_{n-1}
                   - C(eta0 u_n + eta1 u_{n-1}) - G p_n
  2. Poisson:    L phi = (alpha0/k) D u*          (mean-free; warm-started
                 from the previous step's increment)
  3. Correction: M u_{n+1} = M u* - (k/alpha0) G phi,  p_{n+1} = p_n + phi

This is the benchmark path (periodic problems: no Dirichlet masking in the
inner loops; the mean pressure mode is projected out inside CG).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _pcg(matvec, b, x0, iters, inv_diag=None, project=None, rtol=None):
    """Preconditioned CG: fixed-iteration (static schedule) or,
    with ``rtol``, tolerance-controlled (``lax.while_loop`` with ``iters``
    as the cap).  Returns ``(x, ||r||)`` so callers can assert/record
    convergence instead of trusting a fixed sweep."""

    def precond(r):
        return r if inv_diag is None else inv_diag * r

    def body(state):
        i, x, r, z, p, rz = state
        Ap = matvec(p)
        denom = jnp.vdot(p, Ap)
        # guard fixed-iteration breakdown: once converged (rz ~ 0) the
        # updates freeze instead of dividing 0/0
        alpha = jnp.where(jnp.abs(denom) > 0.0, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        if project is not None:
            r = project(r)
        z = precond(r)
        rz_new = jnp.vdot(r, z)
        beta = jnp.where(jnp.abs(rz) > 0.0, rz_new / rz, 0.0)
        p = z + beta * p
        return i + 1, x, r, z, p, rz_new

    r0 = b - matvec(x0)
    if project is not None:
        r0 = project(r0)
    z0 = precond(r0)
    state = (jnp.asarray(0), x0, r0, z0, z0, jnp.vdot(r0, z0))
    if rtol is None:
        state = jax.lax.fori_loop(0, iters,
                                  lambda _, s: body(s), state)
    else:
        norm_b = jnp.linalg.norm(b)

        def cond(state):
            i, _, r, *_ = state
            return jnp.logical_and(
                i < iters, jnp.linalg.norm(r) > rtol * norm_b)

        state = jax.lax.while_loop(cond, body, state)
    _, x, r, *_ = state
    return x, jnp.linalg.norm(r)


def build_projection_step(space, ops, *, visc, dt, cg_iters=(12, 45, 8),
                          vel_bc=None, pres_bc_mask=None, conv_coeff=1.0,
                          cg_rtol=None, with_residuals=False):
    """Build ``step(u, u_old, p, phi, alpha, eta) -> (u_new, p_new, phi)``.

    ``ops``: a ShardedCellOperator providing the matvec factories.
    ``alpha = (a0, a1, a2)`` are the BDF weights, ``eta`` the convection
    extrapolation weights -- both traced, so variable steps never
    recompile.  ``phi`` is the previous pressure increment (pass zeros on
    the first step); it warm-starts the Poisson solve.

    Boundary conditions:
      * ``vel_bc=None``: fully periodic velocity (no masking);
        ``vel_bc=(mask, values)``: full-length (n_u,) boolean mask and
        value arrays applied to both velocity solves (steady data).
      * ``pres_bc_mask=None``: enclosed flow -- the Poisson solve runs
        mean-free; ``pres_bc_mask``: (n_p,) boolean mask where the
        pressure is prescribed (the increment vanishes there).

    Residual control: ``cg_rtol`` switches the three CG
    sweeps from fixed iteration counts to a relative-residual stop with
    ``cg_iters`` as caps; ``with_residuals=True`` makes ``step`` return a
    fourth element, the final (Helmholtz, Poisson, correction) residual
    norms, for per-step monitoring/assertion.

    The step also accepts two optional traced keyword arguments:
    ``bc_values`` (per-step velocity Dirichlet data, e.g. a time-dependent
    inflow) and ``k`` (the step size -- defaults to the built ``dt``;
    passing it traced makes variable step sizes recompile-free).
    """
    mass_u = ops.make_velocity_mass()
    helm = ops.make_velocity_helmholtz(visc)
    grad = ops.make_gradient()
    div = ops.make_divergence()
    stiff_p = ops.make_pressure_stiffness()
    conv = ops.make_convection_rhs(conv_coeff)
    diag_m, diag_k, diag_l = ops.diagonals()

    def inv(d):
        return 1.0 / jnp.where(jnp.abs(d) > 1e-30, d, 1.0)

    inv_diag_l = inv(diag_l)

    if vel_bc is not None:
        v_free = jnp.where(jnp.asarray(vel_bc[0]), 0.0, 1.0).astype(
            diag_m.dtype)
        v_vals_static = jnp.asarray(vel_bc[1], dtype=diag_m.dtype)
    if pres_bc_mask is not None:
        p_free = jnp.where(jnp.asarray(pres_bc_mask), 0.0, 1.0).astype(
            diag_l.dtype)

    def masked_u(A, v_vals):
        """SPD-preserving Dirichlet projection of a velocity operator."""
        if vel_bc is None:
            return A, lambda b, x0: (b, x0)

        def A_masked(v):
            return v_free * A(v_free * v) + (1.0 - v_free) * v

        def fix_rhs(b, x0):
            g = (1.0 - v_free) * v_vals
            return (v_free * (b - A(g)) + g,
                    v_free * x0 + g)

        return A_masked, fix_rhs

    if pres_bc_mask is None:
        def project_p(r):
            return r - jnp.mean(r)

        def stiff_masked(v):
            return stiff_p(v)
    else:
        def project_p(r):
            return p_free * r

        def stiff_masked(v):
            return p_free * stiff_p(p_free * v) + (1.0 - p_free) * v

    @jax.jit
    def step(u, u_old, p, phi, alpha, eta, bc_values=None, k=None,
             body_rhs=None):
        """``bc_values``: optional traced override of the (steady) velocity
        BC value array -- pass per step for time-dependent inflow.
        ``k``: optional traced step size (defaults to the built ``dt``).
        ``body_rhs``: optional traced velocity-space load vector
        (pre-assembled body force) added to the momentum RHS."""
        a0, a1, a2 = alpha
        if k is None:
            k = dt
        if vel_bc is not None:
            v_vals = v_vals_static if bc_values is None else bc_values
        else:
            v_vals = None

        # (1) velocity Helmholtz solve (mass-dominated: few iterations)
        u_ext = eta[0] * u + eta[1] * u_old
        b = (-(a1 / k) * mass_u(u) - (a2 / k) * mass_u(u_old)
             - conv(u_ext) - grad(p))
        if body_rhs is not None:
            b = b + body_rhs
        inv_diag_h = inv((a0 / k) * diag_m + visc * diag_k)
        H = lambda v: helm(v, a0 / k)
        H_m, fix = masked_u(H, v_vals)
        b, x0 = fix(b, u)
        u_star, res_h = _pcg(H_m, b, x0, cg_iters[0], inv_diag=inv_diag_h,
                             rtol=cg_rtol)

        # (2) incremental pressure Poisson (warm-started)
        rhs = project_p((a0 / k) * div(u_star))
        phi_new, res_p = _pcg(stiff_masked, rhs, project_p(phi),
                              cg_iters[1], inv_diag=inv_diag_l,
                              project=project_p, rtol=cg_rtol)

        # (3) velocity correction
        b_corr = mass_u(u_star) - (k / a0) * grad(phi_new)
        M_m, fix = masked_u(mass_u, v_vals)
        b_corr, x0 = fix(b_corr, u_star)
        u_new, res_m = _pcg(M_m, b_corr, x0, cg_iters[2],
                            inv_diag=inv(diag_m), rtol=cg_rtol)

        p_new = p + phi_new
        if pres_bc_mask is None:
            p_new = p_new - jnp.mean(p_new)
        if with_residuals:
            return u_new, p_new, phi_new, jnp.stack([res_h, res_p, res_m])
        return u_new, p_new, phi_new

    return step
