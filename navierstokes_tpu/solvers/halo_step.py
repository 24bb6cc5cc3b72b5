"""Domain-decomposed projection step over the halo-exchange layer.

The same incremental pressure-correction scheme as
``solvers/fused_step.py`` (reference prototype scripts/test_ipcs.py:102-171),
but every state vector is *partitioned* over a ``jax.sharding.Mesh``:
per-device memory is O(dofs/n_dev + halo) and each matvec moves only the
halo over the interconnect (``lax.ppermute`` inside the HaloCellOperator kernels).
This is the multi-chip slot of the reference stack -- parmetis/MPI domain
decomposition + distributed PETSc solves
(/root/reference/environment.yml:63-65, SURVEY.md par.2.2) -- expressed
as XLA collectives.

Layout contract: velocity vectors are ``(nu_pad*dim,)`` node-major in the
operator's owner-major partitioned numbering (``HaloCellOperator.
pad_velocity``), pressures ``(np_pad,)``; padding slots hold zeros and are
kept zero by construction (padded cells carry zero quadrature weight, and
the mean/mask projections re-zero them).  Dot products inside CG run on
the sharded vectors directly -- XLA inserts the all-reduce.

Dirichlet conditions use the same
SPD-preserving mask projection as the single-device steps, with mask and
value arrays converted into the partitioned layout once at build time.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from navierstokes_tpu.solvers.fused_step import _pcg


def build_halo_projection_step(ops, *, visc, dt, cg_iters=(12, 45, 8),
                               vel_bc=None, pres_bc_mask=None,
                               conv_coeff=1.0, cg_rtol=None,
                               with_residuals=False):
    """Build ``step(u, u_old, p, phi, alpha, eta, ...)`` on sharded state.

    ``ops``: a :class:`~navierstokes_tpu.parallel.halo.HaloCellOperator`.
    State lives in the partitioned padded layout (see module docstring);
    use ``ops.pad_velocity``/``ops.unpad_velocity`` (and the pressure
    versions) at solver boundaries.

    ``vel_bc=(mask, values)``: full-length *space-layout* ``(n_u,)``
    boolean mask + value arrays (as for ``build_projection_step``) --
    converted to the partitioned layout here.  ``pres_bc_mask``: space
    layout ``(n_p,)``; ``None`` = enclosed flow (mean-free Poisson).

    The returned step accepts optional traced ``bc_values`` (PARTITIONED
    layout -- convert per step with ``ops.pad_velocity``), ``k`` and
    ``body_rhs`` (partitioned layout).
    """
    mass_u = ops.make_velocity_mass()
    helm = ops.make_velocity_helmholtz(visc)
    grad = ops.make_gradient()
    div = ops.make_divergence()
    stiff_p = ops.make_pressure_stiffness()
    conv = ops.make_convection_rhs(conv_coeff)
    diag_m, diag_k, diag_l = ops.diagonals()
    sh_u = ops.velocity_sharding()

    def inv(d):
        return 1.0 / jnp.where(jnp.abs(d) > 1e-30, d, 1.0)

    inv_diag_l = inv(diag_l)

    # real-slot masks (1 at real nodes, 0 at padding)
    space = ops.space
    real_u = jax.device_put(
        ops.pad_velocity(jnp.ones(space.n_velocity_dofs, ops.dtype)), sh_u)
    real_p = jax.device_put(
        ops.pad_pressure(jnp.ones(space.n_pnodes, ops.dtype)),
        ops.velocity_sharding())
    n_real_p = float(space.n_pnodes)

    if vel_bc is not None:
        free = np.where(np.asarray(vel_bc[0]), 0.0, 1.0)
        v_free = jax.device_put(
            ops.pad_velocity(jnp.asarray(free, dtype=ops.dtype)), sh_u)
        # padding slots: pad_velocity zeroes them; they must stay "free"
        # so the identity branch of the masked operator cannot inject
        # nonzeros -- re-open them via the real-slot mask
        v_free = jnp.where(real_u > 0, v_free, 1.0)
        v_vals_static = jax.device_put(
            ops.pad_velocity(jnp.asarray(vel_bc[1], dtype=ops.dtype)), sh_u)
    if pres_bc_mask is not None:
        freep = np.where(np.asarray(pres_bc_mask), 0.0, 1.0)
        p_free = jax.device_put(
            ops.pad_pressure(jnp.asarray(freep, dtype=ops.dtype)),
            ops.velocity_sharding())
        p_free = jnp.where(real_p > 0, p_free, 1.0)

    def masked_u(A, v_vals):
        if vel_bc is None:
            return A, lambda b, x0: (b, x0)

        def A_masked(v):
            return v_free * A(v_free * v) + (1.0 - v_free) * v

        def fix_rhs(b, x0):
            g = (1.0 - v_free) * v_vals
            return (v_free * (b - A(g)) + g, v_free * x0 + g)

        return A_masked, fix_rhs

    if pres_bc_mask is None:
        def project_p(r):
            # mean over REAL nodes only; padding slots re-zeroed
            return (r - jnp.sum(r) / n_real_p) * real_p

        stiff_masked = stiff_p
    else:
        def project_p(r):
            return p_free * r * real_p

        def stiff_masked(v):
            return p_free * stiff_p(p_free * v) + (1.0 - p_free) * v

    @jax.jit
    def step(u, u_old, p, phi, alpha, eta, bc_values=None, k=None,
             body_rhs=None):
        a0, a1, a2 = alpha
        if k is None:
            k = dt
        if vel_bc is not None:
            v_vals = v_vals_static if bc_values is None else bc_values
        else:
            v_vals = None

        # (1) velocity Helmholtz solve
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
            p_new = (p_new - jnp.sum(p_new) / n_real_p) * real_p
        if with_residuals:
            return u_new, p_new, phi_new, jnp.stack([res_h, res_p, res_m])
        return u_new, p_new, phi_new

    return step
