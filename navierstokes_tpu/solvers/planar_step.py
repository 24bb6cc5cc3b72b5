"""Fully-jitted projection step over the gather-free operator engine.

Same incremental pressure-correction scheme as ``solvers/fused_step.py``
(the reference's own prototype scripts/test_ipcs.py:102-171: extrapolated
convection, incremental pressure Poisson, mass-matrix velocity
correction), but in *planar* velocity layout ``(dim, n_unodes)`` over a
``FastTaylorHood`` suite (assembly/fastop.py): every matvec inside the
three CG solves is roll/window streaming -- no gathers anywhere in the
per-iteration path except the once-per-step convection assembly.

The operator bundle (``PlanarOps``) is threaded through ``jax.jit`` as an
argument pytree -- the band arrays are hundreds of MB and must not be
embedded as HLO constants.

State vectors live in the engine's permuted node numbering; use the
engine's (un)permute helpers at solver boundaries.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from navierstokes_tpu.assembly.fastop import conv_apply


def _pcg(matvec, b, x0, iters, inv_diag=None, project=None, rtol=None,
         precond_fn=None):
    """Preconditioned CG (planar-friendly).  Returns ``(x, ||r||)``.

    ``precond_fn`` (e.g. an AMG V-cycle) takes precedence over the Jacobi
    ``inv_diag``; its output is re-projected when a nullspace projector is
    active (deflated PCG) so the search stays in the mean-free subspace.
    """

    def precond(r):
        if precond_fn is not None:
            z = precond_fn(r)
            return z if project is None else project(z)
        return r if inv_diag is None else inv_diag * r

    def body(state):
        i, x, r, z, p, rz = state
        Ap = matvec(p)
        denom = jnp.vdot(p, Ap)
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
        state = jax.lax.fori_loop(0, iters, lambda _, s: body(s), state)
    else:
        norm_b = jnp.linalg.norm(b.reshape(-1))

        def cond(state):
            i, _, r, *_ = state
            return jnp.logical_and(
                i < iters, jnp.linalg.norm(r.reshape(-1)) > rtol * norm_b)

        state = jax.lax.while_loop(cond, body, state)
    _, x, r, *_ = state
    return x, jnp.linalg.norm(r.reshape(-1))


@partial(jax.jit, static_argnames=("visc", "conv_coeff", "cg_iters",
                                   "cg_rtol", "with_residuals",
                                   "p_precond", "rotational",
                                   "conv_strided"))
def _step_core(ops, masks, u, u_old, p, phi, alpha, eta, bc_values, k,
               body_rhs, *, visc, conv_coeff, cg_iters, cg_rtol,
               with_residuals, p_precond=None, rotational=False,
               conv_strided=None):
    v_free, v_vals_static, p_free = masks
    a0, a1, a2 = alpha

    def inv(d):
        return 1.0 / jnp.where(jnp.abs(d) > 1e-30, d, 1.0)

    mass_u = ops.M.apply

    from navierstokes_tpu.assembly.fastop import (CirculantBand,
                                                  combine_circulant)

    if isinstance(ops.M, CirculantBand) and isinstance(ops.K,
                                                       CirculantBand):
        # one fused band: halves the band traffic and kernel count of
        # every velocity-CG iteration (combine paid once per step)
        helm = combine_circulant([(a0 / k, ops.M), (visc, ops.K)]).apply
    else:
        def helm(v):
            return (a0 / k) * ops.M.apply(v) + visc * ops.K.apply(v)

    def grad(q):
        return jnp.stack([Gd.apply(q) for Gd in ops.G], axis=0)

    def div(v):
        acc = ops.D[0].apply(v[0])
        for d in range(1, len(ops.D)):
            acc = acc + ops.D[d].apply(v[d])
        return acc

    if v_free is not None:
        v_vals = v_vals_static if bc_values is None else bc_values

        def masked_u(A):
            def A_masked(v):
                return v_free * A(v_free * v) + (1.0 - v_free) * v

            def fix_rhs(b, x0):
                g = (1.0 - v_free) * v_vals
                return (v_free * (b - A(g)) + g, v_free * x0 + g)

            return A_masked, fix_rhs
    else:
        def masked_u(A):
            return A, lambda b, x0: (b, x0)

    if p_free is None:
        def project_p(r):
            return r - jnp.mean(r)

        stiff_masked = ops.L.apply
    else:
        def project_p(r):
            return p_free * r

        def stiff_masked(v):
            return p_free * ops.L.apply(p_free * v) + (1.0 - p_free) * v

    # (1) velocity Helmholtz solve
    u_ext = eta[0] * u + eta[1] * u_old
    b = (-(a1 / k) * mass_u(u) - (a2 / k) * mass_u(u_old)
         - conv_apply(ops, u_ext, conv_coeff, strided=conv_strided)
         - grad(p))
    if body_rhs is not None:
        b = b + body_rhs
    inv_diag_h = inv((a0 / k) * ops.diag_m + visc * ops.diag_k)
    H_m, fix = masked_u(helm)
    b, x0 = fix(b, u)
    u_star, res_h = _pcg(H_m, b, x0, cg_iters[0], inv_diag=inv_diag_h,
                         rtol=cg_rtol)

    # (2) incremental pressure Poisson (warm-started)
    rhs = project_p((a0 / k) * div(u_star))
    phi_new, res_p = _pcg(stiff_masked, rhs, project_p(phi), cg_iters[1],
                          inv_diag=inv(ops.diag_l), project=project_p,
                          rtol=cg_rtol, precond_fn=p_precond)

    # (3) velocity correction
    b_corr = mass_u(u_star) - (k / a0) * grad(phi_new)
    M_m, fix = masked_u(mass_u)
    b_corr, x0 = fix(b_corr, u_star)
    u_new, res_m = _pcg(M_m, b_corr, x0, cg_iters[2],
                        inv_diag=inv(ops.diag_m), rtol=cg_rtol)

    p_new = p + phi_new
    if rotational:
        # Timmermans/Guermond rotational correction: p += phi - nu div u*.
        # The standard incremental update leaves an O(dt) artificial
        # pressure boundary layer (implied d phi/dn = 0 on no-slip walls)
        # that biases pressure-dominated wall forces; subtracting the
        # L2-projected nodal divergence restores consistent pressure
        # boundary data (O(dt^2) pressure; Guermond/Minev/Shen 2006).
        # div() returns -int(N1 div u), so the nodal field solves
        # Mp d = -div(u_star).
        d_nodal, _ = _pcg(ops.Mp.apply, -div(u_star),
                          jnp.zeros_like(phi_new), cg_iters[2],
                          inv_diag=inv(ops.diag_mp))
        corr = visc * d_nodal
        if p_free is not None:
            corr = p_free * corr
        p_new = p_new - corr
    if p_free is None:
        p_new = p_new - jnp.mean(p_new)
    if with_residuals:
        return u_new, p_new, phi_new, jnp.stack([res_h, res_p, res_m])
    return u_new, p_new, phi_new


def build_poisson_amg(fast, pres_bc_mask=None, **amg_kwargs):
    """AMG V-cycle preconditioner for the planar step's pressure Poisson,
    in the engine's permuted P1 numbering.

    Fixed Jacobi-CG sweeps on the Poisson solve degrade as O(1/h) -- the
    DFG/cavity marches pay 250-300 CG iterations per step where an AMG
    V-cycle holds the count h-independent (~10-20).  Setup is host-side
    scipy (once per mesh); ``apply`` is jittable and scan-safe.

    ``pres_bc_mask``: permuted boolean mask of prescribed-pressure nodes
    (same convention as ``build_planar_projection_step``); ``None`` =
    enclosed flow (semidefinite Laplacian regularized with a small mass
    shift -- the outer CG still projects out the mean).
    """
    import numpy as np

    from navierstokes_tpu.linalg.amg import AMG, pressure_laplacian_scipy

    space = fast.space
    perm = np.asarray(fast.permP)
    if pres_bc_mask is not None:
        dofs = perm[np.where(np.asarray(pres_bc_mask))[0]]
        A = pressure_laplacian_scipy(space, dirichlet_dofs=dofs)
    else:
        # unshifted semidefinite Laplacian: the coarsest level is a pinv
        # and the outer CG's mean-free projection keeps everything in the
        # SPD subspace (measured: a mass shift only degrades the rate)
        A = pressure_laplacian_scipy(space)
    amg = AMG(A[perm][:, perm], **amg_kwargs)

    # the V-cycle's level-0 matvec (smoother + residual) dominates its
    # cost; route it through the gather-free banded operator instead of
    # the device CSR's gather/segment-sum path -- identical matrix
    if amg.levels:
        if pres_bc_mask is not None:
            p_free = jnp.where(jnp.asarray(np.asarray(pres_bc_mask)),
                               0.0, 1.0).astype(amg.levels[0]["dinv"].dtype)

            def mv(v):
                return p_free * fast.L.apply(p_free * v) + (1.0 - p_free) * v
        else:
            mv = fast.L.apply

        class _Banded0:
            matvec = staticmethod(mv)

        amg.levels[0]["A"] = _Banded0()
    return amg


def build_planar_projection_step(fast, *, visc, dt, cg_iters=(12, 45, 8),
                                 vel_bc=None, pres_bc_mask=None,
                                 conv_coeff=1.0, cg_rtol=None,
                                 with_residuals=False,
                                 poisson_precond=None, rotational=False):
    """Build ``step(u, u_old, p, phi, alpha, eta, ...)`` (planar layout).

    ``fast``: a FastTaylorHood engine.  Velocity states are
    ``(dim, n_unodes)``, pressures ``(n_pnodes,)``, all in the engine's
    permuted numbering.  ``alpha=(a0,a1,a2)`` BDF weights, ``eta`` the
    convection extrapolation weights (traced: variable steps never
    recompile).

    Boundary conditions (arrays in permuted numbering):
      * ``vel_bc=(mask, values)``: planar (dim, Nu) boolean mask + values;
        ``None`` = fully periodic.
      * ``pres_bc_mask``: (Np,) boolean where the pressure is prescribed;
        ``None`` = enclosed flow (mean-free Poisson solve).

    Optional traced keywords of the returned step: ``bc_values`` (per-step
    velocity Dirichlet data), ``k`` (step size; defaults to ``dt``),
    ``body_rhs`` (pre-assembled velocity load).

    ``poisson_precond``: ``None`` (Jacobi), ``"amg"`` (build an AMG
    V-cycle via :func:`build_poisson_amg`), or any jittable callable
    ``r -> z`` in permuted pressure numbering.

    Matches the semantics of solvers/fused_step.py:78 (same scheme, planar
    layout); reference scheme: scripts/test_ipcs.py:102-171.
    """
    if poisson_precond == "amg":
        poisson_precond = build_poisson_amg(fast, pres_bc_mask).apply
    ops = fast.ops
    dtype = ops.diag_m.dtype
    if vel_bc is not None:
        v_free = jnp.where(jnp.asarray(vel_bc[0]), 0.0, 1.0).astype(dtype)
        v_vals = jnp.asarray(vel_bc[1], dtype=dtype)
    else:
        v_free = v_vals = None
    if pres_bc_mask is not None:
        p_free = jnp.where(jnp.asarray(pres_bc_mask), 0.0, 1.0).astype(
            dtype)
    else:
        p_free = None
    masks = (v_free, v_vals, p_free)
    dt_default = jnp.asarray(dt, dtype)

    def step(u, u_old, p, phi, alpha, eta, bc_values=None, k=None,
             body_rhs=None):
        if k is None:
            k = dt_default
        return _step_core(ops, masks, u, u_old, p, phi, tuple(alpha),
                          tuple(eta), bc_values, k, body_rhs,
                          visc=float(visc), conv_coeff=float(conv_coeff),
                          cg_iters=tuple(int(i) for i in cg_iters),
                          cg_rtol=None if cg_rtol is None else float(cg_rtol),
                          with_residuals=bool(with_residuals),
                          p_precond=poisson_precond,
                          rotational=bool(rotational),
                          conv_strided=getattr(fast, "conv_strided",
                                               None))

    # expose the traced-argument pieces so callers embedding the step in a
    # LARGER jitted program (e.g. a lax.scan over steps) can pass the
    # operator bundle as an argument instead of closing over it -- a
    # closure would bake the band arrays into the HLO as constants
    step.ops = ops
    step.masks = masks
    step.static = dict(
        visc=float(visc), conv_coeff=float(conv_coeff),
        cg_iters=tuple(int(i) for i in cg_iters),
        cg_rtol=None if cg_rtol is None else float(cg_rtol),
        p_precond=poisson_precond, rotational=bool(rotational),
        conv_strided=getattr(fast, "conv_strided", None))
    return step
