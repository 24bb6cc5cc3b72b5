"""Host-side float64 residual assembly (NumPy).

Two jobs:

* the high-precision half of **mixed-precision iterative refinement**:
  the device runs float32 Krylov (fast), the host evaluates the true
  float64 residual and accumulates the float64 iterate, so the
  reference's ||F|| <= 1e-10 contract
  (the reference's source/ns_solver_base.py:986-988) holds even though
  the accelerator has no fast float64 path (SURVEY.md hard part #5);
* an independent cross-check of the jitted device kernels (same math,
  different code path and arithmetic order).

Mirrors ``assembly/kernels.make_cell_residual`` term by term.
"""

from __future__ import annotations

import numpy as np

from navierstokes_tpu.fem.bcs import (WeakFormConvectiveTerm,
                                      WeakFormViscousTerm,
                                      parse_convective_form,
                                      parse_viscous_form)


def element_residuals_f64(space, u_c, p_c, scalars, *,
                          form_convective_term="standard",
                          form_viscous_term="reduced", source_q=0.0):
    """Per-cell residual contributions (r_u_c (nc,nn2,d), r_p_c (nc,nn1))
    in float64 -- the quadrature core shared by :func:`residual_f64` and
    the central-difference element Jacobians of :func:`jacobian_f64`.
    """
    conv_form = parse_convective_form(form_convective_term)
    visc_form = parse_viscous_form(form_viscous_term)
    dim = space.dim

    N2 = np.asarray(space.N2, dtype=np.float64)
    G2 = np.asarray(space.G2, dtype=np.float64)
    N1 = np.asarray(space.N1, dtype=np.float64)
    Jinv = np.asarray(space.Jinv_q, dtype=np.float64)
    W = np.asarray(space.integration_weights(), dtype=np.float64)

    cc = scalars.get("cc")
    cv = float(scalars["cv"])
    cp_coef = float(scalars["cp"])
    accel0 = float(scalars.get("accel0", 0.0))

    g2 = np.einsum("qia,cqae->cqie", G2, Jinv)
    v_q = np.einsum("qi,cid->cqd", N2, u_c)            # (nc, nq, d)
    grad_v = np.einsum("cid,cqie->cqde", u_c, g2)
    p_q = np.einsum("qj,cj->cq", N1, p_c)

    mom = accel0 * v_q + np.asarray(source_q, dtype=v_q.dtype)
    if cc is not None:
        cc = float(cc)
        if conv_form is WeakFormConvectiveTerm.standard_form:
            mom = mom + cc * np.einsum("cqde,cqe->cqd", grad_v, v_q)
        elif conv_form is WeakFormConvectiveTerm.rotational_form:
            if dim == 2:
                curl = grad_v[:, :, 1, 0] - grad_v[:, :, 0, 1]
                mom = mom + cc * np.stack(
                    [-curl * v_q[..., 1], curl * v_q[..., 0]], axis=-1)
            else:
                curl = np.stack(
                    [grad_v[:, :, 2, 1] - grad_v[:, :, 1, 2],
                     grad_v[:, :, 0, 2] - grad_v[:, :, 2, 0],
                     grad_v[:, :, 1, 0] - grad_v[:, :, 0, 1]], axis=-1)
                mom = mom + cc * np.cross(curl, v_q)
        elif conv_form is WeakFormConvectiveTerm.divergence_form:
            div_u = np.trace(grad_v, axis1=2, axis2=3)
            mom = mom + cc * (np.einsum("cqde,cqe->cqd", grad_v, v_q)
                              + 0.5 * div_u[..., None] * v_q)
        elif conv_form is WeakFormConvectiveTerm.skew_symmetric_form:
            mom = mom + 0.5 * cc * np.einsum("cqde,cqe->cqd", grad_v, v_q)
    if "cor" in scalars:
        cor = scalars["cor"]
        if dim == 2:
            mom = mom + float(cor) * np.stack(
                [-v_q[..., 1], v_q[..., 0]], axis=-1)
        else:
            mom = mom + np.cross(
                np.broadcast_to(np.asarray(cor, dtype=np.float64),
                                v_q.shape), v_q)

    if visc_form is WeakFormViscousTerm.traction_form:
        stress = cv * (grad_v + np.swapaxes(grad_v, 2, 3))
    else:
        stress = cv * grad_v
    stress = stress - cp_coef * p_q[..., None, None] * np.eye(dim)
    if cc is not None and \
            conv_form is WeakFormConvectiveTerm.skew_symmetric_form:
        stress = stress - 0.5 * cc * np.einsum("cqd,cqe->cqde", v_q, v_q)

    r_u_c = (np.einsum("cq,cqd,qi->cid", W, mom, N2)
             + np.einsum("cq,cqde,cqie->cid", W, stress, g2))
    div_v = np.trace(grad_v, axis1=2, axis2=3)
    r_p_c = -cp_coef * np.einsum("cq,cq,qj->cj", W, div_v, N1)
    return r_u_c, r_p_c


def residual_f64(space, x, bc_dofs, bc_values, scalars, *,
                 form_convective_term="standard",
                 form_viscous_term="reduced", source_q=0.0,
                 extra_ru=None, mask_bcs=True) -> np.ndarray:
    """Assembled mixed residual in float64, vectorized NumPy.

    ``x``: (n_dofs,) float64 mixed vector; ``scalars``: the solver's
    coefficient dict (plain floats; ``cor`` optional); ``source_q``:
    scalar 0.0 or (nc, nq, d) float64 momentum source; ``extra_ru``:
    optional (n_unodes, d) float64 pre-scattered contribution.
    """
    dim = space.dim
    cu = np.asarray(space.cell_unodes)
    cp_ = np.asarray(space.cell_pnodes)

    x = np.asarray(x, dtype=np.float64)
    u = x[:space.n_velocity_dofs].reshape(space.n_unodes, dim)
    p = x[space.n_velocity_dofs:]

    r_u_c, r_p_c = element_residuals_f64(
        space, u[cu], p[cp_], scalars,
        form_convective_term=form_convective_term,
        form_viscous_term=form_viscous_term, source_q=source_q)

    r_u = np.zeros((space.n_unodes, dim))
    np.add.at(r_u, cu.ravel(), r_u_c.reshape(-1, dim))
    if extra_ru is not None:
        r_u = r_u + np.asarray(extra_ru, dtype=np.float64)
    r_p = np.zeros(space.n_pnodes)
    np.add.at(r_p, cp_.ravel(), r_p_c.reshape(-1))

    r = np.concatenate([r_u.reshape(-1), r_p])
    if mask_bcs:
        bc_dofs = np.asarray(bc_dofs)
        r[bc_dofs] = x[bc_dofs] - np.asarray(bc_values, dtype=np.float64)
    return r


def jacobian_f64(space, x, bc_dofs, scalars, *,
                 form_convective_term="standard",
                 form_viscous_term="reduced", pin_dof=None):
    """Assembled float64 Newton Jacobian as scipy CSR (host).

    Element Jacobians by **central differences with h=1 over the
    cell-local dofs**: the Navier-Stokes residual is at most quadratic in
    (u, p), so central differences are *exact* -- the only error is f64
    roundoff (~1e-13 relative), far below the 1e-10 contract.  30 (2D) /
    68 (3D) vectorized quadrature sweeps, seconds at 1e5 dofs.

    Constrained rows become identity; ``pin_dof`` adds one more identity
    row (enclosed-flow pressure gauge, making the saddle matrix
    nonsingular).  Used as the refinement fallback for residual
    directions the float32 preconditioned Krylov cannot reach
    (pressure-Dirichlet cases floor at ~4.5e-7 otherwise; see
    ``StationarySolverBase.solve_refined``).
    """
    import scipy.sparse as sp

    dim = space.dim
    cu = np.asarray(space.cell_unodes)
    cp_ = np.asarray(space.cell_pnodes)
    nn2 = cu.shape[1]
    nn1 = cp_.shape[1]
    n_loc = nn2 * dim + nn1
    nc = cu.shape[0]

    x = np.asarray(x, dtype=np.float64)
    u = x[:space.n_velocity_dofs].reshape(space.n_unodes, dim)
    p = x[space.n_velocity_dofs:]
    u_c0 = u[cu]
    p_c0 = p[cp_]

    kw = dict(form_convective_term=form_convective_term,
              form_viscous_term=form_viscous_term)
    h = 1.0
    cols = []
    for j in range(n_loc):
        du = np.zeros((nn2, dim))
        dp = np.zeros(nn1)
        if j < nn2 * dim:
            du[j // dim, j % dim] = h
        else:
            dp[j - nn2 * dim] = h
        rp_u, rp_p = element_residuals_f64(space, u_c0 + du, p_c0 + dp,
                                           scalars, **kw)
        rm_u, rm_p = element_residuals_f64(space, u_c0 - du, p_c0 - dp,
                                           scalars, **kw)
        col = np.concatenate(
            [((rp_u - rm_u) / (2 * h)).reshape(nc, -1),
             ((rp_p - rm_p) / (2 * h)).reshape(nc, -1)], axis=1)
        cols.append(col)
    elem = np.stack(cols, axis=2)                    # (nc, n_loc, n_loc)

    # global dof ids per cell-local slot
    gdofs = np.concatenate(
        [(cu[:, :, None] * dim + np.arange(dim)).reshape(nc, -1),
         space.n_velocity_dofs + cp_], axis=1)       # (nc, n_loc)
    rows = np.repeat(gdofs, n_loc, axis=1).ravel()
    colsg = np.tile(gdofs, (1, n_loc)).ravel()
    n = space.n_dofs
    A = sp.coo_matrix((elem.ravel(), (rows, colsg)), shape=(n, n)).tocsr()

    constrained = np.zeros(n, dtype=bool)
    constrained[np.asarray(bc_dofs)] = True
    if pin_dof is not None:
        constrained[int(pin_dof)] = True
    keep = ~constrained[A.indices]                  # zero constrained cols?
    # rows: zero constrained rows, then identity diagonal.  Columns stay
    # (the correction solve carries zero increments at constrained dofs,
    # so off-diagonal column entries multiply zeros and are harmless).
    free_rows = ~constrained
    D = sp.diags(free_rows.astype(np.float64))
    A = D @ A + sp.diags(constrained.astype(np.float64))
    del keep
    return A.tocsr()
