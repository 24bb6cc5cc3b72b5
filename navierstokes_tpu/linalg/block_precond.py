"""Block (PCD) preconditioning for the monolithic saddle-point system.

The Newton/Picard Jacobian has the block form

    J = [ F  G ]      F: velocity convection-diffusion(-reaction)
        [ D  0 ]      G: pressure gradient, D: divergence

(with identity rows mixed in at Dirichlet dofs).  The PCD
(pressure-convection-diffusion, Kay/Loghin/Wathen; see PAPERS.md)
right preconditioner approximates

    P^{-1} [r_u, r_p]:
        z_p = -S^{-1} r_p,   S^{-1} ~= Lp^{-1} Fp Mp^{-1}
        z_u = F^{-1} (r_u - G z_p)

where Lp / Mp are the pressure Laplacian / mass and
Fp = accel0 Mp + nu Lp + N_p(u) is the pressure-space
convection-diffusion operator.  All sub-solves are fixed-iteration
Jacobi-CG / BiCGStab sweeps on device -- this replaces the reference's
PETSc direct LU (ns_solver_base.py:938) for problem sizes where a
factorization is impossible, and is SURVEY.md "hard part #1".
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from navierstokes_tpu.assembly.operators import (MixedOperator,
                                                 PressurePoissonOperator)
from navierstokes_tpu.linalg.krylov import bicgstab, cg, gmres


class PCDPreconditioner:
    """PCD application bound to a mixed operator + current state."""

    def __init__(self, mixed_op: MixedOperator, J_matvec, *, visc, accel0,
                 u_current, f_iters=8, lp_iters=25, mp_iters=4):
        space = mixed_op.space
        self.n_u = space.n_velocity_dofs
        self.n_p = space.n_pnodes
        self.J = J_matvec
        self.f_iters = f_iters
        self.lp_iters = lp_iters
        self.mp_iters = mp_iters

        self.pop = PressurePoissonOperator(space)
        self.u_q = mixed_op.u_at_quad(u_current)
        self.visc = visc
        self.accel0 = accel0

        # pressure dofs constrained in J (pins / pressure Dirichlet): the
        # preconditioner acts as identity there
        bc = np.asarray(mixed_op._bc_dofs_np)
        p_bc = bc[bc >= self.n_u] - self.n_u
        mask = np.zeros(self.n_p, dtype=bool)
        mask[p_bc] = True
        self.p_bc_mask = jnp.asarray(mask)
        self.p_free = jnp.where(self.p_bc_mask, 0.0, 1.0)
        self.enclosed = len(p_bc) == 0

        u_bc = bc[bc < self.n_u]
        vmask = np.zeros(self.n_u, dtype=bool)
        vmask[u_bc] = True
        self.u_free = jnp.where(jnp.asarray(vmask), 0.0, 1.0)

        import jax

        self.apply = jax.jit(self._apply_impl)

    # -- block applies through the full Jacobian ------------------------------
    def _F_apply(self, v):
        x = jnp.concatenate([v, jnp.zeros(self.n_p, dtype=v.dtype)])
        return self.J(x)[:self.n_u]

    def _G_apply(self, p):
        x = jnp.concatenate([jnp.zeros(self.n_u, dtype=p.dtype), p])
        return self.J(x)[:self.n_u]

    # -- pressure-space solves -------------------------------------------------
    def _project(self, r):
        if self.enclosed:
            return r - jnp.mean(r)
        return self.p_free * r

    def _lp_solve(self, r):
        r = self._project(r)

        def A(v):
            y = self.pop.stiffness_matvec(self._project(v))
            return self._project(y) + (1.0 - self.p_free) * v \
                if not self.enclosed else self._project(y)

        x, _ = cg(A, r, tol=0.0, maxiter=self.lp_iters)
        return self._project(x)

    def _mp_solve(self, r):
        x, _ = cg(self.pop.mass_matvec, r, tol=0.0, maxiter=self.mp_iters)
        return x

    def _fp_apply(self, p):
        return (self.accel0 * self.pop.mass_matvec(p)
                + self.visc * self.pop.stiffness_matvec(p)
                + self.pop.convection_matvec(p, self.u_q))

    # -- the preconditioner ------------------------------------------------------
    def _apply_impl(self, r):
        r_u, r_p = r[:self.n_u], r[self.n_u:]
        # Schur approximation: S^{-1} ~= Lp^{-1} Fp Mp^{-1}
        z_p = -self._lp_solve(self._fp_apply(self._mp_solve(r_p)))
        z_p = jnp.where(self.p_bc_mask, r_p, z_p)
        # velocity solve: F z_u = r_u - G z_p (inexact BiCGStab sweep)
        rhs = r_u - self._G_apply(z_p)
        z_u, _ = bicgstab(self._F_apply, rhs, tol=0.0,
                          maxiter=self.f_iters)
        z_u = self.u_free * z_u + (1.0 - self.u_free) * rhs
        return jnp.concatenate([z_u, z_p])


class MatrixFreePCD:
    """Setup-once, at-scale PCD solver for the monolithic Newton systems.

    Differences from :class:`PCDPreconditioner` (the round-1 layer):

    - the Jacobian is never assembled: ``MixedOperator.linearize_at``
      provides the matvec (one residual-like sweep per application);
    - the pressure-Laplacian solve is an AMG V-cycle (h-independent
      quality; ``linalg/amg.py``) instead of a fixed CG sweep;
    - Mp^{-1} is a short lumped-preconditioned CG on the consistent mass;
    - the velocity block runs one GMRES(f_iters) sweep preconditioned by
      a component-wise AMG V-cycle on the scalar P2 stiffness (optionally
      mass-shifted via ``helmholtz_shift`` ~ accel0/cv);
    - the whole linear solve (linearization, preconditioner, flexible
      GMRES) is ONE jitted XLA program per (picard,) flag -- no per-Newton
      retracing, no host round-trips inside the Krylov loop.

    Setup cost (AMG hierarchy, diagonals) is paid once per space + BC
    configuration; the operators it is built from (pressure Laplacian and
    mass) do not change between Newton steps, time steps or Reynolds
    continuation steps.
    """

    def __init__(self, mixed_op: MixedOperator, *, f_iters=15, mp_iters=5,
                 restart=80, max_cycles=6, helmholtz_shift=0.0,
                 grad_div=0.0, amg_kwargs=None):
        # restart=80: GMRES(40) stagnates on convective Newton systems
        # from Re ~ 200 (measured: restart-40 parks at 2.6e-2 forever at
        # Re=215/32^2 while restart-80 converges to 7e-9 in 238 its);
        # basis memory is 2*81*n, e.g. ~100 MB at 150k dofs in f32.
        import os

        from navierstokes_tpu.linalg.amg import (AMG,
                                                 pressure_laplacian_scipy)

        # augmented-Lagrangian (grad-div) stabilization (Benzi &
        # Olshanskii 2006, SIAM J. Sci. Comput. 28): gamma > 0 adds gamma * G Mp^{-1} D to the
        # velocity block of BOTH the system and the residual (same
        # discrete solution -- D u = 0 at convergence) and replaces the
        # PCD Schur sandwich with the AL approximation
        # S^{-1} ~= -(cv + gamma) Mp^{-1}, which is Re- and h-robust.
        # The price is a stiffer velocity block (the classical AL
        # tradeoff) and one extra Jacobian application per matvec.
        self.grad_div = float(os.environ.get("NS_PCD_GRAD_DIV", grad_div))

        self.op = mixed_op
        space = mixed_op.space
        self.n_u = space.n_velocity_dofs
        self.n_p = space.n_pnodes
        self.dim = space.dim
        self.f_iters = f_iters
        self.mp_iters = mp_iters
        self.restart = restart
        self.max_cycles = max_cycles
        self.pop = PressurePoissonOperator(space)

        bc = np.asarray(mixed_op._bc_dofs_np)
        p_bc = bc[bc >= self.n_u] - self.n_u
        self.enclosed = len(p_bc) == 0
        mask = np.zeros(self.n_p, dtype=bool)
        mask[p_bc] = True
        self.p_bc_mask = jnp.asarray(mask)
        self.p_free = jnp.where(self.p_bc_mask, 0.0, 1.0)

        u_bc = bc[bc < self.n_u]
        vmask = np.zeros(self.n_u, dtype=bool)
        vmask[u_bc] = True
        self.u_free = jnp.where(jnp.asarray(vmask), 0.0, 1.0)

        # AMG on the pressure Laplacian (regularized if enclosed)
        if self.enclosed:
            from navierstokes_tpu.linalg.amg import pressure_mass_scipy
            K = pressure_laplacian_scipy(space)
            M = pressure_mass_scipy(space)
            shift = 1e-2 * (K.diagonal().mean() / M.diagonal().mean())
            A = pressure_laplacian_scipy(space, mass_shift=shift)
        else:
            A = pressure_laplacian_scipy(space, dirichlet_dofs=p_bc)
        self.amg = AMG(A, **(amg_kwargs or {}))

        # lumped pressure mass inverse (Mp^{-1} surrogate)
        W = jnp.asarray(space.integration_weights(),
                        dtype=self.p_free.dtype)
        N1 = jnp.asarray(space.N1, dtype=self.p_free.dtype)
        lump_c = jnp.einsum("cq,qj->cj", W, N1)
        lumped = jnp.zeros((self.n_p,), dtype=lump_c.dtype).at[
            jnp.asarray(space.cell_pnodes)].add(lump_c)
        self.mp_lumped_inv = 1.0 / lumped

        dm, dk = mixed_op.velocity_jacobi_diags()
        self.dm_u = jnp.repeat(dm, self.dim)
        self.dk_u = jnp.repeat(dk, self.dim)

        # component-wise AMG on the scalar P2 stiffness: the velocity-block
        # inner solve with plain Jacobi degrades as O(1/h) and stalled the
        # 64^2+ Newton iterations; one V-cycle per GMRES iteration keeps it
        # h-independent.  ``helmholtz_shift`` ~ accel0/cv folds a reaction
        # term into the hierarchy for transient systems.
        from navierstokes_tpu.linalg.amg import velocity_stiffness_scipy

        u_bc_nodes = np.unique(u_bc // space.dim)
        Ku = velocity_stiffness_scipy(space, mass_shift=helmholtz_shift,
                                      dirichlet_dofs=u_bc_nodes)
        self.amg_u = AMG(Ku, **(amg_kwargs or {}))

        self._solvers = {}

    # -- preconditioner application (jittable) -------------------------------
    def _project(self, r):
        if self.enclosed:
            return r - jnp.mean(r)
        return self.p_free * r

    def _apply(self, r, Jmv, u_q, scalars):
        n_u = self.n_u
        r_u, r_p = r[:n_u], r[n_u:]
        accel0 = scalars.get("accel0", 0.0)

        # Schur approximation: S^{-1} ~= Lp^{-1} Fp Mp^{-1}.  The Mp solve
        # accuracy matters (lumped-only doubles the outer iteration count);
        # a short lumped-preconditioned CG on the consistent mass is exact
        # enough at fixed cost.
        mp, _ = cg(self.pop.mass_matvec, r_p, tol=0.0,
                   maxiter=self.mp_iters,
                   M=lambda v: self.mp_lumped_inv * v)
        if self.grad_div > 0.0:
            # AL Schur approximation: S^{-1} ~= -(cv + gamma) Mp^{-1}
            z_p = -(scalars["cv"] + self.grad_div) * self._project(mp)
        else:
            fp = (accel0 * self.pop.mass_matvec(mp)
                  + scalars["cv"] * self.pop.stiffness_matvec(mp)
                  + self.pop.convection_matvec(mp, u_q))
            z_p = -self._project(self.amg.apply(self._project(fp)))
        z_p = jnp.where(self.p_bc_mask, r_p, z_p)

        # velocity solve: F z_u = r_u - G z_p
        zeros_u = jnp.zeros(n_u, dtype=r.dtype)
        zeros_p = jnp.zeros(self.n_p, dtype=r.dtype)
        rhs_u = r_u - Jmv(jnp.concatenate([zeros_u, z_p]))[:n_u]

        def F_apply(v):
            return Jmv(jnp.concatenate([v, zeros_p]))[:n_u]

        # component-wise AMG V-cycle on the diffusion part, scaled by 1/cv
        # (F ~ cv * (K + (accel0/cv) M)); constrained dofs pass through
        def M_u(v):
            vn = v.reshape(-1, self.dim)
            import jax

            z = jax.vmap(self.amg_u.apply, in_axes=1, out_axes=1)(vn)
            z = (z / scalars["cv"]).reshape(-1)
            return self.u_free * z + (1.0 - self.u_free) * v

        # one GMRES(f_iters) sweep: breakdown-free, unlike BiCGStab, whose
        # rho/omega divisions blow up on rough inputs (observed: the
        # BiCGStab variant turned ~4% of preconditioner columns into NaNs
        # and stalled the outer FGMRES at 1e-2)
        z_u, _ = gmres(F_apply, rhs_u, tol=0.0, atol=0.0, maxiter=1,
                       restart=self.f_iters, M=M_u)
        z_u = self.u_free * z_u + (1.0 - self.u_free) * rhs_u
        return jnp.concatenate([z_u, z_p])

    # -- the one-program linear solve -----------------------------------------
    def _build_solver(self, picard: bool, has_source: bool):
        import jax

        from navierstokes_tpu.linalg.fgmres import fgmres_device

        op = self.op

        def impl(x, rhs, x0, scalars, source_q, tol, atol, max_cycles):
            _, jvp = op.linearize_at(x, scalars, source_q, picard=picard)
            u, _ = op.split(x)
            u_q = op.u_at_quad(u)
            if self.grad_div > 0.0:
                jvp, rhs = self._augment(jvp, rhs)
            M = lambda r: self._apply(r, jvp, u_q, scalars)
            return fgmres_device(jvp, M, rhs, x0=x0, restart=self.restart,
                                 tol=tol, atol=atol,
                                 max_cycles=max_cycles)

        return jax.jit(impl, static_argnames=("max_cycles",))

    def _augment(self, jvp, rhs):
        """Wrap the Jacobian matvec and rhs with the grad-div term
        ``gamma * G Mp_lumped^{-1} D`` (composed from the system's own
        blocks, so BC/pin rows stay consistent: constrained u rows are
        masked, constrained/mean p rows are projected out)."""
        gamma = self.grad_div
        n_u = self.n_u
        zeros_u = jnp.zeros(n_u, dtype=rhs.dtype)

        def G_of(q):
            return jvp(jnp.concatenate([zeros_u, q]))[:n_u]

        def aug_u(r_p):
            q = gamma * self.mp_lumped_inv * self._project(r_p)
            return self.u_free * G_of(q)

        def jvp_aug(v):
            out = jvp(v)
            return out.at[:n_u].add(aug_u(out[n_u:]))

        rhs_aug = rhs.at[:n_u].add(aug_u(rhs[n_u:]))
        return jvp_aug, rhs_aug

    def solve(self, x, rhs, scalars, source_q=0.0, *, picard=False,
              tol=1e-10, atol=1e-12, x0=None):
        """Solve J(x) dx = rhs; returns (dx, residual_norm, matvecs).

        ``x0`` warm-starts.  All restart cycles run in one device program.
        """
        key = (bool(picard), np.ndim(source_q) == 3)
        if key not in self._solvers:
            self._solvers[key] = self._build_solver(*key)
        if x0 is None:
            x0 = jnp.zeros_like(rhs)
        return self._solvers[key](x, rhs, x0, scalars, source_q, tol, atol,
                                  self.max_cycles)
