"""Incremental pressure-correction (IPCS) fractional-step solver.

Counterpart of the reference's ``IPCSSolver`` (source/ns_ipcs_solver.py):
three sub-solves per step on the collapsed subspaces,

  1. *diffusion* -- nonlinear velocity step for the intermediate velocity
     u*: BDF acceleration + convection + lagged pressure gradient +
     viscous term, Newton iteration (:106-147);
  2. *projection* -- pressure Poisson
     (grad p, grad q) = (grad p_old, grad q) - (alpha0/k) (div u*, q)
     with pressure Dirichlet BCs (:149-171);
  3. *velocity correction* -- mass solve
     (u, w) = (u*, w) - (k/alpha0) (grad(p - p_old), w) with velocity
     Dirichlet BCs (:173-196).

This is the fast path: steps 2 and 3 are SPD solves running as
matrix-free CG at SpMV speed; step 1 reuses the sparse velocity-block
Newton.

``scheme`` selects the pressure-correction variant, covering the
reference's prototype scripts as first-class options:

* ``"incremental"`` (default) -- the reference IPCSSolver above;
* ``"chorin"``      -- non-incremental: no lagged pressure in the
  diffusion step, pressure recomputed from scratch
  (scripts/test_chorin.py:109-128);
* ``"phi"``         -- increment form with pressure extrapolation
  eta = [2, -1] in the diffusion step and a separate increment field,
  p_{n+1} = p_n + phi (scripts/test_ipcs_phi.py:102-139).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from navierstokes_tpu import config
from navierstokes_tpu.assembly.operators import (PressurePoissonOperator,
                                                 VelocityOperator)
from navierstokes_tpu.fem.dirichlet import compile_dirichlet_bcs
from navierstokes_tpu.linalg.krylov import masked_spd_solve
from navierstokes_tpu.solvers.stationary import solve_linear_system
from navierstokes_tpu.solvers.transient import InstationarySolverBase
from navierstokes_tpu.timestepping import BDFTimeStepping


class IPCSSolver(InstationarySolverBase):

    def __init__(self, mesh, boundary_markers, form_convective_term,
                 time_stepping, tol=None, max_iter=50,
                 form_viscous_term="reduced", linear_solver=None,
                 scheme="incremental"):
        assert isinstance(time_stepping, BDFTimeStepping)
        assert scheme in ("incremental", "chorin", "phi")
        super().__init__(mesh, boundary_markers, form_convective_term,
                         time_stepping, tol, max_iter, form_viscous_term,
                         linear_solver)
        self._scheme = scheme

    # -- setup ---------------------------------------------------------------
    def _setup_function_spaces(self):
        super()._setup_function_spaces()
        dt = config.default_dtype()
        space = self._space
        n = self._n_levels() + 1
        self._velocities = [jnp.zeros((space.n_unodes, space.dim), dtype=dt)
                            for _ in range(n)]
        self._intermediate_velocity = jnp.zeros(
            (space.n_unodes, space.dim), dtype=dt)
        self._pressure = jnp.zeros(space.n_pnodes, dtype=dt)
        self._old_pressure = jnp.zeros(space.n_pnodes, dtype=dt)
        self._older_pressure = jnp.zeros(space.n_pnodes, dtype=dt)

    def _setup_scheme(self):
        space = self._space
        self._vel_operator = VelocityOperator(space,
                                              self._form_convective_term,
                                              self._form_viscous_term)
        self._poisson = PressurePoissonOperator(space)

        # split Dirichlet data onto the collapsed subspaces
        self._vel_dirichlet, _ = compile_dirichlet_bcs(
            space, self._boundary_markers, self._velocity_bcs, ())
        self._vel_operator.set_bc_dofs(self._vel_dirichlet.dofs)
        from navierstokes_tpu.fem.bcs import PressureBCType
        self._pres_dirichlet, _ = compile_dirichlet_bcs(
            space, self._boundary_markers, (), [
                bc for bc in self._pressure_bcs
                if bc[0] is not PressureBCType.mean_value])
        p_bc_ranks = (np.asarray(self._pres_dirichlet.dofs, dtype=np.int64)
                      - space.pressure_offset)
        if len(p_bc_ranks) == 0:
            # unconstrained pressure: pin one dof for solvability
            p_bc_ranks = np.array([0], dtype=np.int64)
            self._pressure_pinned = True
        else:
            self._pressure_pinned = False
        mask = np.zeros(space.n_pnodes, dtype=bool)
        mask[p_bc_ranks] = True
        self._p_bc_mask = jnp.asarray(mask)
        self._p_bc_ranks = p_bc_ranks

        vmask = np.zeros(space.n_unodes * space.dim, dtype=bool)
        vmask[np.asarray(self._vel_dirichlet.dofs, dtype=np.int64)] = True
        self._v_bc_mask = jnp.asarray(vmask)

        # at-scale linalg: AMG-CG for the
        # SPD sub-solves, AMG-preconditioned GMRES Newton-Krylov for the
        # diffusion step -- the reference-shaped fractional-step solver
        # at the same iteration counts as the monolithic round-2 stack.
        # An explicit ``linear_solver`` keeps the legacy assembled path.
        self._use_fast_linalg = self._linear_solver is None
        if self._use_fast_linalg:
            from navierstokes_tpu.linalg.amg import (
                AMG, pressure_laplacian_scipy)

            A_p = pressure_laplacian_scipy(space,
                                           dirichlet_dofs=p_bc_ranks)
            self._amg_p = AMG(A_p)
            dm, _ = self._operator.velocity_jacobi_diags()
            self._mass_diag_u = jnp.repeat(dm, space.dim)
            self._u_bc_nodes = np.unique(
                np.asarray(self._vel_dirichlet.dofs, np.int64) // space.dim)
            self._amg_u = None
            self._amg_u_shift = None
            self._jit_newton = {}     # (source_is_scalar,) -> jitted update
            self._jit_step2 = {}      # (source-free) projection+correction

    def _ensure_diffusion_amg(self, scalars):
        """Component-wise AMG hierarchy on K + (accel0/cv) M: the
        h-independent preconditioner basis for the diffusion-step
        Jacobian cv*(K + shift*M) (identical recipe to MatrixFreePCD's
        velocity block).  Rebuilt only when the reaction shift leaves a
        4x bucket (variable steps stay cheap); a rebuild invalidates the
        cached jitted Newton program (which closes over the hierarchy)."""
        from navierstokes_tpu.linalg.amg import (AMG,
                                                 velocity_stiffness_scipy)

        shift = float(scalars["accel0"]) / float(scalars["cv"])
        if self._amg_u is None or not \
                (0.25 <= shift / self._amg_u_shift <= 4.0):
            Ku = velocity_stiffness_scipy(self._space, mass_shift=shift,
                                          dirichlet_dofs=self._u_bc_nodes)
            self._amg_u = AMG(Ku)
            self._amg_u_shift = shift
            self._jit_newton.clear()

    def _newton_update_program(self, source_is_scalar):
        """One cached jitted Newton update for the diffusion step:
        matrix-free J.v by ``jax.linearize`` of the BC-masked residual
        (identity rows at constrained dofs), AMG-preconditioned GMRES.
        Jitting the WHOLE update (linearize + GMRES + V-cycle) once per
        AMG rebuild is what makes the per-step cost a compiled program
        instead of a fresh trace of jax.scipy GMRES every iteration."""
        import jax

        key = (bool(source_is_scalar),)
        if key in self._jit_newton:
            return self._jit_newton[key]

        vop = self._vel_operator
        amg_u = self._amg_u
        u_free = jnp.where(self._v_bc_mask, 0.0, 1.0)
        dim = self._space.dim

        def M_u(v, cv):
            vn = v.reshape(-1, dim)
            z = jax.vmap(amg_u.apply, in_axes=1, out_axes=1)(vn) / cv
            return u_free * z.reshape(-1) + (1.0 - u_free) * v

        @jax.jit
        def update(ustar, bc_values, scalars, p_diffusion, source_q):
            def F(uf):
                return vop._residual_impl(uf, bc_values, scalars,
                                          p_diffusion, source_q)

            r, Jmv = jax.linearize(F, ustar)
            cv = scalars["cv"]
            dx, _ = jax.scipy.sparse.linalg.gmres(
                Jmv, -r, tol=1e-6, restart=30, maxiter=4,
                M=lambda v: M_u(v, cv), solve_method="batched")
            lin_res = jnp.linalg.norm(r + Jmv(dx))
            u_new = ustar + dx
            res_new = jnp.linalg.norm(F(u_new))
            return u_new, res_new, lin_res

        self._jit_newton[key] = update
        return update

    def _step2_program(self):
        """Cached jitted projection + velocity-correction pair (both SPD
        masked-CG solves, AMG / Jacobi preconditioned), per scheme."""
        import jax

        if self._jit_step2:
            return self._jit_step2["fn"]

        scheme = self._scheme
        op = self._operator
        vop = self._vel_operator
        pop = self._poisson
        amg_p = self._amg_p
        p_bc_mask = self._p_bc_mask
        v_bc_mask = self._v_bc_mask
        mass_diag = self._mass_diag_u
        n_p = self._space.n_pnodes
        # dtype-aware stopping: 1e-14 relative is unreachable in f32 --
        # the CG would spin to maxiter on chip
        f64 = jnp.dtype(config.default_dtype()) == jnp.float64
        cg_tol = 1e-14 if f64 else 1e-6
        cg_cap = 10 * n_p if f64 else 400

        @jax.jit
        def step2(ustar2d, old_p, p_bc_full, v_bc_full, k, alpha0):
            div_ustar = jnp.trace(op.grad_u_at_quad(ustar2d),
                                  axis1=2, axis2=3)
            rhs = -(alpha0 / k) * pop.rhs_scalar(div_ustar)
            if scheme == "incremental":
                rhs = rhs + pop.rhs_grad_dot_gradq(
                    op.grad_p_at_quad(old_p))
            warm = old_p if scheme == "incremental" else None
            sol, pres_res = masked_spd_solve(
                pop.stiffness_matvec, rhs, p_bc_mask, p_bc_full,
                tol=cg_tol, maxiter=cg_cap, M=amg_p.apply, x0=warm)
            if scheme == "incremental":
                pressure = sol
                grad_correction = pressure - old_p
            elif scheme == "chorin":
                pressure = sol
                grad_correction = pressure
            else:  # phi increment
                pressure = old_p + sol
                grad_correction = sol

            grad_dp = op.grad_p_at_quad(grad_correction)
            u_star_q = op.u_at_quad(ustar2d)
            rhs_u = vop.mass_rhs(u_star_q - (k / alpha0) * grad_dp)
            u_new, mass_res = masked_spd_solve(
                vop.mass_matvec, rhs_u, v_bc_mask, v_bc_full, tol=cg_tol,
                maxiter=cg_cap, diag=mass_diag, x0=ustar2d.reshape(-1))
            return u_new, pressure, pres_res, mass_res

        self._jit_step2["fn"] = step2
        return step2

    def set_initial_conditions(self, initial_conditions):
        super().set_initial_conditions(initial_conditions)
        u0, p0 = self._space.split(self._solutions[0])
        self._velocities[0] = u0
        self._velocities[1] = u0
        self._intermediate_velocity = u0
        self._pressure = p0
        self._old_pressure = p0
        self._older_pressure = p0

    # -- stepping ------------------------------------------------------------
    def advance_time(self):
        super().advance_time()
        for i in range(len(self._velocities) - 1, 0, -1):
            self._velocities[i] = self._velocities[i - 1]
        self._older_pressure = self._old_pressure
        self._old_pressure = self._pressure

    def _vel_bc_values(self, t):
        vals = self._vel_dirichlet.values(t)
        return jnp.asarray(vals, dtype=config.default_dtype())

    def _solve_time_step(self, next_time):
        space = self._space
        vop = self._vel_operator
        k = self._next_step_size
        alpha = self._alpha

        scalars = self._scalars()
        scalars["accel0"] = alpha[0] / k

        # BDF history from the velocity ring
        history = None
        for i in range(1, len(alpha)):
            if alpha[i] == 0.0:
                continue
            term = (alpha[i] / k) * self._operator.u_at_quad(
                self._velocities[i])
            history = term if history is None else history + term
        source_q = self._momentum_source(t=next_time, extra_quad=history)

        # pressure entering the diffusion step, per variant
        if self._scheme == "chorin":
            p_diffusion = jnp.zeros_like(self._old_pressure)
        elif self._scheme == "phi":
            # eta = [2, -1] extrapolation (scripts/test_ipcs_phi.py:104-106)
            p_diffusion = 2.0 * self._old_pressure - self._older_pressure
        else:
            p_diffusion = self._old_pressure

        # (1) diffusion step: Newton for the intermediate velocity
        bc_values = self._vel_bc_values(next_time)
        ustar = self._intermediate_velocity.reshape(-1)
        ustar = ustar.at[jnp.asarray(vop._bc_dofs)].set(bc_values)

        def res_norm(uv):
            return float(jnp.linalg.norm(
                vop.residual(uv, bc_values, scalars, p_diffusion,
                             source_q)))

        res = res_norm(ustar)
        res0 = res
        newton_its = 0
        if self._use_fast_linalg:
            self._ensure_diffusion_amg(scalars)
            update = self._newton_update_program(np.ndim(source_q) == 0)
        for _ in range(self._maxiter):
            if res <= max(self._tol, 1.0e1 * self._tol * res0):
                break
            if self._use_fast_linalg:
                ustar, res_dev, lin_res = update(ustar, bc_values, scalars,
                                                 p_diffusion, source_q)
                res = float(res_dev)
                self.monitor.record("linear_solve", residual=lin_res,
                                    label="ipcs-diffusion-gmres")
            else:
                r = vop.residual(ustar, bc_values, scalars, p_diffusion,
                                 source_q)

                def provider(kind):
                    J = vop.jacobian_csr(ustar, scalars, p_diffusion,
                                         source_q)
                    return J.todense() if kind == "dense" else J

                dx = solve_linear_system(provider, -r, vop.n_dofs,
                                         self._linear_solver)
                ustar = ustar + dx
                res = res_norm(ustar)
            newton_its += 1
        else:
            raise RuntimeError(
                f"IPCS diffusion step did not converge: residual {res:.3e}")
        self.monitor.record("nonlinear_solve", phase="ipcs-diffusion",
                            iterations=newton_its, residual=res,
                            initial_residual=res0)
        self._intermediate_velocity = ustar.reshape(-1, space.dim)

        # (2)+(3) pressure projection (Poisson, SPD, masked CG) and
        # velocity correction (mass solve, SPD, masked CG)
        p_bc_full = jnp.zeros(space.n_pnodes, dtype=config.default_dtype())
        if not self._pressure_pinned and self._scheme != "phi":
            # "phi" solves for the increment: homogeneous data at the
            # pressure Dirichlet nodes
            vals = self._pres_dirichlet.values(next_time)
            p_bc_full = p_bc_full.at[jnp.asarray(self._p_bc_ranks)].set(
                jnp.asarray(vals))
        v_bc_full = jnp.zeros(space.n_unodes * space.dim,
                              dtype=config.default_dtype())
        v_bc_full = v_bc_full.at[jnp.asarray(vop._bc_dofs)].set(bc_values)

        if self._use_fast_linalg:
            step2 = self._step2_program()
            u_new, self._pressure, pres_res, mass_res = step2(
                self._intermediate_velocity, self._old_pressure,
                p_bc_full, v_bc_full, k, alpha[0])
        else:
            pop = self._poisson
            div_ustar = jnp.trace(self._operator.grad_u_at_quad(
                self._intermediate_velocity), axis1=2, axis2=3)
            rhs = -(alpha[0] / k) * pop.rhs_scalar(div_ustar)
            if self._scheme == "incremental":
                grad_p_old = self._operator.grad_p_at_quad(
                    self._old_pressure)
                rhs = rhs + pop.rhs_grad_dot_gradq(grad_p_old)
            sol, pres_res = masked_spd_solve(pop.stiffness_matvec, rhs,
                                             self._p_bc_mask, p_bc_full,
                                             tol=1e-14)
            if self._scheme == "incremental":
                self._pressure = sol
                grad_correction = self._pressure - self._old_pressure
            elif self._scheme == "chorin":
                self._pressure = sol
                grad_correction = self._pressure
            else:  # phi increment
                self._pressure = self._old_pressure + sol
                grad_correction = sol

            grad_dp = self._operator.grad_p_at_quad(grad_correction)
            u_star_q = self._operator.u_at_quad(self._intermediate_velocity)
            rhs_u = vop.mass_rhs(u_star_q - (k / alpha[0]) * grad_dp)
            u_new, mass_res = masked_spd_solve(
                vop.mass_matvec, rhs_u, self._v_bc_mask, v_bc_full,
                tol=1e-14)
        self.monitor.record("linear_solve", residual=pres_res,
                            label="ipcs-poisson-cg")
        self.monitor.record("linear_solve", residual=mass_res,
                            label="ipcs-mass-cg")
        self._velocities[0] = u_new.reshape(-1, space.dim)

        self._solutions[0] = space.join(self._velocities[0], self._pressure)

    def _shift_mean_pressure(self):
        mean = self._operator.mean_pressure(self._pressure)
        self._pressure = self._pressure - (mean - self._mean_pressure_value)
        self._solutions[0] = self._space.join(self._velocities[0],
                                              self._pressure)

    @property
    def solution(self):
        self._solutions[0] = self._space.join(self._velocities[0],
                                              self._pressure)
        return self._solutions[0]
