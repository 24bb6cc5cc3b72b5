"""Cell-sharded mixed (saddle-point) Jacobian for multi-device Newton.

The stationary stack's hot operation is the matrix-free Jacobian action
of :class:`~navierstokes_tpu.assembly.operators.MixedOperator` -- a
per-cell quadrature sweep plus scatter.  Here the CELLS are partitioned
across a ``jax.sharding.Mesh``: each device evaluates its own cells'
residual contributions on a replicated state vector, scatters into a
full-length accumulator, and ``psum``s over the mesh axis (the classical
element-coloring/owner-computes decomposition, collective-ized).  State
vectors stay replicated -- the tp-style compute sharding for Newton
systems whose vectors fit every chip while assembly dominates.

Duck-types the ``MixedOperator`` surface that the PCD stack consumes
(``linearize_at``, ``residual``, ``split``, ``u_at_quad``,
``velocity_jacobi_diags``, ``_bc_dofs_np``, ...), so
``MatrixFreePCD(ShardedMixedOperator(...))`` gives a multi-device
stationary Newton-Krylov solve with zero changes to the solver layer.

Replaces: PETSc's MPI-distributed MatMult in the reference's Newton
solve (ns_solver_base.py:938-949, environment.yml:63-65); SURVEY §2.2.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from navierstokes_tpu.assembly import kernels
from navierstokes_tpu.assembly.operators import MixedOperator


class ShardedMixedOperator:
    """Cell-sharded facade over a ``MixedOperator``.

    Quadrature-geometry arrays (``Jinv``, ``W``) and cell index tables
    are padded to a device-count multiple and placed sharded along the
    cell axis; padded cells carry zero quadrature weight, so they
    contribute nothing.
    """

    def __init__(self, mixed_op: MixedOperator, device_mesh):
        ndev = int(device_mesh.devices.size)
        if ndev > 1 and any(d.platform == "gpu"
                            for d in device_mesh.devices.flat):
            # on four H100s the Newton solves through this operator turn
            # to garbage after a few steps while the operator's own action
            # matches one device to 1e-17: the replicated Krylov work
            # differs between the cards at 1e-13, and the collectives are
            # suspected to fall out of step when the cards disagree on a
            # loop test (ROADMAP, correctness item 1)
            raise NotImplementedError(
                "the cell-sharded StationarySolver does not converge on "
                "more than one GPU; solve with device_mesh=None")
        self.base = mixed_op
        self.mesh = device_mesh
        self.axis = device_mesh.axis_names[0]
        self.space = mixed_op.space

        nc = mixed_op.cell_unodes.shape[0]
        pad = (-nc) % ndev
        self.n_cells_padded = nc + pad

        def pad_cells(a, fill=0):
            a = np.asarray(a)
            if pad == 0:
                return a
            pad_block = np.full((pad,) + a.shape[1:], fill, a.dtype)
            return np.concatenate([a, pad_block], axis=0)

        spec = NamedSharding(device_mesh, P(self.axis))
        # padded cells: index tables point at node 0 (any valid id) but
        # the zero quadrature weights null their contributions
        self.cell_unodes = jax.device_put(
            jnp.asarray(pad_cells(mixed_op.cell_unodes)), spec)
        self.cell_pnodes = jax.device_put(
            jnp.asarray(pad_cells(mixed_op.cell_pnodes)), spec)
        self.Jinv = jax.device_put(
            jnp.asarray(pad_cells(np.asarray(mixed_op.Jinv))), spec)
        self.W = jax.device_put(
            jnp.asarray(pad_cells(np.asarray(mixed_op.W), fill=0.0)), spec)

        self._shard_specs = (P(), P(self.axis), P(self.axis),
                             P(self.axis), P(self.axis))

    # -- pass-throughs the PCD stack uses -----------------------------------
    def __getattr__(self, name):
        return getattr(self.base, name)

    def split(self, x):
        return self.base.split(x)

    # -- sharded residual sweep ---------------------------------------------
    def _sharded_sweep(self, scalars, picard):
        space = self.space
        base = self.base

        def sweep(z, uf_c, cu, cp, Ji, Wc):
            u, p = space.split(z)
            u_c = u[cu]
            p_c = p[cp]

            def one(u_cc, p_cc, uf_cc, Jc, Wcc):
                return base._cell_residual(u_cc, p_cc, uf_cc, Jc, Wcc,
                                           0.0, scalars, picard)

            r_u_c, r_p_c = jax.vmap(one)(u_c, p_c, uf_c, Ji, Wc)
            r_u = kernels.scatter_unodes(r_u_c, cu, space.n_unodes)
            r_p = kernels.scatter_pnodes(r_p_c, cp, space.n_pnodes)
            r = jnp.concatenate([r_u.reshape(-1), r_p])
            return jax.lax.psum(r, self.axis)

        return shard_map(
            sweep, mesh=self.mesh,
            in_specs=(P(), P(self.axis)) + self._shard_specs[1:],
            out_specs=P(), check_vma=False)

    def linearize_at(self, x, scalars, source_q=0.0, picard=False):
        """(r, jvp) with the cell sweep sharded over the device mesh.

        Matches ``MixedOperator.linearize_at`` Jacobian semantics (masked
        residual: identity rows at Dirichlet dofs).  ``source_q`` is a
        CONSTANT in the state, so it never enters the jvp; the returned
        ``r`` omits it (the PCD solver discards ``r`` -- use
        ``self.base.residual`` for true residual values).
        """
        space = self.space
        u_frozen, _ = space.split(x)
        uf_c = u_frozen[self.cell_unodes]
        sweep = self._sharded_sweep(scalars, picard)
        bc_dofs = self.base._bc_dofs

        def masked_residual(z):
            r = sweep(z, uf_c, self.cell_unodes, self.cell_pnodes,
                      self.Jinv, self.W)
            return r.at[bc_dofs].set(z[bc_dofs])

        return jax.linearize(masked_residual, x)
