"""Cell-parallel (domain-decomposed) matrix-free operators.

Strategy (round 1): **cell sharding with replicated dof vectors** -- the
FEM analogue of data parallelism.  The element loop dominates matrix-free
Krylov cost, and its scatter is a sum over disjoint cell batches:

    r = sum_d scatter(elements of shard d)         (psum over the mesh)

Each device holds an equal chunk of the per-cell arrays; solution vectors
are replicated.  The only collective is one ``psum`` per operator
application, riding the interconnect.

Performance design (made for the first accelerator, not yet measured on
the H100):

* the *linear* operators (mass, stiffness, pressure-gradient coupling)
  are precomputed as per-cell element matrices once at setup -- each
  matvec is then a gather + batched small matmul instead of re-running
  the quadrature loop;
* scatter-accumulation uses a precomputed **transpose-gather table**
  (node -> list of contributing (cell, local-node) slots, ELL-padded):
  a gather + sum, which vectorizes, instead of ``scatter-add``, which
  serialized there;
* only the nonlinear convection assembly keeps the quadrature loop.

Later rounds: row-partitioned dof sharding with ``ppermute`` halo
exchange for memory-bound scaling beyond replicated vectors.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from navierstokes_tpu import config
from navierstokes_tpu.fem.spaces import TaylorHoodSpace


def device_mesh(n_devices=None, axis="shard"):
    """1D device mesh over the first ``n_devices`` available devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def _numpy_scatter_transpose(flat_nodes: np.ndarray, n_nodes: int,
                             k_pad=None):
    """Pure-NumPy transpose-table build (fallback of native.build_transpose)."""
    n_flat = len(flat_nodes)
    order = np.argsort(flat_nodes, kind="stable")
    counts = np.bincount(flat_nodes, minlength=n_nodes)
    K = int(counts.max()) if len(counts) else 1
    if k_pad is not None:
        K = max(K, int(k_pad))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    table = np.full((n_nodes, K), n_flat, dtype=np.int32)
    within = np.arange(n_flat) - np.repeat(starts, counts)
    table[flat_nodes[order], within] = order.astype(np.int32)
    return table, K


def build_scatter_transpose(cell_nodes: np.ndarray, n_nodes: int,
                            k_pad: int = None):
    """Transpose-gather table: node -> flat (cell, local) slots.

    Returns (table (n_nodes, K) int32, K).  Pad entries point one past the
    last flat slot; callers append a zero row to the flattened per-cell
    values before gathering.  Uses the native C++ counting-sort kernel
    when built (navierstokes_tpu.native); NumPy otherwise.
    """
    from navierstokes_tpu import native

    flat_nodes = np.asarray(cell_nodes, dtype=np.int32).ravel()
    return native.build_transpose(flat_nodes, n_nodes, k_pad)


def build_scatter_transpose_range(cell_nodes: np.ndarray, lo: int,
                                  hi: int, k_pad: int = None):
    """Transpose table restricted to nodes in [lo, hi).

    Rows index local node ids (node - lo); stored slot indices stay global
    into the flattened per-cell values; entries whose node lies outside
    the range simply get no row.  Used to split the velocity scatter by
    node class (vertex vs edge-midpoint ranks), whose valences differ: a
    single ELL width would waste padded gather rows.
    """
    flat = np.asarray(cell_nodes, dtype=np.int64).ravel()
    n_flat = len(flat)
    sel = np.nonzero((flat >= lo) & (flat < hi))[0]
    local = flat[sel] - lo
    counts = np.bincount(local, minlength=hi - lo)
    K = max(int(counts.max()) if len(counts) else 1, 1)
    if k_pad is not None:
        K = max(K, int(k_pad))
    order = np.argsort(local, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    table = np.full((hi - lo, K), n_flat, dtype=np.int32)
    within = np.arange(len(sel)) - np.repeat(starts, counts)
    table[local[order], within] = sel[order].astype(np.int32)
    return table, K


def _gather_scatter(values_flat, table):
    """Accumulate flattened per-cell values (n_flat, ...) into nodes."""
    pad_shape = (1,) + values_flat.shape[1:]
    padded = jnp.concatenate(
        [values_flat, jnp.zeros(pad_shape, dtype=values_flat.dtype)], axis=0)
    return padded[table].sum(axis=1)


class ShardedCellOperator:
    """Sharded matrix-free operators for a Taylor-Hood space."""

    def __init__(self, space: TaylorHoodSpace, mesh: Mesh, axis="shard"):
        config.ensure_accurate_matmuls()
        self.space = space
        self.mesh = mesh
        self.axis = axis
        self.n_dev = int(mesh.devices.size)
        dt = config.default_dtype()
        self.dtype = dt
        dim = space.dim
        self.dim = dim

        nc = space.mesh.n_cells
        n_pad = (-nc) % self.n_dev
        self.n_cells_padded = nc + n_pad
        chunk = self.n_cells_padded // self.n_dev
        self.chunk = chunk

        # order cells along a Morton curve of their centroids: consecutive
        # cells then gather/scatter nearby node rows (cell order is
        # irrelevant to the assembled sums, so this is transparent)
        from navierstokes_tpu.fem.spaces import _morton_order

        centroids = space.mesh.points[space.mesh.cells].mean(axis=1)
        cell_order = _morton_order(centroids)

        # geometry, padded with zero-weight cells
        W = np.asarray(space.integration_weights(), dtype=dt)[cell_order]
        Jinv = np.asarray(space.Jinv_q, dtype=dt)[cell_order]
        cu = np.asarray(space.cell_unodes)[cell_order]
        cp_ = np.asarray(space.cell_pnodes)[cell_order]
        self.cell_order = cell_order
        if n_pad:
            W = np.concatenate([W, np.zeros((n_pad, W.shape[1]), W.dtype)])
            Jinv = np.concatenate([Jinv, np.repeat(Jinv[:1], n_pad, 0)])
            cu = np.concatenate([cu, np.repeat(cu[:1], n_pad, 0)])
            cp_ = np.concatenate([cp_, np.repeat(cp_[:1], n_pad, 0)])

        self.W = jnp.asarray(W)
        self.Jinv = jnp.asarray(Jinv)
        self.cell_unodes = jnp.asarray(cu)
        self.cell_pnodes = jnp.asarray(cp_)

        self.N2 = jnp.asarray(space.N2, dtype=dt)
        self.G2 = jnp.asarray(space.G2, dtype=dt)
        self.N1 = jnp.asarray(space.N1, dtype=dt)

        # --- precomputed element matrices (host-side, once; cell-ordered) --
        g2 = np.einsum("qia,cqae->cqie", np.asarray(space.G2), Jinv)
        g1 = np.einsum("qja,cqae->cqje", np.asarray(space.G1), Jinv)
        N2h = np.asarray(space.N2)
        N1h = np.asarray(space.N1)
        M_c = np.einsum("cq,qi,qj->cij", W, N2h, N2h)
        K_c = np.einsum("cq,cqie,cqje->cij", W, g2, g2)
        # G_c[i,d,j] = -int N1_j dN2_i/dx_d  (pressure-gradient coupling)
        G_c = -np.einsum("cq,qj,cqid->cidj", W, N1h, g2)
        KP_c = np.einsum("cq,cqje,cqke->cjk", W, g1, g1)
        # host copies of the element diagonals: diagonals() must never
        # read the device arrays back (a setup-time device sync per call)
        self._elem_diags_host = (np.einsum("cii->ci", M_c),
                                 np.einsum("cii->ci", K_c),
                                 np.einsum("cjj->cj", KP_c))
        self.M_c = jnp.asarray(M_c, dtype=dt)
        self.K_c = jnp.asarray(K_c, dtype=dt)
        self.G_c = jnp.asarray(G_c, dtype=dt)
        self.KP_c = jnp.asarray(KP_c, dtype=dt)

        # --- per-shard transpose-gather tables ------------------------------
        # the velocity scatter is split by node class (vertex nodes in
        # ranks [0, n_vtx), edge midpoints in [n_vtx, n_unodes) after the
        # class-major renumbering): valences differ a lot between classes
        # (2D: ~6-8 vs 2), so class-wise ELL widths avoid gathering padded
        # rows
        n_vtx = getattr(space, "n_vertex_unodes", space.n_unodes)
        self.n_vertex_unodes = n_vtx

        def shard_tables(builder, *args):
            tabs, K = [], 0
            chunks = [args[0][d * chunk:(d + 1) * chunk]
                      for d in range(self.n_dev)]
            for c in chunks:
                _, k = builder(c, *args[1:])
                K = max(K, k)
            tabs = [builder(c, *args[1:], K)[0] for c in chunks]
            return jnp.asarray(np.stack(tabs))

        self.u_table_v = shard_tables(build_scatter_transpose_range,
                                      cu, 0, n_vtx)
        self.u_table_e = shard_tables(build_scatter_transpose_range,
                                      cu, n_vtx, space.n_unodes)
        self.p_table = shard_tables(build_scatter_transpose,
                                    cp_, space.n_pnodes)

        self._shard_spec = P(axis)
        self._repl = P()

    def _elem_apply(self, A_c, u_c):
        """Batched per-cell element-matrix apply."""
        return jnp.einsum("cij,cjd->cid", A_c, u_c)

    def _scatter_u(self, r_c, table_v, table_e):
        """(chunk, nn2, d) cell contributions -> (n_unodes, d), assembled
        through the class-split transpose tables."""
        flat = r_c.reshape(-1, self.dim)
        pad = jnp.zeros((1, self.dim), dtype=flat.dtype)
        padded = jnp.concatenate([flat, pad], axis=0)
        out_v = padded[table_v[0]].sum(axis=1)
        out_e = padded[table_e[0]].sum(axis=1)
        return jnp.concatenate([out_v, out_e], axis=0)

    def _scatter_p(self, r_c, table):
        flat = r_c.reshape(-1)
        return _gather_scatter(flat, table[0])

    # -- operator factories -------------------------------------------------
    def make_velocity_mass(self):
        """u -> M u (P2 vector mass), flat in/out."""
        space, axis, dim = self.space, self.axis, self.dim

        def local(M_c, cu, tab_v, tab_e, uflat):
            u_c = uflat.reshape(-1, dim)[cu]
            r_c = self._elem_apply(M_c, u_c)
            r = self._scatter_u(r_c, tab_v, tab_e)
            return jax.lax.psum(r.reshape(-1), axis)

        sharded = shard_map(local, mesh=self.mesh,
                            in_specs=(P(axis),) * 4 + (P(),),
                            out_specs=P(), check_vma=False)
        return jax.jit(lambda u: sharded(self.M_c, self.cell_unodes,
                                         self.u_table_v, self.u_table_e,
                                         u))

    def make_velocity_helmholtz(self, visc):
        """(u, accel0) -> (accel0 M + visc K) u with traced accel0."""
        space, axis, dim = self.space, self.axis, self.dim

        def local(M_c, K_c, cu, tab_v, tab_e, uflat, accel0):
            u_c = uflat.reshape(-1, dim)[cu]
            A_c = accel0 * M_c + visc * K_c
            r_c = self._elem_apply(A_c, u_c)
            r = self._scatter_u(r_c, tab_v, tab_e)
            return jax.lax.psum(r.reshape(-1), axis)

        sharded = shard_map(local, mesh=self.mesh,
                            in_specs=(P(axis),) * 5 + (P(), P()),
                            out_specs=P(), check_vma=False)
        return jax.jit(lambda u, accel0: sharded(
            self.M_c, self.K_c, self.cell_unodes, self.u_table_v,
            self.u_table_e, u, accel0))

    def make_gradient(self):
        """p -> G p: velocity-space image of -int(p div w)."""
        axis, dim = self.axis, self.dim

        def local(G_c, cp_, tab_v, tab_e, p):
            p_c = p[cp_]
            r_c = jnp.einsum("cidj,cj->cid", G_c, p_c)
            r = self._scatter_u(r_c, tab_v, tab_e)
            return jax.lax.psum(r.reshape(-1), axis)

        sharded = shard_map(local, mesh=self.mesh,
                            in_specs=(P(axis),) * 4 + (P(),),
                            out_specs=P(), check_vma=False)
        return jax.jit(lambda p: sharded(self.G_c, self.cell_pnodes,
                                         self.u_table_v, self.u_table_e,
                                         p))

    def make_divergence(self):
        """u -> D u with D u = -int(div u) q tested against P1 (note the
        sign: D = G^T, the transpose of the gradient coupling)."""
        axis, dim = self.axis, self.dim

        def local(G_c, cu, table, uflat):
            u_c = uflat.reshape(-1, dim)[cu]
            r_c = jnp.einsum("cidj,cid->cj", G_c, u_c)
            r = self._scatter_p(r_c, table)
            return jax.lax.psum(r, axis)

        sharded = shard_map(local, mesh=self.mesh,
                            in_specs=(P(axis), P(axis), P(axis), P()),
                            out_specs=P(), check_vma=False)
        return jax.jit(lambda u: sharded(self.G_c, self.cell_unodes,
                                         self.p_table, u))

    def make_pressure_stiffness(self):
        """p -> L p (P1 Laplacian)."""
        axis = self.axis

        def local(KP_c, cp_, table, p):
            r_c = jnp.einsum("cjk,ck->cj", KP_c, p[cp_])
            r = self._scatter_p(r_c, table)
            return jax.lax.psum(r, axis)

        sharded = shard_map(local, mesh=self.mesh,
                            in_specs=(P(axis), P(axis), P(axis), P()),
                            out_specs=P(), check_vma=False)
        return jax.jit(lambda p: sharded(self.KP_c, self.cell_pnodes,
                                         self.p_table, p))

    def make_convection_rhs(self, cc):
        """u -> b with b_i = int(cc (u.grad)u . N_i): nonlinear assembly
        (quadrature loop; the scheme of scripts/test_ipcs.py:102-133)."""
        axis, dim = self.axis, self.dim
        N2, G2 = self.N2, self.G2

        def local(cu, Jinv, W, tab_v, tab_e, uflat):
            u_c = uflat.reshape(-1, dim)[cu]
            g2 = jnp.einsum("qia,cqae->cqie", G2, Jinv)
            u_q = jnp.einsum("qi,cid->cqd", N2, u_c)
            grad_u = jnp.einsum("cid,cqie->cqde", u_c, g2)
            conv = cc * jnp.einsum("cqde,cqe->cqd", grad_u, u_q)
            r_c = jnp.einsum("cq,cqd,qi->cid", W, conv, N2)
            r = self._scatter_u(r_c, tab_v, tab_e)
            return jax.lax.psum(r.reshape(-1), axis)

        sharded = shard_map(local, mesh=self.mesh,
                            in_specs=(P(axis),) * 5 + (P(),),
                            out_specs=P(), check_vma=False)
        return jax.jit(lambda u: sharded(self.cell_unodes, self.Jinv,
                                         self.W, self.u_table_v,
                                         self.u_table_e, u))

    # -- composite (kept for API compatibility) ------------------------------
    def make_stokes_matvec(self, visc, cp=1.0, accel0=0.0):
        """x = [u, p] -> monolithic Stokes/Helmholtz apply."""
        n_u = self.space.n_velocity_dofs
        helm = self.make_velocity_helmholtz(visc)
        grad = self.make_gradient()
        div = self.make_divergence()
        a0 = accel0
        cp_coef = cp

        @jax.jit
        def matvec(x):
            u, p = x[:n_u], x[n_u:]
            r_u = helm(u, a0) + cp_coef * grad(p)
            r_p = cp_coef * div(u)
            return jnp.concatenate([r_u, r_p])

        return matvec

    # -- operator diagonals (Jacobi preconditioning) --------------------------
    def diagonals(self):
        """(diag_M_u, diag_K_u, diag_L_p) assembled from element matrices."""
        n_dev = self.n_dev
        chunk = self.chunk

        def accumulate(elem_diag, cell_nodes, n_nodes):
            out = np.zeros(n_nodes)
            np.add.at(out, np.asarray(cell_nodes).ravel(),
                      np.asarray(elem_diag).ravel())
            return out

        dM, dK, dL = self._elem_diags_host
        cu_host = np.asarray(self.cell_order)  # avoid device readbacks:
        # rebuild padded host cell tables exactly as in __init__
        cu = np.asarray(self.space.cell_unodes)[cu_host]
        cp_ = np.asarray(self.space.cell_pnodes)[cu_host]
        n_pad = self.n_cells_padded - cu.shape[0]
        if n_pad:
            cu = np.concatenate([cu, np.repeat(cu[:1], n_pad, 0)])
            cp_ = np.concatenate([cp_, np.repeat(cp_[:1], n_pad, 0)])
        diag_m = accumulate(dM, cu, self.space.n_unodes)
        diag_k = accumulate(dK, cu, self.space.n_unodes)
        diag_l = accumulate(dL, cp_, self.space.n_pnodes)
        dt = self.dtype
        rep = np.repeat  # velocity diag per component
        return (jnp.asarray(rep(diag_m, self.dim), dtype=dt),
                jnp.asarray(rep(diag_k, self.dim), dtype=dt),
                jnp.asarray(diag_l, dtype=dt))
