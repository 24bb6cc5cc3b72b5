"""Dof-partitioned matrix-free operators with ``ppermute`` halo exchange.

The round-1 layer (``parallel/sharded.py``) shards cells but replicates
solution vectors: every matvec ``psum``s a full-length vector, so
per-device memory and collective volume are O(global dofs) -- correct,
but it cannot weak-scale.  This layer partitions the *dofs*:

* nodes are split into contiguous Morton-ordered ranges (one per device;
  the class-major Morton renumbering of ``fem/spaces.py`` makes ranges
  spatially compact), cells into contiguous Morton blocks;
* each device stores ONLY its own dof chunk plus a halo -- the few nodes
  of neighboring ranges its cells touch;
* a matvec is: ppermute halo values in (one shuffle per active partner
  offset, over the interconnect) -> local element kernel + transpose-gather scatter
  -> ppermute halo contributions back to their owners and add.

Per-device memory is O(dofs/n_dev + halo) and the collective volume is
O(halo) per matvec -- the weak-scaling replacement for the reference
stack's parmetis/MPI domain decomposition (SURVEY.md par.2.2), expressed
as XLA collectives instead of MPI messages.

Vectors are globally shaped but PADDED to n_dev-divisible node counts
(``pad_velocity`` / ``unpad_velocity`` convert) and node-major, so
``shard_map`` slices them into exactly the per-device node ranges.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from navierstokes_tpu import config
from navierstokes_tpu.fem.spaces import TaylorHoodSpace, _morton_order
from navierstokes_tpu.parallel.sharded import build_scatter_transpose


def _ceil_div(a, b):
    return -(-a // b)


def _partition_nodes(cell_nodes_pad, chunk_c, n_nodes, n_dev):
    """Cell-partition-aligned node ownership + permuted numbering.

    The space's global numbering is class-major (vertices, then edge
    midpoints), so contiguous ranges straddle both classes and any
    cell-aligned partition would see most touched nodes as halo.  Instead,
    a node is owned by the FIRST device (in Morton cell order) whose cells
    touch it; nodes are renumbered (owner-major, old order within a
    device) and each device's count padded to the max so ``shard_map`` can
    slice the permuted vector evenly.

    Returns (new_id (n_nodes,), chunk_n, old_of_new (n_dev*chunk_n,) with
    -1 at padding slots).
    """
    owner = np.full(n_nodes, -1, dtype=np.int64)
    for d in reversed(range(n_dev)):
        cn = cell_nodes_pad[d * chunk_c:(d + 1) * chunk_c]
        owner[np.unique(cn)] = d
    owner[owner < 0] = 0
    counts = np.bincount(owner, minlength=n_dev)
    chunk_n = max(int(counts.max()), 1)
    new_id = np.empty(n_nodes, dtype=np.int64)
    old_of_new = np.full(n_dev * chunk_n, -1, dtype=np.int64)
    for d in range(n_dev):
        idx = np.nonzero(owner == d)[0]
        new_id[idx] = d * chunk_n + np.arange(len(idx))
        old_of_new[d * chunk_n:d * chunk_n + len(idx)] = idx
    return new_id, chunk_n, old_of_new


class _HaloPlan:
    """Host-side exchange plan for one node set (velocity or pressure).

    Attributes (per device d, stacked on axis 0):
      cell_nodes_local: (n_dev, chunk_c, nloc) int32 into [own | halo | pad]
      tables:           (n_dev, n_local_slots, K) transpose-gather tables
      offsets:          python list of active partner offsets k (owner - needer)
      send_idx[k]:      (n_dev, H_k) int32 own-chunk indices to ship to d-k
                        (padded entries point at the zero row ``chunk_n``)
      halo_sizes[k]:    H_k
    """

    def __init__(self, cell_nodes_pad, cells_per_dev, chunk_n, n_dev):
        chunk_c = cells_per_dev
        self.chunk_n = chunk_n
        self.n_dev = n_dev
        nloc = cell_nodes_pad.shape[1]

        owner = lambda nodes: np.minimum(nodes // chunk_n, n_dev - 1)

        # halo requirements per device
        needs = []
        for d in range(n_dev):
            cn = cell_nodes_pad[d * chunk_c:(d + 1) * chunk_c]
            need = np.unique(cn)
            needs.append(need[owner(need) != d])

        # active offsets k = owner - needer (global union)
        offs = set()
        halo_by_offset = []       # per device: {k: sorted node array}
        for d in range(n_dev):
            by_k = {}
            if len(needs[d]):
                own = owner(needs[d])
                for e in np.unique(own):
                    k = int(e) - d
                    by_k[k] = np.sort(needs[d][own == e])
                    offs.add(k)
            halo_by_offset.append(by_k)
        self.offsets = sorted(offs)

        # per-offset send tables (stored at the OWNER, ordered like the
        # needer's recv buffer) + halo sizes
        self.halo_sizes = {}
        self.send_idx = {}
        for k in self.offsets:
            H = max((len(halo_by_offset[d].get(k, ()))
                     for d in range(n_dev)), default=0)
            H = max(H, 1)
            self.halo_sizes[k] = H
            sidx = np.full((n_dev, H), chunk_n, dtype=np.int32)  # zero row
            for e in range(n_dev):       # e = owner, needer d = e - k
                d = e - k
                if 0 <= d < n_dev:
                    nodes = halo_by_offset[d].get(k, np.zeros(0, np.int64))
                    sidx[e, :len(nodes)] = (nodes - e * chunk_n).astype(
                        np.int32)
            self.send_idx[k] = jnp.asarray(sidx)

        # local index map per device: own range, then halo blocks in
        # offset order, each in the needer's sorted-recv order
        n_halo_total = sum(self.halo_sizes.values())
        self.n_local = chunk_n + n_halo_total
        cn_local = np.zeros((n_dev, chunk_c, nloc), dtype=np.int32)
        for d in range(n_dev):
            lmap = {}
            base = chunk_n
            for k in self.offsets:
                nodes = halo_by_offset[d].get(k, np.zeros(0, np.int64))
                for j, g in enumerate(nodes):
                    lmap[int(g)] = base + j
                base += self.halo_sizes[k]
            cn = cell_nodes_pad[d * chunk_c:(d + 1) * chunk_c]
            lo = d * chunk_n
            local = np.where((cn >= lo) & (cn < lo + chunk_n), cn - lo, -1)
            miss = local < 0
            if miss.any():
                local[miss] = [lmap[int(g)] for g in cn[miss]]
            cn_local[d] = local
        self.cell_nodes_local = jnp.asarray(cn_local)

        # per-device transpose-gather tables over the local slot space
        tabs, K = [], 0
        for d in range(n_dev):
            _, k_ = build_scatter_transpose(cn_local[d], self.n_local)
            K = max(K, k_)
        for d in range(n_dev):
            t, _ = build_scatter_transpose(cn_local[d], self.n_local, K)
            tabs.append(t)
        self.tables = jnp.asarray(np.stack(tabs))

    # -- device-side halo primitives (call inside shard_map) ----------------
    def gather(self, own, axis):
        """own (chunk_n, w) -> (n_local, w): own values + received halo.

        The send tables are closure constants (replicated into every
        shard), so each device must select ITS row via ``axis_index``.
        """
        n = self.n_dev
        me = lax.axis_index(axis)
        ext = jnp.concatenate(
            [own, jnp.zeros((1,) + own.shape[1:], own.dtype)], axis=0)
        parts = [own]
        for k in self.offsets:
            buf = ext[self.send_idx[k][me]]      # (H_k, w): what I ship
            perm = [(e, e - k) for e in range(n) if 0 <= e - k < n]
            parts.append(lax.ppermute(buf, axis, perm))
        return jnp.concatenate(parts, axis=0)

    def scatter_back(self, acc, axis):
        """(n_local, w) accumulator -> (chunk_n, w) with halo contributions
        returned to their owners and added."""
        n = self.n_dev
        me = lax.axis_index(axis)
        own = jnp.concatenate(
            [acc[:self.chunk_n],
             jnp.zeros((1,) + acc.shape[1:], acc.dtype)], axis=0)
        base = self.chunk_n
        for k in self.offsets:
            H = self.halo_sizes[k]
            perm = [(d, d + k) for d in range(n) if 0 <= d + k < n]
            back = lax.ppermute(acc[base:base + H], axis, perm)
            own = own.at[self.send_idx[k][me]].add(back)
            base += H
        return own[:self.chunk_n]


class HaloCellOperator:
    """Dof-partitioned Taylor-Hood operators (the weak-scaling layer).

    Same factory API as :class:`ShardedCellOperator`, but vectors are
    globally shaped, node-padded, and SHARDED over the device mesh -- no
    replication, no full-length psum.  Element matrices are precomputed
    per cell (as in the round-1 layer); only the halo moves per matvec.
    """

    def __init__(self, space: TaylorHoodSpace, mesh: Mesh, axis="shard"):
        config.ensure_accurate_matmuls()
        self.space = space
        self.mesh = mesh
        self.axis = axis
        n_dev = int(mesh.devices.size)
        self.n_dev = n_dev
        dt = config.default_dtype()
        self.dtype = dt
        dim = space.dim
        self.dim = dim

        nc = space.mesh.n_cells
        chunk_c = _ceil_div(nc, n_dev)
        n_pad_c = chunk_c * n_dev - nc
        self.chunk_c = chunk_c

        centroids = space.mesh.points[space.mesh.cells].mean(axis=1)
        cell_order = _morton_order(centroids)
        self.cell_order = cell_order

        W = np.asarray(space.integration_weights(), dtype=dt)[cell_order]
        Jinv = np.asarray(space.Jinv_q, dtype=dt)[cell_order]
        cu = np.asarray(space.cell_unodes, dtype=np.int64)[cell_order]
        cp_ = np.asarray(space.cell_pnodes, dtype=np.int64)[cell_order]

        if n_pad_c:
            W = np.concatenate([W, np.zeros((n_pad_c,) + W.shape[1:],
                                            W.dtype)])
            Jinv = np.concatenate(
                [Jinv, np.repeat(Jinv[:1], n_pad_c, 0)])
            cu = np.concatenate([cu, np.repeat(cu[:1], n_pad_c, 0)])
            cp_ = np.concatenate([cp_, np.repeat(cp_[:1], n_pad_c, 0)])

        # partition-aligned ownership + owner-major renumbering (the
        # permuted, padded layout HaloCellOperator vectors live in)
        self._u_new_id, self.chunk_u, self._u_old_of_new = _partition_nodes(
            cu, chunk_c, space.n_unodes, n_dev)
        self._p_new_id, self.chunk_p, self._p_old_of_new = _partition_nodes(
            cp_, chunk_c, space.n_pnodes, n_dev)
        self.nu_pad = self.chunk_u * n_dev
        self.np_pad = self.chunk_p * n_dev
        cu = self._u_new_id[cu]
        cp_ = self._p_new_id[cp_]
        if n_pad_c:
            # padded cells: zero weight, nodes pinned inside the range of
            # the device that owns them (no spurious halo traffic)
            pad_dev = (np.arange(nc, nc + n_pad_c) // chunk_c)
            cu[nc:] = (pad_dev * self.chunk_u)[:, None]
            cp_[nc:] = (pad_dev * self.chunk_p)[:, None]

        # element matrices (cell-ordered, padded); host copies feed the
        # Jacobi diagonals below with zero device readbacks
        g2 = np.einsum("qia,cqae->cqie", np.asarray(space.G2), Jinv)
        g1 = np.einsum("qja,cqae->cqje", np.asarray(space.G1), Jinv)
        N2h, N1h = np.asarray(space.N2), np.asarray(space.N1)
        M_ch = np.einsum("cq,qi,qj->cij", W, N2h, N2h)
        K_ch = np.einsum("cq,cqie,cqje->cij", W, g2, g2)
        KP_ch = np.einsum("cq,cqje,cqke->cjk", W, g1, g1)
        self.M_c = jnp.asarray(M_ch, dtype=dt)
        self.K_c = jnp.asarray(K_ch, dtype=dt)
        self.G_c = jnp.asarray(-np.einsum("cq,qj,cqid->cidj", W, N1h, g2),
                               dtype=dt)
        self.KP_c = jnp.asarray(KP_ch, dtype=dt)

        # assembled Jacobi diagonals in the partitioned (padded) numbering;
        # padded cells carry zero quadrature weight, so their slots stay 0
        diag_m = np.zeros(self.nu_pad)
        diag_k = np.zeros(self.nu_pad)
        diag_l = np.zeros(self.np_pad)
        np.add.at(diag_m, cu.ravel(), np.einsum("cii->ci", M_ch).ravel())
        np.add.at(diag_k, cu.ravel(), np.einsum("cii->ci", K_ch).ravel())
        np.add.at(diag_l, cp_.ravel(), np.einsum("cjj->cj", KP_ch).ravel())
        self._diag_host = (diag_m, diag_k, diag_l)
        self.W = jnp.asarray(W)
        self.Jinv = jnp.asarray(Jinv)
        self.N2 = jnp.asarray(N2h, dtype=dt)
        self.G2 = jnp.asarray(np.asarray(space.G2), dtype=dt)

        self.u_plan = _HaloPlan(cu, chunk_c, self.chunk_u, n_dev)
        self.p_plan = _HaloPlan(cp_, chunk_c, self.chunk_p, n_dev)

        self._u_gather = jnp.asarray(
            np.where(self._u_old_of_new < 0, space.n_unodes,
                     self._u_old_of_new))
        self._p_gather = jnp.asarray(
            np.where(self._p_old_of_new < 0, space.n_pnodes,
                     self._p_old_of_new))
        self._u_new_id_dev = jnp.asarray(self._u_new_id)
        self._p_new_id_dev = jnp.asarray(self._p_new_id)

        self._vec_spec = P(axis)
        self._tab_spec = P(axis)

    # -- vector layout conversion ---------------------------------------------
    # HaloCellOperator vectors live in the partitioned (owner-major,
    # padded) numbering; these convert to/from the space's numbering.
    def pad_velocity(self, u_flat):
        """(n_unodes*dim,) space layout -> (nu_pad*dim,) partitioned."""
        u = u_flat.reshape(self.space.n_unodes, self.dim)
        ext = jnp.concatenate(
            [u, jnp.zeros((1, self.dim), dtype=u.dtype)], axis=0)
        return ext[self._u_gather].reshape(-1)

    def unpad_velocity(self, u_flat):
        u = u_flat.reshape(self.nu_pad, self.dim)
        return u[self._u_new_id_dev].reshape(-1)

    def pad_pressure(self, p):
        ext = jnp.concatenate([p, jnp.zeros(1, dtype=p.dtype)])
        return ext[self._p_gather]

    def unpad_pressure(self, p):
        return p[self._p_new_id_dev]

    def velocity_sharding(self):
        return NamedSharding(self.mesh, P(self.axis))

    # -- factory helper --------------------------------------------------------
    def _u_to_u(self, elem_apply_factory, extra_arrays=()):
        """Build a velocity->velocity matvec from a per-device kernel.

        ``elem_apply_factory(u_c, *extras)`` maps gathered cell values
        (chunk_c, nn2, dim) to cell contributions of the same shape.
        """
        axis, dim = self.axis, self.dim
        plan = self.u_plan

        def local(cu_local, table, *rest):
            extras = rest[:-1]
            u = rest[-1].reshape(plan.chunk_n, dim)
            full = plan.gather(u, axis)                     # (n_local, d)
            u_c = full[cu_local[0]]                         # (chunk_c, nn2, d)
            r_c = elem_apply_factory(u_c, *[e[0] for e in extras])
            flat = jnp.concatenate(
                [r_c.reshape(-1, dim),
                 jnp.zeros((1, dim), dtype=r_c.dtype)], axis=0)
            acc = flat[table[0]].sum(axis=1)                # (n_local, d)
            out = plan.scatter_back(acc, axis)
            return out.reshape(-1)

        in_specs = (P(axis), P(axis)) + (P(axis),) * len(extra_arrays) \
            + (P(axis),)
        sharded = shard_map(local, mesh=self.mesh, in_specs=in_specs,
                            out_specs=P(axis), check_vma=False)
        cn = plan.cell_nodes_local.reshape(self.n_dev, -1,
                                           *plan.cell_nodes_local.shape[2:])
        tab = plan.tables
        def apply_(u, *dyn):
            assert not dyn, ("_u_to_u carries no dynamic trailing "
                             "arguments; build a dedicated factory instead")
            return sharded(cn, tab, *extra_arrays, u)

        return apply_

    # -- operators -------------------------------------------------------------
    def make_velocity_mass(self):
        M_c = self.M_c.reshape(self.n_dev, self.chunk_c,
                               *self.M_c.shape[1:])

        def apply_(u_c, M):
            return jnp.einsum("cij,cjd->cid", M, u_c)

        fn = self._u_to_u(apply_, (M_c,))
        return jax.jit(lambda u: fn(u))

    def make_velocity_helmholtz(self, visc):
        axis, dim = self.axis, self.dim
        plan = self.u_plan
        M_c = self.M_c.reshape(self.n_dev, self.chunk_c,
                               *self.M_c.shape[1:])
        K_c = self.K_c.reshape(self.n_dev, self.chunk_c,
                               *self.K_c.shape[1:])
        cn = plan.cell_nodes_local
        tab = plan.tables

        def local(cu_local, table, M, K, u, accel0):
            un = u.reshape(plan.chunk_n, dim)
            full = plan.gather(un, axis)
            u_c = full[cu_local[0]]
            A_c = accel0 * M[0] + visc * K[0]
            r_c = jnp.einsum("cij,cjd->cid", A_c, u_c)
            flat = jnp.concatenate(
                [r_c.reshape(-1, dim),
                 jnp.zeros((1, dim), dtype=r_c.dtype)], axis=0)
            acc = flat[table[0]].sum(axis=1)
            return plan.scatter_back(acc, axis).reshape(-1)

        sharded = shard_map(local, mesh=self.mesh,
                            in_specs=(P(axis),) * 4 + (P(axis), P()),
                            out_specs=P(axis), check_vma=False)
        return jax.jit(lambda u, accel0: sharded(cn, tab, M_c, K_c, u,
                                                 accel0))

    def make_gradient(self):
        """p (padded, sharded) -> velocity image (padded, sharded)."""
        axis, dim = self.axis, self.dim
        up, pp = self.u_plan, self.p_plan
        G_c = self.G_c.reshape(self.n_dev, self.chunk_c,
                               *self.G_c.shape[1:])

        def local(cu_local, cp_local, utab, G, p):
            pn = p.reshape(pp.chunk_n, 1)
            pfull = pp.gather(pn, axis)[:, 0]
            p_c = pfull[cp_local[0]]
            r_c = jnp.einsum("cidj,cj->cid", G[0], p_c)
            flat = jnp.concatenate(
                [r_c.reshape(-1, dim),
                 jnp.zeros((1, dim), dtype=r_c.dtype)], axis=0)
            acc = flat[utab[0]].sum(axis=1)
            return up.scatter_back(acc, axis).reshape(-1)

        sharded = shard_map(local, mesh=self.mesh,
                            in_specs=(P(axis),) * 4 + (P(axis),),
                            out_specs=P(axis), check_vma=False)
        return jax.jit(lambda p: sharded(up.cell_nodes_local,
                                         pp.cell_nodes_local,
                                         up.tables, G_c, p))

    def make_divergence(self):
        axis, dim = self.axis, self.dim
        up, pp = self.u_plan, self.p_plan
        G_c = self.G_c.reshape(self.n_dev, self.chunk_c,
                               *self.G_c.shape[1:])

        def local(cu_local, cp_local, ptab, G, u):
            un = u.reshape(up.chunk_n, dim)
            ufull = up.gather(un, axis)
            u_c = ufull[cu_local[0]]
            r_c = jnp.einsum("cidj,cid->cj", G[0], u_c)
            flat = jnp.concatenate(
                [r_c.reshape(-1), jnp.zeros((1,), dtype=r_c.dtype)])
            acc = flat[ptab[0]].sum(axis=1)
            return pp.scatter_back(acc[:, None], axis)[:, 0]

        sharded = shard_map(local, mesh=self.mesh,
                            in_specs=(P(axis),) * 4 + (P(axis),),
                            out_specs=P(axis), check_vma=False)
        return jax.jit(lambda u: sharded(up.cell_nodes_local,
                                         pp.cell_nodes_local,
                                         pp.tables, G_c, u))

    def make_pressure_stiffness(self):
        axis = self.axis
        pp = self.p_plan
        KP_c = self.KP_c.reshape(self.n_dev, self.chunk_c,
                                 *self.KP_c.shape[1:])

        def local(cp_local, ptab, KP, p):
            pn = p.reshape(pp.chunk_n, 1)
            pfull = pp.gather(pn, axis)[:, 0]
            r_c = jnp.einsum("cjk,ck->cj", KP[0], pfull[cp_local[0]])
            flat = jnp.concatenate(
                [r_c.reshape(-1), jnp.zeros((1,), dtype=r_c.dtype)])
            acc = flat[ptab[0]].sum(axis=1)
            return pp.scatter_back(acc[:, None], axis)[:, 0]

        sharded = shard_map(local, mesh=self.mesh,
                            in_specs=(P(axis),) * 3 + (P(axis),),
                            out_specs=P(axis), check_vma=False)
        return jax.jit(lambda p: sharded(pp.cell_nodes_local, pp.tables,
                                         KP_c, p))

    def make_convection_rhs(self, cc):
        """u -> b_i = int(cc (u.grad)u . N_i), quadrature loop."""
        axis, dim = self.axis, self.dim
        up = self.u_plan
        N2, G2 = self.N2, self.G2
        W = self.W.reshape(self.n_dev, self.chunk_c, -1)
        Jinv = self.Jinv.reshape((self.n_dev, self.chunk_c)
                                 + self.Jinv.shape[1:])

        def local(cu_local, utab, Wd, Jd, u):
            un = u.reshape(up.chunk_n, dim)
            full = up.gather(un, axis)
            u_c = full[cu_local[0]]
            g2 = jnp.einsum("qia,cqae->cqie", G2, Jd[0])
            u_q = jnp.einsum("qi,cid->cqd", N2, u_c)
            grad_u = jnp.einsum("cid,cqie->cqde", u_c, g2)
            conv = cc * jnp.einsum("cqde,cqe->cqd", grad_u, u_q)
            r_c = jnp.einsum("cq,cqd,qi->cid", Wd[0], conv, N2)
            flat = jnp.concatenate(
                [r_c.reshape(-1, dim),
                 jnp.zeros((1, dim), dtype=r_c.dtype)], axis=0)
            acc = flat[utab[0]].sum(axis=1)
            return up.scatter_back(acc, axis).reshape(-1)

        sharded = shard_map(local, mesh=self.mesh,
                            in_specs=(P(axis),) * 4 + (P(axis),),
                            out_specs=P(axis), check_vma=False)
        return jax.jit(lambda u: sharded(up.cell_nodes_local, up.tables,
                                         W, Jinv, u))

    def diagonals(self):
        """Assembled Jacobi diagonals, padded + sharded over the mesh.

        Velocity diagonals are expanded to the node-major ``(nu_pad*dim,)``
        vector layout of :meth:`pad_velocity`; padding slots hold 0 (the
        callers' ``1/max(d, eps)`` guard turns them inert).
        """
        dm, dk, dl = self._diag_host
        sh = NamedSharding(self.mesh, P(self.axis))
        rep = lambda a: np.repeat(a, self.dim)
        return (jax.device_put(jnp.asarray(rep(dm), dtype=self.dtype), sh),
                jax.device_put(jnp.asarray(rep(dk), dtype=self.dtype), sh),
                jax.device_put(jnp.asarray(dl, dtype=self.dtype), sh))

    # -- diagnostics -------------------------------------------------------------
    def halo_report(self) -> dict:
        """Per-device memory / halo statistics (the weak-scaling table)."""
        return {
            "n_devices": self.n_dev,
            "u_nodes_per_device": self.u_plan.chunk_n,
            "u_halo_per_device": self.u_plan.n_local - self.u_plan.chunk_n,
            "p_nodes_per_device": self.p_plan.chunk_n,
            "p_halo_per_device": self.p_plan.n_local - self.p_plan.chunk_n,
            "active_offsets_u": list(self.u_plan.offsets),
            "active_offsets_p": list(self.p_plan.offsets),
        }
