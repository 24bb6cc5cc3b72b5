"""Gather-free assembled-operator engine (the generic any-mesh hot path).

Replaces the per-cell gather/scatter matvecs of ``parallel/sharded.py``
with *assembled* scalar operators in one of two gather-free device
formats, selected per matrix from the data.  The formats were chosen on
the system's first accelerator, whose scalar gathers ran as a serial
loop; on the H100 they have not yet been measured against a plain
gather/CSR apply:

* ``CirculantBand`` -- if, under a lexicographic node ordering, the set of
  nonzero offsets ``(col - row) mod N`` is small (structured generators:
  P2 stiffness has 29 offsets on a 2D torus, P1 Laplacian 9), store a
  dense band ``(n_offsets, N)`` and apply with shifted slices + fused
  multiply-adds: pure memory streaming, no gathers, periodic wrap free.
* ``AffineBand`` -- otherwise (gmsh meshes, rectangular velocity/pressure
  couplings), a block-window band: rows in blocks of 128, each block's
  columns inside a window whose start is affine in the block index
  (ordering from reverse Cuthill-McKee keeps windows narrow).  The window
  slices are *static* (stride = round(RB * n_cols / n_rows)), so the
  apply is window construction by reshape/static-slice plus one batched
  dense mat-vec that streams the band from device memory.

Assembly runs entirely host-side in NumPy/SciPy f64 and performs no
device readbacks.

Reference counterpart: the per-step ``SystemAssembler`` assembly + PETSc
solves of /root/reference/source/ns_solver_base.py:972-983 and the IPCS
sub-solves of ns_ipcs_solver.py:149-208 -- here the "assembly" happens
once on the host and each solver iteration is a fused XLA program.
"""

from __future__ import annotations

from typing import NamedTuple

from os import environ as _os_env

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from navierstokes_tpu import config

# rows per block in AffineBand: the lane width of the accelerator the
# format was tuned on; not yet measured against other heights on the H100
RB = 128


# ---------------------------------------------------------------------------
# host-side scalar element matrices and CSR assembly
# ---------------------------------------------------------------------------

def scalar_element_matrices(space):
    """Per-cell scalar P2/P1 element matrices (host f64).

    Returns dict with
      M2 (nc, 6, 6)   P2 mass,
      K2 (nc, 6, 6)   P2 stiffness,
      L1 (nc, 3, 3)   P1 stiffness,
      M1 (nc, 3, 3)   P1 mass,
      G  (nc, 6, d, 3)  pressure-gradient coupling
                        G[c, i, d, j] = -int N1_j dN2_i/dx_d.
    """
    W = np.asarray(space.integration_weights(), dtype=np.float64)
    N2 = np.asarray(space.N2, dtype=np.float64)
    N1 = np.asarray(space.N1, dtype=np.float64)
    Jinv_q = np.asarray(space.Jinv_q, dtype=np.float64)
    g2 = np.einsum("qia,cqae->cqie", np.asarray(space.G2, np.float64), Jinv_q)
    g1 = np.einsum("qja,cqae->cqje", np.asarray(space.G1, np.float64), Jinv_q)
    return {
        "M2": np.einsum("cq,qi,qj->cij", W, N2, N2),
        "K2": np.einsum("cq,cqie,cqje->cij", W, g2, g2),
        "L1": np.einsum("cq,cqje,cqke->cjk", W, g1, g1),
        "M1": np.einsum("cq,qj,qk->cjk", W, N1, N1),
        "G": -np.einsum("cq,qj,cqid->cidj", W, N1, g2),
    }


def assemble_csr(vals, rows_nodes, cols_nodes, shape):
    """Scatter per-cell blocks (nc, a, b) into a CSR matrix."""
    nc, a, b = vals.shape
    r = np.repeat(rows_nodes, b, axis=1).ravel()
    c = np.tile(cols_nodes, (1, a)).ravel()
    m = sp.coo_matrix((vals.ravel(), (r, c)), shape=shape).tocsr()
    m.sum_duplicates()
    return m


def node_coordinates(space):
    """(n_unodes, d) and (n_pnodes, d) canonical node coordinates.

    Periodic slave occurrences map onto their owner; the canonical
    coordinate is the per-axis minimum over occurrences (periodic boxes
    are axis-aligned, so this recovers the owner-side coordinate).
    """
    cu = np.asarray(space.cell_unodes)
    cp = np.asarray(space.cell_pnodes)
    X = np.asarray(space.cell_ucoords, dtype=np.float64)
    d = X.shape[-1]
    uc = np.full((space.n_unodes, d), np.inf)
    pc = np.full((space.n_pnodes, d), np.inf)
    for ax in range(d):
        np.minimum.at(uc[:, ax], cu.ravel(), X[..., ax].ravel())
        np.minimum.at(pc[:, ax], cp.ravel(),
                      X[:, :cp.shape[1], ax].ravel())
    return uc, pc


def lex_permutation(coords, tol=1e-9):
    """Row-major lexicographic node order (last axis fastest)."""
    keys = np.round(np.asarray(coords, np.float64) / tol).astype(np.int64)
    perm = np.lexsort(tuple(keys[:, ax] for ax in range(keys.shape[1])))
    return np.asarray(perm, dtype=np.int64)


def rcm_permutation(A):
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(A.tocsr(),
                                            symmetric_mode=False),
                      dtype=np.int64)


def _inverse(perm):
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


# ---------------------------------------------------------------------------
# device formats
# ---------------------------------------------------------------------------

class CirculantBand:
    """y[i] = sum_d band[d, i] * x[(i + off_d) mod N] via rolls.

    Registered as a JAX pytree (the band array is a leaf) so operators can
    be passed as *arguments* into jitted programs -- closed-over device
    arrays would be embedded as HLO constants, which bloats the programs
    and defeats donation.
    """

    def __init__(self, offsets, band, dtype):
        self.offsets = tuple(int(o) for o in offsets)
        self.n = band.shape[1]
        self._diag_host = (np.ascontiguousarray(band[list(self.offsets).index(0)])
                           if 0 in self.offsets else np.zeros(self.n))
        self.band = jnp.asarray(band, dtype=dtype)

    # above this many band elements the unrolled apply is emitted as a
    # lax.scan over (band row, offset): a 3D P2 stiffness has ~95 offsets
    # at ~1e6 rows, and unrolling 95 slices into every CG iteration of
    # every sub-solve made the program too large to compile in reasonable
    # time.  The scan keeps the HLO O(1) in the offset count at identical
    # memory traffic.  The budget was set on the first accelerator and has
    # not been measured on the H100.
    _UNROLL_BUDGET = int(1e7)

    # apply lowering: "stack" = build the (K, ..., N) window tensor from
    # static slices of one doubled copy and contract it in one fused
    # multiply-reduce (the default); "roll" = per-offset jnp.roll chain,
    # one concat+slice+fma per offset.  NS_CIRC_APPLY selects.
    mode = _os_env.get("NS_CIRC_APPLY", "stack")

    def apply(self, x):
        """x: (..., N) -> (..., N)."""
        if self.band.size <= self._UNROLL_BUDGET:
            if self.mode == "stack":
                from jax import lax

                x2 = jnp.concatenate([x, x], axis=-1)
                wins = jnp.stack(
                    [lax.slice_in_dim(x2, o, o + self.n, axis=-1)
                     for o in self.offsets], axis=0)     # (K, ..., N)
                band = self.band.reshape(
                    (len(self.offsets),) + (1,) * (x.ndim - 1) + (self.n,))
                return (band * wins).sum(axis=0)
            acc = None
            for k, o in enumerate(self.offsets):
                xo = x if o == 0 else jnp.roll(x, -o, axis=-1)
                term = self.band[k] * xo
                acc = term if acc is None else acc + term
            return acc
        # roll(x, -o) == concat(x, x)[..., o:o+N]; scanning over
        # (band row, offset) pairs keeps the program size constant
        from jax import lax

        x2 = jnp.concatenate([x, x], axis=-1)
        offs = jnp.asarray(self.offsets, jnp.int32)

        def body(acc, bo):
            b_k, o = bo
            xo = lax.dynamic_slice_in_dim(x2, o, self.n, axis=-1)
            return acc + b_k * xo, None

        acc, _ = lax.scan(body, jnp.zeros_like(x), (self.band, offs))
        return acc

    def diagonal(self):
        if self._diag_host is None:
            # combine_circulant fuses traced coefficients; its diagonal
            # row lives on device in the fused band
            if 0 in self.offsets:
                return self.band[self.offsets.index(0)]
            return jnp.zeros(self.n, dtype=self.band.dtype)
        return jnp.asarray(self._diag_host, dtype=self.band.dtype)

    @property
    def nbytes(self):
        return self.band.size * self.band.dtype.itemsize


class AffineBand:
    """Block-window band: rows in blocks of RB, window start affine in b.

    ``bandmat`` is (nblk, RB, W) with
        A[b*RB + i, start_b + w] = bandmat[b, i, w],
        start_b = b * stride - b_lo.
    Window construction is static slicing of the padded x reshaped to
    stride-wide tiles; the apply is one batched dense mat-vec.
    """

    def __init__(self, n_rows, n_cols, stride, b_lo, bandmat, dtype):
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)
        self.stride = int(stride)
        self.b_lo = int(b_lo)
        nblk, rb, W = bandmat.shape
        assert rb == RB
        self.nblk = nblk
        s = self.stride
        self.T = -(-W // s)
        Wp = self.T * s
        if Wp != W:
            bandmat = np.concatenate(
                [bandmat, np.zeros((nblk, RB, Wp - W), bandmat.dtype)],
                axis=2)
        self.W = Wp
        self._diag_host = self._extract_diag(bandmat)
        self.bandmat = jnp.asarray(bandmat, dtype=dtype)
        # padded-x length: window max = (nblk-1)*s + Wp, plus front pad b_lo
        need = self.b_lo + (self.nblk - 1) * s + Wp
        self.pad_back = max(need - self.n_cols, 0)
        total = self.b_lo + self.n_cols + self.pad_back
        self.pad_back += (-total) % s
        self.n_tiles = (self.b_lo + self.n_cols + self.pad_back) // s

    def _windows(self, x):
        """x: (..., n_cols) -> (..., nblk, W) window matrix.

        The padding is *circular* (xp[i] = x[(i - b_lo) mod N]): periodic
        wrap columns live near the window under the centered-mod offsets
        of ``build_operator``; for non-periodic operators the wrapped
        reads multiply zero band entries, so they are inert.
        """
        total = self.b_lo + self.n_cols + self.pad_back
        s0 = (-self.b_lo) % self.n_cols
        reps = -(-(s0 + total) // self.n_cols)
        xp = jnp.concatenate([x] * reps, axis=-1)[..., s0:s0 + total]
        tiles = xp.reshape(x.shape[:-1] + (self.n_tiles, self.stride))
        parts = [jax.lax.slice_in_dim(tiles, t, t + self.nblk, axis=-2)
                 for t in range(self.T)]
        wins = jnp.stack(parts, axis=-2)          # (..., nblk, T, s)
        return wins.reshape(x.shape[:-1] + (self.nblk, self.W))

    def apply(self, x):
        """x: (..., n_cols) -> (..., n_rows)."""
        wins = self._windows(x)
        out = jnp.einsum("bij,...bj->...bi", self.bandmat, wins,
                         preferred_element_type=wins.dtype)
        out = out.reshape(x.shape[:-1] + (self.nblk * RB,))
        return out[..., :self.n_rows]

    def _extract_diag(self, bandmat):
        if self.n_rows != self.n_cols:
            return None
        rows = np.arange(self.n_rows)
        b, i = rows // RB, rows % RB
        rel = (np.mod(rows - b * self.stride + self.n_cols // 2,
                      self.n_cols) - self.n_cols // 2)
        w = rel + self.b_lo
        ok = (w >= 0) & (w < self.W)
        diag = np.zeros(self.n_rows, bandmat.dtype)
        diag[ok] = bandmat[b[ok], i[ok], w[ok]]
        return diag

    def diagonal(self):
        assert self._diag_host is not None
        return jnp.asarray(self._diag_host, dtype=self.bandmat.dtype)

    @property
    def nbytes(self):
        return self.bandmat.size * self.bandmat.dtype.itemsize


def build_operator(A, dtype, circulant_cap=96, window_cap=6144,
                   name="", max_bytes=None):
    """Pick the device format for a (permuted) CSR matrix.

    Tries CirculantBand (offset count <= circulant_cap), then AffineBand
    (window width <= window_cap and band storage <= max_bytes, default
    ``NS_FASTOP_MAX_BYTES`` or 1e9).  Raises ``StructureError`` if
    neither fits -- callers fall back to the gather path.  The 1e9 cap
    was sized for the first accelerator's memory and has not been
    revisited for the H100's 80 GB.
    """
    import os

    if max_bytes is None:
        max_bytes = float(os.environ.get("NS_FASTOP_MAX_BYTES", 1e9))
    A = A.tocoo()
    n_rows, n_cols = A.shape
    if n_rows == n_cols:
        off = np.mod(A.col - A.row, n_cols)
        uniq = np.unique(off)
        if len(uniq) <= circulant_cap:
            idx = np.searchsorted(uniq, off)
            # stage in the device dtype: shipping f64 and converting
            # on-device doubles both the host footprint and the transfer
            band = np.zeros((len(uniq), n_cols), dtype=np.dtype(dtype))
            band[idx, A.row] = A.data
            return CirculantBand(uniq, band, dtype)
    # affine block-window band (centered-mod offsets: periodic wrap
    # columns fold back near the window)
    stride = max(int(round(RB * n_cols / n_rows)), 1)
    b = A.row // RB
    rel = np.mod(A.col - b * stride + n_cols // 2, n_cols) - n_cols // 2
    b_lo = int(max(-rel.min(), 0))
    W = int(rel.max() + b_lo + 1)
    if W > window_cap:
        raise StructureError(
            f"{name or 'operator'}: window {W} exceeds cap {window_cap} "
            f"(offsets {len(np.unique(np.mod(A.col - A.row, n_cols))) if n_rows == n_cols else '-'})")
    nblk = -(-n_rows // RB)
    W_pad = -(-W // stride) * stride    # pre-pad to the stride multiple
    est = nblk * RB * W_pad * jnp.dtype(dtype).itemsize
    if est > max_bytes:
        raise StructureError(
            f"{name or 'operator'}: band storage {est/1e9:.2f} GB exceeds "
            f"NS_FASTOP_MAX_BYTES={max_bytes/1e9:.2f} GB")
    bandmat = np.zeros((nblk, RB, W_pad), dtype=np.dtype(dtype))
    bandmat[b, A.row % RB, rel + b_lo] = A.data
    return AffineBand(n_rows, n_cols, stride, b_lo, bandmat, dtype)


class StructureError(ValueError):
    """No gather-free format fits this operator."""


class GatherOp:
    """Sorted-COO rim operator (device gather + scatter-add).

    The rectangular couplings (gradient/divergence) apply only ~3x per
    projection step -- against the hundreds of banded CG matvecs on
    M/K/L, their gather cost is noise, while their *band* storage grows
    with the grid line length (O(N^1.5) total: ~1 GB each at 256^2,
    16 GB at 512^2).  Above ``NS_FASTOP_RIM_BYTES`` the engine stores
    them as plain sorted COO instead.
    """

    def __init__(self, A, dtype):
        coo = A.tocoo()
        coo.sum_duplicates()
        order = np.lexsort((coo.col, coo.row))
        self.n_rows, self.n_cols = A.shape
        self.rows = jnp.asarray(coo.row[order].astype(np.int32))
        self.cols = jnp.asarray(coo.col[order].astype(np.int32))
        self.vals = jnp.asarray(coo.data[order].astype(np.dtype(dtype)))

    def apply(self, x):
        """x: (..., n_cols) -> (..., n_rows)."""
        contrib = self.vals * x[..., self.cols]
        out = jnp.zeros(x.shape[:-1] + (self.n_rows,), dtype=contrib.dtype)
        return out.at[..., self.rows].add(contrib)

    @property
    def nbytes(self):
        return (self.vals.size * self.vals.dtype.itemsize
                + self.rows.size * 8)


class StencilCoupling:
    """Class-constant P2<->P1 coupling stencil on translation-class grids.

    On uniform periodic boxes the permuted P2 nodes fill a fine
    (Ny, Nx) torus grid and the P1 nodes its stride-2 coarse grid; the
    gradient/divergence couplings G (Nu, Np) and D (Np, Nu) are then
    EXACTLY translation-invariant per fine parity phase: every nonzero
    A[i, j] depends only on (parity(i), coarse_offset(i, j)) -- 19
    distinct values at any size (measured spread ~1e-16).  The apply is
    a handful of static slices of a wrap-padded plane + fma: O(taps)
    storage and x+y memory traffic, against the 387 MB AffineBand rim at
    128^2 and a COO fallback whose index arrays grow with the grid.
    Replaces the
    PETSc SpMV of the reference's projection sub-steps
    (ns_ipcs_solver.py:160-187).
    """

    #: (a, b) parity enumeration order for taps
    PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))

    def __init__(self, kind, fine_grid, coarse_grid, offs, weights, dtype):
        assert kind in ("G", "D")
        self.kind = kind
        self.fine = tuple(int(v) for v in fine_grid)
        self.coarse = tuple(int(v) for v in coarse_grid)
        # offs: 4-tuple (per phase) of ((dy, dx), ...) coarse offsets
        self.offs = tuple(tuple((int(dy), int(dx)) for dy, dx in ph)
                          for ph in offs)
        self.extent = max((max(abs(dy), abs(dx)) for ph in self.offs
                           for dy, dx in ph), default=0)
        self.weights = jnp.asarray(np.asarray(weights), dtype=dtype)
        if kind == "G":
            self.n_rows = self.fine[0] * self.fine[1]
            self.n_cols = self.coarse[0] * self.coarse[1]
        else:
            self.n_rows = self.coarse[0] * self.coarse[1]
            self.n_cols = self.fine[0] * self.fine[1]

    def _phase_slices(self, pad, nyc, nxc):
        e = self.extent
        w = 0
        for ph in self.offs:
            acc = None
            for dy, dx in ph:
                sl = jax.lax.slice_in_dim(
                    jax.lax.slice_in_dim(pad, e + dy, e + dy + nyc,
                                         axis=-2),
                    e + dx, e + dx + nxc, axis=-1)
                term = self.weights[w] * sl
                w += 1
                acc = term if acc is None else acc + term
            yield acc

    def apply(self, x):
        nyc, nxc = self.coarse
        lead = x.shape[:-1]
        nl = len(lead)
        e = self.extent
        if self.kind == "G":
            # coarse plane -> 4 fine parity phases
            pg = x.reshape(lead + (nyc, nxc))
            pad = jnp.pad(pg, ((0, 0),) * nl + ((e, e), (e, e)),
                          mode="wrap")
            phases = list(self._phase_slices(pad, nyc, nxc))
            ph = jnp.stack(phases, axis=nl).reshape(
                lead + (2, 2, nyc, nxc))
            # out[..., I, a, J, b] = ph[..., a, b, I, J]
            axes = tuple(range(nl)) + (nl + 2, nl, nl + 3, nl + 1)
            out = ph.transpose(axes)
            return out.reshape(lead + (self.n_rows,))
        # D: 4 fine parity phases -> coarse plane
        ug = x.reshape(lead + (nyc, 2, nxc, 2))
        acc = None
        w = 0
        for (a, b), ph in zip(self.PHASES, self.offs):
            plane = ug[..., :, a, :, b]
            pad = jnp.pad(plane, ((0, 0),) * nl + ((e, e), (e, e)),
                          mode="wrap")
            for dy, dx in ph:
                sl = jax.lax.slice_in_dim(
                    jax.lax.slice_in_dim(pad, e + dy, e + dy + nyc,
                                         axis=-2),
                    e + dx, e + dx + nxc, axis=-1)
                term = self.weights[w] * sl
                w += 1
                acc = term if acc is None else acc + term
        return acc.reshape(lead + (self.n_rows,))

    @property
    def nbytes(self):
        return self.weights.size * self.weights.dtype.itemsize


def _sc_flatten(op):
    aux = (op.kind, op.fine, op.coarse, op.offs, op.extent,
           op.n_rows, op.n_cols)
    return (op.weights,), aux


def _sc_unflatten(aux, children):
    op = object.__new__(StencilCoupling)
    (op.kind, op.fine, op.coarse, op.offs, op.extent,
     op.n_rows, op.n_cols) = aux
    (op.weights,) = children
    return op


jax.tree_util.register_pytree_node(StencilCoupling, _sc_flatten,
                                   _sc_unflatten)


def detect_stencil_coupling(A, kind, fine_grid, coarse_grid, dtype,
                            max_extent=2, tol=1e-11):
    """Exact class-constant detection of a P2<->P1 coupling matrix.

    Returns a :class:`StencilCoupling` when EVERY nonzero of ``A``
    (CSR/COO, rows fine for "G", rows coarse for "D") is reproduced by a
    per-parity-phase constant stencil on the torus grids -- each
    (phase, offset) group must cover every coarse anchor exactly once
    with value spread <= tol.  Returns None otherwise (callers fall
    back to the banded/COO formats).
    """
    Ny, Nx = fine_grid
    nyc, nxc = coarse_grid
    if nyc < 2 * max_extent + 2 or nxc < 2 * max_extent + 2:
        return None
    A = A.tocoo()
    fine_idx = A.row if kind == "G" else A.col
    coarse_idx = A.col if kind == "G" else A.row
    fy, fx = fine_idx // Nx, fine_idx % Nx
    a, b = fy % 2, fx % 2
    Jy, Jx = coarse_idx // nxc, coarse_idx % nxc
    if kind == "G":
        dy = (Jy - fy // 2) % nyc
        dx = (Jx - fx // 2) % nxc
    else:
        dy = (fy // 2 - Jy) % nyc
        dx = (fx // 2 - Jx) % nxc
    dy = np.where(dy > nyc // 2, dy - nyc, dy)
    dx = np.where(dx > nxc // 2, dx - nxc, dx)
    if abs(dy).max() > max_extent or abs(dx).max() > max_extent:
        return None
    span = 2 * max_extent + 1
    key = ((a * 2 + b) * span + (dy + max_extent)) * span \
        + (dx + max_extent)
    order = np.argsort(key, kind="stable")
    ks, vs = key[order], A.data[order]
    uk, starts = np.unique(ks, return_index=True)
    bounds = np.append(starts, len(ks))
    m = nyc * nxc
    scale = np.abs(A.data).max()
    offs = [[] for _ in range(4)]
    weights = []
    per_phase = [[] for _ in range(4)]
    for i, k in enumerate(uk):
        grp = vs[bounds[i]:bounds[i + 1]]
        if len(grp) != m or np.ptp(grp) > tol * scale:
            return None
        ph, rem = divmod(int(k), span * span)
        dyy, dxx = divmod(rem, span)
        per_phase[ph].append(((dyy - max_extent, dxx - max_extent),
                              grp[0]))
    for ph in range(4):
        for (o, v) in per_phase[ph]:
            offs[ph].append(o)
            weights.append(v)
    return StencilCoupling(kind, fine_grid, coarse_grid,
                           tuple(tuple(o) for o in offs),
                           np.asarray(weights), dtype)


def _go_flatten(op):
    return (op.rows, op.cols, op.vals), (op.n_rows, op.n_cols)


def _go_unflatten(aux, children):
    op = object.__new__(GatherOp)
    op.n_rows, op.n_cols = aux
    op.rows, op.cols, op.vals = children
    return op


jax.tree_util.register_pytree_node(GatherOp, _go_flatten, _go_unflatten)


def build_rim_operator(A, dtype, circulant_cap=96, window_cap=6144,
                       name="", max_bytes=None):
    """Band format if it fits the rim budget, else sorted-COO gather.

    The default budget (``NS_FASTOP_RIM_BYTES``, 2.5e8) was sized for the
    first accelerator's memory and has not been revisited for the H100.
    """
    import os

    rim_cap = float(os.environ.get("NS_FASTOP_RIM_BYTES", 2.5e8))
    if max_bytes is not None:
        rim_cap = min(rim_cap, max_bytes)
    try:
        return build_operator(A, dtype, circulant_cap, window_cap,
                              name=name, max_bytes=rim_cap)
    except StructureError:
        return GatherOp(A, dtype)


def _cb_flatten(op):
    return (op.band,), (op.offsets, op.n)


def _cb_unflatten(aux, children):
    op = object.__new__(CirculantBand)
    op.offsets, op.n = aux
    (op.band,) = children
    op._diag_host = None
    return op


jax.tree_util.register_pytree_node(CirculantBand, _cb_flatten, _cb_unflatten)


def combine_circulant(terms):
    """``sum_i c_i A_i`` as ONE CirculantBand (coefficients may be traced).

    Fusing the Helmholtz combination (a0/k) M + nu K into a single band
    halves both the per-iteration band traffic and the kernel count
    of the velocity CG sub-solves -- the band combine itself is one
    elementwise pass, paid once per step instead of once per iteration.
    Traceable: call inside jit with traced coefficients.
    """
    ops = [op for _, op in terms]
    n = ops[0].n
    union = sorted({o for op in ops for o in op.offsets})
    if all(op.offsets == tuple(union) for op in ops):
        band = sum(c * op.band for c, op in terms)
    else:
        pos = {o: i for i, o in enumerate(union)}
        band = jnp.zeros((len(union), n), ops[0].band.dtype)
        for c, op in terms:
            idx = np.asarray([pos[o] for o in op.offsets])
            band = band.at[idx].add(c * op.band)
    out = object.__new__(CirculantBand)
    out.offsets = tuple(union)
    out.n = n
    # fused bands are built from traced coefficients, so a host-side
    # diagonal snapshot does not exist; diagonal() falls back to the
    # on-device zero-offset band row
    out._diag_host = None
    out.band = band
    return out

_AB_AUX = ("n_rows", "n_cols", "stride", "b_lo", "nblk", "T", "W",
           "pad_back", "n_tiles")


def _ab_flatten(op):
    return (op.bandmat,), tuple(getattr(op, a) for a in _AB_AUX)


def _ab_unflatten(aux, children):
    op = object.__new__(AffineBand)
    for name, val in zip(_AB_AUX, aux):
        setattr(op, name, val)
    (op.bandmat,) = children
    op._diag_host = None
    return op


jax.tree_util.register_pytree_node(AffineBand, _ab_flatten, _ab_unflatten)


# ---------------------------------------------------------------------------
# Taylor-Hood operator suite (planar layout)
# ---------------------------------------------------------------------------

class PlanarOps(NamedTuple):
    """Device-side operator bundle, passed as a pytree *argument* into
    jitted programs (never closed over: see CirculantBand docstring)."""

    M: object                 # velocity scalar mass (band op)
    K: object                 # velocity scalar stiffness
    L: object                 # pressure stiffness
    G: tuple                  # per-dim pressure-gradient couplings
    D: tuple                  # per-dim divergence couplings
    diag_m: jnp.ndarray
    diag_k: jnp.ndarray
    diag_l: jnp.ndarray
    conv_cu: jnp.ndarray      # (nc, 6) permuted cell u-node ids
    conv_W: jnp.ndarray       # (nc, nq) quadrature weights
    conv_N2: jnp.ndarray      # (nq, 6)
    conv_g2: jnp.ndarray      # (nc, nq, 6, d) physical shape gradients
    conv_table: jnp.ndarray   # transpose-scatter table
    Mp: object = None         # pressure (P1) mass -- rotational scheme
    diag_mp: jnp.ndarray = None
    conv_Wc: jnp.ndarray = None   # (ncls, nq) per-class quad weights
    conv_g2c: jnp.ndarray = None  # (ncls, nq, nn, d) per-class gradients


class StridedConv(NamedTuple):
    """Static descriptor of the gather-free (strided) convection layout.

    On meshes whose lex ordering makes the scalar operators circulant
    (uniform periodic boxes), the P2 nodes form a regular half-spacing
    torus grid of shape ``grid`` and every cell is one of a few
    translation classes: its 6 nodes sit at fixed 2D offsets ``offs[c]``
    from a stride-2 anchor lattice.  The cell gather/scatter of the
    convection quadrature then lowers to rolls + strided slices (pure
    memory streaming) instead of ~1.3M scalar gathers, which ran as a
    serial loop on the first accelerator; not yet measured against the
    gather form on the H100.
    Hashable (nested tuples) so it can ride ``jit`` static args.
    """

    grid: tuple               # (Ny, Nx) fine-grid shape, Ny*Nx = Nu
    offs: tuple               # ncls x nn x 2 nested int tuples


def conv_apply(ops: PlanarOps, u, cc, strided=None):
    """Assembled convection rhs b = int(cc (u.grad)u . N), planar."""
    if strided is not None and ops.conv_Wc is not None:
        return _conv_apply_strided(ops, u, cc, strided)
    dim = u.shape[0]
    u_c = u[:, ops.conv_cu]                                  # (d, nc, 6)
    u_q = jnp.einsum("qi,dci->dcq", ops.conv_N2, u_c)
    grad_u = jnp.einsum("dci,cqie->dcqe", u_c, ops.conv_g2)
    adv = cc * jnp.einsum("ecq,dcqe->dcq", u_q, grad_u)
    r_c = jnp.einsum("cq,dcq,qi->dci", ops.conv_W, adv, ops.conv_N2)
    flat = r_c.reshape(dim, -1)
    pad = jnp.zeros((dim, 1), dtype=flat.dtype)
    padded = jnp.concatenate([flat, pad], axis=1)
    return padded[:, ops.conv_table].sum(axis=2)


def _conv_apply_strided(ops: PlanarOps, u, cc, strided: StridedConv):
    """Gather-free convection on translation-class grids (StridedConv).

    The fine grid is first split into its 4 half-spacing parity phases
    (one relayout) and cyclically padded by one coarse cell; every
    per-(class, node) extract and scatter is then a *static* slice of a
    contiguous (ny, nx) phase plane, which XLA fuses into the quadrature
    einsums instead of materializing 24 strided copies.
    """
    d = u.shape[0]
    Ny, Nx = strided.grid
    ny, nx = Ny // 2, Nx // 2
    ph = u.reshape(d, ny, 2, nx, 2).transpose(0, 2, 4, 1, 3)
    pad = jnp.pad(ph, ((0, 0),) * 3 + ((1, 1), (1, 1)), mode="wrap")
    outp = jnp.zeros((d, 2, 2, ny + 2, nx + 2), u.dtype)

    def loc(dy, dx):
        py, px = dy % 2, dx % 2
        return py, px, (dy - py) // 2 + 1, (dx - px) // 2 + 1

    for c, off_c in enumerate(strided.offs):
        cols = []
        for dy, dx in off_c:
            py, px, sy, sx = loc(dy, dx)
            cols.append(pad[:, py, px, sy:sy + ny, sx:sx + nx]
                        .reshape(d, -1))
        u_c = jnp.stack(cols, axis=-1)                       # (d, m, nn)
        u_q = jnp.einsum("qi,dmi->dmq", ops.conv_N2, u_c)
        grad_u = jnp.einsum("dmi,qie->dmqe", u_c, ops.conv_g2c[c])
        adv = cc * jnp.einsum("emq,dmqe->dmq", u_q, grad_u)
        r_c = jnp.einsum("q,dmq,qi->dmi", ops.conv_Wc[c], adv,
                         ops.conv_N2)
        m2 = r_c.reshape(d, ny, nx, r_c.shape[-1])
        for i, (dy, dx) in enumerate(off_c):
            py, px, sy, sx = loc(dy, dx)
            outp = outp.at[:, py, px, sy:sy + ny, sx:sx + nx].add(
                m2[..., i])
    # fold the cyclic pad ring back into the interior (rows first with
    # full columns, so corner contributions ride along)
    outp = outp.at[:, :, :, ny, :].add(outp[:, :, :, 0, :])
    outp = outp.at[:, :, :, 1, :].add(outp[:, :, :, ny + 1, :])
    outp = outp.at[:, :, :, :, nx].add(outp[:, :, :, :, 0])
    outp = outp.at[:, :, :, :, 1].add(outp[:, :, :, :, nx + 1])
    out = outp[:, :, :, 1:ny + 1, 1:nx + 1]
    return out.transpose(0, 3, 1, 4, 2).reshape(d, -1)


class FastTaylorHood:
    """Gather-free scalar-operator suite for a Taylor-Hood space.

    Works in *permuted* node numberings chosen per field (lexicographic if
    it yields circulant structure, else reverse Cuthill-McKee) and a
    *planar* velocity layout ``(dim, n_unodes)`` (the velocity operators
    are identical per component, so one band application serves all
    components -- element matrices are scalar, see
    ``scalar_element_matrices``).

    Use ``permute_velocity`` / ``unpermute_velocity`` (and the pressure
    versions) at solver boundaries; keep state permuted across steps.
    """

    @staticmethod
    def _early_band_guard(space, cu, Nu, circulant_cap, window_cap,
                          max_bytes):
        """Fail FAST (seconds, before any CSR assembly) when no band
        format can plausibly fit.  Samples cells under the lex
        permutation: if the sampled mod-offset count rules out the
        circulant format AND the sampled block-window lower bound
        overshoots the affine-band caps by >= 4x (margin for the RCM
        fallback's narrower bandwidth), raise StructureError now --
        at 3D scale the full assembly this guard skips costs minutes.
        """
        import os

        if max_bytes is None:
            max_bytes = float(os.environ.get("NS_FASTOP_MAX_BYTES", 1e9))
        ucoords, _ = node_coordinates(space)
        perm = _inverse(lex_permutation(ucoords))
        rng = np.random.default_rng(0)
        pick = rng.choice(len(cu), size=min(len(cu), 2048), replace=False)
        # interior-only samples of a non-periodic box LOOK circulant
        # (translation-invariant stencil); the boundary rows are what
        # break the format, so sample them explicitly too
        bnd = np.unique(np.asarray(
            space.mesh.facet_cell[space.mesh.exterior_facet_mask]))
        if len(bnd) > 1024:
            bnd = bnd[rng.choice(len(bnd), size=1024, replace=False)]
        sample = cu[np.unique(np.concatenate([pick, bnd]))]
        pc = perm[sample]                          # (ns, nn) permuted ids
        # the rectangular G/D couplings always have the sorted-COO rim
        # fallback, so feasibility hinges on the SQUARE velocity ops
        # (per-CG-iteration matvecs): circulant whenever the sampled
        # stencil mod-offset count stays under the cap (class grids in
        # any dimension), else the affine window must fit -- estimate
        # its lower bound from the sampled stiffness pattern under lex
        # (4x margin for the narrower RCM fallback ordering)
        nn = pc.shape[1]
        offs = np.mod(pc[:, :, None] - pc[:, None, :], Nu).ravel()
        if len(np.unique(offs)) <= circulant_cap:
            return
        item = np.dtype(config.default_dtype()).itemsize
        nblk = -(-Nu // RB)
        rows = np.repeat(pc, nn, axis=1).ravel()
        cols = np.tile(pc, (1, nn)).ravel()
        rel = np.mod(cols - (rows // RB) * RB + Nu // 2, Nu) - Nu // 2
        W_lb = int(rel.max() - rel.min() + 1)
        est = nblk * RB * W_lb * item
        if W_lb > 4 * window_cap or est > 3 * max_bytes:
            raise StructureError(
                f"velocity-stiffness band storage lower bound "
                f"{est/1e9:.2f} GB / window {W_lb} from sampled cells "
                f"rules out the banded formats (caps "
                f"{max_bytes/1e9:.2f} GB / {window_cap}) "
                f"-- refusing before assembly")

    def __init__(self, space, dtype=None, circulant_cap=96,
                 window_cap=6144, max_bytes=None):
        self.space = space
        self.dim = space.dim
        dt = config.default_dtype() if dtype is None else dtype
        self.dtype = dt

        cu = np.asarray(space.cell_unodes)
        cp = np.asarray(space.cell_pnodes)
        Nu, Np = space.n_unodes, space.n_pnodes
        self._early_band_guard(space, cu, Nu, circulant_cap, window_cap,
                               max_bytes)

        em = scalar_element_matrices(space)
        M = assemble_csr(em["M2"], cu, cu, (Nu, Nu))
        K = assemble_csr(em["K2"], cu, cu, (Nu, Nu))
        L = assemble_csr(em["L1"], cp, cp, (Np, Np))
        Mp = assemble_csr(em["M1"], cp, cp, (Np, Np))
        Gs = [assemble_csr(em["G"][:, :, d, :], cu, cp, (Nu, Np))
              for d in range(self.dim)]

        ucoords, pcoords = node_coordinates(space)
        permU = lex_permutation(ucoords)
        # probe circulant structure on the stiffness pattern
        if not self._is_circulant(K, permU, circulant_cap):
            permU = rcm_permutation(K)
        self.permU, self.invU = permU, _inverse(permU)
        permP = lex_permutation(pcoords)
        if not self._is_circulant(L, permP, circulant_cap):
            # induce the pressure ordering from the velocity ordering
            # (P1 nodes are colocated with P2 vertex nodes): independent
            # orderings make the rectangular G/D windows span the whole
            # matrix
            nn1 = cp.shape[1]
            p2u = np.full(Np, -1, dtype=np.int64)
            p2u[cp.ravel()] = cu[:, :nn1].ravel()
            assert (p2u >= 0).all()
            permP = np.argsort(self.invU[p2u], kind="stable")
        self.permP, self.invP = permP, _inverse(permP)

        def pu(A):
            return A.tocsr()[permU][:, permU]

        def pp(A):
            return A.tocsr()[permP][:, permP]

        kw = dict(dtype=dt, circulant_cap=circulant_cap,
                  window_cap=window_cap, max_bytes=max_bytes)
        self.M = build_operator(pu(M), name="mass", **kw)
        self.K = build_operator(pu(K), name="stiffness", **kw)
        self.L = build_operator(pp(L), name="pressure-stiffness", **kw)
        self.Mp = build_operator(pp(Mp), name="pressure-mass", **kw)
        self.structured = all(
            isinstance(op, CirculantBand) for op in (self.M, self.K, self.L))
        # rectangular couplings: exact class-constant stencil on
        # translation-class torus grids (O(1) storage, kills the rim
        # bands and the 256^2 COO wall); else banded while cheap,
        # sorted-COO gather beyond NS_FASTOP_RIM_BYTES
        grids = self._torus_grids(ucoords, pcoords) \
            if (self.structured and self.dim == 2
                and _os_env.get("NS_FASTOP_STENCIL_GD", "1") == "1") \
            else None
        self.G, self.D = [], []
        for d, Gd in enumerate(Gs):
            Gp = Gd.tocsr()[permU][:, permP]
            Dp = Gd.tocsr().T.tocsr()[permP][:, permU]
            g = detect_stencil_coupling(Gp, "G", grids[0], grids[1], dt) \
                if grids else None
            dd = detect_stencil_coupling(Dp, "D", grids[0], grids[1], dt) \
                if grids else None
            self.G.append(g if g is not None else build_rim_operator(
                Gp, name=f"gradient[{d}]", **kw))
            self.D.append(dd if dd is not None else build_rim_operator(
                Dp, name=f"divergence[{d}]", **kw))

        self._setup_convection(em)
        self.ops = PlanarOps(
            M=self.M, K=self.K, L=self.L, G=tuple(self.G), D=tuple(self.D),
            diag_m=self.M.diagonal(), diag_k=self.K.diagonal(),
            diag_l=self.L.diagonal(),
            conv_cu=self._conv_cu, conv_W=self._conv_W,
            conv_N2=self._conv_N2, conv_g2=self._conv_g2,
            conv_table=self._conv_table,
            Mp=self.Mp, diag_mp=self.Mp.diagonal(),
            conv_Wc=self._conv_Wc, conv_g2c=self._conv_g2c)

    @staticmethod
    def _torus_grids(ucoords, pcoords):
        """((Ny, Nx), (nyc, nxc)) when both node sets fill uniform
        row-major grids with the fine one exactly double; else None."""
        def dims(coords):
            key = np.round(coords / 1e-9).astype(np.int64)
            xs, ys = np.unique(key[:, 0]), np.unique(key[:, 1])
            if len(xs) * len(ys) != len(coords):
                return None
            for v in (xs, ys):
                if len(v) > 1 and np.ptp(np.diff(v)) > 1:
                    return None
            return len(ys), len(xs)
        fine, coarse = dims(ucoords), dims(pcoords)
        if fine is None or coarse is None:
            return None
        if fine[0] != 2 * coarse[0] or fine[1] != 2 * coarse[1]:
            return None
        return fine, coarse

    @staticmethod
    def _is_circulant(A, perm, cap):
        A = A.tocoo()
        inv = _inverse(perm)
        off = np.mod(inv[A.col] - inv[A.row], A.shape[0])
        return len(np.unique(off)) <= cap

    # -- layout helpers ------------------------------------------------------
    def interleaved_to_planar(self, u_flat):
        """(n_unodes*dim,) node-major interleaved -> permuted (dim, Nu)."""
        u2 = jnp.asarray(u_flat).reshape(-1, self.dim).T
        return u2[:, self.permU]

    def planar_to_interleaved(self, u_planar):
        """permuted (dim, Nu) -> (n_unodes*dim,) node-major interleaved."""
        return u_planar[:, self.invU].T.reshape(-1)

    # -- permutation helpers (host or device arrays) ------------------------
    def permute_velocity(self, u_planar):
        return u_planar[..., self.permU]

    def unpermute_velocity(self, u_planar):
        return u_planar[..., self.invU]

    def permute_pressure(self, p):
        return p[..., self.permP]

    def unpermute_pressure(self, p):
        return p[..., self.invP]

    # -- operator factories (planar: velocity (dim, Nu), pressure (Np,)) ----
    def make_velocity_mass(self):
        f = jax.jit(lambda M, u: M.apply(u))
        return lambda u: f(self.M, u)

    def make_velocity_helmholtz(self, visc):
        def helm(M, K, u, accel0):
            return accel0 * M.apply(u) + visc * K.apply(u)

        f = jax.jit(helm)
        return lambda u, accel0: f(self.M, self.K, u, accel0)

    def make_gradient(self):
        def grad(G, p):
            return jnp.stack([Gd.apply(p) for Gd in G], axis=0)

        f = jax.jit(grad)
        return lambda p: f(tuple(self.G), p)

    def make_divergence(self):
        def div(D, u):
            acc = D[0].apply(u[0])
            for d in range(1, len(D)):
                acc = acc + D[d].apply(u[d])
            return acc

        f = jax.jit(div)
        return lambda u: f(tuple(self.D), u)

    def make_pressure_stiffness(self):
        f = jax.jit(lambda L, p: L.apply(p))
        return lambda p: f(self.L, p)

    def diagonals(self):
        """(diag_M (Nu,), diag_K (Nu,), diag_L (Np,)) -- scalar per node."""
        return self.M.diagonal(), self.K.diagonal(), self.L.diagonal()

    # -- nonlinear convection (per-cell quadrature; gather path for now) ----
    def _setup_convection(self, em):
        space = self.space
        dt = self.dtype
        cu_p = self.invU[np.asarray(space.cell_unodes)]
        self._conv_cu = jnp.asarray(cu_p.astype(np.int32))
        np_dt = np.dtype(dt)
        self._conv_W = jnp.asarray(
            np.asarray(space.integration_weights(), dtype=np_dt))
        self._conv_N2 = jnp.asarray(np.asarray(space.N2, dtype=np_dt))
        g2 = np.einsum("qia,cqae->cqie", np.asarray(space.G2, np.float64),
                       np.asarray(space.Jinv_q, np.float64))
        self._conv_g2 = jnp.asarray(g2.astype(np_dt))
        from navierstokes_tpu.parallel.sharded import build_scatter_transpose

        tab, _ = build_scatter_transpose(cu_p.astype(np.int32),
                                         space.n_unodes)
        self._conv_table = jnp.asarray(tab)

        self.conv_strided = None
        self._conv_Wc = self._conv_g2c = None
        import os

        if self.structured and space.dim == 2 \
                and os.environ.get("NS_FASTOP_STRIDED_CONV", "1") == "1":
            self._detect_strided_convection(cu_p)

    def _detect_strided_convection(self, cu_p):
        """Classify cells into translation classes on the lex torus grid.

        Succeeds exactly when (a) the permuted P2 nodes fill a uniform
        (Ny, Nx) grid, (b) every cell's nodes sit at class-constant 2D
        offsets from an even-parity anchor, (c) each class's anchors
        tile the stride-2 lattice exactly once, and (d) quadrature
        weights/physical gradients are class-constant (uniform affine
        cells).  Any failure leaves the gather path in place.
        """
        space = self.space
        ucoords, _ = node_coordinates(space)
        key = np.round(ucoords / 1e-9).astype(np.int64)
        xs, ys = np.unique(key[:, 0]), np.unique(key[:, 1])
        Nx, Ny = len(xs), len(ys)
        if Nx * Ny != space.n_unodes or Nx % 2 or Ny % 2:
            return
        if (len(xs) > 1 and np.ptp(np.diff(xs)) > 1) or \
                (len(ys) > 1 and np.ptp(np.diff(ys)) > 1):
            return  # non-uniform spacing
        iy, ix = cu_p // Nx, cu_p % Nx
        dy = (iy - iy[:, :1]) % Ny
        dx = (ix - ix[:, :1]) % Nx
        dy = np.where(dy > Ny // 2, dy - Ny, dy)
        dx = np.where(dx > Nx // 2, dx - Nx, dx)
        if abs(dy).max() > 2 or abs(dx).max() > 2:
            return
        sig = np.concatenate(
            [dy, dx, iy[:, :1] % 2, ix[:, :1] % 2], axis=1)
        classes, cls_inv = np.unique(sig, axis=0, return_inverse=True)
        if len(classes) > 8:
            return
        m = (Ny // 2) * (Nx // 2)
        W = np.asarray(self._conv_W, np.float64)
        g2 = np.asarray(self._conv_g2, np.float64)
        offs, Wc, g2c = [], [], []
        for c in range(len(classes)):
            cells = np.where(cls_inv == c)[0]
            if len(cells) != m:
                return
            if np.ptp(W[cells], axis=0).max() > 1e-12 * abs(W).max() or \
                    np.ptp(g2[cells], axis=0).max() > 1e-9 * abs(g2).max():
                return
            py, px = int(classes[c][-2]), int(classes[c][-1])
            ay, ax = iy[cells, 0] - py, ix[cells, 0] - px
            ids = (ay // 2) * (Nx // 2) + ax // 2
            order = np.argsort(ids)
            if not np.array_equal(ids[order], np.arange(m)):
                return  # anchors do not tile the stride-2 lattice
            nn = cu_p.shape[1]
            offs.append(tuple(
                (int(dy[cells[0], i] + py), int(dx[cells[0], i] + px))
                for i in range(nn)))
            Wc.append(W[cells[0]])
            g2c.append(g2[cells[0]])
        self.conv_strided = StridedConv(grid=(Ny, Nx), offs=tuple(offs))
        np_dt = np.dtype(self.dtype)
        self._conv_Wc = jnp.asarray(np.asarray(Wc, np_dt))
        self._conv_g2c = jnp.asarray(np.asarray(g2c, np_dt))

    def make_convection_rhs(self, cc):
        """u (dim, Nu) -> b (dim, Nu), b = int(cc (u.grad)u . N) assembled."""
        f = jax.jit(conv_apply, static_argnames=("cc", "strided"))
        return lambda u: f(self.ops, u, cc=float(cc),
                           strided=self.conv_strided)
