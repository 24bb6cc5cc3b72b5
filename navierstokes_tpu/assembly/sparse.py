"""Static-sparsity CSR matrices assembled by segment-sum scatter.

The sparsity pattern is host-side precomputation (NumPy, once per space);
per-iteration numeric assembly is a single ``segment_sum`` of element-matrix
entries into the nnz array -- fixed shapes, fully jittable.  This replaces
dolfin/PETSc SystemAssembler + Mat (reference: source/auxiliary_classes.py:
141, ns_solver_base.py:938-949).

SpMV runs as a gather + segment-sum over rows, which XLA lowers to
bandwidth-bound fused kernels; rows are CSR-sorted so the segment
ids are contiguous.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True, eq=False)  # identity eq/hash: used as pytree aux data
class SparsityPattern:
    """CSR pattern + element-entry -> nnz-slot scatter map."""

    n: int                    # matrix dimension
    rows: np.ndarray          # (nnz,) int32 row of each stored entry
    cols: np.ndarray          # (nnz,) int32
    slots: np.ndarray         # (n_cells, nloc, nloc) int32 into nnz
    diag_slots: np.ndarray    # (n,) int32 slot of each diagonal entry

    @property
    def nnz(self) -> int:
        return len(self.rows)


def build_pattern(cell_dofs: np.ndarray, n: int) -> SparsityPattern:
    """Unique CSR pattern of sum_c scatter(cell_dofs[c] x cell_dofs[c])."""
    cell_dofs = np.asarray(cell_dofs, dtype=np.int64)
    nc, nloc = cell_dofs.shape
    rows = np.repeat(cell_dofs, nloc, axis=1).reshape(-1)
    cols = np.tile(cell_dofs, (1, nloc)).reshape(-1)
    keys = rows * n + cols
    # ensure the diagonal exists (needed for BC identity rows)
    diag_keys = np.arange(n, dtype=np.int64) * n + np.arange(n)
    all_keys = np.concatenate([keys, diag_keys])
    unique_keys, inverse = np.unique(all_keys, return_inverse=True)
    slots = inverse[:len(keys)].reshape(nc, nloc, nloc).astype(np.int32)
    diag_slots = inverse[len(keys):].astype(np.int32)
    return SparsityPattern(
        n=n,
        rows=(unique_keys // n).astype(np.int32),
        cols=(unique_keys % n).astype(np.int32),
        slots=slots,
        diag_slots=diag_slots,
    )


@jax.tree_util.register_pytree_node_class
class CSRMatrix:
    """CSR values bound to a static pattern (a pytree: jit-friendly)."""

    def __init__(self, pattern: SparsityPattern, values, rows_dev=None,
                 cols_dev=None):
        self.pattern = pattern
        self.values = values
        self.rows = (rows_dev if rows_dev is not None
                     else jnp.asarray(pattern.rows))
        self.cols = (cols_dev if cols_dev is not None
                     else jnp.asarray(pattern.cols))

    def tree_flatten(self):
        return (self.values, self.rows, self.cols), self.pattern

    @classmethod
    def tree_unflatten(cls, pattern, leaves):
        values, rows, cols = leaves
        return cls(pattern, values, rows, cols)

    def matvec(self, x):
        contrib = self.values * x[self.cols]
        return jax.ops.segment_sum(contrib, self.rows,
                                   num_segments=self.pattern.n,
                                   indices_are_sorted=True)

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self):
        return self.values[jnp.asarray(self.pattern.diag_slots)]

    def todense(self):
        dense = jnp.zeros((self.pattern.n, self.pattern.n),
                          dtype=self.values.dtype)
        return dense.at[self.rows, self.cols].add(self.values)


def assemble_csr(pattern: SparsityPattern, element_matrices) -> jnp.ndarray:
    """Sum element matrices (nc, nloc, nloc) into the nnz value array."""
    slots = jnp.asarray(pattern.slots.reshape(-1))
    vals = element_matrices.reshape(-1)
    return jax.ops.segment_sum(vals, slots, num_segments=pattern.nnz)


def apply_bc_rows(pattern: SparsityPattern, values, bc_row_mask_nnz,
                  bc_diag_slots):
    """Replace Dirichlet rows by identity rows.

    ``bc_row_mask_nnz``: precomputed (nnz,) bool, True where the entry's row
    is constrained.  ``bc_diag_slots``: (n_bc,) slots of the constrained
    diagonal entries.
    """
    values = jnp.where(bc_row_mask_nnz, 0.0, values)
    return values.at[bc_diag_slots].set(1.0)


def bc_row_masks(pattern: SparsityPattern, bc_dofs: np.ndarray):
    """Host precomputation for :func:`apply_bc_rows`."""
    is_bc = np.zeros(pattern.n, dtype=bool)
    is_bc[bc_dofs] = True
    return is_bc[pattern.rows], pattern.diag_slots[bc_dofs]
