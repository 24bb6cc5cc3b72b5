"""Direct linear solves.

``dense_solve`` runs an on-device dense LU (exact, used for validation-sized
saddle-point systems -- the role PETSc LU plays in the reference,
ns_solver_base.py:938).  ``host_sparse_lu`` is a CPU fallback backed by
SuperLU through scipy for medium validation meshes where a dense factor
would not fit; the accelerator path uses the Krylov solvers instead.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def dense_solve(A, b):
    """Solve dense A x = b on device (LU with partial pivoting)."""
    if hasattr(A, "todense"):
        A = A.todense()
    return jnp.linalg.solve(A, b)


class HostSparseLU:
    """SuperLU factorization of a CSRMatrix (host/CPU validation path).

    The reference's linear solves all go through native sparse LU
    (PETSc/MUMPS/SuperLU); this wraps the same SuperLU capability for
    correctness runs on the CPU backend.  Factorizations are re-done each
    call site's discretion (cache the object to reuse the factor).
    """

    def __init__(self, csr):
        from scipy.sparse import csr_matrix

        pattern = csr.pattern
        values = np.asarray(csr.values)
        self._n = pattern.n
        mat = csr_matrix((values, (pattern.rows, pattern.cols)),
                         shape=(pattern.n, pattern.n))
        from scipy.sparse.linalg import splu

        self._lu = splu(mat.tocsc())

    def solve(self, b):
        return jnp.asarray(self._lu.solve(np.asarray(b)))
