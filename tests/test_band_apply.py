"""The plain CirculantBand apply and the Jacobi-CG solve on the CPU.

``CirculantBand.apply`` in its ``stack`` and ``roll`` forms, and the
``lax.scan`` form taken above ``_UNROLL_BUDGET``, against a SciPy CSR
float64 matvec of the same matrix; ``_pcg`` against a direct solve.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import jax.numpy as jnp

from navierstokes_tpu.assembly.fastop import CirculantBand, build_operator
from navierstokes_tpu.solvers.planar_step import _pcg


def _circulant(n, offsets, band):
    """CSR with A[i, (i + o_k) mod n] = band[k, i]."""
    rows = np.tile(np.arange(n), len(offsets))
    cols = np.concatenate([(np.arange(n) + o) % n for o in offsets])
    return sp.csr_matrix((band.ravel(), (rows, cols)), shape=(n, n))


def _torus_offsets(n, width):
    """Offsets of a 9-point stencil on an (n / width, width) torus."""
    return sorted({(r * width + c) % n for r in (-1, 0, 1)
                   for c in (-1, 0, 1)})


@pytest.mark.parametrize("form", ["stack", "roll", "scan"])
@pytest.mark.parametrize("n,width,batch", [(64, 8, None), (240, 16, 2),
                                           (1000, 40, 3)])
def test_circulant_apply_matches_csr(form, n, width, batch):
    rng = np.random.default_rng(n + (batch or 0))
    offsets = _torus_offsets(n, width)
    band = rng.standard_normal((len(offsets), n))
    op = CirculantBand(offsets, band, jnp.float64)
    if form == "scan":
        op._UNROLL_BUDGET = 0
    else:
        op.mode = form
    shape = (n,) if batch is None else (batch, n)
    x = rng.standard_normal(shape)
    y = np.asarray(op.apply(jnp.asarray(x)))
    ref = (_circulant(n, offsets, band) @ np.atleast_2d(x).T).T
    np.testing.assert_allclose(np.atleast_2d(y), ref, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("jacobi", [True, False])
def test_pcg_solves_spd_circulant(jacobi):
    """_pcg converges to the direct solution of an SPD circulant."""
    n, width = 256, 16
    offsets = _torus_offsets(n, width)
    rng = np.random.default_rng(5)
    # symmetric, strictly diagonally dominant: -1 off the diagonal and a
    # diagonal that varies along the rows (so Jacobi is not a scalar)
    diag = 9.0 + rng.uniform(0.0, 4.0, n)
    A = sp.lil_matrix(_circulant(n, offsets, -np.ones((len(offsets), n))))
    A.setdiag(diag)
    A = sp.csr_matrix(A)
    A = 0.5 * (A + A.T)
    op = build_operator(A, jnp.float64)
    assert isinstance(op, CirculantBand)
    b = rng.standard_normal(n)
    x, res = _pcg(op.apply, jnp.asarray(b), jnp.zeros(n), 200,
                  inv_diag=jnp.asarray(1.0 / A.diagonal()) if jacobi
                  else None)
    ref = spla.spsolve(A.tocsc(), b)
    np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-10, atol=1e-10)
    assert float(res) < 1e-9 * np.linalg.norm(b)
