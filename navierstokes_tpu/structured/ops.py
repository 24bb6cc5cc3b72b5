"""Stencil (shift-based) operator application on class grids.

Each operator is a list of taps ``(c_out, c_in, shift, weight)``; applying
it is a sum of ``jnp.roll`` shifts and fused multiply-adds over
(*grid[, d]) tensors -- pure elementwise work that XLA fuses into a
single pass, with none of the per-row gathers that bound the unstructured
element loop (cf. parallel/sharded.py docstring).  Periodic wrap is
exactly ``jnp.roll``.  All applies are dimension-agnostic: shifts carry
the grid rank (2D or 3D).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

# A float32 matmul on the GPU may run in TF32 (about three decimal digits
# per contraction) -- far too coarse for the DFT and symbol applies, whose
# results must agree with the f64 reference to f32 roundoff.
_PREC = jax.lax.Precision.HIGHEST


def _einsum(*args, **kw):
    kw.setdefault("precision", _PREC)
    return jnp.einsum(*args, **kw)


def _roll(A, s):
    """A[g] -> A[g + s] with periodic wrap (negative jnp.roll shift).

    ``s`` is a length-(grid rank) shift; the grid axes are the LEADING
    axes of ``A``."""
    s = tuple(int(v) for v in s)
    if all(v == 0 for v in s):
        return A
    return jnp.roll(A, shift=tuple(-v for v in s),
                    axis=tuple(range(len(s))))


def apply_uu(taps, U, dtype=None):
    """Scalar P2->P2 stencil applied per velocity component.

    ``U``: (2^dim, *grid, d) -> (2^dim, *grid, d).
    """
    out = [None] * len(U)
    for (co, ci), entries in taps.items():
        acc = 0.0
        for s, w in entries:
            acc = acc + float(w) * _roll(U[ci], s)
        out[co] = acc if out[co] is None else out[co] + acc
    zero = jnp.zeros_like(U[0])
    return jnp.stack([o if o is not None else zero for o in out])


def apply_up(taps, P, n_uclass=None):
    """Vector-weighted P1->P2 stencil (pressure gradient).

    taps weights are (d,); ``P``: (*grid) -> (2^dim, *grid, d).
    """
    if n_uclass is None:
        n_uclass = 2 ** P.ndim
    out = [None] * n_uclass
    for (co, _ci), entries in taps.items():
        acc = 0.0
        for s, w in entries:
            acc = acc + jnp.asarray(np.asarray(w), P.dtype) \
                * _roll(P, s)[..., None]
        out[co] = acc if out[co] is None else out[co] + acc
    d = len(next(iter(taps.values()))[0][1])
    zero = jnp.zeros(P.shape + (d,), P.dtype)
    return jnp.stack([o if o is not None else zero for o in out])


def apply_pu(taps, U):
    """Vector-contracting P2->P1 stencil (divergence): (2^dim, *grid, d)
    -> (*grid)."""
    acc = 0.0
    for (_co, ci), entries in taps.items():
        for s, w in entries:
            acc = acc + _einsum(
                "...d,d->...", _roll(U[ci], s),
                jnp.asarray(np.asarray(w), U.dtype))
    return acc


def apply_pp(taps, P):
    """Scalar P1->P1 stencil: (*grid) -> (*grid)."""
    acc = 0.0
    for s, w in taps[(0, 0)]:
        acc = acc + float(w) * _roll(P, s)
    return acc


# ---------------------------------------------------------------------------
# nonlinear convection on class grids
# ---------------------------------------------------------------------------

class StructuredConvection:
    """b_i = int((u . grad)u . N_i) assembled entirely with shifts.

    The element quadrature is identical to the unstructured path
    (parallel/sharded.py make_convection_rhs, itself the scheme of the
    reference prototype scripts/test_ipcs.py:102-133); the cell gather and
    the transpose-table scatter are replaced by rolls in and out of the
    class grids (12 in 2D, 60 in 3D).
    """

    def __init__(self, sgrid, dtype):
        space = sgrid.space
        self.sgrid = sgrid
        self.N2 = jnp.asarray(space.N2, dtype)            # (nq, nlu)
        g2 = np.einsum("qia,tae->tqie", space.G2, sgrid.Jinv_tau)
        self.g2 = jnp.asarray(g2, dtype)                  # (ntau, nq, nlu, d)
        self.W = jnp.asarray(sgrid.W_tau, dtype)          # (ntau, nq)

    def gather_local(self, U):
        """(2^dim, *grid, d) -> (ntau, nlu, *grid, d) local values."""
        sg = self.sgrid
        rows = []
        for t in range(sg.n_tau):
            loc = [
                _roll(U[sg.u_class[t, l]], sg.u_shift[t, l])
                for l in range(sg.n_local_u)
            ]
            rows.append(jnp.stack(loc))
        return jnp.stack(rows)

    def scatter_local(self, R):
        """(ntau, nlu, *grid, d) local contributions -> (2^dim, *grid, d)."""
        sg = self.sgrid
        out = [0.0] * sg.n_uclass
        for t in range(sg.n_tau):
            for l in range(sg.n_local_u):
                c = int(sg.u_class[t, l])
                s = -sg.u_shift[t, l]
                out[c] = out[c] + _roll(R[t, l], s)
        return jnp.stack(out)

    def __call__(self, U):
        u_loc = self.gather_local(U)                      # (t,i,*g,d)
        u_q = _einsum("qi,ti...d->tq...d", self.N2, u_loc)
        grad_u = _einsum("ti...d,tqie->tq...de", u_loc, self.g2)
        conv = _einsum("tq...de,tq...e->tq...d", grad_u, u_q)
        r = _einsum("tq,tq...d,qi->ti...d", self.W, conv, self.N2)
        return self.scatter_local(r)
