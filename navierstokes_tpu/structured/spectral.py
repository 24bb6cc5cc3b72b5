"""Exact DFT block-diagonal solves + fused projection step (periodic).

A stencil over the class grids is block-circulant on the cell lattice, so
the n-D DFT block-diagonalizes it exactly: for each Fourier mode k the P2
operators become dense 2^dim x 2^dim complex blocks (one row/column per
node class -- 4x4 in 2D, 8x8 in 3D), the P1 Laplacian a scalar symbol.
The three linear solves of the incremental projection scheme (Helmholtz,
pressure Poisson, mass correction -- solvers/fused_step.py) are then
*direct* solves with machine-precision accuracy -- a strictly stronger
guarantee than the fixed CG sweeps of the generic path.

Design: the device code uses **no complex dtype at all** (it was written
for an accelerator that lacked complex support; the H100 has not yet been
measured against a complex ``jnp.fft`` form).  Spectral fields are split
re/im real pairs; the DFT is two cos/sin *matrix multiplications* per
axis, not butterfly gathers; and the traced-coefficient Helmholtz solve
(a0/k M + nu K) x = b is reduced at setup (host, complex128) to a
generalized eigenbasis per mode:

    (a M + nu K)^{-1} = P diag(1 / (a + nu lam)) P^H,
    P = L^{-H} Q,  M = L L^H,  L^{-1} K L^{-H} = Q diag(lam) Q^H

so the per-step device work is fixed precomputed block matmuls plus one
elementwise divide by the traced scalar ``a`` -- variable time steps never
recompile and never re-factorize.

Reference semantics: one incremental-pressure-correction step with
extrapolated convection (scripts/test_ipcs.py:102-171); equivalence with
the unstructured fused step is asserted in tests/test_structured.py
(2D and 3D).
"""

from __future__ import annotations

import os
from typing import NamedTuple

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


def _mm_axis(M, X, axis):
    """Apply matrix M (k, g) along ``axis`` of X: out[..., k, ...]."""
    Y = jnp.tensordot(M, X, axes=((1,), (axis,)), precision=_PREC)
    return jnp.moveaxis(Y, 0, axis)


from navierstokes_tpu.structured.grid import (NotStructured,
                                              PeriodicStructuredTH)
from navierstokes_tpu.structured.ops import StructuredConvection


def _symbol(taps, shape, blk, n_uclass):
    """Fourier symbol of a tap set: S[k] = sum_s w(s) e^{+2 pi i k.s / N}.

    ``blk``: trailing block shape, e.g. (2^dim, 2^dim) for P2->P2 taps
    with scalar weights, (2^dim, d) for the gradient/divergence couplings
    (the class axis is whichever side is P2 -- output for the gradient,
    input for the divergence), () for the P1 Laplacian.
    """
    dim = len(shape)
    T = np.zeros(tuple(shape) + blk, dtype=np.complex128)
    for (co, ci), entries in taps.items():
        for s, w in entries:
            g = tuple(s[a] % shape[a] for a in range(dim))
            if blk == (n_uclass, n_uclass):
                T[g + (co, ci)] += w
            elif blk == ():
                T[g] += w
            else:                       # (2^dim, d) coupling: the P2 class
                T[g + (max(co, ci),)] += np.asarray(w)
    return np.conj(np.fft.fftn(T, axes=tuple(range(dim))))


class SplitC(NamedTuple):
    """A complex tensor as a (re, im) pair of real device arrays."""

    re: jnp.ndarray
    im: jnp.ndarray


def _split(z, dtype):
    return (jnp.asarray(np.real(z), dtype), jnp.asarray(np.imag(z), dtype))


class MatmulDFT:
    """n-D DFT over the grid axes as cos/sin matmuls.

    Operates on tensors with layout (a, *grid, d): grid axes are
    1..dim inclusive.
    """

    def __init__(self, shape, dtype):
        def mats(n):
            k = np.arange(n)
            ang = 2.0 * np.pi * np.outer(k, k) / n
            return (jnp.asarray(np.cos(ang), dtype),
                    jnp.asarray(np.sin(ang), dtype))

        self.shape = tuple(shape)
        self.mats = [mats(n) for n in self.shape]

    def fwd(self, X):
        """Real (a, *grid, d) -> SplitC, numpy fft convention
        (e^{-2 pi i k g / N}): per axis multiply by C - iS."""
        re, im = X, None
        for i, (C, S) in enumerate(self.mats):
            ax = 1 + i
            if im is None:
                re, im = _mm_axis(C, re, ax), -_mm_axis(S, re, ax)
            else:
                re, im = (_mm_axis(C, re, ax) + _mm_axis(S, im, ax),
                          _mm_axis(C, im, ax) - _mm_axis(S, re, ax))
        return SplitC(re, im)

    def inv_real(self, Z: SplitC):
        """Real part of the inverse n-D DFT of an (a, *grid, d) SplitC.

        Applies (C + iS)/N per axis; the imaginary part of the LAST axis
        apply is never used, so XLA dead-code-eliminates it."""
        s = 1.0 / float(np.prod(self.shape))
        re, im = Z.re, Z.im
        for i, (C, S) in enumerate(self.mats):
            ax = 1 + i
            re, im = (_mm_axis(C, re, ax) - _mm_axis(S, im, ax),
                      _mm_axis(C, im, ax) + _mm_axis(S, re, ax))
        return s * re


def _cmatmul(S, V: SplitC, sub):
    """Split-complex per-mode block apply: S (split symbol) times V.

    The contraction is a huge batch (one per Fourier mode) of tiny
    matmuls -- (2^dim x 2^dim) @ (2^dim x d).  Two lowerings: a batched
    einsum, or an explicit broadcast-multiply-reduce ("vpu"), which is
    bandwidth-bound (the reduced axis is length 2^dim, so the
    intermediate fuses away).
    """
    assert sub == "...ab,...bd->...ad"
    Sr, Si = S
    # 2D (4x4 blocks) takes the broadcast-reduce, 3D (8x8 blocks) the
    # batched einsum.  The choice was made on the first accelerator, where
    # the einsum padded each tiny block to a matrix-unit tile and the rank-6
    # broadcast made 3D compiles far slower; it has not been measured on
    # the H100.  NS_BLOCK_APPLY overrides.
    mode = os.environ.get(
        "NS_BLOCK_APPLY", "vpu" if Sr.ndim == 4 else "einsum")
    if mode == "einsum":
        re = _einsum(sub, Sr, V.re) - _einsum(sub, Si, V.im)
        im = _einsum(sub, Sr, V.im) + _einsum(sub, Si, V.re)
        return SplitC(re, im)
    mm = lambda A, X: jnp.sum(A[..., :, :, None] * X[..., None, :, :],
                              axis=-2)
    re = mm(Sr, V.re) - mm(Si, V.im)
    im = mm(Sr, V.im) + mm(Si, V.re)
    return SplitC(re, im)


class SpectralOperators:
    """Precomputed Fourier symbols + eigenbases, all-real device arrays.

    Spectral velocity layout: SplitC of (*grid, 2^dim, d); pressure
    SplitC of (*grid).
    """

    def __init__(self, sgrid: PeriodicStructuredTH, dtype):
        shape, d = sgrid.shape, sgrid.space.dim
        nc = sgrid.n_uclass
        self.sgrid = sgrid
        self.shape, self.d = shape, d
        self.dim = len(shape)
        self.n_uclass = nc
        self.rdtype = jnp.dtype(dtype)
        self.dft = MatmulDFT(shape, self.rdtype)

        blk = (nc, nc)
        Mh = _symbol(sgrid.taps_uu(sgrid.M_tau), shape, blk, nc)
        Kh = _symbol(sgrid.taps_uu(sgrid.K_tau), shape, blk, nc)
        # enforce Hermitian symmetry (symmetric real-space operators)
        Mh = 0.5 * (Mh + np.conj(np.swapaxes(Mh, -1, -2)))
        Kh = 0.5 * (Kh + np.conj(np.swapaxes(Kh, -1, -2)))
        self.Mhat = _split(Mh, self.rdtype)
        self.Khat = _split(Kh, self.rdtype)
        self.Ghat = _split(
            _symbol(sgrid.taps_up(sgrid.G_tau), shape, (nc, d), nc),
            self.rdtype)
        self.Dhat = _split(
            _symbol(sgrid.taps_pu(sgrid.G_tau), shape, (nc, d), nc),
            self.rdtype)

        # P1 Laplacian: symmetric stencil -> real symbol; pseudo-inverse
        # (the k=0 constant mode is the mean-pressure null space)
        Lh = _symbol(sgrid.taps_pp(sgrid.L_tau), shape, (), nc)
        assert np.abs(Lh.imag).max() < 1e-9 * np.abs(Lh.real).max()
        Lr = Lh.real.copy()
        zero = (0,) * self.dim
        Lr[zero] = 1.0
        Linv = 1.0 / Lr
        Linv[zero] = 0.0
        self.Linv = jnp.asarray(Linv, self.rdtype)

        # generalized eigenbasis of (M, K) per mode (host, complex128):
        # M = L L^H; B = L^-1 K L^-H = Q lam Q^H; P = L^-H Q
        Lc = np.linalg.cholesky(Mh)
        Lc_inv = np.linalg.inv(Lc)
        B = Lc_inv @ Kh @ np.conj(np.swapaxes(Lc_inv, -1, -2))
        B = 0.5 * (B + np.conj(np.swapaxes(B, -1, -2)))
        lam, Q = np.linalg.eigh(B)
        P = np.conj(np.swapaxes(Lc_inv, -1, -2)) @ Q
        self.P = _split(P, self.rdtype)             # (*grid, 2^dim, 2^dim)
        self.PH = _split(np.conj(np.swapaxes(P, -1, -2)), self.rdtype)
        self.lam = jnp.asarray(np.maximum(lam, 0.0), self.rdtype)

    # -- transforms ----------------------------------------------------------
    def fwd_u(self, U):
        """Physical (2^dim, *grid, d) -> spectral SplitC (*grid, 2^dim, d)."""
        Z = self.dft.fwd(U)
        perm = tuple(range(1, 1 + self.dim)) + (0, 1 + self.dim)
        t = lambda a: jnp.transpose(a, perm)
        return SplitC(t(Z.re), t(Z.im))

    def inv_u(self, Uh: SplitC):
        perm = (self.dim,) + tuple(range(self.dim)) + (self.dim + 1,)
        t = lambda a: jnp.transpose(a, perm)
        return self.dft.inv_real(SplitC(t(Uh.re), t(Uh.im)))

    def fwd_p(self, P):
        Z = self.dft.fwd(P[None, ..., None])
        return SplitC(Z.re[0, ..., 0], Z.im[0, ..., 0])

    def inv_p(self, Ph: SplitC):
        Z = SplitC(Ph.re[None, ..., None], Ph.im[None, ..., None])
        return self.dft.inv_real(Z)[0, ..., 0]

    # -- spectral operator applications --------------------------------------
    def mass(self, Uh: SplitC):
        return _cmatmul(self.Mhat, Uh, "...ab,...bd->...ad")

    def stiffness(self, Uh: SplitC):
        return _cmatmul(self.Khat, Uh, "...ab,...bd->...ad")

    def grad(self, Ph: SplitC):
        Gr, Gi = self.Ghat
        re = _einsum("...ad,...->...ad", Gr, Ph.re) \
            - _einsum("...ad,...->...ad", Gi, Ph.im)
        im = _einsum("...ad,...->...ad", Gr, Ph.im) \
            + _einsum("...ad,...->...ad", Gi, Ph.re)
        return SplitC(re, im)

    def div(self, Uh: SplitC):
        Dr, Di = self.Dhat
        re = _einsum("...ad,...ad->...", Dr, Uh.re) \
            - _einsum("...ad,...ad->...", Di, Uh.im)
        im = _einsum("...ad,...ad->...", Dr, Uh.im) \
            + _einsum("...ad,...ad->...", Di, Uh.re)
        return SplitC(re, im)

    def helmholtz_solve(self, accel0, visc, Bh: SplitC):
        """(accel0 M + visc K) Uh = Bh via the precomputed eigenbasis:
        Uh = P diag(1/(accel0 + visc lam)) P^H Bh.  ``accel0`` traced."""
        t = _cmatmul(self.PH, Bh, "...ab,...bd->...ad")
        scale = 1.0 / (accel0 + visc * self.lam)    # (*grid, 2^dim)
        t = SplitC(t.re * scale[..., None], t.im * scale[..., None])
        return _cmatmul(self.P, t, "...ab,...bd->...ad")

    def mass_solve(self, Bh: SplitC):
        """M^{-1} = P P^H (the visc=0, accel0=1 eigen-solve)."""
        t = _cmatmul(self.PH, Bh, "...ab,...bd->...ad")
        return _cmatmul(self.P, t, "...ab,...bd->...ad")

    def poisson_solve(self, Rh: SplitC):
        return SplitC(self.Linv * Rh.re, self.Linv * Rh.im)


def build_spectral_projection_step(sgrid: PeriodicStructuredTH, *, visc,
                                   dt, dtype=None):
    """Fused projection step on class grids with exact spectral solves.

    Returns ``(step, init_state, read_state)``:

      * ``state = step(state, alpha, eta)`` advances one SBDF step
        (``alpha=(a0,a1,a2)`` BDF weights, ``eta=(e0,e1)`` convection
        extrapolation -- traced, so variable steps never recompile);
      * ``init_state(u_flat, u_old_flat, p_flat) -> state``;
      * ``read_state(state) -> (u_flat, p_flat)`` on the host layout.
    """
    import copy

    from navierstokes_tpu import config

    rdtype = dtype or config.default_dtype()
    ops = SpectralOperators(sgrid, jnp.dtype(rdtype))
    conv = StructuredConvection(sgrid, rdtype)
    zero_mode = (0,) * len(sgrid.shape)

    def axpy(a, X: SplitC, Y):
        if Y is None:
            return SplitC(a * X.re, a * X.im)
        return SplitC(Y.re + a * X.re, Y.im + a * X.im)

    # the per-mode symbol/eigenbasis arrays are O(grid * 2^dim * 2^dim)
    # -- hundreds of MB at 64^3.  They enter the jitted step as
    # ARGUMENTS (a pytree), NOT closures: closure arrays are inlined
    # into the HLO as constants, which bloats the program and its
    # compile time at scale.
    big_arrays = dict(Mhat=ops.Mhat, Ghat=ops.Ghat, Dhat=ops.Dhat,
                      P=ops.P, PH=ops.PH, lam=ops.lam, Linv=ops.Linv)

    def _bind(big):
        o = copy.copy(ops)
        for name, v in big.items():
            setattr(o, name, v)
        return o

    @jax.jit
    def _step(big, state, alpha, eta, k):
        ops = _bind(big)
        U, U_old, Uh, Uh_old, Ph = state
        a0, a1, a2 = alpha
        if k is None:
            k = dt

        # (1) Helmholtz: (a0/k M + nu K) u* = -(a1/k)M u - (a2/k)M u_old
        #                                     - C(extrapolated u) - G p
        U_ext = eta[0] * U + eta[1] * U_old
        Ch = ops.fwd_u(conv(U_ext))
        Bh = axpy(-(a1 / k), ops.mass(Uh), None)
        Bh = axpy(-(a2 / k), ops.mass(Uh_old), Bh)
        Bh = axpy(-1.0, Ch, Bh)
        Bh = axpy(-1.0, ops.grad(Ph), Bh)
        Ustar_h = ops.helmholtz_solve(a0 / k, visc, Bh)

        # (2) incremental pressure Poisson (exact, mean-free)
        Phi_h = ops.poisson_solve(axpy(a0 / k, ops.div(Ustar_h), None))

        # (3) velocity correction + pressure update
        Uh_new = axpy(-(k / a0), ops.mass_solve(ops.grad(Phi_h)), Ustar_h)
        Ph_new = SplitC(
            (Ph.re + Phi_h.re).at[zero_mode].set(0.0),
            (Ph.im + Phi_h.im).at[zero_mode].set(0.0))

        U_new = ops.inv_u(Uh_new)
        return (U_new, U, Uh_new, Uh, Ph_new)

    def step(state, alpha, eta, k=None):
        """``k``: optional traced step size (defaults to the built ``dt``;
        the eigenbasis Helmholtz solve makes variable steps an elementwise
        divide, never a refactorization)."""
        return _step(big_arrays, state, alpha, eta, k)

    def init_state(u_flat, u_old_flat, p_flat):
        U = jnp.asarray(sgrid.u_to_grids(np.asarray(u_flat)), rdtype)
        U_old = jnp.asarray(sgrid.u_to_grids(np.asarray(u_old_flat)),
                            rdtype)
        P = jnp.asarray(sgrid.p_to_grid(np.asarray(p_flat)), rdtype)
        Ph = ops.fwd_p(P - jnp.mean(P))
        return (U, U_old, ops.fwd_u(U), ops.fwd_u(U_old), Ph)

    def read_state(state):
        U, _, _, _, Ph = state
        u_flat = sgrid.grids_to_u(np.asarray(U))
        p_flat = sgrid.grid_to_p(np.asarray(ops.inv_p(Ph)))
        return u_flat, p_flat

    # expose the raw jitted step + its operator pytree so callers can
    # build lax.scan chunks with the big arrays passed as ARGUMENTS
    # (as above: a chunk that closes over them would inline them into
    # the HLO as constants)
    step.raw = _step
    step.big_arrays = big_arrays
    return step, init_state, read_state


# ---------------------------------------------------------------------------
# multi-chip: slab-sharded spectral step
# ---------------------------------------------------------------------------

def shard_spectral_step(step, sgrid, device_mesh, axis_name=None):
    """Slab-decompose a built spectral step over a device mesh.

    The class grids are sharded along the SECOND grid axis (a slab
    decomposition): stencil convection becomes halo ``ppermute``s and
    the DFT matmul along the sharded axis a compiler-inserted collective
    (GSPMD), with every other piece (per-mode block solves, elementwise
    symbol divisions) purely local.  The returned ``(sharded_step,
    shard_state)`` pair mirrors the unsharded step's signature;
    ``shard_state`` places an ``init_state`` result onto the mesh.

    Raises ``NotStructured`` when the grid extent does not divide the
    device count (the caller's fallback path handles it like any other
    structure failure).

    Replaces: the reference's PETSc/MPI distributed Mat-Vec layer
    (environment.yml:63-65) for the structured flagship; SURVEY §2.2.
    """
    import jax.sharding as jsh

    ndev = int(device_mesh.devices.size)
    if axis_name is None:
        axis_name = device_mesh.axis_names[0]
    dim = len(sgrid.shape)
    g1 = sgrid.shape[1]
    if g1 % ndev != 0:
        raise NotStructured(
            f"grid axis 1 ({g1}) not divisible by {ndev} devices")

    def ns(spec):
        return jsh.NamedSharding(device_mesh, jsh.PartitionSpec(*spec))

    def leaf_spec(x):
        nd = jnp.asarray(x).ndim
        if nd <= 1:
            return ns([None] * nd)
        # class-grid layouts: U/(U_old) are (a, *grid, d) -> shard grid
        # axis 1 = tensor axis 2; everything else (Uh/Ph/symbol arrays)
        # leads with the grid -> shard tensor axis 1
        if nd == dim + 2 and x.shape[0] == sgrid.n_uclass \
                and x.shape[1 + 1] == g1:
            spec = [None] * nd
            spec[2] = axis_name
            return ns(spec)
        spec = [None] * nd
        spec[1] = axis_name
        return ns(spec)

    big_sharded = jax.tree.map(
        lambda x: jax.device_put(jnp.asarray(x), leaf_spec(x)),
        step.big_arrays)
    holder = {}

    def shard_state(state):
        state_spec = jax.tree.map(leaf_spec, state)
        # pin the OUTPUT to the slab layout: without out_shardings GSPMD
        # is free to all-gather the result, silently degenerating the
        # loop-carried state to replicated stepping
        holder["jitted"] = jax.jit(step.raw, out_shardings=state_spec)
        return jax.tree.map(lambda x, s: jax.device_put(jnp.asarray(x), s),
                            state, state_spec)

    def sharded_step(state, alpha, eta, k=None):
        assert "jitted" in holder, "call shard_state(...) first"
        return holder["jitted"](big_sharded, state, alpha, eta, k)

    return sharded_step, shard_state
