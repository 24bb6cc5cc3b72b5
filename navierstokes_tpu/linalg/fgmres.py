"""Flexible GMRES (right-preconditioned, restarted).

Host-orchestrated Arnoldi over device vectors: the preconditioner may
itself be an (inexact, varying) iterative solve -- the standard setting
for block preconditioners like PCD, where each application runs inner CG
sweeps.  This replaces the PETSc-LU linear solves of the reference's
stationary/monolithic Newton iterations (ns_solver_base.py:938) for
problem sizes where a dense factorization is impossible.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax


def fgmres(matvec, b, M_apply=None, x0=None, tol=1e-10, atol=1e-12,
           restart=60, maxiter=300):
    """Solve A x = b with flexible right preconditioning.

    ``M_apply(v)`` approximates A^{-1} v and may vary between calls.
    Returns (x, final_residual_norm, total_iterations).
    """
    n = len(b)
    if M_apply is None:
        M_apply = lambda v: v
    x = jnp.zeros_like(b) if x0 is None else x0

    b_norm = float(jnp.linalg.norm(b))
    target = max(tol * b_norm, atol)
    total_its = 0

    r = b - matvec(x)
    res = float(jnp.linalg.norm(r))

    while res > target and total_its < maxiter:
        m = min(restart, maxiter - total_its)
        V = [r / res]
        Z = []
        H = np.zeros((m + 1, m))
        g = np.zeros(m + 1)
        g[0] = res
        # Givens rotations
        cs = np.zeros(m)
        sn = np.zeros(m)
        k_used = 0
        for k in range(m):
            z = M_apply(V[k])
            w = matvec(z)
            Z.append(z)
            # modified Gram-Schmidt
            for i in range(k + 1):
                H[i, k] = float(jnp.vdot(V[i], w))
                w = w - H[i, k] * V[i]
            H[k + 1, k] = float(jnp.linalg.norm(w))
            if H[k + 1, k] > 1e-300:
                V.append(w / H[k + 1, k])
            else:
                V.append(w)
            # apply accumulated rotations to the new column
            for i in range(k):
                t = cs[i] * H[i, k] + sn[i] * H[i + 1, k]
                H[i + 1, k] = -sn[i] * H[i, k] + cs[i] * H[i + 1, k]
                H[i, k] = t
            denom = np.hypot(H[k, k], H[k + 1, k])
            if denom == 0.0:
                k_used = k + 1
                break
            cs[k] = H[k, k] / denom
            sn[k] = H[k + 1, k] / denom
            H[k, k] = denom
            H[k + 1, k] = 0.0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            k_used = k + 1
            total_its += 1
            if abs(g[k + 1]) <= target:
                break
        # solve the small triangular system and update
        y = np.linalg.solve(H[:k_used, :k_used], g[:k_used])
        for i in range(k_used):
            x = x + float(y[i]) * Z[i]
        r = b - matvec(x)
        res = float(jnp.linalg.norm(r))

    return x, res, total_its


def fgmres_device(matvec, M_apply, b, x0=None, *, restart=30, tol=1e-10,
                  atol=1e-12, max_cycles=20):
    """Fully jittable flexible GMRES: restarted cycles in a while_loop.

    Unlike :func:`fgmres` (host-orchestrated Arnoldi, one device sync per
    inner iteration), everything here is one XLA program: the Arnoldi
    basis is built with batched CGS2 orthogonalization (two (m+1, n)
    matmuls per iteration), the
    small least-squares solve runs on device, and convergence is checked
    once per restart cycle.  Each cycle runs its full ``restart`` inner
    iterations; choose ``restart`` around the expected iteration count.

    Returns ``(x, residual_norm, matvec_count)`` as traced values.
    """
    n = b.shape[0]
    m = restart
    b_norm = jnp.linalg.norm(b)
    target = jnp.maximum(tol * b_norm, atol)
    x0 = jnp.zeros_like(b) if x0 is None else x0

    def cycle(x):
        r = b - matvec(x)
        beta = jnp.linalg.norm(r)
        safe_beta = jnp.where(beta > 0.0, beta, 1.0)
        V = jnp.zeros((m + 1, n), b.dtype).at[0].set(r / safe_beta)
        Z = jnp.zeros((m, n), b.dtype)
        H = jnp.zeros((m + 1, m), b.dtype)

        def body(k, carry):
            V, Z, H = carry
            z = M_apply(V[k])
            w = matvec(z)
            mask = (jnp.arange(m + 1) <= k).astype(b.dtype)
            h1 = (V @ w) * mask                 # CGS pass 1
            w = w - V.T @ h1
            h2 = (V @ w) * mask                 # CGS pass 2 (reorthogonalize)
            w = w - V.T @ h2
            h = h1 + h2
            hk1 = jnp.linalg.norm(w)
            V = V.at[k + 1].set(w / jnp.where(hk1 > 0.0, hk1, 1.0))
            H = H.at[:, k].set(h).at[k + 1, k].set(hk1)
            Z = Z.at[k].set(z)
            return (V, Z, H)

        V, Z, H = lax.fori_loop(0, m, body, (V, Z, H))
        e1 = jnp.zeros(m + 1, b.dtype).at[0].set(beta)
        y, *_ = jnp.linalg.lstsq(H, e1)
        return x + Z.T @ y

    def cond(carry):
        _, it, res = carry
        return (res > target) & (it < max_cycles)

    def body(carry):
        x, it, _ = carry
        x = cycle(x)
        res = jnp.linalg.norm(b - matvec(x))
        return (x, it + 1, res)

    res0 = jnp.linalg.norm(b - matvec(x0))
    x, cycles, res = lax.while_loop(cond, body, (x0, jnp.int32(0), res0))
    return x, res, cycles * m
