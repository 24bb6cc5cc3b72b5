#!/usr/bin/env python3
"""End-to-end smoke run of the solver suite on one GPU, or four.

``python chip_smoke.py`` drives the main paths once through the classes a
user calls, at full size, on one GPU, in ONE process (a JAX process
reserves most of the card's memory when it starts):

1. device: a GPU is required; the device and the card's name and power
   limit are printed;
2. Taylor-Green 512^2 (2.36M DoF) through ``ProjectionSolver`` on the
   structured spectral step, checked against the analytic decay;
3. the same flow through ``ProjectionSolver(prefer_spectral=False)`` on
   the generic banded step, checked against the decay and phase 2;
4. DFG 2D-2 at res 3 (~76k DoF, curved cylinder mesh) through
   ``DFGBenchmark2D2Projection.solve_problem()``; the first 10 steps are
   repeated on JAX's CPU device in this process and compared;
5. the README cavity (``StationaryProblem``, Re=100) at 128^2 under x64,
   PCD-FGMRES Newton on the GPU against a host SciPy-LU Newton solve;
6. ``CirculantBand.apply`` (stack and roll forms) and one Jacobi-CG
   Poisson solve against SciPy CSR float64 references.

``python chip_smoke.py --four`` runs only the three sharded solver
classes on four GPUs, each against the same run on one GPU.

Every phase prints its set-up time (host assembly plus compile), the
median time of its warm steps (each ended by ``block_until_ready``), the
device's peak memory so far, and each comparison beside its tolerance.
Any failed check raises, so the exit code is non-zero.  The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# the in-process CPU references of phases 4 and 5 need JAX's CPU backend
# beside the GPU one
_platforms = os.environ.get("JAX_PLATFORMS")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

#: H100 SXM device-memory bandwidth (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12

RE_TG = 100.0
DT_TG = 1.0e-3


class CheckFailed(AssertionError):
    """A comparison fell outside its stated tolerance."""


def check(name, value, tol):
    """Print ``value`` beside its tolerance; raise when it is outside."""
    ok = bool(np.isfinite(value)) and value <= tol
    print(f"    check {name}: {value:.3e} <= {tol:.1e} "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise CheckFailed(f"{name}: {value!r} > {tol!r}")


def peak_bytes():
    """Peak device bytes in use so far in this process (None on CPU)."""
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else int(stats["peak_bytes_in_use"])


#: XLA compilations so far: seconds in backend compile (a persistent-cache
#: fetch included), programs, and how many came from the cache
_COMPILES = {"seconds": 0.0, "programs": 0, "cache_hits": 0}
_COMPILES_REPORTED = dict(_COMPILES)


def watch_compiles():
    """Count compile time and persistent-cache hits through jax.monitoring."""
    from jax import monitoring

    def on_duration(event, seconds, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            _COMPILES["seconds"] += seconds
            _COMPILES["programs"] += 1

    def on_event(event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            _COMPILES["cache_hits"] += 1

    monitoring.register_event_duration_secs_listener(on_duration)
    monitoring.register_event_listener(on_event)


def start_phase():
    """Start a phase's clock; its report counts the compiles from here."""
    _COMPILES_REPORTED.update(_COMPILES)
    return time.perf_counter()


def cache_entries(path):
    """Files in the persistent compile-cache directory (0 if absent)."""
    return len(os.listdir(path)) if os.path.isdir(path) else 0


def report(phase, setup_s, step_s=None, **extra):
    peak = peak_bytes()
    new = {k: v - _COMPILES_REPORTED[k] for k, v in _COMPILES.items()}
    _COMPILES_REPORTED.update(_COMPILES)
    parts = [f"[{phase}] setup {setup_s:.2f} s",
             f"compile {new['seconds']:.2f} s in {new['programs']} programs "
             f"({new['cache_hits']} from the persistent cache)"]
    if step_s is not None:
        parts.append(f"median step {step_s * 1e3:.3f} ms")
    parts.append("peak_bytes_in_use "
                 + ("n/a" if peak is None else f"{peak / 2**30:.3f} GiB"))
    parts += [f"{k} {v}" for k, v in extra.items()]
    print(", ".join(parts), flush=True)


@contextlib.contextmanager
def quiet():
    """Swallow the solvers' progress prints (keeps the report readable)."""
    with contextlib.redirect_stdout(io.StringIO()):
        yield


def require_gpu():
    """The GPU devices JAX sees; raises ``SystemExit`` on any other backend.

    Measurement entry points call this first: a number taken on the CPU
    must never be reported as a device number.
    """
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"no GPU found: JAX runs on "
                         f"{devices[0].platform!r}")
    return devices


def card_report() -> str:
    """Name and power limit of each card, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def _load_package():
    """Import the package from this checkout, never from elsewhere."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import navierstokes_tpu

    pkg = os.path.dirname(os.path.abspath(navierstokes_tpu.__file__))
    if os.path.dirname(pkg) != ROOT:
        raise SystemExit(f"navierstokes_tpu imported from {pkg}, "
                         f"not from {ROOT}")


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device(count=1):
    """Require ``count`` GPUs; print the device and the card line."""
    devices = require_gpu()
    if len(devices) < count:
        raise SystemExit(f"need {count} GPUs, JAX sees {len(devices)}")
    d = devices[0]
    print(f"[device] platform {d.platform}, kind {d.device_kind}, "
          f"count {len(devices)}", flush=True)
    print(card_report(), flush=True)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


# ---------------------------------------------------------------------------
# phases 2-3: Taylor-Green through ProjectionSolver
# ---------------------------------------------------------------------------

def _tg_velocity(x, t=0.0):
    g = 2.0 * np.pi
    decay = np.exp(-2.0 * g * g * (t or 0.0) / RE_TG)
    return decay * np.stack([np.cos(g * x[:, 0]) * np.sin(g * x[:, 1]),
                             -np.sin(g * x[:, 0]) * np.cos(g * x[:, 1])],
                            axis=1)


def tg_amp_rel_err(amp_max, t):
    """|max|u| - e^{-2 nu g^2 t}| / e^{-2 nu g^2 t} (bench.py's guard)."""
    g = 2.0 * np.pi
    expected = np.exp(-2.0 * (1.0 / RE_TG) * g * g * t)
    return abs(float(amp_max) - expected) / expected


def _march(solver, ts, n_steps):
    """Step ``solver`` n times; per-step wall times, each ended by
    ``block_until_ready`` on the solution."""
    times = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        ts.update_coefficients()
        solver.solve()
        ts.advance_time()
        solver.advance_time()
        jax.block_until_ready(solver.solution)
        times.append(time.perf_counter() - t0)
    return times


def run_taylor_green(n, n_steps, prefer_spectral, label):
    """Taylor-Green n^2 through ProjectionSolver; returns the final host
    velocity, the step kind, set-up and median step seconds."""
    from navierstokes_tpu.fem.bcs import PressureBCType
    from navierstokes_tpu.fem.spaces import axis_periodic
    from navierstokes_tpu.mesh import HyperCubeBoundaryMarkers as M
    from navierstokes_tpu.mesh import hyper_cube
    from navierstokes_tpu.solvers import ProjectionSolver
    from navierstokes_tpu.timestepping import BDFTimeStepping

    t0 = start_phase()
    mesh, markers = hyper_cube(2, n)
    ts = BDFTimeStepping(0.0, 1.0, desired_start_time_step=DT_TG)
    solver = ProjectionSolver(mesh, markers, "standard", ts,
                              prefer_spectral=prefer_spectral)
    solver.set_periodic_boundary_conditions(
        [axis_periodic(0), axis_periodic(1)],
        (M.left.value, M.right.value, M.bottom.value, M.top.value))
    solver.set_boundary_conditions(((PressureBCType.mean_value, None, 0.0),))
    solver.set_equation_coefficients(
        {"convective_term": 1.0, "viscous_term": 1.0 / RE_TG,
         "pressure_term": 1.0})
    solver.set_initial_conditions({"velocity": _tg_velocity})
    times = _march(solver, ts, n_steps)
    n_warm = min(3, n_steps - 1)
    setup = time.perf_counter() - t0 - sum(times[n_warm:])
    u, _ = solver.space.split(np.asarray(solver.solution))
    u = np.asarray(u, np.float64)
    amp_err = tg_amp_rel_err(np.abs(u).max(), ts.current_time)
    step = float(np.median(times[n_warm:]))
    report(label, setup, step, dofs=solver.space.n_dofs,
           step_kind=solver._step_kind, steps=n_steps,
           dof_steps_per_s=f"{solver.space.n_dofs / step:.4e}")
    return u, solver._step_kind, amp_err


def phase_tg_spectral(n=512, n_steps=30, amp_tol=1e-3):
    u, kind, amp_err = run_taylor_green(n, n_steps, True, "tg-spectral")
    if kind != "spectral":
        raise CheckFailed(f"expected the spectral step, got {kind!r}")
    check("tg-spectral amp_rel_err vs analytic decay", amp_err, amp_tol)
    return u


def phase_tg_banded(u_spectral, n=512, n_steps=30, amp_tol=1e-3,
                    cross_tol=1e-3):
    u, kind, amp_err = run_taylor_green(n, n_steps, False, "tg-banded")
    if kind != "fast":
        raise CheckFailed(f"expected the banded step, got {kind!r}")
    check("tg-banded amp_rel_err vs analytic decay", amp_err, amp_tol)
    cross = np.linalg.norm(u - u_spectral) / np.linalg.norm(u_spectral)
    check("tg-banded vs tg-spectral velocity, rel L2", cross, cross_tol)


# ---------------------------------------------------------------------------
# phase 4: DFG 2D-2 through the Problem API
# ---------------------------------------------------------------------------

def run_dfg(resolution, n_steps, dt, capture_step):
    """DFG 2D-2 from rest; returns (state after ``capture_step`` steps,
    per-step hook times, force series, problem)."""
    sys.path.insert(0, os.path.join(ROOT, "demo"))
    from dfg_benchmark_projection import DFGBenchmark2D2Projection

    class Run(DFGBenchmark2D2Projection):
        def postprocess_solution(self):
            super().postprocess_solution()
            solver = self._get_solver()
            jax.block_until_ready(solver.solution)
            self.hook_times.append(time.perf_counter())
            if self._time_stepping.step_number + 1 == capture_step:
                self.captured = np.asarray(solver.solution, np.float64)

    results = os.path.join(ROOT, "results")
    os.makedirs(results, exist_ok=True)
    problem = Run(main_dir=ROOT, end_time=n_steps * dt,
                  n_max_steps=n_steps, resolution=resolution, dt=dt)
    problem.hook_times, problem.captured = [], None
    with quiet():
        problem.solve_problem()
    return problem


def phase_dfg(resolution=3.0, n_steps=100, dt=0.005, n_check=10,
              state_tol=1e-3):
    t0 = start_phase()
    problem = run_dfg(resolution, n_steps, dt, n_check)
    hooks = problem.hook_times
    # set-up runs to the end of step 3 (mesh, host assembly, compiles);
    # the later steps are the warm ones
    setup = hooks[2] - t0
    steps = np.diff(hooks[2:])
    coeffs = np.asarray(problem.materialize_coefficients())
    space = problem._get_solver().space
    report("dfg-2d2", setup, float(np.median(steps)), dofs=space.n_dofs,
           step_kind=problem._get_solver()._step_kind, steps=len(hooks),
           c_D=f"{coeffs[-1, 1]:.6f}", c_L=f"{coeffs[-1, 2]:.6f}")
    if not np.isfinite(coeffs).all():
        raise CheckFailed("non-finite c_D / c_L")
    print(f"    check dfg c_D, c_L finite over {len(coeffs)} steps: ok",
          flush=True)
    gpu_state = problem.captured

    cpu = jax.devices("cpu")[0]
    t1 = time.perf_counter()
    with jax.default_device(cpu):
        ref = run_dfg(resolution, n_check, dt, n_check)
        cpu_state = ref.captured
    print(f"    cpu reference: {n_check} steps in "
          f"{time.perf_counter() - t1:.2f} s", flush=True)
    err = np.linalg.norm(gpu_state - cpu_state) / np.linalg.norm(cpu_state)
    check(f"dfg state after {n_check} steps, gpu vs cpu, rel L2", err,
          state_tol)


# ---------------------------------------------------------------------------
# phase 5: stationary Newton (README cavity) under x64
# ---------------------------------------------------------------------------

def run_cavity(n, linear_solver):
    """README quick-start cavity at n^2 through StationaryProblem; returns
    (solution f64, final ||F||, seconds)."""
    from navierstokes_tpu.fem.bcs import VelocityBCType
    from navierstokes_tpu.mesh import HyperCubeBoundaryMarkers as M
    from navierstokes_tpu.mesh import hyper_cube
    from navierstokes_tpu.problems import (EquationCoefficientHandler,
                                           StationaryProblem)
    from navierstokes_tpu.solvers import StationarySolver

    class Cavity(StationaryProblem):
        def __init__(self):
            super().__init__(main_dir=ROOT)
            self._problem_name = f"Cavity_{linear_solver}"

        def setup_mesh(self):
            self._mesh, self._boundary_markers = hyper_cube(2, n)
            self._navier_stokes_solver = StationarySolver(
                self._mesh, self._boundary_markers, "standard",
                linear_solver=linear_solver)

        def set_boundary_conditions(self):
            self._bcs = ((VelocityBCType.no_slip, M.left.value, None),
                         (VelocityBCType.no_slip, M.right.value, None),
                         (VelocityBCType.no_slip, M.bottom.value, None),
                         (VelocityBCType.constant, M.top.value, (1.0, 0.0)))

        def set_equation_coefficients(self):
            self._coefficient_handler = EquationCoefficientHandler(Re=100.0)

    os.makedirs(os.path.join(ROOT, "results"), exist_ok=True)
    t0 = start_phase()
    problem = Cavity()
    with quiet():
        problem.solve_problem()
    solver = problem._get_solver()
    x = np.asarray(solver.solution, np.float64)
    rec = [r for r in solver.monitor.records
           if r["kind"] == "nonlinear_solve"][-1]
    return x, float(rec["residual"]), time.perf_counter() - t0, solver


def phase_stationary(n=128, res_tol=1e-10, sol_tol=1e-8):
    x64_before = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        x_dev, res, secs, solver = run_cavity(n, "pcd")
        if solver.solution.dtype != jnp.float64:
            raise CheckFailed(f"device solve ran in {solver.solution.dtype}")
        rec = [r for r in solver.monitor.records
               if r["kind"] == "linear_solve"]
        report("stationary-newton", secs, None, dofs=solver.space.n_dofs,
               dtype="float64", newton_linear_solves=len(rec),
               fgmres_iterations=sum(int(r["iterations"]) for r in rec))
        check("stationary ||F|| on the device", res, res_tol)
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            x_ref, res_ref, secs_ref, _ = run_cavity(n, "host_lu")
        print(f"    host LU reference: ||F|| {res_ref:.3e} in "
              f"{secs_ref:.2f} s", flush=True)
        err = np.abs(x_dev - x_ref).max() / np.abs(x_ref).max()
        check("stationary solution, pcd (gpu) vs LU (host), rel max",
              err, sol_tol)
    finally:
        jax.config.update("jax_enable_x64", x64_before)


# ---------------------------------------------------------------------------
# phase 6: band apply and the Jacobi-CG solve
# ---------------------------------------------------------------------------

def _periodic_operators(n):
    """(FastTaylorHood, permuted CSR K and L) of the periodic n^2 TG space."""
    from navierstokes_tpu.assembly.fastop import (FastTaylorHood,
                                                  assemble_csr,
                                                  scalar_element_matrices)
    from navierstokes_tpu.fem.spaces import TaylorHoodSpace, axis_periodic
    from navierstokes_tpu.mesh import hyper_cube

    mesh, _ = hyper_cube(2, n)
    space = TaylorHoodSpace(mesh, periodic=[axis_periodic(0),
                                            axis_periodic(1)])
    fast = FastTaylorHood(space, dtype=jnp.float32)
    em = scalar_element_matrices(space)
    cu = np.asarray(space.cell_unodes)
    cp = np.asarray(space.cell_pnodes)
    K = assemble_csr(em["K2"], cu, cu, (space.n_unodes,) * 2).tocsr()
    L = assemble_csr(em["L1"], cp, cp, (space.n_pnodes,) * 2).tocsr()
    K = K[fast.permU][:, fast.permU]
    L = L[fast.permP][:, fast.permP]
    return fast, K, L


def time_band_apply(op, mode, x, reps):
    """Seconds per ``op.apply`` in ``mode``, from ``reps`` dependent
    applies inside one jitted loop (no per-apply dispatch)."""
    from navierstokes_tpu.assembly.fastop import CirculantBand

    leaves, treedef = jax.tree_util.tree_flatten(op)
    scale = 1e-4 / float(jnp.abs(op.band).max())

    def apply(band_leaves, v):
        o = jax.tree_util.tree_unflatten(treedef, band_leaves)
        return o.apply(v)

    def loop(band_leaves, v):
        return jax.lax.fori_loop(
            0, reps, lambda _, w: w + scale * apply(band_leaves, w), v)

    saved = CirculantBand.mode
    CirculantBand.mode = mode
    try:
        one = jax.jit(apply)
        y = np.asarray(one(leaves, x), np.float64)
        run = jax.jit(loop)
        jax.block_until_ready(run(leaves, x))
        t0 = time.perf_counter()
        jax.block_until_ready(run(leaves, x))
        secs = (time.perf_counter() - t0) / reps
    finally:
        CirculantBand.mode = saved
    return y, secs


def phase_band(sizes=(128, 512), reps=200, apply_tol=1e-5, cg_n=128,
               cg_iters=60, cg_tol=1e-3):
    rng = np.random.default_rng(0)
    for n in sizes:
        t0 = start_phase()
        fast, K, L = _periodic_operators(n)
        setup = time.perf_counter() - t0
        report(f"band-{n}", setup, None, n_unodes=K.shape[0],
               n_pnodes=L.shape[0])
        for name, op, A, shape in (
                ("velocity K (2 planes)", fast.K, K, (2, K.shape[0])),
                ("pressure L", fast.L, L, (L.shape[0],))):
            x = rng.standard_normal(shape).astype(np.float32)
            ref = (A @ x.astype(np.float64).T).T
            # forward-error scale: (|A| |x|)_max
            scale = np.abs((abs(A) @ np.abs(x.astype(np.float64)).T)).max()
            nbytes = op.nbytes + 2 * x.nbytes
            for mode in ("stack", "roll"):
                y, secs = time_band_apply(op, mode, jnp.asarray(x), reps)
                print(f"    {n}^2 {name} {mode}: {secs * 1e6:.3f} us/apply, "
                      f"{nbytes / secs / 1e9:.1f} GB/s of "
                      f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s "
                      f"({nbytes / secs / HBM_BYTES_PER_S:.3f} of peak; "
                      f"{len(op.offsets)} offsets, {nbytes / 1e6:.2f} MB)",
                      flush=True)
                check(f"{n}^2 {name} {mode} vs scipy CSR f64, "
                      f"max err / (|A||x|)_max", np.abs(y - ref).max()
                      / scale, apply_tol)
        if n == cg_n:
            phase_cg(fast, L, cg_iters, cg_tol)


def phase_cg(fast, L, iters, tol):
    """One mean-free Jacobi-CG Poisson solve (``_pcg``) against the same
    iteration count of SciPy's CG in float64."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from navierstokes_tpu.solvers.planar_step import _pcg

    rng = np.random.default_rng(1)
    b = rng.standard_normal(L.shape[0])
    b -= b.mean()
    inv_d = 1.0 / L.diagonal()

    def project(r):
        return r - jnp.mean(r)

    @jax.jit
    def solve(op, rhs):
        return _pcg(op.apply, rhs, jnp.zeros_like(rhs), iters,
                    inv_diag=jnp.asarray(inv_d, rhs.dtype), project=project)

    rhs = jnp.asarray(b, jnp.float32)
    jax.block_until_ready(solve(fast.L, rhs))
    t0 = time.perf_counter()
    x, _ = jax.block_until_ready(solve(fast.L, rhs))
    secs = time.perf_counter() - t0
    print(f"    _pcg {iters} Jacobi-CG iterations on {L.shape[0]} pressure "
          f"nodes: {secs * 1e3:.3f} ms ({secs / iters * 1e6:.2f} "
          f"us/iteration)", flush=True)
    x_ref, _ = spla.cg(L, b, x0=np.zeros_like(b), rtol=0.0, atol=0.0,
                       maxiter=iters, M=sp.diags(inv_d))
    x = np.asarray(x, np.float64)
    x -= x.mean()
    x_ref -= x_ref.mean()
    check(f"_pcg vs scipy cg ({iters} its, f64), rel L2",
          np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref), tol)


# ---------------------------------------------------------------------------
# --four: the sharded solver classes
# ---------------------------------------------------------------------------

def _assert_spread(arrays, devices, what):
    """Every device holds its own shard of every array (no replication
    onto, and no concentration on, device 0)."""
    want = {d.id for d in devices}
    for a in arrays:
        shards = a.addressable_shards
        got = {s.device.id for s in shards}
        idx = {str(s.index) for s in shards}
        if got != want or len(idx) != len(devices):
            raise CheckFailed(f"{what}: shards on devices {sorted(got)} "
                              f"with {len(idx)} distinct slices")
    print(f"    check {what}: each of {len(devices)} devices holds its own "
          f"shard ({len(arrays)} arrays): ok", flush=True)


def four_halo(dmesh, nx=256, ny=64, n_steps=20, tol=1e-9):
    """Halo ``ProjectionSolver(device_mesh=)`` on 4 GPUs against the
    banded step on 1, under x64 with CG converged to 1e-10: in float32
    the truncated Poisson solves of the two different operator layouts
    drift apart by more than roundoff, and would hide a real mismatch."""
    from navierstokes_tpu.fem.bcs import PressureBCType, VelocityBCType
    from navierstokes_tpu.mesh import hyper_rectangle
    from navierstokes_tpu.mesh.generators import \
        HyperCubeBoundaryMarkers as M
    from navierstokes_tpu.solvers import ProjectionSolver
    from navierstokes_tpu.timestepping import BDFTimeStepping

    def build(device_mesh):
        cmesh, markers = hyper_rectangle((0.0, 0.0), (4.0, 1.0), (nx, ny))
        ts = BDFTimeStepping(0.0, 1.0, desired_start_time_step=0.002)
        solver = ProjectionSolver(cmesh, markers, "standard", ts,
                                  cg_iters=(100, 5000, 100), cg_rtol=1e-10,
                                  poisson_precond=None,
                                  device_mesh=device_mesh)
        inlet = lambda x: np.stack(
            [x[:, 1] * (1 - x[:, 1]), np.zeros(len(x))], axis=1)
        solver.set_boundary_conditions(
            ((VelocityBCType.function, M.left.value, inlet),
             (VelocityBCType.no_slip, M.bottom.value, None),
             (VelocityBCType.no_slip, M.top.value, None),
             (PressureBCType.constant, M.right.value, 0.0)))
        solver.set_equation_coefficients(
            {"convective_term": 1.0, "viscous_term": 0.1,
             "pressure_term": 1.0})
        solver.set_initial_conditions({"velocity": (0.0, 0.0)})
        return solver, ts

    x64_before = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        out = {}
        for label, dm in (("1 gpu", None), ("4 gpus", dmesh)):
            t0 = start_phase()
            with quiet():
                solver, ts = build(dm)
            times = _march(solver, ts, n_steps)
            setup = time.perf_counter() - t0 - sum(times[3:])
            report(f"halo-projection {label}", setup,
                   float(np.median(times[3:])), dofs=solver.space.n_dofs,
                   step_kind=solver._step_kind, dtype="float64")
            out[label] = (np.asarray(solver.solution, np.float64), solver)
        x1, _ = out["1 gpu"]
        xh, sh = out["4 gpus"]
        if sh._step_kind != "halo":
            raise CheckFailed(f"expected the halo step, got "
                              f"{sh._step_kind!r}")
        _assert_spread([sh._uh, sh._ph], list(dmesh.devices.flat),
                       "halo projection state")
        err = np.abs(xh - x1).max() / np.abs(x1).max()
        check("halo ProjectionSolver 4 vs 1 gpu, rel max", err, tol)
    finally:
        jax.config.update("jax_enable_x64", x64_before)


def four_spectral(dmesh, n=512, n_steps=10, tol=1e-5):
    from navierstokes_tpu.fem.spaces import TaylorHoodSpace, axis_periodic
    from navierstokes_tpu.mesh import hyper_cube
    from navierstokes_tpu.structured import (PeriodicStructuredTH,
                                             build_spectral_projection_step)
    from navierstokes_tpu.structured.spectral import shard_spectral_step

    t0 = start_phase()
    mesh, _ = hyper_cube(2, n)
    space = TaylorHoodSpace(mesh, periodic=[axis_periodic(0),
                                            axis_periodic(1)])
    g = 2.0 * np.pi
    u0 = space.interpolate_velocity(
        lambda x: np.stack([np.cos(g * x[:, 0]) * np.sin(g * x[:, 1]),
                            -np.sin(g * x[:, 0]) * np.cos(g * x[:, 1])],
                           axis=1))
    p0 = space.interpolate_pressure(
        lambda x: -0.25 * (np.cos(2 * g * x[:, 0]) + np.cos(2 * g * x[:, 1])))
    sgrid = PeriodicStructuredTH(space)
    step, init_state, read_state = build_spectral_projection_step(
        sgrid, visc=1.0 / RE_TG, dt=DT_TG, dtype=jnp.float32)
    alpha = tuple(jnp.asarray(v, jnp.float32) for v in (1.5, -2.0, 0.5))
    eta = tuple(jnp.asarray(v, jnp.float32) for v in (2.0, -1.0))
    setup = time.perf_counter() - t0
    sharded, shard_state = shard_spectral_step(step, sgrid, dmesh)
    results = {}
    for label, fn, st in (
            ("1 gpu", step, init_state(u0.reshape(-1), u0.reshape(-1), p0)),
            ("4 gpus", sharded,
             shard_state(init_state(u0.reshape(-1), u0.reshape(-1), p0)))):
        times = []
        for _ in range(n_steps):
            t1 = time.perf_counter()
            st = jax.block_until_ready(fn(st, alpha, eta))
            times.append(time.perf_counter() - t1)
        report(f"spectral-step {label}", setup + sum(times[:3]),
               float(np.median(times[3:])), dofs=space.n_dofs)
        results[label] = st
    leaves = [l for l in jax.tree.leaves(results["4 gpus"]) if l.ndim > 1]
    _assert_spread(leaves, list(dmesh.devices.flat), "spectral state")
    u1, _ = read_state(results["1 gpu"])
    u4, _ = read_state(results["4 gpus"])
    u1, u4 = np.asarray(u1, np.float64), np.asarray(u4, np.float64)
    check("sharded spectral step 4 vs 1 gpu, rel L2",
          np.linalg.norm(u4 - u1) / np.linalg.norm(u1), tol)


def four_stationary(dmesh, n=64, tol=1e-6):
    from navierstokes_tpu.fem.bcs import VelocityBCType
    from navierstokes_tpu.mesh import HyperCubeBoundaryMarkers as M
    from navierstokes_tpu.mesh import hyper_cube
    from navierstokes_tpu.solvers import StationarySolver

    def cavity(device_mesh):
        mesh, markers = hyper_cube(2, n)
        s = StationarySolver(mesh, markers, "standard", tol=1e-9,
                             linear_solver="pcd", device_mesh=device_mesh)
        s.set_boundary_conditions(
            ((VelocityBCType.no_slip, M.left.value, None),
             (VelocityBCType.no_slip, M.right.value, None),
             (VelocityBCType.no_slip, M.bottom.value, None),
             (VelocityBCType.constant, M.top.value, (1.0, 0.0))))
        s.set_equation_coefficients(
            {"convective_term": 1.0, "viscous_term": 1.0 / 50.0,
             "pressure_term": 1.0, "coriolis_term": None,
             "euler_term": None, "body_force_term": None})
        label = "4 gpus" if device_mesh else "1 gpu"
        record, out = s.monitor.record, sys.stdout

        def record_and_print(kind, **fields):
            # each linear solve as it ends, so a stalled or hung solve
            # shows in the output of a run that is cut
            record(kind, **fields)
            if kind in ("linear_solve", "nonlinear_solve"):
                print(f"    {label} {kind}: residual "
                      f"{fields['residual']:.3e}, {fields['iterations']} "
                      f"iterations, {time.perf_counter() - t0:.1f} s",
                      file=out, flush=True)

        s.monitor.record = record_and_print
        t0 = start_phase()
        with quiet():
            s.solve()
        return s, time.perf_counter() - t0

    x64_before = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        s1, secs1 = cavity(None)
        report("stationary 1 gpu", secs1, None, dofs=s1.space.n_dofs)
        s4, secs4 = cavity(dmesh)
        report("stationary 4 gpus", secs4, None, dofs=s4.space.n_dofs)
        op = s4._operator
        _assert_spread([op.cell_unodes, op.cell_pnodes, op.Jinv, op.W],
                       list(dmesh.devices.flat), "stationary cell arrays")
        x1 = np.asarray(s1.solution, np.float64)
        x4 = np.asarray(s4.solution, np.float64)
        check("sharded StationarySolver 4 vs 1 gpu, rel max",
              np.abs(x4 - x1).max() / np.abs(x1).max(), tol)
    finally:
        jax.config.update("jax_enable_x64", x64_before)


# ---------------------------------------------------------------------------

def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the sharded solver classes on 4 GPUs")
    args = parser.parse_args(argv)

    _load_package()
    from navierstokes_tpu import config

    device = phase_device(4 if args.four else 1)
    cache = config.use_compile_cache()
    print(f"[compile-cache] {cache}: {cache_entries(cache)} entries at the "
          f"start", flush=True)
    watch_compiles()
    t0 = time.perf_counter()
    if args.four:
        from navierstokes_tpu.parallel.sharded import device_mesh

        dmesh = device_mesh(4)
        four_halo(dmesh)
        four_spectral(dmesh)
        four_stationary(dmesh)
    else:
        u_spectral = phase_tg_spectral()
        phase_tg_banded(u_spectral)
        phase_dfg()
        phase_stationary()
        phase_band()
    print(f"[total] {time.perf_counter() - t0:.1f} s, compile "
          f"{_COMPILES['seconds']:.1f} s in {_COMPILES['programs']} programs "
          f"({_COMPILES['cache_hits']} from the persistent cache); "
          f"{cache_entries(cache)} cache entries at the end", flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
