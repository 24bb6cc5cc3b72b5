#!/usr/bin/env python3
"""DFG cylinder benchmarks through the product Problem API, fast path.

The same template-method problem classes as demo/dfg_benchmark.py
(reference: demo/dfg_benchmark.py + ns_problem.py:504-736), but solved with
``ProjectionSolver`` -- the fused single-XLA-program projection step -- so
the documented API reaches benchmark throughput (the fast path used to
live only in bespoke benchmarks/ scripts).

Two configurations:

* ``DFGBenchmark2D2Projection`` -- steady inflow, Re=100 (Schafer-Turek
  2D-2): c_D in [3.22, 3.24], c_L in [0.99, 1.01], St in [0.295, 0.305];
* ``DFGBenchmark2D3Projection`` -- pulsating inflow amplitude
  sin(pi t / t_end) (2D-3): c_D,max in [2.93, 2.97], c_L,max in
  [0.47, 0.49].  Exercises the traced time-dependent BC path.

Usage: python demo/dfg_benchmark_projection.py [2d2|2d3] [t_end]
       [resolution] [dt]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # runnable from any cwd
import sys

import numpy as np

from navierstokes_tpu.fem.bcs import PressureBCType, VelocityBCType
from navierstokes_tpu.mesh import channel_with_cylinder
from navierstokes_tpu.problems import (EquationCoefficientHandler,
                                       InstationaryProblem)
from navierstokes_tpu.solvers import ProjectionSolver

H = 4.1           # channel height (cylinder diameters)


class DFGBenchmark2D2Projection(InstationaryProblem):
    """Steady-inflow DFG 2D-2 on the fused projection path."""

    pulsating = False

    def __init__(self, main_dir=None, end_time=80.0, n_max_steps=16000,
                 resolution=1.8, dt=0.005):
        super().__init__(main_dir, start_time=0.0, end_time=end_time,
                         desired_start_time_step=dt,
                         n_max_steps=n_max_steps)
        self._problem_name = type(self).__name__
        self._resolution = resolution
        self._output_frequency = 0
        self._postprocessing_frequency = 1
        self._cfl_frequency = 200       # monitoring only (non-adaptive)
        self.set_solver_class(ProjectionSolver)
        self.coefficients = []
        self._force_series = []         # device arrays, converted lazily

    def setup_mesh(self):
        self._mesh, self._boundary_markers, self._boundary_marker_map = \
            channel_with_cylinder(self._resolution)

    def set_initial_conditions(self):
        self._initial_conditions = {"velocity": (0.0, 0.0)}

    def _amplitude(self, t):
        if not self.pulsating:
            return 1.0
        return np.sin(np.pi * t / self._time_stepping.end_time)

    def set_boundary_conditions(self):
        def inlet_velocity(x, t=0.0):
            t = 0.0 if t is None else t
            s = x[:, 1] / H
            return self._amplitude(t) * np.stack(
                [6.0 * s * (1.0 - s), np.zeros(len(x))], axis=1)

        bm = self._boundary_marker_map
        self._bcs = ((VelocityBCType.function, bm["inlet"], inlet_velocity),
                     (VelocityBCType.no_slip, bm["cylinder"], None),
                     (VelocityBCType.no_slip, bm["upper wall"], None),
                     (VelocityBCType.no_slip, bm["lower wall"], None),
                     (PressureBCType.constant, bm["outlet"], 0.0))

    def set_equation_coefficients(self):
        self._coefficient_handler = EquationCoefficientHandler(Re=100.0)

    def postprocess_solution(self):
        solver = self._get_solver()
        force = solver.boundary_reaction_force(
            self._boundary_marker_map["cylinder"])
        # keep the force on device: a float() here would wait for the
        # device every step; the series materializes in one transfer at
        # the end
        self._force_series.append((self._time_stepping.next_time, force))
        if self._time_stepping.step_number % 200 == 0:
            t, force = self._force_series[-1]
            print(f"t={t:8.3f}  c_D={2 * float(force[0]):8.4f}  "
                  f"c_L={2 * float(force[1]):8.4f}", flush=True)

    def materialize_coefficients(self):
        """Convert the device-side force series to (t, c_D, c_L) rows."""
        if self._force_series:
            forces = np.asarray([np.asarray(f) for _, f in
                                 self._force_series])
            times = [t for t, _ in self._force_series]
            self.coefficients = [(t, 2.0 * f[0], 2.0 * f[1])
                                 for t, f in zip(times, forces)]
            self._force_series = []
        return self.coefficients


class DFGBenchmark2D3Projection(DFGBenchmark2D2Projection):
    """Pulsating-inflow DFG 2D-3 (time-dependent Dirichlet data)."""

    pulsating = True


def summarize(coefficients, dt, window=20.0):
    series = np.asarray(coefficients)
    t_end = series[-1, 0]
    win = series[series[:, 0] > t_end - window]
    cd_max, cl_max = win[:, 1].max(), win[:, 2].max()
    cl = win[:, 2] - win[:, 2].mean()
    freqs = np.fft.rfftfreq(len(cl), d=dt)
    amp = np.abs(np.fft.rfft(cl))
    return {"cd_max": float(cd_max), "cl_max": float(cl_max),
            "strouhal": float(freqs[np.argmax(amp[1:]) + 1])}


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "2d3"
    t_end = float(sys.argv[2]) if len(sys.argv) > 2 else 80.0
    res = float(sys.argv[3]) if len(sys.argv) > 3 else 1.8
    dt = float(sys.argv[4]) if len(sys.argv) > 4 else 0.005
    cls = DFGBenchmark2D3Projection if which == "2d3" \
        else DFGBenchmark2D2Projection
    problem = cls(end_time=t_end, n_max_steps=int(round(t_end / dt)),
                  resolution=res, dt=dt)
    problem.solve_problem()
    import json

    print(json.dumps(summarize(problem.materialize_coefficients(), dt)))
    np.savetxt(f"results/{problem._problem_name}_coefficients.txt",
               np.asarray(problem.coefficients))
