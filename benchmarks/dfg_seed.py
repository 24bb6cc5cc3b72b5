#!/usr/bin/env python3
"""FE-interpolate a saved DFG 2D-2 state onto a finer cylinder mesh.

Mesh-refinement runs of the saturated vortex street should not pay the full ~100-time-unit saturation transient again: a
saturated coarse-mesh limit cycle interpolated onto the finer mesh
re-saturates in a few shedding periods.  This tool reads a state written
by ``benchmarks/dfg_2d2.py`` (``results/dfg_2d2_state*.npz``), evaluates
the P2 velocity ring (u, u_old) and the P1 pressure/increment fields at
the fine mesh's node coordinates (exact FE interpolation, chunked cell
location to bound host memory), enforces the fine mesh's Dirichlet data,
and writes a resume-compatible npz.

Reference counterpart: restarting `demo/dfg_benchmark.py` runs from saved
fields (the reference has no restart machinery -- README ToDo; here it
is first-class).

Usage: python benchmarks/dfg_seed.py <state.npz> <res_from> <res_to>
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # runnable from any cwd

import os
import sys

import numpy as np


def eval_chunked(space, eval_fn, field, points, chunk=2000):
    out = [eval_fn(field, points[i:i + chunk])
           for i in range(0, len(points), chunk)]
    return np.concatenate([np.atleast_1d(o) for o in out])


def main(state_path, res_from, res_to):
    from navierstokes_tpu.fem.spaces import TaylorHoodSpace
    from navierstokes_tpu.mesh import channel_with_cylinder

    data = np.load(state_path)
    assert float(data["resolution"]) == res_from, \
        (float(data["resolution"]), res_from)

    wake_from = float(os.environ.get("NS_DFG_WAKE_FROM", "1"))
    wake_to = float(os.environ.get("NS_DFG_WAKE", "1"))
    len_from = float(os.environ.get("NS_DFG_LENGTH_FROM", "22"))
    len_to = float(os.environ.get("NS_DFG_LENGTH", "22"))
    # NS_DFG_STAGGER_FROM lets the SOURCE mesh use a different ring/cloud
    # construction than the target (e.g. seeding the new symmetric mesh
    # from a state saved on the legacy asymmetric one)
    stagger_from = os.environ.get("NS_DFG_STAGGER_FROM")
    if stagger_from is not None:
        saved = os.environ.get("NS_RING_STAGGER")
        os.environ["NS_RING_STAGGER"] = stagger_from
    mesh1, _, _ = channel_with_cylinder(res_from, wake=wake_from,
                                        length=len_from)
    if stagger_from is not None:
        if saved is None:
            del os.environ["NS_RING_STAGGER"]
        else:
            os.environ["NS_RING_STAGGER"] = saved
    space1 = TaylorHoodSpace(mesh1)
    mesh2, markers2, bm2 = channel_with_cylinder(res_to, wake=wake_to,
                                                 length=len_to)
    space2 = TaylorHoodSpace(mesh2)
    print(f"seed: {space1.n_dofs} DoF -> {space2.n_dofs} DoF", flush=True)

    u1 = np.asarray(data["u"], np.float64).reshape(space1.n_unodes,
                                                   space1.dim)
    uo1 = np.asarray(data["u_old"], np.float64).reshape(space1.n_unodes,
                                                        space1.dim)
    p1 = np.asarray(data["p"], np.float64)
    # monolithic states (benchmarks/dfg_monolithic.py) carry no pressure
    # increment; seed phi = 0 (the split scheme rebuilds it in one step)
    phi1 = (np.asarray(data["phi"], np.float64) if "phi" in data
            else np.zeros_like(p1))

    upts = np.array(space2.u_coords)
    ppts = np.array(space2.p_coords)
    if len_to > len_from:
        # domain-extension seeding: clamp evaluation points into the
        # source domain (the street regenerates downstream within a few
        # advection times)
        xmax = len_from - 1e-6
        upts[:, 0] = np.minimum(upts[:, 0], xmax)
        ppts[:, 0] = np.minimum(ppts[:, 0], xmax)
    u2 = eval_chunked(space1, space1.eval_velocity, u1, upts).reshape(
        space2.n_unodes, space2.dim)
    uo2 = eval_chunked(space1, space1.eval_velocity, uo1, upts).reshape(
        space2.n_unodes, space2.dim)
    p2 = eval_chunked(space1, space1.eval_pressure, p1, ppts)
    phi2 = eval_chunked(space1, space1.eval_pressure, phi1, ppts)

    # re-impose the fine mesh's Dirichlet data exactly (the coarse
    # cylinder polygon sits slightly inside the fine one, so interpolated
    # wall values are only O(h^2) small, not zero)
    from navierstokes_tpu.fem.bcs import VelocityBCType
    from navierstokes_tpu.fem.dirichlet import compile_dirichlet_bcs

    h = 4.1

    def inlet(x):
        s = x[:, 1] / h
        return np.stack([6.0 * s * (1.0 - s), np.zeros(len(x))], axis=1)

    vbc, _ = compile_dirichlet_bcs(space2, markers2, [
        (VelocityBCType.function, bm2["inlet"], inlet),
        (VelocityBCType.no_slip, bm2["cylinder"], None),
        (VelocityBCType.no_slip, bm2["upper wall"], None),
        (VelocityBCType.no_slip, bm2["lower wall"], None)], [])
    for arr in (u2, uo2):
        arr.reshape(-1)[np.asarray(vbc.dofs)] = vbc.values()

    suffix = "" if wake_to == 1.0 else f"_w{wake_to:g}"
    if len_to != 22.0:
        suffix += f"_L{len_to:g}"
    out = f"results/dfg_2d2_base_res{res_to:g}{suffix}.npz"
    np.savez(out, u=u2.reshape(-1), u_old=uo2.reshape(-1), p=p2, phi=phi2,
             t=float(data["t"]), resolution=res_to, wake=wake_to)
    print(f"wrote {out} (t={float(data['t']):g})", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], float(sys.argv[2]), float(sys.argv[3]))
