"""Gather-free operator engine (assembly/fastop.py) vs the cell-loop layer.

CPU/f64: the FastTaylorHood suite must reproduce the ShardedCellOperator
matvecs to roundoff on periodic and non-periodic meshes, in both device
formats (circulant rolls and the affine block-window band), and the planar
projection step must track the fused step trajectory.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from navierstokes_tpu.assembly.fastop import (AffineBand, CirculantBand,
                                              FastTaylorHood)
from navierstokes_tpu.fem.spaces import TaylorHoodSpace, axis_periodic
from navierstokes_tpu.mesh import hyper_cube, hyper_rectangle
from navierstokes_tpu.parallel.sharded import (ShardedCellOperator,
                                               device_mesh)


@pytest.fixture(scope="module")
def periodic_space():
    mesh, _ = hyper_cube(2, 8)
    return TaylorHoodSpace(mesh, periodic=[axis_periodic(0),
                                           axis_periodic(1)])


@pytest.fixture(scope="module")
def channel_space():
    mesh, _ = hyper_rectangle((0.0, 0.0), (2.0, 1.0), (12, 6))
    return TaylorHoodSpace(mesh)


def _interleaved_to_planar(u_flat, space):
    return jnp.asarray(np.asarray(u_flat).reshape(space.n_unodes,
                                                  space.dim).T)


def _planar_to_interleaved(u2):
    return jnp.asarray(np.asarray(u2).T.reshape(-1))


def _check_against_reference(space, fast):
    rng = np.random.default_rng(3)
    u_flat = jnp.asarray(rng.standard_normal(space.n_velocity_dofs))
    p = jnp.asarray(rng.standard_normal(space.n_pnodes))

    ref = ShardedCellOperator(space, device_mesh(1))
    u2 = fast.permute_velocity(_interleaved_to_planar(u_flat, space))
    pp = fast.permute_pressure(p)

    # velocity mass
    got = fast.unpermute_velocity(fast.make_velocity_mass()(u2))
    want = _interleaved_to_planar(ref.make_velocity_mass()(u_flat), space)
    np.testing.assert_allclose(got, want, atol=1e-11)

    # helmholtz with traced accel0
    a0 = jnp.asarray(37.5)
    got = fast.unpermute_velocity(
        fast.make_velocity_helmholtz(0.01)(u2, a0))
    want = _interleaved_to_planar(
        ref.make_velocity_helmholtz(0.01)(u_flat, a0), space)
    np.testing.assert_allclose(got, want, atol=1e-9)

    # gradient
    got = fast.unpermute_velocity(fast.make_gradient()(pp))
    want = _interleaved_to_planar(ref.make_gradient()(p), space)
    np.testing.assert_allclose(got, want, atol=1e-11)

    # divergence
    got = fast.unpermute_pressure(fast.make_divergence()(u2))
    want = ref.make_divergence()(u_flat)
    np.testing.assert_allclose(got, want, atol=1e-11)

    # pressure stiffness
    got = fast.unpermute_pressure(fast.make_pressure_stiffness()(pp))
    want = ref.make_pressure_stiffness()(p)
    np.testing.assert_allclose(got, want, atol=1e-11)

    # nonlinear convection rhs
    got = fast.unpermute_velocity(fast.make_convection_rhs(1.0)(u2))
    want = _interleaved_to_planar(ref.make_convection_rhs(1.0)(u_flat),
                                  space)
    np.testing.assert_allclose(got, want, atol=1e-11)

    # diagonals agree with the cell-loop assembly
    dm, dk, dl = fast.diagonals()
    rm, rk, rl = ref.diagonals()
    np.testing.assert_allclose(np.asarray(dm)[fast.invU],
                               np.asarray(rm).reshape(-1, space.dim)[:, 0],
                               atol=1e-11)
    np.testing.assert_allclose(np.asarray(dl)[fast.invP], rl, atol=1e-11)


def test_periodic_structured_is_circulant(periodic_space):
    fast = FastTaylorHood(periodic_space)
    assert isinstance(fast.M, CirculantBand)
    assert isinstance(fast.K, CirculantBand)
    assert isinstance(fast.L, CirculantBand)
    assert fast.structured
    _check_against_reference(periodic_space, fast)


def test_channel_matches_reference(channel_space):
    fast = FastTaylorHood(channel_space)
    _check_against_reference(channel_space, fast)


def test_affine_band_forced(periodic_space):
    """circulant_cap=0 forces every operator through AffineBand."""
    fast = FastTaylorHood(periodic_space, circulant_cap=0)
    assert isinstance(fast.M, AffineBand)
    assert isinstance(fast.K, AffineBand)
    assert isinstance(fast.L, AffineBand)
    _check_against_reference(periodic_space, fast)


def test_planar_step_matches_fused_step(periodic_space):
    from navierstokes_tpu.solvers.fused_step import build_projection_step
    from navierstokes_tpu.solvers.planar_step import \
        build_planar_projection_step

    space = periodic_space
    fast = FastTaylorHood(space)
    ref_ops = ShardedCellOperator(space, device_mesh(1))

    g = 2 * np.pi
    u0 = space.interpolate_velocity(
        lambda x: np.stack([np.cos(g * x[:, 0]) * np.sin(g * x[:, 1]),
                            -np.sin(g * x[:, 0]) * np.cos(g * x[:, 1])],
                           axis=1))
    p0 = space.interpolate_pressure(
        lambda x: -0.25 * (np.cos(2 * g * x[:, 0])
                           + np.cos(2 * g * x[:, 1])))

    kw = dict(visc=0.01, dt=1e-3, cg_iters=(8, 20, 6))
    step_ref = build_projection_step(space, ref_ops, **kw)
    step_new = build_planar_projection_step(fast, **kw)

    dt64 = jnp.float64
    one = lambda v: jnp.asarray(v, dt64)
    alpha1 = (one(1.0), one(-1.0), one(0.0))
    alpha2 = (one(1.5), one(-2.0), one(0.5))
    eta1 = (one(1.0), one(0.0))
    eta2 = (one(2.0), one(-1.0))

    u_flat = jnp.asarray(u0.reshape(-1))
    p = jnp.asarray(p0)
    phi = jnp.zeros_like(p)
    u2 = fast.permute_velocity(_interleaved_to_planar(u_flat, space))
    p2 = fast.permute_pressure(p)
    phi2 = jnp.zeros_like(p2)

    ur_old = ur = u_flat
    un_old = un = u2
    for i in range(4):
        a, e = (alpha1, eta1) if i == 0 else (alpha2, eta2)
        ur_new, p, phi = step_ref(ur, ur_old, p, phi, a, e)
        un_new, p2, phi2 = step_new(un, un_old, p2, phi2, a, e)
        ur_old, ur = ur, ur_new
        un_old, un = un, un_new

    got_u = fast.unpermute_velocity(un)
    want_u = _interleaved_to_planar(ur, space)
    np.testing.assert_allclose(got_u, want_u, rtol=0, atol=1e-10)
    got_p = fast.unpermute_pressure(p2)
    np.testing.assert_allclose(got_p, p, rtol=0, atol=1e-10)


def test_3d_matches_reference():
    """The banded engine is dimension-agnostic: 3D tetrahedral operators
    (structured box -> circulant under lex ordering) match the cell-loop
    layer to roundoff."""
    from navierstokes_tpu.mesh import hyper_cube

    mesh, _ = hyper_cube(3, 5)
    space = TaylorHoodSpace(mesh)
    fast = FastTaylorHood(space)
    _check_against_reference(space, fast)


def test_planar_step_amg_poisson():
    """poisson_precond="amg" reaches the Jacobi-converged trajectory at a
    fraction of the Poisson iteration count (h-independent V-cycle vs
    O(1/h) fixed Jacobi sweeps), on both pressure-BC classes:
    enclosed (mean-free deflated CG) and pressure-Dirichlet."""
    from navierstokes_tpu.fem.bcs import PressureBCType, VelocityBCType
    from navierstokes_tpu.fem.dirichlet import compile_dirichlet_bcs
    from navierstokes_tpu.mesh.generators import \
        HyperCubeBoundaryMarkers as M
    from navierstokes_tpu.solvers.planar_step import \
        build_planar_projection_step

    mesh, markers = hyper_cube(2, 24)
    space = TaylorHoodSpace(mesh)
    lid = lambda x: np.stack([np.ones(len(x)), np.zeros(len(x))], axis=1)
    vbc, _ = compile_dirichlet_bcs(space, markers, [
        (VelocityBCType.no_slip, M.left.value, None),
        (VelocityBCType.no_slip, M.right.value, None),
        (VelocityBCType.no_slip, M.bottom.value, None),
        (VelocityBCType.function, M.top.value, lid)], [])
    pbc, _ = compile_dirichlet_bcs(space, markers, [], [
        (PressureBCType.constant, M.right.value, 0.0)])
    n_u = space.n_velocity_dofs
    v_mask = np.zeros(n_u, bool)
    v_mask[np.asarray(vbc.dofs)] = True
    v_vals = np.zeros(n_u)
    v_vals[np.asarray(vbc.dofs)] = vbc.values()
    p_mask = np.zeros(space.n_pnodes, bool)
    p_mask[np.asarray(pbc.dofs) - space.pressure_offset] = True

    fast = FastTaylorHood(space)
    to_planar = lambda flat: jnp.asarray(np.asarray(flat).reshape(
        space.n_unodes, space.dim).T[:, fast.permU])

    u0 = np.zeros((space.n_unodes, space.dim))
    u0.reshape(-1)[v_mask] = v_vals[v_mask]
    dt64 = jnp.float64
    one = lambda v: jnp.asarray(v, dt64)
    alphas = [(one(1.0), one(-1.0), one(0.0)), (one(1.5), one(-2.0),
                                                one(0.5))]
    etas = [(one(1.0), one(0.0)), (one(2.0), one(-1.0))]

    for pm in (None, np.asarray(p_mask)[fast.permP]):
        common = dict(visc=1e-2, dt=1e-2,
                      vel_bc=(to_planar(v_mask), to_planar(v_vals)),
                      pres_bc_mask=pm, with_residuals=True)
        step_j = build_planar_projection_step(
            fast, cg_iters=(15, 400, 8), **common)
        step_a = build_planar_projection_step(
            fast, cg_iters=(15, 14, 8), poisson_precond="amg", **common)

        def run(step, n=3):
            u = fast.permute_velocity(jnp.asarray(u0.T, dt64))
            uo, p = u, jnp.zeros(space.n_pnodes, dt64)
            phi = jnp.zeros_like(p)
            res = None
            for i in range(n):
                a, e = (alphas[0], etas[0]) if i == 0 \
                    else (alphas[1], etas[1])
                un, p, phi, res = step(u, uo, p, phi, a, e)
                uo, u = u, un
            return u, p, np.asarray(res)

        u_j, p_j, _ = run(step_j)
        u_a, p_a, res_a = run(step_a)
        # 14 V-cycle-CG iterations track the 400-sweep Jacobi solution
        assert res_a[1] < 1e-8
        np.testing.assert_allclose(u_a, u_j, rtol=0, atol=1e-8)
        np.testing.assert_allclose(p_a, p_j, rtol=0, atol=1e-7)


def test_rim_gather_fallback(channel_space, monkeypatch):
    """NS_FASTOP_RIM_BYTES=0 forces the rectangular G/D couplings onto
    the sorted-COO gather path; every operator still matches the
    cell-loop layer to roundoff (the band-width of G/D grows with the
    grid line length, so large grids take this path automatically)."""
    from navierstokes_tpu.assembly.fastop import GatherOp

    monkeypatch.setenv("NS_FASTOP_RIM_BYTES", "0")
    fast = FastTaylorHood(channel_space)
    assert all(isinstance(op, GatherOp) for op in (*fast.G, *fast.D))
    _check_against_reference(channel_space, fast)


def test_circulant_scan_apply_matches_unrolled(periodic_space,
                                               monkeypatch):
    """Large bands lower the circulant apply as a lax.scan (the unrolled
    loop made 3D-scale programs too large to compile); both lowerings use
    the same accumulation order, differing only by compiler FMA
    contraction (last-bit)."""
    fast = FastTaylorHood(periodic_space)
    x = jnp.asarray(np.random.default_rng(3).standard_normal(
        (2, fast.K.n)), fast.K.band.dtype)
    y_unrolled = np.asarray(fast.K.apply(x))
    monkeypatch.setattr(CirculantBand, "_UNROLL_BUDGET", 0)
    y_scan = np.asarray(fast.K.apply(x))
    np.testing.assert_allclose(y_scan, y_unrolled, rtol=1e-12, atol=1e-12)
    y_jit = np.asarray(jax.jit(lambda op, v: op.apply(v))(fast.K, x))
    np.testing.assert_allclose(y_jit, y_unrolled, rtol=1e-12, atol=1e-12)


def test_planar_step_rotational_poiseuille_exact():
    """Rotational (Timmermans) pressure update: the steady Poiseuille
    channel is in the FE space, and both its velocity AND its linear
    pressure must be reproduced (div u* = 0 at the solution, so the
    rotational correction vanishes and the scheme remains exact).
    Reference scheme: Guermond/Minev/Shen 2006; prototype parity:
    scripts/test_ipcs_phi.py:115-139 (the phi-variant's rotational
    term)."""
    from navierstokes_tpu.fem.bcs import PressureBCType, VelocityBCType
    from navierstokes_tpu.fem.dirichlet import compile_dirichlet_bcs
    from navierstokes_tpu.mesh import hyper_rectangle
    from navierstokes_tpu.mesh.generators import \
        HyperCubeBoundaryMarkers as M
    from navierstokes_tpu.solvers.planar_step import \
        build_planar_projection_step

    Re = 10.0
    mesh, markers = hyper_rectangle((0.0, 0.0), (5.0, 1.0), (20, 6))
    space = TaylorHoodSpace(mesh)

    def inlet(x):
        return np.stack([6.0 * x[:, 1] * (1.0 - x[:, 1]),
                         np.zeros(len(x))], axis=1)

    vbc, _ = compile_dirichlet_bcs(space, markers, [
        (VelocityBCType.function, M.left.value, inlet),
        (VelocityBCType.no_slip, M.bottom.value, None),
        (VelocityBCType.no_slip, M.top.value, None)], [])
    pbc, _ = compile_dirichlet_bcs(space, markers, [], [
        (PressureBCType.constant, M.right.value, 0.0)])
    n_u = space.n_velocity_dofs
    v_mask = np.zeros(n_u, bool)
    v_mask[np.asarray(vbc.dofs)] = True
    v_vals = np.zeros(n_u)
    v_vals[np.asarray(vbc.dofs)] = vbc.values()
    p_mask = np.zeros(space.n_pnodes, bool)
    p_mask[np.asarray(pbc.dofs) - space.pressure_offset] = True

    fast = FastTaylorHood(space)
    to_planar = lambda flat: jnp.asarray(np.asarray(flat).reshape(
        space.n_unodes, space.dim).T[:, fast.permU])

    # start AT the exact solution: u = 6y(1-y), p = 12(L-x)/Re
    u0 = space.interpolate_velocity(inlet, t=None)
    p0 = space.interpolate_pressure(
        lambda x: 12.0 * (5.0 - x[:, 0]) / Re, t=None)

    dt64 = jnp.float64
    one = lambda v: jnp.asarray(v, dt64)
    a2 = (one(1.5), one(-2.0), one(0.5))
    e2 = (one(2.0), one(-1.0))
    step = build_planar_projection_step(
        fast, visc=1.0 / Re, dt=1e-2, cg_iters=(60, 400, 30),
        vel_bc=(to_planar(v_mask), to_planar(v_vals)),
        pres_bc_mask=np.asarray(p_mask)[fast.permP], rotational=True)
    u = fast.permute_velocity(jnp.asarray(np.asarray(u0).T, dt64))
    uo = u
    p = fast.permute_pressure(jnp.asarray(np.asarray(p0), dt64))
    phi = jnp.zeros_like(p)
    for _ in range(4):
        un, p, phi = step(u, uo, p, phi, a2, e2)
        uo, u = u, un
    u_back = np.asarray(fast.unpermute_velocity(u)).T
    p_back = np.asarray(fast.unpermute_pressure(p))
    assert np.abs(u_back - np.asarray(u0)).max() < 1e-8
    assert np.abs(p_back - np.asarray(p0)).max() < 1e-6


def test_strided_convection_matches_gather(periodic_space):
    """Translation-class (padded static-slice) convection == cell gather."""
    from navierstokes_tpu.assembly.fastop import conv_apply

    fast = FastTaylorHood(periodic_space)
    assert fast.conv_strided is not None, \
        "periodic uniform box must detect the strided layout"
    assert len(fast.conv_strided.offs) == 2    # two triangle classes
    rng = np.random.default_rng(11)
    u = jnp.asarray(rng.standard_normal((2, periodic_space.n_unodes)))
    a = conv_apply(fast.ops, u, 1.3)
    b = conv_apply(fast.ops, u, 1.3, strided=fast.conv_strided)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-13)


def test_strided_convection_not_detected_on_channel(channel_space):
    fast = FastTaylorHood(channel_space)
    assert fast.conv_strided is None


def test_combine_circulant_matches_sum(periodic_space):
    from navierstokes_tpu.assembly.fastop import combine_circulant

    fast = FastTaylorHood(periodic_space)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal(periodic_space.n_unodes))
    a0, nu = jnp.asarray(317.2), jnp.asarray(0.013)
    H = combine_circulant([(a0, fast.M), (nu, fast.K)])
    want = a0 * fast.M.apply(x) + nu * fast.K.apply(x)
    np.testing.assert_allclose(np.asarray(H.apply(x)), np.asarray(want),
                               atol=1e-10)


def test_stencil_coupling_detected_and_exact(periodic_space):
    """G/D on the periodic torus lower to class-constant stencils (O(1)
    storage) and reproduce the CSR couplings exactly."""
    from navierstokes_tpu.assembly.fastop import StencilCoupling

    fast = FastTaylorHood(periodic_space)
    assert all(isinstance(g, StencilCoupling) for g in fast.G)
    assert all(isinstance(d, StencilCoupling) for d in fast.D)
    assert sum(g.nbytes for g in fast.G) < 1024   # taps, not bands

    space = periodic_space
    rng = np.random.default_rng(3)
    p = rng.standard_normal(space.n_pnodes)
    u = rng.standard_normal(space.n_unodes)
    for d in range(space.dim):
        ref = FastTaylorHood(space, circulant_cap=0)  # AffineBand G/D
        got = np.asarray(fast.G[d].apply(jnp.asarray(
            p[fast.permP], fast.G[d].weights.dtype)))
        want = np.asarray(ref.G[d].apply(jnp.asarray(
            p[ref.permP], dtype=got.dtype)))
        # orderings may differ between the two instances; compare in
        # the unpermuted numbering
        np.testing.assert_allclose(got[fast.invU], want[ref.invU],
                                   atol=1e-11)
        gotd = np.asarray(fast.D[d].apply(jnp.asarray(
            u[fast.permU], fast.D[d].weights.dtype)))
        wantd = np.asarray(ref.D[d].apply(jnp.asarray(
            u[ref.permU], dtype=gotd.dtype)))
        np.testing.assert_allclose(gotd[fast.invP], wantd[ref.invP],
                                   atol=1e-11)
