"""Component tests: numerics accuracy of the mesh discretisation,
remapping, and mass-conservation machinery, with scoreboard output.

Re-design of src/UPSY/validation/component_tests/
(ct_create_test_meshes.f90, ct_discretisation_mapping_derivatives.f90:1-562,
ct_discretisation_solve_Laplace_eq.f90:1-225, ct_remapping_*.f90) and
src/UFEMISM/validation/component_tests/ct_mass_conservation.f90:1-397.
Each test measures RMSEs of the discrete result against an analytic
expectation and writes them to the scoreboard. The mesh, operator and
remapping tiers are host work (numpy/scipy, as in the reference's own
tests); the mass-conservation tier runs the model's device functions.
"""

from __future__ import annotations

import numpy as np

from .scoreboard import ScoreboardRun
from ..utils.constants import pi


# ---------------------------------------------------------------------------
# Test meshes (ct_create_test_meshes.f90: Antarctic domain, uniform set +
# resolution gradients)
# ---------------------------------------------------------------------------

DOMAIN = dict(xmin=-3040e3, xmax=3040e3, ymin=-3040e3, ymax=3040e3)
UNIFORM_RESOLUTIONS = [400e3, 300e3, 200e3]


def create_test_meshes(resolutions=None, gradients=True):
    """[(name, mesh)] suite."""
    from ..mesh import build_uniform_mesh
    from ..mesh.refinement import refine_mesh, lloyds_algorithm
    from ..mesh.refinement import UniformCriterion
    from ..mesh.mesh_types import mesh_from_points, renumber_mesh_morton

    out = []
    for res in (resolutions or UNIFORM_RESOLUTIONS):
        m = build_uniform_mesh(DOMAIN["xmin"], DOMAIN["xmax"],
                               DOMAIN["ymin"], DOMAIN["ymax"], res)
        out.append((f"mesh_Ant_uniform_{res:.4E}_m", m))

    if gradients:
        for orientation in ("x", "y"):
            # resolution gradient 400 km -> 75 km across the domain
            m = _gradient_mesh(orientation)
            out.append((f"mesh_Ant_gradient_{orientation}", m))
    return out


def _gradient_mesh(orientation, res_min=400e3, res_max=150e3, n_bands=4):
    """Resolution-gradient mesh (create_test_mesh_gradient): bands of
    successively finer target resolution across the domain, built with
    the production refinement pipeline."""
    from ..mesh.mesh_types import mesh_from_points, renumber_mesh_morton
    from ..mesh.refinement import (refine_mesh, lloyds_algorithm,
                                   UniformCriterion, PolygonCriterion)
    x0, x1 = DOMAIN["xmin"], DOMAIN["xmax"]
    y0, y1 = DOMAIN["ymin"], DOMAIN["ymax"]
    crits = [UniformCriterion(res_min)]
    for i in range(1, n_bands + 1):
        res = res_min + (res_max - res_min) * i / n_bands
        frac = i / (n_bands + 1)
        if orientation == "x":
            bx0 = x0 + frac * (x1 - x0)
            poly = np.array([[bx0, y0], [x1, y0], [x1, y1], [bx0, y1]])
        else:
            by0 = y0 + frac * (y1 - y0)
            poly = np.array([[x0, by0], [x1, by0], [x1, y1], [x0, y1]])
        crits.append(PolygonCriterion(poly=poly, res=res))
    V = refine_mesh(x0, x1, y0, y1, crits)
    V = lloyds_algorithm(V, x0, x1, y0, y1, nit=2)
    m = mesh_from_points(V, x0, x1, y0, y1)
    return renumber_mesh_morton(m)


# ---------------------------------------------------------------------------
# Test functions (ct_discretisation_mapping_derivatives.f90:496-560)
# ---------------------------------------------------------------------------

def test_function_linear(x, y, xmin, xmax, ymin, ymax):
    c1 = 2.0 / (xmax - xmin)
    c2 = 3.0 / (ymax - ymin)
    z = np.zeros_like(x)
    return (c1 * x + c2 * y, c1 + z, c2 + z, z, z, z)


def test_function_quadratic(x, y, xmin, xmax, ymin, ymax):
    c1 = 2.0 / (xmax - xmin)
    c2 = 3.0 / (ymax - ymin)
    c3 = 5.0 / (ymax - ymin)
    z = np.zeros_like(x)
    return ((c1 * x) ** 2 + (c2 * y) ** 2 + c3 * x * y,
            2 * c1 ** 2 * x + c3 * y,
            2 * c2 ** 2 * y + c3 * x,
            2 * c1 ** 2 + z, c3 + z, 2 * c2 ** 2 + z)


def test_function_periodic(x, y, xmin, xmax, ymin, ymax):
    c1 = 2.0 * pi / (xmax - xmin)
    c2 = 3.0 * pi / (ymax - ymin)
    sx, cx = np.sin(c1 * (x - xmin)), np.cos(c1 * (x - xmin))
    sy, cy = np.sin(c2 * (y - ymin)), np.cos(c2 * (y - ymin))
    return (sx * sy, c1 * cx * sy, sx * c2 * cy,
            -(c1 ** 2) * sx * sy, c1 * cx * c2 * cy, -(c2 ** 2) * sx * sy)


TEST_FUNCTIONS = {"linear": test_function_linear,
                  "quadratic": test_function_quadratic,
                  "periodic": test_function_periodic}


# ---------------------------------------------------------------------------
# Discretisation: mapping / derivative accuracy
# ---------------------------------------------------------------------------

def _interior(mesh, pts, margin=0.05):
    w = margin * (mesh.xmax - mesh.xmin)
    return ((pts[:, 0] > mesh.xmin + w) & (pts[:, 0] < mesh.xmax - w)
            & (pts[:, 1] > mesh.ymin + w) & (pts[:, 1] < mesh.ymax - w))


def run_map_deriv_tests(mesh, mesh_name, scoreboard_dir=None):
    """RMSEs of every map/ddx/ddy (+2nd-order b-grid) operator against
    each analytic test function
    (ct_discretisation_mapping_derivatives.f90:115-200). Interior
    vertices only (the reference's low-order boundary rows are excluded
    from its cost functions via the masked writers)."""
    from ..mesh.operators import build_all_matrix_operators
    if mesh.operators is None:
        mesh.operators = build_all_matrix_operators(mesh)
    ops = mesh.operators
    dom = (mesh.xmin, mesh.xmax, mesh.ymin, mesh.ymax)

    grids = {"a": mesh.V, "b": mesh.TriGC, "c": mesh.E}
    int_mask = {g: _interior(mesh, pts) for g, pts in grids.items()}

    runs = []
    for fname, fn in TEST_FUNCTIONS.items():
        ex = {g: fn(pts[:, 0], pts[:, 1], *dom)
              for g, pts in grids.items()}
        run = ScoreboardRun(
            name=f"{mesh_name}_{fname}",
            category="component_tests/discretisation/"
                     "mapping_and_derivatives")

        def rmse(M, src_grid, dst_grid, k):
            d = M @ ex[src_grid][0]
            e = ex[dst_grid][k]
            m = int_mask[dst_grid]
            return float(np.sqrt(((d - e)[m] ** 2).mean()))

        for op_name, src, dst, k in [
                ("map_a_b", "a", "b", 0), ("map_b_a", "b", "a", 0),
                ("map_a_c", "a", "c", 0), ("map_b_c", "b", "c", 0),
                ("ddx_a_a", "a", "a", 1), ("ddy_a_a", "a", "a", 2),
                ("ddx_a_b", "a", "b", 1), ("ddy_a_b", "a", "b", 2),
                ("ddx_b_a", "b", "a", 1), ("ddy_b_a", "b", "a", 2),
                ("ddx_b_b", "b", "b", 1), ("ddy_b_b", "b", "b", 2),
                ("M2_ddx_b_b", "b", "b", 1), ("M2_ddy_b_b", "b", "b", 2),
                ("M2_d2dx2_b_b", "b", "b", 3),
                ("M2_d2dxdy_b_b", "b", "b", 4),
                ("M2_d2dy2_b_b", "b", "b", 5)]:
            attr = op_name if op_name.startswith("M2") else "M_" + op_name
            M = getattr(ops, attr, None)
            if M is None:
                continue
            run.add_cost_function(
                f"rmse_{op_name}",
                f"sqrt(mean((M_{op_name} @ f - exact)^2)) interior",
                rmse(M, src, dst, k))
        if scoreboard_dir:
            run.write(scoreboard_dir)
        runs.append(run)
    return runs


# ---------------------------------------------------------------------------
# Discretisation: Laplace-equation solve
# ---------------------------------------------------------------------------

def run_laplace_test(mesh, mesh_name, scoreboard_dir=None):
    """Solve d2f/dx2 + d2f/dy2 = c inside r<r0 with exact Dirichlet ring,
    compare to f = -c/4 r0^2 + c/4 (x^2+y^2)
    (ct_discretisation_solve_Laplace_eq.f90:70-180)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    from ..mesh.operators import build_all_matrix_operators
    if mesh.operators is None:
        mesh.operators = build_all_matrix_operators(mesh)
    ops = mesh.operators

    c = -1e-9
    r0 = mesh.xmax * 0.8
    x = mesh.TriGC[:, 0]
    y = mesh.TriGC[:, 1]
    f_ex = -c / 4.0 * r0 ** 2 + c / 4.0 * (x ** 2 + y ** 2)

    L = (ops.M2_d2dx2_b_b + ops.M2_d2dy2_b_b).tocsr()
    inside = np.sqrt(x ** 2 + y ** 2) < r0
    A = L.tolil()
    b = np.full(mesh.nTri, c)
    for ti in np.flatnonzero(~inside):
        A.rows[ti] = [ti]
        A.data[ti] = [1.0]
        b[ti] = f_ex[ti]
    A = A.tocsr()
    f_disc = spla.spsolve(A, b)
    rmse = float(np.sqrt(((f_disc - f_ex)[inside] ** 2).mean()))

    run = ScoreboardRun(name=mesh_name,
                        category="component_tests/discretisation/"
                                 "solve_Laplace_eq")
    run.add_cost_function("rmse_Laplace",
                          "sqrt(mean((f_disc - f_ex)^2)) inside r0", rmse)
    if scoreboard_dir:
        run.write(scoreboard_dir)
    return run


# ---------------------------------------------------------------------------
# Remapping accuracy + conservation
# ---------------------------------------------------------------------------

def run_remapping_tests(mesh_src, mesh_dst, name, scoreboard_dir=None):
    """mesh->mesh, mesh->grid, grid->mesh 2nd-order conservative remaps of
    the periodic test function: accuracy RMSE + global conservation error
    (ct_remapping_*.f90; the integral of the field must be preserved)."""
    from ..remap.atlas import get_map
    from ..mesh.grids import setup_square_grid

    dom = (mesh_src.xmin, mesh_src.xmax, mesh_src.ymin, mesh_src.ymax)
    # offset keeps the global integral away from zero so the relative
    # conservation error is well-defined
    fn = lambda x, y, *d: \
        tuple(v + (2.0 if i == 0 else 0.0) for i, v in
              enumerate(test_function_periodic(x, y, *d)))
    grid = setup_square_grid(*dom, dx=250e3)
    gc = grid.centres()

    f_src = fn(mesh_src.V[:, 0], mesh_src.V[:, 1], *dom)[0]
    f_dst_ex = fn(mesh_dst.VorGC[:, 0], mesh_dst.VorGC[:, 1], *dom)[0]
    f_grid = fn(gc[:, 0], gc[:, 1], *dom)[0]

    run = ScoreboardRun(name=name, category="component_tests/remapping")

    def add(tag, M, f, A_src, A_dst, f_ex, interior):
        d = M @ f
        rmse = float(np.sqrt(((d - f_ex)[interior] ** 2).mean()))
        cons = abs(float((d * A_dst).sum() - (f * A_src).sum())) \
            / max(abs(float((f * A_src).sum())), 1e-300)
        run.add_cost_function(f"rmse_{tag}", "remap accuracy RMSE", rmse)
        run.add_cost_function(f"conservation_{tag}",
                              "|int dst - int src| / |int src|", cons)

    # grid cell areas clipped to the mesh domain (the outermost cells
    # overhang the domain rectangle; only the overlapping part holds mass)
    def clipped_len(c, h, lo, hi):
        return np.maximum(0.0, np.minimum(c + h, hi) - np.maximum(c - h, lo))
    wx = clipped_len(gc[:, 0], grid.dx / 2, dom[0], dom[1])
    wy = clipped_len(gc[:, 1], grid.dy / 2, dom[2], dom[3])
    A_grid = wx * wy
    add("mesh_to_mesh", get_map(mesh_src, mesh_dst), f_src,
        mesh_src.A, mesh_dst.A, f_dst_ex, _interior(mesh_dst, mesh_dst.V))
    add("mesh_to_grid", get_map(mesh_src, grid), f_src,
        mesh_src.A, A_grid,
        fn(gc[:, 0], gc[:, 1], *dom)[0],
        np.ones(grid.n, bool))
    add("grid_to_mesh", get_map(grid, mesh_dst), f_grid,
        A_grid, mesh_dst.A, f_dst_ex, _interior(mesh_dst, mesh_dst.V))

    if scoreboard_dir:
        run.write(scoreboard_dir)
    return run


# ---------------------------------------------------------------------------
# Mass conservation (ct_mass_conservation.f90)
# ---------------------------------------------------------------------------

def _test_ice_sheet(mesh, which):
    """(Hi, u_vav_b, v_vav_b, dHi_dt_ex) (:293-395)."""
    from ..core.analytical import halfar_H, halfar_dHdt, halfar_u_vav
    xv, yv = mesh.V[:, 0], mesh.V[:, 1]
    xt, yt = mesh.Tricc[:, 0], mesh.Tricc[:, 1]
    if which == "linear":
        u0, H0 = 1.0 / 2000.0, 1000.0
        Hi = np.full(mesh.nV, H0)
        dHi_dt_ex = np.full(mesh.nV, -2.0 * u0 * H0)
        return Hi, u0 * xt, u0 * yt, dHi_dt_ex
    if which == "periodic":
        u0, H0 = 1000.0, 1000.0
        lam = 4.0 * (mesh.xmax - mesh.xmin) / (2 * pi)
        H = H0 * (2.0 + np.sin(3 * pi * xv / lam) * np.sin(3 * pi * yv / lam))
        dH_dx = 3 * pi * H0 / lam * np.cos(3 * pi * xv / lam) \
            * np.sin(3 * pi * yv / lam)
        dH_dy = 3 * pi * H0 / lam * np.sin(3 * pi * xv / lam) \
            * np.cos(3 * pi * yv / lam)
        u = u0 * np.sin(2 * pi * xv / lam)
        v = u0 * np.sin(2 * pi * yv / lam)
        du_dx = 2 * pi * u0 / lam * np.cos(2 * pi * xv / lam)
        dv_dy = 2 * pi * u0 / lam * np.cos(2 * pi * yv / lam)
        dHi_dt_ex = -(H * du_dx + u * dH_dx + H * dv_dy + v * dH_dy)
        return (H, u0 * np.sin(2 * pi * xt / lam),
                u0 * np.sin(2 * pi * yt / lam), dHi_dt_ex)
    # Halfar
    A, n, H0, R0, t = 1e-16, 3.0, 6000.0, 1500e3, 0.0
    Hi = halfar_H(A, n, H0, R0, xv, yv, t)
    dHi_dt_ex = halfar_dHdt(A, n, H0, R0, xv, yv, t)
    u, v = halfar_u_vav(A, n, H0, R0, xt, yt, t)
    return Hi, u, v, dHi_dt_ex


def run_mass_conservation_test(mesh, mesh_name, scoreboard_dir=None,
                               device="cuda"):
    """dHi/dt RMSE vs exact for the explicit / semi-implicit / implicit /
    over-implicit integration methods on analytic test ice sheets
    (ct_mass_conservation.f90:150-290; BASELINE.md row 'Component tests:
    dHi/dt RMSE'), in f64 on `device`: the upwind divergence and the
    semi-implicit thickness solve (BiCGSTAB) run there."""
    import torch
    from ..config import Config
    from ..core.mesh_data import build_mesh_data
    from ..core.ice.mass import calc_divQ_upwind, calc_dHi_dt_semiimplicit
    from ..ops import resolve_device

    device = resolve_device(device)
    md = build_mesh_data(mesh, dtype=torch.float64, device=device)
    kw = dict(dtype=torch.float64, device=device)
    runs = []
    for which in ("linear", "periodic", "Halfar"):
        Hi, u_b, v_b, dHi_dt_ex = _test_ice_sheet(mesh, which)
        Hi_t = torch.as_tensor(Hi, **kw)
        u_t = torch.as_tensor(u_b, **kw)
        v_t = torch.as_tensor(v_b, **kw)
        fm = torch.ones(mesh.nV, **kw)
        zeros = torch.zeros(mesh.nV, **kw)
        Hb = torch.zeros(mesh.nV, **kw)
        SL = torch.full((mesh.nV,), -100.0, **kw)
        noice = torch.zeros(mesh.nV, dtype=torch.bool, device=device)
        dt = 0.1
        interior = _interior(mesh, mesh.V) & (np.abs(dHi_dt_ex) > 0)

        run = ScoreboardRun(name=f"{mesh_name}_{which}",
                            category="component_tests/mass_conservation")

        divQ = calc_divQ_upwind(md, Hi_t, u_t, v_t, fm).cpu().numpy()
        rmse_expl = float(np.sqrt(
            ((-divQ - dHi_dt_ex)[interior] ** 2).mean()))
        run.add_cost_function("rmse_dHi_dt_explicit",
                              "RMSE(-divQ - dHi_dt_exact)", rmse_expl)

        for fs, tag in ((0.5, "semiimplicit"), (1.0, "implicit"),
                        (1.5, "overimplicit")):
            C = Config(dHi_semiimplicit_fs=fs)
            dHi_dt_si = calc_dHi_dt_semiimplicit(
                C, md, Hi_t, Hb, SL, u_t, v_t,
                zeros, zeros, zeros, zeros, fm, noice, dt, zeros)[0]
            arr = dHi_dt_si.cpu().numpy()
            rmse = float(np.sqrt(((arr - dHi_dt_ex)[interior] ** 2).mean()))
            run.add_cost_function(f"rmse_dHi_dt_{tag}",
                                  f"RMSE(dHi_dt_{tag} - exact), fs={fs}",
                                  rmse)
        if scoreboard_dir:
            run.write(scoreboard_dir)
        runs.append(run)
    return runs


# ---------------------------------------------------------------------------
# The programs: every tier in one call
# ---------------------------------------------------------------------------

def run_all_component_tests(scoreboard_dir, resolutions=None,
                            verbose=True, device="cuda"):
    """The component-test program (UPSY_component_test_program_*.f90):
    create the test-mesh suite and run every tier on it; the mass
    conservation tier on `device`, the others on the host (scipy)."""
    from ..ops import resolve_device
    device = resolve_device(device)     # before anything is written
    runs = []
    meshes = create_test_meshes(resolutions=resolutions)
    for name, mesh in meshes:
        runs += run_map_deriv_tests(mesh, name, scoreboard_dir)
        runs.append(run_laplace_test(mesh, name, scoreboard_dir))
    # remapping between the two finest meshes
    if len(meshes) >= 2:
        runs.append(run_remapping_tests(
            meshes[-1][1], meshes[0][1],
            f"{meshes[-1][0]}_to_{meshes[0][0]}", scoreboard_dir))
    # mass conservation on the coarsest uniform mesh (the reference's
    # 300 km uniform Antarctic mesh)
    runs += run_mass_conservation_test(meshes[min(1, len(meshes) - 1)][1],
                                       meshes[min(1, len(meshes) - 1)][0],
                                       scoreboard_dir, device=device)
    if verbose:
        for r in runs:
            print(r.summary())
    return runs
