"""The design of the `heat_columns` kernel (csrc/heat_columns.cu), written
as plain tensor code and held to the bit against `heat_columns_plain`.

`heat_columns_sketch` below is the kernel's specification. It reorders the
work of the reference's solve without changing a single rounding:

- one factorisation per ladder level: the tridiagonal matrix of a level
  is the same in every substep and for both basal boundary conditions
  (`lo` and `up` are fixed, `diag` depends on dt_i only, the boundary rows
  are identity rows), so `den` (with the 1e-300 clamp) and `cp` are formed
  once, with the operations of `thomas_batched` in its order, and reused;
- one right-hand side a substep, shared by both boundary conditions: they
  differ in the basal row only, so the forward sweep is shared up to the
  row above it and splits into two values there, then two back
  substitutions; the basal value is chosen per column (the kernel's lane),
  and only subgrid-mixed columns use the second one;
- levels run independently (the kernel runs levels 0-3 on one lane of a
  column and level 4 on a second one) and the first stable level wins;
- the non-finite exit: once a level's carry holds a non-finite value in
  an interior row, every later substep of that level stays non-finite
  (b_k is non-finite, so dp_k and then x_k are, for both boundary
  conditions and their mix), so the level is unstable and stops there.

The operands cover the three grounding-line rules, float32 and float64
fields, nz 7, 12 and 15, dt 1 and 0.1, inf and NaN in every operand that
can carry one, and columns whose factorisation hits the 1e-300 clamp or
overflows.
"""

import numpy as np
import pytest
import torch

from ufemism2_tpu_torch.mesh.zeta import setup_zeta_grid
from ufemism2_tpu_torch.ops import cuda_heat
from ufemism2_tpu_torch.ops.tridiag import (thomas_batched,
                                           zeta_tridiag_operators)
from ufemism2_tpu_torch.utils.constants import T0

N_LEVELS = 5
# operands that can carry a non-finite value, with the rows it is put in
PLACEMENTS = [("rhs", 0), ("rhs", "interior"), ("rhs", -1), ("Ti", 0),
              ("Ti", "interior"), ("Ti", -1), ("T_surf", None),
              ("q_base", None), ("T_base_float", None),
              ("fraction_gr", None)]
ARG = {name: j for j, name in enumerate(
    ("Ti", "c_dd", "c_d2", "rhs", "T_surf", "q_base", "T_base_float",
     "Ti_pmp", "grounded", "floating", "gl_gr", "fraction_gr", "thin",
     "T_robin", "zrows"))}


def _like(x, value):
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _stable(T):
    return (torch.isfinite(T) & (T >= 180.0) & (T <= T0)).all(dim=1)


def factorise(diag, lo, up):
    """den (clamped) and cp of the forward sweep, formed once per level
    with thomas_batched's operations in its order: [m, nz] each."""
    den, cp = [], []
    c_prev = torch.zeros_like(diag[:, 0])
    for k in range(diag.shape[1]):
        d = diag[:, k] - lo[:, k] * c_prev
        d = torch.where(torch.abs(d) < 1e-300, 1e-300, d)
        c_prev = up[:, k] / d
        den.append(d)
        cp.append(c_prev)
    return torch.stack(den, 1), torch.stack(cp, 1)


def solve_factorised(den, cp, lo, b, base_1, base_2):
    """One substep's solves on a reused factorisation: the forward sweep
    over the rows above the basal one, shared by both right-hand sides,
    then the basal row with base_1 and with base_2, then two back
    substitutions: ([m, nz], [m, nz]) float64."""
    nz = b.shape[1]
    dp = torch.zeros_like(den[:, 0])
    dps = []
    for k in range(nz - 1):
        dp = (b[:, k] - lo[:, k] * dp) / den[:, k]
        dps.append(dp)
    xs = []
    for base in (base_1, base_2):
        x = (base - lo[:, -1] * dp) / den[:, -1]
        x = x - cp[:, -1] * torch.zeros_like(x)
        col = [x]
        for k in range(nz - 2, -1, -1):
            x = dps[k] - cp[:, k] * x
            col.append(x)
        xs.append(torch.stack(col[::-1], 1))
    return xs


def heat_columns_sketch(Ti, c_dd, c_d2, rhs, T_surf, q_base, T_base_float,
                        Ti_pmp, grounded, floating, gl_gr, fraction_gr, thin,
                        T_robin, zrows, dt, gl_bc="grounded", exit_early=True):
    """The kernel's algorithm on tensors: (Ti_new [n, nz] float64,
    n_unstable int32, info). info["exits"] counts the levels stopped by the
    non-finite exit; info["late_nonfinite"] (exit_early=False only) marks,
    per level, the columns whose carry went non-finite in an interior row
    before the level's last substep."""
    n, nz = Ti.shape
    f64 = torch.float64
    # level-invariant rows (the kernel keeps them in shared memory)
    l1, u1, l2, u2 = (zrows[j, :nz - 1] for j in (0, 2, 3, 5))
    lo = torch.zeros(n, nz, dtype=f64)
    up = torch.zeros(n, nz, dtype=f64)
    lo[:, 1:] = c_dd[:, 1:] * l1[None, :] + c_d2[:, 1:] * l2[None, :]
    up[:, :-1] = c_dd[:, :-1] * u1[None, :] + c_d2[:, :-1] * u2[None, :]
    lo[:, nz - 1] = 0.0
    up[:, 0] = 0.0
    p1, p2 = c_dd * zrows[1][None, :], c_d2 * zrows[4][None, :]
    sel = torch.where(gl_gr, cuda_heat.GL_BC.get(gl_bc, 2),
                      torch.where(floating & ~grounded, 1, 0))
    b_surf = torch.clamp(T_surf, max=T0)
    base_f = torch.minimum(T_base_float, Ti_pmp[:, nz - 1])
    fg = fraction_gr[:, None]
    solved = ~thin
    ok = torch.zeros(n, dtype=torch.bool)
    T_out = T_robin.clone()
    info = {"exits": 0, "late_nonfinite": []}

    for lev in range(N_LEVELS):
        dt_i = dt * 0.5 ** lev
        # lane A walks levels 0-3 until one is stable; lane B level 4
        idx = torch.nonzero(solved & ~ok if lev < 4 else solved)[:, 0]
        diag = 1.0 / dt_i + p1[idx] + p2[idx]
        diag[:, 0] = 1.0
        diag[:, nz - 1] = 1.0
        den, cp = factorise(diag, lo[idx], up[idx])
        live = torch.arange(len(idx))        # rows of idx still running
        T = Ti[idx]
        late = torch.zeros(n, dtype=torch.bool)
        for s in range(2 ** lev):
            i = idx[live]
            b = rhs[i] + T / _like(T, dt_i)   # shared by both conditions
            b[:, 0] = b_surf[i]
            # per-column basal values, in b's type
            base_g = torch.minimum(Ti_pmp[i, nz - 1], T[:, nz - 2] - q_base[i])
            base_1 = torch.where(sel[i] == 1, base_f[i], base_g).to(b.dtype)
            base_2 = base_f[i].to(b.dtype)
            T1, T2 = solve_factorised(den[live], cp[live], lo[i], b, base_1,
                                      base_2)
            mix = fg[i] * T1 + (1 - fg[i]) * T2
            T = torch.where((sel[i] == 2)[:, None], mix, T1)
            if s == 2 ** lev - 1:
                break
            gone = ~torch.isfinite(T[:, 1:-1]).all(dim=1)
            if exit_early:
                # the non-finite exit: these columns' level is unstable
                info["exits"] += int(gone.sum())
                live, T = live[~gone], T[~gone]
            else:
                late[i[gone]] = True
        info["late_nonfinite"].append((late, ~_stable(T), idx[live]))
        i = idx[live]
        take = _stable(T) & ~ok[i]
        T_out[i[take]] = T[take]
        ok[i[take]] = True

    T_out = torch.where(thin[:, None], T_surf[:, None], T_out)
    T_out = torch.minimum(T_out, Ti_pmp)
    n_unstable = (~ok & ~thin).sum().to(torch.int32)
    return T_out, n_unstable, info


def operands(nz, dtype, gl_bc, dt, rng, n=96):
    """Physical columns (as chip_smoke.py's heat_operands makes them) with
    unstable ones (infinite or huge heating, strong advection), the four
    kinds of column, thin ice, and the factorisation's edge cases: a column
    whose pivot is exactly 0 at level 0 (the 1e-300 clamp) and one whose
    cp overflows to inf."""
    zeta = setup_zeta_grid("irregular_log", nz)[0]
    zeta = np.asarray(zeta, np.float32 if dtype == torch.float32
                      else np.float64)
    H = rng.uniform(5.0, 3000.0, n)
    pmp = T0 - 8.7e-4 * H[:, None] * zeta[None, :]
    Ti = np.minimum(240.0 + 30.0 * rng.random((n, nz)), pmp)
    c_dd = rng.standard_normal((n, nz)) * 3e-4 \
        * (1.0 + 1e3 * (rng.random((n, 1)) < 0.15))
    c_d2 = -36.0 / H[:, None] ** 2 * (1.0 + rng.random((n, nz)))
    rhs = rng.standard_normal((n, nz)) * 1e-2
    rhs[rng.random(n) < 0.05] = np.inf
    rhs[rng.random(n) < 0.1] *= 1e6
    kind = rng.integers(0, 4, n)
    masks = [kind == 0, kind == 1, (kind == 2) | (rng.random(n) < 0.05),
             H < 10.0 + 290.0 * (rng.random(n) < 0.05)]
    zrows = cuda_heat.zeta_rows(zeta_tridiag_operators(zeta), "cpu")
    # row 1 with d1 = 1, d2 = -1: diag = 1/dt + c_dd - c_d2, exactly 0 at
    # level 0 in columns 0 and 1 (the 1e-300 clamp); column 0's
    # cp = up / 1e-300 stays finite, column 1's (up about 2e9) overflows
    zrows[1, 1], zrows[4, 1] = 1.0, -1.0
    c_dd[:2, 1] = (0.5, 2.0 ** 23)
    c_d2[:2, 1] = 1.0 / dt + c_dd[:2, 1]
    masks[3][:2] = False
    t = lambda a, dt_=dtype: torch.as_tensor(np.asarray(a), dtype=dt_)
    return [t(Ti), t(c_dd), t(c_d2), t(rhs), t(rng.uniform(230.0, 280.0, n)),
            t(-rng.uniform(0.5, 5.0, n), torch.float64), t(pmp[:, -1]),
            t(pmp), *(t(m, torch.bool) for m in masks[:3]),
            t(rng.random(n)), t(masks[3], torch.bool),
            t(240.0 + 20.0 * rng.random((n, nz)), torch.float64), zrows,
            dt, gl_bc]


def place(args, name, row, value, rng):
    """`value` in a few solved columns of operand `name` (in `row` of an
    [n, nz] operand: 0, an interior row or nz-1)."""
    a = args[ARG[name]].clone()
    nz = args[0].shape[1]
    cols = torch.as_tensor(rng.choice(np.arange(4, a.shape[0]), 6,
                                      replace=False))
    if a.ndim == 1:
        a[cols] = value
    else:
        k = int(rng.integers(1, nz - 1)) if row == "interior" else row % nz
        a[cols, k] = value
    args[ARG[name]] = a
    args[ARG["thin"]] = args[ARG["thin"]].clone()
    args[ARG["thin"]][cols] = False
    if name == "fraction_gr":          # only mixed columns read it
        args[ARG["gl_gr"]] = args[ARG["gl_gr"]].clone()
        args[ARG["gl_gr"]][cols] = True
    return args


def place_every(args, rng, inf=float("inf")):
    """Every placement of PLACEMENTS, `inf` (+inf or -inf) in half of them
    and NaN in the other (chip_smoke.py runs the kernel on these operands
    too)."""
    for j, (name, row) in enumerate(PLACEMENTS):
        value = inf if j % 2 else float("nan")
        if name == "q_base" and j % 2:
            value = -value        # T_in - q_base = inf: the pmp cap holds
                                  # (-inf with inf=-inf)
        args = place(args, name, row, value, rng)
    return args


def _assert_bit_equal(a, b):
    """Equal to the bit (signed zeros told apart), NaN where NaN."""
    assert a.dtype == b.dtype == torch.float64 and a.shape == b.shape
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    assert torch.equal(nan_a, nan_b)
    assert torch.equal(a[~nan_a].view(torch.int64), b[~nan_b].view(torch.int64))


def _check(args):
    ref, n_ref = cuda_heat.heat_columns_plain(*args)
    out, n_out, info = heat_columns_sketch(*args)
    _assert_bit_equal(out, ref)
    assert int(n_out) == int(n_ref)
    return out, int(n_ref), info


@pytest.mark.parametrize("nz", [7, 12, 15])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("gl_bc", ["grounded", "pmp", "subgrid"])
@pytest.mark.parametrize("dt", [1.0, 0.1])
def test_sketch_bit_equal_to_plain(nz, dtype, gl_bc, dt):
    """Every rule, type, column count and dt, with every non-finite
    placement of PLACEMENTS (inf in half of them, NaN in the other) and the
    clamped and overflowing factorisations in one set of operands."""
    rng = np.random.default_rng([nz, int(dtype == torch.float64),
                                 len(gl_bc), int(10 * dt)])
    args = place_every(operands(nz, dtype, gl_bc, dt, rng), rng)
    _, n_unstable, info = _check(args)
    assert 0 < n_unstable < int((~args[ARG["thin"]]).sum())
    assert info["exits"] > 0


@pytest.mark.parametrize("value", [float("inf"), -float("inf"),
                                   float("nan")], ids=["inf", "-inf", "nan"])
@pytest.mark.parametrize("j", range(len(PLACEMENTS)),
                         ids=[f"{n}-{r}" for n, r in PLACEMENTS])
def test_sketch_non_finite_placement(j, value):
    """One placement at a time, in f32 fields with the subgrid mix (every
    operand read) and dt 1."""
    name, row = PLACEMENTS[j]
    rng = np.random.default_rng(j)
    args = operands(12, torch.float32, "subgrid", 1.0, rng)
    _check(place(args, name, row, value, rng))


@pytest.mark.parametrize("dt", [1.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_factorisation_edge_cases(dtype, dt):
    """Columns 0 and 1 have a level-0 pivot of exactly 0 in row 1, which
    takes the 1e-300 clamp; column 1's cp then overflows. Their substeps on
    the reused factorisation equal thomas_batched's solves to the bit, for
    both basal values; and the columns go through the whole solve."""
    args = operands(12, dtype, "subgrid", dt, np.random.default_rng(5))
    nz = 12
    c_dd, c_d2, zr = (args[1][:2].double(), args[2][:2].double(),
                      args[ARG["zrows"]])
    lo = torch.zeros(2, nz, dtype=torch.float64)
    up = torch.zeros(2, nz, dtype=torch.float64)
    lo[:, 1:-1] = c_dd[:, 1:-1] * zr[0, :nz - 2] + c_d2[:, 1:-1] * zr[3, :nz - 2]
    up[:, 1:-1] = c_dd[:, 1:-1] * zr[2, 1:-1] + c_d2[:, 1:-1] * zr[5, 1:-1]
    diag = 1.0 / dt + c_dd * zr[1] + c_d2 * zr[4]
    diag[:, 0] = diag[:, -1] = 1.0
    assert torch.equal(diag[:, 1], torch.zeros(2, dtype=torch.float64))
    den, cp = factorise(diag, lo, up)
    assert float(den[0, 1]) == float(den[1, 1]) == 1e-300
    assert bool(torch.isfinite(cp[0, 1])) and bool(torch.isinf(cp[1, 1]))
    rng = np.random.default_rng(6)
    for _ in range(3):          # three substeps' right-hand sides
        b = torch.as_tensor(250.0 + rng.standard_normal((2, nz)))
        bases = torch.as_tensor(260.0 + rng.standard_normal((2, 2)))
        xs = solve_factorised(den, cp, lo, b, bases[:, 0], bases[:, 1])
        for j, x in enumerate(xs):
            bj = b.clone()
            bj[:, -1] = bases[:, j]
            _assert_bit_equal(x, thomas_batched(lo[:, 1:], diag, up[:, :-1],
                                                bj))
    _check(args)


def test_non_finite_exit_is_exact():
    """The property the exit rests on, on fuzzed operands: a column whose
    carry went non-finite in an interior row before a level's last substep
    ends that level non-finite (unstable), when the level is run to its
    end."""
    rng = np.random.default_rng(42)
    n_late = 0
    for trial in range(12):
        nz = (7, 12, 15)[trial % 3]
        dtype = (torch.float32, torch.float64)[trial % 2]
        args = operands(nz, dtype, ("grounded", "pmp", "subgrid")[trial % 3],
                         float(rng.choice([0.1, 1.0, 10.0])), rng)
        for name, row in PLACEMENTS:
            if rng.random() < 0.5:
                value = float(rng.choice([np.inf, -np.inf, np.nan]))
                args = place(args, name, row, value, rng)
        _, _, info = heat_columns_sketch(*args, exit_early=False)
        for late, unstable, idx in info["late_nonfinite"]:
            at = late[idx]
            assert bool(unstable[at].all())
            n_late += int(at.sum())
    assert n_late > 100
