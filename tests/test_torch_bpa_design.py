"""The design of the BPA kernels (csrc/bpa.cu), written as plain tensor
code and held to the bit against `bpa_apply_plain` and
`line_thomas_plain`.

The functions below are the kernels' specification. They reorder the
work of the plain versions without changing a single rounding:

- `bpa_apply` takes a row in runs of R layers (at nz 12 R = 2 in f32 and
  1 in f64, and 4 as the source's option; R = 1, the run-time form, at
  any other nz and for operands off a 16-byte boundary). A run sums each
  stencil entry over its R layers with the entry's index and
  coefficients read once, and takes the zeta neighbours at its edges
  from the row's own column (`column_run`, `ddz_run`);
- pass 1 writes the first derivatives ux, uy, vx, vy interleaved
  [n, nz, 4], and in f32 with the rounding of x also their copy rounded
  once to bfloat16. Pass 2 gathers that copy and widens it (exact),
  which equals rounding each gathered value again; the own row's zeta
  differences and the boundary rows use the exact first derivatives;
- the surface layer is the first layer of a row's first run and the base
  layer the last layer of its last run; a lateral row takes its whole
  column run by run;
- `line_thomas` solves each column on two lanes, one a right-hand side,
  each forming the same pivots by the same operations (`thomas_lane`),
  from a block's slabs of columns copied into shared memory as they lie
  (column strides nz - 1 and nz, the two right-hand sides one slab after
  the other: `slot`, `stage`, `unstage`); the zero dividends (every
  column's last c', identity columns, the no-slip base rows' zero
  right-hand sides) give the signed zeros of the IEEE division.

The operands: random coefficient fields of the magnitudes a viscosity
iteration makes on the small mesh of tests/test_torch_bpa.py, f32 with
and without the rounding of x and f64, sliding and no-slip, the periodic
(neighbour-mean) lateral rows and mixed identity / neighbour-mean rows,
nz 12, 7 and 5.
"""

import numpy as np
import pytest
import torch

from torch_port_fixture import mesh_to_numpy
from ufemism2_tpu_torch.config import Config
from ufemism2_tpu_torch.convert import mesh_from_numpy
from ufemism2_tpu_torch.core.ice.bpa import register_bpa_static
from ufemism2_tpu_torch.core.mesh_data import build_mesh_data
from ufemism2_tpu_torch.ops import cuda_bpa
from ufemism2_tpu_torch.ops.cuda_spmv import DivaRows, _round_bf16

FIELDS = 4           # ux, uy, vx, vy, the interleaved scratch's last axis


def kernel_run(nz, dtype, aligned=True):
    """The run length the kernel takes (csrc/bpa.cu bpa_apply): at nz 12
    with every operand on a 16-byte boundary UF_BPA_RUN (2) in f32 and
    UF_BPA_RUN64 (1) in f64, else 1."""
    if nz == 12 and aligned:
        return 2 if dtype == torch.float32 else 1
    return 1


# -- bpa_apply ------------------------------------------------------------

def column_run(col, k0, R):
    """[n, R + 2, ...]: layers k0 .. k0+R-1 of each row of col [n, nz, ...]
    between their neighbours k0-1 and k0+R (zeros past the column's ends,
    which ddz_run never reads)."""
    nz = col.shape[1]
    zero = torch.zeros_like(col[:, :1])
    left = col[:, k0 - 1:k0] if k0 > 0 else zero
    right = col[:, k0 + R:k0 + R + 1] if k0 + R < nz else zero
    return torch.cat([left, col[:, k0:k0 + R], right], dim=1)


def ddz_run(c, k0, nz, dz, two_dz):
    """d/dzeta at the run's layers from column_run's c: one-sided at the
    column's ends, central inside."""
    out = []
    for i in range(c.shape[1] - 2):
        k = k0 + i
        if k == 0:
            out.append((c[:, i + 2] - c[:, i + 1]) / dz)
        elif k == nz - 1:
            out.append((c[:, i + 1] - c[:, i]) / dz)
        else:
            out.append((c[:, i + 2] - c[:, i]) / two_dz)
    return torch.stack(out, dim=1)


def first_pass(A, u, v, R):
    """Pass 1 run by run: the exact first derivatives [n, nz, 4] and, with
    the rounding of x, their copy rounded once to bfloat16."""
    cols, vals = A.stack.cols.long(), A.stack.vals
    c, (dz, two_dz, _) = A.coeffs, A.consts
    n, nz = u.shape
    rnd = _round_bf16 if A.round else (lambda x: x)
    d1 = torch.empty((n, nz, FIELDS), dtype=u.dtype)
    for k0 in range(0, nz, R):
        run = slice(k0, k0 + R)
        sxu = syu = sxv = syv = torch.zeros((n, R), dtype=u.dtype)
        for e in range(cols.shape[0]):
            ax, ay = vals[0, e][:, None], vals[1, e][:, None]
            xu, xv = rnd(u[cols[e], run]), rnd(v[cols[e], run])
            sxu, syu = sxu + ax * xu, syu + ay * xu
            sxv, syv = sxv + ax * xv, syv + ay * xv
        du = ddz_run(column_run(u, k0, R), k0, nz, dz, two_dz)
        dv = ddz_run(column_run(v, k0, R), k0, nz, dz, two_dz)
        zx, zy = c.zx[:, run], c.zy[:, run]
        d1[:, run] = torch.stack([sxu + zx * du, syu + zy * du,
                                  sxv + zx * dv, syv + zy * dv], dim=-1)
    return d1, (d1.to(torch.bfloat16) if A.round else None)


def nbr_run(rows, x, run):
    """The neighbour-mean residual of a lateral row over the run."""
    g = torch.where(rows.mask_TriC[:, :, None], x[rows.TriC][:, :, run], 0.0)
    n_nbr = rows.mask_TriC.sum(dim=1).to(x.dtype)
    return (g[:, 0] + g[:, 1]) + g[:, 2] - n_nbr[:, None] * x[:, run]


def layer_rows(A, d, s, uc, vc, r, i, k):
    """(Au, Av) [n] at layer k, the run's layer i: the interior, surface
    or base row from the stencil sums s, the exact first derivatives d
    (column_run form, [n, R + 2, 4]) and u, v (column_run form), in the
    order of bpa_apply_plain."""
    c, (dz, two_dz, dz2) = A.coeffs, A.consts
    nz = A.nz
    ddz = lambda f: ddz_run(d[..., f], r.start, nz, dz, two_dz)[:, i]
    dux, duy, dvx, dvy = ddz(0), ddz(1), ddz(2), ddz(3)
    zx, zy = c.zx[:, k], c.zy[:, k]
    uxx, uxy = s[0][:, i] + zx * dux, s[1][:, i] + zy * dux
    uyy = s[2][:, i] + zy * duy
    vxx, vxy = s[3][:, i] + zx * dvx, s[4][:, i] + zy * dvx
    vyy = s[5][:, i] + zy * dvy
    ux, uy, vx, vy = d[:, i + 1].unbind(-1)
    e, ex, ey, ez = c.eta[:, k], c.eta_x[:, k], c.eta_y[:, k], c.eta_z[:, k]
    if k == 0:                              # surface
        Su = 2 * c.dh_dx * (2 * ux + vy) + c.dh_dy * (uy + vx)
        Sv = 2 * c.dh_dy * (2 * vy + ux) + c.dh_dx * (vx + uy)
        uzz = c.qfac * (uc[:, i + 2] - uc[:, i + 1] - c.dzz * Su)
        vzz = c.qfac * (vc[:, i + 2] - vc[:, i + 1] - c.dzz * Sv)
        tu, tv = (e * uzz, ez * Su), (e * vzz, ez * Sv)
    elif k == nz - 1:                       # base
        if A.no_sliding:
            return uc[:, i + 1], vc[:, i + 1]
        Pu = (2 * c.db_dx * (2 * ux + vy) + c.db_dy * (uy + vx)
              + c.ratio * uc[:, i + 1])
        Pv = (2 * c.db_dy * (2 * vy + ux) + c.db_dx * (vx + uy)
              + c.ratio * vc[:, i + 1])
        au = (4 * e * uxx + 4 * ex * ux + e * uyy + ey * uy
              + 3 * e * vxy + 2 * ex * vy + ey * vx
              + c.qb * (uc[:, i] - uc[:, i + 1]) + c.rb * Pu)
        av = (4 * e * vyy + 4 * ey * vy + e * vxx + ex * vx
              + 3 * e * uxy + 2 * ey * ux + ex * uy
              + c.qb * (vc[:, i] - vc[:, i + 1]) + c.rb * Pv)
        return au, av
    else:                                   # interior
        zz, zz2 = c.zz, c.zz2
        d2 = lambda w: (w[:, i + 2] + w[:, i] - 2 * w[:, i + 1]) / dz2
        uz = zz * ddz_run(uc, r.start, nz, dz, two_dz)[:, i]
        vz = zz * ddz_run(vc, r.start, nz, dz, two_dz)[:, i]
        tu, tv = (e * (zz2 * d2(uc)), ez * uz), (e * (zz2 * d2(vc)), ez * vz)
    au = (4 * e * uxx + 4 * ex * ux + e * uyy + ey * uy + tu[0] + tu[1]
          + 3 * e * vxy + 2 * ex * vy + ey * vx)
    av = (4 * e * vyy + 4 * ey * vy + e * vxx + ex * vx + tv[0] + tv[1]
          + 3 * e * uxy + 2 * ey * ux + ex * uy)
    return au, av


def second_pass(A, u, v, d1, d1h, R, gather_copy=True):
    """Pass 2 run by run: the six stencil sums of the gathered first
    derivatives (the bfloat16 copy widened, or the exact ones rounded
    again with `gather_copy` False), then each layer's row; lateral rows
    run by run."""
    cols, vals = A.stack.cols.long(), A.stack.vals
    rows = A.rows
    n, nz = u.shape
    Au, Av = torch.empty_like(u), torch.empty_like(u)
    for k0 in range(0, nz, R):
        run = slice(k0, k0 + R)
        s = [torch.zeros((n, R), dtype=u.dtype)] * 6
        for e in range(cols.shape[0]):
            ax, ay = vals[0, e][:, None], vals[1, e][:, None]
            if d1h is not None and gather_copy:
                g = d1h[cols[e], run].to(u.dtype)
            else:
                g = d1[cols[e], run]
                g = _round_bf16(g) if A.round else g
            s = [s[0] + ax * g[..., 0], s[1] + ay * g[..., 0],
                 s[2] + ay * g[..., 1], s[3] + ax * g[..., 2],
                 s[4] + ay * g[..., 2], s[5] + ay * g[..., 3]]
        d = column_run(d1, k0, R)
        uc, vc = column_run(u, k0, R), column_run(v, k0, R)
        for i in range(R):
            Au[:, k0 + i], Av[:, k0 + i] = layer_rows(A, d, s, uc, vc, run,
                                                      i, k0 + i)
        free = rows.free[:, None]
        Au[:, run] = torch.where(free, Au[:, run], torch.where(
            rows.inf_u[:, None], nbr_run(rows, u, run), u[:, run]))
        Av[:, run] = torch.where(free, Av[:, run], torch.where(
            rows.inf_v[:, None], nbr_run(rows, v, run), v[:, run]))
    return Au, Av


def bpa_sketch(A, u, v, R, gather_copy=True):
    d1, d1h = first_pass(A, u, v, R)
    return second_pass(A, u, v, d1, d1h, R, gather_copy)


# -- line_thomas ----------------------------------------------------------

def thomas_lane(sub, dia, sup, b):
    """One lane: the column's pivots formed by this lane alone, then its
    right-hand side b [m, nz] swept forward and back."""
    nz = dia.shape[1]
    zero = torch.zeros_like(dia[:, 0])
    c_prev, d_prev = zero, zero
    cps, dps = [], []
    for k in range(nz):
        lk = zero if k == 0 else sub[:, k - 1]
        uk = zero if k == nz - 1 else sup[:, k]
        den = dia[:, k] - lk * c_prev
        den = torch.where(torch.abs(den) < 1e-300, 1e-300, den)
        c_prev = uk / den
        d_prev = (b[:, k] - lk * d_prev) / den
        cps.append(c_prev)
        dps.append(d_prev)
    x = zero
    xs = [None] * nz
    for k in range(nz - 1, -1, -1):
        x = dps[k] - cps[k] * x
        xs[k] = x
    return torch.stack(xs, dim=1)


def slot(e, w, side, C):
    """The shared-memory word of value e of a block's slab (w values a
    column): the slab as it lies, the right-hand side `side` (None for a
    band) one slab after the other."""
    return (0 if side is None else side) * C * w + e


def stage(slab, w, side, C, buf):
    e = torch.arange(slab.numel())
    buf[slot(e, w, side, C)] = slab.reshape(-1)


def unstage(buf, count, w, side, C):
    return buf[slot(torch.arange(count), w, side, C)]


def thomas_sketch(sub, dia, sup, ru, rv, C):
    """line_thomas block by block: C columns staged, two lanes a column
    solving from shared memory, the solutions unstaged."""
    n, nz = dia.shape
    xu, xv = torch.empty_like(ru), torch.empty_like(rv)
    nan = lambda m: torch.full((m,), float("nan"), dtype=dia.dtype)
    for c0 in range(0, n, C):
        nc = min(C, n - c0)
        blk = slice(c0, c0 + nc)
        s_sub, s_dia, s_sup, rhs = (nan(C * (nz - 1)), nan(C * nz),
                                    nan(C * (nz - 1)), nan(2 * C * nz))
        stage(sub[blk], nz - 1, None, C, s_sub)
        stage(sup[blk], nz - 1, None, C, s_sup)
        stage(dia[blk], nz, None, C, s_dia)
        stage(ru[blk], nz, 0, C, rhs)
        stage(rv[blk], nz, 1, C, rhs)
        l, d, up = (s_sub[:nc * (nz - 1)].view(nc, nz - 1),
                    s_dia[:nc * nz].view(nc, nz),
                    s_sup[:nc * (nz - 1)].view(nc, nz - 1))
        for side in (0, 1):
            b = rhs.view(2, C, nz)[side, :nc]
            rhs.view(2, C, nz)[side, :nc] = thomas_lane(l, d, up, b)
        xu[blk] = unstage(rhs, nc * nz, nz, 0, C).view(nc, nz)
        xv[blk] = unstage(rhs, nc * nz, nz, 1, C).view(nc, nz)
    return xu, xv


def bank_ways(words):
    """The most distinct 4-byte words one bank serves for a warp's
    accesses (a word read by several lanes is served once)."""
    words = torch.unique(words)
    return int(torch.bincount(words.remainder(32), minlength=32).max())


# -- operands and tests ---------------------------------------------------

# periodic sides: every lateral row takes the neighbour-mean form
PERIODIC = Config(**{f"BC_{c}_{s}": "periodic_ISMIP-HOM" for c in "uv"
                     for s in ("north", "south", "east", "west")})


@pytest.fixture(scope="module")
def meshes(small_mesh):
    mesh = mesh_from_numpy(mesh_to_numpy(small_mesh))
    out = {}
    for dtype in (torch.float32, torch.float64):
        md = build_mesh_data(mesh, dtype=dtype, device="cpu")
        register_bpa_static(PERIODIC, mesh, md)
        out[dtype] = md
    return out


def operands(md, nz, dtype, seed):
    """Coefficient fields of the magnitudes a viscosity iteration makes
    (ice 500-1,500 m thick, eta 1e13-1e14 Pa yr, slopes of a few 1e-3)
    and (u, v) of tens of m/yr."""
    rng = np.random.default_rng(seed)
    n = md.nTri
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    dzeta = 1.0 / (nz - 1)
    zz = -1.0 / (500.0 + 1000.0 * rng.random(n))
    slope = 1e-2 * rng.standard_normal((n, 1))
    eta = 10.0 ** (13.0 + rng.random((n, nz)))
    qfac = 2.0 / dzeta ** 2 * zz ** 2
    eta_z = 1e-2 * eta * rng.standard_normal((n, nz))
    c = cuda_bpa.BpaCoeffs(
        zx=t(slope + 1e-3 * rng.standard_normal((n, nz))),
        zy=t(-slope + 1e-3 * rng.standard_normal((n, nz))),
        eta=t(eta), eta_x=t(1e-3 * eta * rng.standard_normal((n, nz))),
        eta_y=t(1e-3 * eta * rng.standard_normal((n, nz))), eta_z=t(eta_z),
        zz=t(zz), zz2=t(zz ** 2), dh_dx=t(1e-2 * rng.standard_normal(n)),
        dh_dy=t(1e-2 * rng.standard_normal(n)),
        db_dx=t(5e-2 * rng.standard_normal(n)),
        db_dy=t(5e-2 * rng.standard_normal(n)), dzz=t(dzeta / zz),
        qfac=t(qfac), qb=t(qfac * eta[:, -1]),
        rb=t(2 * eta[:, -1] / dzeta * zz + eta_z[:, -1]),
        ratio=t(1e3 * rng.random(n) / eta[:, -1]))
    u, v = (t(30.0 * rng.standard_normal((n, nz))) for _ in range(2))
    return c, dzeta, u, v


def lateral_rows(md, kind):
    rows = md.x("bpa_rows")
    if kind == "periodic":
        return rows
    x, y = md.TriGC[:, 0], md.TriGC[:, 1]
    return DivaRows(md.TriC, md.mask_TriC, rows.free,
                    ~rows.free & (x > 0), ~rows.free & (y > 0))


PRECISIONS = {"f32_bf16x": (torch.float32, True),
              "f32": (torch.float32, False),
              "f64": (torch.float64, False)}
# (nz, the run length): every run length the source offers at nz 12 (2
# the f32 design, 1 the f64 design and the run-time form for operands off
# a 16-byte boundary, 4 the option), and the run-time form at nz 7 and 5
RUNS = [(12, 4), (12, 2), (12, 1), (7, 1), (5, 1)]


@pytest.mark.parametrize("no_sliding", [False, True],
                         ids=["sliding", "no_slip"])
@pytest.mark.parametrize("rows_kind", ["periodic", "mixed"])
@pytest.mark.parametrize("nz,R", RUNS,
                         ids=[f"nz{nz}_run{R}" for nz, R in RUNS])
@pytest.mark.parametrize("prec", list(PRECISIONS))
def test_bpa_runs_match_plain(meshes, prec, nz, R, rows_kind, no_sliding):
    dtype, rnd = PRECISIONS[prec]
    md = meshes[dtype]
    c, dzeta, u, v = operands(md, nz, dtype, seed=nz)
    rows = lateral_rows(md, rows_kind)
    assert (~rows.free).any()
    A = cuda_bpa.BpaOperator(md.M2_stack.op, rows, c, dzeta, no_sliding,
                             rnd)
    Pu, Pv = A.plain(u, v)
    Ku, Kv = bpa_sketch(A, u, v, R)
    assert torch.isfinite(Pu).all() and torch.isfinite(Pv).all()
    assert torch.equal(Ku, Pu) and torch.equal(Kv, Pv)


@pytest.mark.parametrize("nz", [12, 7])
def test_bf16_copy_equals_rounding_each_read(meshes, nz):
    """The copy rounded once and widened is what rounding each gathered
    value gives, and rounding it again changes nothing: pass 2 may gather
    it instead of rounding at every one of a value's readers."""
    md = meshes[torch.float32]
    c, dzeta, u, v = operands(md, nz, torch.float32, seed=20 + nz)
    A = cuda_bpa.BpaOperator(md.M2_stack.op, md.x("bpa_rows"), c, dzeta,
                             round_x_bf16=True)
    R = kernel_run(nz, torch.float32)
    d1, d1h = first_pass(A, u, v, R)
    assert d1h.dtype == torch.bfloat16 and d1h.shape == (md.nTri, nz, 4)
    wide = d1h.to(torch.float32)
    assert torch.equal(wide, _round_bf16(d1))
    assert torch.equal(_round_bf16(wide), wide)
    for R in {R, 1}:
        a = second_pass(A, u, v, d1, d1h, R)
        b = second_pass(A, u, v, d1, d1h, R, gather_copy=False)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("nz", [12, 7, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_thomas_lanes_match_plain(dtype, nz):
    """Two lanes a column, each forming the pivots itself, from the staged
    slab: line_thomas_plain to the bit, at three block widths and a
    partial last block (f64 with pivots at the 1e-300 clamp)."""
    rng = np.random.default_rng(nz)
    n = 150
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    sub, sup = (t(rng.standard_normal((n, nz - 1))) for _ in "ab")
    dia = t(4.0 + rng.random((n, nz)))
    if dtype == torch.float64:
        dia[:7, 2] = 0.0
        sub[:7, 1] = 0.0
    ru, rv = (t(rng.standard_normal((n, nz))) for _ in "ab")
    Pu, Pv = cuda_bpa.line_thomas_plain(sub, dia, sup, ru, rv)
    for C in (16, 32, 64):
        Ku, Kv = thomas_sketch(sub, dia, sup, ru, rv, C)
        assert torch.equal(Ku, Pu) and torch.equal(Kv, Pv)


@pytest.mark.parametrize("nz", [12, 7, 5, 64])
def test_thomas_staging_order(nz):
    """The staged column order: every value of a block's slabs lands on its
    own word, unstaging inverts staging, and the bank conflicts of a
    warp's 32 lanes (16 columns, both sides) at nz 12: at most two-way on
    the bands and four-way on the right-hand sides (an odd stride would
    avoid them, at the price of a copy a value)."""
    C = 32
    for w, sides in ((nz - 1, (None,)), (nz, (None,)), (nz, (0, 1))):
        words = torch.cat([slot(torch.arange(C * w), w, s, C)
                           for s in sides])
        assert words.unique().numel() == words.numel()
        assert int(words.max()) < len(sides) * C * w
    buf = torch.zeros(2 * C * nz)
    slab = torch.arange(C * nz, dtype=torch.float32).view(C, nz) + 1
    stage(slab, nz, 1, C, buf)
    assert torch.equal(unstage(buf, C * nz, nz, 1, C), slab.reshape(-1))
    if nz != 12:
        return
    lanes = torch.arange(32)
    col, side = lanes // 2, lanes % 2
    for k in range(nz - 1):
        assert bank_ways(slot(col * (nz - 1) + k, nz - 1, None, C)) <= 2
        assert bank_ways(slot(col * nz + k, nz, side, C)) <= 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_thomas_signed_zeros(dtype):
    """Zero right-hand sides (the no-slip base rows), identity columns and
    negative pivots: the lanes give the plain version's signed zeros, bit
    for bit (line_thomas answers a zero dividend over a finite nonzero
    pivot with the signed zero instead of dividing)."""
    rng = np.random.default_rng(4)
    n, nz = 70, 12
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    sub, sup = (t(rng.standard_normal((n, nz - 1))) for _ in "ab")
    dia = t(-(4.0 + rng.random((n, nz))))
    sub[:9], sup[:9], dia[:9] = 0.0, 0.0, 1.0       # identity columns
    sub[20:40, -1], dia[20:40, -1] = 0.0, 1.0       # no-slip base rows
    ru, rv = (t(rng.standard_normal((n, nz))) for _ in "ab")
    ru[20:40, -1], rv[20:40:2, -1] = 0.0, -0.0
    rv[3::5] = -0.0
    Pu, Pv = cuda_bpa.line_thomas_plain(sub, dia, sup, ru, rv)
    Ku, Kv = thomas_sketch(sub, dia, sup, ru, rv, 32)
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    for a, b in ((Ku, Pu), (Kv, Pv)):
        assert torch.equal(a.view(bits), b.view(bits))
    assert bool((Pu[20:40, -1] == 0).all()) and bool((Pv == 0).any())
