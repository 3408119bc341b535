"""The BPA operator and the vertical-line preconditioner's column solves:
build, binding, wrappers and plain versions.

`bpa_apply` is one apply of the Blatter-Pattyn momentum operator on the
3-D velocities (u, v) [n_rows, nz] (the closure `A_op` of
ufemism2_tpu/core/ice/bpa.py:208-297): horizontal derivatives as sums over
the b-grid stencil of the M2 stack (its shared index table and its first
two operators, d/dx and d/dy), vertical derivatives on the zeta grid, the
surface row with the ghost point eliminated, the base row (sliding or
no-slip) and the lateral boundary rows. `line_thomas` solves the
per-column tridiagonal systems of the line preconditioner `M_pre`
(bpa.py:299-328) for both right-hand sides.

Neither has a Pallas counterpart: the JAX package leaves both to XLA,
which fuses them into a few loops, where eager PyTorch would run some 230
launches an operator apply and 260 a preconditioner apply. The CUDA
source csrc/bpa.cu is compiled with nvcc at first use into its own shared
library under build/ and loaded with ctypes, as ops/cuda_spmv.py does. A
CUDA tensor always goes to the kernel; only a CPU tensor takes
`bpa_apply_plain` / `line_thomas_plain`, the same arithmetic in plain
tensor code, in the kernels' order of operations (the CPU path and the
kernels' test oracle: on the card the two agree to the bit).

What changes only once per viscosity iteration (the coefficient fields,
the divisions of the boundary rows, the preconditioner's diagonals) is
formed in tensor code by the caller (core/ice/bpa.py) and checked and
bound once, in `BpaOperator` and `LineThomas`; a call checks its x.

Precision: in float32 the horizontal stencil sums see their operand
rounded to bfloat16 (round_x_bf16, as every `M @ x` of the reference
rounds it): u and v in the first pass, the first derivatives in the
second. The vertical differences, the boundary rows and the lateral rows
use the values as they are.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda_spmv import DivaRows, StackOperator, _round_bf16
from .tridiag import thomas_batched

NZ_MAX = 64          # layers a column may have (csrc/bpa.cu UF_NZ_MAX)

launches = 0         # bpa_apply kernel launches (two an apply) since the
                     # caller last set it to 0
thomas_launches = 0  # line_thomas launches, likewise


class BpaCoeffs(NamedTuple):
    """The per-iteration fields of the BPA operator, in the run's type.
    [n, nz]: zx, zy (dzeta/dx, dzeta/dy), eta, eta_x, eta_y, eta_z;
    [n]: zz (dzeta/dz), zz2 (zz**2), dh_dx, dh_dy, db_dx, db_dy, dzz
    (dzeta / zz), qfac (Q_fac), qb (Q_fac * eta at the base), rb (R of the
    base row), ratio (beta / eta_base)."""
    zx: torch.Tensor
    zy: torch.Tensor
    eta: torch.Tensor
    eta_x: torch.Tensor
    eta_y: torch.Tensor
    eta_z: torch.Tensor
    zz: torch.Tensor
    zz2: torch.Tensor
    dh_dx: torch.Tensor
    dh_dy: torch.Tensor
    db_dx: torch.Tensor
    db_dy: torch.Tensor
    dzz: torch.Tensor
    qfac: torch.Tensor
    qb: torch.Tensor
    rb: torch.Tensor
    ratio: torch.Tensor


N_FIELDS_3D = 6      # the first six fields of BpaCoeffs are [n, nz]


def zeta_consts(dzeta, dtype, device):
    """The three divisors of the zeta differences (dzeta, 2 dzeta,
    dzeta**2) as Python floats and as 0-dim tensors of the run's type: the
    plain version divides by the tensors (a Python-scalar divisor would
    become a multiplication by its reciprocal on the card), the kernel by
    the same values rounded to its type."""
    vals = (float(dzeta), 2.0 * float(dzeta), float(dzeta) ** 2)
    return vals, tuple(torch.full((), v, dtype=dtype, device=device)
                       for v in vals)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def ddzeta_plain(f, dz, two_dz):
    """Central d/dzeta with one-sided ends of f [n, nz] (bpa.py:114-120)."""
    out = torch.empty_like(f)
    out[:, 1:-1] = (f[:, 2:] - f[:, :-2]) / two_dz
    out[:, 0] = (f[:, 1] - f[:, 0]) / dz
    out[:, -1] = (f[:, -1] - f[:, -2]) / dz
    return out


def d2dzeta2_plain(f, dz2):
    """d2/dzeta2 of f [n, nz] on the interior layers, 0 at the ends
    (bpa.py:403-407)."""
    out = torch.zeros_like(f)
    out[:, 1:-1] = (f[:, 2:] + f[:, :-2] - 2 * f[:, 1:-1]) / dz2
    return out


def _stencil_sums(cols, vals, x):
    """(sum_k vals[0, k, r] x[cols[k, r]], sum_k vals[1, k, r] x[cols[k,
    r]]) for x [n, nz, m] (m fields side by side), over the entries k = 0,
    1, ... in turn from 0, each product and each sum one operation: the
    kernel's order for every field."""
    xg = x[cols]                                   # [K, n, nz, m]
    sx = torch.zeros_like(x)
    sy = torch.zeros_like(x)
    for k in range(cols.shape[0]):
        sx = sx + vals[0, k][:, None, None] * xg[k]
        sy = sy + vals[1, k][:, None, None] * xg[k]
    return sx, sy


def nbr_residual_plain(rows, x):
    """sum(x[neighbours]) - n_neighbours * x for x [n, nz], the three
    neighbours added in slot order (bpa.py:110-112)."""
    g = torch.where(rows.mask_TriC[:, :, None], x[rows.TriC], 0.0)
    s = (g[:, 0] + g[:, 1]) + g[:, 2]
    n_nbr = rows.mask_TriC.sum(dim=1).to(x.dtype)
    return s - n_nbr[:, None] * x


def bpa_apply_plain(stack, rows, c: BpaCoeffs, consts, u, v,
                    no_sliding=False, round_x_bf16=False):
    """Plain tensor version of `bpa_apply`: (Au, Av) [n, nz] of the BPA
    operator (bpa.py:208-297) at (u, v) [n, nz]. `stack` = (cols, vals) of
    the M2 stack (ops 0 and 1: d/dx, d/dy on the b-grid), `rows` the
    lateral row tables (a DivaRows: on a boundary row the u row is the
    neighbour-mean form where inf_u, else the identity; likewise v),
    `consts` the 0-dim divisors of `zeta_consts`."""
    cols, vals = stack
    cl = cols.long()
    dz, two_dz, dz2 = consts
    rnd = _round_bf16 if round_x_bf16 else (lambda x: x)

    # pass 1 of the kernel: the stencil sums of (u, v) side by side
    uv = torch.stack([u, v], dim=-1)
    sx, sy = _stencil_sums(cl, vals, rnd(uv))
    du, dv = ddzeta_plain(u, dz, two_dz), ddzeta_plain(v, dz, two_dz)
    ux, uy = sx[..., 0] + c.zx * du, sy[..., 0] + c.zy * du
    vx, vy = sx[..., 1] + c.zx * dv, sy[..., 1] + c.zy * dv
    # pass 2: d/dx of ux and vx, d/dy of ux, uy, vx and vy (both cross
    # terms are d/dy of an x-derivative, bpa.py:212-213)
    sx, sy = _stencil_sums(cl, vals, rnd(torch.stack([ux, uy, vx, vy],
                                                     dim=-1)))
    dux, duy = ddzeta_plain(ux, dz, two_dz), ddzeta_plain(uy, dz, two_dz)
    dvx, dvy = ddzeta_plain(vx, dz, two_dz), ddzeta_plain(vy, dz, two_dz)
    uxx, uxy = sx[..., 0] + c.zx * dux, sy[..., 0] + c.zy * dux
    uyy = sy[..., 1] + c.zy * duy
    vxx, vxy = sx[..., 2] + c.zx * dvx, sy[..., 2] + c.zy * dvx
    vyy = sy[..., 3] + c.zy * dvy
    zz = c.zz[:, None]
    uz = zz * ddzeta_plain(u, dz, two_dz)
    vz = zz * ddzeta_plain(v, dz, two_dz)
    uzz = c.zz2[:, None] * d2dzeta2_plain(u, dz2)
    vzz = c.zz2[:, None] * d2dzeta2_plain(v, dz2)
    eta, eta_x, eta_y, eta_z = c.eta, c.eta_x, c.eta_y, c.eta_z

    Au = (4 * eta * uxx + 4 * eta_x * ux + eta * uyy
          + eta_y * uy + eta * uzz + eta_z * uz
          + 3 * eta * vxy + 2 * eta_x * vy + eta_y * vx)
    Av = (4 * eta * vyy + 4 * eta_y * vy + eta * vxx
          + eta_x * vx + eta * vzz + eta_z * vz
          + 3 * eta * uxy + 2 * eta_y * ux + eta_x * uy)

    # surface row (k = 0): the ghost point eliminated, zero stress
    e0, ex0, ey0, ez0 = eta[:, 0], eta_x[:, 0], eta_y[:, 0], eta_z[:, 0]
    S_u0 = (2 * c.dh_dx * (2 * ux[:, 0] + vy[:, 0])
            + c.dh_dy * (uy[:, 0] + vx[:, 0]))
    S_v0 = (2 * c.dh_dy * (2 * vy[:, 0] + ux[:, 0])
            + c.dh_dx * (vx[:, 0] + uy[:, 0]))
    uzz0 = c.qfac * (u[:, 1] - u[:, 0] - c.dzz * S_u0)
    vzz0 = c.qfac * (v[:, 1] - v[:, 0] - c.dzz * S_v0)
    Au[:, 0] = (4 * e0 * uxx[:, 0] + 4 * ex0 * ux[:, 0]
                + e0 * uyy[:, 0] + ey0 * uy[:, 0]
                + e0 * uzz0 + ez0 * S_u0
                + 3 * e0 * vxy[:, 0] + 2 * ex0 * vy[:, 0]
                + ey0 * vx[:, 0])
    Av[:, 0] = (4 * e0 * vyy[:, 0] + 4 * ey0 * vy[:, 0]
                + e0 * vxx[:, 0] + ex0 * vx[:, 0]
                + e0 * vzz0 + ez0 * S_v0
                + 3 * e0 * uxy[:, 0] + 2 * ey0 * ux[:, 0]
                + ex0 * uy[:, 0])

    # base row (k = nz-1): sliding, or u = v = 0 without it
    kb = u.shape[1] - 1
    if no_sliding:
        Au[:, kb] = u[:, kb]
        Av[:, kb] = v[:, kb]
    else:
        eb, exb, eyb = eta[:, kb], eta_x[:, kb], eta_y[:, kb]
        P_u = (2 * c.db_dx * (2 * ux[:, kb] + vy[:, kb])
               + c.db_dy * (uy[:, kb] + vx[:, kb])
               + c.ratio * u[:, kb])
        P_v = (2 * c.db_dy * (2 * vy[:, kb] + ux[:, kb])
               + c.db_dx * (vx[:, kb] + uy[:, kb])
               + c.ratio * v[:, kb])
        Au[:, kb] = (4 * eb * uxx[:, kb] + 4 * exb * ux[:, kb]
                     + eb * uyy[:, kb] + eyb * uy[:, kb]
                     + 3 * eb * vxy[:, kb] + 2 * exb * vy[:, kb]
                     + eyb * vx[:, kb]
                     + c.qb * (u[:, kb - 1] - u[:, kb]) + c.rb * P_u)
        Av[:, kb] = (4 * eb * vyy[:, kb] + 4 * eyb * vy[:, kb]
                     + eb * vxx[:, kb] + exb * vx[:, kb]
                     + 3 * eb * uxy[:, kb] + 2 * eyb * ux[:, kb]
                     + exb * uy[:, kb]
                     + c.qb * (v[:, kb - 1] - v[:, kb]) + c.rb * P_v)

    # lateral rows, the whole column
    free = rows.free[:, None]
    Au = torch.where(free, Au, torch.where(
        rows.inf_u[:, None], nbr_residual_plain(rows, u), u))
    Av = torch.where(free, Av, torch.where(
        rows.inf_v[:, None], nbr_residual_plain(rows, v), v))
    return Au, Av


def line_thomas_plain(sub, dia, sup, ru, rv):
    """Plain version of `line_thomas`: the tridiagonal systems (sub [n,
    nz-1], dia [n, nz], sup [n, nz-1]) of every column solved for ru and
    rv [n, nz] by ops/tridiag.py thomas_batched, the recurrence of the
    reference's M_pre (bpa.py:325-328)."""
    x = thomas_batched(sub, dia, sup, torch.stack([ru, rv]))
    return x[0], x[1]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check_x(what, x, shape, dtype, device):
    if x.dtype != dtype:
        raise TypeError(f"{what}: x is {x.dtype}, the operator {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{what}: x of shape {tuple(x.shape)}, expected "
                         f"{shape}")
    if x.device != device:
        raise ValueError(f"{what}: operands on different devices")
    return x if x.is_contiguous() else x.contiguous()


class BpaOperator:
    """The BPA operator for one viscosity iteration, checked once and bound
    to the kernel `bpa_apply` (two launches an apply: the first
    derivatives of u and v into a scratch [n, nz, 4], with the rounding of
    x also their copy rounded once to bfloat16, then the rows).
    `A((u, v))` gives (Au, Av); `A.flat(x)` takes and gives the flat
    Krylov vector [u; v] (each [n, nz] row-major)."""

    def __init__(self, stack: StackOperator, rows: DivaRows, coeffs,
                 dzeta, no_sliding=False, round_x_bf16=False):
        n = stack.n_rows
        coeffs = BpaCoeffs(*coeffs)
        nz = coeffs.eta.shape[1] if coeffs.eta.ndim == 2 else 0
        if not 3 <= nz <= NZ_MAX:
            raise ValueError(f"bpa_apply: nz {nz} outside 3..{NZ_MAX}")
        if stack.n_ops < 2:
            raise ValueError("bpa_apply: needs the stack's d/dx and d/dy")
        if round_x_bf16 and stack.dtype != torch.float32:
            raise TypeError("bpa_apply: round_x_bf16 needs float32")
        for i, f in enumerate(coeffs):
            want = (n, nz) if i < N_FIELDS_3D else (n,)
            if tuple(f.shape) != want:
                raise ValueError(f"bpa_apply: {BpaCoeffs._fields[i]} of "
                                 f"shape {tuple(f.shape)}, expected {want}")
            if f.dtype != stack.dtype:
                raise TypeError(f"bpa_apply: {BpaCoeffs._fields[i]} is "
                                f"{f.dtype}, the operators {stack.dtype}")
            if f.device != stack.device:
                raise ValueError("bpa_apply: operands on different devices")
        if rows.free.shape[0] != n or rows.code.device != stack.device:
            raise ValueError("bpa_apply: row tables of another mesh or "
                             "device")
        self.stack, self.rows, self.n, self.nz = stack, rows, n, nz
        self.no_sliding = bool(no_sliding)
        self.round = bool(round_x_bf16)
        # contiguous copies where needed, kept alive with the pointers
        self.coeffs = BpaCoeffs(*(f.contiguous() for f in coeffs))
        self.dtype, self.device = stack.dtype, stack.device
        vals, self.consts = zeta_consts(dzeta, self.dtype, self.device)
        self._index = None          # always the plain version

    def plain(self, u, v):
        return bpa_apply_plain((self.stack.cols, self.stack.vals), self.rows,
                               self.coeffs, self.consts, u, v,
                               self.no_sliding, self.round)

    def flat(self, x):
        """[Au; Av] for x = [u; v], flat vectors of 2 n nz."""
        m = self.n * self.nz
        x = _check_x("bpa_apply", x, (2 * m,), self.dtype, self.device)
        Au, Av = self.plain(x[:m].view(self.n, self.nz),
                            x[m:].view(self.n, self.nz))
        return torch.cat([Au.reshape(-1), Av.reshape(-1)])

    def __call__(self, uv):
        u, v = uv
        shape = (self.n, self.nz)
        u = _check_x("bpa_apply", u, shape, self.dtype, self.device)
        v = _check_x("bpa_apply", v, shape, self.dtype, self.device)
        return self.plain(u, v)


class LineThomas:
    """The vertical-line preconditioner of one viscosity iteration (the
    tridiagonal systems sub [n, nz-1], dia [n, nz], sup [n, nz-1]), checked
    once and bound to the kernel `line_thomas`: one launch solves every
    column for both right-hand sides (a lane each, from shared memory).
    `M((ru, rv))` gives (xu, xv); `M.flat(r)` works on the flat Krylov
    vector."""

    def __init__(self, sub, dia, sup):
        n, nz = dia.shape
        if not 3 <= nz <= NZ_MAX:
            raise ValueError(f"line_thomas: nz {nz} outside 3..{NZ_MAX}")
        for t, shape in ((sub, (n, nz - 1)), (sup, (n, nz - 1))):
            if tuple(t.shape) != shape:
                raise ValueError(f"line_thomas: a band of shape "
                                 f"{tuple(t.shape)}, expected {shape}")
            if t.dtype != dia.dtype or t.device != dia.device:
                raise TypeError("line_thomas: bands of different types or "
                                "devices")
        if dia.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"line_thomas: unsupported dtype {dia.dtype}")
        self.sub, self.dia, self.sup = (t.contiguous()
                                        for t in (sub, dia, sup))
        self.n, self.nz = n, nz
        self.dtype, self.device = dia.dtype, dia.device
        self._index = None          # always the plain version

    def plain(self, ru, rv):
        return line_thomas_plain(self.sub, self.dia, self.sup, ru, rv)

    def flat(self, r):
        m = self.n * self.nz
        r = _check_x("line_thomas", r, (2 * m,), self.dtype, self.device)
        xu, xv = self.plain(r[:m].view(self.n, self.nz),
                            r[m:].view(self.n, self.nz))
        return torch.cat([xu.reshape(-1), xv.reshape(-1)])

    def __call__(self, r):
        ru, rv = r
        shape = (self.n, self.nz)
        ru = _check_x("line_thomas", ru, shape, self.dtype, self.device)
        rv = _check_x("line_thomas", rv, shape, self.dtype, self.device)
        return self.plain(ru, rv)
