"""The stack-SpMV kernel and the DIVA operator fused onto it: build,
binding, wrappers and plain versions.

Counterpart of the reference's ops/pallas_spmv.py. The first function is

    y[o, r, j] = sum_k vals[o, k, r] * x[cols[k, r], j]

for `n_ops` operators sharing one padded-ELL index table `cols`. Tables
are entry-major (`cols` [K, n_rows] int32, `vals` [n_ops, K, n_rows]) so
that neighbouring rows lie at neighbouring addresses; padded entries
point at column 0 with value 0. The second, `diva_apply`, is the whole
linearised SSA/DIVA momentum operator (the five-operator derivative stack
applied to (u, v), the scaling by the per-triangle fields and the
boundary rows; with an ocean-pressure calving front also the front rows
and the identity rows off the ice) in one launch.

The CUDA source csrc/stack_spmv.cu holds both. It is compiled with nvcc
at first use into a shared library with a plain C interface (under build/
beside the package, by `_build.build_kernel`) and loaded with ctypes. A
CUDA tensor always goes to the kernel; only a CPU tensor takes
`stack_spmv_plain` / `diva_apply_plain`, the same arithmetic in plain
tensor code (the CPU path and the kernels' test oracle).

The binding is thin because the Krylov loop calls it once per iteration
and the host, not the card, is what that loop waits for: everything that
depends only on the operator (shapes, types, contiguity, device, the
table pointers) is checked and cached once, in `StackOperator` and
`DivaOperator`; a call checks only its x.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

N_OPS = (1, 5)       # operator counts the kernel is instantiated for

launches = 0         # stack_spmv launches since the caller last set it to 0
diva_launches = 0    # diva_apply launches, likewise
# the type that x is rounded through where an operator rounds it: bfloat16
# as the configurations state; the control of the benchmark's comparison
# sets a lower one (compare.rounded_through). A float8 type is scaled per
# tensor to its largest finite value first, as a float8 path would do.
ROUND_DTYPE = torch.bfloat16


def _round_bf16(x):
    if ROUND_DTYPE.itemsize > 1:
        return x.to(ROUND_DTYPE).to(torch.float32)
    top = torch.finfo(ROUND_DTYPE).max
    scale = (x.abs().amax() / top).clamp_min(torch.finfo(torch.float32).tiny)
    return (x / scale).to(ROUND_DTYPE).to(torch.float32) * scale


def _check_tables(cols, vals):
    """The checks that depend on the operator alone."""
    if cols.ndim != 2 or vals.ndim != 3 or vals.shape[1:] != cols.shape:
        raise ValueError(f"stack_spmv: cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} do not match")
    if vals.device != cols.device:
        raise ValueError("stack_spmv: operands on different devices")
    if vals.device.type == "cpu":
        return
    if vals.device.type != "cuda":
        raise ValueError(f"stack_spmv: unsupported device {vals.device}")
    if cols.dtype != torch.int32:
        raise TypeError("stack_spmv: cols must be int32")
    if vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"stack_spmv: unsupported dtype {vals.dtype}")
    if vals.shape[0] not in N_OPS:
        raise ValueError(f"stack_spmv: the kernel is built for n_ops in "
                         f"{N_OPS}, not {vals.shape[0]}")
    if not (cols.is_contiguous() and vals.is_contiguous()):
        raise ValueError("stack_spmv: cols and vals must be contiguous")


def stack_spmv_plain(cols, vals, x, round_x_bf16=False):
    """Plain tensor version of the kernel (same optional x rounding)."""
    if round_x_bf16:
        x = _round_bf16(x)
    xg = x[cols.long()]                       # [K, n_rows(, d)]
    if x.ndim == 1:
        return (vals * xg[None]).sum(dim=1)
    return (vals[..., None] * xg[None]).sum(dim=1)


class StackOperator:
    """`n_ops` operators over one index table, checked once and bound to
    the kernel: `op(x, round_x_bf16)` is `stack_spmv` without the checks
    that depend only on the tables."""

    __slots__ = ("cols", "vals", "n_ops", "K", "n_rows", "dtype", "device",
                 "_index")

    def __init__(self, cols, vals):
        _check_tables(cols, vals)
        self.cols, self.vals = cols, vals
        self.n_ops, self.K, self.n_rows = vals.shape
        self.dtype, self.device = vals.dtype, vals.device
        self._index = None          # always the plain version

    def __call__(self, x, round_x_bf16=False):
        """y [n_ops, n_rows(, d)] for x [n_cols(, d)]."""
        if x.dtype != self.dtype:
            raise TypeError(f"stack_spmv: x is {x.dtype}, vals {self.dtype}")
        if round_x_bf16 and self.dtype != torch.float32:
            raise TypeError("stack_spmv: round_x_bf16 needs float32")
        nd = x.ndim
        if nd != 1 and nd != 2:
            raise ValueError("stack_spmv: x must be [n_cols] or [n_cols, d]")
        if x.device != self.device:
            raise ValueError("stack_spmv: operands on different devices")
        return stack_spmv_plain(self.cols, self.vals, x, round_x_bf16)


def stack_spmv(cols, vals, x, round_x_bf16=False):
    """y [n_ops, n_rows(, d)] from cols [K, n_rows], vals [n_ops, K, n_rows]
    and x [n_cols(, d)]. `round_x_bf16` (float32 only) rounds x to bfloat16
    and back before the products. For a single apply: it checks the tables
    on every call, so a caller that applies one operator many times keeps
    a `StackOperator` (`EllStack.op`)."""
    return StackOperator(cols, vals)(x, round_x_bf16)


# ---------------------------------------------------------------------------
# The DIVA operator
# ---------------------------------------------------------------------------

ROW_BOUNDARY, ROW_INF_U, ROW_INF_V = 1, 2, 4     # bits of a row's code
ROW_FRONT, ROW_OFF = 8, 16        # per-solve bits of an ocean-pressure front


@dataclass
class DivaRows:
    """Static row tables of the DIVA operator on one mesh: the masks and
    neighbour table the plain version reads, and the same packed for the
    kernel (one code a row: 0 for a free row, else ROW_BOUNDARY plus
    ROW_INF_U / ROW_INF_V where that component's row is the 'infinite'
    form; neighbour triangles as int32 with -1 for none)."""

    TriC: torch.Tensor        # [n, 3] int64 neighbour triangles (pad 0)
    mask_TriC: torch.Tensor   # [n, 3] bool
    free: torch.Tensor        # [n] bool: rows that solve the PDE
    inf_u: torch.Tensor       # [n] bool: 'infinite' u rows
    inf_v: torch.Tensor
    code: torch.Tensor = field(init=False)     # [n] uint8
    tric32: torch.Tensor = field(init=False)   # [n, 3] int32

    def __post_init__(self):
        n = self.free.shape[0]
        if self.TriC.shape != (n, 3) or self.mask_TriC.shape != (n, 3) \
                or self.inf_u.shape != (n,) or self.inf_v.shape != (n,):
            raise ValueError("DivaRows: tables of different row counts")
        code = (ROW_BOUNDARY + ROW_INF_U * self.inf_u.to(torch.uint8)
                + ROW_INF_V * self.inf_v.to(torch.uint8))
        self.code = torch.where(self.free, 0, code).to(torch.uint8)
        self.tric32 = torch.where(self.mask_TriC, self.TriC,
                                  -1).to(torch.int32).contiguous()


def diva_apply_plain(stack, rows, N_b, dN_dx_b, dN_dy_b, beta_eff_b, u, v,
                     round_x_bf16=False, front=None):
    """Plain tensor version of `diva_apply`: (Au, Av) of the linearised
    SSA/DIVA momentum operator (solve_linearised_SSA_DIVA_infinite_slab.f90
    rows) from the five-operator stack `stack` (cols, vals of
    ddx, ddy, d2dx2, d2dxdy, d2dy2 on the b-grid). `front` =
    (is_front, off, n_x, n_y) adds the ocean-pressure calving front
    (solve_linearised_SSA_DIVA_ocean_pressure.f90:445-560): Neumann
    back-pressure rows at the front, identity rows off the ice; off wins
    over front, front over every other row kind."""
    cols, vals = stack
    # all 10 derivative fields at once: u and v ride the trailing axis of
    # the stacked input. The sums run over the entries k = 0, 1, ... in
    # turn from 0, each product and each sum one tensor operation (rounded
    # once, never fused): the kernel's instance with a front adds in this
    # order, and so equals this version to the bit.
    x = torch.stack([u, v], dim=-1)
    if round_x_bf16:
        x = _round_bf16(x)
    xg = x[cols.long()]                       # [K, n_rows, 2]
    # u, v may be a rank's extended [own ; halo] vectors: the rows are the
    # first n_rows entries
    n = cols.shape[1]
    u_ext, v_ext, u, v = u, v, u[:n], v[:n]
    d = torch.zeros((vals.shape[0],) + xg.shape[1:], dtype=x.dtype,
                    device=x.device)
    for k in range(vals.shape[1]):
        d = d + vals[:, k, :, None] * xg[k]
    ddx_u, ddy_u, dxx_u, dxy_u, dyy_u = (d[i][:, 0] for i in range(5))
    ddx_v, ddy_v, dxx_v, dxy_v, dyy_v = (d[i][:, 1] for i in range(5))

    Au = (4 * N_b * dxx_u + 4 * dN_dx_b * ddx_u
          + N_b * dyy_u + dN_dy_b * ddy_u - beta_eff_b * u
          + 3 * N_b * dxy_v + 2 * dN_dx_b * ddy_v + dN_dy_b * ddx_v)
    Av = (4 * N_b * dyy_v + 4 * dN_dy_b * ddy_v
          + N_b * dxx_v + dN_dx_b * ddx_v - beta_eff_b * v
          + 3 * N_b * dxy_u + 2 * dN_dy_b * ddx_u + dN_dx_b * ddy_u)

    # BC rows: zero/fixed -> identity; infinite -> neighbour mean,
    # sum(x[nbrs]) - n*x
    n_nbr = rows.mask_TriC.sum(dim=1).to(N_b.dtype)

    def nbr_mean_residual(x_ext, x):
        s = torch.where(rows.mask_TriC, x_ext[rows.TriC], 0.0).sum(dim=1)
        return s - n_nbr * x

    Au = torch.where(rows.free, Au, torch.where(
        rows.inf_u, nbr_mean_residual(u_ext, u), u))
    Av = torch.where(rows.free, Av, torch.where(
        rows.inf_v, nbr_mean_residual(v_ext, v), v))
    if front is not None:
        is_front, off, n_x, n_y = front
        Au_f = (4 * N_b * n_x * ddx_u + N_b * n_y * ddy_u
                + 2 * N_b * n_x * ddy_v + N_b * n_y * ddx_v)
        Av_f = (4 * N_b * n_y * ddy_v + N_b * n_x * ddx_v
                + 2 * N_b * n_y * ddx_u + N_b * n_x * ddy_u)
        Au = torch.where(off, u, torch.where(is_front, Au_f, Au))
        Av = torch.where(off, v, torch.where(is_front, Av_f, Av))
    return (Au, Av)


class DivaOperator:
    """The DIVA operator for one set of per-triangle fields, checked once
    and bound to the kernel `diva_apply`. `A((u, v))` gives (Au, Av);
    `A.flat(x)` takes and gives the flat Krylov vector [u; v]. In float32
    the derivative terms see u and v rounded to bfloat16 when `stack`
    rounds (its plain apply does); `beta_eff_b * u` and the boundary rows
    never do.

    `front` = (is_front, off, n_x, n_y), per solve, adds the ocean-pressure
    calving front: the operator then carries its own row codes (the static
    ones with ROW_FRONT and ROW_OFF set), formed once here on the device,
    and the kernel instance that reads them and the normals; without a
    front the kernel is the infinite-slab instance.

    On a rank of a sharded run the operator has n_rows rows and `n_cols`
    = n_rows + Hh columns: `extend` maps the rank's (u, v) block
    [n_rows, 2] to its extended [own ; halo] form [n_cols, 2] (the halo
    exchange, md.ext_Tri), and the kernel reads u and v there, at the row
    itself and at its stack and TriC columns. `A.flat` and `A((u, v))`
    take the rank's block either way."""

    def __init__(self, stack: StackOperator, rows: DivaRows, N_b, dN_dx_b,
                 dN_dy_b, beta_eff_b, round_x_bf16=False, front=None,
                 n_cols=None, extend=None):
        n = stack.n_rows
        n_cols = n if n_cols is None else n_cols
        if (extend is None) != (n_cols == n):
            raise ValueError(f"diva_apply: {n_cols} columns on {n} rows "
                             f"need an extend (and only they do)")
        fields = (N_b, dN_dx_b, dN_dy_b, beta_eff_b)
        if stack.n_ops != 5:
            raise ValueError("diva_apply: needs the five-operator stack, "
                             f"got n_ops {stack.n_ops}")
        if round_x_bf16 and stack.dtype != torch.float32:
            raise TypeError("diva_apply: round_x_bf16 needs float32")
        for f in fields:
            if f.shape != (n,):
                raise ValueError(f"diva_apply: a field of shape "
                                 f"{tuple(f.shape)} on {n} rows")
            if f.dtype != stack.dtype:
                raise TypeError(f"diva_apply: a field is {f.dtype}, the "
                                f"operators {stack.dtype}")
        if rows.free.shape[0] != n:
            raise ValueError("diva_apply: row tables of another mesh")
        code, normals = rows.code, ()
        if front is not None:
            is_front, off, n_x, n_y = front
            for m in (is_front, off):
                if m.shape != (n,) or m.dtype != torch.bool:
                    raise ValueError("diva_apply: front masks must be bool "
                                     f"[{n}]")
            for f in (n_x, n_y):
                if f.shape != (n,) or f.dtype != stack.dtype:
                    raise TypeError("diva_apply: front normals must be "
                                    f"{stack.dtype} [{n}]")
            code = (code | (ROW_FRONT * is_front.to(torch.uint8))
                    | (ROW_OFF * off.to(torch.uint8)))
            normals = (n_x.contiguous(), n_y.contiguous())
            front = (is_front, off) + normals
        for t in fields + (code, rows.tric32) + normals:
            if t.device != stack.device:
                raise ValueError("diva_apply: operands on different devices")
        self.stack, self.rows, self.n = stack, rows, n
        self.n_cols, self.extend = n_cols, extend
        self.round = bool(round_x_bf16)
        self.front, self.code = front, code
        # contiguous copies where needed, kept alive with the pointers
        self.fields = tuple(f.contiguous() for f in fields)
        self._index = None          # always the plain version

    def _ext(self, u, v):
        """(u, v) on the operator's columns: the extended vectors of a
        rank (one halo exchange of both), else u and v themselves."""
        if self.extend is None:
            return u, v
        uv = self.extend(torch.stack([u, v], dim=1)).t().contiguous()
        if uv.shape[1] != self.n_cols:
            raise ValueError(f"diva_apply: extend gave {uv.shape[1]} "
                             f"columns, the operator has {self.n_cols}")
        return uv[0], uv[1]

    def _check(self, x, shape):
        if x.dtype != self.stack.dtype:
            raise TypeError(f"diva_apply: x is {x.dtype}, the operators "
                            f"{self.stack.dtype}")
        if x.shape != shape:
            raise ValueError(f"diva_apply: x of shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if x.device != self.stack.device:
            raise ValueError("diva_apply: operands on different devices")
        return x if x.is_contiguous() else x.contiguous()

    def _plain(self, u, v):
        return diva_apply_plain((self.stack.cols, self.stack.vals),
                                self.rows, *self.fields, u, v, self.round,
                                self.front)

    def flat(self, x):
        """[Au; Av] for x = [u; v], both flat vectors of 2 n_rows."""
        n = self.n
        x = self._check(x, (2 * n,))
        if self.extend is not None:
            return torch.cat(self(((x[:n], x[n:]))))
        return torch.cat(self._plain(x[:n], x[n:]))

    def __call__(self, uv):
        u, v = uv
        n = self.n
        u, v = self._ext(self._check(u, (n,)), self._check(v, (n,)))
        return self._plain(u, v)
