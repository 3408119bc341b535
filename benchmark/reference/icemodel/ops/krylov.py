"""Matrix-free preconditioned Krylov solvers (eager, host-driven loops).

Counterpart of the reference's lax.while_loop solvers, themselves a
replacement for its PETSc KSP bridge (src/UPSY/basic/petsc_basic.f90:
33-242): the stress-balance system is solved by restarted GMRES and the
semi-implicit-mass system by BiCGSTAB, with a (block-)Jacobi
preconditioner, with the same convergence criterion
(||r|| < max(rtol*||b||, abstol)) and the same 2000-iteration cap.
Iteration counts are returned (the scoreboard's n_Axb_its metric).
`cg` solves SPD systems; the Chebyshev and Neumann polynomial
preconditioners accelerate a base preconditioner with operator applies
only.

A is any callable x -> A@x (a tensor or a tuple of tensors in, same out);
M is the preconditioner application (approximate A^-1). `gmres` works on
one flat vector; an A on a tuple that has an attribute `flat` (the same
operator on the concatenation of the leaves) is applied through it, and
so is a preconditioner with one.

The vectors live on the device; the loops run in Python and read one
small result back per iteration (the residual estimate), which is what
lets them stop at the same iteration as the reference's on-device loops.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import scipy.linalg
import torch

from ..parallel import comm

MAXIT_DEFAULT = 2000  # petsc_basic.f90:166 KSPSetTolerances maxit

# all inner products / norms route through parallel.comm (the reference's
# MPI_ALLREDUCE inside PETSc KSP)
_dot = comm.dot


def _map(fn, *xs):
    """Apply fn leaf-wise to tensors or equal-length tuples of tensors."""
    if isinstance(xs[0], (tuple, list)):
        return tuple(fn(*leaves) for leaves in zip(*xs))
    return fn(*xs)


def _axpy(alpha, x, y):
    return _map(lambda a, b: alpha * a + b, x, y)


def _scale(alpha, x):
    return _map(lambda a: alpha * a, x)


def _add(x, y):
    return _map(torch.add, x, y)


def _sub(x, y):
    return _map(torch.sub, x, y)


class KrylovResult(NamedTuple):
    x: object
    n_iter: int
    converged: bool
    res_norm: float


def estimate_lambda_max(B: Callable, v0, n_its: int = 10):
    """Largest-magnitude eigenvalue of the linear operator B by power
    iteration (tensor or tuple in/out). Used to set the Chebyshev interval
    for the polynomial preconditioners; n_its operator applies, amortised
    over the hundreds of applies they save. Returns a 0-d tensor."""
    nrm0 = torch.sqrt(_dot(v0, v0))
    v = _scale(1.0 / torch.clamp(nrm0, min=1e-30), v0)
    lam = torch.ones_like(nrm0)
    for _ in range(n_its):
        w = B(v)
        lam = torch.sqrt(_dot(w, w))
        v = _scale(1.0 / torch.clamp(lam, min=1e-30), w)
    return lam


def make_chebyshev_preconditioner(A: Callable, M: Callable, degree: int,
                                  lam_max, lam_ratio: float = 20.0):
    """Chebyshev polynomial acceleration of a base preconditioner M.

    Returns M_cheb(r) ~= A^-1 r built from `degree` applications of the
    M-preconditioned operator B = M o A, optimal over the real interval
    [lam_max/lam_ratio, 1.1*lam_max] (Golub & Varga semi-iteration): only
    operator applies and elementwise updates, no triangular solves. The
    reference gets the equivalent robustness from PETSc's ILU-class
    preconditioners (petsc_basic.f90).
    """
    lmax = 1.1 * lam_max
    lmin = lam_max / lam_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def B(v):
        return M(A(v))

    def Mc(r):
        g = M(r)
        z = _scale(1.0 / theta, g)
        if degree == 1:
            return z
        rk = _sub(g, B(z))
        dz = z
        rho = 1.0 / sigma
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            dz = _add(_scale(rho_new * rho, dz),
                      _scale(2.0 * rho_new / delta, rk))
            z = _add(z, dz)
            rk = _sub(rk, B(dz))
            rho = rho_new
        return z
    return Mc


def make_neumann_preconditioner(A: Callable, M: Callable, degree: int):
    """Truncated Neumann series over a base preconditioner:
    M_p = sum_{i<degree} (I - M A)^i M. Valid when rho(I - M A) < 1; no
    spectrum estimate needed."""
    def Mp(r):
        z = M(r)
        acc = z
        for _ in range(degree - 1):
            resid = _sub(r, A(acc))
            acc = _add(acc, M(resid))
        return acc
    return Mp


def bicgstab(A: Callable, b, x0=None, M: Callable = None,
             rtol=1e-7, abstol=1e-5, maxiter=MAXIT_DEFAULT) -> KrylovResult:
    """Preconditioned BiCGSTAB (right-preconditioned, PETSc-style norms)."""
    if M is None:
        M = lambda z: z
    x0 = x0 if x0 is not None else _map(torch.zeros_like, b)

    b_norm = torch.sqrt(_dot(b, b))
    tol = max(rtol * float(b_norm), abstol)

    r = _sub(b, A(x0))
    rhat = r
    x = x0
    p = v = _map(torch.zeros_like, b)
    rho = alpha = omega = torch.ones_like(b_norm)
    rnorm = float(torch.sqrt(_dot(r, r)))
    k = 0
    breakdown = False

    while rnorm > tol and k < maxiter and not breakdown:
        # guard denominators with 1.0 (NOT a tiny number): a guarded
        # division must stay benign - x/1e-300 manufactures infs that
        # poison x via inf-inf. Vanishing rho/omega is flagged as
        # breakdown below instead.
        rho1 = _dot(rhat, r)
        denom_beta = rho * omega
        beta = (rho1 / torch.where(denom_beta == 0, 1.0, denom_beta)) * \
               (alpha / torch.where(omega == 0, 1.0, omega))
        p = _axpy(beta, _sub(p, _scale(omega, v)), r)
        phat = M(p)
        v = A(phat)
        denom = _dot(rhat, v)
        alpha = rho1 / torch.where(denom == 0, 1.0, denom)
        sres = _sub(r, _scale(alpha, v))
        # early convergence at the half-step (||s|| small): take
        # x += alpha p and stop - the omega step would be 0/0 garbage
        snorm = torch.sqrt(_dot(sres, sres))
        s_small = snorm <= tol
        shat = M(sres)
        t = A(shat)
        tt = _dot(t, t)
        omega = _dot(t, sres) / torch.where(tt == 0, 1.0, tt)
        omega = torch.where(s_small | (tt == 0), 0.0, omega)
        x = _add(x, _add(_scale(alpha, phat), _scale(omega, shat)))
        r = _sub(sres, _scale(omega, t))
        rn = torch.sqrt(_dot(r, r))
        bd = (torch.abs(rho1) < 1e-300) \
            | (~s_small & (torch.abs(omega) < 1e-300)) \
            | ~torch.isfinite(rn)
        rho = rho1
        k += 1
        # the one host read of the iteration
        rnorm, bd_f = torch.stack([rn, bd.to(rn.dtype)]).tolist()
        breakdown = bd_f != 0.0

    return KrylovResult(x, k, rnorm <= tol, rnorm)


def cg(A: Callable, b, x0=None, M: Callable = None,
       rtol=1e-7, abstol=1e-5, maxiter=MAXIT_DEFAULT) -> KrylovResult:
    """Preconditioned conjugate gradients (SPD systems)."""
    if M is None:
        M = lambda z: z
    x = x0 if x0 is not None else _map(torch.zeros_like, b)
    b_norm = torch.sqrt(_dot(b, b))
    tol = max(rtol * float(b_norm), abstol)

    r = _sub(b, A(x))
    z = M(r)
    p = z
    rz = _dot(r, z)
    rnorm = float(torch.sqrt(_dot(r, r)))
    k = 0
    while rnorm > tol and k < maxiter:
        Ap = A(p)
        denom = _dot(p, Ap)
        alpha = rz / torch.where(denom == 0, 1e-300, denom)
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, Ap, r)
        z = M(r)
        rz_new = _dot(r, z)
        beta = rz_new / torch.where(rz == 0, 1e-300, rz)
        p = _axpy(beta, p, z)
        rz = rz_new
        k += 1
        # the one host read of the iteration
        rnorm = float(torch.sqrt(_dot(r, r)))
    return KrylovResult(x, k, rnorm <= tol, rnorm)


def gmres(A: Callable, b, x0=None, M: Callable = None,
          rtol=1e-7, abstol=1e-5, maxiter=MAXIT_DEFAULT,
          restart=60) -> KrylovResult:
    """Left-preconditioned restarted GMRES(m).

    More robust than BiCGSTAB on the ill-conditioned stress-balance systems
    near the grounding line (the reference leans on PETSc's default GMRES,
    which also preconditions on the left). Left preconditioning matters in
    f32: the block-Jacobi M normalises the wildly-scaled stress-balance
    rows (coefficients span ~1e13) to O(1) BEFORE orthogonalisation, so
    the Krylov basis stays accurate in single precision. Works on tuples
    by flattening to a single vector; convergence is on the preconditioned
    residual norm (PETSc KSP_NORM_PRECONDITIONED default).
    """
    if M is None:
        M = lambda z: z
    x0 = x0 if x0 is not None else _map(torch.zeros_like, b)

    # flatten tuple <-> vector
    is_tuple = isinstance(b, (tuple, list))
    leaves = list(b) if is_tuple else [b]
    shapes = [l.shape for l in leaves]
    sizes = [int(np.prod(s)) for s in shapes]
    offs = np.cumsum([0] + sizes)

    def flat(t):
        ls = list(t) if is_tuple else [t]
        return torch.cat([l.reshape(-1) for l in ls])

    def unflat(v):
        parts = [v[offs[i]:offs[i + 1]].reshape(shapes[i])
                 for i in range(len(shapes))]
        return tuple(parts) if is_tuple else parts[0]

    # an operator or a preconditioner on a tuple may offer itself on the
    # flat vector (`A.flat`, `M.flat`), which saves the split and the
    # concatenation per apply
    A_flat = getattr(A, "flat", None) if is_tuple else None
    M_flat = getattr(M, "flat", None) if is_tuple else None

    def Af(v):
        return A_flat(v) if A_flat is not None else flat(A(unflat(v)))

    def Mf(v):
        return M_flat(v) if M_flat is not None else flat(M(unflat(v)))

    bf = flat(b)
    xf0 = flat(x0)
    n = bf.shape[0]
    m = min(restart, n)
    dtype = bf.dtype
    ndt = np.float32 if dtype == torch.float32 else np.float64
    tol = max(rtol * float(comm.norm(Mf(bf))), abstol)
    tiny = 1e-30

    def arnoldi_cycle(x):
        """One GMRES(m) cycle from x with TRUE early exit: the Hessenberg
        column is rotated incrementally (Givens, tracked through an
        accumulated [m+1,m+1] rotation product G), giving the
        least-squares residual |beta*G[j+1,0]| for free after every
        matvec - the loop stops the moment it drops under tol instead of
        burning the full restart length (PETSc KSPGMRES does exactly
        this). The basis stays on the device; the small rotated
        Hessenberg lives on the host in the working precision.
        Returns (x_new, rnorm, matvecs)."""
        r = Mf(bf - Af(x))
        beta_t = comm.norm(r)
        Vm = torch.zeros((m + 1, n), dtype=dtype, device=bf.device)
        Vm[0] = r / torch.where(beta_t == 0, 1.0, beta_t)
        beta = ndt(float(beta_t))
        R = np.zeros((m + 1, m), ndt)         # rotated Hessenberg
        G = np.eye(m + 1, dtype=ndt)          # accumulated rotations
        j, res = 0, float(beta)

        while j < m and res > tol:
            # CGS2 (classical Gram-Schmidt, re-orthogonalised): two dense
            # [j+1,n]@[n] products instead of a sequential inner loop -
            # numerically equivalent to MGS in practice; each column of
            # products summed over the ranks of a sharded run
            w = Mf(Af(Vm[j]))
            Vj = Vm[:j + 1]
            h1 = comm.gsum(Vj @ w)
            w = w - h1 @ Vj
            h2 = comm.gsum(Vj @ w)
            w = w - h2 @ Vj
            hj1 = comm.norm(w)
            Vm[j + 1] = w / torch.where(hj1 < tiny, 1.0, hj1)
            # the one host read of the iteration: the Hessenberg column
            hcol = torch.cat([h1 + h2, hj1.reshape(1)]).cpu().numpy()
            h = np.zeros(m + 1, ndt)
            h[:j + 2] = hcol
            hr = (G * h[None, :]).sum(-1)
            # new Givens rotation zeroing hr[j+1] against hr[j]
            a, bb = hr[j], hr[j + 1]
            rho = np.sqrt(a * a + bb * bb)
            if rho < tiny:
                c_, s_ = ndt(1.0), ndt(0.0)
            else:
                c_, s_ = a / rho, bb / rho
            hr[j] = rho
            hr[j + 1] = 0.0
            R[:, j] = hr
            Gj = c_ * G[j] + s_ * G[j + 1]
            Gj1 = -s_ * G[j] + c_ * G[j + 1]
            G[j], G[j + 1] = Gj, Gj1
            res = float(beta * abs(G[j + 1, 0]))   # LS residual estimate
            j += 1

        jf = j
        if jf > 0:
            Rs = R[:jf, :jf].copy()
            rd = np.diagonal(Rs)
            Rs = Rs + np.diag(np.where(np.abs(rd) < tiny, ndt(tiny),
                                       ndt(0.0)))
            g = beta * G[:jf, 0]
            y = scipy.linalg.solve_triangular(Rs, g, lower=False)
            y_t = torch.as_tensor(np.asarray(y, ndt), device=bf.device)
            x_new = x + y_t @ Vm[:jf]
        else:
            x_new = x
        rnorm = float(comm.norm(Mf(bf - Af(x_new))))
        return x_new, rnorm, jf + 2   # jf matvecs + initial r + final check

    x = xf0
    rnorm = float(comm.norm(Mf(bf - Af(xf0))))
    rprev = float("inf")
    k = 0
    # stop on convergence, iteration cap, or stagnation (a full restart
    # cycle reducing the residual by <5% means the precision floor is
    # reached - burning more cycles cannot help; the Picard outer
    # iteration absorbs the remaining error)
    while rnorm > tol and k < maxiter and rnorm < 0.95 * rprev:
        x_new, rn, mv = arnoldi_cycle(x)
        x, rprev, rnorm = x_new, rnorm, rn
        k += mv
    return KrylovResult(unflat(x), k, rnorm <= tol, rnorm)
