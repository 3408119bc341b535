"""The port's Krylov solvers against the JAX package's on the same
systems, in f64: the same stopping rule must stop at the same iteration
count, and the solutions agree.

Tolerance: both sides solve to ||r|| < max(rtol ||b||, abstol) with rtol
1e-10 here, in f64, and differ only in summation order, so the solutions
agree to 1e-9 of max|x|."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from ufemism2_tpu.ops import krylov as jk
from ufemism2_tpu.ops.sparse import ell_from_csr as j_ell

from ufemism2_tpu_torch.ops import krylov as tk
from ufemism2_tpu_torch.ops.sparse import ell_from_csr as t_ell

SOL_TOL = 1e-9


def _mesh_like_matrix(n=900, k=7, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = (rows + rng.integers(-40, 41, size=n * k)) % n
    vals = (rng.random(n * k) - 0.5) * scale
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


def _system(kind, n=400, seed=1):
    """A mesh-like sparse system with a dominant diagonal: 'spd' is
    symmetric positive definite, 'nonsym' is not symmetric."""
    B = _mesh_like_matrix(n=n, seed=seed)
    if kind == "spd":
        A = (B @ B.T + 0.5 * sp.identity(n)).tocsr()
    else:
        A = (B + 2.5 * sp.identity(n)).tocsr()
        assert abs(A - A.T).max() > 0.1
    b = np.random.default_rng(seed + 1).standard_normal(n)
    return A, b


def _ops(A):
    Mj = j_ell(A, dtype=jnp.float64)
    Mt = t_ell(A, dtype=torch.float64, device="cpu")
    dinv = 1.0 / A.diagonal()
    return Mj, Mt, dinv


@pytest.mark.parametrize("restart", [60, 15])
@pytest.mark.parametrize("kind", ["spd", "nonsym"])
def test_gmres_matches_jax(kind, restart):
    A, b = _system(kind)
    Mj, Mt, dinv = _ops(A)
    dj, dt_ = jnp.asarray(dinv), torch.from_numpy(dinv)
    kw = dict(rtol=1e-10, abstol=1e-14, restart=restart)
    rj = jk.gmres(lambda x: Mj @ x, jnp.asarray(b), M=lambda r: dj * r, **kw)
    rt = tk.gmres(lambda x: Mt @ x, torch.from_numpy(b),
                  M=lambda r: dt_ * r, **kw)
    assert rt.converged and bool(rj.converged)
    assert rt.n_iter == int(rj.n_iter) > restart // 4
    xj = np.asarray(rj.x)
    assert np.abs(rt.x.numpy() - xj).max() <= SOL_TOL * np.abs(xj).max()
    assert np.abs(A @ rt.x.numpy() - b).max() < 1e-8
    assert abs(rt.res_norm - float(rj.res_norm)) <= 1e-6 * rt.res_norm + 1e-15


def test_gmres_on_uv_tuple_matches_jax():
    """Operands as (u, v) tuples, as the stress-balance solve passes them,
    with a warm start."""
    A, b = _system("nonsym", n=300, seed=5)
    n = 150
    Mj, Mt, dinv = _ops(A)

    def Aj(uv):
        y = Mj @ jnp.concatenate(uv)
        return (y[:n], y[n:])

    def At(uv):
        y = Mt @ torch.cat(uv)
        return (y[:n], y[n:])

    dj, dt_ = jnp.asarray(dinv), torch.from_numpy(dinv)
    x0 = np.random.default_rng(6).standard_normal(2 * n) * 0.1
    kw = dict(rtol=1e-10, abstol=1e-14, restart=20)
    rj = jk.gmres(Aj, (jnp.asarray(b[:n]), jnp.asarray(b[n:])),
                  x0=(jnp.asarray(x0[:n]), jnp.asarray(x0[n:])),
                  M=lambda r: (dj[:n] * r[0], dj[n:] * r[1]), **kw)
    rt = tk.gmres(At, (torch.from_numpy(b[:n]), torch.from_numpy(b[n:])),
                  x0=(torch.from_numpy(x0[:n]), torch.from_numpy(x0[n:])),
                  M=lambda r: (dt_[:n] * r[0], dt_[n:] * r[1]), **kw)
    assert isinstance(rt.x, tuple) and len(rt.x) == 2
    assert rt.n_iter == int(rj.n_iter) > 0
    for a, c in zip(rt.x, rj.x):
        c = np.asarray(c)
        assert np.abs(a.numpy() - c).max() <= SOL_TOL * np.abs(c).max()

    # an operator that offers itself on the flat vector is applied through
    # `flat` and through nothing else; same iterations, same bits
    class Flat:
        calls = 0

        def __call__(self, uv):
            raise AssertionError("gmres took the tuple form")

        def flat(self, x):
            Flat.calls += 1
            return Mt @ x

    rf = tk.gmres(Flat(), (torch.from_numpy(b[:n]), torch.from_numpy(b[n:])),
                  x0=(torch.from_numpy(x0[:n]), torch.from_numpy(x0[n:])),
                  M=lambda r: (dt_[:n] * r[0], dt_[n:] * r[1]), **kw)
    assert rf.n_iter == rt.n_iter and Flat.calls == rt.n_iter + 1
    assert all(torch.equal(a, c) for a, c in zip(rf.x, rt.x))


@pytest.mark.parametrize("kind", ["spd", "nonsym"])
def test_bicgstab_matches_jax(kind):
    A, b = _system(kind, seed=9)
    Mj, Mt, dinv = _ops(A)
    dj, dt_ = jnp.asarray(dinv), torch.from_numpy(dinv)
    kw = dict(rtol=1e-10, abstol=1e-14)
    rj = jk.bicgstab(lambda x: Mj @ x, jnp.asarray(b),
                     M=lambda r: dj * r, **kw)
    rt = tk.bicgstab(lambda x: Mt @ x, torch.from_numpy(b),
                     M=lambda r: dt_ * r, **kw)
    assert rt.converged and bool(rj.converged)
    assert rt.n_iter == int(rj.n_iter) > 3
    xj = np.asarray(rj.x)
    assert np.abs(rt.x.numpy() - xj).max() <= SOL_TOL * np.abs(xj).max()


def test_stopping_rule_cap_and_zero_rhs():
    """abstol ends a solve whose rhs is tiny at once; maxiter caps the
    count; both as in the JAX solvers."""
    A, b = _system("nonsym", seed=13)
    Mj, Mt, _ = _ops(A)
    z = np.zeros_like(b)
    for name in ("gmres", "bicgstab"):
        rj = getattr(jk, name)(lambda x: Mj @ x, jnp.asarray(z))
        rt = getattr(tk, name)(lambda x: Mt @ x, torch.from_numpy(z))
        assert rt.n_iter == int(rj.n_iter) == 0 and rt.converged
    rj = jk.gmres(lambda x: Mj @ x, jnp.asarray(b), rtol=1e-30, abstol=0.0,
                  maxiter=25, restart=10)
    rt = tk.gmres(lambda x: Mt @ x, torch.from_numpy(b), rtol=1e-30,
                  abstol=0.0, maxiter=25, restart=10)
    assert rt.n_iter == int(rj.n_iter) >= 25 and not rt.converged
    rj = jk.bicgstab(lambda x: Mj @ x, jnp.asarray(b), rtol=1e-30,
                     abstol=0.0, maxiter=7)
    rt = tk.bicgstab(lambda x: Mt @ x, torch.from_numpy(b), rtol=1e-30,
                     abstol=0.0, maxiter=7)
    assert rt.n_iter == int(rj.n_iter) == 7
    assert tk.MAXIT_DEFAULT == jk.MAXIT_DEFAULT == 2000


# cg and the polynomial preconditioners: same iteration counts, solutions
# within 1e-12 of max|x| (f64, summation order apart).
POLY_TOL = 1e-12


@pytest.mark.parametrize("precond", [False, True])
def test_cg_matches_jax(precond):
    A, b = _system("spd", seed=21)
    Mj, Mt, dinv = _ops(A)
    dj, dt_ = jnp.asarray(dinv), torch.from_numpy(dinv)
    kw = dict(rtol=1e-10, abstol=1e-14)
    rj = jk.cg(lambda x: Mj @ x, jnp.asarray(b),
               M=(lambda r: dj * r) if precond else None, **kw)
    rt = tk.cg(lambda x: Mt @ x, torch.from_numpy(b),
               M=(lambda r: dt_ * r) if precond else None, **kw)
    assert rt.converged and bool(rj.converged)
    assert rt.n_iter == int(rj.n_iter) > 3
    xj = np.asarray(rj.x)
    assert np.abs(rt.x.numpy() - xj).max() <= POLY_TOL * np.abs(xj).max()
    assert np.abs(A @ rt.x.numpy() - b).max() < 1e-8
    assert abs(rt.res_norm - float(rj.res_norm)) <= 1e-6 * rt.res_norm


def test_cg_on_tuple_and_cap():
    """(u, v) tuples with a warm start; the cap and a zero rhs as in the
    JAX solver."""
    A, b = _system("spd", n=300, seed=23)
    n = 150
    Mj, Mt, _ = _ops(A)
    x0 = np.random.default_rng(24).standard_normal(2 * n)
    rj = jk.cg(lambda uv: (lambda y: (y[:n], y[n:]))(
        Mj @ jnp.concatenate(uv)), (jnp.asarray(b[:n]), jnp.asarray(b[n:])),
        x0=(jnp.asarray(x0[:n]), jnp.asarray(x0[n:])), rtol=1e-10,
        abstol=1e-14)
    rt = tk.cg(lambda uv: (lambda y: (y[:n], y[n:]))(Mt @ torch.cat(uv)),
               (torch.from_numpy(b[:n]), torch.from_numpy(b[n:])),
               x0=(torch.from_numpy(x0[:n]), torch.from_numpy(x0[n:])),
               rtol=1e-10, abstol=1e-14)
    assert isinstance(rt.x, tuple) and rt.n_iter == int(rj.n_iter) > 3
    for a, c in zip(rt.x, rj.x):
        c = np.asarray(c)
        assert np.abs(a.numpy() - c).max() <= POLY_TOL * np.abs(c).max()
    rj = jk.cg(lambda x: Mj @ x, jnp.asarray(b), rtol=1e-30, abstol=0.0,
               maxiter=9)
    rt = tk.cg(lambda x: Mt @ x, torch.from_numpy(b), rtol=1e-30,
               abstol=0.0, maxiter=9)
    assert rt.n_iter == int(rj.n_iter) == 9 and not rt.converged
    rt = tk.cg(lambda x: Mt @ x, torch.zeros(2 * n, dtype=torch.float64))
    assert rt.n_iter == 0 and rt.converged


@pytest.mark.parametrize("n_its", [1, 10])
def test_estimate_lambda_max_matches_jax(n_its):
    A, b = _system("nonsym", seed=31)
    Mj, Mt, dinv = _ops(A)
    dj, dt_ = jnp.asarray(dinv), torch.from_numpy(dinv)
    lj = jk.estimate_lambda_max(lambda x: dj * (Mj @ x), jnp.asarray(b),
                                n_its=n_its)
    lt = tk.estimate_lambda_max(lambda x: dt_ * (Mt @ x),
                                torch.from_numpy(b), n_its=n_its)
    assert lt.ndim == 0 and lt.dtype == torch.float64
    assert abs(float(lt) - float(lj)) <= 1e-13 * float(lj)
    # a diagonal operator: the power iteration finds its largest entry
    d = torch.cat([torch.linspace(1.0, 3.0, 49, dtype=torch.float64),
                   torch.tensor([5.0], dtype=torch.float64)])
    lam = tk.estimate_lambda_max(lambda x: d * x, torch.ones(50,
                                 dtype=torch.float64), n_its=60)
    assert abs(float(lam) - 5.0) < 1e-6


@pytest.mark.parametrize("degree", [1, 3, 5])
@pytest.mark.parametrize("kind", ["chebyshev", "neumann"])
def test_polynomial_preconditioned_gmres_matches_jax(kind, degree):
    """GMRES with a Chebyshev (interval from estimate_lambda_max) or
    Neumann polynomial over the Jacobi base preconditioner, on an SPD
    system (a real positive spectrum under Jacobi scaling, which the
    Chebyshev interval assumes)."""
    A, b = _system("spd", seed=41)
    Mj, Mt, dinv = _ops(A)
    dj, dt_ = jnp.asarray(dinv), torch.from_numpy(dinv)
    Aj, At = (lambda x: Mj @ x), (lambda x: Mt @ x)
    Bj, Bt = (lambda r: dj * r), (lambda r: dt_ * r)
    if kind == "chebyshev":
        lj = jk.estimate_lambda_max(lambda w: Bj(Aj(w)), jnp.asarray(b))
        lt = tk.estimate_lambda_max(lambda w: Bt(At(w)),
                                    torch.from_numpy(b))
        Pj = jk.make_chebyshev_preconditioner(Aj, Bj, degree, lj)
        Pt = tk.make_chebyshev_preconditioner(At, Bt, degree, lt)
    else:
        Pj = jk.make_neumann_preconditioner(Aj, Bj, degree)
        Pt = tk.make_neumann_preconditioner(At, Bt, degree)
    # one application, then the solve
    zj = np.asarray(Pj(jnp.asarray(b)))
    zt = Pt(torch.from_numpy(b)).numpy()
    assert np.abs(zt - zj).max() <= POLY_TOL * np.abs(zj).max()
    kw = dict(rtol=1e-10, abstol=1e-14, restart=30)
    rj = jk.gmres(Aj, jnp.asarray(b), M=Pj, **kw)
    rt = tk.gmres(At, torch.from_numpy(b), M=Pt, **kw)
    assert rt.converged and bool(rj.converged)
    assert rt.n_iter == int(rj.n_iter) > 0
    xj = np.asarray(rj.x)
    assert np.abs(rt.x.numpy() - xj).max() <= POLY_TOL * np.abs(xj).max()
