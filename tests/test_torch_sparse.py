"""The port's ELL stack SpMV (the module that holds the CUDA kernel; on
the CPU its wrapper runs the plain tensor version) against the JAX
package's applies on the same matrices and vectors:

- f32: `TiledEllStack.apply`, `GroupedTiledEllStack.apply` and the Pallas
  kernel `grouped_apply_pallas(interpret=True)`, with x exact and with x
  rounded to bfloat16 (the JAX default);
- f64: `ell_spmv` and scipy.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from torch_port_fixture import ell_to_dense

from ufemism2_tpu.ops import sparse as sps
from ufemism2_tpu.ops.sparse import (ell_from_csr as j_ell_from_csr,
                                     tiled_stack_from_csr,
                                     grouped_stack_from_csr)
from ufemism2_tpu.ops.pallas_spmv import grouped_apply_pallas

from ufemism2_tpu_torch.convert import ell_from_scipy
from ufemism2_tpu_torch.ops import cuda_spmv
from ufemism2_tpu_torch.ops.sparse import (EllMatrix, EllStack, ell_from_csr,
                                           exact_mv)

# The JAX side stores f32 coefficients as a bf16 (hi, lo) pair, exact to
# 2^-17 relative; 3e-5 of max|y| is its own test's bound for that
# (tests/test_split_spmv.py). The port's coefficients are plain f32.
F32_TOL = 3e-5
# f64 on both sides: only the summation order differs.
F64_TOL = 1e-12


def _mesh_like_matrix(n=900, k=7, scale=1e10, seed=0):
    """Banded matrix with ~vertex-degree row nnz (mesh-operator-like)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = (rows + rng.integers(-40, 41, size=n * k)) % n
    vals = (rng.random(n * k) - 0.5) * scale
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


def _mats(n_ops, n=640, seed=3):
    """n_ops matrices sharing one sparsity pattern."""
    A = _mesh_like_matrix(n=n, seed=seed)
    fac = [1.0, 2.0, -0.5, 1.7, 0.3][:n_ops]
    return [A.multiply(f).tocsr() for f in fac]


def _x(n, d, seed):
    rng = np.random.default_rng(seed)
    shape = (n,) if d == 1 else (n, d)
    return rng.standard_normal(shape).astype(np.float32)


def _with_modes(x_split, fn):
    """Run fn with the JAX package's split-SpMV mode and the given x
    handling ('bits' = x exact, 'none' = x rounded to bf16, its default)."""
    old = sps._SPMV_MODE, sps._X_SPLIT
    sps._SPMV_MODE, sps._X_SPLIT = "split", x_split
    try:
        return fn()
    finally:
        sps._SPMV_MODE, sps._X_SPLIT = old


def _rel(y, ref):
    return np.abs(np.asarray(y, np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("exact", [True, False], ids=["x_exact", "x_bf16"])
@pytest.mark.parametrize("d", [1, 2, 12])
@pytest.mark.parametrize("n_ops", [1, 2, 5])
def test_stack_apply_f32_matches_jax(n_ops, d, exact):
    mats = _mats(n_ops)
    x = _x(mats[0].shape[1], d, seed=10 * n_ops + d)
    S = ell_from_scipy(mats, device="cpu", dtype=torch.float32)
    assert S.n_ops == n_ops and S.cols.dtype == torch.int32
    y = S.apply(torch.from_numpy(x), exact=exact).numpy()
    assert y.shape == (n_ops,) + mats[0].shape[:1] + x.shape[1:]
    assert y.dtype == np.float32

    def jax_side():
        T = tiled_stack_from_csr(mats, dtype=jnp.float32)
        G = grouped_stack_from_csr(mats, dtype=jnp.float32)
        out = {"tiled": np.asarray(T.apply(jnp.asarray(x))),
               "grouped": np.asarray(G.apply(jnp.asarray(x)))}
        if exact:
            # the Pallas kernel always splits x exactly (hi*(xh+xl)+lo*xh)
            out["pallas"] = np.asarray(
                grouped_apply_pallas(G, jnp.asarray(x), interpret=True))
        return out

    ref = _with_modes("bits" if exact else "none", jax_side)
    for name, yj in ref.items():
        den = np.abs(yj).max()
        gap = np.abs(y.astype(np.float64) - yj).max() / den
        assert gap < F32_TOL, f"{name}: {gap:.2e}"
    if exact:
        # and against scipy in f64: the port's f32 products are exact to
        # f32 rounding of the coefficients and sums
        for i, m in enumerate(mats):
            assert _rel(y[i], m @ x.astype(np.float64)) < F32_TOL


@pytest.mark.parametrize("d", [1, 2, 12])
@pytest.mark.parametrize("n_ops", [1, 2, 5])
def test_stack_apply_f64_matches_jax_ell_and_scipy(n_ops, d):
    mats = _mats(n_ops, seed=7)
    x = _x(mats[0].shape[1], d, seed=20 * n_ops + d).astype(np.float64)
    S = ell_from_scipy(mats, device="cpu", dtype=torch.float64)
    xt = torch.from_numpy(x)
    y = S.apply(xt).numpy()
    # nothing is rounded in f64: a plain apply equals an exact one
    assert np.array_equal(y, S.apply(xt, exact=True).numpy())
    for i, m in enumerate(mats):
        Mj = j_ell_from_csr(m, dtype=jnp.float64)
        yj = np.asarray(Mj @ jnp.asarray(x))
        assert _rel(y[i], yj) < F64_TOL
        assert _rel(y[i], m @ x) < F64_TOL


def test_rounding_is_bf16_nearest_even_on_x_only():
    """`M @ x` rounds x (not the coefficients) to bfloat16 in f32;
    `exact_matvec` does not; both in f64 are exact."""
    A = _mesh_like_matrix(n=300, seed=11)
    x = _x(300, 1, seed=12) * 3000.0
    M = ell_from_csr(A, dtype=torch.float32, device="cpu")
    assert isinstance(M, EllMatrix)
    xt = torch.from_numpy(x)
    x_r = xt.to(torch.bfloat16).to(torch.float32)
    y_round = (M @ xt).numpy()
    assert np.array_equal(y_round, M.exact_matvec(x_r).numpy())
    assert _rel(M.exact_matvec(xt).numpy(), A @ x.astype(np.float64)) < 1e-5
    assert _rel(exact_mv(M, xt).numpy(), A @ x.astype(np.float64)) < 1e-5
    # the rounded apply differs from the exact one by about 2^-9 of x
    gap = _rel(y_round, A @ x.astype(np.float64))
    assert 1e-5 < gap < 2e-2
    # the same contract as the JAX default apply (x rounded, slab exact)
    yj = _with_modes("none", lambda: np.asarray(
        sps.tiled_from_csr(A, dtype=jnp.float32) @ jnp.asarray(x)))
    assert _rel(y_round, yj.astype(np.float64)) < F32_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_M2_stack_of_a_small_mesh(small_mesh_ops, dtype):
    """The five shared-pattern b-grid operators of a real (small) mesh,
    applied to (u, v) at once as make_A does."""
    ops = small_mesh_ops
    mats = [ops.M2_ddx_b_b, ops.M2_ddy_b_b, ops.M2_d2dx2_b_b,
            ops.M2_d2dxdy_b_b, ops.M2_d2dy2_b_b]
    n = mats[0].shape[1]
    uv = np.random.default_rng(5).standard_normal((n, 2)) * 100.0
    S = ell_from_scipy(mats, device="cpu", dtype=dtype)
    assert S.n_ops == 5 and S.K <= 16
    y = S.apply(torch.as_tensor(uv, dtype=dtype), exact=True).numpy()
    tol = F64_TOL if dtype == torch.float64 else 1e-5
    for i, m in enumerate(mats):
        ref = m @ uv
        assert np.abs(y[i] - ref).max() <= tol * np.abs(ref).max()
        # the table holds the operator itself
        assert np.abs(ell_to_dense(S, i) - m.toarray()).max() <= \
            (0 if dtype == torch.float64 else 1e-6 * abs(m).max())
    if dtype == torch.float32:
        def jax_side():
            T = tiled_stack_from_csr(mats, dtype=jnp.float32)
            return np.asarray(T.apply(jnp.asarray(uv, jnp.float32)))
        yj = _with_modes("bits", jax_side)
        for i in range(5):
            assert _rel(y[i], yj[i].astype(np.float64)) < F32_TOL


def test_wrapper_checks_and_counts():
    """Shape, dtype and device checks - those of the tables alone when the
    operator is built, those of x on each call; on the CPU the wrapper
    takes the plain version and launches (and counts) nothing."""
    S = ell_from_scipy(_mats(2, n=64), device="cpu", dtype=torch.float32)
    x = torch.zeros(64)
    before = cuda_spmv.launches
    y = cuda_spmv.stack_spmv(S.cols, S.vals, x)
    assert y.shape == (2, 64)
    assert torch.equal(S.apply(x, exact=True), y)
    assert torch.equal(S.op(x), y)
    assert cuda_spmv.launches == before
    # once, at construction: tables that do not match
    with pytest.raises(ValueError):
        EllStack(S.cols[:, :10], S.vals, S.n_cols)
    with pytest.raises(ValueError):
        cuda_spmv.StackOperator(S.cols, S.vals[0])
    with pytest.raises(ValueError):
        S.to("meta")              # neither the CPU nor a CUDA device
    # per call: what depends on x
    with pytest.raises(TypeError):
        S.op(x.double())
    with pytest.raises(ValueError):
        S.op(x.to("meta"))
    with pytest.raises(TypeError):
        cuda_spmv.stack_spmv(S.cols, S.vals, x.double())
    with pytest.raises(TypeError):
        S64 = ell_from_scipy(_mats(2, n=64), device="cpu",
                             dtype=torch.float64)
        cuda_spmv.stack_spmv(S64.cols, S64.vals, x.double(),
                             round_x_bf16=True)
    with pytest.raises(ValueError):
        cuda_spmv.stack_spmv(S.cols[:, :10], S.vals, x)
    with pytest.raises(ValueError):
        S.apply(torch.zeros(65))
    with pytest.raises(ValueError):
        cuda_spmv.stack_spmv(S.cols, S.vals, torch.zeros(64, 2, 2))


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a CUDA device")
def test_default_device_is_the_card_and_never_the_host(small_mesh):
    """Every function that makes device data defaults to the card and
    raises without one; the host has to be asked for by name."""
    from ufemism2_tpu_torch.convert import ice_state_from_numpy
    from ufemism2_tpu_torch.core.mesh_data import build_mesh_data
    from ufemism2_tpu_torch.ops import resolve_device
    from ufemism2_tpu_torch.ops.sparse import ell_stack_from_csr
    mats = _mats(2, n=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ell_from_csr(mats[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ell_stack_from_csr(mats)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ell_from_scipy(mats, "cuda", torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ice_state_from_numpy({}, "cuda", torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mesh_data(small_mesh)
    with pytest.raises(TypeError):
        ell_from_scipy(mats)                  # the device is not optional
    assert resolve_device("cpu") == torch.device("cpu")
    assert ell_from_csr(mats[0], device="cpu").cols.device.type == "cpu"
