"""The halo exchange of the port (parallel/halo.py) against the JAX
package's (ufemism2_tpu/parallel/halo.py): the host tables of
build_halo_plan and shard_ell integer for integer, for the random
mesh-like operators of tests/test_halo.py (n 256 and 1,000, 8 parts) and
a real mesh's M_ddx_a_a; and make_sharded_spmv over 2 gloo ranks spawned
on the CPU against the dense product (rtol 1e-12)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import torch_port_fixture  # noqa: F401  (one torch thread a process)
import torch_dist_ranks as R

from ufemism2_tpu_torch.ops.sparse import ell_from_csr
from ufemism2_tpu_torch.parallel import halo as th
from ufemism2_tpu_torch.parallel.launch import spawn

N_PARTS = 8


def _random_meshlike_csr(n, rng, k=7, bw=40):
    """tests/test_halo.py's banded random sparsity."""
    rows = np.repeat(np.arange(n), k)
    cols = rows + rng.integers(-bw, bw + 1, size=rows.size)
    cols = np.clip(cols, 0, n - 1)
    vals = rng.normal(size=rows.size)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A.sum_duplicates()
    return A


def _real_mesh_csr():
    from ufemism2_tpu.mesh.creation import build_uniform_mesh
    from ufemism2_tpu.mesh.operators import build_all_matrix_operators
    m = build_uniform_mesh(-1e6, 1e6, -1e6, 1e6, 200e3, nit_lloyd=1)
    A = build_all_matrix_operators(m).M_ddx_a_a.tocsr()
    x = np.sin(m.V[:, 0] / 3e5) * np.cos(m.V[:, 1] / 4e5)
    return A, x


def _problems():
    out = []
    for n in (256, 1000):
        rng = np.random.default_rng(0)
        A = _random_meshlike_csr(n, rng)
        out.append((A, rng.normal(size=n)))
    out.append(_real_mesh_csr())
    return out


PROBLEMS = ("random-256", "random-1000", "real-mesh")


@pytest.fixture(scope="module")
def problems():
    return _problems()


def _tables(A, halo, M, arg):
    """(HaloPlan, halo sets, shard_ell output) of one package: M has the
    row-major inds and vals, arg(M) is what its shard_ell takes."""
    inds, vals = np.asarray(M.inds), np.asarray(M.vals)
    rows = np.broadcast_to(np.arange(inds.shape[0])[:, None], inds.shape)
    m = vals != 0
    refs = [(rows[m], inds[m])]
    plan = halo.build_halo_plan(refs, A.shape[1], N_PARTS)
    hs, _ = halo._halo_sets(refs, A.shape[1], N_PARTS)
    return plan, hs, halo.shard_ell(arg(M), plan, halo_sets=hs)


@pytest.mark.parametrize("i", range(3), ids=PROBLEMS)
def test_halo_tables_match_jax(problems, i):
    from ufemism2_tpu.ops.sparse import ell_from_csr as jax_ell
    from ufemism2_tpu.parallel import halo as jh
    A, _ = problems[i]

    class PortEll:       # the port's ELL, seen row-major as the JAX one
        def __init__(self, A):
            self.M = ell_from_csr(A, device="cpu")
            self.inds = self.M.cols.numpy().T
            self.vals = self.M.vals[0].numpy().T

    pj, hs_j, Mj = _tables(A, jh, jax_ell(A), lambda M: M)
    port = PortEll(A)
    pt, hs_t, (inds_t, vals_t, n_cols_t) = _tables(
        A, th, port, lambda M: (M.inds, M.vals))
    for name in ("send_idx", "send_mask", "recv_map", "recv_mask"):
        np.testing.assert_array_equal(getattr(pt, name),
                                      np.asarray(getattr(pj, name)),
                                      err_msg=name)
    assert (pt.n, pt.n_parts, pt.nL) == (pj.n, pj.n_parts, pj.nL)
    for a, b in zip(hs_t, hs_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(inds_t, np.asarray(Mj.inds))
    np.testing.assert_array_equal(vals_t, np.asarray(Mj.vals))
    assert n_cols_t == Mj.n_cols
    # the port's EllMatrix in, the same tables out
    assert np.array_equal(th.shard_ell(port.M, pt, halo_sets=hs_t)[0],
                          inds_t)


@pytest.fixture(scope="module")
def sharded_products(problems):
    return spawn(R.sharded_spmv_runs, 2, "gloo", ["cpu"] * 2,
                 args=(problems,))


@pytest.mark.parametrize("i", range(3), ids=PROBLEMS)
def test_sharded_spmv_matches_dense(problems, sharded_products, i):
    A, x = problems[i]
    y_ref = A @ x
    for rank_out in sharded_products:
        y, Hh, nL = rank_out[i]
        np.testing.assert_allclose(y, y_ref, rtol=1e-12, atol=1e-12)
        # the halo never exceeds the other rank's block
        assert Hh <= A.shape[1] - nL


def test_halo_exchange_outside_a_rank_context_raises():
    from ufemism2_tpu_torch.parallel.comm import HaloTables, halo_extend
    z = torch.zeros(1, dtype=torch.int64)
    t = HaloTables(z, z.bool(), z, z.bool())
    with pytest.raises(RuntimeError, match="rank_ctx"):
        halo_extend(torch.zeros(3), t)


@pytest.mark.parametrize("n_parts", (2, 4, 8))
def test_renumbering_matches_jax(n_parts):
    """renumber_contiguous (the Morton order of vertices, triangles and
    edges) and pad_to_multiple, as the JAX package's."""
    from ufemism2_tpu.mesh.creation import build_uniform_mesh
    from ufemism2_tpu.parallel import sharding as js
    from ufemism2_tpu_torch.parallel import sharding as ts
    m = build_uniform_mesh(-1e6, 1e6, -1e6, 1e6, 200e3, nit_lloyd=1)
    for a, b in zip(ts.renumber_contiguous(m, n_parts),
                    js.renumber_contiguous(m, n_parts)):
        np.testing.assert_array_equal(a, b)
    assert ts.pad_to_multiple(m.nV, n_parts) == js.pad_to_multiple(
        m.nV, n_parts) >= m.nV
