"""The port's remapping (`remap/clipping.py`, `remap/conservative.py`,
`remap/atlas.py`) and the remap of the whole ice state
(`core/fields.py remap_ice_state`) against the JAX package's, on the CPU.

Both packages build the maps with the same numpy and scipy arithmetic;
the port finds the triangle that holds a point with its own locator
(the trapezoid map's tie rule, core/ice/bedrock_cdf.py) where the JAX
package asks matplotlib. Every map agrees to 1e-13 of its largest entry
(measured: exactly equal), the polygon clipping and the 1-D vertical
remap exactly, the remapped state exactly."""

import gc

import numpy as np
import pytest
import torch

from torch_port_fixture import (build_meshes, configs, mesh_to_numpy,
                                state_to_numpy)

from ufemism2_tpu.core.fields import remap_ice_state as jax_remap_state
from ufemism2_tpu.core.ice.state import init_ice_state as jax_init_state
from ufemism2_tpu.core.mesh_data import build_mesh_data as jax_mesh_data
from ufemism2_tpu.mesh import build_mesh_from_config as jax_build_mesh
from ufemism2_tpu.mesh.grids import setup_square_grid as jax_grid
from ufemism2_tpu.remap import clipping as jclip
from ufemism2_tpu.remap import conservative as jcons
from ufemism2_tpu.remap.atlas import Atlas as JaxAtlas

from ufemism2_tpu_torch.convert import ice_state_from_numpy, mesh_from_numpy
from ufemism2_tpu_torch.core.fields import remap_ice_state
from ufemism2_tpu_torch.core.ice.state import init_ice_state
from ufemism2_tpu_torch.core.mesh_data import build_mesh_data
from ufemism2_tpu_torch.io.output_files import _state_leaves
from ufemism2_tpu_torch.mesh.grids import setup_square_grid
from ufemism2_tpu_torch.remap import clipping as tclip
from ufemism2_tpu_torch.remap import conservative as tcons
from ufemism2_tpu_torch.remap.atlas import Atlas

MAP_TOL = 1e-13
METHODS = ("2nd_order_conservative", "1st_order_conservative", "trilin",
           "nearest_neighbour")


class Env:
    pass


@pytest.fixture(scope="module")
def env():
    e = Env()
    e.mesh_j, e.mesh_t = build_meshes()
    # a second, finer mesh of the same domain: the target of a remesh
    Cj, _ = configs(maximum_resolution_grounding_line=40e3,
                    grounding_line_width=40e3)
    e.mesh2_j = jax_build_mesh(Cj, "ANT")
    e.mesh2_t = mesh_from_numpy(mesh_to_numpy(e.mesh2_j))
    e.grid_j = jax_grid(-1000e3, 1000e3, -1000e3, 1000e3, 100e3)
    e.grid_t = setup_square_grid(-1000e3, 1000e3, -1000e3, 1000e3, 100e3)
    return e


def _convex_polygons(rng, n, k):
    """n random convex CCW polygons of k vertices (points on ellipses)."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, k)), axis=1)
    c = rng.uniform(-1, 1, (n, 1, 2))
    r = rng.uniform(0.2, 1.0, (n, 1, 2))
    return c + r * np.stack([np.cos(ang), np.sin(ang)], axis=2)


def test_clipping_matches_jax():
    """clip_convex, polygon_areas_centroids and pad_polygons, on random
    convex polygon pairs (overlapping, nested and disjoint)."""
    rng = np.random.default_rng(0)
    subj = _convex_polygons(rng, 400, 6)
    clip = _convex_polygons(rng, 400, 4)
    nv_s = rng.integers(3, 7, 400)
    nv_c = rng.integers(3, 5, 400)
    out_j, nv_j = jclip.clip_convex(subj, nv_s, clip, nv_c)
    out_t, nv_t = tclip.clip_convex(subj, nv_s, clip, nv_c)
    assert np.array_equal(nv_j, nv_t) and np.array_equal(out_j, out_t)
    assert (nv_t == 0).any() and (nv_t > 0).any()
    Aj, cj = jclip.polygon_areas_centroids(out_j, nv_j)
    At, ct = tclip.polygon_areas_centroids(out_t, nv_t)
    assert np.array_equal(Aj, At) and np.array_equal(cj, ct)
    polys = [subj[i, :nv_s[i]] for i in range(20)]
    for a, b in zip(jclip.pad_polygons(polys), tclip.pad_polygons(polys)):
        assert np.array_equal(a, b)


def _sparse_gap(A, B):
    D = (A - B).tocsr()
    return (abs(D).max() if D.nnz else 0.0) / abs(A).max()


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dst", ["mesh", "grid"])
def test_maps_match_jax(env, method, dst):
    """get_map from the fixture mesh to a finer mesh and to a square
    grid, by every method: the same sparse matrix."""
    d_j, d_t = (env.mesh2_j, env.mesh2_t) if dst == "mesh" \
        else (env.grid_j, env.grid_t)
    Mj = JaxAtlas().get(env.mesh_j, d_j, method)
    Mt = Atlas().get(env.mesh_t, d_t, method)
    assert Mj.shape == Mt.shape
    assert _sparse_gap(Mj, Mt) <= MAP_TOL


def test_triangle_map_matches_jax(env):
    """The conservative map from the triangles of one mesh (the b-grid)
    to the vertices of another."""
    Mj = JaxAtlas().get(env.mesh_j, env.mesh2_j, src_grid_type="triangles")
    Mt = Atlas().get(env.mesh_t, env.mesh2_t, src_grid_type="triangles")
    assert Mj.shape == Mt.shape == (env.mesh2_t.nV, env.mesh_t.nTri)
    assert _sparse_gap(Mj, Mt) <= MAP_TOL


def test_atlas_purges_a_dead_mesh(env):
    """Maps are cached per object UID, not id(): a mesh that dies takes
    its maps with it, and a new mesh never finds a dead mesh's map."""
    atlas = Atlas()
    m = mesh_from_numpy(mesh_to_numpy(env.mesh_j))
    M = atlas.get(m, env.grid_t, "nearest_neighbour")
    assert atlas.get(m, env.grid_t, "nearest_neighbour") is M
    uid = m._atlas_uid
    assert len(atlas._maps) == 1
    del m
    gc.collect()
    assert len(atlas._maps) == 0
    m2 = mesh_from_numpy(mesh_to_numpy(env.mesh2_j))
    M2 = atlas.get(m2, env.grid_t, "nearest_neighbour")
    assert m2._atlas_uid != uid and M2.shape[1] == env.mesh2_t.nV


def test_remap_ice_state_matches_jax(env):
    """Every IceState field onto the finer mesh by its metadata
    (conservative, trilinear, reinit, copy), with the same maps."""
    rng = np.random.default_rng(4)
    mj, m2j = env.mesh_j, env.mesh2_j
    sj = jax_init_state(jax_mesh_data(mj), rng.uniform(0, 3e3, mj.nV),
                        rng.uniform(-800, 400, mj.nV), np.zeros(mj.nV),
                        nz=12, dt_init=0.3)
    import jax.numpy as jnp
    sj = sj.replace(
        Ti=jnp.asarray(rng.uniform(240, 273, (mj.nV, 12))),
        u_vav_b=jnp.asarray(rng.standard_normal(mj.nTri)),
        visc_eta_3D_b=jnp.asarray(rng.uniform(1e4, 1e8, (mj.nTri, 12))),
        dHi_dt=jnp.asarray(rng.standard_normal(mj.nV)),
        mask_gl_gr=jnp.asarray(rng.random(mj.nV) < 0.2),
        t_Hi_next=jnp.asarray(7.5), n_Axb_its=jnp.asarray(99, jnp.int32),
        pc=sj.pc.replace(dHi_dt_Hi_nm1_u_nm1=jnp.asarray(
            rng.standard_normal(mj.nV)), dt_np1=jnp.asarray(0.7)))
    st = ice_state_from_numpy(state_to_numpy(sj), "cpu", torch.float64)
    atlas = JaxAtlas()
    M_cons = atlas.get(mj, m2j)
    M_tri = atlas.get(mj, m2j, "trilin")
    M_b = jcons.build_map_nearest(mj.TriGC, m2j.TriGC, mj.nTri)
    Hi2 = rng.uniform(0, 3e3, m2j.nV)
    Hb2 = rng.uniform(-800, 400, m2j.nV)
    new_j = jax_init_state(jax_mesh_data(m2j), Hi2, Hb2, np.zeros(m2j.nV),
                           nz=12)
    new_t = init_ice_state(build_mesh_data(env.mesh2_t, device="cpu"), Hi2,
                           Hb2, np.zeros(m2j.nV), nz=12)
    out_j = state_to_numpy(jax_remap_state(sj, new_j, (M_cons, M_b),
                                           (M_tri, M_b)))
    out_t = remap_ice_state(st, new_t, (M_cons, M_b), (M_tri, M_b))
    flat_j = {**{k: v for k, v in out_j.items() if k != "pc"},
              **{f"pc.{k}": v for k, v in out_j["pc"].items()}}
    for name, v in _state_leaves(out_t).items():
        a = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
        assert a.shape == flat_j[name].shape, name
        assert np.array_equal(a, flat_j[name]), name
    assert out_t.t_Hi_next == 7.5 and out_t.pc.dt_np1 == 0.7
    assert out_t.Ti.shape == (m2j.nV, 12)


def test_remap_vertical_1d_matches_jax():
    """The 1-D conservative and linear vertical remap, batched, with
    masks and an empty destination cell."""
    rng = np.random.default_rng(8)
    z_s = np.sort(rng.uniform(0, 1000, 15))
    z_d = np.sort(rng.uniform(-50, 1100, 9))
    F = rng.standard_normal((4, 15))
    ms = rng.random(15) < 0.8
    md = rng.random(9) < 0.9
    for kw in (dict(), dict(conservative=False),
               dict(mask_src=ms, mask_dst=md)):
        a = jcons.remap_vertical_1d(z_s, z_d, F, **kw)
        b = tcons.remap_vertical_1d(z_s, z_d, F, **kw)
        assert np.array_equal(a, b)
