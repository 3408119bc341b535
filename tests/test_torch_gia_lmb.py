"""The port's ELRA bed deformation (ufemism2_tpu_torch/models/gia.py) and
GlacialIndex LMB (models/lmb.py) against the JAX package's on the same
mesh, files and states:

- ELRA in f64 over three calls (each a relaxation step from the last
  dHb), with the GIA-equilibrium geometry from each of its three sources
  (idealised, a file, the initial geometry where neither resolves), the
  nearest-neighbour grid tables built with scipy's cKDTree on each side;
  tolerance 1e-12 relative;
- ELRA in f32, where both packages take the FFT in f32 (pocketfft here,
  cuFFT on the card): the two FFT libraries round differently, and an f32
  transform of n points carries a relative error of about eps32 log2(n)
  of the transform's norm (eps32 = 6e-8, n = 39 x 39 grid cells: about
  6e-7), which the spectral division (by at least rho_m g) does not
  amplify; the load itself is the f32 difference of two loads of up to
  3e6 Pa against their sum. The f32 deformation rate is held within 1e-5
  of its largest value (measured 3.1e-7);
- GlacialIndex at times inside and beyond the glacial-index series, in f64
  (1e-12) and f32 (to the f32 rounding), at the calving front only.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_fixture import (climate_files, climate_state, configs,
                                polar_meshes, rel_gap, write_nc_pair)

from ufemism2_tpu.core import mesh_data as jmd
from ufemism2_tpu.core.ice import masks as jmasks
from ufemism2_tpu.models import gia as jgia, lmb as jlmb

from ufemism2_tpu_torch.core import mesh_data as tmd
from ufemism2_tpu_torch.core.ice import masks as tmasks
from ufemism2_tpu_torch.models import gia as tgia, lmb as tlmb

TOL = 1e-12


class Env:
    pass


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    e = Env()
    d = tmp_path_factory.mktemp("gia_lmb")
    e.mesh_j, e.mesh_t = polar_meshes()
    e.files = climate_files(d)
    x = np.linspace(-330e3, 330e3, 23)
    X, Y = np.meshgrid(x, x, indexing="ij")
    R = np.hypot(X, Y) / 300e3
    e.files["GIAeq"] = write_nc_pair(d, "giaeq", {"x": 23, "y": 23}, {
        "x": (("x",), x), "y": (("y",), x),
        "Hi": (("x", "y"), np.where(R < 0.9, 2000.0 * (1 - R ** 2), 0.0)),
        "Hb": (("x", "y"), 700.0 - 1500.0 * R ** 2),
        "SL": (("x", "y"), np.zeros_like(R))})
    return e


def gia_config(env, dtype, source, k):
    over = dict(choice_GIA_model="ELRA", dx_GIA=16e3,
                ELRA_bedrock_relaxation_time=300.0,
                tpu_precision="f32" if dtype == torch.float32 else "f64")
    if source == "idealised":
        over.update(choice_refgeo_GIAeq_ANT="idealised",
                    choice_refgeo_GIAeq_idealised="Halfar",
                    refgeo_idealised_Halfar_R0=250e3,
                    refgeo_idealised_Halfar_H0=2500.0)
    elif source == "file":
        over.update(choice_refgeo_GIAeq_ANT="read_from_file",
                    filename_refgeo_GIAeq_ANT=env.files["GIAeq"][k])
    return configs(**over)[k]


@pytest.mark.parametrize("source", ("idealised", "file", "init"))
def test_elra_f64(env, source):
    mdj = jmd.build_mesh_data(env.mesh_j)
    mdt = tmd.build_mesh_data(env.mesh_t, dtype=torch.float64, device="cpu")
    rj = jgia.make_run_gia(gia_config(env, torch.float64, source, 0), mdj,
                           "ANT", env.mesh_j)
    rt = tgia.make_run_gia(gia_config(env, torch.float64, source, 1), mdt,
                           "ANT", env.mesh_t)
    sj, st = climate_state(env.mesh_t, np.random.default_rng(41))
    for dt in (50.0, 100.0, 25.0):
        dj, hj = rj(0.0, sj, dt)
        dt_t, ht = rt(0.0, st, dt)
        assert rel_gap(dt_t, np.asarray(dj)) <= TOL
        assert rel_gap(ht, np.asarray(hj)) <= TOL
        sj.dHb, st.dHb = hj, ht
    assert float(dt_t.abs().max()) > 0.0


def test_elra_f32(env):
    mdj = jmd.build_mesh_data(env.mesh_j, dtype=jnp.float32)
    mdt = tmd.build_mesh_data(env.mesh_t, dtype=torch.float32, device="cpu")
    rj = jgia.make_run_gia(gia_config(env, torch.float32, "file", 0), mdj,
                           "ANT", env.mesh_j)
    rt = tgia.make_run_gia(gia_config(env, torch.float32, "file", 1), mdt,
                           "ANT", env.mesh_t)
    sj, st = climate_state(env.mesh_t, np.random.default_rng(42))
    sj = SimpleNamespace(**{k: v.astype(jnp.float32)
                            for k, v in vars(sj).items()})
    st = SimpleNamespace(**{k: v.float() for k, v in vars(st).items()})
    dj, hj = rj(0.0, sj, 100.0)
    dt_t, ht = rt(0.0, st, 100.0)
    assert dt_t.dtype == torch.float32
    assert rel_gap(dt_t, np.asarray(dj)) <= 1e-5
    assert rel_gap(ht, np.asarray(hj)) <= 1e-5


def test_gia_none(env):
    mdt = tmd.build_mesh_data(env.mesh_t, dtype=torch.float64, device="cpu")
    _, Ct = configs(choice_GIA_model="none")
    rt = tgia.make_run_gia(Ct, mdt, "ANT", env.mesh_t)
    d, h = rt(0.0, None, 10.0)
    assert float(d.abs().max()) == float(h.abs().max()) == 0.0


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32))
def test_glacial_index_lmb(env, dtype):
    jd = jnp.float32 if dtype == torch.float32 else jnp.float64
    prec = "f32" if dtype == torch.float32 else "f64"
    over = dict(choice_LMB_model_ANT="GlacialIndex", warm_LMB_ANT=-0.5,
                cold_LMB_ANT=-4.0, tpu_precision=prec)
    Cj, _ = configs(**over, filename_LMB_GI_ANT=env.files["GI"][0])
    _, Ct = configs(**over, filename_LMB_GI_ANT=env.files["GI"][1])
    mdj = jmd.build_mesh_data(env.mesh_j, dtype=jd)
    mdt = tmd.build_mesh_data(env.mesh_t, dtype=dtype, device="cpu")
    rj = jlmb.make_run_lmb(Cj, mdj, "ANT")
    rt = tlmb.make_run_lmb(Ct, mdt, "ANT")
    sj, st = climate_state(env.mesh_t, np.random.default_rng(43))
    mj = jmasks.determine_masks(mdj, sj.Hi.astype(jd), sj.Hb.astype(jd),
                                sj.SL.astype(jd))
    mt = tmasks.determine_masks(mdt, st.Hi.to(dtype), st.Hb.to(dtype),
                                st.SL.to(dtype))
    cf = (mt["mask_cf_fl"] | mt["mask_cf_gr"]).numpy()
    assert cf.any()
    tol = TOL if dtype == torch.float64 else 4 * torch.finfo(dtype).eps
    for t in (-500.0, -100.0, -20.0, 0.0, 3.5, 7.0, 20.0, 80.0):
        a, b = rt(t, st, mt), rj(t, sj, mj)
        assert a.dtype == dtype
        assert rel_gap(a, np.asarray(b)) <= tol, t
        assert (a.numpy()[~cf] == 0.0).all()
    assert float(rt(3.5, st, mt).min()) < -0.5
