"""The port's post-processing tools (tools/run.py, diagnose_run.py,
analyse_resources.py, figure.py, figure_3d.py, plot_figures.py, movie.py)
against the JAX package's, over a short run of each package's program on
the same small Halfar stand-in: the port's NetCDF classic output directory
and the JAX package's NetCDF4 one. Numbers are compared, not images."""

import contextlib
import io

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")

from torch_port_fixture import H_HALFAR, write_namelist

from ufemism2_tpu.main import program as jprog
from ufemism2_tpu.tools import analyse_resources as j_ar
from ufemism2_tpu.tools import figure as j_fig
from ufemism2_tpu.tools import figure_3d as j_f3
from ufemism2_tpu.tools.run import Run as JRun

from ufemism2_tpu_torch.main import program as tprog
from ufemism2_tpu_torch.tools import analyse_resources as t_ar
from ufemism2_tpu_torch.tools import diagnose_run as t_dr
from ufemism2_tpu_torch.tools import figure as t_fig
from ufemism2_tpu_torch.tools import figure_3d as t_f3
from ufemism2_tpu_torch.tools import movie as t_movie
from ufemism2_tpu_torch.tools import plot_figures as t_pf
from ufemism2_tpu_torch.tools.run import Run

RUN_CFG = dict(H_HALFAR, do_ANT=True, choice_thermo_model="none",
               choice_initial_ice_temperature_ANT="uniform",
               start_time_of_run=0.0, end_time_of_run=2.0, dt_coupling=0.5,
               dt_output=0.5, choice_output_field_01="u_3D")
FIELD_TOL = 1e-10       # the two packages' fields, relative to the largest


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    cfg = write_namelist(d / "tools_halfar.cfg", RUN_CFG)
    with contextlib.redirect_stdout(io.StringIO()):
        jprog.run_model(str(cfg), output_dir=str(d / "jax"))
        tprog.main([str(cfg), "--output-dir", str(d / "torch"),
                    "--device", "cpu"])
    return d


def test_run_over_both_directories(runs):
    rt, rj = Run(runs / "torch" / "ANT"), Run(runs / "jax" / "ANT")
    assert rt.regions == rj.regions == ["ANT"]
    assert rt.n_meshes == rj.n_meshes == 1
    assert rt.model == rj.model == "UFEMISM"
    assert [f.name for f in rt.mesh_files] == [f.name for f in rj.mesh_files]
    assert [f.name for f in rt.restart_files] \
        == [f.name for f in rj.restart_files] == ["restart_ANT_00001.nc"]
    assert (runs / "torch" / "ANT" / "main_output_ANT_00001.nc").read_bytes(
        )[:3] == b"CDF"
    # the port's tools read the JAX package's NetCDF4 directory too
    jt = Run(runs / "jax" / "ANT")
    mt, mj = rt.get_mesh(0), jt.get_mesh(0)
    assert np.array_equal(mt.V, mj.V) and np.array_equal(mt.Tri, mj.Tri)
    assert mt.nV == mj.nV and mt.nTri == mj.nTri
    assert np.array_equal(mt.time, mj.time) and len(mt.time) >= 5
    assert set(mj.variables) <= set(mt.variables) | {"TriGC"}
    for var in ("Hi", "Hs", "dHi_dt", "u_3D", "uabs_surf"):
        a, b = mt.read(var, -1), mj.read(var, -1)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= FIELD_TOL * max(np.abs(b).max(), 1.0)
    assert np.array_equal(mt.grounding_line_mask(-1),
                          mj.grounding_line_mask(-1))
    tf = mt.timeframe(-1)
    assert tf.t == 2.0 and "Hi" in tf.summary()
    st, sj = rt.scalars(), jt.scalars()
    for k in ("time", "ice_volume", "n_Axb_its", "dt_ice"):
        assert np.allclose(st[k], sj[k], rtol=FIELD_TOL, atol=0.0), k
    # the JAX package's own Run agrees on what it reads of its files
    assert JRun(runs / "jax" / "ANT").get_mesh(0).variables == mj.variables


def test_diagnose_run(runs):
    outs = []
    for sub in ("torch", "jax"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            t_dr.main([str(runs / sub / "ANT")])
        outs.append(buf.getvalue())
    for out in outs:
        assert "model: UFEMISM" in out and "final scalars:" in out
        assert "nV=" in out and "t = 2.00 yr" in out
    heads = [[ln.split(" vars=")[0] for ln in out.splitlines()
              if ln.startswith("mesh 0")] for out in outs]
    assert heads[0] == heads[1] and len(heads[0]) == 1


def test_analyse_resources(runs):
    path = runs / "torch" / "resource_tracking.jsonl"
    recs_t, recs_j = t_ar.load_records(path), j_ar.load_records(path)
    assert recs_t == recs_j and len(recs_t) == 4
    agg_t, agg_j = t_ar.aggregate(recs_t), j_ar.aggregate(recs_j)
    assert agg_t == agg_j and "run_model_region" in "".join(agg_t)
    assert t_ar.report(agg_t, 10) == j_ar.report(agg_j, 10)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t_ar.main([str(runs / "torch"), "--top", "5"])
    assert "4 coupling intervals" in buf.getvalue()
    # the JAX package's file of the same run
    rj = t_ar.aggregate(t_ar.load_records(runs / "jax"
                                          / "resource_tracking.jsonl"))
    assert set(k.split("/")[-1] for k in rj) \
        >= {"run_model_region"}


@pytest.mark.parametrize("which", ["grounding_line", "ice_margin",
                                   "coastline"])
def test_field_contours(runs, which):
    mt = Run(runs / "torch" / "ANT").get_mesh(0)
    mj_file = Run(runs / "jax" / "ANT").get_mesh(0)
    from ufemism2_tpu.tools.run import MeshOutput as JMesh
    mj = JMesh(mj_file.path)
    # one file, both packages' contouring: the same polylines
    same_t = t_fig.field_contours(mj_file, which)
    same_j = j_fig.field_contours(mj, which)
    assert len(same_t) == len(same_j)
    for a, b in zip(same_t, same_j):
        assert np.array_equal(a, b)
    # each package's own run: polylines within rounding of the fields
    own_t = t_fig.field_contours(mt, which)
    assert len(own_t) == len(same_j)
    for a, b in zip(own_t, same_j):
        assert a.shape == b.shape
        assert not a.size or np.abs(a - b).max() <= 1e-6         # km
    # the dome has a margin and a grounding line, and no coast
    assert (sum(len(s) for s in own_t) > 3) == (which != "coastline")


def test_figure_3d_transects(runs):
    mt = Run(runs / "torch" / "ANT").get_mesh(0)
    from ufemism2_tpu.tools.run import MeshOutput as JMesh
    mj = JMesh(Run(runs / "jax" / "ANT").get_mesh(0).path)
    for spec in ("westeast", "southnorth", "-500,-100,400,300"):
        pt, dt = t_f3.transect_points(mt, spec)
        pj, dj = j_f3.transect_points(mj, spec)
        assert np.array_equal(pt, pj) and np.array_equal(dt, dj)
        for var in ("Hi", "Hs"):
            a = t_f3._interp_a(mt, mt.read(var, -1), pt)
            b = j_f3._interp_a(mj, mj.read(var, -1), pj)
            ok = np.isfinite(b)
            assert np.array_equal(np.isfinite(a), ok)
            assert np.abs(a[ok] - b[ok]).max() \
                <= FIELD_TOL * max(np.abs(b[ok]).max(), 1.0)
        a = t_f3._sample_b(mt, mt.read("u_3D", -1), pt)
        b = j_f3._sample_b(mj, mj.read("u_3D", -1), pj)
        assert a.shape == b.shape == (len(pt), mt.read("zeta").size)
        assert np.abs(a - b).max() <= FIELD_TOL * max(np.abs(b).max(), 1.0)
    ax = t_f3.plot_transect_3d(mt, "u_3D", "westeast")
    assert ax.get_title() == "u_3D (westeast)"


def test_figures_and_movie(runs, tmp_path):
    rdir = runs / "torch" / "ANT"
    mo = Run(rdir).get_mesh(0)
    fig = t_fig.Figure(ncols=2).add_field(mo, "Hi").add_field(mo, "uabs_surf")
    fig.add_diff(mo, "Hi", mo, ti1=-1, ti2=0)
    out = fig.make(str(tmp_path / "panels.png"), add_cf=True)
    assert (tmp_path / "panels.png").stat().st_size > 1000 and out
    other = Run(runs / "jax" / "ANT").get_mesh(0)
    other.V = other.V[:-1]              # a mesh of another size
    with pytest.raises(ValueError, match="different meshes"):
        t_fig.Figure().add_diff(mo, "Hi", other)
    t_pf.main_2d([str(rdir), "Hi", "-o", str(tmp_path / "hi.png")])
    assert (tmp_path / "hi.png").exists()
    t_f3.main([str(rdir), "u_3D", "-o", str(tmp_path / "u3d.png")])
    assert (tmp_path / "u3d.png").exists()
    res = t_movie.make_movie(str(rdir), ["Hi"], out_dir=str(tmp_path / "mv"))
    frames = sorted((tmp_path / "mv").glob("frame_*.png"))
    # six frames kept as PNGs, or one mp4 where ffmpeg is installed
    assert len(frames) == 6 or str(res).endswith(".mp4")
