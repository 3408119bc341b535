"""Multi-device runs of the port (parallel/dist.py), over 2 and 4 ranks
spawned on the CPU and joined by gloo through a file:// rendezvous, held
against the port's single-device step and against the JAX package's
ShardedModel on the conftest's virtual CPU devices, in f64.

- build_dist_md's integer tables (halo tables, re-indexed connectivity,
  operator columns) equal the JAX package's for P = 2, 4 and 8 on
  tests/test_dist_step.py's Halfar region;
- a sharded PC step (DIVA explicit, SIA explicit, DIVA semi-implicit)
  equals the single-device step (equal counts, fields within 1e-9 of
  their largest value, masks bitwise, tests/test_dist_step.py's
  tolerance) and the JAX sharded step with the same P (equal counts,
  fields within 1e-12 of scale);
- over 2 ranks, three sharded steps in lockstep, a run_to with
  tpu_n_devices and the thermodynamics fused (equal step counts; Hi, Ti,
  u_vav_b within 1e-8 of scale, __graft_entry__.py:105-112) and a forced
  remesh followed by sharded stepping;
- a world size other than tpu_n_devices, and no process group at all,
  raise by name.

Each P is one spawn of its ranks (tests/torch_dist_ranks.py), shared by
the module's tests.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from torch_port_fixture import mesh_to_numpy
from test_torch_program import write_cfg
import torch_dist_ranks as R

from ufemism2_tpu_torch.parallel.launch import spawn

ROOT = Path(__file__).resolve().parent.parent
PS = (2, 4)
PS_WINDOWS = (2,)      # the lockstep, run_to and remesh windows: on the
#                        CPU every collective costs 1-2 ms, and 4 ranks
#                        double the file's time
STEP_TOL = 1e-9        # sharded against single-device, of the largest value
JAX_TOL = 1e-12        # port sharded against JAX sharded, likewise
RUN_TOL = 1e-8


class Env:
    pass


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    import jax.numpy as jnp
    from ufemism2_tpu.config import Config as CJ
    from ufemism2_tpu.main.region import ModelRegion as JaxRegion
    from ufemism2_tpu.parallel.dist import ShardedModel as JaxSharded
    e = Env()
    e.jax_regions = {}
    for sb, im in R.CASES:
        e.jax_regions[(sb, im)] = JaxRegion(CJ(**R.halfar_kw(sb, im)), "ANT")
    mesh_j = e.jax_regions[R.CASES[0]].mesh
    e.mesh_j = mesh_j
    e.halfar_np = mesh_to_numpy(mesh_j)
    # the program's configurations: over two ranks, and on one device
    e.dir = tmp_path_factory.mktemp("dist")
    e.cfg2 = write_cfg(e.dir / "halfar_2.cfg", R.program_kw(tpu_n_devices=2))
    e.cfg1 = write_cfg(e.dir / "halfar_1.cfg", R.program_kw())
    # the runs over 2 and over 4 ranks and the entry point under torchrun,
    # at once; the windows over 2
    with ThreadPoolExecutor(len(PS) + 1) as pool:
        runs = [pool.submit(spawn, R.sharded_runs, P, "gloo", ["cpu"] * P,
                            args=(e.halfar_np, P in PS_WINDOWS,
                                  str(e.cfg1) if P == 2 else None))
                for P in PS]
        cli = pool.submit(
            subprocess.run,
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "ufemism2_tpu_torch",
             str(e.cfg2), "--backend", "gloo", "--device", "cpu",
             "--output-dir", str(e.dir / "out2")],
            capture_output=True, text=True, cwd=str(ROOT),
            env=dict(os.environ, PYTHONPATH=str(ROOT)))
        e.runs = {P: f.result() for P, f in zip(PS, runs)}
        e.cli = cli.result()
    # the JAX package's sharded step, same P, same state
    e.jax = {}
    for P in PS:
        for case, rj in e.jax_regions.items():
            SM = JaxSharded(rj.C, rj, P)
            s = SM.from_dist(SM.step(SM.to_dist(rj.state), jnp.asarray(1.0)))
            e.jax[(P, case)] = s
    # the port's single-device references of the window and the remesh
    e.run_ref = R.run_summary(_ran(R.region(
        e.halfar_np, R.halfar_kw("DIVA", "semi-implicit")), R.T_RUN))
    e.remesh_ref = R.remesh_run(R.region(e.halfar_np, R.remesh_kw()))
    return e


def _ran(r, t):
    r.run_to(t)
    return r


def _close(a, b, tol, name):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(a).max()), 1e-30)
    np.testing.assert_allclose(b, a, rtol=0, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("P", (2, 4, 8))
def test_dist_tables_match_jax(env, P):
    """The halo tables, the re-indexed tables and every operator's
    columns, integer for integer (the DIVA semi-implicit region, whose
    extras hold the SSA copy table and the thermodynamics sector table)."""
    from ufemism2_tpu.parallel.dist import build_dist_md as jax_build
    from ufemism2_tpu_torch.parallel.dist import build_dist_md
    case = ("DIVA", "semi-implicit")
    rj = env.jax_regions[case]
    rt = R.region(env.halfar_np, R.halfar_kw(*case))
    md_j, _, sp_j = jax_build(rj.mesh, rj.md, P)
    dm = build_dist_md(rt.mesh, rt.md, P)
    for s in ("V", "Tri", "E"):
        a, b = dm.spaces[s], sp_j[s]
        assert (a.nL, a.Hs, a.Hh) == (b.nL, b.Hs, b.Hh), s
        for name in ("send_idx", "send_mask", "recv_map", "recv_mask"):
            np.testing.assert_array_equal(
                getattr(a.plan, name).reshape(-1),
                np.asarray(getattr(b.tables, name)), err_msg=f"{s} {name}")
    for name in ("C", "VE", "EV", "ETri", "Tri", "TriC"):
        np.testing.assert_array_equal(dm.arrays[name][1],
                                      np.asarray(getattr(md_j, name)),
                                      err_msg=name)
    for name, (_, cols, vals) in dm.ops.items():
        Mj = getattr(md_j, name)
        np.testing.assert_array_equal(cols, np.asarray(Mj.inds),
                                      err_msg=name)
        np.testing.assert_array_equal(vals, np.asarray(Mj.vals),
                                      err_msg=name)
    for name in ("ssa_copy_inds", "th_tri_sector"):
        np.testing.assert_array_equal(dm.extras[name][3],
                                      np.asarray(md_j.extras[name].arr),
                                      err_msg=name)


@pytest.mark.parametrize("case", R.CASES, ids=["-".join(c) for c in R.CASES])
@pytest.mark.parametrize("P", PS)
def test_sharded_step_matches_single_device(env, P, case):
    for rank_out in env.runs[P]:
        single, sharded = rank_out[case]["single"], rank_out[case]["sharded"]
        assert sharded["n_visc_its"] == single["n_visc_its"]
        assert sharded["n_Axb_its"] == single["n_Axb_its"]
        assert sharded["dt_ice"] == pytest.approx(single["dt_ice"],
                                                  rel=1e-12)
        for name in R.STEP_FIELDS[:-1]:
            _close(single[name], sharded[name], STEP_TOL, name)
        np.testing.assert_array_equal(single["mask"], sharded["mask"])


@pytest.mark.parametrize("case", R.MORE_CASES,
                         ids=["-".join(c) for c in R.MORE_CASES])
@pytest.mark.parametrize("P", PS_WINDOWS)
def test_sharded_step_of_more_stress_balances(env, P, case):
    """SSA and SIA/SSA, which the JAX package's sharded step also runs."""
    test_sharded_step_matches_single_device(env, P, case)


@pytest.mark.parametrize("case", R.CASES, ids=["-".join(c) for c in R.CASES])
@pytest.mark.parametrize("P", PS)
def test_sharded_step_matches_jax_sharded(env, P, case):
    """dHi_dt = (Hi_next - Hi_prev) / dt is held in Hi's units (times
    dt, against Hi's scale): a rate of a 3,000 m dome's thinning carries
    Hi's rounding over dt, 1e-11 of its own largest value."""
    mine = env.runs[P][0][case]["sharded"]
    sj = env.jax[(P, case)]
    assert mine["n_visc_its"] == int(sj.n_visc_its)
    assert mine["n_Axb_its"] == int(sj.n_Axb_its)
    for name in R.STEP_FIELDS[:-1]:
        a, b = np.asarray(getattr(sj, name)), mine[name]
        if name == "dHi_dt":
            scale = np.abs(np.asarray(sj.Hi_next)).max()
            assert np.abs(a - b).max() * mine["dt_ice"] <= JAX_TOL * scale
            continue
        _close(a, b, JAX_TOL, name)
    np.testing.assert_array_equal(mine["mask"], np.asarray(sj.mask))


@pytest.mark.parametrize("P", PS_WINDOWS)
def test_sharded_steps_stay_in_lockstep(env, P):
    """Three sharded steps against three single-device ones (the JAX
    package's test_sharded_multistep_stays_in_lockstep)."""
    r = R.region(env.halfar_np, R.halfar_kw(*R.CASES[0]))
    s = r.state
    for _ in range(3):
        s = r.pc_step(r.md, s, 1.0)
    for rank_out in env.runs[P]:
        got = rank_out["lockstep"]
        _close(s.Hi_next.numpy(), got["Hi_next"], RUN_TOL, "Hi_next")
        assert got["t_Hi_next"] == pytest.approx(s.t_Hi_next, rel=1e-12)


@pytest.mark.parametrize("P", PS_WINDOWS)
def test_run_to_sharded_with_fused_thermodynamics(env, P):
    ref = env.run_ref
    for rank_out in env.runs[P]:
        got = rank_out["run_to"]
        assert got["n_dt_ice"] == ref["n_dt_ice"]
        assert got["thermo_steps"] == ref["thermo_steps"] > 0
        assert got["t_thermo_next"] == pytest.approx(ref["t_thermo_next"],
                                                     rel=1e-12)
        for name in R.RUN_FIELDS:
            _close(ref[name], got[name], RUN_TOL, name)


@pytest.mark.parametrize("P", PS_WINDOWS)
def test_remesh_then_sharded_stepping(env, P):
    ref = env.remesh_ref
    assert ref["n_mesh_updates"] == 1 and ref["nV"] != env.mesh_j.nV
    for rank_out in env.runs[P]:
        got = rank_out["remesh"]
        assert got["nV"] == ref["nV"]
        assert got["n_mesh_updates"] == 1
        assert got["n_dt_ice"] == ref["n_dt_ice"]
        assert got["n_visc_its"] == ref["n_visc_its"]
        assert got["n_Axb_its"] == ref["n_Axb_its"]
        for name in R.RUN_FIELDS:
            _close(ref[name], got[name], RUN_TOL, name)


@pytest.mark.parametrize("P", PS)
def test_world_size_mismatch_raises_by_name(env, P):
    msg = env.runs[P][0]["mismatch"]
    assert msg is not None
    assert f"tpu_n_devices = {P + 1}" in msg
    assert f"found world size {P}" in msg


def test_no_process_group_raises_by_name(env):
    """Outside a process group a multi-device region raises, naming
    tpu_n_devices, and does not fall back to one device."""
    with pytest.raises(RuntimeError, match="tpu_n_devices = 2 needs"):
        R.region(env.halfar_np, R.halfar_kw("SIA", "explicit",
                                            tpu_n_devices=2))


@pytest.mark.parametrize("choice", ("BPA", "hybrid DIVA/BPA"))
def test_unsharded_stress_balances_raise_by_name(env, choice):
    """The JAX package's sharded step cannot run BPA or the hybrid (their
    solvers hold full-mesh tables: a shape error there, ROADMAP C); the
    port refuses them by name before it builds anything."""
    with pytest.raises(NotImplementedError,
                       match="choice_stress_balance_approximation"):
        R.region(env.halfar_np, R.halfar_kw(choice, "explicit",
                                            tpu_n_devices=2))


@pytest.mark.parametrize("P", PS)
def test_halo_stats_describe_the_blocks(env, P):
    st = env.runs[P][0][R.CASES[0]]["halo_stats"]
    for s, n in (("V", env.mesh_j.nV), ("Tri", env.mesh_j.nTri)):
        assert st[s]["n_global"] == n
        assert st[s]["n_local_padded"] == -(-n // P)
        assert 0 < st[s]["halo_recv_max"] < n


def test_torchrun_entry_point_over_two_ranks(env):
    """torchrun --nproc-per-node 2 -m ufemism2_tpu_torch <cfg> --backend
    gloo runs the tpu_n_devices = 2 configuration; rank 0 alone writes
    the output directory, and its final scalars (the program's last
    output event) equal the one-device program's: the solver counts
    exactly, the ice volume within 1e-9."""
    from ufemism2_tpu_torch.io.ncio import NCFile
    from ufemism2_tpu_torch.main.program import run_model
    assert env.cli.returncode == 0, env.cli.stderr[-3000:]
    out = env.dir / "out2"
    for name in ("halfar_2.cfg", "run_manifest.json",
                 "resource_tracking.jsonl", "ANT/restart_ANT_00001.nc",
                 "ANT/scalar_output_ANT_00001.nc"):
        assert (out / name).exists(), name
    assert len((out / "resource_tracking.jsonl").read_text()
               .splitlines()) == 1
    one = run_model(str(env.cfg1), output_dir=str(env.dir / "out1"),
                    device="cpu")["ANT"]
    nc = NCFile(str(out / "ANT" / "scalar_output_ANT_00001.nc"))
    last = one.scalars_history[-1]
    for name in ("n_visc_its", "n_Axb_its"):
        assert float(np.asarray(nc.read(name))[-1]) == last[name], name
    assert float(np.asarray(nc.read("ice_volume"))[-1]) == pytest.approx(
        last["ice_volume"], rel=1e-9)


def test_program_refuses_a_world_size_other_than_tpu_n_devices(env):
    msg = env.runs[2][0]["program_mismatch"]
    assert msg is not None and "tpu_n_devices = 1" in msg \
        and "world size 2" in msg
