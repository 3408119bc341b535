"""The ranks' side of the sharded-run tests (not a test file).

`ufemism2_tpu_torch.parallel.launch.spawn` runs these functions in
processes of their own, one a rank, joined by gloo on the CPU; they
import the port and no JAX, and return numpy results to the test.
"""

import torch

torch.set_num_threads(1)

# tests/test_dist_step.py's Halfar region
HALFAR = dict(
    choice_refgeo_init_ANT="idealised",
    choice_refgeo_init_idealised="Halfar",
    dx_refgeo_init_idealised=200e3,
    refgeo_idealised_Halfar_H0=3000.0,
    refgeo_idealised_Halfar_R0=500e3,
    uniform_Glens_flow_factor=1e-16,
    choice_ice_rheology_Glen="uniform",
    choice_sliding_law="Weertman",
    choice_basal_hydrology_model="Martin2011",
    xmin_ANT=-1000e3, xmax_ANT=1000e3,
    ymin_ANT=-1000e3, ymax_ANT=1000e3,
    maximum_resolution_uniform=400e3,
    maximum_resolution_grounded_ice=400e3,
    maximum_resolution_ice_front=200e3,
    ice_front_width=200e3,
    nit_Lloyds_algorithm=2,
    refgeo_Hi_min=2.0,
    visc_it_nit=3,
    pc_nit_max=2,
)

# the three cases of tests/test_dist_step.py:45-49
CASES = (("DIVA", "explicit"), ("SIA", "explicit"), ("DIVA", "semi-implicit"))
# the stress balances the JAX package's own tests do not shard, whose
# sharded step there runs and holds its single-device step (SSA, SIA/SSA;
# its BPA and hybrid do not run sharded: ROADMAP C)
MORE_CASES = (("SSA", "explicit"), ("SIA/SSA", "explicit"))
STEP_FIELDS = ("Hi_next", "dHi_dt", "u_vav_b", "v_vav_b", "u_3D_b",
               "fraction_gr", "Hi_eff", "mask")
RUN_FIELDS = ("Hi", "Ti", "u_vav_b")
# the remesh case: the Halfar region (DIVA semi-implicit) with remeshing
# on and resolutions of its own size (a forced remesh takes it from 441
# to 451 vertices), no thermodynamics
REMESH_OVER = dict(allow_mesh_updates=True, choice_thermo_model="none",
                   maximum_resolution_grounding_line=200e3,
                   maximum_resolution_calving_front=200e3,
                   maximum_resolution_floating_ice=400e3,
                   grounding_line_width=200e3, calving_front_width=200e3)
T_RUN = 1.2                   # the run_to window (a thermodynamics step)
T_REMESH = (0.3, 0.6)         # run_to, update_mesh, run_to


def halfar_kw(stress_balance, integration, **over):
    return dict(HALFAR, choice_stress_balance_approximation=stress_balance,
                choice_ice_integration_method=integration, **over)


def region(mesh_np, kw, device="cpu"):
    from ufemism2_tpu_torch.config import Config
    from ufemism2_tpu_torch.convert import mesh_from_numpy
    from ufemism2_tpu_torch.main.region import ModelRegion
    return ModelRegion(Config(**kw), "ANT", mesh=mesh_from_numpy(mesh_np),
                       device=device)


def fields(s, names):
    """The named tensors of a state and its counters, as numpy."""
    out = {k: getattr(s, k).detach().cpu().numpy() for k in names}
    out.update(n_visc_its=int(s.n_visc_its), n_Axb_its=int(s.n_Axb_its),
               dt_ice=float(s.dt_ice), t_Hi_next=float(s.t_Hi_next))
    return out


def run_summary(r):
    out = fields(r.state, RUN_FIELDS)
    out.update(n_dt_ice=r.n_dt_ice, thermo_steps=r.thermo_steps,
               t_thermo_next=float(r.t_thermo_next), nV=r.mesh.nV,
               n_mesh_updates=r.n_mesh_updates)
    return out


def remesh_run(r):
    """run_to, a forced update_mesh, run_to (the remesh cases)."""
    r.run_to(T_REMESH[0])
    r.update_mesh()
    r.run_to(T_REMESH[1])
    return run_summary(r)


def remesh_kw(**over):
    return halfar_kw("DIVA", "semi-implicit", **REMESH_OVER, **over)


def program_kw(**over):
    """The Halfar region through the program: one coupling interval."""
    return halfar_kw("DIVA", "explicit", do_ANT=True, start_time_of_run=0.0,
                     end_time_of_run=0.2, dt_coupling=0.2,
                     choice_thermo_model="none", **over)


def sharded_runs(group, halfar_np, windows, single_cfg=None):
    """Everything the tests hold of a run over this group: per case one
    single-device and one sharded PC step from the same state, the
    refusal of a world size other than tpu_n_devices and, with `windows`,
    three sharded steps, a run_to with the thermodynamics fused and a
    remesh followed by sharded stepping."""
    P = group.world
    out = {}
    for sb, im in CASES + (MORE_CASES if windows else ()):
        r = region(halfar_np, halfar_kw(sb, im, tpu_n_devices=P))
        D = r._dist
        single = fields(r.pc_step(r.md, r.state, 1.0), STEP_FIELDS)
        sharded = fields(D.from_dist(D.step(D.to_dist(r.state), 1.0)),
                         STEP_FIELDS)
        out[(sb, im)] = {"single": single, "sharded": sharded,
                         "halo_stats": D.halo_stats()}
        if windows and (sb, im) == CASES[0]:
            sd = D.to_dist(r.state)
            for _ in range(3):
                sd = D.step(sd, 1.0)
            out["lockstep"] = fields(D.from_dist(sd), ("Hi_next",))
    if windows:
        r = region(halfar_np, halfar_kw("DIVA", "semi-implicit",
                                        tpu_n_devices=P))
        r.run_to(T_RUN)
        out["run_to"] = run_summary(r)
        out["remesh"] = remesh_run(region(halfar_np,
                                          remesh_kw(tpu_n_devices=P)))
    try:
        region(halfar_np, halfar_kw("SIA", "explicit", tpu_n_devices=P + 1))
        out["mismatch"] = None
    except RuntimeError as e:
        out["mismatch"] = str(e)
    if single_cfg is not None:
        # a one-device configuration in a group of P ranks
        from ufemism2_tpu_torch.main.program import run_model
        try:
            run_model(single_cfg, device="cpu")
            out["program_mismatch"] = None
        except RuntimeError as e:
            out["program_mismatch"] = str(e)
    return out


def sharded_spmv_runs(group, problems):
    """make_sharded_spmv of each (scipy CSR, x): the gathered product
    (every rank has all of it), its halo size and block size."""
    from ufemism2_tpu_torch.ops.sparse import ell_from_csr
    from ufemism2_tpu_torch.parallel.halo import make_sharded_spmv
    out = []
    for A, x in problems:
        M = ell_from_csr(A, device="cpu")
        apply, plan = make_sharded_spmv(M, A.shape[1], group)
        out.append((apply(torch.as_tensor(x)).numpy(), plan.Hh, plan.nL))
    return out
