"""MonteCarloSim's programs (parallel/programs.py) against mind_tpu's jitted
`_update_fn` and `_batched_fn` at K = 4 on the same inputs, at float64 on
the small synthetic AV2 world (test_torch_scaleout_programs.py's settings;
the body run through a PlanProgram, which on the CPU runs it eagerly on
its buffers): the K-fold window equal to the bit, ok flags and iteration
counts equal, controls within 1e-6. Then two MonteCarloSims of one
configuration with their own target velocity and target lane plan in turns
through one pair of programs, each equal to its own eager run to the bit
(a value baked into a program, or a window left to the other runner, would
show). On the card (marked cuda) compiled against graphed=False, to the
bit.
"""

import numpy as np
import pytest
import torch

from mind_tpu_torch.config import ClAgentConfig as TClAgentConfig, SimConfig as TSimConfig
from mind_tpu_torch.parallel import monte_carlo as tmonte_carlo
from mind_tpu_torch.planner import programs
from test_torch_data import SEQ_ID
from test_torch_planner import CL_AGENT, CPU, planner_cfgs, spread_weights
from test_torch_scaleout_programs import (  # noqa: F401 (the fixtures world, as_programs)
    SOLVER, TOL, as_programs, common, configs, cuda_config, cuda_world, needs_cuda, port_weights,
    recording, world)

torch.set_num_threads(2)


def jax_monte_carlo(world, jcfg, k, **kw):
    from mind_tpu.config import ClAgentConfig, SimConfig
    from mind_tpu.parallel.monte_carlo import MonteCarloSim

    return MonteCarloSim(SimConfig(cl_agents=[ClAgentConfig(**CL_AGENT)], **common(world)), k=k,
                         planner_cfg=jcfg, **kw)


def port_monte_carlo(world, tcfg, k, flat, cl=None, **kw):
    mc = tmonte_carlo.MonteCarloSim(
        TSimConfig(cl_agents=[TClAgentConfig(**(cl or CL_AGENT))], **common(world)), k=k,
        planner_cfg=tcfg, device=CPU, scenario=world.syn.scenario, **kw)
    port_weights(mc.planner.net, flat)
    return mc


def test_monte_carlo_programs_match_jax(world, monkeypatch, as_programs):
    """K = 4 perturbed egos (seed 3), one tick: the update program's K-fold
    window, built on the device from the exo states and the egos, equal to
    `_update_fn`'s; the plan program's packed [4, 4] against
    `_batched_fn`'s."""
    import mind_tpu.data.loader as jloader

    monkeypatch.setattr(jloader, "load_scenario", lambda path: world.jscenario)
    jcfg, tcfg = configs(world)
    params, flat = spread_weights(jcfg)
    jmc = jax_monte_carlo(world, jcfg, 4, seed=3, max_steps=1)
    jmc.planner.params = params
    tmc = port_monte_carlo(world, tcfg, 4, flat, seed=3, max_steps=1)
    jplans, jupdates = [], []
    jmc._batched_fn = recording(jmc._batched_fn, jplans)
    jmc._update_fn = recording(jmc._update_fn, jupdates)
    want, got = jmc.run(), tmc.run()
    assert got["plan_calls"] == want["plan_calls"] == 1 and len(jupdates) == 1
    progs = tmc.programs.programs
    assert all(a is b for a, b in zip(progs["batched_plan"].inputs.bufs,
                                      progs["obs_update"].inputs.buf))
    # the plan reads the update's presence where it lies
    assert progs["batched_plan"].inputs.amasks is progs["obs_update"].inputs.present
    for f, a, b in zip(tmc.buf._fields, tmc.buf, jmc.buf):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    (jargs, jout), = jplans
    host = progs["batched_plan"].inputs.host.numpy()
    np.testing.assert_array_equal(host[:, :6], np.asarray(jargs[4]))
    np.testing.assert_array_equal(host[:, 6:], np.asarray(jargs[5].field_offset))
    packed, jpacked = progs["batched_plan"].outputs.numpy(), np.asarray(jout)
    np.testing.assert_array_equal(packed[:, 2:], jpacked[:, 2:])
    assert (packed[:, 2] == 1.0).all() and (packed[:, 3] > 0).all()
    np.testing.assert_allclose(packed[:, :2], jpacked[:, :2], rtol=0, atol=TOL)
    assert int(progs["batched_plan"].rounds) >= 2
    assert got["failed"] == want["failed"] == 0
    np.testing.assert_allclose(tmc.trajectory[0], jmc.trajectory[0], rtol=0, atol=TOL)


def test_two_monte_carlo_runners_share_one_program(world, monkeypatch):
    """Two MonteCarloSims of one configuration, with their own target
    velocity and target lane (so their own origin, statics and cost
    parameters), plan in turns through one update and one plan program:
    a, b, then a again (it takes its window back from b). Each equal to the
    bit to its own eager run (graphed=False) of the same turns (float32,
    one copy each)."""
    jcfg, tcfg = planner_cfgs(world.n_lanes, "float32", "float32", **SOLVER)
    _, flat = spread_weights(jcfg)
    cls = {"a": None, "b": dict(CL_AGENT, target_velocity=6.0, semantic_lane=4)}
    runs = {}
    for graphed in (False, None):
        with monkeypatch.context() as m:
            if graphed is None:
                m.setattr(programs, "compiled", lambda device, g: g is not False)
            mcs = {n: port_monte_carlo(world, tcfg, 1, flat, cl, seed=5, max_steps=1,
                                       graphed=graphed) for n, cl in cls.items()}
            out = {n: [] for n in mcs}
            for n in ("a", "b", "a"):
                mcs[n].run()
                out[n].append((mcs[n].ctrls.copy(), mcs[n].failed.copy(),
                               tuple(t.clone() for t in mcs[n].buf)))
            runs[graphed] = (mcs, out)
    (eager, want), (comp, got) = runs[False], runs[None]
    a, b = comp["a"], comp["b"]
    assert a.planner.lcl_smp.target_velocity != b.planner.lcl_smp.target_velocity
    assert not np.array_equal(a.planner.lcl_smp.target_lane, b.planner.lcl_smp.target_lane)
    # one program of each kind serves both runners, and eagerly none ran
    for kind in ("obs_update", "batched_plan"):
        assert a.programs.programs[kind] is b.programs.programs[kind]
    assert not eager["a"].programs.programs
    for n in ("a", "b"):
        assert len(got[n]) == len(want[n])
        for (c, f, w), (ce, fe, we) in zip(got[n], want[n]):
            assert np.array_equal(c, ce) and np.array_equal(f, fe)
            assert all(torch.equal(x, y) for x, y in zip(w, we))
        assert np.array_equal(np.stack(comp[n].trajectory), np.stack(eager[n].trajectory))
    # the two runners' plans differ: their own data reached them
    assert not np.array_equal(got["a"][0][0], got["b"][0][0])


@pytest.mark.cuda
def test_cuda_monte_carlo_compiled_equals_eager(tmp_path):
    """On the card: MonteCarloSim, k = 4, 15 ticks, compiled against
    graphed=False: every packed, the failures and the trajectory equal to
    the bit."""
    needs_cuda()
    syn = cuda_world(tmp_path)
    tcfg = cuda_config(syn)
    res = {}
    for graphed in (None, False):
        mc = tmonte_carlo.MonteCarloSim(
            TSimConfig(cl_agents=[TClAgentConfig(**CL_AGENT)], sim_name="demo_1",
                       seq_id=SEQ_ID, data_root=str(tmp_path)),
            k=4, planner_cfg=tcfg, seed=3, max_steps=15, scenario=syn.scenario, graphed=graphed)
        packed = []
        mc._plan = recording(mc._plan, packed)
        mc.run()
        res[graphed] = (mc, np.stack(mc.trajectory), [p for _, p in packed])
    (a, ta, pa), (b, tb, pb) = res[None], res[False]
    assert len(pa) == len(pb) == 3 and all(np.array_equal(x, y) for x, y in zip(pa, pb))
    assert np.array_equal(a.failed, b.failed) and np.array_equal(ta, tb)
