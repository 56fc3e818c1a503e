"""The batched simulators of the PyTorch port against mind_tpu's on the
small synthetic AV2 world with the test settings of test_torch_sim.py (128
cost nodes, 4 line-search steps, the small network with shared weights), at
float64: MultiScenarioSim (two scenarios in lockstep, one batched plan per
trigger, 15 ticks) and MonteCarloSim (k = 4 perturbed egos, 15 ticks). The
JAX package's loaders get the scenario through a monkeypatched
load_scenario, and both packages' simulators the test planner configuration
through a monkeypatched Simulator.
"""

import functools

import numpy as np
import pytest
import torch

from mind_tpu_torch.config import ClAgentConfig as TClAgentConfig, SimConfig as TSimConfig
from mind_tpu_torch.models.weights import params_from_flax
from mind_tpu_torch.parallel import monte_carlo as tmonte_carlo
from mind_tpu_torch.parallel import multi_scenario as tmulti
from mind_tpu_torch.sim.simulator import Simulator as TSimulator
from test_torch_data import SEQ_ID
from test_torch_planner import CL_AGENT, CPU, World, planner_cfgs, spread_weights

torch.set_num_threads(2)

HORIZON = 15       # 3 plans from tick 0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("av2"))


def test_multi_scenario_sim_matches_jax(world, monkeypatch):
    """Two scenarios (the AV asked for 8 and for 6 m/s, planner on from tick
    0), 15 ticks: the same plan calls and no termination as mind_tpu's
    MultiScenarioSim, the egos within 1e-3 m (the BASELINE.json budget);
    the scenarios' egos differ."""
    import mind_tpu.data.loader as jloader
    import mind_tpu.parallel.multi_scenario as jmulti
    from mind_tpu.config import ClAgentConfig, SimConfig
    from mind_tpu.sim.simulator import Simulator

    jcfg, tcfg = planner_cfgs(world.n_lanes, "float64", "float64")
    monkeypatch.setattr(jloader, "load_scenario", lambda path: world.jscenario)
    monkeypatch.setattr(jmulti, "Simulator", functools.partial(Simulator, planner_cfg=jcfg))
    monkeypatch.setattr(tmulti, "Simulator", functools.partial(TSimulator, planner_cfg=tcfg))
    common = dict(sim_name="demo_1", seq_id=SEQ_ID, data_root=str(world.root))
    agents = [dict(CL_AGENT, target_velocity=v, enable_timestep=0.0) for v in (8.0, 6.0)]
    jms = jmulti.MultiScenarioSim([SimConfig(cl_agents=[ClAgentConfig(**a)], **common)
                                   for a in agents], planner_cfg=jcfg, max_steps=HORIZON)
    tms = tmulti.MultiScenarioSim([TSimConfig(cl_agents=[TClAgentConfig(**a)], **common)
                                   for a in agents], planner_cfg=tcfg, max_steps=HORIZON,
                                  device=CPU, scenarios=[world.syn.scenario] * 2)
    params, flat = spread_weights(jcfg)
    jms.params = params
    net = tms.avs[0].planner.net
    assert tms.avs[1].planner.net is net
    net.load_state_dict(params_from_flax(flat))
    net.apply_compute_dtype()
    want, got = jms.run(), tms.run()
    assert got["plan_calls"] == want["plan_calls"] == 3
    assert got["terminated"] == want["terminated"] == [False, False]
    np.testing.assert_allclose(tms.ego_states(), jms.ego_states(), rtol=0, atol=1e-3)
    assert np.abs(tms.ego_states()[0] - tms.ego_states()[1]).max() > 1e-4


def test_monte_carlo_sim_matches_jax(world, monkeypatch):
    """MonteCarloSim, k = 4 perturbed egos (seed 3), 15 ticks at float64
    against mind_tpu's: the same plan count and failures, every copy's
    trajectory within 1e-3 m (the BASELINE.json budget; measured gap in the
    PR's notes)."""
    import mind_tpu.data.loader as jloader
    from mind_tpu.config import ClAgentConfig, SimConfig
    from mind_tpu.parallel.monte_carlo import MonteCarloSim

    monkeypatch.setattr(jloader, "load_scenario", lambda path: world.jscenario)
    jcfg, tcfg = planner_cfgs(world.n_lanes, "float64", "float64")
    common = dict(sim_name="demo_1", seq_id=SEQ_ID, data_root=str(world.root))
    jmc = MonteCarloSim(SimConfig(cl_agents=[ClAgentConfig(**CL_AGENT)], **common), k=4,
                        planner_cfg=jcfg, seed=3, max_steps=HORIZON)
    tmc = tmonte_carlo.MonteCarloSim(TSimConfig(cl_agents=[TClAgentConfig(**CL_AGENT)], **common),
                                     k=4, planner_cfg=tcfg, seed=3, max_steps=HORIZON, device=CPU,
                                     scenario=world.syn.scenario)
    params, flat = spread_weights(jcfg)
    jmc.planner.params = params
    tmc.planner.net.load_state_dict(params_from_flax(flat))
    tmc.planner.net.apply_compute_dtype()
    np.testing.assert_array_equal(tmc.egos, jmc.egos)
    want, got = jmc.run(), tmc.run()
    assert got["plan_calls"] == want["plan_calls"] == 3
    assert got["failed"] == want["failed"] and got["copies"] == 4
    traj_j, traj_t = np.stack(jmc.trajectory), np.stack(tmc.trajectory)
    assert traj_t.shape == (HORIZON, 4, 4) and np.isfinite(traj_t).all()
    np.testing.assert_allclose(traj_t, traj_j, rtol=0, atol=1e-3)
    # the copies were planned: they left their constant-speed starts apart
    assert np.abs(tmc.ctrls).max() > 1e-3
