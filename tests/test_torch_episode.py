"""The episode runner of the PyTorch port (mind_tpu_torch/sim/episode.py)
against mind_tpu's on the small synthetic AV2 world, with the test settings
of test_torch_sim.py (128 cost nodes, 4 line-search steps; the planner
enabled after 0.3 s) and the same network weights: the precomputed schedule,
the whole episode at float64 against mind_tpu's `lax.scan` and against the
port's own Simulator loop, segmented against whole, the truncation at a
failed cycle, the Monte-Carlo start states and the run_sim --episode CLI;
two scenarios in one batch and the Monte-Carlo schedule against mind_tpu's
vmapped runners (the Monte-Carlo runner is in test_torch_monte_carlo.py).
"""

import numpy as np
import pytest
import torch

from mind_tpu_torch import run_sim as t_run_sim
from mind_tpu_torch.config import ClAgentConfig as TClAgentConfig, SimConfig as TSimConfig
from mind_tpu_torch.sim import episode as tepisode
from mind_tpu_torch.sim.simulator import Simulator as TSimulator
from test_torch_data import SEQ_ID, scenario_frame
from test_torch_planner import CL_AGENT, CPU, World, planner_cfgs, share_weights

torch.set_num_threads(2)

# enable tick 15 in both loops: the Simulator accumulates 0.02 s per tick
# and enables once the sum reaches 0.3 s, at tick 15, where the episode's
# ceil(0.3 / 0.02) puts it too (after 0.2 s the sum would enable at tick 11
# and the episode at tick 10)
ENABLE = 0.3
HORIZON = 30       # 6 cycles: 0-2 do not plan, 3-5 plan


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("av2"))


def ego(sim):
    return next(a for a in sim.agents if a.id == "AV")


def make_sims(world, pipeline="float64", solve="float64", ticks=HORIZON, target_velocity=None):
    """Both packages' initialized Simulators (mind_tpu first) with the AV's
    planner enabled after ENABLE seconds and the same weights; the AV asked
    for `target_velocity` (CL_AGENT's by default)."""
    import mind_tpu.data.loader as jloader
    from mind_tpu.config import ClAgentConfig, SimConfig
    from mind_tpu.sim.simulator import Simulator

    jcfg, tcfg = planner_cfgs(world.n_lanes, pipeline, solve)
    common = dict(sim_name="demo_1", seq_id=SEQ_ID, data_root=str(world.root))
    agent = dict(CL_AGENT, enable_timestep=ENABLE)
    if target_velocity is not None:
        agent["target_velocity"] = target_velocity
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jloader, "load_scenario", lambda path: world.jscenario)
        jsim = Simulator(SimConfig(cl_agents=[ClAgentConfig(**agent)], **common),
                         planner_cfg=jcfg, max_steps=ticks)
        jsim.init_sim()
    finally:
        mp.undo()
    tsim = TSimulator(TSimConfig(cl_agents=[TClAgentConfig(**agent)], **common),
                      planner_cfg=tcfg, max_steps=ticks, device=CPU,
                      scenario=world.syn.scenario)
    tsim.init_sim()
    share_weights(ego(jsim), ego(tsim))
    return jsim, tsim


@pytest.fixture(scope="module")
def episodes64(world):
    """mind_tpu's and the port's run_episode at float64 over HORIZON ticks,
    and the port's run_episode_segmented in 4-cycle segments."""
    from mind_tpu.sim.episode import run_episode

    jsim, tsim = make_sims(world)
    phases = []
    return (run_episode(jsim, HORIZON), tepisode.run_episode(tsim, HORIZON, phases=phases),
            tepisode.run_episode_segmented(tsim, HORIZON, seg_cycles=4), phases, tsim)


def test_build_episode_inputs_matches_jax(world):
    from mind_tpu.sim.episode import build_episode_inputs

    jsim, tsim = make_sims(world, ticks=60)
    want = build_episode_inputs(jsim, 60)
    got = tepisode.build_episode_inputs(tsim, 60)
    for f in ("slot_states", "present", "active", "ego_replay", "types"):
        g = getattr(got, f)
        assert g.device == CPU
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, f)), err_msg=f)
    assert got.slot_states.dtype == got.ego_replay.dtype == torch.float64
    assert got.enable_tick == int(want.enable_tick) == 15
    assert got.target_vel == float(want.target_vel) == 8.0
    assert got.slot_states.shape[:2] == (12, 8) and got.active[-1].sum() >= 5
    with pytest.raises(ValueError, match="multiple of 5"):
        tepisode.build_episode_inputs(tsim, 33)


def test_episode_float64_matches_jax(episodes64):
    """The same cycles plan, succeed and take the same iteration counts up to
    the failing cycle (none fails), and the ego stays within 1e-4 m of
    mind_tpu's (float64: sums in another order)."""
    want, got, _, phases, _ = episodes64
    assert got.fail_cycle == want.fail_cycle == -1
    assert got.plan_calls == want.plan_calls == 3
    np.testing.assert_array_equal(got.planned, np.asarray(want.planned))
    np.testing.assert_array_equal(got.plan_ok, np.asarray(want.plan_ok))
    np.testing.assert_array_equal(got.iterations, np.asarray(want.iterations))
    assert got.ego_states.shape == want.ego_states.shape == (HORIZON, 4)
    np.testing.assert_allclose(got.ego_states, want.ego_states, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.controls, np.asarray(want.controls), rtol=0, atol=1e-5)
    # one phase record per cycle; only the planning cycles have plan phases
    assert [p["cycle"] for p in phases] == list(range(HORIZON // 5))
    assert [("solve" in p) for p in phases] == got.planned.tolist()
    assert all(p["rounds"] >= 1 for p in phases if "solve" in p)


@pytest.fixture(scope="module")
def loops64(world):
    """Both packages' Simulator loops over HORIZON ticks at float64 (staged
    plans with exported trees, host float64 integration), from fresh sims;
    mind_tpu first."""
    import mind_tpu.data.loader as jloader

    jsim, tsim = make_sims(world)
    tsim.run_sim()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jloader, "load_scenario", lambda path: world.jscenario)
        jsim.run_sim()
    finally:
        mp.undo()
    return jsim, tsim


def test_episode_matches_simulator_loop(episodes64, loops64):
    """The episode against the port's own Simulator loop: the same plan
    count, ego within 1e-3 m (the BASELINE.json budget)."""
    _, got, _, _, _ = episodes64
    _, tsim = loops64
    m = tsim.metrics
    assert m["plan_calls"] == got.plan_calls and m["ticks"] == HORIZON
    traj = tsim.ego_trajectory()
    assert traj.shape == got.ego_states.shape
    np.testing.assert_allclose(got.ego_states, traj, rtol=0, atol=1e-3)
    # the planned ego left its log
    assert np.linalg.norm(traj[-1, :2] - ego(tsim).traj_pos[HORIZON - 1]) > 1e-3


def test_episode_loop_gap_is_the_jax_packages(episodes64, loops64):
    """The episode and the host loop part at the first tick after the enable
    tick (measured 1.06e-4 m here, and ~1.2e-4 m on the card's scenario):
    mind_tpu's episode and loop part the same way, to float64 rounding,
    so the gap is the JAX package's semantics at the enable tick, kept."""
    want, got, _, _, _ = episodes64
    jsim, tsim = loops64
    t_gap = np.abs(got.ego_states - tsim.ego_trajectory())
    j_gap = np.abs(want.ego_states - jsim.ego_trajectory())
    first = int(ENABLE / 0.02) + 1
    assert t_gap[:first].max() < 1e-9 and t_gap[first].max() > 1e-6
    np.testing.assert_allclose(t_gap, j_gap, rtol=0, atol=1e-6)


def test_segmented_equals_whole(episodes64):
    """4-cycle segments over 6 cycles ([4, 2]): the same cycles on the same
    data, so the same result to the bit."""
    _, whole, seg, _, _ = episodes64
    assert seg.fail_cycle == whole.fail_cycle and seg.plan_calls == whole.plan_calls
    for f in ("ego_states", "plan_ok", "planned", "iterations", "controls"):
        np.testing.assert_array_equal(getattr(seg, f), getattr(whole, f), err_msg=f)
    with pytest.raises(ValueError, match="seg_cycles"):
        tepisode.run_episode_segmented(None, seg_cycles=0)


def test_to_result_truncates_at_fail_cycle():
    """A plan failure cuts the rollout at the failing cycle; mind_tpu's
    _to_result gives the same on the same arrays."""
    from mind_tpu.sim.episode import _to_result

    class _Pl:
        origin = np.array([100.0, -200.0])

    C = 4
    rec = np.random.default_rng(0).normal(size=(C, tepisode.TICKS_PER_PLAN, 4))
    ok = np.array([True, False, False, False])
    planned = np.array([True, True, False, False])
    for args in ((rec, ok, planned, np.arange(C), np.zeros((C, 2))),
                 (rec, np.ones(C, bool), np.ones(C, bool), np.arange(C), np.ones((C, 2)))):
        got, want = tepisode._to_result(_Pl(), *args), _to_result(_Pl(), *args)
        assert got.fail_cycle == want.fail_cycle and got.plan_calls == want.plan_calls
        np.testing.assert_array_equal(got.ego_states, want.ego_states)
    res = tepisode._to_result(_Pl(), rec, ok, planned, np.zeros(C), np.zeros((C, 2)))
    assert res.fail_cycle == 1 and res.plan_calls == 2
    assert len(res.ego_states) == 2 * tepisode.TICKS_PER_PLAN
    np.testing.assert_array_equal(res.ego_states[:, :2], rec[:2].reshape(-1, 4)[:, :2] + _Pl.origin)


def test_monte_carlo_starts_match_jax(world, episodes64):
    """perturb_ego_starts equals mind_tpu's for one seed; build_mc_inputs
    stacks the copies' schedules, each copy's cycle-0 ego at its start and
    enabled at tick 0."""
    from mind_tpu.sim.episode import perturb_ego_starts

    base = np.array([12.0, -3.0, 5.0, 0.3])
    want = perturb_ego_starts(base, 16, 0.5, 0.25, 2.0, seed=7)
    got = tepisode.perturb_ego_starts(base, 16, 0.5, 0.25, 2.0, seed=7)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 2] >= 0).all() and got.shape == (16, 4)

    tsim = episodes64[4]
    base_inp = tepisode.build_episode_inputs(tsim, HORIZON)
    copies = tepisode.build_mc_inputs(tsim, 3, seed=7, horizon=HORIZON)
    starts = tepisode.perturb_ego_starts(
        base_inp.ego_replay[0, 0].numpy(), 3, 0.5, 0.25,
        ego(tsim).planner.cfg.scen_tree.tar_dist_thres, 7)
    assert copies.enable_tick == 0 and copies.slot_states.shape[0] == 3
    for i, start in enumerate(starts):
        inp = tepisode.lane_inputs(copies, i)
        assert inp.enable_tick == 0
        np.testing.assert_array_equal(inp.slot_states[0, 0].numpy(), start)
        np.testing.assert_array_equal(inp.ego_replay[0, 0].numpy(), start)
        np.testing.assert_array_equal(inp.slot_states[1:].numpy(), base_inp.slot_states[1:].numpy())
        np.testing.assert_array_equal(inp.types.numpy(), base_inp.types.numpy())


def test_run_sim_episode_cli(world, tmp_path, capsys):
    """run_sim --episode on a parquet of the synthetic scenario, on the CPU,
    with the demo planner configuration at full width; the planner is
    enabled after the 15 ticks that run, so no plan is made."""
    pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    scenario_frame(world.syn.scenario).to_parquet(
        world.root / SEQ_ID / f"scenario_{SEQ_ID}.parquet")
    path = tmp_path / "sim.json"
    path.write_text('{"sim_name": "demo_1", "seq_id": "%s", "render": true, "cl_agents": '
                    '[{"id": "AV", "enable_timestep": 4.0, "agent": "agent:MINDAgent"}]}' % SEQ_ID)
    metrics = t_run_sim.main(["--config", str(path), "--data-root", str(world.root),
                              "--device", "cpu", "--max-steps", "15", "--episode"])
    assert metrics["ticks"] == 15 and metrics["plan_calls"] == 0 and metrics["fail_cycle"] == -1
    assert "metrics:" in capsys.readouterr().out


@pytest.fixture(scope="module")
def batched_episodes64(world):
    """Two scenarios (the world's, the AV asked for 8 and for 6 m/s) through
    both packages' run_episodes_batched at float64."""
    from mind_tpu.sim.episode import run_episodes_batched

    pairs = [make_sims(world, target_velocity=v) for v in (8.0, 6.0)]
    want = run_episodes_batched([j for j, _ in pairs], HORIZON)
    phases = []
    got = tepisode.run_episodes_batched([t for _, t in pairs], HORIZON, phases=phases)
    return want, got, phases, [t for _, t in pairs]


def test_episodes_batched_match_jax(batched_episodes64, episodes64):
    """Per scenario: the same cycles plan and succeed with the same
    iteration counts as mind_tpu's batched program, the ego within 1e-4 m
    (float64: sums in another order); the scenarios' plans differ. The
    8 m/s scenario against its own run_episode: within 1e-6 m (the network
    sums in another order in a batch of another size)."""
    want, got, phases, _ = batched_episodes64
    assert len(got) == len(want) == 2
    for s, (w, g) in enumerate(zip(want, got)):
        assert g.fail_cycle == w.fail_cycle == -1 and g.plan_calls == w.plan_calls == 3, s
        np.testing.assert_array_equal(g.planned, np.asarray(w.planned))
        np.testing.assert_array_equal(g.plan_ok, np.asarray(w.plan_ok))
        np.testing.assert_array_equal(g.iterations, np.asarray(w.iterations))
        np.testing.assert_allclose(g.ego_states, w.ego_states, rtol=0, atol=1e-4)
    assert np.abs(got[0].ego_states[-1] - got[1].ego_states[-1]).max() > 1e-3
    # one phase record per cycle of the batch
    assert [("solve" in p) for p in phases] == got[0].planned.tolist()
    single = episodes64[1]
    np.testing.assert_array_equal(got[0].iterations, single.iterations)
    np.testing.assert_allclose(got[0].ego_states, single.ego_states, rtol=0, atol=1e-6)


def test_episodes_batched_checks_its_inputs(batched_episodes64):
    """The batch needs one enable tick, one configuration and one set of
    weights (each broken in turn on the second scenario, then restored)."""
    *_, tsims = batched_episodes64
    other = ego(tsims[1])
    run = lambda: tepisode.run_episodes_batched(tsims, HORIZON)
    other.enable_timestep, keep = 0.5, other.enable_timestep
    try:
        with pytest.raises(ValueError, match="enable tick"):
            run()
    finally:
        other.enable_timestep = keep
    tt = other.planner.cfg.traj_tree
    tt.max_iterations += 1
    other.planner._init_programs()
    try:
        with pytest.raises(ValueError, match="configuration"):
            run()
    finally:
        tt.max_iterations -= 1
        other.planner._init_programs()
    w = next(other.planner.net.parameters())
    keep = w.detach().clone()
    with torch.no_grad():
        w.add_(1.0)
    try:
        with pytest.raises(ValueError, match="weights"):
            run()
    finally:
        with torch.no_grad():
            w.copy_(keep)


def test_build_mc_inputs_matches_jax(world):
    """The stacked Monte-Carlo schedule equals mind_tpu's to the bit."""
    from mind_tpu.sim.episode import build_mc_inputs

    jsim, tsim = make_sims(world)
    want = build_mc_inputs(jsim, 3, seed=5, horizon=HORIZON)
    got = tepisode.build_mc_inputs(tsim, 3, seed=5, horizon=HORIZON)
    for f in ("slot_states", "present", "active", "ego_replay", "types"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.enable_tick == 0 and np.asarray(want.enable_tick).tolist() == [0, 0, 0]
    assert got.target_vel == float(np.asarray(want.target_vel)[0])
