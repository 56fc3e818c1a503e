"""The closed loop of the PyTorch port against mind_tpu's on the small
synthetic AV2 world: target-lane synthesis and plan triggers of MINDAgent,
the Simulator with the planner enabled after 0.2 s (float64: ego within
1e-4 m, same plan ticks and trees; float32: controls within 1e-3), the
simulation-state files loaded across the packages, the replay rollouts,
the metrics and the run_sim CLI. Nothing in mind_tpu changes: its loader
gets the scenario through a monkeypatched load_scenario.
"""

import importlib.util
import shutil

import numpy as np
import pytest
import torch

from mind_tpu_torch import run_sim as t_run_sim
from mind_tpu_torch.config import ClAgentConfig as TClAgentConfig, SimConfig as TSimConfig
from mind_tpu_torch.sim import agents as tagents
from mind_tpu_torch.sim import replay as treplay
from mind_tpu_torch.sim import state_io as tstate_io
from mind_tpu_torch.sim.simulator import Simulator as TSimulator
from mind_tpu_torch.utils.metrics import Metrics as TMetrics, profile_trace as t_profile_trace
from mind_tpu_torch.viz.video import probe_avi
from test_torch_data import SEQ_ID, scenario_frame
from test_torch_planner import CL_AGENT, CPU, World, planner_cfgs, share_weights

ENABLE = 0.2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("av2"))


def closed_loops(world, monkeypatch, pipeline, solve, ticks):
    """Run both packages' Simulator for `ticks` ticks with the AV's planner
    enabled after ENABLE seconds. Returns ((sim, log), (sim, log)), mind_tpu
    first; a log holds per plan the tick, the control and the selected
    tree's root slot."""
    import mind_tpu.data.loader as jloader
    from mind_tpu.config import ClAgentConfig, SimConfig
    from mind_tpu.sim.simulator import Simulator

    monkeypatch.setattr(jloader, "load_scenario", lambda path: world.jscenario)
    jcfg, tcfg = planner_cfgs(world.n_lanes, pipeline, solve)
    common = dict(sim_name="demo_1", seq_id=SEQ_ID, data_root=str(world.root))
    jsim = Simulator(SimConfig(cl_agents=[ClAgentConfig(enable_timestep=ENABLE, **CL_AGENT)],
                               **common), planner_cfg=jcfg, max_steps=ticks)
    tsim = TSimulator(TSimConfig(cl_agents=[TClAgentConfig(enable_timestep=ENABLE, **CL_AGENT)],
                                 **common), planner_cfg=tcfg, max_steps=ticks, device=CPU,
                      scenario=world.syn.scenario)
    out = []
    for sim in (jsim, tsim):
        sim.init_sim()
    share_weights(ego(jsim), ego(tsim))
    for sim in (jsim, tsim):
        out.append((sim, record_plans(sim)))
        sim.run_sim()
    return out


def ego(sim):
    return next(a for a in sim.agents if a.id == "AV")


def record_plans(sim):
    agent, log = ego(sim), []
    plan = agent.plan

    def recorded():
        ok, res = plan()
        log.append((sim.metrics["ticks"], np.array(agent.ctrl, copy=True),
                    res[0][0].get_root_key() if ok else None))
        return ok, res

    agent.plan = recorded
    return log


@pytest.fixture(scope="module")
def loops64(world):
    mp = pytest.MonkeyPatch()
    try:
        return closed_loops(world, mp, "float64", "float64", 36)
    finally:
        mp.undo()


@pytest.mark.parametrize("use_traj, lane_id", [(False, None), (True, None), (False, 2),
                                               (True, 2), (True, 0)])
def test_target_lane_synthesis_equal(world, use_traj, lane_id):
    from mind_tpu.sim.agents import CustomizedAgent

    j, t = CustomizedAgent(), tagents.CustomizedAgent()
    idx = world.tbundle.track_ids.index("AV")
    j.init("AV", world.jbundle, idx, world.jsmp, use_traj=use_traj, semantic_lane_id=lane_id)
    t.init("AV", world.tbundle, idx, world.tsmp, use_traj=use_traj, semantic_lane_id=lane_id)
    np.testing.assert_array_equal(t.lcl_smp.target_lane, j.lcl_smp.target_lane)
    assert len(t.lcl_smp.target_lane) > 10
    assert t.lcl_smp.target_velocity == j.lcl_smp.target_velocity
    assert (t.lcl_smp.target_lane_info is None) == (j.lcl_smp.target_lane_info is None) == use_traj
    # the AV drives on the middle lane's first chain
    assert tagents.CustomizedAgent.get_closest_semantic_lane(
        world.tsmp, t.traj_pos, t.traj_ang) == CustomizedAgent.get_closest_semantic_lane(
            world.jsmp, j.traj_pos, j.traj_ang) == 2
    np.testing.assert_array_equal(t.state, j.state)
    with pytest.raises(ValueError):
        t.get_target_lane(world.tsmp, True, 99)


def test_trigger_ticks_equal():
    """sim_time is accumulated tick by tick, so the 10 Hz triggers (period
    0.1 - 1e-4 s) and the enable tick land where mind_tpu's do."""
    from mind_tpu.sim.agents import CustomizedAgent

    for enable in (0.0, 0.2, 1.0):
        logs = []
        for cls in (CustomizedAgent, tagents.CustomizedAgent):
            a = cls()
            a.traj_pos, a.traj_vel, a.traj_ang = np.zeros((5, 2)), np.zeros(5), np.zeros(5)
            a.set_enable_timestep(enable)
            sim_time, log = 0.0, []
            for tick in range(120):
                a.check_enable(sim_time)
                log.append((a.is_enable, *a.check_trigger(sim_time)))
                sim_time += 0.02
            logs.append(log)
        assert logs[0] == logs[1]
        plans = [i for i, (_, _, p) in enumerate(logs[1]) if p]
        assert plans == list(range(0, 120, 5))
        times = np.cumsum(np.r_[0.0, np.full(119, 0.02)])   # summed in the loop's order
        assert [e for e, _, _ in logs[1]].index(True) == int(np.argmax(times >= enable))


def test_closed_loop_float64_matches_jax(loops64):
    (jsim, jlog), (tsim, tlog) = loops64
    assert jsim.metrics["ticks"] == tsim.metrics["ticks"] == 36
    assert tsim.metrics["plan_calls"] == jsim.metrics["plan_calls"] == len(tlog) >= 5
    assert [t for t, _, _ in tlog] == [t for t, _, _ in jlog], "plan ticks"
    assert [k for _, _, k in tlog] == [k for _, _, k in jlog], "selected trees"
    assert None not in [k for _, _, k in tlog]
    for (_, tc, _), (_, jc, _) in zip(tlog, jlog):
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-5)
    jego, tego = jsim.ego_trajectory(), tsim.ego_trajectory()
    assert tego.shape == jego.shape == (36, 4) and np.isfinite(tego).all()
    np.testing.assert_allclose(tego, jego, rtol=0, atol=1e-4)
    # the planned ego left the log: it is no replay of the recorded track
    log_xy = ego(tsim).traj_pos[35]
    assert np.linalg.norm(tego[35, :2] - log_xy) > 1e-3
    assert tsim.metrics["plan_time_s"] <= tsim.metrics["wall_time_s"]
    assert set(ego(tsim).planner.metrics.timer.totals) == {"aime", "flatten", "solve", "export"}
    assert "scen_tree" in tsim.frames[tlog[-1][0]] and "traj_tree" in tsim.frames[tlog[-1][0]]


def test_closed_loop_float32_first_plans_match_jax(world, monkeypatch):
    (jsim, jlog), (tsim, tlog) = closed_loops(world, monkeypatch, "float32", "float32", 21)
    assert [t for t, _, _ in tlog] == [t for t, _, _ in jlog] and len(tlog) == 2
    for (_, tc, tk), (_, jc, jk) in zip(tlog, jlog):
        assert tk == jk, "selected tree"
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tsim.ego_trajectory(), jsim.ego_trajectory(), rtol=0, atol=1e-3)


def assert_sim_state_equal(a_sim, b_sim):
    assert a_sim.sim_time == b_sim.sim_time
    for a in a_sim.agents:
        b = next(x for x in b_sim.agents if x.id == a.id)
        np.testing.assert_array_equal(a.state, b.state)
        np.testing.assert_array_equal(a.ctrl, b.ctrl)
        assert (a.rec_step, a.timestep) == (b.rec_step, b.timestep)
    ea, eb = ego(a_sim), ego(b_sim)
    assert (ea.is_enable, ea.last_pl_tri, ea.enable_timestep) == \
        (eb.is_enable, eb.last_pl_tri, eb.enable_timestep)
    ba, bb = ea.planner.obs_buffer, eb.planner.obs_buffer
    assert ba.slots == bb.slots
    for f in ("types", "active", "last_present"):
        np.testing.assert_array_equal(getattr(ba, f), getattr(bb, f))
    for f in ("pos", "ang", "vel", "observed"):
        np.testing.assert_array_equal(np.asarray(getattr(ba.buf, f)),
                                      np.asarray(getattr(bb.buf, f)), err_msg=f)


def fresh_sims(world, monkeypatch):
    import mind_tpu.data.loader as jloader
    from mind_tpu.config import ClAgentConfig, SimConfig
    from mind_tpu.sim.simulator import Simulator

    monkeypatch.setattr(jloader, "load_scenario", lambda path: world.jscenario)
    jcfg, tcfg = planner_cfgs(world.n_lanes, "float64", "float64")
    common = dict(sim_name="demo_1", seq_id=SEQ_ID, data_root=str(world.root))
    jsim = Simulator(SimConfig(cl_agents=[ClAgentConfig(**CL_AGENT)], **common), planner_cfg=jcfg)
    tsim = TSimulator(TSimConfig(cl_agents=[TClAgentConfig(**CL_AGENT)], **common),
                      planner_cfg=tcfg, device=CPU, scenario=world.syn.scenario)
    jsim.init_sim()
    tsim.init_sim()
    return jsim, tsim


def test_sim_state_round_trip_and_cross_load(world, loops64, monkeypatch, tmp_path):
    """A state saved by either package loads in the other (same keys and
    meaning), and the port's own round trip restores every field."""
    from mind_tpu.sim.state_io import load_sim_state, save_sim_state

    (jsim, _), (tsim, _) = loops64
    t_path = tstate_io.save_sim_state(tsim, tmp_path / "port" / "state.npz")
    j_path = save_sim_state(jsim, tmp_path / "jax" / "state.npz")
    with np.load(t_path) as tz, np.load(j_path) as jz:
        assert sorted(tz.files) == sorted(jz.files)
        for k in tz.files:
            assert tz[k].dtype == jz[k].dtype and tz[k].shape == jz[k].shape, k

    jnew, tnew = fresh_sims(world, monkeypatch)
    ver = ego(tnew).planner.obs_buffer._ver
    tstate_io.load_sim_state(tnew, t_path)          # port -> port
    assert_sim_state_equal(tnew, tsim)
    buf = ego(tnew).planner.obs_buffer
    assert buf._ver > ver, "device-copy caches invalidated"
    assert buf.buf.pos.dtype == torch.float64 and buf.buf.pos.device == CPU
    load_sim_state(jnew, t_path)                    # port -> mind_tpu
    assert_sim_state_equal(jnew, tsim)
    tstate_io.load_sim_state(tnew, j_path)          # mind_tpu -> port
    assert_sim_state_equal(tnew, jsim)


def stacked_scenes(world):
    """Two replay scenes of one shape: the world's and a shifted, shorter
    copy (mind_tpu's as jnp stacks, the port's as tensors)."""
    import jax.numpy as jnp
    from mind_tpu.sim import replay as jreplay

    pairs = []
    for mod, bundle in ((jreplay, world.jbundle), (treplay, world.tbundle)):
        kw = {} if mod is jreplay else {"device": CPU}
        a = mod.scene_from_bundle(bundle, max_agents=12, **kw)
        cut = type(bundle)(bundle.pos[:5, :400] + 3.0, bundle.ang[:5, :400], bundle.vel[:5, :400],
                           bundle.has_flag[:5, :400], bundle.types[:5], bundle.track_ids[:5],
                           bundle.categories[:5])
        b = mod.scene_from_bundle(cut, max_agents=12, max_steps=546, **kw)
        stack = jnp.stack if mod is jreplay else torch.stack
        pairs.append((a, type(a)(*(stack([x, y]) for x, y in zip(a, b)))))
    return pairs


def test_replay_rollouts_match_jax(world):
    from mind_tpu.sim import replay as jreplay

    (ja, jstack), (ta, tstack) = stacked_scenes(world)
    for x, y in zip(ta, ja):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    H = 600   # past the log's 546 steps: the last step is held
    jst, jv = jreplay.replay_rollout(ja, H)
    tst, tv = treplay.replay_rollout(ta, H)
    assert tst.shape == (H, 12, 4) and tv.shape == (H, 12)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tst[-1].numpy(), tst[545].numpy())

    jbs, jbv = jreplay.batched_replay(jstack, H)
    tbs, tbv = treplay.batched_replay(tstack, H)
    assert tbs.shape == (2, H, 12, 4)
    np.testing.assert_array_equal(tbs.numpy(), np.asarray(jbs))
    np.testing.assert_array_equal(tbv.numpy(), np.asarray(jbv))

    # float32 positions ~2300 m from the origin (spacing 2.4e-4 m): mind_tpu
    # adds 600 steps to the position one by one and rounds each time, the
    # port adds the steps' cumulative sum to the start. Against the same sum
    # in float64 the port stays within 5e-3 m (measured 2.4e-4) and mind_tpu
    # within 0.15 m (measured 6.5e-2), so the two agree within 0.15 m.
    offsets = np.random.default_rng(0).normal(0.0, 0.5, (3, 12, 2)).astype(np.float32)
    rec = np.minimum(np.arange(1, H + 1), 545)
    pos, ang, vel = (x.numpy().astype(np.float64) for x in (ta.pos, ta.ang, ta.vel))
    steps = np.stack([vel[:, rec] * np.cos(ang[:, rec]), vel[:, rec] * np.sin(ang[:, rec])],
                     -1) * np.float64(np.float32(0.02))
    for k in range(3):
        want = np.asarray(jreplay.perturbed_rollout(ja, H, offsets[k]))
        got = treplay.perturbed_rollout(ta, H, torch.tensor(offsets[k]))
        exact = (pos[:, :1] + offsets[k][:, None] + np.cumsum(steps, 1)).transpose(1, 0, 2)
        assert got.shape == (H, 12, 4)
        np.testing.assert_allclose(got[..., :2].numpy(), exact, rtol=0, atol=5e-3)
        np.testing.assert_allclose(want[..., :2], exact, rtol=0, atol=0.15)
        np.testing.assert_array_equal(got[..., 2:].numpy(), want[..., 2:])
    many = treplay.perturbed_rollout(ta, H, offsets)
    assert many.shape == (3, H, 12, 4)
    np.testing.assert_array_equal(many[1].numpy(), treplay.perturbed_rollout(
        ta, H, offsets[1]).numpy())


def test_metrics_and_profile_trace(tmp_path):
    from mind_tpu.utils.metrics import Metrics

    dumps = []
    for cls in (Metrics, TMetrics):
        m = cls()
        m.incr("plans")
        m.incr("plans", 2)
        m.observe("trees", 3)
        with m.timer.phase("aime"):
            pass
        d = m.to_dict()
        assert d["counters"] == {"plans": 3, "gauge/trees": 3}
        assert d["phases"]["aime"]["calls"] == 1 and isinstance(m.dump(), str)
        dumps.append(sorted(d["phases"]["aime"]))
        m.timer.reset()
        assert m.timer.summary() == {}
    assert dumps[0] == dumps[1]
    with t_profile_trace(None):
        pass
    with t_profile_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_entry_points_need_a_device_without_gpu(world, tmp_path):
    """With no GPU, Simulator and run_sim raise unless given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    cfg = TSimConfig(sim_name="demo_1", seq_id=SEQ_ID, data_root=str(world.root),
                     cl_agents=[TClAgentConfig(id="AV")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSimulator(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treplay.scene_from_bundle(world.tbundle)
    path = tmp_path / "sim.json"
    path.write_text('{"sim_name": "demo_1", "seq_id": "%s", "cl_agents": []}' % SEQ_ID)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_run_sim.main(["--config", str(path), "--data-root", str(world.root)])


def test_run_sim_cli(world, tmp_path, capsys, monkeypatch):
    """The CLI on a parquet of the synthetic scenario, on the CPU, with the
    demo planner configuration at full width. The planner is enabled after
    the 12 ticks that run, so it takes observations and makes no plan. With
    rendering on it writes the 12 frames as an MJPEG AVI, or raises the
    ImportError of matplotlib or PIL where they are missing."""
    pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    scenario_frame(world.syn.scenario).to_parquet(
        world.root / SEQ_ID / f"scenario_{SEQ_ID}.parquet")
    path = tmp_path / "sim.json"
    out_dir = tmp_path / "out"
    path.write_text('{"sim_name": "demo_1", "seq_id": "%s", "render": true, "num_threads": 1, '
                    '"output_dir": "%s", "cl_agents": [{"id": "AV", "enable_timestep": 4.0, '
                    '"agent": "agent:MINDAgent"}]}' % (SEQ_ID, out_dir))
    args = ["--config", str(path), "--data-root", str(world.root), "--device", "cpu",
            "--max-steps", "12"]
    metrics = t_run_sim.main(args + ["--no-render"])
    assert metrics["ticks"] == 12 and metrics["plan_calls"] == 0
    assert "metrics:" in capsys.readouterr().out
    assert not out_dir.exists()
    monkeypatch.setattr(shutil, "which", lambda name: None)     # no ffmpeg: the AVI writer
    if importlib.util.find_spec("matplotlib") and importlib.util.find_spec("PIL"):
        t_run_sim.main(args)                       # render: true in the config
        info = probe_avi(str(out_dir / f"{SEQ_ID}_demo_1.avi"))
        assert info["frames"] == 12 and info["jpeg_ok"]
    else:
        with pytest.raises(ImportError):
            t_run_sim.main(args)
    episode = t_run_sim.main(args[:-1] + ["10", "--episode"])   # render on: --episode turns it off
    assert episode["ticks"] == 10 and episode["plan_calls"] == 0 and episode["fail_cycle"] == -1
    assert episode["wall_time_s"] > 0
    with pytest.raises(SystemExit, match="not found"):
        t_run_sim.main(["--config", str(tmp_path / "none.json"), "--device", "cpu"])
