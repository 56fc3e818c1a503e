"""The float64 parity mirror of the PyTorch port (mind_tpu_torch/parity)
against mind_tpu's on the small synthetic AV2 world, with the same network
weights (mind_tpu's seeded small network, carried across with
params_from_flax):

- HostRefPlanner, port vs JAX, on the same observations at three plans
  (the regression head scaled 10x, 128 scenario-tree slots: trees of 2-3
  roots and up to ~75 nodes):
  the same node set (parents, branch times, durations), tree roots,
  selected tree and record_debug decisions; controls within 1e-5;
- the port's mirror against the port's float64 MINDPlanner within 1e-3
  (tests/test_parity.py:43-73);
- the four runners, port vs JAX, on a short horizon of the demo_1
  configuration (a narrow network: 2 fusion layers, width 32, patched into
  planner_config_for_demo of both packages): the same plans compared and
  ok flips, per-cycle deviations within 1e-4 m of each other;
- the parity_run CLI on a synthetic data root.

Nothing in mind_tpu changes: its loader gets the scenario through a
monkeypatched load_scenario, and the runners of both packages read the
narrowed configuration through a monkeypatched planner_config_for_demo.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mind_tpu_torch.config import ClAgentConfig as TClAgentConfig
from mind_tpu_torch.models.weights import params_from_flax
from mind_tpu_torch.parity import HostRefPlanner as THostRefPlanner
from mind_tpu_torch.parity import runner as trunner
from mind_tpu_torch.sim import agents as tagents
from test_torch_planner import CL_AGENT, N_OBS_FRAMES, World, planner_cfgs

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DEMO = "demo_1"
DEMO_SEQ = json.loads((ROOT / "configs" / f"{DEMO}.json").read_text())["seq_id"]
CPU = torch.device("cpu")
# controls of the two mirrors: both run the same float64 numpy code on the
# float32 network's outputs, which differ by float32 sums in another order
TOL_MIRROR_CTRL = 1e-5
# per-cycle rollout deviations of the two packages' runners, metres
TOL_RUNNER_DEV = 1e-4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("av2"))


def agents(world, head=10.0):
    """(mind_tpu MINDAgent, port MINDAgent) of the AV at float64, with 128
    scenario-tree slots (the mirror has no limit; the planner must hold the
    whole tree to plan what the mirror plans), 256 cost nodes and 32 a level,
    and the seeded small network's regression head scaled by `head`."""
    from flax.traverse_util import flatten_dict, unflatten_dict
    from mind_tpu.config import ClAgentConfig
    from mind_tpu.models import init_scene_pred
    from mind_tpu.sim.agents import load_agents

    jcfg, tcfg = planner_cfgs(world.n_lanes, "float64", "float64", max_cost_nodes=256,
                              max_width_hint=32)
    for c in (jcfg, tcfg):
        c.scen_tree.max_tree_nodes = 128
    j = next(a for a in load_agents(world.jbundle, world.jsmp, [ClAgentConfig(**CL_AGENT)],
                                    lambda p: jcfg) if a.id == "AV")
    t = next(a for a in tagents.load_agents(world.tbundle, world.tsmp,
                                            [TClAgentConfig(**CL_AGENT)], lambda p: tcfg, CPU)
             if a.id == "AV")
    _, params, _ = init_scene_pred(jcfg.net, jcfg.max_actors, jcfg.max_lanes, seed=jcfg.seed)
    flat = {k: np.asarray(v) * (head if k.startswith("params/SceneDecoder_0/Dense_1/") else 1.0)
            for k, v in flatten_dict(params, sep="/").items()}
    j.planner.params = unflatten_dict(flat, sep="/")
    t.planner.net.load_state_dict(params_from_flax(flat))
    return j, t


def mirrors(j, t):
    """(mind_tpu HostRefPlanner, port HostRefPlanner) of the AV, each
    sharing its own package's planner network, with record_debug on."""
    from mind_tpu.parity import HostRefPlanner

    jp, tp = j.planner, t.planner
    jm = HostRefPlanner(jp.cfg, j._smp, j.lcl_smp,
                        shared_net=(jp.model, jp.params, jp.batched_apply), record_debug=True)
    tm = THostRefPlanner(tp.cfg, t._smp, t.lcl_smp, shared_net=tp.net, record_debug=True)
    for m, a in ((jm, j), (tm, t)):
        m.update_target_lane(a.gt_tgt_lane)
    return jm, tm


PLAN_FRAMES = (N_OBS_FRAMES, N_OBS_FRAMES + 5, N_OBS_FRAMES + 10)


@pytest.fixture(scope="module")
def mirror_plans(world):
    """Both mirrors and the port's float64 MINDPlanner fed the same 10 Hz
    stream, planning at three frames with one control held throughout.
    Returns per plan ((jax ok, ctrl, debug), (port ok, ctrl, debug), port
    planner (ok, ctrl)) and both mirrors' diagnostics."""
    j, t = agents(world)
    jm, tm = mirrors(j, t)
    out = []
    for f in range(PLAN_FRAMES[-1] + 1):
        for m, bundle in ((jm, world.jbundle), (tm, world.tbundle), (t.planner, world.tbundle)):
            m.update_observation(world.observations(bundle, f))
        if f in PLAN_FRAMES:
            state = world.observations(world.tbundle, f)[0][1]
            rec = []
            for m in (jm, tm, t.planner):
                m.update_state_ctrl(state, np.array([0.3, 0.01]))
                ok, ctrl, _ = m.plan()
                rec.append((ok, ctrl, getattr(m, "debug", None)))
            out.append(rec)
    return out, (jm.diagnostics, tm.diagnostics)


def test_mirror_matches_jax(mirror_plans):
    plans, diagnostics = mirror_plans
    worst = 0.0
    for (jok, jctrl, jdbg), (tok, tctrl, tdbg), _ in plans:
        assert jok and tok
        for k in ("tree_roots", "best_root", "n_nodes"):
            assert tdbg[k] == jdbg[k], k
        assert [{k: n[k] for k in ("key", "parent", "cur_t", "t_b", "duration", "end")}
                for n in tdbg["scen_nodes"]] == \
            [{k: n[k] for k in ("key", "parent", "cur_t", "t_b", "duration", "end")}
             for n in jdbg["scen_nodes"]]
        np.testing.assert_allclose([n["norm_prob"] for n in tdbg["scen_nodes"]],
                                   [n["norm_prob"] for n in jdbg["scen_nodes"]], atol=1e-6)
        assert len(tdbg["rounds"]) == len(jdbg["rounds"])
        for tr, jr in zip(tdbg["rounds"], jdbg["rounds"]):
            for k in ("branch_key", "cur_t", "keep", "t_b"):
                assert tr[k] == jr[k], k
        np.testing.assert_allclose(tdbg["tree_costs"], jdbg["tree_costs"], rtol=1e-6)
        worst = max(worst, float(np.abs(tctrl - jctrl).max()))
    print(f"mirror port vs JAX: {len(plans)} plans, "
          f"{[len(p[1][2]['tree_roots']) for p in plans]} trees, control gap {worst:.3e} "
          f"(tolerance {TOL_MIRROR_CTRL})")
    assert worst <= TOL_MIRROR_CTRL
    jdiag, tdiag = diagnostics
    assert tdiag == jdiag and tdiag["plans"] == len(plans) and tdiag["plan_failures"] == 0


def test_mirror_matches_port_planner(mirror_plans):
    """The port's mirror against the port's float64 MINDPlanner on the same
    observations (tests/test_parity.py:43-73): controls within 1e-3."""
    plans, _ = mirror_plans
    for _, (tok, tctrl, tdbg), (pok, pctrl, _) in plans:
        assert tok and pok
        np.testing.assert_allclose(pctrl, tctrl, atol=1e-3)


def test_mirror_seeds_its_own_network(world):
    """Without shared_net the mirror seeds a network from cfg.seed with
    init_scene_pred, in eval mode, on the device it is given."""
    from mind_tpu_torch.models.train import init_scene_pred

    _, t = agents(world)
    cfg = t.planner.cfg
    m = THostRefPlanner(cfg, t._smp, t.lcl_smp, device="cpu")
    want = init_scene_pred(cfg.net, seed=cfg.seed, device=CPU)
    assert not m.net.training and m.device == CPU
    for (k, a), (_, b) in zip(m.net.state_dict().items(), want.state_dict().items()):
        assert torch.equal(a, b), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            THostRefPlanner(cfg, t._smp, t.lcl_smp)


# ---------------------------------------------------------------------------
# the four runners and the CLI on the demo_1 configuration, narrowed
# ---------------------------------------------------------------------------

NARROW = dict(n_scene_layer=2, n_fpn_scale=2, d_actor=32, d_lane=32, d_embed=32, d_rpe=32,
              n_scene_head=4)
ENABLE = 0.3           # the playback runners' enable time: plans at ticks 15, 20, 25
PLAY_TICKS = 30
LOOP_TICKS = 215       # demo_1 enables the planner at 4 s: plans at ticks 200-210


class Demo:
    """The small synthetic world as demo_1's data root (the map under demo_1's
    seq_id), the narrowed demo configurations of both packages and the
    mind_tpu network's seeded weights as a flax .npz for the port."""

    def __init__(self, world, root):
        from flax.traverse_util import flatten_dict
        from mind_tpu.config import NetConfig, planner_config_for_demo
        from mind_tpu.models import init_scene_pred

        from mind_tpu_torch.config import NetConfig as TNetConfig
        from mind_tpu_torch.config import planner_config_for_demo as t_for_demo
        from mind_tpu_torch.synthetic import write_synthetic_map

        self.world, self.root = world, root
        write_synthetic_map(world.syn.map_json, root, DEMO_SEQ)
        self.j_for_demo, self.t_for_demo = planner_config_for_demo, t_for_demo
        self.jnet = lambda: NetConfig(**NARROW, use_pallas_fusion=False)
        self.tnet = lambda: TNetConfig(**NARROW)
        jcfg = self.jcfg(DEMO)
        _, params, _ = init_scene_pred(jcfg.net, jcfg.max_actors, jcfg.max_lanes, seed=jcfg.seed)
        self.npz = root / "weights.npz"
        np.savez(self.npz, **{k: np.asarray(v)
                              for k, v in flatten_dict(params, sep="/").items()})

    def narrow(self, cfg, net):
        """The demo configuration at the small world's sizes, the network
        narrowed and in float32 (as tests/test_parity.py runs it)."""
        cfg.net = net
        cfg.max_actors, cfg.max_lanes = 8, self.world.n_lanes
        cfg.scen_tree.max_branch_nodes = 4
        cfg.scen_tree.max_tree_nodes = 32
        cfg.traj_tree.max_cost_nodes = 128
        cfg.traj_tree.n_line_search = 4
        return cfg

    def jcfg(self, demo):
        cfg = self.narrow(self.j_for_demo(demo), self.jnet())
        cfg.ckpt_path = None
        return cfg

    def tcfg(self, demo):
        cfg = self.narrow(self.t_for_demo(demo), self.tnet())
        cfg.ckpt_path = str(self.npz)
        return cfg

    def patch(self, mp):
        """Both packages read the narrowed configurations and mind_tpu reads
        the in-memory scenario."""
        import mind_tpu.config as jconfig
        import mind_tpu.data.loader as jloader

        import mind_tpu_torch.config as tconfig

        mp.setattr(jloader, "load_scenario", lambda path: self.world.jscenario)
        mp.setattr(jconfig, "planner_config_for_demo", self.jcfg)
        mp.setattr(tconfig, "planner_config_for_demo", self.tcfg)


@pytest.fixture(scope="module")
def demo(world, tmp_path_factory):
    return Demo(world, tmp_path_factory.mktemp("demo_root"))


@pytest.fixture(scope="module")
def runs(demo):
    """Each runner of both packages once: {name: (mind_tpu result, port
    result)}."""
    from mind_tpu.parity import runner as jrunner

    mp = pytest.MonkeyPatch()
    out = {}
    try:
        demo.patch(mp)
        t_kw = dict(data_root=str(demo.root), device=CPU, scenario=demo.world.syn.scenario)
        j_kw = dict(data_root=str(demo.root))
        play = dict(enable_timestep=ENABLE)
        for name, args, extra in (
                ("playback", (DEMO, PLAY_TICKS), play),
                ("diagnostic", (DEMO, PLAY_TICKS), dict(play, worst_k=3)),
                ("resync", (DEMO, LOOP_TICKS), {}),
                ("free", (DEMO, LOOP_TICKS), {})):
            fn = {"playback": "run_parity_episode_playback",
                  "diagnostic": "run_playback_diagnostic",
                  "resync": "run_parity_demo_resync", "free": "run_parity_demo"}[name]
            jargs = dict(j_kw, **extra)
            if name in ("playback", "diagnostic"):
                jargs["planner_cfg"] = demo.jcfg(DEMO)
                extra = dict(extra, planner_cfg=demo.tcfg(DEMO))
            out[name] = (getattr(jrunner, fn)(*args, **jargs),
                         getattr(trunner, fn)(*args, **t_kw, **extra))
    finally:
        mp.undo()
    return out


def assert_devs_close(got, want, keys):
    for k in keys:
        assert abs(got[k] - want[k]) <= TOL_RUNNER_DEV, (k, got[k], want[k])


def test_playback_runner_matches_jax(runs):
    want, got = runs["playback"]
    assert got["plans_compared"] == want["plans_compared"] >= 2
    assert got["ok_mismatches"] == want["ok_mismatches"] == 0
    assert got["fail_cycle"] == want["fail_cycle"] == -1 and got["ticks"] == PLAY_TICKS
    assert [r["cycle"] for r in got["records"]] == [r["cycle"] for r in want["records"]]
    gaps = [abs(g["cycle_dev"] - w["cycle_dev"]) for g, w in zip(got["records"],
                                                                   want["records"])]
    print(f"playback: per-cycle deviations port {[r['cycle_dev'] for r in got['records']]}, "
          f"gap to mind_tpu's {max(gaps):.3e} (tolerance {TOL_RUNNER_DEV})")
    assert max(gaps) <= TOL_RUNNER_DEV
    assert_devs_close(got, want, ("max_cycle_dev", "mean_cycle_dev"))
    assert got["mean_cycle_dev"] <= 1e-3


def test_diagnostic_runner_matches_jax(runs):
    want, got = runs["diagnostic"]
    assert got["fail_cycle"] == want["fail_cycle"] == -1
    keys = ("cycle", "ok_dev", "ok_host", "n_trees_dev", "n_trees_host", "n_end_nodes_dev",
            "n_end_nodes_host", "best_dev", "best_host")
    assert [{k: c[k] for k in keys if k in c} for c in got["cycles"]] == \
        [{k: c[k] for k in keys if k in c} for c in want["cycles"]]
    for g, w in zip(got["cycles"], want["cycles"]):
        assert abs(g["cycle_dev"] - w["cycle_dev"]) <= TOL_RUNNER_DEV
        np.testing.assert_allclose(g["tree_costs_host"], w["tree_costs_host"], rtol=1e-4)
    w = got["worst"][0]
    for key in ("cycle_dev", "ctrl_dev", "tree_costs_dev", "tree_costs_host",
                "selection_margin_dev", "selection_margin_host", "dev_nodes", "host_debug"):
        assert key in w, key
    assert w["n_end_nodes_dev"] == w["n_end_nodes_host"] and \
        w["n_trees_dev"] == w["n_trees_host"]


def test_resync_runner_matches_jax(runs):
    want, got = runs["resync"]
    for k in ("ticks", "plans", "plans_compared", "ok_mismatches", "host_failures"):
        assert got[k] == want[k], k
    assert got["plans_compared"] >= 2 and got["ok_mismatches"] == 0
    print(f"resync: max / mean cycle deviation port {got['max_cycle_dev']:.3e} / "
          f"{got['mean_cycle_dev']:.3e}, mind_tpu {want['max_cycle_dev']:.3e} / "
          f"{want['mean_cycle_dev']:.3e}")
    assert_devs_close(got, want, ("max_cycle_dev", "mean_cycle_dev"))


def test_free_run_runner_matches_jax(runs):
    want, got = runs["free"]
    for k in ("ticks_dev", "ticks_host", "plans_dev", "closed_loop_steps", "host_failures",
              "branch_overflows"):
        assert got[k] == want[k], k
    assert got["plans_dev"] >= 2 and got["closed_loop_steps"] == LOOP_TICKS - 200
    print(f"free run: max deviation port {got['max_dev_all']:.3e}, "
          f"mind_tpu {want['max_dev_all']:.3e}")
    assert_devs_close(got, want, ("max_dev_all", "max_dev_cl", "mean_dev_cl", "final_dev"))


def test_parity_run_cli(demo, tmp_path, capsys):
    """python -m mind_tpu_torch.parity_run on a data root holding the
    synthetic scenario as demo_1's parquet: the playback and the resynced
    run, and the report."""
    pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    from mind_tpu_torch import parity_run
    from test_torch_data import scenario_frame

    scenario_frame(demo.world.syn.scenario).to_parquet(
        demo.root / DEMO_SEQ / f"scenario_{DEMO_SEQ}.parquet")
    report = tmp_path / "PARITY.md"
    mp = pytest.MonkeyPatch()
    try:
        demo.patch(mp)
        out = parity_run.main(["--demos", "1", "--steps", "205", "--skip", "free",
                               "--report", str(report), "--data-root", str(demo.root),
                               "--device", "cpu"])
    finally:
        mp.undo()
    (play,), (sync,) = out["playback"], out["resync"]
    assert play["plans_compared"] == sync["plans_compared"] == 1
    assert play["ok_mismatches"] == sync["ok_mismatches"] == 0
    text = report.read_text()
    assert "| demo_1 | 1 | 0 |" in text and "## 3. Free-run" in text
    assert "episode playback PASS" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        parity_run.main(["--free-modes", "nope", "--device", "cpu"])
