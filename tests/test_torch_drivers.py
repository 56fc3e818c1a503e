"""The port's drivers (mind_tpu_torch/scripts/) against mind_tpu and the JAX
package's scripts/*.py on the CPU.

On the small synthetic AV2 world with the settings of test_torch_episode.py
(float64 pipeline and solve, the planner on after 0.3 s, 30 ticks: 3
plans, the shared spread weights): run_all_demos' host and episode rows
against mind_tpu's Simulator.run_sim and run_episode_timed, bench_strict's
row against mind_tpu's run_episode_segmented, and diag_playback's JSON
against the field names of mind_tpu's run_playback_diagnostic. Without a
model: the report's layout against DEMOS_TPU.md, the policy tables
against the JAX scripts' (VARIANTS, FREE_MODES), each variant's planner
configuration and the north-star verdict against what the JAX scripts
build and print when their simulator is a stub, and the drivers' refusals:
a line that is no literal, a missing log, a committed artifact's path, a
failed probe, an unknown step.
"""

import ast
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mind_tpu_torch import scripts
from mind_tpu_torch.parity import runner as trunner
from mind_tpu_torch.scripts import (bench_exec_ab, bench_north_star, bench_strict, diag_playback,
                                    run_all_demos, run_evidence)
from test_torch_episode import ENABLE, HORIZON, make_sims
from test_torch_planner import World, planner_cfgs

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(tmp_path_factory.mktemp("av2"))


def jax_script(name):
    """scripts/<name>.py of the JAX package as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", ROOT / "scripts" /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ego(sim):
    return next(a for a in sim.agents if a.id == "AV")


# ---------------------------------------------------------------------------
# on the small world, against mind_tpu
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def demo_runs(world, tmp_path_factory):
    """run_all_demos' main in both modes on the small world (its sims are
    make_sims' port sims), and mind_tpu's Simulator.run_sim and
    run_episode_timed on the same scenario."""
    from mind_tpu.sim.episode import run_episode_timed

    mp = pytest.MonkeyPatch()
    out = tmp_path_factory.mktemp("demos")
    built = []

    def small_sim(opts, demo, root, ticks=None):
        jsim, tsim = make_sims(world, ticks=ticks)
        built.append(jsim)
        return tsim

    try:
        mp.setattr(run_all_demos, "demo_sim", small_sim)
        rc = run_all_demos.main(["--mode", "both", "--demos", "1", "--steps", str(HORIZON),
                                 "--data-root", str(world.root), "--device", "cpu",
                                 "--json-out", str(out / "host.json"),
                                 "--episode-json", str(out / "episode.json"),
                                 "--report", str(out / "DEMOS.md")])
    finally:
        mp.undo()
    jep, jhost = built
    jres, _ = run_episode_timed(jep, HORIZON)
    jm = jhost.run_sim()
    return rc, out, jres, jm, jhost


def test_run_all_demos_rows_match_jax(demo_runs):
    """The rows equal mind_tpu's on the same scenario: ticks, plans, plan
    failures; the final ego speed within 1e-3."""
    rc, out, jres, jm, jhost = demo_runs
    assert rc == 0
    (ep,) = json.loads((out / "episode.json").read_text())["rows"]
    (host,) = json.loads((out / "host.json").read_text())
    assert ep["ticks"] == len(jres.ego_states) == HORIZON
    assert ep["plan_calls"] == jres.plan_calls == 3
    assert ep["plan_failures"] == 0 and jres.fail_cycle == -1
    assert abs(ep["final_ego_v"] - float(jres.ego_states[-1, 2])) <= 1e-3
    jav = ego(jhost)
    assert host["ticks"] == jm["ticks"] == HORIZON
    assert host["plan_calls"] == jm["plan_calls"] == host["plans_ok"] == 3
    assert host["plan_failures"] == int(jav.planner.metrics.counters.get("plan_failures", 0)) == 0
    assert abs(host["final_ego_v"] - float(jav.state[2])) <= 1e-3
    for r in (ep, host):
        assert r["steps_per_sec"] > 0 and r["launches"] == {"float32": 0, "bfloat16": 0}


def report_skeleton(text):
    """The section headings and the table header rows of a DEMOS report."""
    lines = text.splitlines()
    return ([ln for ln in lines if ln.startswith("## ")],
            [ln for ln in lines if ln.startswith("| demo |")])


def test_run_all_demos_report_has_the_demos_tpu_layout(demo_runs):
    rc, out, *_ = demo_runs
    got = (out / "DEMOS.md").read_text()
    want = (ROOT / "DEMOS_TPU.md").read_text()
    assert report_skeleton(got) == report_skeleton(want)
    assert got.startswith("# DEMOS — closed-loop acceptance (")
    assert "**Result: PASS**" in got and f"| demo_1 | {HORIZON} | 3 | 0 |" in got


def test_run_all_demos_merges_only_a_matching_episode_file(tmp_path, capsys):
    path = tmp_path / "ep.json"
    rows = [{"demo": "demo_1", "ticks": 250, "plan_failures": 0}]
    path.write_text(json.dumps({"steps": 250, "demos": "1", "rows": rows}))
    assert run_all_demos.saved_episode_rows(path, 250, "1") == rows
    assert run_all_demos.saved_episode_rows(path, 500, "1") == []
    assert run_all_demos.saved_episode_rows(path, 250, "1,2") == []
    assert "ignoring stale" in capsys.readouterr().out
    assert run_all_demos.saved_episode_rows(tmp_path / "none.json", 250, "1") == []


def test_run_all_demos_fail_exits_nonzero(world, tmp_path, monkeypatch):
    """A row short of the horizon is a FAIL, and FAIL exits non-zero."""
    def failing(demo, sim, steps=None):
        return {"demo": demo, "ticks": 25, "plan_calls": 1, "plan_failures": 1}

    monkeypatch.setattr(run_all_demos, "episode_row", failing)
    monkeypatch.setattr(run_all_demos, "demo_sim", lambda *a, **kw: None)
    rc = run_all_demos.main(["--mode", "episode", "--demos", "1", "--steps", "30",
                             "--data-root", str(world.root), "--device", "cpu",
                             "--episode-json", str(tmp_path / "ep.json")])
    assert rc == 1


def test_bench_strict_row_matches_jax_segmented(world):
    """bench_strict's row at float64 (its sim's solve) against mind_tpu's
    run_episode_segmented: the same plans and failing cycle, the ego within
    1e-4 m."""
    from mind_tpu.sim.episode import run_episode_segmented

    jsim, tsim = make_sims(world, "float64", "float64")
    assert ego(tsim).planner.cfg.traj_tree.solve_dtype == "float64"
    want = run_episode_segmented(jsim, HORIZON, seg_cycles=2)
    row, got = bench_strict.strict_row("demo_1", tsim, HORIZON, seg_cycles=2)
    assert row["plan_calls"] == got.plan_calls == want.plan_calls == 3
    assert row["fail_cycle"] == got.fail_cycle == want.fail_cycle == -1
    assert row["ticks"] == HORIZON and row["steps_per_s"] > 0
    np.testing.assert_allclose(got.ego_states, want.ego_states, rtol=0, atol=1e-4)
    assert bench_strict.strict_config("demo_3").traj_tree.solve_dtype == "float64"


def jax_diag_fields():
    """The string keys of the dicts mind_tpu's run_playback_diagnostic
    builds per cycle and returns."""
    tree = ast.parse((ROOT / "mind_tpu" / "parity" / "runner.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_playback_diagnostic")
    return {k.value for d in ast.walk(fn) if isinstance(d, ast.Dict)
            for k in d.keys if isinstance(k, ast.Constant) and isinstance(k.value, str)}


def test_diag_playback_json_has_the_jax_field_names(world, tmp_path, monkeypatch, capsys):
    """diag_playback's main on the small world (its runner given the small
    planner configuration and the scenario): the JSON's worst cycles carry
    every field name of mind_tpu's diagnostic, the summary line prints."""
    from mind_tpu_torch.config import CONFIGS, SimConfig
    from mind_tpu_torch.synthetic import write_synthetic_map

    _, tcfg = planner_cfgs(world.n_lanes, "float64", "float64")
    write_synthetic_map(world.syn.map_json, tmp_path,
                        SimConfig.from_json(CONFIGS / "demo_1.json").seq_id)
    real = trunner.run_playback_diagnostic
    monkeypatch.setattr(trunner, "run_playback_diagnostic", lambda *a, **kw: real(
        *a, **{**kw, "scenario": world.syn.scenario, "planner_cfg": tcfg,
               "enable_timestep": ENABLE}))
    path = tmp_path / "diag.json"
    assert diag_playback.main(["--demo", "demo_1", "--steps", str(HORIZON), "--worst", "2",
                               "--data-root", str(tmp_path), "--device", "cpu",
                               "--out", str(path)]) == 0
    out = json.loads(path.read_text())
    assert {"demo", "fail_cycle", "cycles", "worst"} <= set(out)
    fields = jax_diag_fields()
    assert {"cycle_dev", "ctrl_dev", "n_trees_dev", "n_trees_host", "n_end_nodes_dev",
            "n_end_nodes_host", "best_dev", "best_host", "selection_margin_dev",
            "selection_margin_host"} <= fields
    assert len(out["worst"]) == 2
    for r in out["worst"]:
        missing = fields - set(r) - {"demo", "fail_cycle", "cycles", "worst", "slot",
                                     "parent", "duration", "tree", "norm_prob"}
        assert not missing, missing
    assert "cycles compared, max dev" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the policy tables and verdicts against the JAX scripts
# ---------------------------------------------------------------------------

def test_policy_tables_equal_the_jax_scripts():
    from mind_tpu_torch.parity_run import FREE_MODES

    assert bench_exec_ab.VARIANTS == jax_script("bench_exec_ab").VARIANTS
    assert FREE_MODES == jax_script("parity_run").FREE_MODES


class StubResult:
    def __init__(self, ticks, plans):
        self.ego_states, self.plan_calls, self.fail_cycle = [0] * ticks, plans, -1


class StubAgent:
    """What the JAX scripts touch of the AV agent."""

    def __init__(self, pcfg):
        from mind_tpu.utils.metrics import Metrics

        self.id, self.enable_timestep = "AV", 4.0
        self.planner = type("P", (), dict(cfg=pcfg, origin=None, metrics=Metrics(),
                                          export_trees=True))()

    def set_enable_timestep(self, t):
        self.enable_timestep = t


def stub_simulator(built, delay_s=0.0):
    class StubSim:
        """mind_tpu's Simulator as the JAX scripts drive it: the planner
        configuration recorded, run_sim taking `delay_s` per call."""

        def __init__(self, cfg, planner_cfg=None, max_steps=None):
            self.sim_horizon = max_steps or cfg.sim_horizon
            self.agents = [StubAgent(planner_cfg)]
            built.append(planner_cfg)

        def init_sim(self):
            pass

        def run_sim(self):
            time.sleep(delay_s)
            return {"ticks": self.sim_horizon, "plan_calls": self.sim_horizon // 5}

    return StubSim


def run_jax_main(mod, argv, monkeypatch):
    import jax

    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    monkeypatch.setattr(jax.config, "update", lambda *a, **kw: None)
    monkeypatch.chdir(ROOT)
    mod.main()


def config_fields(cfg):
    """A planner configuration as a dict, without what the two packages
    name differently: the JAX network's use_pallas_fusion and the weight
    file's path."""
    d = dataclasses.asdict(cfg)
    d["net"].pop("use_pallas_fusion", None)
    d.pop("ckpt_path")
    return d


def test_exec_ab_variant_configs_equal_the_jax_scripts(tmp_path, monkeypatch):
    """The JAX script's main with a stub simulator and episode runner
    records the planner configuration of each variant; the port's
    variant_config equals each, field by field."""
    import mind_tpu.sim.episode as jepisode
    import mind_tpu.sim.simulator as jsimulator

    built = []
    monkeypatch.setattr(jsimulator, "Simulator", stub_simulator(built))
    monkeypatch.setattr(jepisode, "build_episode_inputs", lambda sim, *a: None)
    monkeypatch.setattr(jepisode, "run_episode", lambda sim, h, inp: StubResult(500, 60))
    run_jax_main(jax_script("bench_exec_ab"), ["--out", str(tmp_path / "ab.json")],
                 monkeypatch)
    names = [v[0] for v in bench_exec_ab.VARIANTS]
    assert len(built) == len(names) == 5
    for name, want in zip(names, built):
        assert config_fields(bench_exec_ab.variant_config(name)) == config_fields(want), name
    assert set(json.loads((tmp_path / "ab.json").read_text())) == set(names)


NOT_A_LITERAL = "{'demo': 'demo_1', 'max_dev_cl': __import__('os').getpid()}"


def free_row(demo, dev):
    return {"demo": demo, "ticks_dev": 260, "ticks_host": 260, "plans_dev": 12,
            "closed_loop_steps": 60, "max_dev_all": dev, "max_dev_cl": dev,
            "mean_dev_cl": dev / 2, "final_dev": dev, "host_failures": 0,
            "branch_overflows": 0, "wall_dev_s": 1.5, "wall_host_s": 9.25}


@pytest.mark.parametrize("delay_s, devs", [(0.0, (2e-4, 6e-4)), (0.0, (2e-4, 2e-3)),
                                           (0.2, (2e-4, 6e-4)), (0.2, None)],
                         ids=["both", "parity_fails", "throughput_fails", "no_free_log"])
def test_north_star_verdict_equals_the_jax_scripts(delay_s, devs, tmp_path, monkeypatch):
    """The JAX script's main on a stub simulator (5 ticks a demo, each run
    taking `delay_s`: 0.2 s puts 25 steps/s under the 41.5 of 50x) and a
    free-run log as parity_run prints it: the port's free_run_rows reads
    the same rows, and its verdict on the JAX script's throughput rows gives
    the JAX script's flags."""
    import mind_tpu.planner.planner as jplanner
    import mind_tpu.sim.simulator as jsimulator
    import mind_tpu.sim.state_io as jstate_io

    argv = ["--policy", "native_bal", "--steps", "5", "--demos", "1,2",
            "--out", str(tmp_path / "ns.json")]
    rows = []
    if devs is not None:
        rows = [free_row(f"demo_{i + 1}", d) for i, d in enumerate(devs)]
        log = tmp_path / "free.log"
        log.write_text("".join(f"=== {r['demo']} free-run, native_bal ===\n{r}\n"
                               for r in rows) + "free-run native_bal PASS (max 6.00e-04)\n")
        argv += ["--free-log", str(log)]
        assert bench_north_star.free_run_rows(log) == rows
    monkeypatch.setattr(jsimulator, "Simulator", stub_simulator([], delay_s))
    monkeypatch.setattr(jstate_io, "save_sim_state", lambda sim, path: None)
    monkeypatch.setattr(jstate_io, "load_sim_state", lambda sim, path: None)
    monkeypatch.setattr(jplanner, "ObsBuffer", lambda *a, **kw: None)
    run_jax_main(jax_script("bench_north_star"), argv, monkeypatch)
    want = json.loads((tmp_path / "ns.json").read_text())
    got = bench_north_star.verdict(want["throughput"], want.get("free_run", []))
    for k in ("throughput_ok_50x", "parity_ok_1e3", "north_star", "worst_steps_per_sec"):
        assert got[k] == want[k], k
    assert want.get("free_run", []) == rows
    assert got["throughput_ok_50x"] == (delay_s == 0.0)


def test_north_star_rejects_a_line_that_is_no_literal(tmp_path):
    log = tmp_path / "free.log"
    log.write_text(f"{free_row('demo_1', 1e-4)}\n{NOT_A_LITERAL}\n")
    with pytest.raises(ValueError, match="not a literal row"):
        bench_north_star.free_run_rows(log)
    with pytest.raises(ValueError):
        ast.literal_eval(NOT_A_LITERAL)
    empty = tmp_path / "empty.log"
    empty.write_text("=== demo_1 free-run, native_bal ===\n")
    with pytest.raises(ValueError, match="no free-run rows"):
        bench_north_star.main(["--synthetic", "--device", "cpu", "--free-log", str(empty)])


def test_policy_config_applies_the_free_mode():
    pcfg = bench_north_star.policy_config("demo_3", "native_bal")
    assert pcfg.pipeline_dtype == "float64" and pcfg.traj_tree.exec_resolve_mode == "native"
    assert pcfg.traj_tree.warm.w_des_velocity == 0.5      # demo_3's own weights stay


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_missing_log_raises(tmp_path):
    """Without --synthetic a missing AV2 log raises; nothing falls back to
    a synthetic scene."""
    with pytest.raises(FileNotFoundError):
        run_all_demos.main(["--mode", "episode", "--demos", "1", "--steps", "205",
                            "--data-root", str(tmp_path), "--device", "cpu",
                            "--episode-json", str(tmp_path / "ep.json")])
    with pytest.raises(SystemExit):
        run_all_demos.main(["--device", "cpu"])      # neither --synthetic nor --data-root


@pytest.mark.parametrize("path", ["DEMOS_TPU.md", "outputs/exec_ab.json",
                                  "outputs/north_star.json", "PARITY_TRACES.md",
                                  "outputs/parity/freerun.json"])
def test_a_committed_artifact_is_never_written(path):
    with pytest.raises(ValueError, match="writes only under"):
        scripts.artifact(ROOT / path)


def test_writable_paths(tmp_path, monkeypatch):
    """Outside the repository anything; inside it outputs/torch/ and
    chiprun_out/ only (a stand-in repository under tmp_path)."""
    assert scripts.artifact(tmp_path / "a" / "b.json") == (tmp_path / "a" / "b.json").resolve()
    repo = tmp_path / "repo"
    monkeypatch.setattr(scripts, "ROOT", repo)
    monkeypatch.setattr(scripts, "WRITABLE", (repo / "outputs" / "torch", repo / "chiprun_out"))
    for ok in ("outputs/torch/x.json", "outputs/torch/a/y.md", "chiprun_out/z.log"):
        assert scripts.artifact(repo / ok).parent.is_dir()
    for bad in ("outputs/x.json", "DEMOS_TPU.md", "outputs/torchy/x.json"):
        with pytest.raises(ValueError):
            scripts.artifact(repo / bad)


def test_run_evidence_stops_at_a_failed_probe(monkeypatch):
    ran = []
    monkeypatch.setattr(run_evidence, "probe_once", lambda: False)
    monkeypatch.setattr(run_evidence, "run_step", lambda *a, **kw: ran.append(a) or 0)
    assert run_evidence.main(["--synthetic"]) != 0
    assert ran == []


def test_run_evidence_runs_every_step_and_reports_a_failure(tmp_path, monkeypatch):
    ran = []
    monkeypatch.setattr(run_evidence, "probe_once", lambda: True)
    monkeypatch.setattr(run_evidence, "run_step",
                        lambda cmd, timeout_s, stdout_file=None: ran.append(cmd) or (
                            "timeout" if "bench_strict" in cmd[2] else 0))
    summary = tmp_path / "evidence.json"
    assert run_evidence.main(["--synthetic", "--only", "scale,strict,ab",
                              "--summary", str(summary)]) == 1
    assert [c[2] for c in ran] == [run_evidence.M + n for n in
                                   ("bench_exec_ab", "bench_strict", "bench_scale")]
    assert ran[0][-1] == "--synthetic" and "--synthetic" not in ran[2]
    got = json.loads(summary.read_text())
    assert got["strict"]["returncode"] == "timeout" and got["ab"]["returncode"] == 0


def test_run_evidence_unknown_step_raises():
    with pytest.raises(ValueError, match="unknown steps"):
        run_evidence.main(["--synthetic", "--only", "ab,nope"])


# ---------------------------------------------------------------------------
# the drivers the card's runs leave out, on the small world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_demo_sim(world):
    """A stand-in for scripts.demo_sim: make_sims' port sim of the small
    world alone (the spread weights drawn once), rendered serially."""
    from mind_tpu_torch.config import ClAgentConfig, SimConfig
    from mind_tpu_torch.models.weights import params_from_flax
    from mind_tpu_torch.sim.simulator import Simulator
    from test_torch_data import SEQ_ID
    from test_torch_planner import CL_AGENT, CPU, spread_weights

    jcfg, _ = planner_cfgs(world.n_lanes, "float64", "float64")
    weights = params_from_flax(spread_weights(jcfg)[1])

    def build(opts, demo, root, ticks=None, planner_cfg=None):
        cfg = SimConfig(sim_name="demo_1", seq_id=SEQ_ID, data_root=str(world.root),
                        num_threads=1,
                        cl_agents=[ClAgentConfig(**CL_AGENT, enable_timestep=ENABLE)])
        sim = Simulator(cfg, planner_cfg=planner_cfgs(world.n_lanes, "float64", "float64")[1],
                        max_steps=ticks or HORIZON, device=CPU, scenario=world.syn.scenario)
        sim.init_sim()
        net = ego(sim).planner.net
        net.load_state_dict(weights)
        net.apply_compute_dtype()
        return sim
    return build


def test_render_demo_video_writes_the_avi(small_demo_sim, world, tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    pytest.importorskip("PIL")
    import shutil

    from mind_tpu_torch.scripts import render_demo_video

    monkeypatch.setattr(render_demo_video, "demo_sim", small_demo_sim)
    monkeypatch.setattr(shutil, "which", lambda name: None)    # no ffmpeg: the AVI writer
    out = tmp_path / "v" / "demo_1.avi"
    assert render_demo_video.main(["--max-steps", str(HORIZON), "--figsize", "2",
                                   "--data-root", str(world.root), "--device", "cpu",
                                   "--out", str(out)]) == 0
    from mind_tpu_torch.viz.video import probe_avi

    info = probe_avi(str(out))
    assert info["jpeg_ok"] and info["frames"] >= HORIZON - 1
    assert sorted(p.name for p in out.parent.iterdir()) == ["demo_1.avi"]


def test_render_demo_video_without_matplotlib_raises(small_demo_sim, world, tmp_path,
                                                     monkeypatch):
    """The port draws and encodes frames with numpy, so without matplotlib
    or PIL the script runs and renders; what it still raises on is a .mov,
    which the renderer writes where ffmpeg is installed (here a stand-in
    that writes nothing)."""
    import shutil

    from mind_tpu_torch.scripts import render_demo_video
    from mind_tpu_torch.viz import render

    for name in ("matplotlib", "mpl_toolkits", "PIL"):
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setattr(render_demo_video, "demo_sim", small_demo_sim)
    monkeypatch.setattr(shutil, "which", lambda name: "/usr/bin/" + name)
    ran = []
    monkeypatch.setattr(render.subprocess, "run", lambda cmd, **kw: ran.append(cmd))
    with pytest.raises(RuntimeError, match=r"not an MJPEG \.avi"):
        render_demo_video.main(["--max-steps", "3", "--figsize", "2", "--data-root",
                                str(world.root), "--device", "cpu",
                                "--out", str(tmp_path / "demo_1.avi")])
    assert ran and ran[0][0] == "ffmpeg"


def test_bench_mc_and_unroll_ab_on_the_small_world(small_demo_sim, world, tmp_path,
                                                   monkeypatch):
    """bench_mc (2 copies in chunks of 1, 10 ticks: every copy plans both
    cycles) and bench_unroll_ab (one demo, 20 ticks: one plan, its row added
    to a table already holding another label) write their JAX scripts'
    keys."""
    from mind_tpu_torch.scripts import bench_mc, bench_unroll_ab

    for mod in (bench_mc, bench_unroll_ab):
        monkeypatch.setattr(mod, "demo_sim", small_demo_sim)
    common = ["--data-root", str(world.root), "--device", "cpu"]
    assert bench_mc.main(["--k", "2", "--chunk", "1", "--seg", "1", "--horizon", "10",
                          "--out", str(tmp_path / "mc.json"), *common]) == 0
    mc = json.loads((tmp_path / "mc.json").read_text())
    assert mc["copies"] == 2 and mc["survived"] == 2 and mc["fail_cycles"] == []
    assert mc["total_steps"] == 20 and len(mc["chunk_walls_s"]) == 2
    for k in ("eff_steps_per_s", "compile_wall_s", "cold_first_chunk_s", "warm_steps_per_s"):
        assert mc[k] > 0, k
    table = tmp_path / "ab.json"
    table.write_text(json.dumps({"before": {"demo_1": {"steps_per_s": 1.0}}}))
    assert bench_unroll_ab.main(["after", "demo_1", "--steps", "20", "--out", str(table),
                                 *common]) == 0
    got = json.loads(table.read_text())
    assert list(got) == ["before", "after"]
    assert len(got["after"]["demo_1"]["walls_s"]) == 3 and got["after"]["demo_1"]["steps_per_s"] > 0


def test_bench_scale_on_the_cpu(tmp_path):
    from mind_tpu_torch.scripts import bench_scale

    path = tmp_path / "scale.json"
    assert bench_scale.main(["--trees", "4", "--iters", "2", "--device", "cpu",
                             "--json-out", str(path)]) == 0
    row = json.loads(path.read_text())
    assert row["unit"] == "trees/s" and row["value"] > 0 and row["detail"]["n_trees"] == 4
