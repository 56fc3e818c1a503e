"""The benchmark twin (mind_tpu_torch/bench.py) on the CPU: its final line
against the JAX package's bench.py on the same results; the per-demo and
phase-split sections on the small synthetic AV2 world with the settings of
test_torch_episode.py (the planner on after 0.3 s, the spread weights; a
20-tick horizon and cut solver budgets), held against the port's own
run_episode and MINDPlanner.plan; the network's FLOP count against the
fusion core's own count; and the parent's non-zero exit, with the final
line printed, when a section fails or there is no card.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mind_tpu_torch import bench
from mind_tpu_torch.config import NetConfig as TNetConfig
from mind_tpu_torch.models.weights import params_from_flax
from mind_tpu_torch.ops import fusion_attention as fa
from mind_tpu_torch.sim import episode as tepisode
from mind_tpu_torch.synthetic import demo_scenario, write_synthetic_map
from test_torch_data import small_av2
from test_torch_plan_cycle import SMALL
from test_torch_planner import CPU, planner_cfgs, spread_weights
from test_torch_scene_pred import make_inputs

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
ENABLE = 0.3
HORIZON = 20       # 4 cycles: 0-2 do not plan, 3 plans
# the solver's iteration budgets cut to keep the CPU plans short; both sides
# of every comparison run the same configuration
ITERATIONS = dict(max_iterations=12, warm_max_iterations=6)


@pytest.fixture(scope="module")
def small_world(tmp_path_factory):
    """The small synthetic AV2 world's map under demo_1's and demo_2's
    seq_ids, its scenario, and mind_tpu's spread weights of the small
    network as the port's state dict."""
    from mind_tpu_torch.config import CONFIGS, SimConfig

    root = tmp_path_factory.mktemp("av2")
    syn = small_av2()
    for demo in ("demo_1", "demo_2"):
        write_synthetic_map(syn.map_json, root, SimConfig.from_json(CONFIGS / f"{demo}.json").seq_id)
    jcfg, _ = planner_cfgs(syn.n_graph_segments, "float64", "float64", **ITERATIONS)
    return root, syn, params_from_flax(spread_weights(jcfg)[1])


def small_sim(world, demo):
    """demo_scenario of `demo`'s configuration on the small world: float64
    pipeline and solve (no exec re-solve), the planner on after ENABLE s,
    HORIZON ticks, on the CPU, with the spread weights."""
    root, syn, weights = world
    _, tcfg = planner_cfgs(syn.n_graph_segments, "float64", "float64", **ITERATIONS)
    sim = demo_scenario(demo, None, root, ticks=HORIZON, planner_cfg=tcfg,
                        enable_timestep=ENABLE, device=CPU, scenario=syn.scenario)
    net = bench._av(sim).planner.net
    net.load_state_dict(weights)
    net.apply_compute_dtype()
    return sim


def test_final_line_has_the_jax_benchs_keys_and_values():
    """(a) The twin's _final_json and bench.py's on one results dict: the
    same top-level and detail keys (the twin adds `device` and
    `kernel_launches` to detail), the same headline (the worst demo), its
    vs_baseline and the MFU."""
    spec = importlib.util.spec_from_file_location("jax_bench", ROOT / "bench.py")
    jax_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bench)
    results = {
        "per_demo_episode": {d: {"steps_per_s": s, "vs_baseline": s / (500 / 600),
                                 "wall_s": 500 / s, "plan_calls": 60}
                             for d, s in zip(bench.DEMOS, (21.5, 19.25, 23.0, 20.0))},
        "phase_split": {"aime_program_ms": 40.0, "net_forward_b8_ms": 12.5,
                        "net_flops_per_fwd": 1.17e11, "net_mfu_bf16_peak": 0.0094},
        "batched_episode": {"agg_steps_per_s": 64.0},
    }
    want = jax_bench._final_json(results, {})
    run = {"device": {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0},
           "ticks": 500, "scenes": "synthetic_av2 seeds 0-3",
           "launches": {"per_demo_episode": {"float32": 0, "bfloat16": 1440}}}
    got = bench._final_json(results, {}, run)
    assert set(got) == set(want)
    assert set(got["detail"]) == set(want["detail"]) | {"device", "kernel_launches"}
    for k in ("value", "vs_baseline", "unit"):
        assert got[k] == want[k], k
    assert got["value"] == 19.25
    assert got["detail"]["mfu"] == want["detail"]["mfu"] == 0.0094
    assert got["detail"]["net_flops_per_fwd_b8"] == want["detail"]["net_flops_per_fwd_b8"]
    for k in ("per_demo_episode", "batched_episode", "phase_mean_ms"):
        assert got["detail"][k] == want["detail"][k], k
    assert got["detail"]["device"] == run["device"]
    assert got["detail"]["kernel_launches"] == run["launches"]
    assert "NVIDIA H100 80GB HBM3" in got["metric"] and "500 steps" in got["metric"]
    # a section left out of the request is marked so, not as skipped
    part = bench._final_json({}, {}, dict(run, sections=["per_demo_episode"]))
    assert part["detail"]["monte_carlo_episode"] == {"error": "not_requested"}
    assert part["detail"]["per_demo_episode"] == {"error": "missing"}
    assert part["value"] == 0.0


def test_per_demo_section_matches_run_episode(small_world, monkeypatch):
    """(b) section_per_demo on two small sims: one warm run of each, then
    one timed run per demo; each timed run's ego trajectory equal to the bit
    to the warm run of the same sim, and the same plan count; no graph
    captures (there are none off the card)."""
    sims = {d: small_sim(small_world, d) for d in ("demo_1", "demo_2")}
    runs = []
    run_episode = tepisode.run_episode

    def recorded(*a, **kw):
        runs.append(run_episode(*a, **kw))
        return runs[-1]

    monkeypatch.setattr(tepisode, "run_episode", recorded)
    out = bench.section_per_demo(sims)
    monkeypatch.undo()
    assert list(out) == ["demo_1", "demo_2"] and len(runs) == 4
    for (demo, sim), got, want in zip(sims.items(), runs[2:], runs[:2]):
        assert want.fail_cycle == -1
        assert out[demo]["plan_calls"] == got.plan_calls == want.plan_calls == 1
        np.testing.assert_array_equal(got.ego_states, want.ego_states)
        row = out[demo]
        assert row["steps_per_s"] == pytest.approx(HORIZON / row["wall_s"])
        assert row["vs_baseline"] == pytest.approx(row["steps_per_s"] / bench.BASELINE_STEPS_PER_SEC)
        assert row["graph_captures_warm"] == row["graph_captures"] == 0


class _Result:
    def __init__(self, sim):
        self.ego_states, self.plan_calls, self.fail_cycle = [0] * 3, 1, -1


@pytest.mark.parametrize("n_demos", [1, 4])
def test_twin_warms_every_demo_it_times(monkeypatch, n_demos):
    """With a counting stub of run_episode: section_per_demo and
    bench_unroll_ab.label_row run every demo once untimed before any timed
    run, and each row counts the graph captures of its own warm and timed
    runs (a stub capture per run of a demo not seen before)."""
    from mind_tpu_torch.planner import ilqr
    from mind_tpu_torch.scripts import bench_unroll_ab

    calls, timed = [], []
    graphs = {}

    def run_episode(sim, steps=None, inputs=None):
        calls.append((sim, inputs is not None))
        graphs.setdefault(("shape", sim), object())    # a demo's first run captures
        return _Result(sim)

    monkeypatch.setattr(tepisode, "run_episode", run_episode)
    monkeypatch.setattr(tepisode, "build_episode_inputs", lambda sim, steps=None: "inputs")
    monkeypatch.setattr(ilqr._GRAPHS, "graphs", graphs)
    sims = {f"demo_{k + 1}": f"sim_{k}" for k in range(n_demos)}
    for section in (bench.section_per_demo, bench_unroll_ab.label_row):
        calls.clear()
        graphs.clear()
        out = section(sims)
        first_timed = [c[1] for c in calls].index(True)
        assert [c[0] for c in calls[:first_timed]] == list(sims.values())     # all warmed
        assert all(c[1] for c in calls[first_timed:])
        assert {c[0] for c in calls[first_timed:]} == set(sims.values())
        assert all(out[d]["graph_captures_warm"] == 1 and out[d]["graph_captures"] == 0
                   for d in sims), out
        timed.append(len(calls) - first_timed)
    assert timed == [n_demos, n_demos * bench_unroll_ab.TIMED_RUNS]


def test_phase_split_selects_what_plan_selects(small_world, monkeypatch):
    """(c) section_phase_split on a small sim (float64 pipeline and solve;
    one timed run of each phase, where the card's run takes the median of
    5): the warm-then-full micro-solves select the tree MINDPlanner.plan
    selects on the same state, with the same control to 1e-9; every time
    is finite and positive, and there is no MFU on the CPU."""
    monkeypatch.setattr(bench, "TIMED_RUNS", 1)
    sim = small_sim(small_world, "demo_1")
    out = bench.section_phase_split(sim)
    pl = bench._av(sim).planner
    ok, ctrl, _ = pl.plan()
    assert ok and out["trees"] == pl.last_n_trees >= 1
    assert out["selected_tree"] == pl.last_best
    np.testing.assert_allclose(out["selected_ctrl"], ctrl, rtol=0, atol=1e-9)
    for k in ("aime_program_ms", "topology_host_ms", "warm_solve_ms", "full_solve_ms",
              "selection_ms", "staged_solve_program_ms", "net_forward_b8_ms"):
        assert np.isfinite(out[k]) and out[k] > 0, k
    assert out["net_flops_per_fwd"] > 0 and out["net_mfu_bf16_peak"] is None


def test_phase_split_times_the_planners_programs(small_world, monkeypatch):
    """(c') With the plan's programs in use (forced here: on the CPU a
    program runs its body eagerly on its buffers, where the card replays
    its graph): the section's host loop and bench_phases run the planner's
    AIME and staged solve programs, graph_captures counts them, and the
    micro-solves still select what plan selects."""
    from mind_tpu_torch.planner import programs

    monkeypatch.setattr(bench, "TIMED_RUNS", 1)
    monkeypatch.setattr(programs, "compiled", lambda *a, **kw: True)
    sim = small_sim(small_world, "demo_1")
    pl = bench._av(sim).planner
    before, ran = bench.graph_captures(), set(programs.programs())
    out = bench.section_phase_split(sim)
    new = [p for p in programs.programs() if p not in ran]
    assert sorted(p.kind for p in new) == ["aime", "solve"]
    assert all(p in pl.program_set().programs.values() for p in new)
    assert bench.graph_captures() == before + 2
    ok, ctrl, _ = pl.plan()
    assert ok and out["selected_tree"] == pl.last_best
    np.testing.assert_allclose(out["selected_ctrl"], ctrl, rtol=0, atol=1e-9)
    assert out["aime_program_ms"] > 0 and out["staged_solve_program_ms"] > 0


@pytest.mark.parametrize("update_edge", [True, False])
def test_flop_count_of_the_fusion_core(update_edge):
    """(d) FlopCounterMode's count of one plain fusion-core call against
    fused_edge_attention_flops(variant="unfolded"): its docstring leaves out
    only LayerNorm and softmax, which the counter does not count either (it
    counts matrix products), so the two are equal, with no tolerance."""
    from torch.utils.flop_counter import FlopCounterMode

    B, N, D, H = 3, 10, 32, 4
    g = torch.Generator().manual_seed(0)
    w = fa.FusionWeights(*(torch.randn((D, D) if f.startswith("w") else (D,), generator=g)
                           for f in fa.FusionWeights._fields))
    node, edge = torch.randn(B, N, D, generator=g), torch.randn(B, N, N, D, generator=g)
    with FlopCounterMode(display=False) as counter:
        fa.fused_edge_attention_ref(node, edge, torch.ones(B, N, dtype=torch.bool), w, H,
                                    update_edge)
    assert counter.get_total_flops() == fa.fused_edge_attention_flops(B, N, D, update_edge,
                                                                      "unfolded", H)


def test_network_flops_are_linear_in_the_batch():
    """(d) The whole forward's count at B = 1, 2, 3 nodes is exactly B times
    one node's: every counted product is per node."""
    cfg = TNetConfig(**SMALL)
    rng = np.random.default_rng(0)
    counts = [bench.network_flops(cfg, [torch.from_numpy(x) for x in make_inputs(rng, B, 8, 24,
                                                                                 cfg)])
              for B in (1, 2, 3)]
    assert counts[0] > 0 and counts == [counts[0], 2 * counts[0], 3 * counts[0]]
    # the compute dtype does not enter the count
    inputs = [torch.from_numpy(x) for x in make_inputs(rng, 1, 8, 24, cfg)]
    assert bench.network_flops(TNetConfig(**SMALL, compute_dtype="bfloat16"), inputs) == counts[0]


def run_bench(*args, timeout=300):
    env = dict(os.environ, MIND_TPU_BENCH_BUDGET_S="240")
    return subprocess.run([sys.executable, "-m", "mind_tpu_torch.bench", *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=timeout)


def test_failed_section_prints_the_final_line_and_exits_nonzero(tmp_path):
    """(e) The AV2 logs are missing (an empty --data-root): the section
    raises in the child, the final line is still printed with its error, and
    the exit code is non-zero."""
    p = run_bench("--device", "cpu", "--data-root", str(tmp_path), "--sections",
                  "per_demo_episode")
    assert p.returncode != 0, p.stderr[-3000:]
    final = json.loads(p.stdout.strip().splitlines()[-1])
    err = final["detail"]["per_demo_episode"]["error"]
    assert "FileNotFoundError" in err, err
    assert final["value"] == 0.0 and final["detail"]["device"] == {"name": "cpu",
                                                                   "power_limit_w": None}
    assert final["detail"]["phase_mean_ms"] == {"error": "not_requested"}
    acc = final["detail"]["window_accounting"]
    assert acc["child_returncode"] == 0 and "per_demo_episode" in acc["sections"]


def test_no_card_prints_the_final_line_and_exits_nonzero():
    """Without --device cpu nothing runs on the CPU: where the probe finds
    no card, the final line names the failure and the exit is non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the probe passes")
    p = run_bench("--synthetic", "--sections", "phase_split")
    assert p.returncode != 0
    final = json.loads(p.stdout.strip().splitlines()[-1])
    assert "health probe failed" in final["detail"]["phase_mean_ms"]["error"]
    assert "sections" not in final["detail"]["window_accounting"]   # no child ran


def test_arguments_are_checked(capsys):
    for args, msg in ((["--steps", "12", "--synthetic"], "multiple of 5"),
                      (["--sections", "per_demo", "--synthetic"], "unknown sections"),
                      ([], "--data-root DIR")):
        with pytest.raises(SystemExit):
            bench._parse(args)
        assert msg in capsys.readouterr().err
    opts = bench._parse(["--synthetic", "--sections", "host_loop_demo_1,per_demo_episode"])
    assert opts.sections == ["per_demo_episode", "host_loop_demo_1"]   # SECTION_ORDER


def test_device_info_reads_nvidia_smi(monkeypatch):
    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **kw: Done())
    assert bench.device_info() == {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0}
    assert bench.device_info("cpu") == {"name": "cpu", "power_limit_w": None}

    def missing(*a, **kw):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(bench.subprocess, "run", missing)
    assert bench.device_info() == {"name": None, "power_limit_w": None}
