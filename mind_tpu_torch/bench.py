"""Benchmark of the PyTorch port: closed-loop simulation throughput on one
CUDA card, all four demos (the counterpart of the JAX package's bench.py,
with its sections, result fields, tagged section lines and final line).

    python -m mind_tpu_torch.bench --synthetic          # synthetic scenes
    python -m mind_tpu_torch.bench --data-root DIR      # the AV2 demo logs
    python -m mind_tpu_torch.bench --synthetic --steps 250 \\
        --sections per_demo_episode,phase_split
    python -m mind_tpu_torch.bench --synthetic --section phase_split [--out PATH]

Prints ONE final JSON line {"metric", "value", "unit", "vs_baseline",
"detail"}. Baseline: the reference's ~10-minute CPU wall clock for one
500-step demo rollout => 500/600 ~= 0.833 steps/s; vs_baseline is steps/s
over that. The headline value is the MIN over the four demos of the episode
runner's steps/s (sim/episode.py::run_episode).

Sections, in SECTION_ORDER:
- per_demo_episode: run_episode per demo on a warm runner (one untimed
  run of every demo first: kernel builds, each demo's CUDA graph captures,
  allocator), the graph captures of each warm and timed run counted;
- phase_split: one plan cycle of demo_1 split into phases after a 12-tick
  host loop (AIME, host cost topology, warm-only and full-only tree solves,
  selection, the staged solve, the network forward at B =
  max_branch_nodes), each the median of 5 host-clock runs ended by
  torch.cuda.synchronize() after one warm call, and the network's MFU: the
  FLOPs of one forward, counted by FlopCounterMode on the plain path of a
  CPU copy of the network (matrix products and convolutions only; the
  kernels behind ctypes are invisible to it, as XLA's count cannot see
  inside a Pallas kernel), over the forward's time and the card's dense
  bf16 peak (utils/device_specs.py);
- monte_carlo_episode: run_episode_monte_carlo, 64 perturbed egos on
  demo_1 in chunks of 4, after a 4-copy warm run, bounded by a deadline
  that leaves the later sections their time;
- batched_episode: run_episodes_batched over the four demos, warm then
  timed;
- host_loop_demo_1: the Simulator loop on demo_1, warmed by 12 ticks and
  rewound through sim/state_io.py.

--synthetic runs synthetic_av2 seeds 0-3 in place of demo_1..4's logs, each
under its demo's sim and planner configuration (synthetic.py::
demo_scenario); without it the demos' AV2 folders are read under
--data-root, and a missing one is a section error. --steps cuts the
500-tick horizon. --device cpu runs on the CPU (tests); nothing runs there
otherwise.

All sections run in ONE child process (python -m mind_tpu_torch.bench
--child ...), which streams one RESULT_TAG line per section with its wall
time and its fusion-kernel launches by variant. The parent never
initializes CUDA: it probes the card once in a subprocess
(utils/device_health.py) while the child starts (a failed probe stops the
child), reads its name and power limit from nvidia-smi,
and kills the child at the global budget (MIND_TPU_BENCH_BUDGET_S, 22 min).
The final line is ALWAYS printed. Unlike the JAX bench, nothing hides a
failure: a section that raises, is skipped for the budget or never ran, a
failed probe, or a child that dies makes the exit code non-zero; and a dead
card is not waited for or retried.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BASELINE_STEPS_PER_SEC = 500.0 / 600.0
DEMOS = ["demo_1", "demo_2", "demo_3", "demo_4"]

BUDGET_S = float(os.environ.get("MIND_TPU_BENCH_BUDGET_S", 22 * 60))
T_START = time.time()
DEADLINE = T_START + BUDGET_S

# least remaining seconds a section needs to be worth starting: ~1.5x its
# wall on an H100 80GB HBM3 at 500 ticks (PERF.md section 5: 83, 15, 48 and
# 15 s; the Monte-Carlo sweep's warm run and first chunk took ~71 s); below it
# the child marks the section skipped_deadline
MIN_NEED_S = {
    "per_demo_episode": 130,
    "phase_split": 30,
    "monte_carlo_episode": 100,
    "batched_episode": 75,
    "host_loop_demo_1": 30,
}
# headline first; then the phase split (MFU), the Monte-Carlo sweep (which
# takes what the budget leaves), the batched episode and the host loop
SECTION_ORDER = ["per_demo_episode", "phase_split", "monte_carlo_episode",
                 "batched_episode", "host_loop_demo_1"]
# the Monte-Carlo sweep stops issuing chunks this long before the later
# sections' time: a chunk started just before its deadline runs to its end
MC_CHUNK_RESERVE_S = 60
TIMED_RUNS = 5

RESULT_TAG = "@@BENCH_SECTION@@ "
ROOT = Path(__file__).resolve().parent.parent


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def _progress(name, payload):
    """Per-section progress on stderr (stdout carries the protocol lines)."""
    print(f"[bench +{time.time() - T_START:.0f}s] {name}: {json.dumps(payload)}",
          file=sys.stderr, flush=True)


def _synchronize(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_dev(fn, device):
    """bench.py's timed_dev: the median of TIMED_RUNS host-clock runs of
    fn(), each ended by a device synchronize, after one warm call."""
    fn()
    _synchronize(device)
    ts = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        fn()
        _synchronize(device)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def _av(sim):
    return next(a for a in sim.agents if a.id == "AV")


# ---------------------------------------------------------------------------
# the network: forward time, FLOPs, MFU
# ---------------------------------------------------------------------------

def network_flops(net_cfg, inputs) -> int:
    """FLOPs of one ScenePredNet forward on `inputs`, counted by
    FlopCounterMode on the plain path of the network at `net_cfg`'s widths
    in float32, built on the meta device: the count follows the shapes alone
    (it does not depend on the weights, the values or the compute dtype), so
    no arithmetic is done. It counts matrix products (mm, bmm, addmm, and the
    einsums that lower to them) and convolutions; LayerNorm, softmax, the
    elementwise work and the broadcast products of common/batch_invariant.py
    are left out."""
    import dataclasses

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from mind_tpu_torch.models import scene_pred
    from mind_tpu_torch.ops import fusion_attention as fa

    meta = torch.device("meta")
    with meta:
        net = scene_pred.ScenePredNet(dataclasses.replace(net_cfg, compute_dtype="float32"))
    scene_pred.fused_edge_attention = fa.fused_edge_attention_ref   # the plain path
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            net.eval()(*(x.to(meta) for x in inputs))
    finally:
        scene_pred.fused_edge_attention = fa.fused_edge_attention
    return int(counter.get_total_flops())


def bench_network(pl, inputs):
    """The planner's network on one AIME round's inputs (B =
    max_branch_nodes nodes), as AIME calls it: forward ms, FLOPs per forward
    and MFU against the card's dense bf16 peak (None on the CPU)."""
    import torch

    from mind_tpu_torch.common import batch_invariant
    from mind_tpu_torch.utils import device_specs

    def forward():
        with torch.no_grad(), batch_invariant.scenes(1):
            return pl.net(*inputs)

    t_net = _timed_dev(forward, pl.device)
    flops = network_flops(pl.cfg.net, inputs)
    mfu = None
    if pl.device.type == "cuda":
        peak = device_specs.peaks(torch.cuda.get_device_name(pl.device)).bf16_flops
        mfu = flops / t_net / peak
    return {"net_forward_b8_ms": t_net * 1e3, "net_flops_per_fwd": flops,
            "net_mfu_bf16_peak": mfu}


def bench_phases(pl):
    """One plan cycle's split on the planner's current state (the staged
    path's AIME and solve programs, as MINDPlanner.plan runs them: compiled
    on the card, eager on the CPU; and the host topology), with the
    warm-only and full-only tree solves and the selection timed apart; run
    under no_grad, as MINDPlanner.plan runs. Returns the times, the tree
    the micro-solves select and its control, and the network's inputs of
    the first AIME round."""
    import numpy as np
    import torch

    from mind_tpu_torch.ops.potential import select_trees
    from mind_tpu_torch.planner import programs
    from mind_tpu_torch.planner.ilqr import ilqr_solve
    from mind_tpu_torch.planner.planner import (MAX_TREES, AimeInputs, SolveInputs, _host_parts,
                                                pack_trees, split_trees)
    from mind_tpu_torch.planner.trajectory_tree import (_cast, build_cost_indices,
                                                        evaluate_traj_tree, gather_cost_nodes,
                                                        torch_dtype)

    cfg, dev = pl.cfg, pl.device
    MN = cfg.scen_tree.max_tree_nodes
    compiled = programs.compiled(dev, pl.graphed)
    buf = pl.obs_buffer
    warm_s, full_s, tgt = pl._statics()
    aime_in = AimeInputs(buf.buf, buf.types_device(), buf.mask_device(buf.actor_mask()),
                         pl.lane_static, tgt)
    # the network's inputs of the first round, from one eager AIME (a
    # replay calls no Python)
    inputs = []
    hook = pl.net.register_forward_pre_hook(lambda m, a: inputs.append(a) if not inputs else None)
    try:
        pl._run("aime", aime_in, False)
    finally:
        hook.remove()
    t_aime = _timed_dev(lambda: pl._run("aime", aime_in, compiled), dev)
    (slots, norm_prob, packed), aime = pl._run("aime", aime_in, compiled)
    packed = packed.cpu().numpy()

    t0 = time.perf_counter()
    trees = build_cost_indices(packed[0:MN].astype(np.int64), packed[MN:2 * MN].astype(np.int64),
                               packed[2 * MN:3 * MN] > 0.5, packed[3 * MN:4 * MN].astype(np.int64),
                               cfg.traj_tree)
    t_topo = time.perf_counter() - t0
    trees = trees[:MAX_TREES]
    n_real = len(trees)
    flat = torch.from_numpy(pack_trees(trees + [trees[0]] * (MAX_TREES - n_real), n_real))
    host = pl._host_vector(pl.local_state())
    amask = aime.inputs.amask if aime is not None else aime_in.amask
    solve_in = SolveInputs(slots, norm_prob, amask, flat, host, warm_s, full_s, pl._eval_segs,
                           pl._scene)
    keep = (*slots, norm_prob, amask) if compiled else ()
    t_solve = _timed_dev(lambda: pl._run("solve", solve_in, compiled, keep=keep), dev)

    dct = split_trees(flat.to(dev), cfg.traj_tree)
    x0, offset, tv = _host_parts(host.to(dev))
    warm_p, full_p = warm_s._replace(field_offset=offset), full_s._replace(field_offset=offset)
    amasks, scene = amask[None], pl._scene
    segs = tuple(x[None].index_select(0, scene) for x in pl._eval_segs)
    # the solver's two phases alone, over the same padded tree batch, in the
    # solve dtype (two_phase_solve's casts)
    sd = torch_dtype(pl.ilqr_cfg.dtype)
    topo = dct.topo
    nodes = gather_cost_nodes(slots, norm_prob, dct.cost_slot, dct.cost_step,
                              topo.node_mask, amasks, scene, dtype=sd)
    x0_t = x0[None].index_select(0, scene)
    wp = _cast(select_trees(warm_p, scene), sd)
    fp = _cast(select_trees(full_p, scene), sd)
    x0_s = x0_t.to(sd)
    us0 = torch.zeros((MAX_TREES, topo.parent.shape[1], 2), dtype=sd, device=dev)
    warm = lambda: ilqr_solve(topo, x0_s, us0, nodes, wp, pl.warm_ilqr_cfg, dct.tree_mask)
    t_warm = _timed_dev(warm, dev)
    us_warm = warm()[1]
    full = lambda: ilqr_solve(topo, x0_s, us_warm, nodes, fp, pl.ilqr_cfg, dct.tree_mask)
    t_full = _timed_dev(full, dev)
    xs, us, _ = full()

    def select():
        cost = evaluate_traj_tree(xs, us, topo.node_mask, topo.node_mask.sum(-1), x0_t, *segs,
                                  tv, pl._weights)
        return torch.argmin(torch.where(dct.tree_mask, cost, torch.full_like(cost, float("inf"))))

    t_sel = _timed_dev(select, dev)
    best = int(select())
    return {
        "aime_program_ms": t_aime * 1e3,
        "topology_host_ms": t_topo * 1e3,
        "warm_solve_ms": t_warm * 1e3,
        "full_solve_ms": t_full * 1e3,
        "selection_ms": t_sel * 1e3,
        "staged_solve_program_ms": t_solve * 1e3,
        "trees": n_real,
        "selected_tree": best,
        # the executed control as solve_and_select returns it
        "selected_ctrl": xs[best, 0, 4:6].to(torch.float32).tolist(),
    }, inputs[0]


# ---------------------------------------------------------------------------
# sections: each takes prebuilt, initialized Simulators
# ---------------------------------------------------------------------------

def graph_captures() -> int:
    """CUDA graphs captured in this process so far: the tree iLQR's
    (planner/ilqr.py), the episode programs' (sim/episode.py) and the
    planner's programs (planner/programs.py); none off the card."""
    from mind_tpu_torch.planner import ilqr, programs
    from mind_tpu_torch.sim import episode

    return len(ilqr._GRAPHS.graphs) + len(episode.programs()) + len(programs.programs())


def section_per_demo(sims):
    """The episode runner, per demo ({demo: sim}): one untimed run of every
    demo warms the runner (kernel builds, and the CUDA graph captures that
    each demo's own tree shapes need); each demo is then timed on one run.
    Each row counts the graph captures of its warm run and of its timed run
    (0 once warm). A failed plan raises."""
    from mind_tpu_torch.sim.episode import build_episode_inputs, run_episode

    per_demo = {}
    warm_captures = {}
    for demo, sim in sims.items():
        before = graph_captures()
        run_episode(sim)
        warm_captures[demo] = graph_captures() - before
    for demo, sim in sims.items():
        inp = build_episode_inputs(sim)
        before = graph_captures()
        res, wall = _timed(run_episode, sim, None, inp)
        if res.fail_cycle != -1:
            raise RuntimeError(f"{demo}: plan failure at cycle {res.fail_cycle}")
        sps = len(res.ego_states) / wall
        per_demo[demo] = {"steps_per_s": sps, "vs_baseline": sps / BASELINE_STEPS_PER_SEC,
                          "wall_s": wall, "plan_calls": res.plan_calls,
                          "fail_cycle": res.fail_cycle,
                          "graph_captures_warm": warm_captures[demo],
                          "graph_captures": graph_captures() - before}
        _progress(f"episode/{demo}", per_demo[demo])
    return per_demo


def section_batched(sims):
    """All demos' episodes as one batch (run_episodes_batched): a warm call,
    then the timed one."""
    from mind_tpu_torch.sim.episode import run_episodes_batched

    run_episodes_batched(sims)
    results, wall = _timed(run_episodes_batched, sims)
    total = sum(len(r.ego_states) for r in results)
    return {"scenarios": len(sims), "agg_steps_per_s": total / wall,
            "vs_baseline": total / wall / BASELINE_STEPS_PER_SEC, "wall_s": wall,
            "fail_cycles": [r.fail_cycle for r in results]}


def section_mc(sim, section_deadline=None):
    """64 perturbed-ego copies of one demo in chunks of 4, after a 4-copy
    warm run; no chunk starts past `section_deadline` (epoch seconds). The
    first chunk's wall is reported apart (cold) from the steady chunks'
    rate (warm)."""
    from mind_tpu_torch.sim.episode import run_episode_monte_carlo

    run_episode_monte_carlo(sim, 4)
    walls = []
    mc, wall = _timed(lambda: run_episode_monte_carlo(sim, 64, deadline=section_deadline,
                                                      chunk_walls=walls))
    total = sum(len(r.ego_states) for r in mc)
    out = {"copies": len(mc), "copies_requested": 64, "eff_steps_per_s": total / wall,
           "vs_baseline": total / wall / BASELINE_STEPS_PER_SEC, "wall_s": wall,
           "survived": sum(1 for r in mc if r.fail_cycle < 0),
           "chunk_walls_s": [w for _, _, w in walls]}
    if len(walls) > 1:
        warm_wall = sum(w for _, _, w in walls[1:])
        warm_steps = sum(len(r.ego_states) for r in mc[walls[0][1]:])
        out.update(warm_steps_per_s=warm_steps / warm_wall,
                   warm_vs_baseline=warm_steps / warm_wall / BASELINE_STEPS_PER_SEC,
                   cold_first_chunk_s=walls[0][2], warm_copies=walls[-1][1] - walls[0][1])
    return out


def _warm_host_loop(sim, av):
    """Warm the planner by a 12-tick run with it on from tick 0, then
    rewind the sim to its start (state_io) with a fresh observation window,
    timer and counters."""
    from mind_tpu_torch.planner.planner import ObsBuffer
    from mind_tpu_torch.sim.state_io import load_sim_state, save_sim_state

    enable, horizon = av.enable_timestep, sim.sim_horizon
    with tempfile.TemporaryDirectory() as d:
        snap = os.path.join(d, "t0.npz")
        save_sim_state(sim, snap)
        av.set_enable_timestep(0.0)
        sim.sim_horizon = 12
        sim.run_sim()
        load_sim_state(sim, snap)
    av.set_enable_timestep(enable)
    av.is_enable = False
    av.last_pl_tri = None
    pl = av.planner
    pl.obs_buffer = ObsBuffer(pl.cfg.max_actors, origin=pl.origin, dtype=pl.cfg.pipeline_dtype,
                              device=pl.device)
    pl.metrics.timer.reset()
    pl.metrics.counters.clear()
    sim.sim_horizon = horizon
    sim.metrics.update(plan_calls=0, plan_time_s=0.0)


def section_host_loop(sim):
    """The Simulator loop on one demo (fused plans, no exported trees),
    after _warm_host_loop; the planner's mean phase times."""
    av = _av(sim)
    av.planner.export_trees = False
    _warm_host_loop(sim, av)
    metrics, wall = _timed(sim.run_sim)
    return {"steps_per_s": metrics["ticks"] / wall,
            "vs_baseline": metrics["ticks"] / wall / BASELINE_STEPS_PER_SEC,
            "wall_s": wall, "plan_calls": metrics["plan_calls"],
            "phase_mean_ms": {k: v["mean_ms"]
                              for k, v in av.planner.metrics.timer.summary().items()}}


def section_phase_split(sim):
    """The phase split and the network's MFU on one demo's planner, after a
    12-tick host loop with the planner on from tick 0 (exported trees, the
    staged path), so that the planner holds a real plan state."""
    import torch

    av = _av(sim)
    av.planner.export_trees = True
    av.set_enable_timestep(0.0)
    sim.sim_horizon = 12
    sim.run_sim()
    with torch.no_grad():
        phases, inputs = bench_phases(av.planner)
        phases.update(bench_network(av.planner, inputs))
    return phases


# ---------------------------------------------------------------------------
# the child: sections in one process, on shared scenes
# ---------------------------------------------------------------------------

class Scenes:
    """The demos' Simulators of one run: built once and shared by the
    sections that leave them as they are; `fresh` builds new ones for the
    sections that change them (host loop, phase split). Synthetic maps go
    under `data_root`."""

    def __init__(self, data_root, synthetic: bool, steps=None, device=None):
        self.data_root, self.synthetic = data_root, synthetic
        self.steps, self.device = steps, device
        self.cache = {}

    def sims(self, demos, fresh=False) -> dict:
        from mind_tpu_torch.synthetic import demo_scenario

        out = {}
        for demo in demos:
            if fresh or demo not in self.cache:
                seed = DEMOS.index(demo) if self.synthetic else None
                sim = demo_scenario(demo, seed, self.data_root, ticks=self.steps,
                                    device=self.device)
                if fresh:
                    out[demo] = sim
                    continue
                self.cache[demo] = sim
            out[demo] = self.cache[demo]
        return out


def _run_section(name, scenes, section_deadline=None):
    if name == "per_demo_episode":
        return section_per_demo(scenes.sims(DEMOS))
    if name == "batched_episode":
        return section_batched(list(scenes.sims(DEMOS).values()))
    if name == "monte_carlo_episode":
        return section_mc(scenes.sims(DEMOS[:1])["demo_1"], section_deadline)
    if name == "host_loop_demo_1":
        return section_host_loop(scenes.sims(DEMOS[:1], fresh=True)["demo_1"])
    if name == "phase_split":
        return section_phase_split(scenes.sims(DEMOS[:1], fresh=True)["demo_1"])
    raise ValueError(f"unknown section {name!r}: one of {SECTION_ORDER}")


def _emit(record):
    print(RESULT_TAG + json.dumps(record), flush=True)


def _run_child(sections, deadline, opts):
    """Child mode: `sections` in order in this process, one tagged line per
    section as it finishes (its result, wall time and kernel launches by
    variant). A section that would not fit before `deadline` is marked
    skipped; one that raises is recorded and the next one runs."""
    t0 = time.time()
    import torch

    from mind_tpu_torch.common.device import resolve_device
    from mind_tpu_torch.ops import fusion_attention as fa

    device = resolve_device(opts.device)
    init = {"torch_import_s": time.time() - t0}
    if device.type == "cuda":
        torch.zeros(1, device=device)
        init["cuda_init_s"] = time.time() - t0 - init["torch_import_s"]
        t1 = time.time()
        fa.build_kernels()
        init["kernel_build_s"] = time.time() - t1
    _emit({"section": "_child_init", "result": init})
    with tempfile.TemporaryDirectory() as tmp:
        scenes = Scenes(tmp if opts.synthetic else opts.data_root, opts.synthetic, opts.steps,
                        device)
        for i, name in enumerate(sections):
            remaining = deadline - time.time()
            if remaining < MIN_NEED_S[name]:
                _emit({"section": name, "result": {"error": "skipped_deadline",
                                                   "remaining_s": remaining}})
                continue
            later = sum(MIN_NEED_S[s] for s in sections[i + 1:])
            t_sec = time.time()
            fa.reset_launch_counts()
            try:
                out = _run_section(name, scenes, deadline - later - MC_CHUNK_RESERVE_S)
            except Exception as e:  # keep later sections alive; the parent exits non-zero
                import traceback

                traceback.print_exc()
                out = {"error": f"{type(e).__name__}: {e}"}
            _emit({"section": name, "result": out, "elapsed_s": time.time() - t_sec,
                   "launches": dict(fa.fused_edge_attention.launches_by_variant)})
            _progress(name, out)


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

def _child_args(opts):
    args = ["--steps", str(opts.steps)] if opts.steps else []
    if opts.synthetic:
        args.append("--synthetic")
    if opts.data_root:
        args += ["--data-root", os.path.abspath(opts.data_root)]
    if opts.device:
        args += ["--device", opts.device]
    return args


def _spawn_child(sections, deadline, opts):
    cmd = [sys.executable, "-m", "mind_tpu_torch.bench", "--child",
           "--sections", ",".join(sections), "--deadline", str(deadline), *_child_args(opts)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, cwd=ROOT)


def _drain_child(proc, results, accounting=None, launches=None):
    """Stream the child's stdout into `results` (and each section's kernel
    launches into `launches`) until it exits or the global deadline passes
    (then kill it). Returns True if the child exited cleanly. `accounting`,
    if given, records each section's arrival offset and child-side wall
    time (the window_accounting detail block)."""
    import selectors

    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    while True:
        timeout = DEADLINE - time.time()
        if timeout <= 0:
            proc.kill()
            proc.wait()
            return False
        events = sel.select(timeout=min(timeout, 10.0))
        if events:
            line = proc.stdout.readline()
            if line == "":  # EOF: the child exited
                proc.wait()
                return proc.returncode == 0
            if line.startswith(RESULT_TAG):
                rec = json.loads(line[len(RESULT_TAG):])
                if accounting is not None:
                    acc = {"done_at_s": time.time() - T_START}
                    if "elapsed_s" in rec:
                        acc["elapsed_s"] = rec["elapsed_s"]
                    if rec["section"] == "_child_init":
                        acc.update(rec["result"])
                    accounting.setdefault("sections", {})[rec["section"]] = acc
                if rec["section"] != "_child_init":
                    results[rec["section"]] = rec["result"]
                    if launches is not None and "launches" in rec:
                        launches[rec["section"]] = rec["launches"]
        elif proc.poll() is not None:
            return proc.returncode == 0


def device_info(device=None) -> dict:
    """{name, power_limit_w} of the card from nvidia-smi (it does not
    initialize CUDA in this process); the CPU where `device` names it, and
    None for either number nvidia-smi cannot give."""
    if device is not None and device.startswith("cpu"):
        return {"name": "cpu", "power_limit_w": None}
    try:
        line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"name": None, "power_limit_w": None}
    name, _, power = line.rpartition(",")
    try:
        watts = float(power.strip().split()[0])
    except (ValueError, IndexError):
        watts = None
    return {"name": name.strip(), "power_limit_w": watts}


def _final_json(results, accounting=None, run=None):
    """bench.py's final line from the sections' results, with `run`'s card
    ({name, power_limit_w}), scenes, ticks and kernel launches by section;
    a section left out of `run`'s request is marked so."""
    run = run or {}
    requested = run.get("sections", SECTION_ORDER)

    def section(name, missing):
        if name in results:
            return results[name]
        return {"error": missing if name in requested else "not_requested"}

    per_demo = section("per_demo_episode", "missing")
    phases = section("phase_split", "missing")
    demo_rows = {k: v for k, v in per_demo.items() if k in DEMOS}
    if demo_rows:
        worst = min(demo_rows.values(), key=lambda d: d["steps_per_s"])
    else:
        worst = {"steps_per_s": 0.0, "vs_baseline": 0.0}
    device = run.get("device", {"name": None, "power_limit_w": None})
    return {
        "metric": f"four-demo closed-loop sim throughput, worst demo ({run.get('ticks', 500)} "
                  f"steps each, {device['name']}, {run.get('scenes', 'AV2 demo logs')}, "
                  "episode runner)",
        "value": worst["steps_per_s"],
        "unit": "steps/s",
        "vs_baseline": worst["vs_baseline"],
        "detail": {
            "per_demo_episode": per_demo,
            "batched_episode": section("batched_episode", "skipped_deadline"),
            "monte_carlo_episode": section("monte_carlo_episode", "skipped_deadline"),
            "host_loop_demo_1": section("host_loop_demo_1", "skipped_deadline"),
            "phase_mean_ms": phases,
            "mfu": phases.get("net_mfu_bf16_peak"),
            "net_flops_per_fwd_b8": phases.get("net_flops_per_fwd"),
            "wall_s_total": time.time() - T_START,
            "window_accounting": accounting or {},
            "device": device,
            "kernel_launches": run.get("launches", {}),
        },
    }


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m mind_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic_av2 seeds 0-3 in place of demo_1..4's AV2 logs")
    ap.add_argument("--data-root", help="directory holding the demos' AV2 folders")
    ap.add_argument("--device", help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, help="ticks per episode (default: the demos' 500)")
    ap.add_argument("--sections", default=",".join(SECTION_ORDER),
                    help="comma-separated sections to run, in SECTION_ORDER")
    ap.add_argument("--section", help="run one section in this process and print its line")
    ap.add_argument("--out", help="with --section: write its result to this JSON file")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--deadline", type=float, help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if not opts.synthetic and not opts.data_root:
        ap.error("pass --data-root DIR (the AV2 demo logs) or --synthetic")
    if opts.steps is not None and (opts.steps <= 0 or opts.steps % 5):
        ap.error("--steps must be a positive multiple of 5 (one plan cycle is 5 ticks)")
    sections = opts.sections.split(",")
    unknown = [s for s in sections + ([opts.section] if opts.section else [])
               if s not in SECTION_ORDER]
    if unknown:
        ap.error(f"unknown sections {unknown}: choose from {SECTION_ORDER}")
    opts.sections = [s for s in SECTION_ORDER if s in sections]
    return opts


def main(argv=None) -> int:
    opts = _parse(argv)
    if opts.section:  # one section in this process
        with tempfile.TemporaryDirectory() as tmp:
            from mind_tpu_torch.common.device import resolve_device

            scenes = Scenes(tmp if opts.synthetic else opts.data_root, opts.synthetic,
                            opts.steps, resolve_device(opts.device))
            out = _run_section(opts.section, scenes)
        _emit({"section": opts.section, "result": out})
        if opts.out:
            os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
            with open(opts.out, "w") as f:
                json.dump({"section": opts.section, "result": out}, f, indent=1)
        return 0
    if opts.child:
        _run_child(opts.sections, opts.deadline, opts)
        return 0

    results, launches = {}, {}
    accounting = {"budget_s": BUDGET_S}
    run = {"sections": opts.sections, "ticks": opts.steps or 500, "launches": launches,
           "scenes": "synthetic_av2 seeds 0-3" if opts.synthetic else "AV2 demo logs",
           "device": device_info(opts.device)}
    clean = False
    try:
        # the child starts beside the probe: its imports take as long
        proc = _spawn_child(opts.sections, DEADLINE, opts)
        if not (opts.device or "").startswith("cpu"):
            from mind_tpu_torch.utils.device_health import probe_once

            t = time.time()
            healthy = probe_once()
            accounting["probe_s"] = time.time() - t
            _progress("device_probe", {"ok": healthy})
            if not healthy:
                # no card, or a dead one: the child is stopped and the final
                # line printed at once, no retry
                proc.kill()
                proc.wait()
                results[opts.sections[0]] = {
                    "error": "CUDA device unavailable: the health probe failed"}
                return 1
        clean = _drain_child(proc, results, accounting, launches)
        accounting["child_returncode"] = proc.returncode
        for s in opts.sections:
            if s not in results:
                results[s] = {"error": "skipped_deadline" if time.time() >= DEADLINE else
                              f"the child exited with code {proc.returncode} first"}
    finally:
        print(json.dumps(_final_json(results, accounting, run)), flush=True)
    failed = [s for s in opts.sections if "error" in results[s]]
    if failed:
        _progress("failed_sections", {s: results[s]["error"] for s in failed})
    return 0 if clean and not failed else 1


if __name__ == "__main__":
    sys.exit(main())
