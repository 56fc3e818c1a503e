"""Smoke run of the PyTorch port (mind_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure ends the run with a non-zero exit and no
result line):
  0. probe: utils/device_health.py::probe_once() (a bf16 product on the card
     in a fresh subprocess) must return True;
  1. build both CUDA kernels (mind_tpu_torch/ops/csrc/fusion_attention.cu,
     float32, and fusion_attention_bf16.cu, bf16 operands on the tensor
     cores; sm_90a, one nvcc per source, side by side) from the checkout;
  2. hold each kernel against its plain PyTorch version at the main path's
     shapes (B = 8 AIME nodes, N = 48 + 80 + 1 = 129 tokens, D = 128) for
     both update_edge values (and both edge input types of the bf16
     variant), and time both against the card's bound; then both at
     B = 32 against each slice of 8 alone: equal to the bit (a node
     computes in a batch of scenes what it computes alone);
  3. load the trained ScenePredNet weights from the committed archive;
  4. float32 path: plan cycles of fused_plan_core at full width on a seeded
     synthetic scene (48 actor slots, 80 lane segments, 256-point target
     lane), rolling the observation window between cycles; the first cycle
     is held against the same cycle on the CPU through the plain version;
 4a. host tree: ScenarioTreeGenerator.branch_aime (planner/scenario_tree.py,
     the tree bookkeeping on the host) against aime_grow_tree on the same
     filled window, both on the card with the float32 network: the same
     number of trees, the same multiset of (duration, norm_prob to 1e-4),
     root-child trajectories within 2e-3 m, kernel A launched 6 times per
     round;
  5. demo path: the same cycles under planner_config_for_demo("demo_1")
     (bf16 network); one ScenePredNet forward on the path's first AIME
     inputs is held, kernel against plain, on the card;
  6. closed loop: the port's Simulator on the seeded synthetic AV2 scenario
     (a three-lane road as a log_map_archive map and a 110-frame Scenario,
     built by synthetic.py::demo_scenario under configs/demo_1.json with each
     phase's own planner configuration, AV target velocity, enable time and
     ticks, as are the sims of phases 7-12b), here read from the committed
     AV2-format log of synthetic_av2(0) (tests/fixtures/av2_synthetic: the
     map JSON and the scenario parquet, read by data/parquet.py and held
     equal to the scenario built in memory; the read's ms printed);
     through the data layer, load_agents, MINDAgent and MINDPlanner.plan on
     the staged path with exported trees) under the demo configuration at
     full width, 150 ticks of 20 ms with the planner enabled after 1 s: 20
     plans; per-plan wall time with the planner's phases, ticks per second
     and the share of the loop's wall time outside plan() are printed;
 6b. demo command: python -m mind_tpu_torch.run_sim --config <the fixture's
     demo_1_synthetic.json, its output in a temporary folder> --data-root
     tests/fixtures/av2_synthetic --max-steps 150, rendering on, as a
     subprocess: exit code 0, phase 6's plan count, no failed plan, an MJPEG
     AVI of 150 JPEG frames of 1200 x 1200 (probe_avi); then run_sim.main
     on the same arguments and --no-render in this process: kernel B
     launched a positive multiple of 6 times and kernel A never, the ego
     within 1e-6 m of phase 6's (whether it is equal to the bit is
     printed); the parquet read ms, render seconds a frame (8 frames one
     after another here; drawn and encoded with the configuration's
     num_threads workers in the command), PNG read and JPEG encode ms a
     frame and the command's ticks/s, with the card's name and power limit;
  7. float32 loop: 36 ticks under the float32 defaults with the planner
     enabled after 0.2 s (5 plans, float32 kernel), on the card and again
     on the CPU through the plain version: ego states within 1e-3 m, the
     same tree at every plan;
  8. exec re-solve: one plan each with float32 selection solves and a
     float64 re-solve of the winner in polish, scratch and native mode (the
     native one in C++ on the host, mind_tpu_torch/native, built with g++);
     the scratch control is held against a pure float64 solve of the same
     scene, the native control against the scratch one (1e-7);
  9. graph against eager: the float32 plan-cycle scene's two-phase solve of
     all trees with each iLQR iteration a replayed CUDA graph (1 and 4
     replays per host read) and eagerly: the same iteration counts, xs/us
     equal to the bit, and the three timed;
 10. episode: run_episode_timed (sim/episode.py) on the closed loop's
     scenario under the demo configuration, 150 ticks with the planner
     enabled after 1 s: no failed cycle, the loop's plan count, the ego
     within 1e-3 m of the Simulator's trajectory of phase 6; kernel B
     launched 6 times per AIME round, kernel A never; then
     run_episode_segmented in 4-cycle segments equal to it to the bit;
 11. batched episode: run_episodes_batched over four synthetic AV2 scenarios
     (seeds 0-3, the AV asked for 8, 7, 9 and 6 m/s; planner on after 1 s,
     150 ticks, demo configuration), warm then timed: kernel B launched 6
     times per AIME round of the batch (B = 32 nodes per round), the iLQR
     graphs' pool holding no tensor, each scenario against its own
     run_episode: the same failing cycle and plan count, the ego within
     1e-3 m over the whole run; the first cycle where the two take a
     different discrete decision (plan, ok, iteration count, tree), if
     any, is printed; and the network's outputs for each scene's nodes in
     a batched forward equal to its forward alone, to the bit;
 12. Monte-Carlo: run_episode_monte_carlo on the loop's scenario, 16 copies
     in one chunk (B = 128 nodes per round), segments of 10 cycles, warm then
     timed, with its peak device memory: every copy finite, kernel B
     launched 6 times per round, segments of 4 equal to it to the bit, copies
     0 and 15 against run_episode on their own schedules (as in 11);
 12a. parity playback: parity/runner.py::run_parity_episode_playback on the
     loop's scenario under the demo configuration (read from
     configs/demo_1.json; 150 ticks, planner on after 1 s): the episode's
     recorded controls against the float64 mirror (parity/host_planner.py)
     planning from the same inputs with the planner's network on the card:
     zero ok flips, mean per-cycle rollout deviation within 1e-3 m
     (PARITY_TRACES.md section 1), kernel B launched 6 times per AIME round
     and per mirror forward; the plans compared, the deviations and the
     mirror's seconds per plan are printed;
 12b. parity resync: run_parity_demo_resync on the same scenario (demo_1's
     4 s enable time, 230 ticks, at least 5 plans of the staged planner with
     the mirror in tandem): the same criterion and launch check;
 13. tree scale: parallel_tree_solve of 1024 random branching trees on a
     one-device mesh, timed, against four slices of 256 solved alone;
 14. training: PlannerConfig()'s float32 network at full width from
     init_scene_pred(seed=0), one batch of four synthetic AV2 scenarios
     (seeds 0-3) through the data layer and scenario_to_batch, AdamW(3e-4):
     (a) kernel A launched 6 times per training forward; (b) the whole
     network's gradients through the kernel's autograd Function against
     autograd through the plain version, each parameter within 1e-3 in
     relative norm, none missing or zero, and the decoder's target branch
     (which only a scene won by mode 0 trains) the same way under the loss
     with mode 0 as every scene's winner; (c) the same for kernel B at one
     call; (d) 20 steps, finite losses, the last below the first; (e) the
     first two losses and the first gradients against the same steps on the
     CPU; (f) save, restore, one step equal to one step without the round
     trip, to the bit, under deterministic cuDNN (set for (f) alone; the
     other checks and the timing run cuDNN's default algorithms); the timed
     steps' forward / backward / optimizer ms,
     scenes per second, peak memory and the backward's share in the plain
     recompute of the 6 layer cores;
 15. bench: python -m mind_tpu_torch.bench --synthetic --steps 250 over its
     per-demo, phase-split, batched and host-loop sections (the Monte-Carlo
     sweep is phase 12's) in a subprocess: exit code 0, the final line with
     the JAX package's bench.py keys and the twin's, every section without
     an error, every demo with 10 plans and, as every batched scene, no
     failed cycle, the host loop with 10 plans, every time and rate finite
     and positive, 0 < MFU < 1, in every section kernel B launched a
     positive multiple of 6 times and kernel A never, and no demo's timed
     run capturing a CUDA graph (every demo is warmed first; the captures of
     each warm run are printed);
 15a. scripts: the drivers of mind_tpu_torch/scripts/ (the JAX package's
     scripts/*.py) through their main([...]) in this process, on synthetic
     scenes at 215 ticks (3 plans a demo), outputs in a temporary
     directory: run_all_demos in both modes on demos 1 and 2 (PASS, the
     report written; its episode mode once more as a subprocess, the CLI);
     parity_run's free run of demo_1 under native_bal and its log through
     bench_north_star (finite rows; the verdict printed, not held);
     bench_strict on demo_1 (no failed cycle, the float32 plan count);
     bench_exec_ab's five policies (finite rates, no failed cycle);
     bench_forward_split in bf16 and float32 and bench_fusion (the
     variant's kernel 6 times per FusionNet pass, the other never, kernel
     against plain within TOL_NET_CLS / TOL_NET_POS); diag_playback on
     demo_1 (the JAX field names, finite deviations). Each driver's
     launches, counted from 0 around it, equal what its rows record, and
     the demo configuration's runs launch kernel B in multiples of 6;
 15b. dist: the shards at the same time, one process per shard
     (mind_tpu_torch/parallel/launch.py, the rank workloads of
     parallel/dryrun.py), at full width with the trained weights. (a)-(c)
     two ranks on the one card (gloo): the Monte-Carlo sweep of phase 12's
     scenario under the demo configuration, K = 8 copies in chunks of 4
     (2 per rank), 100 ticks; phase 13's 1024 trees, 2 x 512; 5 float32
     training steps of phase 14's batch, 2 scenes per rank (cuDNN held to
     deterministic algorithms in the ranks and here). Each rank's copies,
     trees, losses and parameters equal to the sequential two-shard mesh's
     in this process, to the bit; kernel B launched by the ranks' sweeps as
     often as by the sequential one, kernel A 6 times per training forward.
     One rank on nccl trains on the whole batch, equal to the bit to the
     unsharded step. (d) with two cards or more, one rank per card on nccl
     against the sequential mesh across two cards, the same way; with one
     card a line says it was not run. Copy-ticks/s of the ranks and of the
     one process, the tree solve's ms, each rank's step ms and launches;
 16. print per-phase times, the benchmark's final and section lines, the
     kernel table and the card.

The kernels' bounds and the benchmark's MFU divide by the card's peak rates
from mind_tpu_torch/utils/device_specs.py, which raises on a card it does
not know.

Phase 2 holds both kernels at B = 8, 32 and 128, the batches the paths give
them. The kernels line counts each kernel's launches by path.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit from nvidia-smi, and before that one JSON line
{"kernels": [...]}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_CYCLES = 2
SEED = 0
# the card's peak rates (mind_tpu_torch/utils/device_specs.py), set in main
PEAKS = None
# float32 kernel vs its plain version: float32 sums in another order
TOL_KERNEL = 2e-4
# bf16 kernel vs its plain version: sums in another order, and a float32
# activation that lies on a bf16 rounding boundary may round the other way in
# the kernel. One such flip of a mem value between 2 and 4 is a step of 2^-6
# on one of a row's 128 summands; through a weight of 0.3 and two LayerNorms
# it moves an edge output by up to ~1e-2 (measured max 5.5e-3). Flips are
# rare, so the mean error is held far tighter.
TOL_KERNEL_BF16 = 2e-2
TOL_KERNEL_BF16_MEAN = 1e-4
# one bf16 ScenePredNet forward, kernel against plain: the same flips, carried
# through 6 fusion layers and the decoder
TOL_NET_CLS = 5e-3
TOL_NET_POS = 5e-2         # metres
# closed loop: ego on the card against the CPU run through the plain version
# (the BASELINE.json rollout budget), metres
TOL_LOOP_EGO = 1e-3
# scratch re-solve against a pure float64 solve of the same scene: the same
# float64 arithmetic on one tree (measured gap 0.0 on the card and the CPU)
TOL_SCRATCH = 1e-7
# polish re-solve against the same: it stops within rel_tol of that optimum
# (measured gap 8.9e-8 on the card at full width); controls are O(0.1)
TOL_POLISH = 1e-3
# native (C++ on the host) against the scratch re-solve of the same plan:
# the same two-phase float64 iteration path, sums in another order (the JAX
# package's tests/test_native.py holds its own pair to the same 1e-7)
TOL_NATIVE = 1e-7
# episode against the Simulator loop of the same scenario (fused against
# staged plans, float64 integration on the device against the host): the
# BASELINE.json rollout budget, metres
TOL_EPISODE_EGO = 1e-3
# training: a parameter's gradient through the kernel's autograd Function
# (kernel forward, plain recompute backward) against autograd through the
# plain version, in relative norm; the card's first steps against the CPU's
TOL_GRAD = 1e-3
TOL_TRAIN_LOSS = 1e-4
TRAIN_STEPS, TRAIN_WARM, TRAIN_LR = 20, 3, 3e-4
# the decoder's target-lane branch (target RPE and target embedding), which
# feeds mode 0 alone (reference network.py:506-508)
TARGET_BRANCH = ("SceneDecoder_0.MLPBlock_0.", "SceneDecoder_0.MLPBlock_1.")
SEQ_ID = "synthetic"
# the host tree generator against the device AIME: root-child trajectories,
# metres (tests/test_aime.py:119)
TOL_HOST_TREE = 2e-3
# parity: mean per-cycle rollout deviation against the float64 mirror, metres
# (PARITY_TRACES.md section 1's criterion)
TOL_PARITY_MEAN = 1e-3
# the resynced parity run: demo_1 enables the planner at 4 s (tick 200)
RESYNC_TICKS = 230
OBS = 50
# the AV logs 5 m/s behind a leader at 3 m/s; asked for 8 m/s (the demo
# configurations set a target velocity too), every plan has to accelerate
TARGET_VELOCITY = 8.0
REPLACES = "mind_tpu/ops/fusion_attention.py:95 (_kernel, pallas_call at :182)"
T0 = 0.0
# the committed AV2-format log of synthetic_av2(0) under demo_1's sequence id
# and its configuration (tools/write_av2_fixture.py)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                       "av2_synthetic")
FIXTURE_CONFIG = os.path.join(FIXTURE, "demo_1_synthetic.json")
# (6b) the demo command against phase 6's in-process loop on the same scene
# and configuration: the same float64 values through the parquet, metres
TOL_COMMAND_EGO = 1e-6
LOOP_TICKS = 150
DEMO_FRAME = 1200                 # pixels: render_png's figsize 12 at 100 dpi
SERIAL_FRAMES = 8                 # frames drawn again in this process, timed
COMMAND_TIMEOUT_S = 600


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build(fa):
    t = time.perf_counter()
    fa.build_kernels()
    log(f"[build] both fusion kernels built and loaded in {time.perf_counter() - t:.3f} s")
    for variant, text in fa.build_kernels.log.items():
        log(f"[build] nvcc, {variant}:\n{text.strip()}")


def check_case(fa, ref, args, H, ue, tol, tol_mean, label):
    """One (inputs, update_edge) case: kernel vs plain, and both timed."""
    edge = args[1]
    out, edge_out = fa.fused_edge_attention(*args, H, ue)
    torch.cuda.synchronize()
    ref_out, ref_edge = ref(*args, H, ue)
    if out.dtype != torch.float32 or edge_out.dtype != torch.float32:
        raise RuntimeError(f"{label}: outputs must be float32")
    if not ue and edge.dtype == torch.float32 and edge_out is not edge:
        raise RuntimeError(f"{label}: passthrough must return a float32 input edge")
    d_out, d_edge = (out - ref_out).abs(), (edge_out - ref_edge).abs()
    err = max(d_out.max().item(), d_edge.max().item())
    mean = max(d_out.mean().item(), d_edge.mean().item())
    ms = cuda_time_ms(lambda: fa.fused_edge_attention(*args, H, ue))
    plain_ms = cuda_time_ms(lambda: ref(*args, H, ue))
    if not (err < tol and mean < tol_mean):
        raise RuntimeError(f"{label}: kernel disagrees with plain: max {err} (tol {tol}), "
                           f"mean {mean} (tol {tol_mean})")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "mean_abs_err": mean}


def kernel_cases(fa, dev, key_mask):
    """Both kernels vs their plain versions at B = key_mask.shape[0] and
    N = 129, on random inputs with the main path's token mask: one result
    per (variant, edge type, update_edge) case, weighted by its launches in
    one forward: 5 with the edge update and 1 without. In the bf16 variant
    the first of the 5 reads a bf16 node and edge (the encoders' output);
    the later ones read float32, which is what the layer before them wrote,
    so each case's node has its edge's type."""
    B, N, D, H = key_mask.shape[0], key_mask.shape[1], 128, 8
    from mind_tpu_torch.synthetic import fusion_inputs

    w, node, edge = fusion_inputs(B, N, D, dev, SEED)
    bf16 = torch.bfloat16
    w16 = fa.FusionWeights(*(t.to(bf16) for t in w))
    # (variant, edge type, update_edge, launches of it in one forward)
    cases = [("float32", "float32", True, 5), ("float32", "float32", False, 1),
             ("bfloat16", "bfloat16", True, 1), ("bfloat16", "float32", True, 4),
             ("bfloat16", "float32", False, 1), ("bfloat16", "bfloat16", False, 0)]
    entries = {}
    for variant, edge_type, ue, weight in cases:
        if weight == 0 and B != 8:
            continue
        if variant == "float32":
            args, ref = (node, edge, key_mask, w), fa.fused_edge_attention_ref
            tol, tol_mean, peak = TOL_KERNEL, TOL_KERNEL, PEAKS.f32_flops
            nbytes = fa.fused_edge_attention_bytes(B, N, D, ue)
        else:
            x, e = (node.to(bf16), edge.to(bf16)) if edge_type == "bfloat16" else (node, edge)
            args, ref = (x, e, key_mask, w16), fa.fused_edge_attention_bf16_ref
            tol, tol_mean, peak = TOL_KERNEL_BF16, TOL_KERNEL_BF16_MEAN, PEAKS.bf16_flops
            nbytes = fa.fused_edge_attention_bytes(B, N, D, ue, e.element_size(),
                                                   x.element_size(), 2)
        flops = fa.fused_edge_attention_flops(B, N, D, ue, variant)
        label = f"B={B} {variant} node,edge={edge_type} update_edge={ue}"
        r = check_case(fa, ref, args, H, ue, tol, tol_mean, label)
        t_ops, t_bytes = 1e3 * flops / peak, 1e3 * nbytes / PEAKS.hbm_bytes
        r.update(bound_ms=max(t_ops, t_bytes), weight=weight,
                 bound_by="operations" if t_ops > t_bytes else "bytes")
        log(f"[kernel] {label}: max_abs_err={r['max_abs_err']:.3e} "
            f"mean_abs_err={r['mean_abs_err']:.3e} kernel={r['ms']:.4f} ms "
            f"plain={r['plain_ms']:.4f} ms bound={r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        entries.setdefault(variant, {})[f"edge_{edge_type}_update_{str(ue).lower()}"] = r
    del node, edge, args
    torch.cuda.empty_cache()
    return entries


def mix(by_case, k):
    total = sum(r["weight"] for r in by_case.values())
    return sum(r[k] * r["weight"] for r in by_case.values()) / total


def kernel_batch_gap(fa, dev, token_mask, B=8, S=4):
    """Both kernels on S * B nodes against the same call on each slice of B
    of them alone, for every (variant, edge type, update_edge) case of the
    main path: the max abs gap of out and edge per variant. A node must
    compute in a batch of scenes what it computes alone, so any gap but 0
    raises."""
    from mind_tpu_torch.synthetic import fusion_inputs

    N, D, H = token_mask.shape[0], 128, 8
    w, node, edge = fusion_inputs(S * B, N, D, dev, SEED)
    mask = token_mask[None].expand(S * B, -1).contiguous()
    w16 = fa.FusionWeights(*(t.to(torch.bfloat16) for t in w))
    cases = [("float32", w, torch.float32, True), ("float32", w, torch.float32, False),
             ("bfloat16", w16, torch.bfloat16, True), ("bfloat16", w16, torch.float32, True),
             ("bfloat16", w16, torch.float32, False)]
    gaps = {}
    for variant, ww, edge_type, ue in cases:
        x, e = node.to(edge_type), edge.to(edge_type)
        whole = fa.fused_edge_attention(x, e, mask, ww, H, ue)
        # clones: a slice of the mask is not 16-byte aligned, as the kernels need
        cut = lambda t, k: t[k:k + B].clone()
        for k in range(0, S * B, B):
            alone = fa.fused_edge_attention(cut(x, k), cut(e, k), cut(mask, k), ww, H, ue)
            gap = max(float((a[k:k + B] - b).abs().max()) for a, b in zip(whole, alone))
            gaps[variant] = max(gaps.get(variant, 0.0), gap)
    log(f"[kernel] B={S * B} against each slice of {B} alone, max abs gap: {gaps}")
    if any(g != 0.0 for g in gaps.values()):
        raise RuntimeError(f"a node's kernel result depends on its batch: {gaps}")
    return gaps


def phase_kernel_check(fa, dev, token_mask, batches=(8, 32, 128)):
    """kernel_cases at B = 8 (one scene's AIME round) and at the batched
    paths' B = 32 (4 scenes) and 128 (16 Monte-Carlo copies), and
    kernel_batch_gap at B = 32; returns the two kernel table entries
    (launches filled in later), whose ms, plain_ms and bound_ms are the
    B = 8 mix, with "by_batch" for every B."""
    per_batch = {B: kernel_cases(fa, dev, token_mask[None].expand(B, -1).contiguous())
                 for B in batches}
    batch_gap = kernel_batch_gap(fa, dev, token_mask)
    table = []
    for variant in ("float32", "bfloat16"):
        by_case = per_batch[batches[0]][variant]
        bound_by = {r["bound_by"] for r in by_case.values() if r["weight"]}
        table.append({
            "name": "fused_edge_attention" + ("" if variant == "float32" else "_bf16"),
            "route": "cuda",
            "source": "mind_tpu_torch/ops/csrc/fusion_attention"
                      + ("" if variant == "float32" else "_bf16") + ".cu",
            "replaces": REPLACES + (", float32 mode" if variant == "float32"
                                    else ", bf16 operand mode (:109-130)"),
            "launches": None,
            "max_abs_err": max(r["max_abs_err"] for b in batches
                               for r in per_batch[b][variant].values()),
            "ms": mix(by_case, "ms"), "plain_ms": mix(by_case, "plain_ms"),
            "bound_ms": mix(by_case, "bound_ms"),
            "bound_by": bound_by.pop() if len(bound_by) == 1 else "bytes",
            "library_ms": None,
            "shape": f"B={batches[0]} N={token_mask.shape[0]} D=128 heads=8 {variant}",
            "by_case": by_case,
            "by_batch": {str(b): {**{k: mix(per_batch[b][variant], k)
                                     for k in ("ms", "plain_ms", "bound_ms")},
                                  "max_abs_err": max(r["max_abs_err"] for r in
                                                     per_batch[b][variant].values())}
                         for b in batches},
            "batch_gap_32_vs_8": batch_gap[variant],
        })
    return table


def phase_graph_vs_eager(cfg, net, scene, aime, scene_statics, dev):
    """(a) The float32 plan-cycle scene's two-phase solve of all trees, with
    the iteration as a CUDA graph (REPLAYS_PER_READ = 1 and 4) and eagerly:
    the same warm and full iteration counts, xs/us equal to the bit. Each
    timed once more after a first call that captures the graphs."""
    from mind_tpu_torch.planner import ilqr
    from mind_tpu_torch.planner.cost_topology import device_cost_topology
    from mind_tpu_torch.planner.planner import MAX_COST_TGT_PTS, MAX_TREES, ilqr_configs
    from mind_tpu_torch.planner.trajectory_tree import (gather_cost_nodes, make_cost_params,
                                                        torch_dtype, two_phase_solve)

    tt = cfg.traj_tree
    pdt = getattr(torch, cfg.pipeline_dtype)
    buf = fill_buffer(aime, scene, pdt, dev)
    st = scene_statics(scene, pdt, dev)
    amask = torch.tensor(scene.present, device=dev)
    with torch.no_grad():
        state, meta, _ = aime.aime_grow_tree(net, cfg, *aime.scene_axis(
            buf, torch.tensor(scene.types, device=dev), amask, st.lane, st.tgt))
    dct = device_cost_topology(state.parent, state.depth, state.duration, state.start_t,
                               state.end_flag, meta.tree_id, MAX_TREES, tt.max_cost_nodes,
                               tt.max_depth_levels, tt.max_width_hint)
    ilqr_cfg, warm_cfg = ilqr_configs(cfg)
    nodes = gather_cost_nodes(state.slots, meta.norm_prob, dct.cost_slot, dct.cost_step,
                              dct.topo.node_mask, amask[None],
                              torch.zeros(MAX_TREES, dtype=torch.long, device=dev),
                              dtype=torch_dtype(ilqr_cfg.dtype))
    x0 = World(scene).x0()
    wp, fp = (make_cost_params(ph, x0, st.cost_lane, scene.target_vel, MAX_COST_TGT_PTS, w, dev)
              for ph, w in ((tt.warm, True), (tt.full, False)))
    x0 = torch.tensor(x0, device=dev)

    def solve(graphed, k=None):
        if k is not None:
            ilqr.REPLAYS_PER_READ = k
        torch.cuda.synchronize()
        t = time.perf_counter()
        xs, us, info = two_phase_solve(dct.topo, x0, nodes, wp, fp, ilqr_cfg, warm_cfg,
                                       active=dct.tree_mask, graphed=graphed)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, xs, us, info

    keep = ilqr.REPLAYS_PER_READ
    runs = {}
    try:
        for name, graphed, k in (("eager", False, None), ("graph_k1", True, 1),
                                 ("graph_k4", True, 4), ("eager", False, None),
                                 ("graph_k4", True, 4), ("graph_k1", True, 1)):
            ms, xs, us, info = solve(graphed, k)
            runs.setdefault(name, {"ms": [], "out": (xs, us, info)})["ms"].append(ms)
    finally:
        ilqr.REPLAYS_PER_READ = keep
    xs0, us0, info0 = runs["eager"]["out"]
    tm = dct.tree_mask
    its = lambda info, k: [int(x) for x in info[k][tm].tolist()]
    summary = {"trees": int(dct.n_trees), "levels": ilqr._levels_in_use(dct.topo),
               "warm_iterations": its(info0, "warm_iterations"),
               "iterations": its(info0, "iterations"), "replays_per_read": keep,
               "ms": {n: r["ms"] for n, r in runs.items()}}
    for name in ("graph_k1", "graph_k4"):
        xs, us, info = runs[name]["out"]
        summary[f"{name}_max_abs_diff"] = max((xs - xs0).abs().max().item(),
                                              (us - us0).abs().max().item())
        if its(info, "warm_iterations") != summary["warm_iterations"] or \
                its(info, "iterations") != summary["iterations"] or \
                not (torch.equal(xs, xs0) and torch.equal(us, us0)):
            raise RuntimeError(f"graphed solve ({name}) differs from the eager solve: {summary}, "
                               f"{its(info, 'warm_iterations')} + {its(info, 'iterations')}")
    log("[graph] " + json.dumps(summary))
    return summary


class World:
    """The synthetic scene's agents, advanced between plan cycles: the ego
    by the kinematic bicycle under the planned control (5 ticks of 20 ms),
    the others at constant velocity."""

    def __init__(self, scene):
        self.scene = scene
        self.state = scene.history[:, -1].copy()      # [A, 4] x, y, v, yaw
        self.ctrl = np.zeros(2)

    def step(self, ctrl, kine_propagate, dt=0.02, ticks=5):
        self.ctrl = np.asarray(ctrl, np.float64)
        ego = torch.tensor(self.state[0])
        for _ in range(ticks):
            ego = kine_propagate(ego, torch.tensor(self.ctrl), dt)
        self.state[0] = ego.numpy()
        others = self.state[1:]
        others[:, 0] += others[:, 2] * np.cos(others[:, 3]) * dt * ticks
        others[:, 1] += others[:, 2] * np.sin(others[:, 3]) * dt * ticks

    def x0(self):
        return np.concatenate([self.state[0], self.ctrl])


def plan_once(mods, net, cfg, world, buf, statics, dev, report):
    tplanner, make_cost_params = mods
    tt = cfg.traj_tree
    x0 = world.x0()
    P = tplanner.MAX_COST_TGT_PTS
    wp = make_cost_params(tt.warm, x0, statics.cost_lane, world.scene.target_vel, P, True, dev)
    fp = make_cost_params(tt.full, x0, statics.cost_lane, world.scene.target_vel, P, False, dev)
    ilqr, warm = tplanner.ilqr_configs(cfg)
    sc = world.scene
    return tplanner.fused_plan_core(
        net, buf, torch.tensor(sc.types, device=dev), torch.tensor(sc.present, device=dev),
        torch.tensor(x0, device=dev), wp, fp, sc.target_vel, statics.lane, statics.tgt,
        statics.eval_segs, cfg=cfg, ilqr_cfg=ilqr, warm_ilqr_cfg=warm,
        weights=tplanner.selection_weights(cfg), report=report).cpu().numpy()


def fill_buffer(aime, scene, dtype, dev):
    buf = aime.DeviceObsBuffer.create(scene.history.shape[0], dtype, dev)
    for f in range(scene.history.shape[1]):
        buf = aime.obs_buffer_update(buf, torch.tensor(scene.history[:, f], device=dev),
                                     torch.tensor(scene.present, device=dev))
    return buf


class FirstCall:
    """The network as the plan cycle calls it, keeping the first call's
    inputs."""

    def __init__(self, net):
        self.net, self.inputs = net, None

    def __call__(self, *inputs):
        if self.inputs is None:
            self.inputs = inputs
        return self.net(*inputs)


def run_path(name, variant, cfg, net, scene, mods, aime, scene_statics, kine_propagate, fa, dev):
    """N_CYCLES plan cycles of one configuration on the card. The launch
    counts are set to 0 just before and read just after; returns (launches
    of `variant`, per-cycle records, the first cycle's (out, best, buf))."""
    tplanner = mods[0]
    pdt = getattr(torch, cfg.pipeline_dtype)
    world = World(scene)
    buf = fill_buffer(aime, scene, pdt, dev)
    statics = scene_statics(scene, pdt, dev)
    first, total_rounds, cycles = None, 0, []
    fa.reset_launch_counts()
    for c in range(N_CYCLES):
        report = {}
        before = fa.fused_edge_attention.launches
        t = time.perf_counter()
        out = plan_once(mods, net, cfg, world, buf, statics, dev, report)
        wall = time.perf_counter() - t
        launched = fa.fused_edge_attention.launches - before
        rounds = report["rounds"]
        total_rounds += rounds
        log(f"[{name} {c}] out={out.tolist()} rounds={rounds} "
            f"trees={int(report['trees'].n_trees)} best={int(report['best'])} "
            f"launches={launched} iterations={report['warm_iterations']}+{report['iterations']} "
            f"wall={wall * 1e3:.1f} ms | "
            + " ".join(f"{k}={report[k] * 1e3:.1f} ms"
                       for k in ("aime", "cost_topology", "solve", "selection")))
        if out.shape != (4,) or not np.isfinite(out).all():
            raise RuntimeError(f"{name}: plan output not finite: {out}")
        if out[2] != 1.0:
            raise RuntimeError(f"{name}: plan failed: no scenario tree (ok = 0)")
        if launched != cfg.net.n_scene_layer * rounds:
            raise RuntimeError(f"{name}: {launched} kernel launches for {rounds} AIME rounds")
        cycles.append({"wall_ms": wall * 1e3, "rounds": rounds,
                       "trees": int(report["trees"].n_trees),
                       "warm_iterations": report["warm_iterations"],
                       "iterations": report["iterations"],
                       **{k: report[k] * 1e3 for k in ("aime", "cost_topology", "solve",
                                                        "selection")}})
        if first is None:
            first = (out, int(report["best"]), buf)
        world.step(out[:2], kine_propagate)
        states = torch.tensor(world.state, device=dev)
        buf = aime.obs_buffer_update(buf, states, torch.tensor(scene.present, device=dev))
    counts = dict(fa.fused_edge_attention.launches_by_variant)
    other = sum(n for v, n in counts.items() if v != variant)
    if counts[variant] != cfg.net.n_scene_layer * total_rounds or counts[variant] == 0 or other:
        raise RuntimeError(f"{name}: the path did not run through the {variant} kernel "
                           f"alone: {counts} for {total_rounds} AIME rounds")
    return counts[variant], cycles, first


def loop_sim(planner_cfg, enable, ticks, data_root, seed=SEED, target_velocity=TARGET_VELOCITY,
             device=None):
    """demo_1's configuration on the synthetic AV2 scenario of `seed`
    (synthetic.py::demo_scenario) with this phase's planner configuration,
    AV target velocity, enable time (s) and ticks, on `device` (None: the
    card)."""
    from mind_tpu_torch.synthetic import demo_scenario

    return demo_scenario("demo_1", seed, data_root, ticks=ticks, planner_cfg=planner_cfg,
                         enable_timestep=enable, target_velocity=target_velocity, device=device)


def run_loop(name, planner_cfg, enable, ticks, device, data_root, seed=SEED):
    """The port's Simulator for `ticks` ticks on the synthetic AV2 scenario
    of `seed` (None: the log under data_root) with the AV's planner enabled
    after `enable` seconds, on `device` (None: the card). Returns (sim, the
    AV's agent, per-plan records)."""
    sim = loop_sim(planner_cfg, enable, ticks, data_root, seed=seed, device=device)
    agent = next(a for a in sim.agents if a.id == "AV")
    plans, plan, timer = [], agent.plan, agent.planner.metrics.timer

    def recorded():
        before = dict(timer.totals)
        t = time.perf_counter()
        ok, res = plan()
        rec = {"tick": sim.metrics["ticks"], "ok": ok,
               "wall_ms": (time.perf_counter() - t) * 1e3,
               "rounds": agent.planner.last_rounds,
               **{k: (timer.totals[k] - before.get(k, 0.0)) * 1e3 for k in timer.totals}}
        if ok:
            rec.update(ctrl=[float(c) for c in agent.ctrl], trees=agent.planner.last_n_trees,
                       tree=res[0][0].get_root_key(),
                       iterations=agent.planner.metrics.counters["gauge/ilqr_iterations"])
        plans.append(rec)
        log(f"[{name} plan {len(plans) - 1}] " + json.dumps(rec))
        return ok, res

    agent.plan = recorded
    sim.run_sim()
    m = sim.metrics
    failures = agent.planner.metrics.counters.get("plan_failures", 0)
    if m["ticks"] != ticks or failures or not all(r["ok"] for r in plans):
        raise RuntimeError(f"{name}: the loop ended early or a plan failed: {m}, "
                           f"{failures} plan failures")
    if m["plan_calls"] != len(plans):
        raise RuntimeError(f"{name}: {m['plan_calls']} plan calls, {len(plans)} recorded")
    ego = sim.ego_trajectory()
    if ego.shape != (ticks, 4) or not np.isfinite(ego).all():
        raise RuntimeError(f"{name}: ego trajectory {ego.shape} not finite")
    return sim, agent, plans


def check_exported_trees(name, frame):
    """The scenario and trajectory trees of one plan: non-empty, finite."""
    for key in ("scen_tree", "traj_tree"):
        (tree,) = frame[key]
        if tree.size() < (2 if key == "traj_tree" else 1):   # the traj tree's root is x0
            raise RuntimeError(f"{name}: exported {key} is empty")
        for k in tree.bfs_keys():
            for x in tree.get_node(k).data:
                if np.size(x) == 0 or not np.isfinite(np.asarray(x, np.float64)).all():
                    raise RuntimeError(f"{name}: {key} node {k} payload empty or not finite")
    return {k: frame[k][0].size() for k in ("scen_tree", "traj_tree")}


def scenario_fields(scn):
    return (scn.scenario_id, scn.focal_track_id, scn.city_name,
            [(t.track_id, t.object_type, t.category, t.object_states) for t in scn.tracks])


def phase_closed_loop(dcfg, fa, syn, lane_w, origin):
    """150 ticks under the demo configuration, 20 plans, on the card, on the
    committed AV2 log of synthetic_av2(0): its parquet read by
    data/parquet.py must equal the scenario built in memory, field by
    field."""
    from mind_tpu_torch.config import CONFIGS, SimConfig
    from mind_tpu_torch.data.av2 import load_scenario

    seq_id = SimConfig.from_json(os.path.join(CONFIGS, "demo_1.json")).seq_id
    t = time.perf_counter()
    scenario = load_scenario(os.path.join(FIXTURE, seq_id, f"scenario_{seq_id}.parquet"))
    parquet_ms = (time.perf_counter() - t) * 1e3
    if scenario_fields(scenario) != scenario_fields(syn.scenario):
        raise RuntimeError("closed loop: the committed parquet does not read to "
                           "synthetic_av2(0)'s scenario")
    fa.reset_launch_counts()
    sim, agent, plans = run_loop("loop", dcfg, 1.0, LOOP_TICKS, None, FIXTURE, seed=None)
    counts = dict(fa.fused_edge_attention.launches_by_variant)
    rounds = sum(r["rounds"] for r in plans)
    if len(plans) != 20:
        raise RuntimeError(f"closed loop: {len(plans)} plans, expected 20")
    if counts["bfloat16"] != dcfg.net.n_scene_layer * rounds or counts["bfloat16"] == 0 \
            or counts["float32"] != 0:
        raise RuntimeError(f"closed loop: launches {counts} for {rounds} AIME rounds")
    ego = sim.ego_trajectory()
    enabled = ego[plans[0]["tick"]:]
    along = float(enabled[-1, 0] - enabled[0, 0])
    lateral = float(np.abs(enabled[:, 1] - origin[1]).max())   # the target lane is y = 0
    if not (np.diff(enabled[:, 0]) > 0).all() or along < 5.0 or lateral > lane_w:
        raise RuntimeError(f"closed loop: ego advanced {along:.2f} m along the lane, "
                           f"{lateral:.2f} m off it at most (lane width {lane_w})")
    trees = check_exported_trees("closed loop", sim.frames[plans[-1]["tick"]])
    m = sim.metrics
    summary = {
        "ticks": m["ticks"], "plan_calls": m["plan_calls"], "wall_s": m["wall_time_s"],
        "ticks_per_s": m["ticks"] / m["wall_time_s"],
        "share_outside_plan": 1.0 - m["plan_time_s"] / m["wall_time_s"],
        "plan_wall_ms_mean": float(np.mean([r["wall_ms"] for r in plans])),
        "plan_wall_ms_first": plans[0]["wall_ms"],
        "plan_wall_ms_steady_mean": float(np.mean([r["wall_ms"] for r in plans[1:]])),
        "phases_ms_steady_mean": {k: float(np.mean([r[k] for r in plans[1:]]))
                                  for k in ("aime", "flatten", "solve", "export")},
        "rounds": rounds, "launches": counts, "ego_advance_m": along,
        "ego_lateral_max_m": lateral, "last_plan_tree_sizes": trees,
        "tracks": len(sim.agents), "lane_segments": syn.n_graph_segments,
        "parquet_read_ms": parquet_ms,
    }
    log("[loop] " + json.dumps(summary))
    return counts["bfloat16"], summary, sim.ego_trajectory()


def probe_video(name, path, ticks):
    from mind_tpu_torch.viz.video import probe_avi

    info = probe_avi(path)
    if not (info["frames"] == info["index_entries"] == ticks and info["jpeg_ok"]
            and (info["width"], info["height"]) == (DEMO_FRAME, DEMO_FRAME)):
        raise RuntimeError(f"{name}: {path}: {info}, expected {ticks} JPEG frames of "
                           f"{DEMO_FRAME}x{DEMO_FRAME}")
    return info


def phase_demo_command(fa, loop, loop_ego, card):
    """(6b) the demo command as its users run it, on the committed log with
    rendering on: python -m mind_tpu_torch.run_sim --config <the fixture's
    configuration, its output in a temporary directory> --data-root
    tests/fixtures/av2_synthetic --max-steps 150, as a subprocess: exit code
    0, phase 6's plan count and no failed plan, an MJPEG AVI of 150 JPEG
    frames of 1200 x 1200. Then run_sim.main on the same arguments in this
    process with --no-render (drawing launches nothing on the card), the
    launch counts set to 0 just before: kernel B a positive multiple of 6
    times, kernel A never, phase 6's plan count, the ego within
    TOL_COMMAND_EGO of phase 6's; SERIAL_FRAMES of its frames drawn one
    after another, read back and JPEG-encoded, timed. Returns (kernel B's
    launches, summary)."""
    import ast
    import re

    from mind_tpu_torch import run_sim
    from mind_tpu_torch.sim.simulator import Simulator
    from mind_tpu_torch.viz import jpeg, raster, render

    cfg = json.load(open(FIXTURE_CONFIG))
    summary = {"ticks": LOOP_TICKS, "render_workers": min(cfg["num_threads"], LOOP_TICKS)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "demo_1.json")
        with open(path, "w") as f:
            json.dump(dict(cfg, output_dir=os.path.join(tmp, "out")), f)
        args = ["--config", path, "--data-root", FIXTURE, "--max-steps", str(LOOP_TICKS)]

        # the command in its own process
        cmd = [sys.executable, "-m", "mind_tpu_torch.run_sim", *args]
        log("[demo command] " + " ".join(cmd[1:]))
        torch.cuda.empty_cache()
        t = time.perf_counter()
        p = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, timeout=COMMAND_TIMEOUT_S,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        summary["command_s"] = time.perf_counter() - t
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("metrics:")]
        video = re.search(r"^video: (\S+) \((\d+) frames drawn and encoded in ([\d.]+) s\)$",
                          p.stdout, re.M)
        if p.returncode != 0 or len(lines) != 1 or video is None:
            raise RuntimeError(f"demo command: exit code {p.returncode}; stdout ends "
                               f"{p.stdout[-2000:]}")
        metrics = ast.literal_eval(lines[0][len("metrics:"):].strip())
        if metrics["ticks"] != LOOP_TICKS or metrics["plan_calls"] != loop["plan_calls"] or \
                "plan failed" in p.stdout:
            raise RuntimeError(f"demo command: {metrics} against the loop's "
                               f"{loop['plan_calls']} plans; stdout ends {p.stdout[-2000:]}")
        summary["command_ticks_per_s"] = metrics["ticks"] / metrics["wall_time_s"]
        summary["command_video"] = probe_video("demo command", video.group(1), LOOP_TICKS)
        summary["draw_and_encode_s_per_frame_pool"] = float(video.group(3)) / LOOP_TICKS

        # the same arguments through run_sim.main here: launches and trajectory
        sims = []
        run = Simulator.run_sim

        def recorded(self):
            sims.append(self)
            return run(self)

        Simulator.run_sim = recorded
        try:
            fa.reset_launch_counts()
            metrics = run_sim.main(args + ["--no-render"])
            counts = dict(fa.fused_edge_attention.launches_by_variant)
        finally:
            Simulator.run_sim = run
        (sim,) = sims
        agent = next(a for a in sim.agents if a.id == "AV")
        if metrics["plan_calls"] != loop["plan_calls"] or \
                agent.planner.metrics.counters.get("plan_failures", 0):
            raise RuntimeError(f"demo command in this process: {metrics}")
        if counts["bfloat16"] <= 0 or counts["bfloat16"] % 6 or counts["float32"]:
            raise RuntimeError(f"demo command: kernel launches {counts}")
        ego = sim.ego_trajectory()
        gap = float(np.abs(ego - loop_ego).max()) if ego.shape == loop_ego.shape else np.inf
        if not gap <= TOL_COMMAND_EGO:
            raise RuntimeError(f"demo command: ego {ego.shape} against the loop's "
                               f"{loop_ego.shape}, {gap} m apart (limit {TOL_COMMAND_EGO})")
        summary.update(launches=counts, ego_gap_m=gap,
                       ego_bit_equal=bool(np.array_equal(ego, loop_ego)))
        # frames of this run drawn one after another, read back, encoded
        frames = np.linspace(0, LOOP_TICKS - 1, SERIAL_FRAMES).astype(int)
        t = time.perf_counter()
        for i in frames:
            render.render_png(sim, int(i), tmp)
        summary["render_s_per_frame_serial"] = (time.perf_counter() - t) / len(frames)
        t = time.perf_counter()
        rgb = [raster.read_png(os.path.join(tmp, f"frame_{i:03d}.png"))[..., :3] for i in frames]
        summary["png_read_ms_per_frame"] = (time.perf_counter() - t) / len(frames) * 1e3
        t = time.perf_counter()
        for x in rgb:
            jpeg.encode_jpeg(x, 85)
        summary["jpeg_encode_ms_per_frame"] = (time.perf_counter() - t) / len(frames) * 1e3
    summary["parquet_read_ms"] = loop["parquet_read_ms"]
    summary["card"] = card
    log("[demo command] " + json.dumps(summary))
    log(f"[demo command] parquet read {loop['parquet_read_ms']:.2f} ms; render "
        f"{summary['render_s_per_frame_serial']:.3f} s a frame serial; drawn and encoded "
        f"{summary['draw_and_encode_s_per_frame_pool']:.3f} s a frame with "
        f"{summary['render_workers']} workers; JPEG encode "
        f"{summary['jpeg_encode_ms_per_frame']:.1f} ms a frame; the command "
        f"{summary['command_ticks_per_s']:.2f} ticks/s ({card})")
    return counts["bfloat16"], summary


def phase_float32_loop(cfg, fa, data_root):
    """36 ticks under the float32 defaults on the card (kernel A) and on the
    CPU (plain version): the same trees, ego within TOL_LOOP_EGO."""
    fa.reset_launch_counts()
    sim, _, plans = run_loop("loop32", cfg, 0.2, 36, None, data_root)
    counts = dict(fa.fused_edge_attention.launches_by_variant)
    rounds = sum(r["rounds"] for r in plans)
    if len(plans) != 5 or counts["float32"] != cfg.net.n_scene_layer * rounds \
            or counts["float32"] == 0 or counts["bfloat16"] != 0:
        raise RuntimeError(f"float32 loop: {len(plans)} plans, launches {counts} for "
                           f"{rounds} AIME rounds")
    t = time.perf_counter()
    sim_cpu, _, plans_cpu = run_loop("loop32-cpu", cfg, 0.2, 36, "cpu", data_root)
    cpu_s = time.perf_counter() - t
    if fa.fused_edge_attention.launches != counts["float32"]:
        raise RuntimeError("the CPU loop launched a kernel")
    gap = float(np.abs(sim.ego_trajectory() - sim_cpu.ego_trajectory()).max())
    same = [a["tick"] == b["tick"] and a["tree"] == b["tree"] for a, b in zip(plans, plans_cpu)]
    summary = {"plans": len(plans), "ego_gap_m": gap, "same_tree": same,
               "launches": counts, "cpu_loop_s": cpu_s,
               "plan_wall_ms": [r["wall_ms"] for r in plans]}
    log("[loop32] " + json.dumps(summary))
    if len(plans_cpu) != len(plans) or not all(same) or not gap < TOL_LOOP_EGO:
        raise RuntimeError(f"float32 loop: card and CPU disagree: {summary}")
    return counts["float32"], summary


def phase_exec_resolve(float32_cfg, data_root):
    """One plan each: float32 selection + float64 polish, + float64 scratch,
    and a pure float64 solve of the same scene (the pipeline stays float32,
    so all three grow the same scenario trees)."""
    out = {}
    for mode, solve, exec_dtype in (("float64", "float64", None), ("polish", "float32", "float64"),
                                    ("scratch", "float32", "float64"),
                                    ("native", "float32", "float64")):
        cfg = float32_cfg()
        cfg.traj_tree.solve_dtype = solve
        cfg.traj_tree.exec_solve_dtype = exec_dtype
        cfg.traj_tree.exec_resolve_mode = mode if exec_dtype else "polish"
        _, _, plans = run_loop(f"exec-{mode}", cfg, 0.2, 16, None, data_root)
        if len(plans) != 1:
            raise RuntimeError(f"exec re-solve {mode}: {len(plans)} plans, expected 1")
        out[mode] = plans[0]
    ref = np.array(out["float64"]["ctrl"])
    summary = {}
    for mode, tol in (("polish", TOL_POLISH), ("scratch", TOL_SCRATCH)):
        r = out[mode]
        gap = float(np.abs(np.array(r["ctrl"]) - ref).max())
        summary[mode] = {"exec_resolve_ms": r.get("exec_resolve"), "solve_ms": r["solve"],
                         "ctrl": r["ctrl"], "gap_to_float64": gap, "tolerance": tol}
        if r["tree"] != out["float64"]["tree"] or not gap < tol or not r.get("exec_resolve"):
            raise RuntimeError(f"exec re-solve {mode}: {summary[mode]} against the float64 "
                               f"solve {out['float64']}")
    r = out["native"]
    gap = float(np.abs(np.array(r["ctrl"]) - np.array(out["scratch"]["ctrl"])).max())
    summary["native"] = {"exec_native_ms": r.get("exec_native"), "solve_ms": r["solve"],
                         "ctrl": r["ctrl"], "gap_to_scratch": gap, "tolerance": TOL_NATIVE}
    if r["tree"] != out["scratch"]["tree"] or not gap < TOL_NATIVE or not r.get("exec_native") \
            or "exec_resolve" in r:
        raise RuntimeError(f"exec re-solve native: {summary['native']} against the scratch "
                           f"re-solve {out['scratch']}")
    summary["float64"] = {"solve_ms": out["float64"]["solve"], "ctrl": out["float64"]["ctrl"]}
    log("[exec] " + json.dumps(summary))
    return summary


class RoundCounter:
    """aime_grow_tree as fused_plan_core calls it, summing the AIME rounds
    of every call."""

    def __init__(self, fn):
        self.fn, self.rounds = fn, 0

    def __call__(self, *a, **kw):
        state, meta, rounds = self.fn(*a, **kw)
        self.rounds += rounds
        return state, meta, rounds


def phase_episode(dcfg, fa, data_root, loop_ego, loop_plans):
    """run_episode_timed on the closed loop's scenario and configuration
    (150 ticks, planner enabled after 1 s) against that loop's trajectory;
    then run_episode_segmented against the timed run. The launch counts are
    set to 0 just before run_episode_timed, which drives the episode twice
    (a warm call, then the timed one), and read just after."""
    from mind_tpu_torch.planner import planner as tplanner
    from mind_tpu_torch.sim import episode

    sim = loop_sim(dcfg, 1.0, 150, data_root)
    counter = RoundCounter(tplanner.aime_grow_tree)
    tplanner.aime_grow_tree = counter
    phases = []
    try:
        fa.reset_launch_counts()
        t = time.perf_counter()
        res, wall = episode.run_episode_timed(sim, phases=phases)
        both_s = time.perf_counter() - t
        counts = dict(fa.fused_edge_attention.launches_by_variant)
    finally:
        tplanner.aime_grow_tree = counter.fn
    planning = [p for p in phases if "solve" in p]
    timed_rounds = sum(p["rounds"] for p in planning)
    gap = (float(np.abs(res.ego_states[:, :2] - loop_ego[:, :2]).max())
           if res.ego_states.shape == loop_ego.shape else float("inf"))
    split = {k: float(np.mean([p[k] * 1e3 for p in planning]))
             for k in ("obs", "aime", "cost_topology", "solve", "selection", "propagate")}
    idle = [p for p in phases if "solve" not in p]
    summary = {
        "ticks": len(res.ego_states), "plan_calls": res.plan_calls, "fail_cycle": res.fail_cycle,
        "loop_plan_calls": loop_plans, "ego_gap_to_loop_m": gap, "wall_s": wall,
        "warm_wall_s": both_s - wall, "ticks_per_s": len(res.ego_states) / wall,
        "planning_cycle_ms_mean": float(np.mean([sum(p[k] for k in split) * 1e3
                                                 for p in planning])),
        "phases_ms_mean_planning_cycle": split,
        "non_planning_cycle_ms_mean": float(np.mean([(p["obs"] + p["propagate"]) * 1e3
                                                     for p in idle])),
        "rounds_timed_call": timed_rounds, "rounds_both_calls": counter.rounds,
        "launches": counts, "iterations": res.iterations[res.planned].tolist()}
    log("[episode] " + json.dumps(summary))
    layers = dcfg.net.n_scene_layer
    if res.fail_cycle != -1 or res.plan_calls != loop_plans or not gap < TOL_EPISODE_EGO:
        raise RuntimeError(f"episode disagrees with the closed loop: {summary}")
    if counts["bfloat16"] != layers * counter.rounds or counts["float32"] != 0 \
            or counter.rounds == 0 or counter.rounds != 2 * timed_rounds:
        raise RuntimeError(f"episode: launches {counts} for {counter.rounds} AIME rounds")
    seg = episode.run_episode_segmented(sim, seg_cycles=4)
    same = {f: bool(np.array_equal(getattr(seg, f), getattr(res, f)))
            for f in ("ego_states", "plan_ok", "planned", "iterations", "controls")}
    log(f"[episode] segmented (4-cycle segments) equal to the timed run: {same}")
    if not all(same.values()) or seg.fail_cycle != res.fail_cycle:
        raise RuntimeError(f"segmented episode differs from the whole one: {same}")
    summary["segmented_equal"] = True
    return counts["bfloat16"], summary


def lane_trees(phases, lane):
    """The tree a lane selected at each planning cycle, from the phase
    records of run_episode (one lane) or of a batched run."""
    return {p["cycle"]: p["best"][lane] for p in phases if "best" in p}


def first_decision(got, want, got_trees, want_trees):
    """The first cycle at which a lane of a batched run and the same
    scenario or copy run alone take a different discrete decision: plan or
    not, plan ok, solver iteration count, selected tree. None if none."""
    for c in range(min(len(got.planned), len(want.planned))):
        a = (bool(got.planned[c]), bool(got.plan_ok[c]), float(got.iterations[c]),
             got_trees.get(c))
        b = (bool(want.planned[c]), bool(want.plan_ok[c]), float(want.iterations[c]),
             want_trees.get(c))
        if a != b:
            return {"cycle": c, "batched": a, "alone": b,
                    "control_gap": float(np.abs(got.controls[c] - want.controls[c]).max())}
    return None


def against_single(got, want, got_trees, want_trees):
    """A lane of a batched run against the same scenario or copy run alone:
    the failing cycles, plan counts, the ego's largest gap over the whole
    run, the first cycle at which the two take a different discrete
    decision (None if none) and whether all of it holds: the same failing
    cycle and plan count, and the ego within TOL_EPISODE_EGO."""
    diff = (np.abs(got.ego_states[:, :2] - want.ego_states[:, :2])
            if got.ego_states.shape == want.ego_states.shape else None)
    gap = float(diff.max()) if diff is not None else float("inf")
    return {"fail_cycle": [got.fail_cycle, want.fail_cycle],
            "plan_calls": [got.plan_calls, want.plan_calls], "ego_gap_m": gap,
            "first_decision_differing": first_decision(got, want, got_trees, want_trees),
            "ok": got.fail_cycle == want.fail_cycle and got.plan_calls == want.plan_calls
            and gap < TOL_EPISODE_EGO}


def hold_against_singles(name, recs):
    """Raise unless every record of against_single holds."""
    bad = {i: r for i, r in recs.items() if not r["ok"]}
    if bad:
        raise RuntimeError(f"{name}: batched runs and runs alone disagree: {bad}")


def network_batch_gap(net, inputs, B):
    """The network's outputs (cls, positions, velocities) for each scene's
    B nodes in a batched forward, as AIME makes it, against the same nodes
    alone, on the inputs of one batched call."""
    from mind_tpu_torch.common import batch_invariant

    S = inputs[0].shape[0] // B
    with torch.no_grad():
        with batch_invariant.scenes(S):
            whole = net(*inputs)
        return [[float((w[s * B:(s + 1) * B][..., :2] if k == 1 else w[s * B:(s + 1) * B])
                       .sub(a[..., :2] if k == 1 else a).abs().max())
                 for k, (w, a) in enumerate(zip(whole, net(*(x[s * B:(s + 1) * B]
                                                               for x in inputs))))]
                for s in range(S)]


def graph_pool_in_use():
    """(bytes, sizes of the live blocks) allocated in the iLQR graphs'
    shared memory pool: a graph that kept a tensor of its own there, or a
    capture that allocated a cuBLAS workspace there, would show here."""
    from mind_tpu_torch.planner import ilqr

    pool = ilqr._GRAPHS.pool
    segs = torch.cuda.memory_snapshot()
    if pool is None or not segs or "segment_pool_id" not in segs[0]:
        raise RuntimeError("no graph pool, or the memory snapshot names no pool")
    mine = [seg for seg in segs if tuple(seg["segment_pool_id"]) == tuple(pool)]
    return (sum(seg["allocated_size"] for seg in mine),
            [b["size"] for seg in mine for b in seg["blocks"] if b["state"] == "active_allocated"])


def phase_batched_episode(dcfg, fa, data_root):
    """run_episodes_batched over 4 synthetic AV2 scenarios (seeds 0-3, the AV
    asked for 8, 7, 9 and 6 m/s, so that the scenes' cost parameters
    differ; planner on after 1 s, 150 ticks), a warm call then the timed
    one, the launch counts set to 0 just before and read just after; each
    scenario then held against its own run_episode."""
    from mind_tpu_torch.planner import planner as tplanner
    from mind_tpu_torch.sim import episode

    speeds = (8.0, 7.0, 9.0, 6.0)
    sims = [loop_sim(dcfg, 1.0, 150, data_root, seed, v) for seed, v in enumerate(speeds)]
    counter = RoundCounter(tplanner.aime_grow_tree)
    tplanner.aime_grow_tree = counter
    phases, first_call = [], []
    net = sims[0].agents[[a.id for a in sims[0].agents].index("AV")].planner.net
    hook = net.register_forward_pre_hook(
        lambda m, args: first_call.append(args) if not first_call else None)
    try:
        fa.reset_launch_counts()
        t = time.perf_counter()
        episode.run_episodes_batched(sims)
        warm_s = time.perf_counter() - t
        t = time.perf_counter()
        res = episode.run_episodes_batched(sims, phases=phases)
        wall = time.perf_counter() - t
        counts = dict(fa.fused_edge_attention.launches_by_variant)
    finally:
        tplanner.aime_grow_tree = counter.fn
        hook.remove()
    pool_bytes, pool_blocks = graph_pool_in_use()
    planning = [p for p in phases if "solve" in p]
    timed_rounds = sum(p["rounds"] for p in planning)
    split = {k: float(np.mean([p[k] * 1e3 for p in planning]))
             for k in ("obs", "aime", "cost_topology", "solve", "selection", "propagate")}
    summary = {
        "scenes": len(sims), "target_velocities": speeds, "wall_s": wall, "warm_wall_s": warm_s,
        "scene_ticks_per_s": sum(len(r.ego_states) for r in res) / wall,
        "plan_calls": [r.plan_calls for r in res], "fail_cycle": [r.fail_cycle for r in res],
        "planning_cycle_ms_mean": float(np.mean([sum(p[k] for k in split) * 1e3
                                                 for p in planning])),
        "phases_ms_mean_planning_cycle": split, "rounds_timed_call": timed_rounds,
        "rounds_both_calls": counter.rounds, "launches": counts,
        "graph_pool_live_bytes": pool_bytes, "graph_pool_live_blocks": pool_blocks}
    log("[batched] " + json.dumps(summary))
    layers = dcfg.net.n_scene_layer
    if counts["bfloat16"] != layers * counter.rounds or counts["float32"] != 0 \
            or counter.rounds == 0 or counter.rounds != 2 * timed_rounds:
        raise RuntimeError(f"batched episode: launches {counts} for {counter.rounds} AIME rounds")
    if pool_bytes != 0:
        raise RuntimeError(f"the iLQR graphs hold {pool_bytes} bytes of tensors in their pool")
    summary["network_batch_gap"] = network_batch_gap(net, first_call[0],
                                                     dcfg.scen_tree.max_branch_nodes)
    log("[batched] network outputs of each scene's nodes in the batch against alone "
        "(cls, positions m, velocities): " + json.dumps(summary["network_batch_gap"]))
    if any(g != 0.0 for gaps in summary["network_batch_gap"] for g in gaps):
        raise RuntimeError("a scene's network outputs in the batch differ from alone")
    singles = {}
    for i, (sim, r) in enumerate(zip(sims, res)):
        if not np.isfinite(r.ego_states).all() or r.plan_calls == 0:
            raise RuntimeError(f"batched episode: scenario {i} planned {r.plan_calls} times, "
                               "or its ego is not finite")
        alone = []
        want = episode.run_episode(sim, phases=alone)
        singles[i] = against_single(r, want, lane_trees(phases, i), lane_trees(alone, 0))
    summary["against_run_episode"] = singles
    log("[batched] each scenario against its run_episode: " + json.dumps(singles))
    hold_against_singles("batched episode", singles)
    return counts["bfloat16"], summary


def phase_monte_carlo(dcfg, fa, data_root, k=16):
    """run_episode_monte_carlo on the loop's scenario (seed 0) under the demo
    configuration: k = 16 copies in one chunk, segments of 10 cycles, a warm
    call then the timed one with the launch counts set to 0 just before and
    read just after, and the peak device memory of the timed chunk; then
    segments of 4 (equal to the bit) and two copies through run_episode on
    their own schedules (within TOL_EPISODE_EGO)."""
    from mind_tpu_torch.planner import planner as tplanner
    from mind_tpu_torch.sim import episode

    sim = loop_sim(dcfg, 1.0, 150, data_root)
    counter = RoundCounter(tplanner.aime_grow_tree)
    tplanner.aime_grow_tree = counter
    walls = []
    try:
        fa.reset_launch_counts()
        episode.run_episode_monte_carlo(sim, k=k, chunk=k, seg_cycles=10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        phases = []
        res = episode.run_episode_monte_carlo(sim, k=k, chunk=k, seg_cycles=10, chunk_walls=walls,
                                              phases=phases)
        wall = time.perf_counter() - t
        counts = dict(fa.fused_edge_attention.launches_by_variant)
    finally:
        tplanner.aime_grow_tree = counter.fn
    peak = torch.cuda.max_memory_allocated()
    failed = [i for i, r in enumerate(res) if r.fail_cycle >= 0]
    summary = {"copies": len(res), "wall_s": wall, "chunk_walls": walls,
               "copy_ticks_per_s": sum(len(r.ego_states) for r in res) / wall,
               "copy_ticks_per_s_full_horizon": k * 150 / wall,
               "failed_copies": len(failed), "fail_cycles": [res[i].fail_cycle for i in failed],
               "plan_calls": [r.plan_calls for r in res], "peak_memory_gb": peak / 1e9,
               "rounds_both_calls": counter.rounds, "launches": counts}
    log("[monte_carlo] " + json.dumps(summary))
    if len(res) != k or not all(np.isfinite(r.ego_states).all() for r in res):
        raise RuntimeError(f"monte carlo: {len(res)} copies, or a copy's states are not finite")
    if counts["bfloat16"] != dcfg.net.n_scene_layer * counter.rounds or counts["float32"] != 0 \
            or counter.rounds == 0:
        raise RuntimeError(f"monte carlo: launches {counts} for {counter.rounds} AIME rounds")
    seg = episode.run_episode_monte_carlo(sim, k=k, chunk=k, seg_cycles=4)
    for i, (a, b) in enumerate(zip(seg, res)):
        for f in ("ego_states", "plan_ok", "planned", "iterations", "controls"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise RuntimeError(f"monte carlo: copy {i}'s {f} differs between segments of "
                                   "4 and of 10 cycles")
    summary["segments_4_equal_10"] = True
    inp = episode.build_mc_inputs(sim, k)
    singles = {}
    for i in (0, k - 1):
        alone = []
        want = episode.run_episode(sim, inputs=episode.lane_inputs(inp, i), phases=alone)
        singles[i] = against_single(res[i], want, lane_trees(phases, i), lane_trees(alone, 0))
    summary["against_run_episode"] = singles
    log("[monte_carlo] segments of 4 equal to 10; copies against run_episode: "
        + json.dumps(singles))
    hold_against_singles("monte carlo", singles)
    return counts["bfloat16"], summary


def phase_tree_scale():
    """parallel_tree_solve on make_tree_batch at the JAX package's scale-test
    sizes (1024 branching trees of up to 24 of 32 cost nodes, 24 levels,
    width 4, 4 exo agents; 10 iterations) on a one-device mesh, a first
    call that captures, then the timed one; held against 4 slices of 256
    solved alone: us within 1e-4, J within 1e-5 relative."""
    from mind_tpu_torch.parallel.mesh import make_mesh
    from mind_tpu_torch.parallel.scale import make_tree_batch, parallel_tree_solve
    from mind_tpu_torch.planner.ilqr import ILQRConfig, TreeTopology
    from mind_tpu_torch.ops.potential import NodeCostData

    mesh = make_mesh(1)
    topo, nodes, params, x0 = make_tree_batch(1024, 24, 32, 24, 4, 4, device=mesh.devices[0])
    cfg = ILQRConfig(max_iterations=10)
    parallel_tree_solve(mesh, topo, nodes, params, x0, cfg)
    torch.cuda.synchronize()
    t = time.perf_counter()
    us, J = parallel_tree_solve(mesh, topo, nodes, params, x0, cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    gaps = []
    for lo in range(0, 1024, 256):
        cut = lambda x: x[lo:lo + 256]
        us_s, J_s = parallel_tree_solve(mesh, TreeTopology(*map(cut, topo)),
                                        NodeCostData(*map(cut, nodes)), params, cut(x0), cfg)
        gaps.append((float((us_s - us[lo:lo + 256]).abs().max()),
                     float(((J_s - J[lo:lo + 256]).abs() / J[lo:lo + 256].abs()).max())))
    summary = {"trees": 1024, "ms": ms, "finite": bool(torch.isfinite(us).all()
                                                       and torch.isfinite(J).all()),
               "slice_gaps_us_J_rel": gaps}
    log("[scale] " + json.dumps(summary))
    if not summary["finite"] or max(g[0] for g in gaps) >= 1e-4 or max(g[1] for g in gaps) >= 1e-5:
        raise RuntimeError(f"tree scale: {summary}")
    return summary



def grad_gaps(names, got, want, exempt_unused, noise, zero=()):
    """Per parameter: relative-norm gap of `got` against `want` (lists of
    gradients or None, in `names` order). The unused parameters must have
    none in both; the shift-invariant ones (exact gradient zero) must be
    rounding noise in both, below 1e-6 of the whole gradient's norm; those
    in `zero` exactly zero in both; every other one must be there, not all
    zero, and within TOL_GRAD. Returns {name: gap} of the compared ones;
    raises on any failure."""
    total = sum(float(w.double().pow(2).sum()) for w in want if w is not None) ** 0.5
    gaps, bad = {}, {}
    for name, g, w in zip(names, got, want):
        if name in exempt_unused:
            if g is not None or w is not None:
                bad[name] = "unused, yet has a gradient"
        elif g is None or w is None:
            bad[name] = "no gradient"
        elif name in noise:
            if max(float(g.float().norm()), float(w.float().norm())) >= 1e-6 * total:
                bad[name] = "exact gradient zero, yet above rounding noise"
        elif name in zero:
            if bool(g.any()) or bool(w.any()):
                bad[name] = "expected all zero: no scene trains mode 0"
        elif not bool(g.any()):
            bad[name] = "all-zero gradient"
        else:
            gaps[name] = float((g.float() - w.float()).norm() / w.float().norm())
            if not gaps[name] <= TOL_GRAD:
                bad[name] = f"gap {gaps[name]:.3e}"
    if bad:
        raise RuntimeError(f"gradients disagree: {dict(list(bad.items())[:12])} "
                           f"({len(bad)} parameters)")
    return gaps


def bf16_call_grads(fa, dev):
    """(c) Kernel B at one call (B = 8, N = 129, bf16 weights, a bf16 node
    and edge as the first layer gets them), update_edge on and off: the
    gradients of every input through the Function against autograd through
    the bf16 plain version, on the card."""
    from mind_tpu_torch.synthetic import fusion_inputs

    bf16 = torch.bfloat16
    w, node, edge = fusion_inputs(8, 129, 128, dev, SEED + 1)
    mask = torch.ones(8, 129, dtype=torch.bool, device=dev)
    mask[:, 40:48] = False
    w = fa.FusionWeights(*(t.to(bf16).requires_grad_() for t in w))
    node, edge = node.to(bf16).requires_grad_(), edge.to(bf16).requires_grad_()
    inputs, names = (node, edge, *w), ("node", "edge", *fa.FusionWeights._fields)
    out = {}
    for ue in (True, False):
        runs = []
        for core in (fa.fused_edge_attention, fa.fused_edge_attention_bf16_ref):
            before = fa.fused_edge_attention.launches_by_variant["bfloat16"]
            o, e = core(node, edge, mask, w, 8, ue)
            loss = (o ** 2).mean() + (e * e.detach().cos()).mean()
            runs.append((fa.fused_edge_attention.launches_by_variant["bfloat16"] - before,
                         torch.autograd.grad(loss, inputs, allow_unused=True)))
        (n_fn, got), (n_ref, want) = runs
        if (n_fn, n_ref) != (1, 0):
            raise RuntimeError(f"bf16 gradient check: {n_fn} and {n_ref} launches, 1 and 0 expected")
        unused = set() if ue else {"we", "be", "ln_e1_g", "ln_e1_b", "ln_e2_g", "ln_e2_b"}
        gaps = grad_gaps(names, got, want, unused, ("bk",))   # the key bias: exact gradient 0
        out[f"update_edge_{str(ue).lower()}"] = max(gaps.values())
    log(f"[train] kernel B, one call at B = 8: largest gradient gap {out}")
    return out


def training_batch(cfg, dev, synthetic_av2):
    """Four synthetic AV2 scenarios (seeds 0-3) through the data layer and
    scenario_to_batch, on `dev`: the training batch of the four demos."""
    from mind_tpu_torch.data.loader import ArgoAgentLoader
    from mind_tpu_torch.data.semantic_map import SemanticMap
    from mind_tpu_torch.models.data_pipeline import stack_batches
    from mind_tpu_torch.synthetic import write_synthetic_map
    from mind_tpu_torch.train_weights import scene_batch

    scenes = []
    with tempfile.TemporaryDirectory() as root:
        for seed in range(4):
            syn = synthetic_av2(seed)
            smp = SemanticMap().load_from_argo2(
                write_synthetic_map(syn.map_json, root, f"{SEQ_ID}-{seed}"))
            scenes.append(scene_batch(smp, ArgoAgentLoader.trajs_info_of(syn.scenario, smp),
                                      cfg, dev))
    return stack_batches(scenes)


def phase_training(fa, dev, synthetic_av2):
    """14. Train PlannerConfig()'s float32 network on four synthetic
    scenarios: checks (a)-(f) of the module docstring, and the timed steps.
    Returns (kernel A's launches in the 20 steps, summary)."""
    from mind_tpu_torch.config import PlannerConfig
    from mind_tpu_torch.models import checkpoint as ckpt
    from mind_tpu_torch.models import scene_pred, train
    from mind_tpu_torch.models.weights import unused_edge_params
    from mind_tpu_torch.synthetic import fusion_inputs

    cfg = PlannerConfig()
    t0 = time.perf_counter()
    batch = training_batch(cfg, dev, synthetic_av2)
    B = batch.actors.shape[0]
    summary = {"scenes": B, "batch_s": time.perf_counter() - t0,
               "actors": batch.actor_mask.sum(1).tolist(),
               "lanes": batch.lane_mask.sum(1).tolist(),
               "targets": int(batch.gt_mask.sum())}
    summary["kernel_b_grad_gap"] = bf16_call_grads(fa, dev)

    # (b) the whole network's gradients, kernel Function against plain
    net = train.init_scene_pred(cfg.net, seed=0, device=dev)
    names, params = zip(*net.named_parameters())
    exempt, noise = set(unused_edge_params(cfg.net)), set(train.shift_invariant_params(cfg.net))

    branch = [n for n in names if n.startswith(TARGET_BRANCH)]
    branch_params = [p for n, p in zip(names, params) if n in branch]

    def grads(core):
        """The scene loss's gradients, and the target branch's of the
        same loss with mode 0 as every scene's winner (scene_loss over
        mode 0 alone)."""
        scene_pred.fused_edge_attention = core
        try:
            cls_prob, reg, _ = net(*batch[:7])
            loss = train.scene_loss(cls_prob, reg, batch.gt_pos, batch.gt_mask).mean()
            loss_mode0 = train.scene_loss(cls_prob[..., :1], reg[..., :1, :, :],
                                          batch.gt_pos, batch.gt_mask).mean()
            modes = train.winning_modes(reg.detach(), batch.gt_pos, batch.gt_mask)
            return (float(loss.detach()), modes.tolist(),
                    torch.autograd.grad(loss, params, allow_unused=True, retain_graph=True),
                    torch.autograd.grad(loss_mode0, branch_params))
        finally:
            scene_pred.fused_edge_attention = fa.fused_edge_attention

    fa.reset_launch_counts()
    loss_fn, modes, g_fn, g0_fn = grads(fa.fused_edge_attention)
    one_forward = dict(fa.fused_edge_attention.launches_by_variant)
    loss_plain, modes_plain, g_plain, g0_plain = grads(fa.fused_edge_attention_ref)
    if one_forward != {"float32": cfg.net.n_scene_layer, "bfloat16": 0} or \
            fa.fused_edge_attention.launches != cfg.net.n_scene_layer:
        raise RuntimeError(f"(a) one training forward launched {one_forward}, the plain "
                           f"one {fa.fused_edge_attention.launches} in all")
    if modes != modes_plain:
        raise RuntimeError(f"(b) winning modes {modes} against plain {modes_plain}")
    # the target lane enters mode 0 only: its branch learns from no scene
    # whose winning mode is another
    target = set() if 0 in modes else set(branch)
    gaps = grad_gaps(names, g_fn, g_plain, exempt, noise, target)
    # the branch's gradients where mode 0 wins every scene
    branch_gaps = grad_gaps(branch, g0_fn, g0_plain, set(), set())
    if len(branch_gaps) != 12:
        raise RuntimeError(f"(b) {len(branch_gaps)} target-branch tensors compared")
    fusion = [n for n in gaps if ".RelaFusionLayer_" in n and n.rsplit(".", 1)[1]
              in scene_pred._FUSION_PARAMS.values()]
    if len(fusion) != 20 * cfg.net.n_scene_layer - len(exempt) - cfg.net.n_scene_layer:
        raise RuntimeError(f"(b) {len(fusion)} fusion-core tensors compared")
    summary["grad_vs_plain"] = {
        "loss": [loss_fn, loss_plain], "winning_modes": modes,
        "target_branch_zero": len(target), "tensors": len(gaps), "max_gap": max(gaps.values()),
        "target_branch_mode0_tensors": len(branch_gaps),
        "target_branch_mode0_max_gap": max(branch_gaps.values()),
        "fusion_core_tensors": len(fusion), "fusion_core_max_gap": max(gaps[n] for n in fusion),
        "largest": sorted(gaps.items(), key=lambda kv: -kv[1])[:3]}
    log("[train] (b) gradients, kernel Function against plain: "
        + json.dumps(summary["grad_vs_plain"]))
    del g_plain, g0_fn, g0_plain

    # (e) the same two steps on the CPU
    cpu = torch.device("cpu")
    t = time.perf_counter()
    net_cpu = train.init_scene_pred(cfg.net, seed=0, device=cpu)
    step_cpu = train.make_train_step(net_cpu, train.adamw(net_cpu.parameters(), TRAIN_LR))
    batch_cpu = batch.to(cpu)
    cpu_losses = [float(step_cpu(batch_cpu))]
    g_cpu = [None if n in exempt else p.grad.clone() for n, p in net_cpu.named_parameters()]
    cpu_losses.append(float(step_cpu(batch_cpu)))
    summary["cpu_two_steps_s"] = time.perf_counter() - t
    cpu_gaps = grad_gaps(names, [g.cpu() if g is not None else None for g in g_fn], g_cpu,
                         exempt, noise, target)
    del net_cpu, step_cpu, batch_cpu, g_cpu, g_fn

    # (d) 20 steps, the launch counts set to 0 just before and read just after
    optimizer = train.adamw(net.parameters(), TRAIN_LR)
    step = train.make_train_step(net, optimizer)
    losses, times, events = [], {}, []
    vjp = fa.fused_edge_attention_vjp

    def timed_vjp(*a, **kw):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = vjp(*a, **kw)
        e.record()
        events.append((s, e))
        return out

    fa.reset_launch_counts()
    try:
        for i in range(TRAIN_STEPS):
            if i == TRAIN_WARM:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                fa.fused_edge_attention_vjp = timed_vjp
            losses.append(step(batch, times=times if i >= TRAIN_WARM else None))
    finally:
        fa.fused_edge_attention_vjp = vjp
    torch.cuda.synchronize()
    launches = dict(fa.fused_edge_attention.launches_by_variant)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    timed = TRAIN_STEPS - TRAIN_WARM
    ms = {k: v * 1e3 / timed for k, v in times.items()}
    recompute_ms = sum(s.elapsed_time(e) for s, e in events) / timed
    with torch.no_grad():
        w, node, edge = fusion_inputs(B, 129, 128, dev, SEED)
        mask = torch.ones(B, 129, dtype=torch.bool, device=dev)
        kernel_ms = [cuda_time_ms(lambda: fa.fused_edge_attention(node, edge, mask, w, 8, ue))
                     for ue in (True, False)]
        del w, node, edge
    kernel_fwd_ms = (cfg.net.n_scene_layer - 1) * kernel_ms[0] + kernel_ms[1]
    step_ms = sum(ms.values())
    summary.update({
        "losses": losses, "cpu_losses": cpu_losses,
        "cpu_gap": {"loss": [abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)],
                    "grad_max": max(cpu_gaps.values()),
                    "largest": sorted(cpu_gaps.items(), key=lambda kv: -kv[1])[:5]},
        "launches": launches, "timed_steps": timed,
        "step_ms": step_ms, "ms": ms, "scenes_per_s": B * 1e3 / step_ms,
        "peak_memory_gb": peak / 1e9,
        "recompute_ms": recompute_ms, "recompute_share_of_backward":
            recompute_ms / ms["backward"],
        "recomputes_per_step": len(events) / timed,
        "kernel_a_forward_ms_6_layers": kernel_fwd_ms,
        "kernel_a_ms_per_call": kernel_ms})
    log("[train] " + json.dumps({k: summary[k] for k in (
        "losses", "cpu_losses", "cpu_gap", "launches", "step_ms", "ms", "scenes_per_s",
        "peak_memory_gb", "recompute_ms", "recompute_share_of_backward",
        "kernel_a_forward_ms_6_layers")}))
    if launches != {"float32": cfg.net.n_scene_layer * TRAIN_STEPS, "bfloat16": 0}:
        raise RuntimeError(f"(a) {launches} launches in {TRAIN_STEPS} training steps")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError(f"(d) losses not finite or not falling: {losses}")
    if not all(g <= TOL_TRAIN_LOSS for g in summary["cpu_gap"]["loss"]):
        raise RuntimeError(f"(e) card and CPU losses disagree: {summary['cpu_gap']}")
    if len(events) != cfg.net.n_scene_layer * timed:
        raise RuntimeError(f"{len(events)} plain recomputes in {timed} backward passes")

    # (f) save -> restore -> one step, against one step without the round
    # trip; only here are cuDNN's algorithms held to deterministic ones, so
    # that two runs of a step can be equal to the bit
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as d:
            ckpt.save_params(d, net, step=TRAIN_STEPS, opt_state=optimizer)
            loss_on = step(batch)
            net2 = train.init_scene_pred(cfg.net, seed=1, device=dev)
            net2.load_state_dict(ckpt.load_params(d, net2))
            opt2 = ckpt.load_opt_state(d, train.adamw(net2.parameters(), TRAIN_LR))
            loss_back = train.make_train_step(net2, opt2)(batch)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same = torch.equal(loss_on, loss_back) and all(
        torch.equal(a, b) for a, b in zip(net.state_dict().values(), net2.state_dict().values()))
    summary["restore_equal"] = same
    log(f"[train] (f) restored step equal to the continued one, to the bit: {same}")
    if not same:
        raise RuntimeError(f"(f) restored step differs: loss {float(loss_back)} against "
                           f"{float(loss_on)}")
    del net, net2, optimizer, opt2, batch
    torch.cuda.empty_cache()
    summary["seconds"] = time.perf_counter() - t0
    return launches["float32"], summary


def phase_probe():
    """The card's health probe (utils/device_health.py): a 128x128 bf16
    product in a fresh subprocess, within its timeout."""
    from mind_tpu_torch.utils import device_health

    t = time.perf_counter()
    ok = device_health.probe_once()
    log(f"[probe] device_health.probe_once() = {ok} in {time.perf_counter() - t:.2f} s")
    if not ok:
        raise RuntimeError("the device health probe failed")
    return time.perf_counter() - t


class CallCounter:
    """A function or method, counting its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)

    def __get__(self, obj, objtype=None):     # bind like the method it wraps
        return self if obj is None else lambda *a, **kw: self(obj, *a, **kw)


def phase_host_tree(cfg, net, scene, aime, scene_statics, fa, dev):
    """ScenarioTreeGenerator.branch_aime (host bookkeeping, planner/
    scenario_tree.py) against aime_grow_tree, both on the card, from the
    same filled window of the float32 path's scene, with the checks of
    tests/test_aime.py:70-119: the same number of trees, the same multiset
    of (duration, norm_prob rounded to 1e-4), root-child trajectories within
    2e-3 m; kernel A launched 6 times per round of the host generator (the
    counts set to 0 just before branch_aime and read just after)."""
    from mind_tpu_torch.planner.scenario_tree import ScenarioTreeGenerator

    pdt = getattr(torch, cfg.pipeline_dtype)
    buf = fill_buffer(aime, scene, pdt, dev)
    statics = scene_statics(scene, pdt, dev)
    types = torch.tensor(scene.types, device=dev)
    amask = torch.tensor(scene.present, device=dev)
    pos, ang, vel, obs = aime.nn_fill_window(buf)
    cov = torch.full(obs.shape, 1e-5, dtype=torch.float64, device=dev)
    counted = CallCounter(net)
    gen = ScenarioTreeGenerator(cfg, counted, statics.lane, statics.tgt, cfg.max_actors)
    fa.reset_launch_counts()
    t = time.perf_counter()
    host_trees = gen.branch_aime((pos, ang, vel, cov, obs), types, amask)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    counts = dict(fa.fused_edge_attention.launches_by_variant)
    rounds = counted.calls
    t = time.perf_counter()
    state, meta, dev_rounds = aime.aime_grow_tree(net, cfg, *aime.scene_axis(
        buf, types, amask, statics.lane, statics.tgt))
    end = meta.end_flag[0].cpu().numpy().copy()
    device_s = time.perf_counter() - t
    end[0] = False   # the root, which the host trees do not hold
    tid, dur = meta.tree_id[0].cpu().numpy(), meta.duration[0].cpu().numpy()
    nprob, depth = meta.norm_prob[0].cpu().numpy(), state.depth[0].cpu().numpy()
    dev_nodes = sorted((int(dur[i]), round(float(nprob[i]), 4)) for i in np.flatnonzero(end))
    host_nodes = sorted((nd.data[1].shape[1], round(float(nd.data[0]), 4))
                        for tr in host_trees for nd in tr.nodes.values())
    host_rc = {(tr.get_root().data[1].shape[1], round(float(tr.get_root().data[0]), 4)):
               tr.get_root().data[1] for tr in host_trees}
    gap = 0.0
    for i in np.flatnonzero(end & (depth == 1)):
        key = (int(dur[i]), round(float(nprob[i]), 4))
        if key not in host_rc:
            gap = float("inf")
            break
        d = int(dur[i])
        gap = max(gap, float(np.abs(state.slots.pos[0, i, :, OBS:OBS + d].cpu().numpy()
                                    - host_rc[key]).max(initial=0.0)))
    n_dev_trees = len({int(x) for x in tid if x >= 0})
    summary = {"trees": len(host_trees), "device_trees": n_dev_trees,
               "nodes": len(host_nodes), "device_nodes": len(dev_nodes), "rounds": rounds,
               "device_rounds": dev_rounds, "root_child_gap_m": gap, "launches": counts,
               "host_generator_s": host_s, "device_aime_s": device_s}
    log("[host tree] " + json.dumps(summary))
    if not host_trees or n_dev_trees != len(host_trees) or dev_nodes != host_nodes \
            or not gap <= TOL_HOST_TREE:
        raise RuntimeError(f"host tree generator disagrees with aime_grow_tree: {summary}")
    if counts["float32"] != cfg.net.n_scene_layer * rounds or counts["bfloat16"] or rounds == 0:
        raise RuntimeError(f"host tree: launches {counts} for {rounds} rounds")
    return counts["float32"], summary


def phase_parity(dcfg, fa, data_root, syn):
    """The float64 mirror (parity/host_planner.py) against the port's planner
    on the closed loop's scenario under planner_config_for_demo("demo_1")
    (bf16 network, trained weights), the mirror sharing the planner's
    network on the card: run_parity_episode_playback (150 ticks, planner on
    after 1 s) and run_parity_demo_resync (demo_1's enable time of 4 s,
    RESYNC_TICKS ticks). Each must show zero ok flips and a mean cycle
    deviation within 1e-3 m, and kernel B launched 6 times per AIME round
    and per mirror forward, kernel A never (counts set to 0 just before
    each run, read just after)."""
    from mind_tpu_torch.parity import host_planner
    from mind_tpu_torch.parity import runner
    from mind_tpu_torch.planner import planner as tplanner

    layers = dcfg.net.n_scene_layer
    out = {}
    for name, run in (
            ("parity_playback", lambda: runner.run_parity_episode_playback(
                "demo_1", 150, data_root, enable_timestep=1.0, scenario=syn.scenario)),
            ("parity_resync", lambda: runner.run_parity_demo_resync(
                "demo_1", RESYNC_TICKS, data_root, scenario=syn.scenario))):
        rounds = RoundCounter(tplanner.aime_grow_tree)
        forwards = CallCounter(host_planner.HostRefPlanner._predict)
        tplanner.aime_grow_tree = rounds
        host_planner.HostRefPlanner._predict = forwards
        try:
            fa.reset_launch_counts()
            t = time.perf_counter()
            r = run()
            wall = time.perf_counter() - t
            counts = dict(fa.fused_edge_attention.launches_by_variant)
        finally:
            tplanner.aime_grow_tree = rounds.fn
            host_planner.HostRefPlanner._predict = forwards.fn
        plans = len(r["records"]) if "records" in r else r["plans"]
        summary = {k: r[k] for k in ("plans_compared", "ok_mismatches", "max_cycle_dev",
                                     "mean_cycle_dev", "max_ctrl_dev")}
        summary.update(plans=plans, device_rounds=rounds.rounds,
                       mirror_forwards=forwards.calls, launches=counts, wall_s=wall)
        if name == "parity_playback":
            summary.update(episode_wall_s=r["episode_wall_s"], mirror_wall_s=r["mirror_wall_s"],
                           mirror_s_per_plan=r["mirror_wall_s"] / max(plans, 1),
                           fail_cycle=r["fail_cycle"])
        else:
            summary.update(ticks=r["ticks"], host_failures=r["host_failures"])
        log(f"[{name}] " + json.dumps(summary))
        if r["ok_mismatches"] or not r["plans_compared"] or \
                not r["mean_cycle_dev"] <= TOL_PARITY_MEAN or r["plans_compared"] != plans:
            raise RuntimeError(f"{name}: parity criterion failed: {summary}")
        if name == "parity_resync" and plans < 5:
            raise RuntimeError(f"{name}: {plans} plans, fewer than 5")
        launched = layers * (rounds.rounds + forwards.calls)
        if counts["bfloat16"] != launched or counts["float32"] or not rounds.rounds \
                or not forwards.calls:
            raise RuntimeError(f"{name}: launches {counts} for {rounds.rounds} AIME rounds and "
                               f"{forwards.calls} mirror forwards")
        out[name] = (counts["bfloat16"], summary)
    return out


# the benchmark twin's run (python -m mind_tpu_torch.bench): every section but
# the Monte-Carlo sweep, which phase 12 drives; 250 ticks with the planner on
# at 4 s give each demo 10 plans
BENCH_SECTIONS = ("per_demo_episode", "phase_split", "batched_episode", "host_loop_demo_1")
BENCH_STEPS, BENCH_PLANS = 250, 10
BENCH_BUDGET_S = 420
# the section each one's result stands under in the final line's detail
BENCH_DETAIL = {"per_demo_episode": "per_demo_episode", "phase_split": "phase_mean_ms",
                "batched_episode": "batched_episode", "host_loop_demo_1": "host_loop_demo_1"}
# the JAX package's bench.py final line: its keys, and its detail's keys
# (the twin adds device and kernel_launches)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
BENCH_DETAIL_KEYS = {"per_demo_episode", "batched_episode", "monte_carlo_episode",
                     "host_loop_demo_1", "phase_mean_ms", "mfu", "net_flops_per_fwd_b8",
                     "wall_s_total", "window_accounting", "device", "kernel_launches"}


def positive(x):
    return isinstance(x, (int, float)) and np.isfinite(x) and x > 0


def phase_bench():
    """(bench) python -m mind_tpu_torch.bench --synthetic --steps 250 over
    BENCH_SECTIONS in a subprocess (its own CUDA context; the twin counts
    each section's kernel launches from 0), with its final line's checks,
    each fatal: exit code 0; the final line parses with bench.py's keys and
    the twin's; every section present without an error; every demo with
    10 plans and no failed cycle, the batched run's scenes without one, the
    host loop with 10 plans; every time and rate finite and positive;
    0 < MFU < 1; in every section kernel B launched 6 times per network
    forward (a positive multiple of 6) and kernel A never; no CUDA graph
    captured in a demo's timed run. Returns ({variant: launches
    over the sections}, {"final": the final line, "wall_s": seconds})."""
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "mind_tpu_torch.bench", "--synthetic", "--steps",
           str(BENCH_STEPS), "--sections", ",".join(BENCH_SECTIONS)]
    log("[bench] " + " ".join(cmd[1:]))
    t = time.perf_counter()
    p = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, timeout=BENCH_BUDGET_S + 60,
                       env={**os.environ, "MIND_TPU_BENCH_BUDGET_S": str(BENCH_BUDGET_S)})
    wall = time.perf_counter() - t
    lines = p.stdout.strip().splitlines()
    if p.returncode != 0 or not lines:
        raise RuntimeError(f"bench: exit code {p.returncode}; stdout ends {p.stdout[-2000:]}")
    final = json.loads(lines[-1])
    detail = final["detail"]
    if set(final) != BENCH_KEYS or set(detail) != BENCH_DETAIL_KEYS:
        raise RuntimeError(f"bench: final line keys {sorted(final)}, detail {sorted(detail)}")
    bad = {s: detail[BENCH_DETAIL[s]] for s in BENCH_SECTIONS
           if "error" in detail[BENCH_DETAIL[s]]}
    if bad:
        raise RuntimeError(f"bench: sections failed: {bad}")
    rows = detail["per_demo_episode"]
    batched, host, split = (detail[k] for k in ("batched_episode", "host_loop_demo_1",
                                                  "phase_mean_ms"))
    if sorted(rows) != ["demo_1", "demo_2", "demo_3", "demo_4"] or any(
            r["fail_cycle"] != -1 or r["plan_calls"] != BENCH_PLANS for r in rows.values()) \
            or batched["fail_cycles"] != [-1] * 4 or host["plan_calls"] != BENCH_PLANS:
        raise RuntimeError(f"bench: failed cycles or plan counts: {rows}, batched "
                           f"{batched['fail_cycles']}, host loop {host['plan_calls']}")
    times = [final["value"], *(r[k] for r in rows.values() for k in ("steps_per_s", "wall_s")),
             batched["agg_steps_per_s"], batched["wall_s"], host["steps_per_s"], host["wall_s"],
             *host["phase_mean_ms"].values(), split["net_flops_per_fwd"],
             *(v for k, v in split.items() if k.endswith("_ms"))]
    if not all(positive(x) for x in times) or not 0 < detail["mfu"] < 1:
        raise RuntimeError(f"bench: a time or rate is not finite and positive, or the MFU "
                           f"{detail['mfu']} is not in (0, 1): {times}")
    captures = {d: (r["graph_captures_warm"], r["graph_captures"]) for d, r in rows.items()}
    log(f"[bench] CUDA graph captures (warm run, timed run) by demo: {json.dumps(captures)}")
    if any(timed != 0 for _, timed in captures.values()):
        raise RuntimeError(f"bench: a timed run captured CUDA graphs: {captures}")
    launches = detail["kernel_launches"]
    if sorted(launches) != sorted(BENCH_SECTIONS) or any(
            n["float32"] != 0 or n["bfloat16"] <= 0 or n["bfloat16"] % 6
            for n in launches.values()):
        raise RuntimeError(f"bench: kernel launches by section {launches}")
    log(f"[bench] {wall:.1f} s of command; launches by section {json.dumps(launches)}")
    return ({v: sum(n[v] for n in launches.values()) for v in ("float32", "bfloat16")},
            {"final": final, "wall_s": wall})


# (scripts): the modules of mind_tpu_torch/scripts/ on synthetic scenes, 215
# ticks with the planner on at 4 s (3 plans a demo; at 250 ticks and 50
# bench_fusion forwards a path the phase took 195 s on an H100, at 230 ticks
# and 10 forwards 108-130 s)
SCRIPTS_STEPS, SCRIPTS_PLANS = 215, 3
SCRIPTS_FUSION_REPS = 10
SCRIPTS_TIMEOUT_S = 300


def demo_launches(name, n):
    """Launches by the demo configuration's drivers: kernel B a positive
    multiple of 6 (6 fusion layers per forward), kernel A never."""
    if n["float32"] != 0 or n["bfloat16"] <= 0 or n["bfloat16"] % 6:
        raise RuntimeError(f"scripts {name}: kernel launches {n}")


def add_launches(total, n):
    for v in total:
        total[v] += n[v]


def read_json(path):
    with open(path) as f:
        return json.load(f)


def run_driver(fa, name, main, argv):
    """One driver's main(argv) in this process, the launch counts set to 0
    just before and read just after; exit code 0 or raise. Returns (its
    launches by variant, seconds)."""
    log(f"[scripts] {name} " + " ".join(argv))
    fa.reset_launch_counts()
    t = time.perf_counter()
    rc = main(argv)
    wall = time.perf_counter() - t
    n = dict(fa.fused_edge_attention.launches_by_variant)
    if rc != 0:
        raise RuntimeError(f"scripts {name}: exit code {rc}")
    return n, wall


def phase_scripts(fa):
    """(scripts) the drivers' main([...]) in this process on synthetic_av2
    scenes at 215 ticks, outputs in a temporary directory, each check
    fatal: run_all_demos (both modes, demos 1 and 2; and its episode mode
    once more as a subprocess, the CLI itself) PASS with 3 plans a demo and
    the report written; parity_run's free run of demo_1 under native_bal,
    its log fed to bench_north_star (demo_1): finite rows, the verdict
    printed, not held; bench_strict (demo_1): no failed cycle and
    run_all_demos' float32 plan count; bench_exec_ab: the five variants with
    finite rates and no failed cycle; bench_forward_split in bf16 and
    float32 and bench_fusion (10 forwards a window): the variant's kernel
    launched 6 times per FusionNet pass, the other never, kernel against plain within
    TOL_NET_CLS / TOL_NET_POS; diag_playback (demo_1, 3 worst cycles): the
    JAX field names, finite deviations. Every run of the demo configuration
    launches kernel B in multiples of 6 and kernel A never, and its counts
    equal the launches its rows record. Returns ({variant: launches}, summary)."""
    import contextlib

    from mind_tpu_torch import parity_run
    from mind_tpu_torch.scripts import (bench_exec_ab, bench_forward_split, bench_fusion,
                                        bench_north_star, bench_strict, diag_playback,
                                        run_all_demos)

    t_phase = time.perf_counter()
    total = {"float32": 0, "bfloat16": 0}
    summary = {"seconds": {}}
    steps = ["--steps", str(SCRIPTS_STEPS), "--synthetic"]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = lambda name: os.path.join(tmp, name)

        def driver(name, mod, argv):
            n, wall = run_driver(fa, name, mod.main, argv)
            summary["seconds"][name] = wall
            add_launches(total, n)
            return n

        # run_all_demos: both modes in this process, the episode mode as a CLI
        n = driver("run_all_demos", run_all_demos, [
            "--mode", "both", "--demos", "1,2", *steps, "--json-out", out("host.json"),
            "--episode-json", out("episode.json"), "--report", out("DEMOS.md")])
        demo_launches("run_all_demos", n)
        ep_rows = read_json(out("episode.json"))["rows"]
        rows = read_json(out("host.json"))
        report = open(out("DEMOS.md")).read()
        for mode, rs in (("episode", ep_rows), ("host", rows)):
            if [r["demo"] for r in rs] != ["demo_1", "demo_2"] or any(
                    r["ticks"] != SCRIPTS_STEPS or r["plan_calls"] != SCRIPTS_PLANS
                    or r["plan_failures"] or not positive(r["steps_per_sec"]) for r in rs):
                raise RuntimeError(f"scripts run_all_demos: {mode} rows {rs}")
        if "**Result: PASS**" not in report or "## Fused-episode mode" not in report:
            raise RuntimeError(f"scripts run_all_demos: report {report[:2000]}")
        row_n = {v: sum(r["launches"][v] for r in ep_rows + rows) for v in total}
        if row_n != n:
            raise RuntimeError(f"scripts run_all_demos: rows record {row_n}, counted {n}")
        summary["run_all_demos"] = {"episode": ep_rows, "host": rows}
        cmd = [sys.executable, "-m", "mind_tpu_torch.scripts.run_all_demos", "--mode",
               "episode", "--demos", "1", *steps, "--episode-json", out("cli.json")]
        log("[scripts] " + " ".join(cmd[1:]))
        t = time.perf_counter()
        p = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, timeout=SCRIPTS_TIMEOUT_S)
        summary["seconds"]["run_all_demos_cli"] = time.perf_counter() - t
        (cli,) = read_json(out("cli.json"))["rows"] if p.returncode == 0 else (None,)
        if p.returncode != 0 or "EPISODE DEMOS PASS" not in p.stdout or \
                cli["plan_calls"] != SCRIPTS_PLANS:
            raise RuntimeError(f"scripts run_all_demos CLI: exit code {p.returncode}, "
                               f"stdout ends {p.stdout[-2000:]}")
        demo_launches("run_all_demos CLI", cli["launches"])
        add_launches(total, cli["launches"])

        # the north star: native_bal's free-run parity, then its throughput
        fa.reset_launch_counts()
        t = time.perf_counter()
        with open(out("free.log"), "w") as f, contextlib.redirect_stdout(f):
            parity_run.main(["--demos", "1", "--skip", "playback", "resync", "--free-modes",
                             "native_bal", "--synthetic"])
        summary["seconds"]["parity_run_free"] = time.perf_counter() - t
        n = dict(fa.fused_edge_attention.launches_by_variant)
        demo_launches("parity_run", n)
        add_launches(total, n)
        n = driver("bench_north_star", bench_north_star, [
            "--policy", "native_bal", "--demos", "1", *steps, "--free-log", out("free.log"),
            "--out", out("north_star.json")])
        demo_launches("bench_north_star", n)
        ns = read_json(out("north_star.json"))
        (thr,), free = ns["throughput"], ns.get("free_run", [])
        if thr["plan_calls"] != SCRIPTS_PLANS or not positive(thr["steps_per_sec"]) or \
                len(free) != 1 or not np.isfinite(free[0]["max_dev_cl"]) or \
                thr["launches"] != n:
            raise RuntimeError(f"scripts bench_north_star: {ns}")
        summary["north_star"] = {k: ns[k] for k in (
            "worst_steps_per_sec", "worst_vs_baseline", "throughput_ok_50x", "parity_ok_1e3",
            "north_star")}
        summary["north_star"].update(free_run_max_dev_cl=free[0]["max_dev_cl"],
                                     phase_mean_ms=thr["phase_mean_ms"])

        # strict float64 against the float32 episode of run_all_demos
        n = driver("bench_strict", bench_strict, ["--demos", "1", *steps,
                                                  "--out", out("strict.json")])
        demo_launches("bench_strict", n)
        (strict,) = read_json(out("strict.json"))["per_demo"]
        if strict["fail_cycle"] != -1 or strict["plan_calls"] != ep_rows[0]["plan_calls"] or \
                not positive(strict["steps_per_s"]) or strict["launches"] != n:
            raise RuntimeError(f"scripts bench_strict: {strict}, float32 {ep_rows[0]}")
        summary["strict"] = dict(strict, float32_steps_per_s=ep_rows[0]["steps_per_sec"])

        # the precision-policy matrix
        n = driver("bench_exec_ab", bench_exec_ab, [*steps, "--out", out("exec_ab.json")])
        demo_launches("bench_exec_ab", n)
        ab = read_json(out("exec_ab.json"))
        names = [v[0] for v in bench_exec_ab.VARIANTS]
        if sorted(ab) != sorted(names) or any(
                r["fail_cycle"] != -1 or r["plan_calls"] != SCRIPTS_PLANS
                or not positive(r["steps_per_s"]) for r in ab.values()) or \
                {v: sum(r["launches"][v] for r in ab.values()) for v in total} != n:
            raise RuntimeError(f"scripts bench_exec_ab: {ab}")
        summary["exec_ab"] = ab

        # the forward split in both variants, and the kernel against the plain core
        for dtype, variant, other in (("bfloat16", "bfloat16", "float32"),
                                      ("float32", "float32", "bfloat16")):
            name = f"bench_forward_split_{dtype}"
            n = driver(name, bench_forward_split, ["--compute-dtype", dtype,
                                                   "--out", out(name + ".json")])
            r = read_json(out(name + ".json"))
            gap = r["kernel_vs_plain"]
            if n[variant] != 6 * r["fusion_passes"] or not r["fusion_passes"] or n[other] or \
                    r["launches"] != n or not gap["cls_prob"] < TOL_NET_CLS or \
                    not gap["positions_m"] < TOL_NET_POS or not positive(r["full_fwd_ms"]):
                raise RuntimeError(f"scripts {name}: launches {n}, {r}")
            summary[name] = r
        n = driver("bench_fusion", bench_fusion, ["--reps", str(SCRIPTS_FUSION_REPS),
                                                  "--out", out("fusion.json")])
        r = read_json(out("fusion.json"))
        gap = r["kernel_vs_plain"]
        if n != {"float32": 6 * r["kernel_forwards"], "bfloat16": 0} or r["launches"] != n or \
                not gap["cls_prob"] < TOL_NET_CLS or not gap["positions_m"] < TOL_NET_POS:
            raise RuntimeError(f"scripts bench_fusion: launches {n}, {r}")
        summary["bench_fusion"] = r

        # the playback parity's stage-by-stage dump
        n = driver("diag_playback", diag_playback, [
            "--demo", "demo_1", *steps, "--worst", "3", "--out", out("diag.json")])
        demo_launches("diag_playback", n)
        diag = read_json(out("diag.json"))
        fields = ("cycle", "cycle_dev", "ctrl_dev", "n_trees_dev", "n_trees_host",
                  "n_end_nodes_dev", "n_end_nodes_host", "best_dev", "best_host",
                  "selection_margin_dev", "selection_margin_host")
        if not diag["worst"] or any(k not in r for r in diag["worst"] for k in fields) or \
                not all(np.isfinite(r["cycle_dev"]) and np.isfinite(r["ctrl_dev"])
                        for r in diag["worst"]) or diag["launches"] != n:
            raise RuntimeError(f"scripts diag_playback: {json.dumps(diag)[:3000]}")
        summary["diag_playback"] = {"fail_cycle": diag["fail_cycle"],
                                    "worst": [{k: r[k] for k in fields} for r in diag["worst"]]}
    summary["launches"] = dict(total)
    summary["seconds"]["phase"] = time.perf_counter() - t_phase
    log("[scripts] " + json.dumps(summary))
    return total, summary


# (dist): the Monte-Carlo sweep of phase 12's scenario under the demo
# configuration, K copies in chunks of DIST_PER_RANK copies per rank, over
# DIST_TICKS ticks; phase 13's tree batch; DIST_TRAIN_STEPS float32 training
# steps of phase 14's batch (2 scenes per rank)
DIST_RANKS, DIST_K, DIST_PER_RANK, DIST_TICKS = 2, 8, 2, 100
DIST_TRAIN_STEPS = 5
DIST_TIMEOUT_S = 600


def dist_jobs(spec, net_cfg, batch):
    """The rank workloads of (dist) (mind_tpu_torch/parallel/dryrun.py)."""
    return [("collectives_on_device", {}),
            ("monte_carlo", dict(spec=spec, k=DIST_K, chunk=DIST_PER_RANK, seg_cycles=10)),
            ("tree_solve", dict(n_trees=1024, n_nodes=24, max_nodes=32, max_levels=24,
                                max_width=4, n_exo=4, max_iterations=10, timed=True)),
            ("train", dict(net_cfg=net_cfg, batch=batch, steps=DIST_TRAIN_STEPS,
                           lr=TRAIN_LR, deterministic_cudnn=True))]


def dist_sequential(fa, mesh, spec, net_cfg, batch, dev):
    """The same three workloads on a sequential mesh in this process: the
    Monte-Carlo sweep timed with its launch counts, the tree solve (a first
    call that captures, then the timed one), and the training steps under
    deterministic cuDNN (as the ranks run them)."""
    from mind_tpu_torch.models import train
    from mind_tpu_torch.parallel.scale import make_tree_batch, parallel_tree_solve
    from mind_tpu_torch.planner.ilqr import ILQRConfig
    from mind_tpu_torch.sim.episode import run_episode_monte_carlo

    out = {}
    sim = spec.build(dev)
    walls = []
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t = time.perf_counter()
    out["results"] = run_episode_monte_carlo(sim, k=DIST_K, chunk=DIST_PER_RANK, seg_cycles=10,
                                             mesh=mesh, chunk_walls=walls)
    torch.cuda.synchronize()
    out.update(wall_s=time.perf_counter() - t, chunk_walls=walls,
               launches=dict(fa.fused_edge_attention.launches_by_variant))
    del sim
    tree = make_tree_batch(1024, 24, 32, 24, 4, 4, device=mesh.devices[0])
    solve = lambda: parallel_tree_solve(mesh, *tree, ILQRConfig(max_iterations=10))
    solve()
    torch.cuda.synchronize()
    t = time.perf_counter()
    us, J = solve()
    torch.cuda.synchronize()
    out.update(tree_ms=(time.perf_counter() - t) * 1e3, us=us.cpu(), J=J.cpu())
    torch.backends.cudnn.deterministic = True
    try:
        net = train.init_scene_pred(net_cfg, 0, dev)
        step = train.make_train_step(net, train.adamw(net.parameters(), TRAIN_LR), mesh=mesh)
        b = batch.to(dev)
        out["losses"] = [step(b).item() for _ in range(DIST_TRAIN_STEPS)]
    finally:
        torch.backends.cudnn.deterministic = False
    out["params"] = {k: p.detach().cpu() for k, p in net.named_parameters()}
    return out


def hold_dist(label, ranks, seq):
    """Each rank's copies, trees and training equal to the sequential
    mesh's, to the bit, and the parameters equal across ranks; kernel B
    launched by the ranks' sweeps as often as by the sequential one (the
    same shards), 6 per AIME round, kernel A never; kernel A 6 times per
    training forward, B never. Returns the summary of the comparison."""
    for r, rank in enumerate(ranks):
        mc, tree, tr = rank["monte_carlo"], rank["tree_solve"], rank["train"]
        if len(mc["results"]) != DIST_K:
            raise RuntimeError(f"{label}: rank {r} holds {len(mc['results'])} copies")
        for i, (a, b) in enumerate(zip(mc["results"], seq["results"])):
            for f in ("ego_states", "plan_ok", "planned", "iterations", "controls"):
                if not np.array_equal(getattr(a, f), getattr(b, f)):
                    raise RuntimeError(f"{label}: rank {r}'s copy {i} {f} differs from the "
                                       "sequential mesh's")
            if (a.fail_cycle, a.plan_calls) != (b.fail_cycle, b.plan_calls):
                raise RuntimeError(f"{label}: rank {r}'s copy {i} fails or plans otherwise")
        if not (torch.equal(tree["us"], seq["us"]) and torch.equal(tree["J"], seq["J"])):
            raise RuntimeError(f"{label}: rank {r}'s tree solve differs from the sequential one")
        if tr["losses"] != seq["losses"] or any(not torch.equal(tr["params"][k], v)
                                                for k, v in seq["params"].items()):
            raise RuntimeError(f"{label}: rank {r}'s training differs from the sequential "
                               f"mesh's: losses {tr['losses']} against {seq['losses']}")
        if not all(np.isfinite(x.ego_states).all() for x in mc["results"]):
            raise RuntimeError(f"{label}: a copy's states are not finite")
        n = mc["launches"]
        if n["float32"] != 0 or n["bfloat16"] <= 0 or n["bfloat16"] % 6 or \
                tr["launches"] != {"float32": 6 * DIST_TRAIN_STEPS, "bfloat16": 0}:
            raise RuntimeError(f"{label}: rank {r}'s launches: sweep {n}, training "
                               f"{tr['launches']}")
    total = sum(rank["monte_carlo"]["launches"]["bfloat16"] for rank in ranks)
    if total != seq["launches"]["bfloat16"] or seq["launches"]["float32"] != 0:
        raise RuntimeError(f"{label}: the ranks launched kernel B {total} times, the "
                           f"sequential sweep {seq['launches']}")
    ticks = DIST_K * DIST_TICKS
    rank_wall = max(rank["monte_carlo"]["wall_s"] for rank in ranks)
    last = lambda walls: (walls[-1][1] - walls[-1][0]) * DIST_TICKS / walls[-1][2]
    return {"sweep_wall_s": {"ranks": rank_wall, "one_process": seq["wall_s"]},
            "copy_ticks_per_s": {"ranks": ticks / rank_wall, "one_process": ticks / seq["wall_s"]},
            "last_chunk_copy_ticks_per_s": {
                "ranks": min(last(rank["monte_carlo"]["chunk_walls"]) for rank in ranks),
                "one_process": last(seq["chunk_walls"])},
            "chunk_walls_s": {"ranks": [[w[2] for w in rank["monte_carlo"]["chunk_walls"]]
                                        for rank in ranks],
                              "one_process": [w[2] for w in seq["chunk_walls"]]},
            "rank_build_s": [rank["monte_carlo"]["build_s"] for rank in ranks],
            "tree_ms": {"ranks": ranks[0]["tree_solve"]["ms"], "one_process": seq["tree_ms"]},
            "train_step_ms_per_rank": [{k: 1e3 * v / rank["train"]["timed_steps"]
                                        for k, v in rank["train"]["times"].items()}
                                       for rank in ranks],
            "rank_job_s": [rank["seconds"] for rank in ranks],
            "train_losses": seq["losses"],
            "launches_by_rank": [{"monte_carlo": rank["monte_carlo"]["launches"],
                                  "train": rank["train"]["launches"]} for rank in ranks],
            "one_process_launches": seq["launches"]}


def phase_dist(dcfg, fa, synthetic_av2):
    """(dist) the shards run at the same time, one process per shard
    (parallel/launch.py): (a)-(c) two ranks on the one card (gloo) run the
    Monte-Carlo sweep, the 1024-tree solve (2 x 512) and 5 training steps,
    each held to the bit against the sequential two-shard mesh here; (c)
    also one rank on nccl (the whole batch) against the unsharded step; (d)
    with two cards or more, one rank per card on nccl against the
    sequential mesh across the two cards. Returns ({variant: the ranks'
    launches}, summary)."""
    from mind_tpu_torch.config import PlannerConfig
    from mind_tpu_torch.parallel.launch import launch
    from mind_tpu_torch.parallel.mesh import make_mesh
    from mind_tpu_torch.synthetic import demo_spec

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = PlannerConfig()
    batch = training_batch(cfg, torch.device("cpu"), synthetic_av2)
    target = "mind_tpu_torch.parallel.dryrun:workloads"
    summary = {}
    launches = {"float32": 0, "bfloat16": 0}
    with tempfile.TemporaryDirectory() as data_root:
        spec = demo_spec("demo_1", SEED, data_root, ticks=DIST_TICKS, planner_cfg=dcfg,
                         enable_timestep=1.0, target_velocity=TARGET_VELOCITY)
        jobs = dist_jobs(spec, cfg.net, batch)
        torch.cuda.empty_cache()
        t, t_epoch = time.perf_counter(), time.time()
        ranks = launch(target, DIST_RANKS, args=(jobs,), ranks_per_card=DIST_RANKS,
                       timeout=DIST_TIMEOUT_S)
        summary["launch_s"] = time.perf_counter() - t
        summary["rank_start_s"] = [rank["seconds"]["start"] - t_epoch for rank in ranks]
        seq = dist_sequential(fa, make_mesh(DIST_RANKS, device=dev), spec, cfg.net, batch, dev)
        summary["gloo_on_the_card"] = ranks[0]["collectives_on_device"]
        summary["one_card"] = hold_dist("dist (a)-(c)", ranks, seq)
        for rank in ranks:
            for job in ("monte_carlo", "train"):
                for v, n in rank[job]["launches"].items():
                    launches[v] += n
        # (c) nccl: one rank, the whole batch, against the unsharded step
        t = time.perf_counter()
        train_job = [j for j in jobs if j[0] == "train"]
        nccl = launch(target, 1, args=(train_job,), backend="nccl", timeout=DIST_TIMEOUT_S)[0]
        summary["nccl_launch_s"] = time.perf_counter() - t
        from mind_tpu_torch.models import train

        torch.backends.cudnn.deterministic = True
        try:
            net = train.init_scene_pred(cfg.net, 0, dev)
            step = train.make_train_step(net, train.adamw(net.parameters(), TRAIN_LR))
            b = batch.to(dev)
            want = [step(b).item() for _ in range(DIST_TRAIN_STEPS)]
        finally:
            torch.backends.cudnn.deterministic = False
        if nccl["train"]["losses"] != want or any(
                not torch.equal(nccl["train"]["params"][k], p.detach().cpu())
                for k, p in net.named_parameters()):
            raise RuntimeError(f"dist (c): the nccl rank's training differs from the unsharded "
                               f"step: {nccl['train']['losses']} against {want}")
        launches["float32"] += nccl["train"]["launches"]["float32"]
        summary["nccl_train"] = {"losses": want, "launches": nccl["train"]["launches"],
                                 "step_ms": {k: 1e3 * v / nccl["train"]["timed_steps"]
                                             for k, v in nccl["train"]["times"].items()},
                                 "rank_job_s": nccl["seconds"]}
        # (d) one rank per card on nccl, and the sequential mesh across two cards
        cards = torch.cuda.device_count()
        if cards >= 2:
            t = time.perf_counter()
            ranks = launch(target, 2, args=(jobs,), timeout=DIST_TIMEOUT_S)
            summary["cards_launch_s"] = time.perf_counter() - t
            seq = dist_sequential(fa, make_mesh(2), spec, cfg.net, batch, dev)
            summary["nccl_on_the_cards"] = ranks[0]["collectives_on_device"]
            summary["two_cards"] = hold_dist("dist (d)", ranks, seq)
            for rank in ranks:
                for job in ("monte_carlo", "train"):
                    for v, n in rank[job]["launches"].items():
                        launches[v] += n
        else:
            log(f"[dist] (d) not run: {cards} CUDA device; one rank per card on nccl and the "
                "sequential mesh across cards need two")
            summary["two_cards"] = f"not run: {cards} CUDA device"
    summary["seconds"] = time.perf_counter() - t_phase
    log("[dist] " + json.dumps(summary))
    return launches, summary


def main() -> int:
    global T0, PEAKS
    T0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from mind_tpu_torch.common.kinematics import kine_propagate
    from mind_tpu_torch.config import DEFAULT_WEIGHTS, PlannerConfig, planner_config_for_demo
    from mind_tpu_torch.models import scene_pred
    from mind_tpu_torch.models.weights import load_scene_pred
    from mind_tpu_torch.ops import fusion_attention as fa
    from mind_tpu_torch.planner import aime_device as aime
    from mind_tpu_torch.planner import planner as tplanner
    from mind_tpu_torch.planner.trajectory_tree import make_cost_params
    from mind_tpu_torch.synthetic import (AV2_ORIGIN, LANE_W, scene_statics, synthetic_av2,
                                          synthetic_scene)
    from mind_tpu_torch.utils import device_specs

    PEAKS = device_specs.peaks(torch.cuda.get_device_name(0))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")
    probe_s = phase_probe()
    laps = {"probe": time.perf_counter() - T0}

    def lap(name):
        """Seconds of the phase that just ended, since the previous lap."""
        laps[name] = time.perf_counter() - T0 - sum(laps.values())
    cfg = PlannerConfig()
    A, L = cfg.max_actors, cfg.max_lanes
    scene = synthetic_scene(SEED, A, L, n_agents=40)

    # 1. build
    phase_build(fa)
    lap("build")

    # 2. kernels vs plain at the main path's shapes and token mask
    token_mask = torch.tensor(np.concatenate([scene.present, scene.lane_mask, [True]]),
                              device=dev)
    entries = phase_kernel_check(fa, dev, token_mask)
    lap("kernels")

    # 3. trained weights
    t = time.perf_counter()
    net = load_scene_pred(cfg.net, DEFAULT_WEIGHTS, dev)
    log(f"[weights] {DEFAULT_WEIGHTS.name}: {sum(p.numel() for p in net.parameters())} "
        f"parameters loaded in {time.perf_counter() - t:.3f} s")

    # 4. float32 path on the card
    mods = (tplanner, make_cost_params)
    common = (scene, mods, aime, scene_statics, kine_propagate, fa, dev)
    entries[0]["launches"], cycles32, first = run_path("plan", "float32", cfg, net, *common)
    lap("float32_path")

    # the first cycle again on the CPU, through the plain version
    out0, best0, buf0 = first
    cpu = torch.device("cpu")
    net_cpu = load_scene_pred(cfg.net, DEFAULT_WEIGHTS, cpu)
    report = {}
    t = time.perf_counter()
    out_cpu = plan_once(mods, net_cpu, cfg, World(scene),
                        aime.DeviceObsBuffer(*(t.cpu() for t in buf0)),
                        scene_statics(scene, getattr(torch, cfg.pipeline_dtype), cpu), cpu,
                        report)
    log(f"[reference] CPU plain plan: out={out_cpu.tolist()} best={int(report['best'])} "
        f"in {time.perf_counter() - t:.1f} s")
    if out_cpu[2] != out0[2] or int(report["best"]) != best0 or \
            np.abs(out_cpu[:2] - out0[:2]).max() > 1e-3:
        raise RuntimeError(f"card plan {out0} (tree {best0}) disagrees with the CPU "
                           f"plan {out_cpu} (tree {int(report['best'])})")

    # 4a. the host tree generator against the device AIME, float32 network
    host_tree_launches, host_tree = phase_host_tree(cfg, net, scene, aime, scene_statics, fa,
                                                    dev)
    lap("cpu_reference_and_host_tree")

    # 5. demo path: the bf16 network of the demo planner configuration
    dcfg = planner_config_for_demo("demo_1")
    if dcfg.net.compute_dtype != "bfloat16" or not dcfg.ckpt_path:
        raise RuntimeError("the demo configuration must ask for bf16 and trained weights")
    dnet = FirstCall(load_scene_pred(dcfg.net, dcfg.ckpt_path, dev))
    entries[1]["launches"], cycles16, _ = run_path("demo", "bfloat16", dcfg, dnet, *common)
    with torch.no_grad():
        got = dnet.net(*dnet.inputs)
        scene_pred.fused_edge_attention = fa.fused_edge_attention_bf16_ref
        try:
            want = dnet.net(*dnet.inputs)
        finally:
            scene_pred.fused_edge_attention = fa.fused_edge_attention
    torch.cuda.synchronize()
    net_err = {"cls_prob": (got[0] - want[0]).abs().max().item(),
               "positions_m": (got[1][..., :2] - want[1][..., :2]).abs().max().item(),
               "velocity": (got[2] - want[2]).abs().max().item()}
    log(f"[demo] ScenePredNet forward on the first AIME inputs, kernel vs plain: {net_err}")
    if not all(torch.isfinite(x).all() for x in got) or \
            not net_err["cls_prob"] < TOL_NET_CLS or not net_err["positions_m"] < TOL_NET_POS:
        raise RuntimeError(f"bf16 network: kernel and plain disagree: {net_err}")
    lap("demo_path")

    # 6.-10. the closed loop through Simulator / MINDAgent / MINDPlanner on the
    # synthetic AV2 scenario: phases 6 and 6b read the committed log (map and
    # parquet), the others write the map to a temporary folder and pass the
    # scenario in memory
    syn = synthetic_av2(SEED)

    def float32_cfg():
        """The float32 defaults with the trained weights."""
        c = PlannerConfig()
        c.ckpt_path = str(DEFAULT_WEIGHTS)
        return c

    loop_launches, loop, loop_ego = phase_closed_loop(dcfg, fa, syn, LANE_W, AV2_ORIGIN)
    lap("closed_loop")
    command_launches, command = phase_demo_command(fa, loop, loop_ego, card)
    lap("demo_command")
    with tempfile.TemporaryDirectory() as data_root:
        loop32_launches, loop32 = phase_float32_loop(float32_cfg(), fa, data_root)
        lap("float32_loop")
        execs = phase_exec_resolve(float32_cfg, data_root)
        lap("exec_resolve")
        graph = phase_graph_vs_eager(cfg, net, scene, aime, scene_statics, dev)
        lap("graph_vs_eager")
        episode_launches, episode = phase_episode(dcfg, fa, data_root, loop_ego,
                                                  loop["plan_calls"])
        lap("episode")
        batched_launches, batched = phase_batched_episode(dcfg, fa, data_root)
        lap("batched_episode")
        mc_launches, monte_carlo = phase_monte_carlo(dcfg, fa, data_root)
        lap("monte_carlo")
        # 12a-b. the float64 mirror against the planner, on demo_1's configuration
        # file with the loop's scenario, whose map loop_sim wrote under demo_1's seq_id
        parity = phase_parity(dcfg, fa, data_root, syn)
        lap("parity")
    scale = phase_tree_scale()
    lap("tree_scale")
    train_launches, training = phase_training(fa, dev, synthetic_av2)
    lap("training")
    bench_launches, bench = phase_bench()
    lap("bench")
    scripts_launches, scripts = phase_scripts(fa)
    lap("scripts")
    dist_launches, dist = phase_dist(dcfg, fa, synthetic_av2)
    lap("dist")
    # launches per path; "launches" stays the sum over the paths that run the kernel
    entries[0]["launches_by_path"] = {"plan_cycles": entries[0]["launches"],
                                      "host_tree": host_tree_launches,
                                      "float32_loop": loop32_launches,
                                      "training": train_launches,
                                      "bench": bench_launches["float32"],
                                      "scripts": scripts_launches["float32"],
                                      "dist": dist_launches["float32"]}
    entries[1]["launches_by_path"] = {"plan_cycles": entries[1]["launches"],
                                      "closed_loop": loop_launches,
                                      "demo_command": command_launches,
                                      "episode": episode_launches,
                                      "batched_episode": batched_launches,
                                      "monte_carlo": mc_launches,
                                      **{k: v[0] for k, v in parity.items()},
                                      "bench": bench_launches["bfloat16"],
                                      "scripts": scripts_launches["bfloat16"],
                                      "dist": dist_launches["bfloat16"]}
    for e in entries:
        e["launches"] = sum(e["launches_by_path"].values())

    # 16. report
    log("[phases] " + json.dumps({"probe_s": probe_s, "float32": cycles32,
                                  "host_tree": host_tree, "demo_bf16": cycles16,
                                  "demo_net_err": net_err, "closed_loop": loop,
                                  "demo_command": command,
                                  "float32_loop": loop32, "exec_resolve": execs,
                                  "graph_vs_eager": graph, "episode": episode,
                                  "batched_episode": batched, "monte_carlo": monte_carlo,
                                  **{k: v[1] for k, v in parity.items()},
                                  "tree_scale": scale, "training": training,
                                  "bench_wall_s": bench["wall_s"],
                                  "scripts_s": scripts["seconds"], "dist": dist,
                                  "seconds": time.perf_counter() - T0}))
    log("[phase seconds] " + json.dumps(laps))
    # the benchmark's final line, then one line per section
    log("[bench] final line: " + json.dumps(bench["final"]))
    for name in BENCH_SECTIONS:
        log(f"[bench] {name}: " + json.dumps(bench["final"]["detail"][BENCH_DETAIL[name]]))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
