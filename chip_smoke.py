"""Smoke run of the PyTorch port (mind_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure ends the run with a non-zero exit and no
result line):
  0. probe: utils/device_health.py::probe_once() (a bf16 product on the card
     in a fresh subprocess) must return True; it runs beside phase 1, and
     nothing runs on the card before it has passed;
  1. build both CUDA kernels (mind_tpu_torch/ops/csrc/fusion_attention.cu,
     float32, and fusion_attention_bf16.cu, bf16 operands on the tensor
     cores), each at the full width (D = E = 128, 8 heads) and at the six
     resident (D, E, heads) of WIDTHS_GRID, and the graph-control library
     (graph_control.cu: the condition kernel and the conditional-node calls;
     sm_90a, one nvcc per library, all side by side) from the checkout; the
     eighteen tiled shapes of WIDTHS_GRID build in a background thread:
     the [widths] networks' three beside phases 2-6b, the other fifteen,
     TILED_BUILD_CHUNK shapes at a time, from the end of the demo command
     (6b) on, so that no nvcc shares the host with its render workers; each
     library's seconds printed;
  2. hold each kernel against its plain PyTorch version at the main path's
     shapes (B = 8 AIME nodes, N = 48 + 80 + 1 = 129 tokens, D = 128) for
     both update_edge values (and both edge input types of the bf16
     variant), and time both against the card's bound (each case's median
     and spread over KERNEL_RUNS runs of 20 calls); then both at
     B = 32 against each slice of 8 alone: equal to the bit (a node
     computes in a batch of scenes what it computes alone); then the
     condition kernel against its plain version any(mask) on masks of 1 to
     1024 entries inside captured programs, and timed there;
 2b. [widths] (a)-(c): both kernels at the other widths of their domain, at
     B = 8, N = 129 up to 1024 wide, B = 2 up to 2048 and B = 1, N = 33
     above (widths_batch): every (D, E, heads) of WIDTHS_GRID (the resident
     layout's 32/32/4, 64/32/4, 48/80/3, 16/16/2, 128/64/8, 128/128/16; the
     tiled route's 256/256/8, 512/512/16, 512/256/64, 160/512/20,
     130/130/10, 72/40/6, 36/20/6, 64/64/32, 12/7/3, and past 512 wide or 64
     heads 640/640/10, 768/768/12, 1024/512/128, 512/512/512, 1376/1376/8,
     1056/1056/1056, 2048/2048/16, 1030/515/10 and 8192/256/64; the tiled
     route in pair tiles, csrc/fusion_tiled.cuh) with and without the edge
     update, kernel B on a bf16 and on a float32 edge, against the plain
     versions within the tolerances of phase 2, each case's ms, bound, share
     of the bound and error printed, and each library's route (fold, tile,
     stages, where its LayerNorms run), shared memory (its own against the
     Python mirror kernel_smem, any difference fatal), pair scratch bytes a
     call and local memory; 32 nodes against each 8 alone, equal to the bit, at
     32/32/4, 72/40/6, 256/256/8 and (N = 33) 1376/1376/8 (WIDTHS_GAP); a
     call of heads that do not divide D (48/48/5), which the JAX function
     refuses too, refused with a ValueError before any launch. It runs after
     (dist), once phase 1's background build of the tiled widths has
     finished; the networks' plan cycles (e) run after phase 6b, and the
     child of phase 7 computes their CPU forwards beside the later phases;
  3. load the trained ScenePredNet weights from the committed archive;
  4. float32 path: plan cycles of fused_plan_core at full width on a seeded
     synthetic scene (48 actor slots, 80 lane segments, 256-point target
     lane), rolling the observation window between cycles; the first cycle
     is held against the same cycle on the CPU through the plain version
     (in the child process of phase 7, which plans on this phase's window);
 4a. host tree: ScenarioTreeGenerator.branch_aime (planner/scenario_tree.py,
     the tree bookkeeping on the host; each round and the next round's
     window gather compiled programs, one replay and one read a round)
     against graphed=False (the same bodies eagerly) and aime_grow_tree on
     the same filled window, all on the card with the float32 network: the
     compiled trees and node payloads equal to the eager ones to the bit;
     against the device AIME the same number of trees, the same multiset of
     (duration, norm_prob to 1e-4), root-child trajectories within 2e-3 m;
     one host read a round outside the export (a TorchDispatchMode), every
     replay under sync debug "error"; kernel A launched only by the
     captures (2 x 6 a round program) and the eager run (6 a round),
     executed 6 times a round by the replays (counted on the device); the
     tree's seconds compiled and eager, capture seconds and peak memory
     printed;
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
     the staged path with exported trees, through the planner's compiled
     programs) under the demo configuration at full width, 150 ticks of 20
     ms with the planner enabled after 1 s: 20 plans; kernel B launched only
     by the programs' captures and executed 6 times per AIME round the
     device counted, those rounds the plans' own; per-plan wall time with
     the planner's phases, ticks per second and the share of the loop's
     wall time outside plan() are printed;
 6b. demo command: python -m mind_tpu_torch.run_sim --config <the fixture's
     demo_1_synthetic.json, its output in a temporary folder> --data-root
     tests/fixtures/av2_synthetic --max-steps 60, rendering on, as a
     subprocess: exit code 0, the plan count of phase 6's first 60 ticks
     (2), no failed plan, an MJPEG AVI of 60 JPEG frames of 1200 x 1200
     (probe_avi); then run_sim.main
     on the same arguments and --no-render in this process: kernel B
     launched a multiple of 6 times (eagerly, or by a capture) and executed
     by the programs' replays, kernel A never, the ego
     within 1e-6 m of phase 6's first 60 ticks (whether it is equal to the bit is
     printed); the parquet read ms, render seconds a frame (8 frames one
     after another here; drawn and encoded with the configuration's
     num_threads workers in the command), PNG read and JPEG encode ms a
     frame and the command's ticks/s, with the card's name and power limit;
  6c. plan programs: MINDPlanner's compiled programs (planner/programs.py:
     AIME, the staged solve and its exec re-solve, the fused plan, each one
     CUDA graph with AIME's rounds IF nodes and the iLQR loops WHILE nodes)
     against graphed=False, which runs the same bodies eagerly: cell 3's
     host loop (phase 6's compiled run, staged, and a fused one, 150 ticks)
     and 26-tick loops under the float32 network in the float32, native
     float64 exec (staged and fused) and polish float64 exec
     configurations, each equal to the bit to its eager loop (every plan's
     ok, control, selected tree, iterations, AIME rounds, the exported
     trees, the ego); every replay under set_sync_debug_mode("error"), one
     a program a plan; the host's reads of the device in one plan counted
     by a TorchDispatchMode (2 staged plus the export's and the native
     payload's, 1 fused); kernels B and A launched only by the captures and
     executed 6 times per device-counted AIME round, the condition kernel
     run by the replays, 6 kernel B nodes per round body in the AIME
     program's graph (DOT); ticks/s compiled and eager, the programs and
     their capture seconds, the weights' copy into the programs' network
     and peak memory, with the card's name and power limit;
  7. float32 loop: 36 ticks under the float32 defaults with the planner
     enabled after 0.2 s (5 plans, float32 kernel), on the card and again
     on the CPU through the plain version (that one in a child process
     started after the probe, beside the card's phases, which then plans
     phase 4's reference cycle and takes phase 14's two CPU training
     steps; this phase runs after 12c, when the child is done): ego states
     within 1e-3 m, the same tree at every plan;
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
     run_episode_segmented in 4-cycle segments equal to it to the bit (both
     eager: phases= runs the cycles eagerly);
 10a. compiled: the episode program (sim/episode.py, one CUDA graph per
     cycle with AIME's rounds IF nodes and the iLQR loops WHILE nodes,
     ops/graph_control.py) on phase 10's scenario, warm (it captures) then
     timed: every replay under torch.cuda.set_sync_debug_mode("error"),
     ego states, controls, iterations, plan_ok and planned equal to the
     bit to the eager loop's (phase 10's timed run), the ego within 1e-3 m
     of the closed loop, kernel B launched only by the
     capture and executed 6 times per AIME round the device counted, its
     nodes in the graph (DOT) 6 per round body, 4-cycle segments equal to
     the whole run; ticks/s compiled and eager, the planning cycle's
     device ms, the program's build seconds, peak memory and the card's
     busy share over one planning cycle under torch.profiler;
 11. batched episode: run_episodes_batched over four synthetic AV2 scenarios
     (seeds 0-3, the AV asked for 8, 7, 9 and 6 m/s; planner on after 1 s,
     BATCHED_TICKS ticks, demo configuration) through the compiled
     'scenarios' program, warm then timed: kernel B launched by the capture alone and
     executed 6 times per device-counted AIME round of the batch (B = 32
     nodes per round), the iLQR graphs' pool holding no tensor, each
     scenario against its own run_episode: the same failing cycle and plan
     count, the ego within 1e-3 m over the whole run; the first cycle where
     the two take a different discrete decision (plan, ok, iteration
     count), if any, is printed; and the network's outputs for each scene's
     nodes in a batched forward equal to its forward alone, to the bit;
 12. Monte-Carlo: run_episode_monte_carlo on the loop's scenario, 16 copies
     in one chunk (B = 128 nodes per round), segments of 10 cycles, through
     the compiled 'copies_seg' program, warm (50 ticks) then timed (75
     ticks), with its peak device memory: every copy finite, kernel B
     launched and executed as in 11, segments of 4 equal to it to the bit
     over the first 50 ticks, copies 0 and 15 against run_episode on their
     own schedules (as in 11);
 12a. parity playback: parity/runner.py::run_parity_episode_playback on the
     loop's scenario under the demo configuration (read from
     configs/demo_1.json; PLAYBACK_TICKS ticks, planner on after 1 s): the episode's
     recorded controls against the float64 mirror (parity/host_planner.py)
     planning from the same inputs with the planner's network on the card,
     each round's forward a compiled program of the planner's program set
     (one replay and one read a round): zero ok flips, mean per-cycle
     rollout deviation within 1e-3 m (PARITY_TRACES.md section 1); every
     mirror forward's program output equal to the bit to the eager network
     on the same inputs (checked inline, its launches counted apart);
     kernel B launched only by the captures (the episode program's, the
     forward program's: 2 x 6) and executed 6 times per AIME round and per
     forward the replays ran (counted on the device); the plans compared,
     the deviations, the mirror's seconds per plan and a forward's seconds
     compiled and eager are printed;
 12b. parity resync: run_parity_demo_resync on the same scenario (demo_1's
     4 s enable time, 230 ticks, at least 5 plans of the staged planner with
     the mirror in tandem): the same criterion and checks;
 12c. scale-out programs: MultiScenarioSim and MonteCarloSim
     (parallel/multi_scenario.py, monte_carlo.py: the JAX package's host
     loops, planning through their compiled programs, parallel/programs.py:
     the observation update and the batched plan, one CUDA graph each)
     against graphed=False, which runs the same bodies eagerly: the four
     scenes of 11 (100 ticks, 10 triggers of B = 32 nodes a round) and 16
     copies of 12's scenario (50 ticks, 10 triggers, B = 128), each a warm
     compiled run that captures, the timed compiled run (capturing nothing)
     and the eager one: every trigger's packed plan, the plan count, the
     terminations or failures and the egos at every tick equal to the bit;
     in the timed compiled runs one host read of the device per trigger and
     none per update (a TorchDispatchMode entered around those calls alone),
     every replay under sync debug "error";
     kernel B launched only by the captures and executed 6 times per
     device-counted AIME round; scene- and copy-ticks/s compiled and eager,
     the programs' capture seconds and condition-kernel runs, the peak
     memory at K = 16 and (one trigger with its capture) at K = 64, with
     the card's name and power limit;
 13. tree scale: parallel_tree_solve of 1024 random branching trees on a
     one-device mesh through its compiled program (the whole solve one CUDA
     graph, the iterations a WHILE node) against graphed=False (a replayed
     iteration and a host read per iteration): us, J and the iteration
     counts equal to the bit, both timed, the timed compiled call capturing
     nothing and reading nothing; then four slices of 256 solved alone;
 14. training: PlannerConfig()'s float32 network at full width from
     init_scene_pred(seed=0), one batch of four synthetic AV2 scenarios
     (seeds 0-3) through the data layer and scenario_to_batch, AdamW(3e-4):
     (a) kernel A launched 6 times per training forward; (b) the whole
     network's gradients through the kernel's autograd Function against
     autograd through the plain version, each parameter within 1e-3 in
     relative norm, none missing or zero, and the decoder's target branch
     (which only a scene won by mode 0 trains) the same way under the loss
     with mode 0 as every scene's winner; (c) the same for kernel B at one
     call; (d) 20 compiled steps (make_train_step: the whole step one
     captured CUDA graph, models/train_program.py) against 20 eager ones
     (graphed=False) from the same initial state, under deterministic
     cuDNN: losses, parameters and optimizer state equal to the bit, the
     first call capturing, 19 replays counted on the device, every replay
     under sync debug "error", kernel A launched 6 times by the first
     call's eager step and 6 by the capture and executed 6 times a replay,
     6 times a step in the eager run; finite losses, the last below the
     first; (e) the first two losses and the first gradients against the
     same steps on the CPU (taken by phase 7's child, through the program
     path on the CPU, on the same batch, built after phase 4, beside the
     card's phases); then compiled steps under cuDNN's default algorithms
     (a program of their own); (f) save, restore into a new network and
     optimizer, two compiled steps, equal to two steps without the round
     trip and to two more after loading the checkpoint back into the
     original network and optimizer, to the bit, under deterministic cuDNN;
     the compiled step's ms (both cuDNN settings) against the eager step's
     forward / backward / optimizer ms, scenes per second, the captures'
     seconds, peak memory with and without the capture and the plain
     recompute of the 6 layer cores beside both;
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
     report written; its episode mode once more as a subprocess, the CLI,
     beside the in-process run_all_demos and parity_run);
     parity_run's free run of demo_1 under native_bal and its log through
     bench_north_star (finite rows; the verdict printed, not held);
     bench_strict on demo_1 (no failed cycle, the float32 plan count);
     bench_exec_ab's five policies (finite rates, no failed cycle);
     bench_forward_split in bf16 and float32 and bench_fusion (the
     variant's kernel 6 times per FusionNet pass, the other never, kernel
     against plain within TOL_NET_CLS / TOL_NET_POS); diag_playback on
     demo_1 (the JAX field names, finite deviations). Each driver's
     launches, counted from 0 around it, equal what its rows record, and
     the demo configuration's runs launch kernel B in multiples of 6 and
     run it at least once (launched, or executed by compiled programs);
 15b. dist: the shards at the same time, one process per shard
     (mind_tpu_torch/parallel/launch.py, the rank workloads of
     parallel/dryrun.py), at full width with the trained weights. (a)-(c)
     two ranks on the one card (gloo): the Monte-Carlo sweep of phase 12's
     scenario under the demo configuration, K = 8 copies in chunks of 4
     (2 per rank), 15 ticks; phase 13's 1024 trees, 2 x 512 (each rank's
     solve its compiled program, as the sequential mesh's); 3 float32
     training steps of phase 14's batch, 2 scenes per rank (cuDNN held to
     deterministic algorithms in the ranks and here), each rank through the
     compiled step's two programs around the all-reduce, the sequential
     mesh through its one program. Each rank's copies, trees, losses and
     parameters equal to the sequential two-shard mesh's in this process,
     to the bit; kernel B executed by the ranks' compiled sweeps as often
     as by the sequential one (the AIME rounds their programs ran, counted
     on the device), kernel A launched 6 times by a rank's first (eager)
     step and 6 by its capture, executed 6 times a replayed step (counted
     on the device).
     Then rank 0 alone, in an nccl group made beside the world's gloo one
     (parallel/dryrun.py::train_on_nccl), trains on the whole batch the
     same way, equal to the bit to the unsharded compiled step. (d) with two cards or more, one rank per card on nccl
     against the sequential mesh across two cards, the same way; with one
     card a line says it was not run. Copy-ticks/s of the ranks and of the
     one process, the tree solve's ms, each rank's step ms and launches;
 15c. [widths] (d)-(f): four networks on the main path, each at 6 layers
     with its own seeded weights, float32 (kernel A) and bf16 (kernel B):
     the 4-head, 32-wide network of the JAX package's tests and dry run
     (NARROW_NET), the 256-wide WIDE_NET, the ragged RAGGED_NET (72 / 40, 6
     heads of width 12) and the 768-wide WIDER_NET (12 heads of width 64).
     For each, a closed loop planning through MINDPlanner's compiled
     programs equal to the bit to its graphed=False loop (26 ticks;
     RAGGED_NET and WIDER_NET 18, one plan; every replay under sync debug
     "error"; the kernel launched only by the captures, executed 6 times a
     device-counted AIME round), and one eager plan cycle (run after phase
     6b) and the network on its first AIME inputs against the CPU's plain
     version (computed in phase 7's child; WIDER_NET's first 2 AIME nodes)
     within TOL_NET_CLS / TOL_NET_POS; for NARROW_NET the float32 loop
     against the same loop on the CPU (in phase 7's child): the same trees,
     the ego within TOL_LOOP_EGO; for NARROW_NET and WIDE_NET 4 compiled AdamW
     training steps (B = 4) of the float32 network equal to the bit to 4
     eager ones;
 16. print per-phase times, the benchmark's final and section lines, the
     kernel table and the card.

The kernels' bounds and the benchmark's MFU divide by the card's peak rates
from mind_tpu_torch/utils/device_specs.py, which raises on a card it does
not know.

Phase 2 holds both kernels at B = 8, 32 and 128, the batches the paths give
them. The kernels line counts each kernel's launches by path.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit from nvidia-smi, and before that one JSON line
{"kernels": [...]}: both fusion kernels and the condition kernel, with the
compiled paths' executions beside the launches, and for each fusion kernel
its numbers at every width it ran ("by_width").
"""

from __future__ import annotations

import contextlib
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
TRAIN_DEFAULT_STEPS = 6   # compiled steps under cuDNN's default algorithms, the first captures
TRAIN_PROFILED = 2        # of their replays under the profiler
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
# the parity playback's ticks (planner on after 1 s: 10 plans) and the batched
# episode's (10 planning cycles; 150 each before the host-path programs
# joined the run)
PLAYBACK_TICKS, BATCHED_TICKS = 100, 100
OBS = 50
# the AV logs 5 m/s behind a leader at 3 m/s; asked for 8 m/s (the demo
# configurations set a target velocity too), every plan has to accelerate
TARGET_VELOCITY = 8.0
REPLACES = "mind_tpu/ops/fusion_attention.py:95 (_kernel, pallas_call at :182)"
# [widths]: (D, E, heads) of the kernels alone beside the full width. In the
# resident layout: the JAX tests' narrow network, a narrower edge, widths and
# a head count that are no powers of two, the narrowest, a narrower edge at
# full node width, and 16 heads at full width (whose folded keys need a block
# of 4 targets in kernel A). In the tiled route (csrc/fusion_tiled.cuh):
# the wide network, 512 / 512 / 16, 64 heads of width 8 with E < D,
# more than 16 heads just past 128, ragged and past 128 (head width 13), the
# ragged network, head width 6, 32 heads of width 2, an edge row of 28 bytes
# (the LayerNorms in the products' epilogues up to 128 wide, in row passes
# above; kernel A folded from a head width of 8)
WIDTHS_BOUNDED = ((32, 32, 4), (64, 32, 4), (48, 80, 3), (16, 16, 2), (128, 64, 8),
                  (128, 128, 16),
                  (256, 256, 8), (512, 512, 16), (512, 256, 64), (160, 512, 20),
                  (130, 130, 10), (72, 40, 6), (36, 20, 6), (64, 64, 32), (12, 7, 3))
# past 512 wide and 64 heads: just past 512, the 768-wide network's widths,
# 128 heads of width 8 (the narrowest folded head), 512 heads of width 1
# (unfolded), 1376 / 1376 / 8, head width 1 past 1,024, 2048 / 2048 / 16, a
# ragged 2,060-byte float32 edge row with head width 103 (a 1,030-byte bf16
# weight row: the producer's element copies), and 8192 wide at 33 nodes
# (1,089 pairs: 9 x 64 tiles of its key product) past the row passes'
# register LayerNorm
WIDTHS_UNBOUNDED = ((640, 640, 10), (768, 768, 12), (1024, 512, 128), (512, 512, 512),
                    (1376, 1376, 8), (1056, 1056, 1056), (2048, 2048, 16), (1030, 515, 10),
                    (8192, 256, 64))
WIDTHS_GRID = WIDTHS_BOUNDED + WIDTHS_UNBOUNDED


def widths_batch(d, e):
    """(B, N) of [widths]' calls at node width d, edge width e: B = 8 and
    N = 129 up to 1024 wide, B = 2 up to 2048, and B = 1, N = 33 above (a
    full-size call there is ~36 TFLOP)."""
    w = max(d, e)
    return (8, 129) if w <= 1024 else (2, 129) if w <= 2048 else (1, 33)


# the batch gap's widths and N: the narrow network, a ragged and a wide shape
# at N = 129, and a wide one at N = 33 (pair tiles that cut a batch's pairs
# at other rows than each scene's alone)
WIDTHS_GAP = ((32, 32, 4, 129), (72, 40, 6, 129), (256, 256, 8, 129), (1376, 1376, 8, 33))
# a call the kernels must refuse, as the JAX function does: 5 heads at D = 48
WIDTHS_OUTSIDE = (48, 48, 5)
# the 4-head, 32-wide network of the JAX package's tests and dry run
# (__graft_entry__.py:107-108) at the default depth (6 layers)
NARROW_NET = dict(d_actor=32, d_lane=32, d_embed=32, d_rpe=32, n_scene_head=4)
# a 256-wide network (the tiled route's widths above 128) and a ragged one
# (widths that are not multiples of 16, an edge narrower than the nodes, a
# head width of 12), both at the default depth
WIDE_NET = dict(d_actor=256, d_lane=256, d_embed=256, d_rpe=256, n_scene_head=8)
RAGGED_NET = dict(d_actor=72, d_lane=72, d_embed=72, d_rpe=40, n_scene_head=6)
# a network past 512 wide: 12 heads of width 64, the default depth
WIDER_NET = dict(d_actor=768, d_lane=768, d_embed=768, d_rpe=768, n_scene_head=12)
WIDTHS_TRAIN_STEPS = 4
# calls each [widths] case is timed over (20 at the full width) in each of
# KERNEL_RUNS runs, and past 512 wide, where a call takes 2-17 ms, one
# after no warm-up call but the check's own
WIDTHS_REPS, WIDTHS_REPS_UNBOUNDED = 10, 1
# runs of a kernel case's timing: its median and spread (one run of one call
# past 512 wide)
KERNEL_RUNS = 5
# calls a case's plain version is timed over, after one warm-up call (fewer
# past 512 wide: WIDTHS_REPS_UNBOUNDED, no warm-up): a time reported beside
# the kernel's, never checked; 5 in place of the kernel's 20 make up the
# time the kernel's runs add
PLAIN_REPS = 5
# (plan programs): the extra configurations' loops, 26 ticks with the
# planner on after 0.2 s (3 plans)
PROGRAM_TICKS = 26
# the ragged network's loops: one plan each (with the planner on after
# 0.2 s, a loop plans at ticks 15, 20, 25, ...)
RAGGED_TICKS = 18
T0 = 0.0
BUILD = None   # phase 1's TiledBuild, closed when the script ends
# the committed AV2-format log of synthetic_av2(0) under demo_1's sequence id
# and its configuration (tools/write_av2_fixture.py)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                       "av2_synthetic")
FIXTURE_CONFIG = os.path.join(FIXTURE, "demo_1_synthetic.json")
# (6b) the demo command against phase 6's in-process loop on the same scene
# and configuration: the same float64 values through the parquet, metres
TOL_COMMAND_EGO = 1e-6
LOOP_TICKS = 150
# the demo command's ticks: the first 60 of phase 6's loop (2 plans; 75
# before [widths] joined the run)
COMMAND_TICKS = 60
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


# libraries the background build (phase 1) compiles at once: two shapes,
# four nvcc, so that the card's phases beside it keep most of the host
TILED_BUILD_CHUNK = 2


def phase_build(fa):
    """Phase 1: both fusion kernels at the full width and at the resident
    layout's shapes of WIDTHS_GRID, and the graph-control library, built
    side by side and loaded; the tiled layout's shapes then build in the
    background (TiledBuild). Returns the TiledBuild."""
    from mind_tpu_torch.ops import graph_control

    resident = [s for s in WIDTHS_GRID if fa.kernel_layout(*s) == "resident"]
    t = time.perf_counter()
    fa.build_kernels([fa.FULL_WIDTH, *resident])
    graph_control.load()
    log(f"[build] both fusion kernels at the full width and the {len(resident)} resident widths "
        f"of [widths], and the graph-control library, built ({len(fa.build_kernels.seconds)} "
        f"nvcc side by side) and loaded in {time.perf_counter() - t:.3f} s; CUDA versions "
        f"{graph_control.load.versions}")
    return TiledBuild(fa)


class TiledBuild:
    """The tiled layout's libraries of WIDTHS_GRID, built in a background
    thread (nvcc only) beside the card's phases: first the shapes of the
    [widths] networks (WIDTHS_NETS), which their plan cycles after the demo
    command take (join_networks); then, once `release` is called (after the
    demo command, so that no nvcc shares the host with its render workers),
    the others, TILED_BUILD_CHUNK shapes at a time, which phase [widths]
    (a)-(c) takes (join). `close` stops it after the chunk in flight, so
    that the script leaves no nvcc behind."""

    def __init__(self, fa):
        import threading

        self.fa = fa
        tiled = [s for s in WIDTHS_GRID if fa.kernel_layout(*s) == "tiled"]
        nets = {net_shape(w) for _, w, _, _ in WIDTHS_NETS}
        self.net_shapes = [s for s in tiled if s in nets]
        self.rest = [s for s in tiled if s not in nets]
        self.error, self.seconds = None, {}
        self.nets_done, self.released, self.done = (threading.Event() for _ in range(3))
        self.stopped = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        t = time.perf_counter()
        try:
            self.fa.compile_kernels(self.net_shapes)
            self.seconds["networks"] = time.perf_counter() - t
            self.nets_done.set()
            self.released.wait()
            t = time.perf_counter()
            for i in range(0, len(self.rest), TILED_BUILD_CHUNK):
                if self.stopped.is_set():
                    return
                self.fa.compile_kernels(self.rest[i:i + TILED_BUILD_CHUNK])
            self.seconds["rest"] = time.perf_counter() - t
        except Exception as err:   # the joins raise it
            self.error = err
        finally:
            self.nets_done.set()
            self.done.set()

    def _wait(self, event, shapes, what):
        t = time.perf_counter()
        event.wait()
        if self.error is not None:
            raise RuntimeError(f"the background build failed: {self.error}")
        self.fa.build_kernels(shapes)
        log(f"[build] {len(shapes)} tiled widths ({what}) built in the background in "
            f"{self.seconds[what]:.3f} s, {time.perf_counter() - t:.3f} s of it waited for "
            f"here")

    def join_networks(self):
        """Wait for the [widths] networks' tiled shapes and load them."""
        self._wait(self.nets_done, self.net_shapes, "networks")

    def release(self):
        self.released.set()

    def join(self):
        """Wait for every tiled shape, load them, and print every library's
        build seconds and nvcc's report."""
        self.release()
        self._wait(self.done, self.rest, "rest")
        log("[build] seconds from each build's start to each library's end: "
            + json.dumps({k: round(v, 2) for k, v in self.fa.build_kernels.seconds.items()}))
        for lib, text in self.fa.build_kernels.log.items():
            log(f"[build] nvcc, {lib}:\n{text.strip()}")

    def close(self):
        self.stopped.set()
        self.released.set()
        self.thread.join()


def cuda_time_spread(fn, runs=5, reps=20, warmup=3):
    """fn's ms a call over `runs` runs of `reps` calls each (CUDA events, as
    cuda_time_ms), after `warmup` calls: {"ms": the median run, "lo", "hi":
    the fastest and slowest run, "runs": every run}."""
    for _ in range(warmup):
        fn()
    times = sorted(cuda_time_ms(fn, reps, 0) for _ in range(runs))
    return {"ms": times[len(times) // 2], "lo": times[0], "hi": times[-1], "runs": times}


def net_shape(widths):
    """(D, E, heads) of a [widths] network's fusion core."""
    return (widths["d_embed"], widths["d_rpe"], widths["n_scene_head"])


def check_case(fa, ref, args, H, ue, tol, tol_mean, label, reps=20, warmup=3, runs=1):
    """One (inputs, update_edge) case: kernel vs plain: the kernel's median
    ms and spread over `runs` runs of `reps` calls after `warmup` ones
    (cuda_time_spread), the plain version's ms over PLAIN_REPS of them
    after one."""
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
    t = cuda_time_spread(lambda: fa.fused_edge_attention(*args, H, ue), runs, reps, warmup)
    plain_ms = cuda_time_ms(lambda: ref(*args, H, ue), min(reps, PLAIN_REPS), min(warmup, 1))
    if not (err < tol and mean < tol_mean):
        raise RuntimeError(f"{label}: kernel disagrees with plain: max {err} (tol {tol}), "
                           f"mean {mean} (tol {tol_mean})")
    return {"ms": t["ms"], "ms_lo": t["lo"], "ms_hi": t["hi"], "plain_ms": plain_ms,
            "max_abs_err": err, "mean_abs_err": mean}


def kernel_cases(fa, dev, key_mask, D=128, E=128, H=8, reps=20, warmup=3, fan_in=False,
                 runs=KERNEL_RUNS):
    """Both kernels vs their plain versions at B, N = key_mask.shape, node
    width D, edge width E and H heads, on random inputs with the token mask
    given (the main path's at N = 129): one result per (variant, edge type,
    update_edge) case, its kernel ms the median of `runs` runs of `reps`
    calls with their spread (ms_lo, ms_hi), weighted by its launches in one
    forward: 5 with the
    edge update and 1 without (weights scaled by fan-in with `fan_in`:
    fusion_inputs). In the bf16 variant the first of the 5 reads a bf16 node
    and edge (the encoders' output); the later ones read float32, which is
    what the layer before them wrote, so each case's node has its edge's
    type."""
    B, N = key_mask.shape[0], key_mask.shape[1]
    from mind_tpu_torch.synthetic import fusion_inputs

    w, node, edge = fusion_inputs(B, N, D, dev, SEED, e=E, fan_in=fan_in)
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
            nbytes = fa.fused_edge_attention_bytes(B, N, D, ue, e=E)
        else:
            x, e = (node.to(bf16), edge.to(bf16)) if edge_type == "bfloat16" else (node, edge)
            args, ref = (x, e, key_mask, w16), fa.fused_edge_attention_bf16_ref
            tol, tol_mean, peak = TOL_KERNEL_BF16, TOL_KERNEL_BF16_MEAN, PEAKS.bf16_flops
            nbytes = fa.fused_edge_attention_bytes(B, N, D, ue, e.element_size(),
                                                   x.element_size(), 2, e=E)
        flops = fa.fused_edge_attention_flops(B, N, D, ue, variant, H, e=E)
        label = (f"B={B}{'' if N == 129 else f' N={N}'} {variant} node,edge={edge_type} "
                 f"update_edge={ue}"
                 + ("" if (D, E, H) == (128, 128, 8) else f" D,E,heads={D},{E},{H}"))
        r = check_case(fa, ref, args, H, ue, tol, tol_mean, label, reps, warmup, runs)
        t_ops, t_bytes = 1e3 * flops / peak, 1e3 * nbytes / PEAKS.hbm_bytes
        r.update(bound_ms=max(t_ops, t_bytes), weight=weight,
                 bound_by="operations" if t_ops > t_bytes else "bytes")
        log(f"[kernel] {label}: max_abs_err={r['max_abs_err']:.3e} "
            f"mean_abs_err={r['mean_abs_err']:.3e} kernel={r['ms']:.4f} ms "
            f"({r['ms_lo']:.4f}-{r['ms_hi']:.4f} over {runs} runs of {reps}) "
            f"plain={r['plain_ms']:.4f} ms bound={r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        entries.setdefault(variant, {})[f"edge_{edge_type}_update_{str(ue).lower()}"] = r
    del node, edge, args
    torch.cuda.empty_cache()
    return entries


def mix(by_case, k):
    total = sum(r["weight"] for r in by_case.values())
    return sum(r[k] * r["weight"] for r in by_case.values()) / total


def kernel_batch_gap(fa, dev, token_mask, B=8, S=4, D=128, E=128, H=8, fan_in=False):
    """Both kernels on S * B nodes against the same call on each slice of B
    of them alone, for every (variant, edge type, update_edge) case of the
    main path, at node width D, edge width E and H heads: the max abs gap of
    out and edge per variant. A node must compute in a batch of scenes what
    it computes alone, so any gap but 0 raises."""
    from mind_tpu_torch.synthetic import fusion_inputs

    N = token_mask.shape[0]
    w, node, edge = fusion_inputs(S * B, N, D, dev, SEED, e=E, fan_in=fan_in)
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
    log(f"[kernel] B={S * B} against each slice of {B} alone, D,E,heads={D},{E},{H}, "
        f"max abs gap: {gaps}")
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
            "ms_spread": [mix(by_case, "ms_lo"), mix(by_case, "ms_hi")],
            "bound_by": bound_by.pop() if len(bound_by) == 1 else "bytes",
            "library_ms": None,
            "shape": f"B={batches[0]} N={token_mask.shape[0]} D=128 heads=8 {variant}",
            "by_case": by_case,
            "by_batch": {str(b): {**{k: mix(per_batch[b][variant], k)
                                     for k in ("ms", "ms_lo", "ms_hi", "plain_ms", "bound_ms")},
                                  "max_abs_err": max(r["max_abs_err"] for r in
                                                     per_batch[b][variant].values())}
                         for b in batches},
            "batch_gap_32_vs_8": batch_gap[variant],
        })
    return table


def mixed_entry(by_case):
    """One width's kernel table numbers: the forward mix of kernel_cases'
    cases (ms, plain_ms, bound_ms), what bounds it, the largest errors."""
    bound_by = {r["bound_by"] for r in by_case.values() if r["weight"]}
    return {**{k: mix(by_case, k) for k in ("ms", "ms_lo", "ms_hi", "plain_ms", "bound_ms")},
            "bound_by": bound_by.pop() if len(bound_by) == 1 else "bytes",
            "max_abs_err": max(r["max_abs_err"] for r in by_case.values()),
            "mean_abs_err": max(r["mean_abs_err"] for r in by_case.values())}


def narrow_cfg(compute_dtype, widths=NARROW_NET):
    """PlannerConfig() with the network of `widths` (the 4-head, 32-wide
    NARROW_NET by default; 6 layers) in `compute_dtype` and its own seeded
    weights (ckpt_path None: load_scene_pred's seed, drawn on the CPU, so the
    card and the CPU hold the same ones)."""
    from mind_tpu_torch.config import NetConfig, PlannerConfig

    cfg = PlannerConfig()
    cfg.net = NetConfig(**widths, compute_dtype=compute_dtype)
    cfg.ckpt_path = None
    return cfg


def widths_mask(token_mask, n):
    """The token mask of a [widths] call over n tokens: the main path's at
    n = 129, else n tokens with the last 5 masked."""
    if n == token_mask.shape[0]:
        return token_mask
    return torch.arange(n, device=token_mask.device) < n - 5


def widths_layout(fa, variant, shape):
    """A [widths] library's layout: its route (resident with its columns a
    block, or tiled: fold, tile, stages, where the LayerNorms run), its
    dynamic and static shared memory against the mirror
    (fusion_attention.py::kernel_smem), its pair scratch bytes a call at the
    shape's B and N and each kernel's local memory and registers
    (cudaFuncGetAttributes). A dynamic or static byte count off its mirror
    raises."""
    mirror = fa.kernel_smem(variant, *shape)
    lib, attrs = fa.kernel_library(variant, shape), fa.kernel_attrs(variant, shape)
    static = max(a["static"] for a in attrs.values())
    route = ({"layout": "resident", "columns_a_block": lib.tj,
              **({"chunk": list(mirror.tile[:2]), "stages": mirror.tile[2],
                  "blocks_a_multiprocessor": mirror.blocks} if mirror.tile else {})}
             if mirror.layout == "resident"
             else {"layout": "tiled", "fold": mirror.fold, "tile": list(mirror.tile[:2]),
                   "stages": mirror.tile[2], "memory_ln": mirror.regime,
                   "edge_ln": mirror.edge_ln})
    rec = {"regime": mirror.regime, "route": route,
           "smem_dynamic": {"library": lib.smem_bytes, "mirror": mirror.dynamic},
           "smem_static": {"library": static, "mirror": max(mirror.static)},
           "scratch_bytes_a_call": fa.pair_scratch_bytes(variant, *shape,
                                                         *widths_batch(*shape[:2])),
           "local_bytes": {k: a["local"] for k, a in attrs.items()},
           "regs": {k: a["regs"] for k, a in attrs.items()}}
    if lib.smem_bytes != mirror.dynamic or static != max(mirror.static):
        raise RuntimeError(f"[widths] {variant} {shape}: shared memory off its mirror: {rec}")
    return rec


def phase_widths_kernels(fa, dev, token_mask):
    """[widths] (a)-(c): both kernels alone against their plain versions at
    every (D, E, heads) of WIDTHS_GRID, at widths_batch's B and N
    (kernel_cases: with and without the edge update, kernel B on a bf16 and
    on a float32 edge; past 512 wide or 64 heads (WIDTHS_UNBOUNDED) the
    weights scaled by fan-in, as a network's initialisation and the CPU
    tests' weights_np draw them, so that activations keep one size: an
    unscaled draw at 8192 wide gives outputs ~36 and logits in the hundreds,
    and the absolute tolerances are set for outputs near 1), each case's
    ms, bound and error printed, and each
    library's layout (widths_layout: regime, shared memory against its
    mirror, local memory); kernel_batch_gap at each shape of WIDTHS_GAP (any
    gap but 0 raises); one call the JAX function refuses too
    (WIDTHS_OUTSIDE, heads that do not divide D), which must raise
    ValueError before any launch. Returns ({variant: {"D/E/heads":
    mixed_entry with B, N and the layout}}, {"D/E/heads": the batch gaps},
    the refusal)."""
    from mind_tpu_torch.synthetic import fusion_inputs

    by_width = {"float32": {}, "bfloat16": {}}
    for d, e, h in WIDTHS_GRID:
        B, N = widths_batch(d, e)
        mask = widths_mask(token_mask, N)[None].expand(B, -1).contiguous()
        past = (d, e, h) in WIDTHS_UNBOUNDED
        reps, warmup, runs = (WIDTHS_REPS_UNBOUNDED, 0, 1) if past else \
            (WIDTHS_REPS, 3, KERNEL_RUNS)
        for variant, by_case in kernel_cases(fa, dev, mask, d, e, h, reps, warmup,
                                             fan_in=past, runs=runs).items():
            layout = widths_layout(fa, variant, (d, e, h))
            entry = mixed_entry(by_case)
            by_width[variant][f"{d}/{e}/{h}"] = {**entry, "B": B, "N": N,
                                                 "bound_share": entry["bound_ms"] / entry["ms"],
                                                 **layout, "by_case": by_case}
            log(f"[widths] {variant} {d}/{e}/{h} at B={B} N={N}: " + json.dumps(layout))
    gaps = {f"{d}/{e}/{h}" + ("" if n == 129 else f" N={n}"):
            kernel_batch_gap(fa, dev, widths_mask(token_mask, n), D=d, E=e, H=h,
                             fan_in=(d, e, h) in WIDTHS_UNBOUNDED)
            for d, e, h, n in WIDTHS_GAP}
    d, e, h = WIDTHS_OUTSIDE
    w, node, edge = fusion_inputs(1, 9, d, dev, SEED, e=e)
    mask = torch.ones(1, 9, dtype=torch.bool, device=dev)
    before = dict(fa.fused_edge_attention.launches_by_variant)
    try:
        fa.fused_edge_attention(node, edge, mask, w, h)
    except ValueError as err:
        refused = str(err)
    else:
        raise RuntimeError(f"[widths] a call of {h} heads at D = {d} was not refused")
    if dict(fa.fused_edge_attention.launches_by_variant) != before:
        raise RuntimeError("[widths] the call outside the domain launched a kernel")
    torch.cuda.empty_cache()
    log(f"[widths] outside the domain, refused before any launch: {refused}")
    for variant, entries in by_width.items():
        log(f"[widths] {variant}, the forward's mix at each shape's B and N: " + json.dumps(
            {k: {x: v[x] for x in ("B", "N", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "bound_share", "max_abs_err", "regime",
                                   "scratch_bytes_a_call")}
             for k, v in entries.items()}))
    return by_width, gaps, refused


# the networks of [widths] (d)-(f): (name, widths, the loops' ticks, trained)
WIDTHS_NETS = (("narrow", NARROW_NET, PROGRAM_TICKS, True),
               ("wide", WIDE_NET, PROGRAM_TICKS, True),
               ("ragged", RAGGED_NET, RAGGED_TICKS, False),
               ("wider", WIDER_NET, RAGGED_TICKS, False))
# AIME nodes of the first forward the CPU child recomputes, by network (all
# where not given): the 768-wide network's plain forward of all 8 would take
# the child ~3 min of the card's phases' CPU; each node's forward is its own,
# so the card's first 2 rows are held against the CPU's forward of those 2
WIDTHS_CPU_NODES = {"wider": 2}


def wire(xs):
    """Tensors as the CPU child takes them: (dtype name, float32 numpy);
    anything else as it is."""
    return tuple((str(x.dtype), x.detach().float().cpu().numpy()) if torch.is_tensor(x) else x
                 for x in xs)


def unwire(xs):
    return tuple(torch.from_numpy(x[1]).to(getattr(torch, x[0][len("torch."):]))
                 if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str) else x
                 for x in xs)


def widths_plan_cycles(fa, dev, cpu_child, runs):
    """[widths] (e), run after phase 6b: for each network of WIDTHS_NETS (6
    layers, seeded weights) in float32 (kernel A) and bf16 (kernel B), one
    eager plan cycle (fused_plan_core) on the card, whose first AIME
    forward's inputs go to the CPU child: it computes the plain forward
    beside the card's later phases, and widths_forward_check holds the two
    in phase 15c. Adds the launches to `runs`; returns {(net, variant):
    record}."""
    from mind_tpu_torch.models.weights import load_scene_pred
    from mind_tpu_torch.planner import aime_device as aime
    from mind_tpu_torch.planner import planner as tplanner
    from mind_tpu_torch.planner.trajectory_tree import make_cost_params
    from mind_tpu_torch.synthetic import scene_statics, synthetic_scene

    cycles = {}
    for net, widths, _, _ in WIDTHS_NETS:
        for variant in ("float32", "bfloat16"):
            cfg = narrow_cfg(variant, widths)
            layers, depth = cfg.net.n_scene_layer, cfg.scen_tree.max_depth
            tag = f"[widths] {net} {variant}"
            scene = synthetic_scene(SEED, cfg.max_actors, cfg.max_lanes, n_agents=40)
            pdt = getattr(torch, cfg.pipeline_dtype)
            first = FirstCall(load_scene_pred(cfg.net, None, dev))
            report = {}
            with KernelRuns(fa) as kr:
                plan = plan_once((tplanner, make_cost_params), first, cfg, World(scene),
                                 fill_buffer(aime, scene, pdt, dev),
                                 scene_statics(scene, pdt, dev), dev, report)
            launched = kr.hold(f"{tag} plan cycle", variant, layers, depth,
                               report["rounds"])[0]
            runs[variant][0] += launched
            if not np.isfinite(plan).all() or plan[2] != 1.0:
                raise RuntimeError(f"{tag}: the plan cycle failed: {plan}")
            k = WIDTHS_CPU_NODES.get(net, len(first.inputs[0]))
            with torch.no_grad():
                got = tuple(x[:k] for x in first.net(*first.inputs))
            cpu_child.forward(f"{net} {variant}", widths, variant,
                              tuple(x[:k] for x in first.inputs))
            cycles[(net, variant)] = {"plan": plan.tolist(), "plan_rounds": report["rounds"],
                                      "launches": launched, "got": wire(got), "cpu_nodes": k}
    cpu_child.forward(None)   # no more forwards
    return cycles


def widths_forward_check(cpu_child, cycle, tag):
    """The card's first forward of a widths_plan_cycles cycle against the
    CPU child's plain forward on the same inputs, within TOL_NET_CLS /
    TOL_NET_POS; returns the record."""
    got = unwire(cycle["got"])
    want, cpu_s = cpu_child.get(f"forward {tag[len('[widths] '):]}")
    want = unwire(want)
    err = {"cls_prob": (got[0] - want[0]).abs().max().item(),
           "positions_m": (got[1][..., :2] - want[1][..., :2]).abs().max().item(),
           "velocity": (got[2] - want[2]).abs().max().item()}
    if not all(torch.isfinite(x).all() for x in got) or \
            not err["cls_prob"] < TOL_NET_CLS or not err["positions_m"] < TOL_NET_POS:
        raise RuntimeError(f"{tag}: the card's forward and the CPU's disagree: {err}")
    return {"plan": cycle["plan"], "plan_rounds": cycle["plan_rounds"],
            "plan_cycle_launches": cycle["launches"], "forward_vs_cpu": err,
            "forward_nodes_vs_cpu": cycle["cpu_nodes"], "cpu_forward_s": cpu_s}


def widths_loops(fa, dev, data_root, cpu_child, net, widths, ticks, runs, cond, modes,
                 cycles):
    """[widths] (d)-(e) for one network (`widths`, 6 layers, seeded weights)
    in float32 (kernel A) and bf16 (kernel B): (d) a `ticks`-tick closed
    loop planning through MINDPlanner's compiled programs against
    graphed=False, equal to the bit (hold_equal_loops), every replay under
    sync debug "error" (`modes` records them), the kernel launched only by
    the captures and executed 6 times a device-counted AIME round
    (KernelRuns); for the narrow network, the float32 loop against the same
    loop on the CPU through the plain version (`cpu_child`): the same trees,
    the ego within TOL_LOOP_EGO; (e) the plan cycle of widths_plan_cycles
    (`cycles`), its first forward against the CPU's
    (widths_forward_check). Adds to `runs` ({variant: [launches,
    executions]}) and `cond`; returns {variant: record}."""
    summary = {}
    for variant in ("float32", "bfloat16"):
        cfg = narrow_cfg(variant, widths)
        layers, depth = cfg.net.n_scene_layer, cfg.scen_tree.max_depth
        tag = f"[widths] {net} {variant}"
        rec, out = {}, {}
        # (d) the loop, compiled and eager
        for kind, graphed in (("compiled", None), ("eager", False)):
            n_modes = len(modes)
            with KernelRuns(fa) as kr:
                t = time.perf_counter()
                sim, _, plans = run_loop(f"widths {net} {variant} {kind}", cfg, 0.2, ticks,
                                         None, data_root, graphed=graphed)
                wall = time.perf_counter() - t
            launched, executed, c_runs, c_launched = kr.hold(
                f"{tag} loop {kind}", variant, layers, depth, sum(r["rounds"] for r in plans))
            replays = modes[n_modes:]
            if kind == "eager" and (executed or replays):
                raise RuntimeError(f"{tag}: the eager loop replayed a program")
            if kind == "compiled" and (executed <= 0 or not replays or
                                       replays != [2] * len(replays)):
                raise RuntimeError(f"{tag}: {executed} executions, replays "
                                   f"under sync debug modes {replays}")
            runs[variant][0] += launched
            runs[variant][1] += executed
            cond[0] += c_launched
            cond[1] += c_runs
            out[kind] = (sim, plans)
            rec[f"{kind}_ticks_per_s"] = ticks / wall
            rec[f"{kind}_launches"] = kr.counts
            rec[f"{kind}_executions"] = executed
        rec["compiled_vs_eager"] = hold_equal_loops(tag, out["compiled"], out["eager"])
        rec["plans"] = len(out["compiled"][1])
        # (e) the plan cycle run after phase 6b, and its forward against the CPU
        rec.update(widths_forward_check(cpu_child, cycles[(net, variant)], tag))
        if net == "narrow" and variant == "float32":
            ego_cpu, plans_cpu, cpu_s = cpu_child.get("widths32")
            sim, plans = out["compiled"]
            gap = float(np.abs(sim.ego_trajectory() - ego_cpu).max())
            same = [(a["tick"], a["tree"]) == b for a, b in zip(plans, plans_cpu)]
            rec["loop_vs_cpu"] = {"ego_gap_m": gap, "same_tree": same, "cpu_loop_s": cpu_s}
            if len(plans_cpu) != len(plans) or not all(same) or not gap < TOL_LOOP_EGO:
                raise RuntimeError(f"{tag} loop: card and CPU disagree: {rec['loop_vs_cpu']}")
        summary[variant] = rec
        log(f"{tag} network: " + json.dumps(rec))
    return summary


def widths_training(fa, dev, batch, net, widths, runs):
    """[widths] (f): WIDTHS_TRAIN_STEPS compiled AdamW training steps
    (TrainStep) of the float32 network of `widths` on phase 14's batch
    against as many eager ones, equal to the bit. Adds to runs["float32"];
    returns the record."""
    from mind_tpu_torch.models import train

    cfg = narrow_cfg("float32", widths)
    layers = cfg.net.n_scene_layer

    def train_run(graphed):
        model = train.init_scene_pred(cfg.net, seed=0, device=dev)
        optimizer = train.adamw(model.parameters(), TRAIN_LR)
        step = train.make_train_step(model, optimizer, graphed=graphed)
        fa.reset_launch_counts()
        t = time.perf_counter()
        losses = [float(step(batch)) for _ in range(WIDTHS_TRAIN_STEPS)]
        torch.cuda.synchronize()
        return {"net": model, "optimizer": optimizer, "step": step, "losses": losses,
                "s": time.perf_counter() - t,
                "launches": dict(fa.fused_edge_attention.launches_by_variant)}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager = train_run(False)
        compiled = train_run(None)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    prog = compiled["step"].program
    replays, captures = prog.replays(), len(prog.capture_s())
    same = (compiled["losses"] == eager["losses"] and all(
        torch.equal(a, b) for a, b in zip(compiled["net"].state_dict().values(),
                                          eager["net"].state_dict().values())) and all(
        torch.equal(x, y) for a, b in zip(compiled["optimizer"].state.values(),
                                          eager["optimizer"].state.values())
        for x, y in zip(a.values(), b.values())))
    rec = {"steps": WIDTHS_TRAIN_STEPS, "scenes": int(batch.actors.shape[0]),
           "losses": compiled["losses"], "compiled_equal_to_eager": same,
           "launches": compiled["launches"], "eager_launches": eager["launches"],
           "captures": captures, "replays": replays, "executions": layers * replays,
           "compiled_s": compiled["s"], "eager_s": eager["s"]}
    log(f"[widths] {net} training: " + json.dumps(rec))
    if not same or not np.isfinite(compiled["losses"]).all():
        raise RuntimeError(f"[widths] {net}: the compiled training steps differ from the eager "
                           f"ones: {compiled['losses']} against {eager['losses']}")
    if compiled["launches"] != {"float32": 2 * layers, "bfloat16": 0} or captures != 1 or \
            replays != WIDTHS_TRAIN_STEPS - 1 or \
            eager["launches"] != {"float32": layers * WIDTHS_TRAIN_STEPS, "bfloat16": 0}:
        raise RuntimeError(f"[widths] {net} training: {compiled['launches']} launches, "
                           f"{captures} captures, {replays} replays; eager {eager['launches']}")
    runs["float32"][0] += compiled["launches"]["float32"] + eager["launches"]["float32"]
    runs["float32"][1] += layers * replays
    return rec


def phase_widths_network(fa, dev, data_root, batch, cpu_child, runs, cycles):
    """[widths] (d)-(f) through the slice's main path at the four networks
    of WIDTHS_NETS, in float32 (kernel A) and bf16 (kernel B), each at 6
    layers with its own seeded weights (widths_loops, widths_training): the
    4-head, 32-wide NARROW_NET (PROGRAM_TICKS-tick loops, the float32 loop
    against the CPU, the plan cycle's forward against the CPU, training);
    the 256-wide WIDE_NET (the same but the loop against the CPU); the
    ragged RAGGED_NET and the 768-wide WIDER_NET (RAGGED_TICKS-tick loops of
    one plan, the forward against the CPU, WIDER_NET's at its first
    WIDTHS_CPU_NODES AIME nodes). `runs` holds the launches of widths_plan_cycles
    (`cycles`), run after phase 6b. Returns ({variant: [launches,
    executions]}, condition kernel [launches, runs], summary)."""
    from mind_tpu_torch.ops import graph_control as gc

    t_phase = time.perf_counter()
    cond, summary = [0, 0], {"seconds": {}}
    replay, modes = gc.GraphProgram.replay, []

    def watched(self):
        modes.append(torch.cuda.get_sync_debug_mode())
        replay(self)

    gc.GraphProgram.replay = watched
    try:
        for net, widths, ticks, training in WIDTHS_NETS:
            t = time.perf_counter()
            rec = widths_loops(fa, dev, data_root, cpu_child, net, widths, ticks, runs, cond,
                               modes, cycles)
            if ticks == RAGGED_TICKS and any(r["plans"] != 1 for r in rec.values()):
                raise RuntimeError(f"[widths] {net}: plans {rec}, one each expected")
            if training:
                gc.GraphProgram.replay = replay
                rec["training"] = widths_training(fa, dev, batch, net, widths, runs)
                gc.GraphProgram.replay = watched
            summary[net] = rec
            summary["seconds"][net] = time.perf_counter() - t
    finally:
        gc.GraphProgram.replay = replay
    summary["seconds"]["phase"] = time.perf_counter() - t_phase
    return runs, cond, summary


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


def run_loop(name, planner_cfg, enable, ticks, device, data_root, seed=SEED, graphed=None,
             export_trees=True):
    """The port's Simulator for `ticks` ticks on the synthetic AV2 scenario
    of `seed` (None: the log under data_root) with the AV's planner enabled
    after `enable` seconds, on `device` (None: the card), planning with
    `graphed` (None: through the compiled programs on the card) on the
    staged path (`export_trees`) or the fused one. Returns (sim, the AV's
    agent, per-plan records)."""
    sim = loop_sim(planner_cfg, enable, ticks, data_root, seed=seed, device=device)
    agent = next(a for a in sim.agents if a.id == "AV")
    agent.planner.graphed, agent.planner.export_trees = graphed, export_trees
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
            pl = agent.planner
            rec.update(ctrl=[float(c) for c in agent.ctrl], best=pl.last_best,
                       iterations=pl.metrics.counters["gauge/ilqr_iterations"])
            if res is not None:   # the staged path's exported trees
                rec.update(trees=pl.last_n_trees, tree=res[0][0].get_root_key())
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
    with KernelRuns(fa) as runs:
        sim, agent, plans = run_loop("loop", dcfg, 1.0, LOOP_TICKS, None, FIXTURE, seed=None)
    rounds = sum(r["rounds"] for r in plans)
    if len(plans) != 20:
        raise RuntimeError(f"closed loop: {len(plans)} plans, expected 20")
    held = runs.hold("closed loop", "bfloat16", dcfg.net.n_scene_layer,
                     dcfg.scen_tree.max_depth, rounds)
    launched, executed, cond, cond_launches = held
    counts = runs.counts
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
        "rounds": rounds, "launches": counts, "kernel_b_executions": executed,
        "condition_kernel_runs": cond, "condition_kernel_launches": cond_launches,
        "ego_advance_m": along,
        "ego_lateral_max_m": lateral, "last_plan_tree_sizes": trees,
        "tracks": len(sim.agents), "lane_segments": syn.n_graph_segments,
        "parquet_read_ms": parquet_ms,
    }
    log("[loop] " + json.dumps(summary))
    return held, summary, sim, plans


def probe_video(name, path, ticks):
    from mind_tpu_torch.viz.video import probe_avi

    info = probe_avi(path)
    if not (info["frames"] == info["index_entries"] == ticks and info["jpeg_ok"]
            and (info["width"], info["height"]) == (DEMO_FRAME, DEMO_FRAME)):
        raise RuntimeError(f"{name}: {path}: {info}, expected {ticks} JPEG frames of "
                           f"{DEMO_FRAME}x{DEMO_FRAME}")
    return info


def phase_demo_command(fa, loop, loop_plans, loop_ego, card):
    """(6b) the demo command as its users run it, on the committed log with
    rendering on: python -m mind_tpu_torch.run_sim --config <the fixture's
    configuration, its output in a temporary directory> --data-root
    tests/fixtures/av2_synthetic --max-steps COMMAND_TICKS, as a subprocess:
    exit code 0, the plan count of phase 6's loop over those ticks and no
    failed plan, an MJPEG AVI of COMMAND_TICKS JPEG frames of 1200 x 1200.
    Then run_sim.main on the same arguments in this process with
    --no-render (drawing launches nothing on the card), the launch counts
    set to 0 just before: kernel B a positive multiple of 6 times, kernel A
    never, that plan count, the ego within TOL_COMMAND_EGO of phase 6's
    over those ticks; SERIAL_FRAMES of its frames drawn one after another,
    read back and JPEG-encoded, timed. Returns (kernel B's launches,
    summary)."""
    import ast
    import re

    from mind_tpu_torch import run_sim
    from mind_tpu_torch.sim.simulator import Simulator
    from mind_tpu_torch.viz import jpeg, raster, render

    cfg = json.load(open(FIXTURE_CONFIG))
    plans = sum(r["tick"] < COMMAND_TICKS for r in loop_plans)
    loop_ego = loop_ego[:COMMAND_TICKS]
    summary = {"ticks": COMMAND_TICKS, "plans": plans,
               "render_workers": min(cfg["num_threads"], COMMAND_TICKS)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "demo_1.json")
        with open(path, "w") as f:
            json.dump(dict(cfg, output_dir=os.path.join(tmp, "out")), f)
        args = ["--config", path, "--data-root", FIXTURE, "--max-steps", str(COMMAND_TICKS)]

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
        if metrics["ticks"] != COMMAND_TICKS or metrics["plan_calls"] != plans or \
                "plan failed" in p.stdout:
            raise RuntimeError(f"demo command: {metrics} against the loop's {plans} plans; "
                               f"stdout ends {p.stdout[-2000:]}")
        summary["command_ticks_per_s"] = metrics["ticks"] / metrics["wall_time_s"]
        summary["command_video"] = probe_video("demo command", video.group(1), COMMAND_TICKS)
        summary["draw_and_encode_s_per_frame_pool"] = float(video.group(3)) / COMMAND_TICKS

        # the same arguments through run_sim.main here: launches and trajectory
        sims = []
        run = Simulator.run_sim

        def recorded(self):
            sims.append(self)
            return run(self)

        Simulator.run_sim = recorded
        try:
            with KernelRuns(fa) as runs:
                metrics = run_sim.main(args + ["--no-render"])
        finally:
            Simulator.run_sim = run
        (sim,) = sims
        agent = next(a for a in sim.agents if a.id == "AV")
        if metrics["plan_calls"] != plans or \
                agent.planner.metrics.counters.get("plan_failures", 0):
            raise RuntimeError(f"demo command in this process: {metrics}")
        pc = agent.planner.cfg
        held = runs.hold("demo command", "bfloat16", pc.net.n_scene_layer,
                         pc.scen_tree.max_depth)
        launched, executed = held[:2]
        counts = runs.counts
        ego = sim.ego_trajectory()
        gap = float(np.abs(ego - loop_ego).max()) if ego.shape == loop_ego.shape else np.inf
        if not gap <= TOL_COMMAND_EGO:
            raise RuntimeError(f"demo command: ego {ego.shape} against the loop's "
                               f"{loop_ego.shape}, {gap} m apart (limit {TOL_COMMAND_EGO})")
        summary.update(launches=counts, kernel_b_executions=executed, ego_gap_m=gap,
                       ego_bit_equal=bool(np.array_equal(ego, loop_ego)))
        # frames of this run drawn one after another, read back, encoded
        frames = np.linspace(0, COMMAND_TICKS - 1, SERIAL_FRAMES).astype(int)
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
    return held, summary


def float32_cfg():
    """The float32 defaults with the trained weights."""
    from mind_tpu_torch.config import DEFAULT_WEIGHTS, PlannerConfig

    c = PlannerConfig()
    c.ckpt_path = str(DEFAULT_WEIGHTS)
    return c


def cpu_references(inbox, outbox):
    """The CPU halves of phases 7, 4 and 14 (e), through the plain version,
    in a child process beside the card's phases (CpuReferences): puts
    ("loop32", (the float32 loop's ego trajectory, [(tick, tree)] per
    plan, seconds)), then, once phase 4's filled window arrives on `inbox`
    (numpy), ("plan", (the plan's 4 numbers, its tree, seconds)), then,
    once phase 14's training batch arrives (numpy), ("train", (the losses
    of two training steps from init_scene_pred(seed=0) through the train
    step's program path (on the CPU its body runs eagerly on the program's
    buffers), the gradients of the first by parameter name (numpy, None
    where a parameter has none), seconds)), then ("widths32", (the ego
    trajectory and [(tick, tree)] of [widths]' float32 loop of the 4-head
    32-wide network, seconds)), then, for each network forward that arrives
    (widths_plan_cycles: its name, widths, variant and wired inputs), ("forward
    <name>", (the seeded network's plain forward on them, wired, seconds))
    until None arrives, then ("done", None); or ("error", traceback)."""
    import traceback

    from mind_tpu_torch.config import PlannerConfig
    from mind_tpu_torch.models import train
    from mind_tpu_torch.models.weights import load_scene_pred
    from mind_tpu_torch.planner import aime_device as aime
    from mind_tpu_torch.planner import planner as tplanner
    from mind_tpu_torch.planner.trajectory_tree import make_cost_params
    from mind_tpu_torch.synthetic import scene_statics, synthetic_scene

    torch.set_num_threads(4)   # the card's phases keep the other cores
    try:
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as root:
            sim, _, plans = run_loop("loop32-cpu", float32_cfg(), 0.2, 36, "cpu", root)
            outbox.put(("loop32", (sim.ego_trajectory(), [(r["tick"], r["tree"]) for r in plans],
                                   time.perf_counter() - t)))
        cfg = float32_cfg()
        scene = synthetic_scene(SEED, cfg.max_actors, cfg.max_lanes, n_agents=40)
        cpu = torch.device("cpu")
        net = load_scene_pred(cfg.net, cfg.ckpt_path, cpu)
        buf = aime.DeviceObsBuffer(*(torch.from_numpy(x) for x in inbox.get()))
        report = {}
        t = time.perf_counter()
        out = plan_once((tplanner, make_cost_params), net, cfg, World(scene), buf,
                        scene_statics(scene, getattr(torch, cfg.pipeline_dtype), cpu), cpu, report)
        outbox.put(("plan", (out, int(report["best"]), time.perf_counter() - t)))
        batch = train.Batch(*(torch.from_numpy(x) for x in inbox.get()))
        t = time.perf_counter()
        net = train.init_scene_pred(PlannerConfig().net, seed=0, device=cpu)
        step = train.make_train_step(net, train.adamw(net.parameters(), TRAIN_LR))
        if step.program is None:
            raise RuntimeError("the CPU training steps did not take the program path")
        losses = [float(step(batch))]
        grads = {n: None if p.grad is None else p.grad.numpy().copy()
                 for n, p in net.named_parameters()}
        losses.append(float(step(batch)))
        outbox.put(("train", (losses, grads, time.perf_counter() - t)))
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as root:
            sim, _, plans = run_loop("widths32-cpu", narrow_cfg("float32"), 0.2, PROGRAM_TICKS,
                                     "cpu", root)
            outbox.put(("widths32", (sim.ego_trajectory(),
                                     [(r["tick"], r["tree"]) for r in plans],
                                     time.perf_counter() - t)))
        for _, name, widths, variant, inputs in iter(inbox.get, None):
            t = time.perf_counter()
            net = load_scene_pred(narrow_cfg(variant, widths).net, None, cpu)
            with torch.no_grad():
                out = net(*unwire(inputs))
            outbox.put((f"forward {name}", (wire(out), time.perf_counter() - t)))
        outbox.put(("done", None))
    except BaseException:   # the parent raises it
        outbox.put(("error", traceback.format_exc()))
        raise


class CpuReferences:
    """cpu_references in a spawned, daemonic child (it ends with this
    process whatever happens): `send` phase 4's window, then phase 14's
    batch, then `forward` the [widths] networks' forwards and None; `get` a
    result by name."""

    def __init__(self):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.inbox, self.outbox, self.results = ctx.Queue(), ctx.Queue(), {}
        self.proc = ctx.Process(target=cpu_references, args=(self.inbox, self.outbox),
                                daemon=True)
        self.proc.start()

    def send(self, buf):
        self.inbox.put(tuple(t.cpu().numpy() for t in buf))

    def forward(self, name, widths=None, variant=None, inputs=None):
        """A network forward for the child (name None: no more of them)."""
        self.inbox.put(None if name is None else ("forward", name, widths, variant,
                                                   wire(inputs)))

    def get(self, name):
        """The child's result `name`, waiting for it; raises the child's
        error."""
        while name not in self.results:
            key, value = self.outbox.get(timeout=COMMAND_TIMEOUT_S)
            if key == "error":
                raise RuntimeError(f"the CPU references failed:\n{value}")
            self.results[key] = value
        if name == "done":
            self.proc.join(timeout=60)
        return self.results[name]




class DeviceReads:
    """Counts the host's reads of the device in a block: every op that takes
    a CUDA tensor and gives the host a result (a copy to the CPU, .item(),
    the truth of a tensor), through a TorchDispatchMode. A graph replay is
    no op: what it runs is never counted."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        reads = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if any(isinstance(t, torch.Tensor) and t.is_cuda
                       for t in tree_leaves((args, kwargs))):
                    got = [o for o in tree_leaves(out) if o is not None]
                    if any(not isinstance(o, torch.Tensor) or not o.is_cuda for o in got):
                        reads.n += 1
                        reads.ops.append(str(func))
                return out

        self.mode, self.n, self.ops = Mode(), 0, []

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def plan_reads(pl):
    """One more plan of `pl` on its current state: the host's reads of the
    device in it by the planner's timer phase ({"aime": n, "solve": n,
    "export": n, ...}) and the ops that read."""
    import contextlib

    reads, by_phase = DeviceReads(), {}
    timer = pl.metrics.timer
    phase = timer.phase

    @contextlib.contextmanager
    def counted(name):
        n = reads.n
        with phase(name):
            yield
        by_phase[name] = by_phase.get(name, 0) + reads.n - n

    timer.phase = counted
    try:
        with reads:
            ok, _, _ = pl.plan()
    finally:
        del timer.phase
    if not ok:
        raise RuntimeError("plan programs: the reads' plan failed")
    if sum(by_phase.values()) != reads.n:
        raise RuntimeError(f"plan programs: {reads.n} reads, {by_phase} inside the phases")
    return by_phase, reads.ops


def same_trees(a, b) -> bool:
    """Two exported trees: the same keys, links and payloads, to the bit."""
    if a.bfs_keys() != b.bfs_keys():
        return False
    for k in a.bfs_keys():
        na, nb = a.get_node(k), b.get_node(k)
        if na.parent_key != nb.parent_key or len(na.data) != len(nb.data) or not all(
                np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(na.data, nb.data)):
            return False
    return True


PLAN_KEYS = ("tick", "ok", "ctrl", "best", "iterations", "rounds", "tree", "trees")


def hold_equal_loops(name, got, want):
    """A compiled loop (sim, plan records) against the eager one: every
    plan's ok, control, selected tree, iteration count (warm + full on the
    staged path, the fused read's on the fused one), AIME rounds and, on
    the staged path, the exported trees; the ego; all to the bit."""
    (sim_c, plans_c), (sim_e, plans_e) = got, want
    diff = [(i, k, a.get(k), b.get(k)) for i, (a, b) in enumerate(zip(plans_c, plans_e))
            for k in PLAN_KEYS if a.get(k) != b.get(k)]
    trees = [r["tick"] for r in plans_e if "tree" in r and not all(
        same_trees(sim_c.frames[r["tick"]][k][0], sim_e.frames[r["tick"]][k][0])
        for k in ("scen_tree", "traj_tree"))]
    ego_c, ego_e = sim_c.ego_trajectory(), sim_e.ego_trajectory()
    if len(plans_c) != len(plans_e) or not plans_e or diff or trees or \
            not np.array_equal(ego_c, ego_e):
        raise RuntimeError(f"plan programs {name}: the compiled loop differs from the eager "
                           f"one: {len(plans_c)} / {len(plans_e)} plans, plans {diff[:5]}, "
                           f"exported trees at ticks {trees}, ego equal "
                           f"{np.array_equal(ego_c, ego_e)}")
    return {"plans": len(plans_e), "exported_trees_compared": sum("tree" in r for r in plans_e)}


def phase_plan_programs(dcfg, fa, loop, loop_sim6, loop_plans6, data_root, card):
    """(plan programs) MINDPlanner's compiled programs (planner/programs.py)
    against graphed=False, which runs the same bodies eagerly. Cell 3's
    Simulator host loop (the committed log, demo configuration, 150 ticks,
    planner on after 1 s): on the staged path phase 6's run (`loop_sim6`,
    `loop_plans6`, which captured the programs) and here a warm compiled
    run and an eager one; on the fused path a run that captures and an
    eager one. Then PROGRAM_TICKS-tick loops compiled and eager in three
    more configurations with the float32 network (kernel A): the float32
    defaults, a native float64 exec re-solve (staged and fused) and a
    device polish re-solve in float64 (staged: its exec program). Each
    compiled loop equal to its eager one to the bit (hold_equal_loops);
    every replay under set_sync_debug_mode("error"), one replay per
    program per plan; the host's reads of the device per plan
    (DeviceReads): 2 on the staged path plus the export's (plus the
    native payload's), 1 on the fused; kernel B or A launched only by the
    captures and executed 6 times per AIME round the device counted, the
    condition kernel run by the replays, the demo AIME program's graph
    holding 6 kernel B nodes a round. Prints ticks/s compiled and eager,
    the programs captured and their capture seconds, the per-call weight
    copy, and the peak memory. Returns ((kernel B launches, executions),
    (kernel A launches, executions), condition-kernel (launches, runs),
    summary)."""
    from mind_tpu_torch.ops import graph_control as gc
    from mind_tpu_torch.planner import planner as tplanner
    from mind_tpu_torch.planner import programs

    layers, depth = dcfg.net.n_scene_layer, dcfg.scen_tree.max_depth
    replay = gc.GraphProgram.replay
    modes = []

    def watched(self):
        modes.append(torch.cuda.get_sync_debug_mode())
        replay(self)

    t_phase = time.perf_counter()
    before = set(programs.programs())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs_b, runs_a, cond = [0, 0], [0, 0], [0, 0]
    summary = {"card": card, "rates": {}, "configurations": {}}

    def loop_runs(name, cfg, enable, ticks, root, seed, export, variant, kinds, given=None):
        """The loop of one configuration in each of `kinds` ("compiled": its
        programs captured in the run where they are new, "warm": captured
        before, "eager": graphed=False), each held to its kernel runs; each
        compiled run (and `given`, phase 6's) against the eager one."""
        # replays a plan: the fused program; or AIME, solve and the exec
        # re-solve where it runs on the device
        per_plan = 1 if not export else 2 + tplanner.resolves(cfg.traj_tree,
                                                             tplanner.ilqr_configs(cfg)[0])
        out = dict(given or {})
        lay, dep = cfg.net.n_scene_layer, cfg.scen_tree.max_depth
        for kind in kinds:
            graphed = False if kind == "eager" else None
            n_modes = len(modes)
            with KernelRuns(fa) as runs:
                t = time.perf_counter()
                sim, agent, plans = run_loop(f"{name}-{kind}", cfg, enable, ticks, None, root,
                                             seed=seed, graphed=graphed, export_trees=export)
                wall = time.perf_counter() - t
            launched, executed, c, c_launched = runs.hold(
                f"plan programs {name}", variant, lay, dep, sum(r["rounds"] for r in plans))
            captured = runs.after[0] - runs.before[0]
            if kind == "eager":
                if executed or modes[n_modes:]:
                    raise RuntimeError(f"plan programs {name}: the eager loop replayed a program")
            elif executed <= 0 or modes[n_modes:] != [2] * (per_plan * len(plans)) or \
                    (kind == "warm" and captured):
                raise RuntimeError(f"plan programs {name} ({kind}): {executed} executions, "
                                   f"{captured} programs captured; replays under sync debug "
                                   f"modes {modes[n_modes:]} for {len(plans)} plans, {per_plan} "
                                   f"a plan")
            tally = runs_b if variant == "bfloat16" else runs_a
            tally[0] += launched
            tally[1] += executed
            cond[0] += c_launched
            cond[1] += c
            out[kind] = (sim, agent, plans, wall, runs.counts)
        rec = {}
        for kind in out:
            if kind != "eager":
                rec[kind] = hold_equal_loops(f"{name} ({kind})", (out[kind][0], out[kind][2]),
                                             (out["eager"][0], out["eager"][2]))
        rec.update({f"{k}_ticks_per_s": ticks / out[k][3] for k in out},
                   launches={k: out[k][4] for k in out},
                   first_plan_ms={k: out[k][2][0]["wall_ms"] for k in out},
                   steady_plan_ms_mean={k: float(np.mean([r["wall_ms"] for r in out[k][2][1:]]))
                                        for k in out})
        return rec, out[[k for k in out if k != "eager"][-1]][1].planner

    gc.GraphProgram.replay = watched
    try:
        # cell 3, staged: phase 6's loop (which captured the programs) and a
        # warm compiled one against an eager one
        staged, pl_staged = loop_runs(
            "loop", dcfg, 1.0, LOOP_TICKS, FIXTURE, None, True, "bfloat16", ("eager", "warm"),
            given={"compiled": (loop_sim6, next(a for a in loop_sim6.agents if a.id == "AV"),
                                loop_plans6, loop["wall_s"], loop["launches"])})
        staged["compiled_ticks_per_s"] = loop["ticks_per_s"]   # the loop's own rate
        fused, pl_fused = loop_runs("loop-fused", dcfg, 1.0, LOOP_TICKS, FIXTURE, None, False,
                                    "bfloat16", ("compiled", "eager"))
        summary["configurations"].update(loop_staged=staged, loop_fused=fused)
        # the float32 network's configurations
        pls = {}
        for name, solve, exec_dtype, mode, export in (
                ("float32", "float32", None, "polish", True),
                ("native", "float32", "float64", "native", True),
                ("native-fused", "float32", "float64", "native", False),
                ("polish", "float32", "float64", "polish", True)):
            cfg = float32_cfg()
            cfg.traj_tree.solve_dtype = solve
            cfg.traj_tree.exec_solve_dtype = exec_dtype
            cfg.traj_tree.exec_resolve_mode = mode
            summary["configurations"][name], pls[name] = loop_runs(
                name, cfg, 0.2, PROGRAM_TICKS, data_root, SEED, export, "float32",
                ("compiled", "eager"))

        # the host's reads of the device per plan, and the replays of each
        reads = {}
        for name, pl in (("staged", pl_staged), ("fused", pl_fused),
                         ("native", pls["native"]), ("native-fused", pls["native-fused"]),
                         ("polish", pls["polish"])):
            n_modes = len(modes)
            by_phase, ops = plan_reads(pl)
            if modes[n_modes:] != [2] * (len(modes) - n_modes):
                raise RuntimeError(f"plan programs {name}: replays under sync debug modes "
                                   f"{modes[n_modes:]}")
            reads[name] = {"reads": by_phase, "replays": len(modes) - n_modes,
                           "ops": sorted(set(ops))}
    finally:
        gc.GraphProgram.replay = replay
    # reads by phase, and replays, of one plan: AIME's packed meta, the
    # solve's packed result, the native payload, the export's trajectories
    # (the winner's scenario slots, states and controls); the fused read
    staged_reads = {"aime": 1, "flatten": 0, "solve": 1, "export": 5}
    want = {"staged": (staged_reads, 2), "fused": ({"plan_fused": 1}, 1),
            "native": (dict(staged_reads, exec_native=1), 2), "native-fused": (
                {"plan_fused": 1, "exec_native": 0}, 1), "polish": (staged_reads, 3)}
    got = {k: (r["reads"], r["replays"]) for k, r in reads.items()}
    summary["reads_per_plan"] = reads
    if got != want:
        raise RuntimeError(f"plan programs: reads by phase and replays per plan {got}, "
                           f"expected {want}: {reads}")

    # the demo AIME program's graph: kernel B in every round body
    (aime,) = [p for p in pl_staged.program_set().programs.values() if p.kind == "aime"]
    with tempfile.TemporaryDirectory() as tmp:
        dot = os.path.join(tmp, "aime.dot")
        aime.program.dot(dot)
        text = open(dot).read()
    kernel_b_nodes = sum("edge_attention_bf16_persistent" in line for line in text.splitlines())
    if kernel_b_nodes != layers * depth:
        raise RuntimeError(f"plan programs: {kernel_b_nodes} kernel B nodes in the AIME "
                           f"program's graph, expected {layers * depth}")

    # the weights' copy into the programs' network, and the check that skips it
    ps, net = pl_staged.program_set(), pl_staged.net
    n_tensors = len(ps.net._mine)
    copy_ms = cuda_time_ms(lambda: ps.net.load(net, force=True), reps=20)
    t = time.perf_counter()
    for _ in range(200):
        ps.net.load(net)
    skip_us = (time.perf_counter() - t) / 200 * 1e6

    progs = programs.programs()
    summary.update(
        programs={"in_process": len(progs), "built_in_phase": len(set(progs) - before),
                  "capture_s": [(p.kind, p.capture_s) for p in progs]},
        kernel_b_nodes_in_aime_graph=kernel_b_nodes,
        weight_copy={"tensors": n_tensors, "ms": copy_ms, "skip_check_us": skip_us},
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        kernel_b=runs_b, kernel_a=runs_a, condition_kernel_runs=cond[1],
        condition_kernel_launches=cond[0], seconds=time.perf_counter() - t_phase)
    log("[plan programs] " + json.dumps(summary))
    log(f"[plan programs] cell 3 staged {staged['compiled_ticks_per_s']:.2f} ticks/s compiled "
        f"(phase 6, capturing) and {staged['warm_ticks_per_s']:.2f} warm against "
        f"{staged['eager_ticks_per_s']:.2f} eager; fused {fused['compiled_ticks_per_s']:.2f} "
        f"(capturing) against {fused['eager_ticks_per_s']:.2f} eager, a plan after the first "
        f"{fused['steady_plan_ms_mean']['compiled']:.1f} ms against "
        f"{fused['steady_plan_ms_mean']['eager']:.1f}; "
        f"{len(progs)} programs, captured in {sum(p.capture_s for p in progs):.2f} s; weights "
        f"copied in {copy_ms:.3f} ms ({n_tensors} tensors), the skip check {skip_us:.1f} us; "
        f"peak {summary['peak_memory_gb']:.2f} GB ({card})")
    return tuple(runs_b), tuple(runs_a), tuple(cond), summary


def phase_float32_loop(cfg, fa, data_root, cpu_child):
    """36 ticks under the float32 defaults on the card (kernel A), against
    the same loop on the CPU (plain version) that `cpu_child`
    (CpuReferences) ran beside the card's phases: the same trees, ego
    within TOL_LOOP_EGO."""
    with KernelRuns(fa) as runs:
        sim, _, plans = run_loop("loop32", cfg, 0.2, 36, None, data_root)
    if len(plans) != 5:
        raise RuntimeError(f"float32 loop: {len(plans)} plans")
    held = runs.hold("float32 loop", "float32", cfg.net.n_scene_layer,
                     cfg.scen_tree.max_depth, sum(r["rounds"] for r in plans))
    launched, executed = held[:2]
    counts = runs.counts
    t = time.perf_counter()
    ego_cpu, plans_cpu, cpu_s = cpu_child.get("loop32")
    wait_s = time.perf_counter() - t
    gap = float(np.abs(sim.ego_trajectory() - ego_cpu).max())
    same = [(a["tick"], a["tree"]) == b for a, b in zip(plans, plans_cpu)]
    summary = {"plans": len(plans), "ego_gap_m": gap, "same_tree": same,
               "launches": counts, "kernel_a_executions": executed, "cpu_loop_s": cpu_s,
               "cpu_loop_wait_s": wait_s,
               "plan_wall_ms": [r["wall_ms"] for r in plans]}
    log("[loop32] " + json.dumps(summary))
    if len(plans_cpu) != len(plans) or not all(same) or not gap < TOL_LOOP_EGO:
        raise RuntimeError(f"float32 loop: card and CPU disagree: {summary}")
    return held, summary


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
    of every eager call (one host read each). A compiled episode program's
    warm-up and capture are not counted: its replays' rounds are counted on
    the device (program_rounds)."""

    def __init__(self, fn):
        self.fn, self.rounds = fn, 0

    def __call__(self, *a, **kw):
        from mind_tpu_torch.ops import graph_control

        state, meta, rounds = self.fn(*a, **kw)
        if not graph_control.capturing():
            self.rounds += int(rounds)
        return state, meta, rounds


def program_counts():
    """(compiled programs that grow AIME trees: the episode programs, the
    planner's AIME and fused programs and the scale-out runners' batched
    plans; the AIME rounds their replays ran; the condition kernel's runs in
    every compiled program, the planner's staged solve and exec programs
    and the tree solves too) in this process, read from the device."""
    from mind_tpu_torch.planner import programs
    from mind_tpu_torch.sim import episode

    eps, pls = episode.programs(), programs.programs()
    aime = eps + [p for p in pls if p.kind in ("aime", "fused", "batched_plan")]
    return (len(aime), sum(int(p.rounds) for p in aime),
            sum(int(p.program.executions) for p in eps + pls))


def graph_programs():
    """Every compiled program of this process: the episode programs and the
    planner's."""
    from mind_tpu_torch.planner import programs
    from mind_tpu_torch.sim import episode

    return episode.programs() + programs.programs()


def captured_launches(layers, depth, programs):
    """Kernel B launches of capturing `programs` AIME-growing programs:
    each warm-up runs all `depth` AIME rounds once eagerly and the capture
    records them, `layers` launches a round."""
    return 2 * layers * depth * programs


class KernelRuns:
    """The fusion kernels' runs in a block: launches by variant counted from
    0, the eager AIME rounds (RoundCounter on planner.aime_grow_tree, which
    every plan path calls), the float64 mirror's network forwards
    (parity/host_planner.py, which the parity drivers run beside the
    planner: compiled programs on the card, whose replays are counted on
    the device), the condition kernel's launches (captures) and
    program_counts and the mirror's round_programs before and after.
    `hold` checks them and returns (launches, executions, condition-kernel
    runs, condition-kernel launches)."""

    def __init__(self, fa):
        self.fa = fa

    def __enter__(self):
        from mind_tpu_torch.ops import graph_control
        from mind_tpu_torch.parity import host_planner
        from mind_tpu_torch.planner import planner as tplanner

        self.tplanner, self.cond = tplanner, graph_control.set_conditional_any
        self.mirror = host_planner.HostRefPlanner
        self.cond0 = self.cond.launches
        self.counter = RoundCounter(tplanner.aime_grow_tree)
        tplanner.aime_grow_tree = self.counter
        self.forwards = CallCounter(self.mirror._predict)
        self.mirror._predict = self.forwards
        self.before = program_counts()
        self.fwd_before = round_programs(("mirror_forward",))
        self.programs0 = set(graph_programs())
        self.fa.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        self.tplanner.aime_grow_tree = self.counter.fn
        self.mirror._predict = self.forwards.fn
        self.counts = dict(self.fa.fused_edge_attention.launches_by_variant)
        self.cond_launches = self.cond.launches - self.cond0
        self.after = program_counts()
        self.fwd_after = round_programs(("mirror_forward",))
        # the compiled programs built in the block: (kind, capture seconds)
        self.built = [(getattr(p, "kind", "episode"), getattr(p, "capture_s", None))
                      for p in graph_programs() if p not in self.programs0]

    @property
    def device_rounds(self):
        return self.after[1] - self.before[1]

    def hold(self, name, variant, layers, depth, rounds=None):
        """Kernel `variant` launched `layers` times per eager AIME round and
        per eager mirror forward, captured_launches by each AIME-growing
        program captured in the block and twice `layers` by each mirror
        forward program captured; executed `layers` times per round those
        programs' replays ran and per mirror forward replayed (both counted
        on the device); the other variant never; at least one round run,
        and `rounds` (the plans' own count, if given) in all."""
        other = "float32" if variant == "bfloat16" else "bfloat16"
        captured = self.after[0] - self.before[0]
        fwd_captured = self.fwd_after[0] - self.fwd_before[0]
        fwd_replayed = self.fwd_after[1] - self.fwd_before[1]
        eager, eager_fwd = self.counter.rounds, self.forwards.calls - fwd_replayed
        launched = layers * (eager + eager_fwd) + captured_launches(layers, depth, captured) + \
            2 * layers * fwd_captured
        total = eager + self.device_rounds
        if self.counts[variant] != launched or self.counts[other] or not total or \
                eager_fwd < 0 or (rounds is not None and total != rounds):
            raise RuntimeError(f"{name}: kernel launches {self.counts} for {eager} eager AIME "
                               f"rounds, {self.forwards.calls} mirror forwards ({fwd_replayed} "
                               f"replayed, {fwd_captured} programs captured) and {captured} "
                               f"programs captured; {self.device_rounds} "
                               f"rounds replayed, the plans' {rounds}")
        return (self.counts[variant], layers * (self.device_rounds + fwd_replayed),
                self.after[2] - self.before[2], self.cond_launches)


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
    return counts["bfloat16"], summary, res


def busy_us(intervals):
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def phase_condition_kernel(dev, sizes=(1, 6, 24, 64, 96, 256, 1024), K=200, reps=20):
    """The graph-control condition kernel (ops/csrc/graph_control.cu) against
    its plain version any(mask) at the masks the paths give it (the plan's
    enable: 1; the solve's run mask: 6 trees a scene, 24 for 4 scenes, 96
    for 16 copies; AIME's branch flags: 64 slots a scene, 256, 1024): in a
    captured program, an IF node on the mask whose body writes 1, for a mask
    all false, one with only its last entry true and a random one. Then its
    time in a graph, K kernels and IF nodes per replay at 64 entries,
    against mask.any() eagerly. Returns the kernel table's entry."""
    from mind_tpu_torch.ops import graph_control as gc

    hit = torch.zeros((), dtype=torch.int64, device=dev)
    wrong = []
    for n in sizes:
        mask = torch.zeros(n, dtype=torch.bool, device=dev)
        prog = gc.GraphProgram(lambda: gc.device_if(mask, lambda: hit.fill_(1)), dev)
        rng = np.random.default_rng(n)
        for case in (np.zeros(n, bool), np.arange(n) == n - 1, rng.random(n) < 0.05):
            mask.copy_(torch.from_numpy(case))
            hit.zero_()
            prog.replay()
            if bool(hit) != bool(gc.set_conditional_any_ref(mask)):
                wrong.append((n, int(case.sum())))
        prog.close()
    mask = torch.arange(64, device=dev) == 63

    def many():
        for _ in range(K - 1):
            gc.device_if(mask, lambda: None)
        gc.device_if(mask, lambda: hit.add_(1))

    prog = gc.GraphProgram(many, dev)
    ms = cuda_time_ms(prog.replay, reps=reps) / K
    prog.close()
    plain_ms = cuda_time_ms(lambda: gc.set_conditional_any_ref(mask), reps=reps * 10)
    bound_ms = 1e3 * mask.numel() / PEAKS.hbm_bytes   # the mask read once; 4 bytes out
    entry = {"name": "set_conditional_any", "route": "cuda",
             "source": "mind_tpu_torch/ops/csrc/graph_control.cu",
             "replaces": "no TPU kernel: the device-side control flow of "
                         "mind_tpu/planner/ilqr.py:327 (lax.while_loop), "
                         "mind_tpu/planner/aime_device.py:289 and "
                         "mind_tpu/sim/episode.py:230 (lax.cond)",
             "launches": None, "max_abs_err": float(len(wrong)), "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
             "library_ms": None,
             "shape": f"bool mask of {mask.numel()} entries (checked at {list(sizes)})"}
    log(f"[condition kernel] any(mask) against the plain version at {list(sizes)} entries: "
        f"{len(wrong)} wrong {wrong}; {ms:.5f} ms a run in a graph (with its IF node), "
        f"plain {plain_ms:.5f} ms, bound {bound_ms:.2e} ms (bytes; its launch latency sets it)")
    if wrong:
        raise RuntimeError(f"the condition kernel disagrees with any(mask): {wrong}")
    return entry


def phase_compiled(dcfg, fa, data_root, loop_ego, eager, eager_summary):
    """(compiled) The episode program (sim/episode.py: one CUDA graph per
    cycle with the AIME rounds and the iLQR loops as conditional nodes) on
    phase 10's scenario and configuration: a warm call that captures, then
    the timed one, with the launch counts set to 0 just before the warm call
    and read after the timed one. Every replay must run under
    set_sync_debug_mode("error"); the result must equal the eager loop's
    (phase 10's timed run: phases= runs the cycles eagerly) to the bit and
    stay within TOL_EPISODE_EGO of the closed loop; kernel B
    is executed layers x the device's AIME rounds, its nodes in the graph
    (DOT) layers per round body; segments of 4 cycles equal the whole run.
    Prints ticks/s compiled and eager (phase 10's), the planning cycle's
    device ms, the capture's seconds, the peak memory and the card's busy
    share over one planning cycle under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from mind_tpu_torch.ops import graph_control as gc
    from mind_tpu_torch.sim import episode

    layers, depth = dcfg.net.n_scene_layer, dcfg.scen_tree.max_depth
    sim = loop_sim(dcfg, 1.0, 150, data_root)
    replay, init = gc.GraphProgram.replay, gc.GraphProgram.__init__
    modes, spans, builds = [], [], []

    def timed_replay(self):
        modes.append(torch.cuda.get_sync_debug_mode())
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        replay(self)
        b.record()
        spans.append((a, b))

    def timed_init(self, *args, **kw):
        t = time.perf_counter()
        init(self, *args, **kw)
        builds.append(time.perf_counter() - t)

    gc.GraphProgram.replay, gc.GraphProgram.__init__ = timed_replay, timed_init
    before = episode.programs()
    try:
        fa.reset_launch_counts()
        gc.set_conditional_any.launches = 0
        n0, r0, x0 = program_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        episode.run_episode(sim)
        warm_s = time.perf_counter() - t
        n1, r1, x1 = program_counts()
        modes.clear()
        spans.clear()
        t = time.perf_counter()
        res = episode.run_episode(sim)
        wall = time.perf_counter() - t
        n2, r2, x2 = program_counts()
        peak = torch.cuda.max_memory_allocated()
        counts = dict(fa.fused_edge_attention.launches_by_variant)
        cond_launches = gc.set_conditional_any.launches
        cycle_ms = [a.elapsed_time(b) for a, b in spans]
    finally:
        gc.GraphProgram.replay, gc.GraphProgram.__init__ = replay, init
    fields = ("ego_states", "plan_ok", "planned", "iterations", "controls")
    same = {f: bool(np.array_equal(getattr(res, f), getattr(eager, f))) for f in fields}
    gap = (float(np.abs(res.ego_states[:, :2] - loop_ego[:, :2]).max())
           if res.ego_states.shape == loop_ego.shape else float("inf"))
    (prog,) = [p for p in episode.programs() if all(p is not q for q in before)]
    with tempfile.TemporaryDirectory() as tmp:
        dot = os.path.join(tmp, "episode.dot")
        prog.program.dot(dot)
        text = open(dot).read()
    kernel_b_nodes = sum("edge_attention_bf16_persistent" in line for line in text.splitlines())
    # one planning cycle (cycle 10: the planner comes on at tick 50) under
    # the profiler, the program replayed on an 11-cycle schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        episode.run_episode(sim, horizon=55)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t
    kernels = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = busy_us(kernels) / 1e3
    planned = res.planned.tolist()
    summary = {
        "ticks": len(res.ego_states), "plan_calls": res.plan_calls, "fail_cycle": res.fail_cycle,
        "wall_s": wall, "warm_wall_s": warm_s, "program_build_s": builds,
        "ticks_per_s": len(res.ego_states) / wall,
        "eager_ticks_per_s": eager_summary["ticks_per_s"],
        "planning_cycle_device_ms_mean": float(np.mean([m for m, p in zip(cycle_ms, planned)
                                                        if p])),
        "non_planning_cycle_device_ms_mean": float(np.mean([m for m, p in zip(cycle_ms, planned)
                                                            if not p])),
        "replays": len(cycle_ms), "sync_debug_modes": sorted(set(modes)),
        "equal_to_eager": same, "ego_gap_to_loop_m": gap,
        "programs_captured": n2 - n0, "device_rounds_timed": r2 - r1,
        "device_rounds_warm": r1 - r0, "condition_kernel_runs_timed": x2 - x1,
        "condition_kernel_launches": cond_launches, "launches": counts,
        "kernel_b_executions_timed": layers * (r2 - r1),
        "kernel_b_nodes_in_graph": kernel_b_nodes, "peak_memory_gb": peak / 1e9,
        "profile_one_planning_cycle": {"wall_ms": prof_wall * 1e3, "device_kernels": len(kernels),
                                       "device_busy_ms": busy_ms,
                                       "device_busy_share": busy_ms / (prof_wall * 1e3)},
        "iterations": res.iterations[res.planned].tolist()}
    log("[compiled] " + json.dumps(summary))
    if res.fail_cycle != -1 or not gap < TOL_EPISODE_EGO or res.plan_calls != eager.plan_calls:
        raise RuntimeError(f"compiled episode disagrees with the closed loop: {summary}")
    if not all(same.values()):
        raise RuntimeError(f"compiled episode differs from the eager loop: {same}")
    if modes != [2] * len(res.planned) or len(cycle_ms) != len(res.planned):
        raise RuntimeError(f"compiled replays ran outside sync debug mode 'error': {modes}")
    if n2 - n0 != 1 or n2 != n1 or counts["float32"] != 0 or \
            counts["bfloat16"] != captured_launches(layers, depth, 1) or r2 - r1 <= 0 or \
            kernel_b_nodes != layers * depth:
        raise RuntimeError(f"compiled episode: {n2 - n0} programs, launches {counts}, "
                           f"{r2 - r1} device rounds, {kernel_b_nodes} kernel B nodes")
    seg = episode.run_episode_segmented(sim, seg_cycles=4)
    seg_same = {f: bool(np.array_equal(getattr(seg, f), getattr(res, f))) for f in fields}
    log(f"[compiled] segmented (4-cycle segments, compiled) equal to the whole run: {seg_same}")
    if not all(seg_same.values()) or seg.fail_cycle != res.fail_cycle:
        raise RuntimeError(f"compiled segmented episode differs from the whole one: {seg_same}")
    summary["segmented_equal"] = True
    return counts["bfloat16"], layers * (r2 - r1), cond_launches, summary


def first_decision(got, want):
    """The first cycle at which a lane of a batched run and the same
    scenario or copy run alone take a different discrete decision: plan or
    not, plan ok, solver iteration count. None if none."""
    for c in range(min(len(got.planned), len(want.planned))):
        a = (bool(got.planned[c]), bool(got.plan_ok[c]), float(got.iterations[c]))
        b = (bool(want.planned[c]), bool(want.plan_ok[c]), float(want.iterations[c]))
        if a != b:
            return {"cycle": c, "batched": a, "alone": b,
                    "control_gap": float(np.abs(got.controls[c] - want.controls[c]).max())}
    return None


def against_single(got, want):
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
            "first_decision_differing": first_decision(got, want),
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
    differ; planner on after 1 s, BATCHED_TICKS ticks) through the compiled
    'scenarios' program, a warm call (it captures) then the timed one, the
    launch counts set to 0 just before and read just after: kernel B
    launched only by the capture (program_counts, captured_launches) and
    executed 6 times per AIME round of the batch (B = 32 nodes per round),
    counted on the device; each scenario then held against its own
    run_episode (its 'single' program)."""
    from mind_tpu_torch.sim import episode

    speeds = (8.0, 7.0, 9.0, 6.0)
    sims = [loop_sim(dcfg, 1.0, BATCHED_TICKS, data_root, seed, v)
            for seed, v in enumerate(speeds)]
    first_call = []
    net = sims[0].agents[[a.id for a in sims[0].agents].index("AV")].planner.net
    hook = net.register_forward_pre_hook(
        lambda m, args: first_call.append(args) if not first_call else None)
    try:
        fa.reset_launch_counts()
        n0, _, _ = program_counts()
        t = time.perf_counter()
        episode.run_episodes_batched(sims)
        warm_s = time.perf_counter() - t
        n1, r1, _ = program_counts()
        t = time.perf_counter()
        res = episode.run_episodes_batched(sims)
        wall = time.perf_counter() - t
        n2, r2, _ = program_counts()
        counts = dict(fa.fused_edge_attention.launches_by_variant)
    finally:
        hook.remove()
    pool_bytes, pool_blocks = graph_pool_in_use()
    layers, depth = dcfg.net.n_scene_layer, dcfg.scen_tree.max_depth
    summary = {
        "scenes": len(sims), "target_velocities": speeds, "wall_s": wall, "warm_wall_s": warm_s,
        "scene_ticks_per_s": sum(len(r.ego_states) for r in res) / wall,
        "plan_calls": [r.plan_calls for r in res], "fail_cycle": [r.fail_cycle for r in res],
        "programs_captured": n2 - n0, "device_rounds_timed": r2 - r1, "launches": counts,
        "kernel_b_executions_timed": layers * (r2 - r1),
        "graph_pool_live_bytes": pool_bytes, "graph_pool_live_blocks": pool_blocks}
    log("[batched] " + json.dumps(summary))
    if n2 - n0 != 1 or n2 != n1 or counts["float32"] != 0 or r2 - r1 <= 0 or \
            counts["bfloat16"] != captured_launches(layers, depth, 1):
        raise RuntimeError(f"batched episode: {n2 - n0} programs, launches {counts} for "
                           f"{r2 - r1} device AIME rounds")
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
        singles[i] = against_single(r, episode.run_episode(sim))
    summary["against_run_episode"] = singles
    log("[batched] each scenario against its run_episode: " + json.dumps(singles))
    hold_against_singles("batched episode", singles)
    return counts["bfloat16"], summary


# the Monte-Carlo phase's timed run: 75 ticks (15 cycles, each planning);
# its segments-of-4 run covers the first 50 (10 cycles: segments of 4, 4, 2)
MC_TICKS, SEG_CHECK_TICKS = 75, 50


def phase_monte_carlo(dcfg, fa, data_root, k=16):
    """run_episode_monte_carlo on the loop's scenario (seed 0) under the demo
    configuration: k = 16 copies in one chunk, segments of 10 cycles, a warm
    call over the first 50 ticks (it captures the program) then the timed
    one over MC_TICKS, with the launch counts set to 0 just before and
    read just after, and the peak device memory of the timed chunk; then
    segments of 4 over the first SEG_CHECK_TICKS (equal to the bit) and two
    copies through run_episode on their own schedules (within
    TOL_EPISODE_EGO)."""
    from mind_tpu_torch.sim import episode

    sim = loop_sim(dcfg, 1.0, 150, data_root)
    walls = []
    fa.reset_launch_counts()
    n0, _, _ = program_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the warm call captures the program the timed one replays: segments of
    # 10 cycles, here over the first 50 ticks (the same shapes)
    episode.run_episode_monte_carlo(sim, k=k, chunk=k, seg_cycles=10, horizon=50)
    warm_peak = torch.cuda.max_memory_allocated()
    n1, r1, _ = program_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = episode.run_episode_monte_carlo(sim, k=k, chunk=k, seg_cycles=10, horizon=MC_TICKS,
                                          chunk_walls=walls)
    wall = time.perf_counter() - t
    n2, r2, _ = program_counts()
    counts = dict(fa.fused_edge_attention.launches_by_variant)
    peak = torch.cuda.max_memory_allocated()
    failed = [i for i, r in enumerate(res) if r.fail_cycle >= 0]
    summary = {"copies": len(res), "wall_s": wall, "chunk_walls": walls,
               "copy_ticks_per_s": sum(len(r.ego_states) for r in res) / wall,
               "copy_ticks_per_s_full_horizon": k * MC_TICKS / wall,
               "failed_copies": len(failed), "fail_cycles": [res[i].fail_cycle for i in failed],
               "plan_calls": [r.plan_calls for r in res], "peak_memory_gb": peak / 1e9,
               "peak_memory_gb_warm_call_with_capture": warm_peak / 1e9,
               "programs_captured": n2 - n0, "device_rounds_timed": r2 - r1,
               "kernel_b_executions_timed": dcfg.net.n_scene_layer * (r2 - r1),
               "launches": counts}
    log("[monte_carlo] " + json.dumps(summary))
    if len(res) != k or not all(np.isfinite(r.ego_states).all() for r in res):
        raise RuntimeError(f"monte carlo: {len(res)} copies, or a copy's states are not finite")
    if n2 - n0 != 1 or n2 != n1 or counts["float32"] != 0 or r2 - r1 <= 0 or \
            counts["bfloat16"] != captured_launches(dcfg.net.n_scene_layer,
                                                    dcfg.scen_tree.max_depth, 1):
        raise RuntimeError(f"monte carlo: {n2 - n0} programs, launches {counts} for "
                           f"{r2 - r1} device AIME rounds")
    # segments of 4 over the first SEG_CHECK_TICKS: the same schedule's
    # prefix, so the same cycles to the bit
    seg = episode.run_episode_monte_carlo(sim, k=k, chunk=k, seg_cycles=4,
                                          horizon=SEG_CHECK_TICKS)
    cycles = SEG_CHECK_TICKS // 5
    for i, (a, b) in enumerate(zip(seg, res)):
        for f in ("ego_states", "plan_ok", "planned", "iterations", "controls"):
            n = SEG_CHECK_TICKS if f == "ego_states" else cycles
            if not np.array_equal(getattr(a, f), getattr(b, f)[:n]):
                raise RuntimeError(f"monte carlo: copy {i}'s {f} differs between segments of "
                                   "4 and of 10 cycles")
    summary["segments_4_equal_10"] = True
    inp = episode.build_mc_inputs(sim, k, horizon=MC_TICKS)
    singles = {}
    for i in (0, k - 1):
        want = episode.run_episode(sim, inputs=episode.lane_inputs(inp, i))
        singles[i] = against_single(res[i], want)
    summary["against_run_episode"] = singles
    log("[monte_carlo] segments of 4 equal to 10; copies against run_episode: "
        + json.dumps(singles))
    hold_against_singles("monte carlo", singles)
    return counts["bfloat16"], summary

# (scale-out programs): MultiScenarioSim over phase 11's four scenes (100
# ticks, planner on after 1 s: 10 triggers) and MonteCarloSim of phase 12's
# scenario (K = 16, 50 ticks: 10 triggers), compiled against graphed=False.
# The warm runs capture the programs: 51 ticks of the scenes (one trigger),
# 1 tick of the copies
SCALEOUT_SPEEDS = (8.0, 7.0, 9.0, 6.0)
SCALEOUT_TICKS, SCALEOUT_PLANS, SCALEOUT_WARM_TICKS = 100, 10, 51
SCALEOUT_K, SCALEOUT_MC_TICKS = 16, 50


def phase_scaleout_programs(dcfg, fa, data_root, card):
    """(12c) the scale-out runners' compiled programs (parallel/programs.py:
    the observation update and the batched plan, each one CUDA graph, AIME's
    rounds IF nodes and the iLQR loops WHILE nodes) against graphed=False,
    which runs the same bodies eagerly, in one process, with the demo
    configuration and the trained weights (kernel B). (a) MultiScenarioSim
    over phase 11's four scenes (seeds 0-3, the AV asked for 8, 7, 9 and 6
    m/s, planner on after 1 s, 100 ticks: 10 triggers of B = 32 nodes a
    round): a warm compiled run (it captures), the timed compiled run (it
    captures nothing) and the eager one, equal to the bit: every trigger's
    packed, plan_calls, terminated and the four egos at every tick. (b)
    MonteCarloSim of phase 12's scenario, K = 16 (B = 128), 50 ticks (10
    triggers), the same way: every trigger's packed, failed and the
    trajectory. (c) In the timed compiled runs the host's reads of the
    device (DeviceReads, around each update and trigger alone): one per
    trigger, none per update; every replay under sync debug "error", one a
    program call. (d) Kernel B launched only by
    the captures and executed 6 times per device-counted AIME round; the
    condition kernel's launches and runs per program. (e) Scene-ticks/s and
    copy-ticks/s compiled against eager, the programs with their capture
    seconds and the peak memory at K = 16, with the card's name and power
    limit. Returns ((kernel B launches, executions), condition-kernel
    (launches, runs), summary)."""
    import contextlib
    import copy

    from mind_tpu_torch.ops import graph_control as gc
    from mind_tpu_torch.parallel.monte_carlo import MonteCarloSim
    from mind_tpu_torch.parallel.multi_scenario import MultiScenarioSim
    from mind_tpu_torch.planner import programs
    from mind_tpu_torch.synthetic import demo_spec

    t_phase = time.perf_counter()
    layers, depth = dcfg.net.n_scene_layer, dcfg.scen_tree.max_depth
    specs = [demo_spec("demo_1", seed, data_root, ticks=SCALEOUT_TICKS, planner_cfg=dcfg,
                       enable_timestep=1.0, target_velocity=v)
             for seed, v in enumerate(SCALEOUT_SPEEDS)]
    mc_spec = demo_spec("demo_1", SEED, data_root, ticks=SCALEOUT_TICKS, planner_cfg=dcfg,
                        enable_timestep=1.0, target_velocity=TARGET_VELOCITY)

    def multi(graphed, ticks=SCALEOUT_TICKS):
        return MultiScenarioSim([copy.deepcopy(sp.config) for sp in specs], planner_cfg=dcfg,
                                max_steps=ticks, scenarios=[sp.scenario for sp in specs],
                                graphed=graphed)

    def monte(graphed, ticks=SCALEOUT_MC_TICKS, k=SCALEOUT_K):
        return MonteCarloSim(copy.deepcopy(mc_spec.config), k=k, planner_cfg=dcfg,
                             max_steps=ticks, scenario=mc_spec.scenario, graphed=graphed)

    replay, modes = gc.GraphProgram.replay, []

    def watched(self):
        modes.append(torch.cuda.get_sync_debug_mode())
        replay(self)

    runs_b, cond = [0, 0], [0, 0]

    def run(name, runner, reads=False):
        """One run of `runner` under KernelRuns: every trigger's packed, the
        egos at every tick (MultiScenarioSim), the wall seconds, the
        programs captured and the replays' sync debug modes; with `reads`,
        the host's reads of the device in each update and trigger
        (DeviceReads, entered around those calls alone)."""
        counter = DeviceReads() if reads else None
        counted = lambda: counter if counter else contextlib.nullcontext()
        rec = {"packed": [], "plan_reads": [], "update_reads": [], "egos": []}
        plan, update = runner._plan, runner.programs.update

        def traced_plan(*a):
            n = counter.n if counter else 0
            with counted():
                out = plan(*a)
            rec["packed"].append(out.copy())
            if counter:
                rec["plan_reads"].append(counter.n - n)
            return out

        def traced_update(*a):
            n = counter.n if counter else 0
            with counted():
                update(*a)
            if counter:
                rec["update_reads"].append(counter.n - n)

        runner._plan, runner.programs.update = traced_plan, traced_update
        if isinstance(runner, MultiScenarioSim):
            flush = runner._flush_obs

            def traced_flush():
                rec["egos"].append(runner.ego_states())
                flush()

            runner._flush_obs = traced_flush
        before, n_modes = set(programs.programs()), len(modes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with KernelRuns(fa) as runs:
            t = time.perf_counter()
            res = runner.run()
            torch.cuda.synchronize()
            rec["wall_s"] = time.perf_counter() - t
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        launched, executed, c, c_launched = runs.hold(f"scale-out programs {name}", "bfloat16",
                                                      layers, depth)
        runs_b[0] += launched
        runs_b[1] += executed
        cond[0] += c_launched
        cond[1] += c
        rec.update(result=res, launches=runs.counts, kernel_b_executions=executed,
                   condition_kernel_runs=c, condition_kernel_launches=c_launched,
                   captured=[(p.kind, p.capture_s) for p in programs.programs()
                             if p not in before],
                   modes=modes[n_modes:])
        if runner.programs.compiled:
            if not executed or set(rec["modes"]) != {2}:
                raise RuntimeError(f"scale-out programs {name}: {executed} kernel B executions, "
                                   f"replays under sync debug modes {set(rec['modes'])}")
        elif executed or rec["modes"] or rec["captured"]:
            raise RuntimeError(f"scale-out programs {name}: the eager run replayed a program")
        calls = len(rec["packed"]) + len(rec["update_reads"])
        if reads and len(rec["modes"]) != calls:
            raise RuntimeError(f"scale-out programs {name}: {len(rec['modes'])} replays for "
                               f"{calls} program calls")
        return runner, rec

    def equal(name, got, want, fields):
        (rc, c), (re_, e) = got, want
        diff = [f for f in fields if not _same(f(rc, c), f(re_, e))]
        if diff or not e["packed"]:
            raise RuntimeError(f"scale-out programs {name}: the compiled run differs from the "
                               f"eager one in {diff} ({len(c['packed'])} / {len(e['packed'])} "
                               "triggers)")

    gc.GraphProgram.replay = watched
    summary = {"card": card}
    try:
        # (a) MultiScenarioSim: warm (captures), timed compiled (its reads
        # counted), eager
        _, warm_ms = run("MultiScenarioSim warm", multi(None, SCALEOUT_WARM_TICKS))
        got_ms = run("MultiScenarioSim", multi(None), reads=True)
        want_ms = run("MultiScenarioSim eager", multi(False))
        # (b) MonteCarloSim at K = 16: warm (one trigger), timed, eager
        _, warm_mc = run("MonteCarloSim warm", monte(None, 1))
        got_mc = run("MonteCarloSim", monte(None), reads=True)
        want_mc = run("MonteCarloSim eager", monte(False))
    finally:
        gc.GraphProgram.replay = replay
    for name, (_, rec) in (("MultiScenarioSim", got_ms), ("MonteCarloSim", got_mc)):
        if rec["captured"]:
            raise RuntimeError(f"scale-out programs {name}: the timed run captured "
                               f"{rec['captured']}")
    for name, warm, (_, rec) in (("MultiScenarioSim", warm_ms, got_ms),
                                 ("MonteCarloSim", warm_mc, got_mc)):
        kinds = sorted(k for k, _ in warm["captured"])
        if kinds != ["batched_plan", "obs_update"] or \
                rec["plan_reads"] != [1] * len(rec["packed"]) or not rec["update_reads"] or \
                set(rec["update_reads"]) != {0}:
            raise RuntimeError(f"scale-out programs {name}: the warm run captured {kinds}; "
                               f"reads per trigger {rec['plan_reads']}, per update "
                               f"{rec['update_reads']}")
    equal("MultiScenarioSim", got_ms, want_ms, (
        lambda r, c: c["packed"], lambda r, c: c["egos"], lambda r, c: r.ego_states(),
        lambda r, c: c["result"]["plan_calls"], lambda r, c: c["result"]["terminated"]))
    equal("MonteCarloSim", got_mc, want_mc, (
        lambda r, c: c["packed"], lambda r, c: r.failed, lambda r, c: r.trajectory,
        lambda r, c: c["result"]["plan_calls"]))
    (ms_c, ms_rec), (_, ms_eager) = got_ms, want_ms
    (mc_c, mc_rec), (_, mc_eager) = got_mc, want_mc
    if ms_rec["result"]["plan_calls"] != SCALEOUT_PLANS or \
            any(ms_rec["result"]["terminated"]) or mc_c.failed.any() or \
            not all(np.isfinite(p).all() for p in ms_rec["packed"] + mc_rec["packed"]):
        raise RuntimeError(f"scale-out programs: {ms_rec['result']}, failed copies "
                           f"{int(mc_c.failed.sum())}, or a packed plan is not finite")
    mine = [p for p in programs.programs() if p.kind in ("obs_update", "batched_plan")]
    ticks = lambda rec, n: n * rec["result"]["ticks"] / rec["wall_s"]
    summary.update(
        multi_scenario={"scenes": len(SCALEOUT_SPEEDS), "ticks": SCALEOUT_TICKS,
                        "triggers": len(ms_rec["packed"]),
                        "scene_ticks_per_s": {"compiled": ticks(ms_rec, 4),
                                              "eager": ticks(ms_eager, 4)},
                        "plan_time_s": {"compiled": ms_rec["result"]["plan_time_s"],
                                        "eager": ms_eager["result"]["plan_time_s"]},
                        "wall_s": {"compiled": ms_rec["wall_s"], "eager": ms_eager["wall_s"]},
                        "peak_memory_gb": ms_rec["peak_memory_gb"]},
        monte_carlo={"copies": SCALEOUT_K, "ticks": SCALEOUT_MC_TICKS,
                     "triggers": len(mc_rec["packed"]),
                     "copy_ticks_per_s": {"compiled": ticks(mc_rec, SCALEOUT_K),
                                          "eager": ticks(mc_eager, SCALEOUT_K)},
                     "wall_s": {"compiled": mc_rec["wall_s"], "eager": mc_eager["wall_s"]},
                     "peak_memory_gb": {"timed": mc_rec["peak_memory_gb"],
                                        "warm_with_capture": warm_mc["peak_memory_gb"]}},
        reads={"triggers": len(ms_rec["plan_reads"]) + len(mc_rec["plan_reads"]),
               "per_trigger": sorted(set(ms_rec["plan_reads"] + mc_rec["plan_reads"])),
               "updates": len(ms_rec["update_reads"]) + len(mc_rec["update_reads"]),
               "per_update": sorted(set(ms_rec["update_reads"] + mc_rec["update_reads"]))},
        programs=[{"kind": p.kind, "batch": int(p.inputs.host.shape[0]) if p.kind ==
                   "batched_plan" else int(p.inputs.buf.pos.shape[0]),
                   "capture_s": p.capture_s, "condition_kernel_runs": int(p.program.executions),
                   "aime_rounds": int(p.rounds)} for p in mine],
        kernel_b={"launches": runs_b[0], "executions": runs_b[1]},
        condition_kernel={"launches": cond[0], "runs": cond[1]},
        launches_by_run={n: r["launches"] for n, r in (
            ("multi_warm", warm_ms), ("multi", ms_rec), ("multi_eager", ms_eager),
            ("monte_warm", warm_mc), ("monte", mc_rec), ("monte_eager", mc_eager))},
        seconds=time.perf_counter() - t_phase)
    log("[scale-out programs] " + json.dumps(summary))
    ms, mc = summary["multi_scenario"], summary["monte_carlo"]
    log(f"[scale-out programs] MultiScenarioSim {ms['scene_ticks_per_s']['compiled']:.2f} "
        f"scene-ticks/s compiled against {ms['scene_ticks_per_s']['eager']:.2f} eager; "
        f"MonteCarloSim (K = {SCALEOUT_K}) {mc['copy_ticks_per_s']['compiled']:.2f} "
        f"copy-ticks/s against {mc['copy_ticks_per_s']['eager']:.2f}; equal to the bit; "
        f"{len(mine)} programs captured in {sum(p.capture_s for p in mine):.2f} s; peak "
        f"{mc['peak_memory_gb']['timed']:.2f} GB at K = {SCALEOUT_K} timed, "
        f"{mc['peak_memory_gb']['warm_with_capture']:.2f} GB with its capture ({card})")
    return tuple(runs_b), tuple(cond), summary


def scaleout_peak_memory(dcfg, fa, data_root, card, k=64):
    """MonteCarloSim of phase 12c's scenario with `k` copies (64: the
    bench's Monte-Carlo size, B = 8k nodes a round), one compiled trigger
    that captures its programs: finite, kernel B launched by the capture
    alone and executed 6 times per device-counted round; the peak device
    memory and seconds, with the card. Not a phase of this script: the
    capture holds tens of GB in the programs' pool, which the later phases
    need (tools/scaleout_programs_phase.py runs it last)."""
    from mind_tpu_torch.parallel.monte_carlo import MonteCarloSim
    from mind_tpu_torch.planner import programs
    from mind_tpu_torch.synthetic import demo_spec

    spec = demo_spec("demo_1", SEED, data_root, ticks=SCALEOUT_TICKS, planner_cfg=dcfg,
                     enable_timestep=1.0, target_velocity=TARGET_VELOCITY)
    mc = MonteCarloSim(spec.config, k=k, planner_cfg=dcfg, max_steps=1, scenario=spec.scenario)
    before = set(programs.programs())
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with KernelRuns(fa) as runs:
        t = time.perf_counter()
        mc.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    held = runs.hold(f"scale-out programs K = {k}", "bfloat16", dcfg.net.n_scene_layer,
                     dcfg.scen_tree.max_depth)
    captured = [(p.kind, p.capture_s) for p in programs.programs() if p not in before]
    summary = {"copies": k, "peak_memory_gb_one_trigger_with_capture":
               torch.cuda.max_memory_allocated() / 1e9, "wall_s": wall, "captured": captured,
               "kernel_b": held[:2], "failed": int(mc.failed.sum()), "card": card}
    log(f"[scale-out programs K = {k}] " + json.dumps(summary))
    if sorted(kind for kind, _ in captured) != ["batched_plan", "obs_update"] or \
            not np.isfinite(mc.ctrls).all():
        raise RuntimeError(f"scale-out programs K = {k}: {summary}")
    return summary


def _same(a, b) -> bool:
    """Equal to the bit: arrays, lists of them, or plain values."""
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.shape == b.shape and np.array_equal(a, b)
    return a == b


def phase_tree_scale():
    """parallel_tree_solve on make_tree_batch at the JAX package's scale-test
    sizes (1024 branching trees of up to 24 of 32 cost nodes, 24 levels,
    width 4, 4 exo agents; 10 iterations) on a one-device mesh, compiled
    (the default: the whole solve one program, captured at its first call,
    the iterations a WHILE node) against graphed=False (a captured
    iteration per replay, a host read after each): a first call of each
    that captures, then the timed ones; us, J and the iteration counts equal
    to the bit; the timed compiled call captures nothing and reads the
    device never (a one-device mesh gathers on the device). Then 4 slices
    of 256 solved alone (compiled) against the whole batch: us within 1e-4,
    J within 1e-5 relative."""
    import contextlib

    from mind_tpu_torch.parallel.mesh import make_mesh
    from mind_tpu_torch.parallel.scale import make_tree_batch, parallel_tree_solve
    from mind_tpu_torch.planner import programs
    from mind_tpu_torch.planner.ilqr import ILQRConfig, TreeTopology
    from mind_tpu_torch.ops.potential import NodeCostData

    mesh = make_mesh(1)
    topo, nodes, params, x0 = make_tree_batch(1024, 24, 32, 24, 4, 4, device=mesh.devices[0])
    cfg = ILQRConfig(max_iterations=10)

    def solve(graphed, reads=None):
        """(us, J, iterations) and the call's wall ms."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        with reads if reads is not None else contextlib.nullcontext():
            out = parallel_tree_solve(mesh, topo, nodes, params, x0, cfg, graphed=graphed,
                                      with_iterations=True)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    before = set(programs.programs())
    _, first_ms = solve(None)
    captured = [p for p in programs.programs() if p not in before]
    solve(False)
    before, reads = set(programs.programs()), DeviceReads()
    (us, J, its), ms = solve(None, reads)
    if set(programs.programs()) != before or reads.n:
        raise RuntimeError(f"tree scale: the timed compiled solve captured or read the device "
                           f"({reads.n} reads: {reads.ops})")
    want, eager_ms = solve(False)
    equal = [torch.equal(a, b) for a, b in zip((us, J, its), want)]
    gaps = []
    for lo in range(0, 1024, 256):
        cut = lambda x: x[lo:lo + 256]
        us_s, J_s = parallel_tree_solve(mesh, TreeTopology(*map(cut, topo)),
                                        NodeCostData(*map(cut, nodes)), params, cut(x0), cfg)
        gaps.append((float((us_s - us[lo:lo + 256]).abs().max()),
                     float(((J_s - J[lo:lo + 256]).abs() / J[lo:lo + 256].abs()).max())))
    (prog,) = [p for p in captured if p.kind == "tree_solve"]
    solves = [p for p in programs.programs() if p.kind == "tree_solve"]
    summary = {"trees": 1024, "ms": ms, "eager_ms": eager_ms, "first_call_ms": first_ms,
               "capture_s": prog.capture_s, "programs": len(solves),
               "condition_kernel_runs": sum(int(p.program.executions) for p in solves),
               "iterations": [int(its.min()), int(its.max())], "reads_timed": reads.n,
               "equal_to_eager_us_J_iterations": equal,
               "finite": bool(torch.isfinite(us).all() and torch.isfinite(J).all()),
               "slice_gaps_us_J_rel": gaps}
    log("[scale] " + json.dumps(summary))
    log(f"[scale] 1024 trees: compiled {ms:.1f} ms against {eager_ms:.1f} ms with a replay and "
        f"a read per iteration; captured in {prog.capture_s:.2f} s")
    if not all(equal) or not summary["finite"] or max(g[0] for g in gaps) >= 1e-4 or \
            max(g[1] for g in gaps) >= 1e-5:
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


def recompute_in_graph_ms(fa, dev, B, layers):
    """The plain recompute of one training backward's layer cores as a
    compiled step runs it: fused_edge_attention_vjp at B scenes, N = 129,
    D = 128, with and without the edge update (every input's gradient),
    each captured in a CUDA graph and timed by replays. Returns (ms of
    layers - 1 calls with the edge update and one without, [ms a call
    with, without])."""
    from mind_tpu_torch.synthetic import fusion_inputs

    w, node, edge = fusion_inputs(B, 129, 128, dev, SEED + 2)
    mask = torch.ones(B, 129, dtype=torch.bool, device=dev)
    g_out, g_edge = torch.randn_like(node), torch.randn_like(edge)
    needs = (True,) * (2 + len(w))
    per_call = []
    for ue in (True, False):
        def vjp():
            fa.fused_edge_attention_vjp("float32", node, edge, mask, w, 8, ue, g_out,
                                        g_edge if ue else None, needs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            vjp()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            vjp()
        per_call.append(cuda_time_ms(graph.replay))
        del graph
    return (layers - 1) * per_call[0] + per_call[1], per_call


def phase_training(fa, dev, batch, cpu_child):
    """14. Train PlannerConfig()'s float32 network on `batch` (four
    synthetic scenarios, training_batch): checks (a)-(f) of the module
    docstring, and the timed steps; (e)'s CPU steps are `cpu_child`'s
    (CpuReferences), run beside the card's phases on the same batch.
    Returns (kernel A's launches in the 20 steps, summary)."""
    from mind_tpu_torch.config import PlannerConfig
    from mind_tpu_torch.models import checkpoint as ckpt
    from mind_tpu_torch.models import scene_pred, train
    from torch.profiler import ProfilerActivity, profile

    from mind_tpu_torch.models.weights import unused_edge_params
    from mind_tpu_torch.synthetic import fusion_inputs

    cfg = PlannerConfig()
    t0 = time.perf_counter()
    B = batch.actors.shape[0]
    summary = {"scenes": B,
               "actors": batch.actor_mask.sum(1).tolist(),
               "lanes": batch.lane_mask.sum(1).tolist(),
               "targets": int(batch.gt_mask.sum())}
    laps = {}

    def lap(name):
        laps[name] = time.perf_counter() - t0 - sum(laps.values())

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

    lap("a_to_c")
    # (e) the same two steps on the CPU, in the child
    cpu_losses, cpu_grads, summary["cpu_two_steps_s_in_child"] = cpu_child.get("train")
    g_cpu = [None if n in exempt else torch.from_numpy(cpu_grads[n]) for n in names]
    cpu_gaps = grad_gaps(names, [g.cpu() if g is not None else None for g in g_fn], g_cpu,
                         exempt, noise, target)
    del cpu_grads, g_cpu, g_fn

    lap("cpu_child_wait")
    # (d) 20 compiled steps and 20 eager ones (graphed=False) from the same
    # initial state, under deterministic cuDNN (so that two runs of a step
    # can be equal to the bit), the launch counts set to 0 just before each
    # run and read just after; the compiled run is timed by whole steps, the
    # eager one by phase with the plain recompute of the 6 layer cores
    vjp = fa.fused_edge_attention_vjp
    replay, modes, events = torch.cuda.CUDAGraph.replay, [], []

    def watched(self):
        modes.append(torch.cuda.get_sync_debug_mode())
        replay(self)

    def timed_vjp(*a, **kw):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = vjp(*a, **kw)
        e.record()
        events.append((s, e))
        return out

    def train_run(graphed):
        net = train.init_scene_pred(cfg.net, seed=0, device=dev)
        optimizer = train.adamw(net.parameters(), TRAIN_LR)
        step = train.make_train_step(net, optimizer, graphed=graphed)
        losses, times = [], {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        try:
            for i in range(TRAIN_STEPS):
                if i == TRAIN_WARM and graphed is False:
                    fa.fused_edge_attention_vjp = timed_vjp
                losses.append(step(batch, times=times if i >= TRAIN_WARM else None))
        finally:
            fa.fused_edge_attention_vjp = vjp
        torch.cuda.synchronize()
        return {"net": net, "optimizer": optimizer, "step": step,
                "losses": [float(x) for x in losses], "times": times,
                "launches": dict(fa.fused_edge_attention.launches_by_variant),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager = train_run(False)
        torch.cuda.CUDAGraph.replay = watched
        try:
            compiled = train_run(None)
        finally:
            torch.cuda.CUDAGraph.replay = replay
    finally:
        torch.backends.cudnn.deterministic = deterministic
    net, optimizer, step = compiled["net"], compiled["optimizer"], compiled["step"]
    prog = step.program
    replays, captures = prog.replays(), len(prog.capture_s())
    launches = compiled["launches"]
    losses = compiled["losses"]
    timed = TRAIN_STEPS - TRAIN_WARM
    ms = {k: v * 1e3 / timed for k, v in eager["times"].items()}
    eager_ms = sum(ms.values())
    step_ms = compiled["times"]["step"] * 1e3 / timed
    recompute_ms = sum(s.elapsed_time(e) for s, e in events) / timed
    same = (compiled["losses"] == eager["losses"] and all(
        torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                          eager["net"].state_dict().values())) and all(
        torch.equal(x, y) for a, b in zip(optimizer.state.values(),
                                          eager["optimizer"].state.values())
        for x, y in zip(a.values(), b.values())))
    del eager["net"], eager["optimizer"], eager["step"]

    lap("d_runs")
    # the compiled step under cuDNN's default algorithms, as a caller runs
    # it: a program of its own (the setting is part of the key), timed, then
    # TRAIN_PROFILED of its replays under the profiler: the kernels a step,
    # the device's busy share and the kernels that take most of it
    t_default = {}
    for i in range(TRAIN_DEFAULT_STEPS):
        step(batch, times=t_default if i else None)
    torch.cuda.synchronize()
    default_ms = t_default["step"] * 1e3 / (TRAIN_DEFAULT_STEPS - 1)
    lap("default_cudnn")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(TRAIN_PROFILED):
            step(batch)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = busy_us([k[:2] for k in kernels]) / 1e3
    by_name = {}
    for s_, e_, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e_ - s_) / 1e3
    lap("profile")
    recompute_graph_ms, recompute_graph_calls = recompute_in_graph_ms(fa, dev, B,
                                                                      cfg.net.n_scene_layer)
    with torch.no_grad():
        w, node, edge = fusion_inputs(B, 129, 128, dev, SEED)
        mask = torch.ones(B, 129, dtype=torch.bool, device=dev)
        kernel_ms = [cuda_time_ms(lambda: fa.fused_edge_attention(node, edge, mask, w, 8, ue))
                     for ue in (True, False)]
        del w, node, edge
    kernel_fwd_ms = (cfg.net.n_scene_layer - 1) * kernel_ms[0] + kernel_ms[1]
    summary.update({
        "losses": losses, "cpu_losses": cpu_losses,
        "cpu_gap": {"loss": [abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)],
                    "grad_max": max(cpu_gaps.values()),
                    "largest": sorted(cpu_gaps.items(), key=lambda kv: -kv[1])[:5]},
        "compiled_equal_to_eager": same,
        "launches": launches, "eager_launches": eager["launches"],
        "replays": replays, "executions": cfg.net.n_scene_layer * replays,
        "replay_sync_debug_modes": sorted(set(modes)), "timed_steps": timed,
        "step_ms": step_ms, "eager_step_ms": eager_ms, "eager_ms": ms,
        "speedup": eager_ms / step_ms,
        "scenes_per_s": B * 1e3 / step_ms, "eager_scenes_per_s": B * 1e3 / eager_ms,
        "step_ms_default_cudnn": default_ms,
        "peak_memory_gb": {"compiled": compiled["peak_gb"], "eager": eager["peak_gb"]},
        "capture_reserved_gb": prog.programs[next(iter(prog.programs))].capture_reserved / 1e9,
        "recompute_ms": recompute_ms, "recompute_share_of_eager_backward":
            recompute_ms / ms["backward"],
        "recompute_in_graph_ms": recompute_graph_ms,
        "recompute_in_graph_ms_per_call": recompute_graph_calls,
        "recompute_in_graph_share_of_compiled_step": recompute_graph_ms / default_ms,
        "recomputes_per_step": len(events) / timed,
        "profile_compiled_steps": {
            "steps": TRAIN_PROFILED, "wall_ms_per_step": prof_wall_ms / TRAIN_PROFILED,
            "device_kernels_per_step": len(kernels) / TRAIN_PROFILED,
            "device_busy_ms_per_step": busy_ms / TRAIN_PROFILED,
            "device_busy_share": busy_ms / prof_wall_ms,
            "top_kernels_ms_per_step": [
                (n[:60], v / TRAIN_PROFILED)
                for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]]},
        "kernel_a_forward_ms_6_layers": kernel_fwd_ms,
        "kernel_a_ms_per_call": kernel_ms})
    if not same:
        raise RuntimeError(f"(d) the compiled steps differ from the eager ones: "
                           f"{compiled['losses']} against {eager['losses']}")
    if launches != {"float32": 2 * cfg.net.n_scene_layer, "bfloat16": 0} or \
            captures != 1 or replays != TRAIN_STEPS - 1:
        raise RuntimeError(f"(a) {launches} launches, {captures} captures and "
                           f"{replays} replays in {TRAIN_STEPS} compiled training steps")
    if eager["launches"] != {"float32": cfg.net.n_scene_layer * TRAIN_STEPS, "bfloat16": 0}:
        raise RuntimeError(f"(a) {eager['launches']} launches in {TRAIN_STEPS} eager steps")
    if modes != [2] * (TRAIN_STEPS - 1):
        raise RuntimeError(f"(d) replays outside sync debug mode 'error': {modes}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError(f"(d) losses not finite or not falling: {losses}")
    if not all(g <= TOL_TRAIN_LOSS for g in summary["cpu_gap"]["loss"]):
        raise RuntimeError(f"(e) card and CPU losses disagree: {summary['cpu_gap']}")
    if len(events) != cfg.net.n_scene_layer * timed:
        raise RuntimeError(f"{len(events)} plain recomputes in {timed} backward passes")

    lap("recompute_and_kernel_timing")
    # (f) save -> restore into a new network and optimizer -> two compiled
    # steps, against two steps of the saved one without the round trip, and
    # against two more of the saved one after loading the checkpoint back
    # into its own network and optimizer (load_state_dict puts new state
    # tensors in place: the program copies them into the ones it addresses);
    # under deterministic cuDNN, whose program is the one (d) captured
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as d:
            ckpt.save_params(d, net, step=TRAIN_STEPS, opt_state=optimizer)
            loss_on = [step(batch) for _ in range(2)]
            state_on = [t.clone() for t in net.state_dict().values()]
            net2 = train.init_scene_pred(cfg.net, seed=1, device=dev)
            net2.load_state_dict(ckpt.load_params(d, net2))
            opt2 = ckpt.load_opt_state(d, train.adamw(net2.parameters(), TRAIN_LR))
            step2 = train.make_train_step(net2, opt2)
            loss_back = [step2(batch) for _ in range(2)]
            net.load_state_dict(ckpt.load_params(d, net))
            ckpt.load_opt_state(d, optimizer)
            loss_again = [step(batch) for _ in range(2)]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same = all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(loss_on, loss_back, loss_again)) and all(
        torch.equal(a, b) and torch.equal(a, c)
        for a, b, c in zip(state_on, net2.state_dict().values(), net.state_dict().values()))
    summary["restore_equal"] = same
    lap("f")
    summary["part_s"] = laps
    summary["capture_s"] = {"first": prog.capture_s()[0], "default_cudnn": prog.capture_s()[1],
                            "restored": step2.program.capture_s()}
    summary["programs"] = {"saved": len(prog.programs), "restored": len(step2.program.programs)}
    log("[train] " + json.dumps({k: summary[k] for k in (
        "losses", "cpu_losses", "cpu_gap", "compiled_equal_to_eager", "launches",
        "eager_launches", "replays", "executions", "step_ms", "eager_step_ms", "eager_ms",
        "speedup", "scenes_per_s", "eager_scenes_per_s", "step_ms_default_cudnn",
        "peak_memory_gb", "capture_reserved_gb", "recompute_ms",
        "recompute_share_of_eager_backward", "recompute_in_graph_ms",
        "recompute_in_graph_ms_per_call", "recompute_in_graph_share_of_compiled_step",
        "profile_compiled_steps", "kernel_a_forward_ms_6_layers", "capture_s", "programs",
        "part_s")}))
    log(f"[train] (f) restored steps equal to the continued ones and to the reloaded "
        f"ones, to the bit: {same}")
    if not same or len(prog.programs) != 2 or len(step2.program.programs) != 1:
        raise RuntimeError(f"(f) restored steps differ: losses {[float(x) for x in loss_back]}, "
                           f"continued {[float(x) for x in loss_on]}, reloaded "
                           f"{[float(x) for x in loss_again]}; programs {summary['programs']}")
    del net, net2, optimizer, opt2, batch, step, step2, prog
    torch.cuda.empty_cache()
    summary["seconds"] = time.perf_counter() - t0
    return (launches["float32"], eager["launches"]["float32"],
            summary["executions"]), summary


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


def round_programs(kinds):
    """(programs of `kinds` that run one AIME round a replay, "tree_round"
    the host generator's rounds and "mirror_forward" the float64 mirror's
    forwards; the replays they ran, counted on the device) in this
    process."""
    from mind_tpu_torch.planner import programs

    progs = [p for p in programs.programs() if p.kind in kinds]
    return len(progs), sum(int(p.rounds) for p in progs)


class ReplayModes:
    """GraphProgram.replay watched in a block: the sync debug mode of each
    replay (2: "error")."""

    def __enter__(self):
        from mind_tpu_torch.ops import graph_control as gc

        self.gc, self.replay, self.modes = gc, gc.GraphProgram.replay, []
        replay, modes = self.replay, self.modes

        def watched(prog):
            modes.append(torch.cuda.get_sync_debug_mode())
            replay(prog)

        gc.GraphProgram.replay = watched
        return self

    def __exit__(self, *exc):
        self.gc.GraphProgram.replay = self.replay


def phase_host_tree(cfg, net, scene, aime, scene_statics, fa, dev):
    """ScenarioTreeGenerator.branch_aime (host bookkeeping, planner/
    scenario_tree.py) on the card from the filled window of the float32
    path's scene: compiled (the round and the window gather as captured
    programs; a run that captures, then a warm one) and with
    graphed=False, which runs the same bodies eagerly. The trees and node
    payloads of all three, and of a fourth run whose reads DeviceReads
    counts, equal to the bit; against aime_grow_tree from the same window
    with the checks of tests/test_aime.py:70-119: the same number of trees,
    the same multiset of (duration, norm_prob rounded to 1e-4), root-child
    trajectories within 2e-3 m. A compiled tree reads the device once a
    round outside the export and replays the round program once a round
    and the window program between rounds, every replay under sync debug
    "error"; kernel A launched only by the
    captures (2 x 6 a round program captured) and by the eager run (6 a
    round), executed 6 times a round by the replays (counted on the
    device); the counts set to 0 just before each run, read just after.
    Returns (kernel A launches, executions, summary)."""
    from mind_tpu_torch.planner import programs
    from mind_tpu_torch.planner.scenario_tree import ScenarioTreeGenerator

    layers = cfg.net.n_scene_layer
    pdt = getattr(torch, cfg.pipeline_dtype)
    buf = fill_buffer(aime, scene, pdt, dev)
    statics = scene_statics(scene, pdt, dev)
    types = torch.tensor(scene.types, device=dev)
    amask = torch.tensor(scene.present, device=dev)
    pos, ang, vel, obs = aime.nn_fill_window(buf)
    cov = torch.full(obs.shape, 1e-5, dtype=torch.float64, device=dev)
    window = (pos, ang, vel, cov, obs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = set(programs.programs())
    runs, launched, executed = {}, 0, 0
    for name, graphed in (("capture", None), ("compiled", None), ("eager", False),
                          ("reads", None)):
        gen = ScenarioTreeGenerator(cfg, net, statics.lane, statics.tgt, cfg.max_actors,
                                    graphed=graphed)
        export, reads, in_export = gen._export, DeviceReads(), []

        def counted(*a, export=export, reads=reads, in_export=in_export):
            n = reads.n
            out = export(*a)
            in_export.append(reads.n - n)
            return out

        gen._export = counted
        n0, r0 = round_programs(("tree_round",))
        fa.reset_launch_counts()
        with ReplayModes() as replays, reads if name == "reads" else contextlib.nullcontext():
            t = time.perf_counter()
            trees = gen.branch_aime(window, types, amask)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        counts = dict(fa.fused_edge_attention.launches_by_variant)
        n1, r1 = round_programs(("tree_round",))
        rounds, captured, replayed = gen.last_rounds, n1 - n0, r1 - r0
        want = 2 * layers * captured + (layers * rounds if graphed is False else 0)
        if counts["float32"] != want or counts["bfloat16"] or not rounds or \
                replayed != (0 if graphed is False else rounds):
            raise RuntimeError(f"host tree ({name}): launches {counts} for {rounds} rounds, "
                               f"{captured} round programs captured, {replayed} rounds replayed")
        round_reads = reads.n - in_export[0]
        if replays.modes != [2] * (0 if graphed is False else 2 * rounds - 1) or \
                (name == "reads" and round_reads != rounds):
            raise RuntimeError(f"host tree ({name}): {round_reads} reads for {rounds} rounds, "
                               f"replays under sync debug modes {replays.modes}")
        launched += counts["float32"]
        executed += layers * replayed
        runs[name] = {"trees": trees, "s": wall, "rounds": rounds, "reads": reads.n,
                      "reads_in_rounds": round_reads, "replays": len(replays.modes),
                      "captured": captured, "launches": counts["float32"],
                      "executions": layers * replayed}
    host_trees = runs["compiled"]["trees"]
    equal = {k: len(runs[k]["trees"]) == len(host_trees) and all(
        same_trees(a, b) for a, b in zip(runs[k]["trees"], host_trees))
        for k in ("capture", "eager", "reads")}
    if not all(equal.values()) or runs["eager"]["rounds"] != runs["compiled"]["rounds"]:
        raise RuntimeError(f"host tree: compiled trees against the capture's and eager's "
                           f"{equal}")
    built = [(p.kind, p.capture_s) for p in programs.programs() if p not in before]
    peak = torch.cuda.max_memory_allocated() / 1e9

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
               "nodes": len(host_nodes), "device_nodes": len(dev_nodes),
               "rounds": runs["compiled"]["rounds"], "device_rounds": int(dev_rounds),
               "root_child_gap_m": gap, "equal_to_the_bit": equal,
               "programs_built": built, "peak_memory_gb": peak,
               "compiled_s": runs["compiled"]["s"], "eager_s": runs["eager"]["s"],
               "capture_run_s": runs["capture"]["s"], "device_aime_s": device_s,
               "reads": runs["reads"]["reads"],
               "reads_in_rounds": runs["reads"]["reads_in_rounds"],
               **{f"{k}_{f}": runs[k][f] for k in runs
                  for f in ("replays", "launches", "executions")}}
    log("[host tree] " + json.dumps(summary))
    if not host_trees or n_dev_trees != len(host_trees) or dev_nodes != host_nodes \
            or not gap <= TOL_HOST_TREE:
        raise RuntimeError(f"host tree generator disagrees with aime_grow_tree: {summary}")
    return launched, executed, summary


class ForwardCheck:
    """HostRefPlanner._forward wrapped in a block: each compiled forward's
    output (the program's buffer) against forward_body run eagerly on the
    mirror's network from the same inputs, to the bit, inline. Times the
    program's forward (copy in, replay, until the card is done; a call
    that captures apart) and the eager one; the eager forwards' kernel
    launches are counted apart (`launches`, by variant) and are no launch
    of the path."""

    def __init__(self, fa):
        self.fa = fa

    def __enter__(self):
        from mind_tpu_torch.parallel.mesh import tree_map
        from mind_tpu_torch.parity import host_planner
        from mind_tpu_torch.planner import programs

        self.hp, self.fn = host_planner, host_planner.HostRefPlanner._forward
        self.checked, self.differ, self.program_s, self.eager_s = 0, 0, [], 0.0
        self.capture_calls_s = []
        self.launches = {"float32": 0, "bfloat16": 0}
        check = self

        def forward(mirror, inputs):
            n = len(programs.programs())
            t = time.perf_counter()
            out = check.fn(mirror, inputs)
            if not programs.compiled(mirror.device, mirror.graphed):
                return out
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (check.capture_calls_s if len(programs.programs()) > n
             else check.program_s).append(t1 - t)
            before = dict(check.fa.fused_edge_attention.launches_by_variant)
            with torch.no_grad():
                want = host_planner.forward_body(mirror.net, tree_map(
                    lambda x: x.to(mirror.device), inputs))[0]
            check.differ += not torch.equal(out, want)
            check.eager_s += time.perf_counter() - t1
            check.checked += 1
            for k, n in check.fa.fused_edge_attention.launches_by_variant.items():
                check.launches[k] += n - before[k]
            return out

        host_planner.HostRefPlanner._forward = forward
        return self

    def __exit__(self, *exc):
        self.hp.HostRefPlanner._forward = self.fn


def phase_parity(dcfg, fa, data_root, syn, mirror_graphed=None):
    """The float64 mirror (parity/host_planner.py) against the port's planner
    on the closed loop's scenario under planner_config_for_demo("demo_1")
    (bf16 network, trained weights), the mirror sharing the planner's
    network on the card and, compiled (`mirror_graphed` None), running its
    forward through a program set of its own: run_parity_episode_playback (PLAYBACK_TICKS, planner on after 1 s) and
    run_parity_demo_resync (demo_1's enable time of 4 s, RESYNC_TICKS
    ticks). Each must show zero ok flips and a mean cycle deviation within
    1e-3 m; every compiled mirror forward's output equal to the bit to the
    eager network's on the same inputs (ForwardCheck, inline), no forward
    eager; kernel B launched only by the captures (the playback's episode
    program, the mirror's forward program: 2 x 6 each) and by eager AIME
    rounds, executed 6 times per round the replays ran and per mirror
    forward replayed (counted on the device), kernel A never (counts set
    to 0 just before each run, read just after; the check's launches apart).
    With mirror_graphed False every mirror forward is eager (6 launches
    each) and none is replayed. Returns {run: (kernel B launches,
    executions, summary)}."""
    from mind_tpu_torch.parity import host_planner
    from mind_tpu_torch.parity import runner
    from mind_tpu_torch.planner import planner as tplanner
    from mind_tpu_torch.planner import programs

    layers, depth = dcfg.net.n_scene_layer, dcfg.scen_tree.max_depth
    before = set(programs.programs())
    out = {}
    for name, run in (
            ("parity_playback", lambda: runner.run_parity_episode_playback(
                "demo_1", PLAYBACK_TICKS, data_root, enable_timestep=1.0, scenario=syn.scenario,
                graphed=mirror_graphed)),
            ("parity_resync", lambda: runner.run_parity_demo_resync(
                "demo_1", RESYNC_TICKS, data_root, scenario=syn.scenario,
                graphed=mirror_graphed))):
        rounds = RoundCounter(tplanner.aime_grow_tree)
        forwards = CallCounter(host_planner.HostRefPlanner._predict)
        tplanner.aime_grow_tree = rounds
        host_planner.HostRefPlanner._predict = forwards
        try:
            with ForwardCheck(fa) as check:
                fa.reset_launch_counts()
                n0, r0, _ = program_counts()
                f0, q0 = round_programs(("mirror_forward",))
                t = time.perf_counter()
                r = run()
                wall = time.perf_counter() - t
                n1, r1, _ = program_counts()
                f1, q1 = round_programs(("mirror_forward",))
                counts = dict(fa.fused_edge_attention.launches_by_variant)
        finally:
            tplanner.aime_grow_tree = rounds.fn
            host_planner.HostRefPlanner._predict = forwards.fn
        path = {k: counts[k] - check.launches[k] for k in counts}
        replayed, eager_fwd = q1 - q0, forwards.calls - (q1 - q0)
        plans = len(r["records"]) if "records" in r else r["plans"]
        summary = {k: r[k] for k in ("plans_compared", "ok_mismatches", "max_cycle_dev",
                                     "mean_cycle_dev", "max_ctrl_dev")}
        summary.update(plans=plans, eager_rounds=rounds.rounds, programs_captured=n1 - n0,
                       program_rounds=r1 - r0, mirror_forwards=forwards.calls,
                       mirror_programs_captured=f1 - f0, mirror_forwards_replayed=replayed,
                       forwards_checked=check.checked, forwards_differing=check.differ,
                       forward_program_s=float(np.mean(check.program_s or [0.0])),
                       forward_capturing_calls_s=check.capture_calls_s,
                       forward_eager_s=check.eager_s / max(check.checked, 1),
                       launches=path, check_launches=check.launches, wall_s=wall)
        if name == "parity_playback":
            mirror_s = r["mirror_wall_s"] - check.eager_s   # the inline check apart
            summary.update(episode_wall_s=r["episode_wall_s"], mirror_wall_s=mirror_s,
                           mirror_s_per_plan=mirror_s / max(plans, 1),
                           mirror_forwards_per_plan=forwards.calls / max(plans, 1),
                           fail_cycle=r["fail_cycle"])
        else:
            summary.update(ticks=r["ticks"], host_failures=r["host_failures"])
        log(f"[{name}] " + json.dumps(summary))
        if r["ok_mismatches"] or not r["plans_compared"] or \
                not r["mean_cycle_dev"] <= TOL_PARITY_MEAN or r["plans_compared"] != plans:
            raise RuntimeError(f"{name}: parity criterion failed: {summary}")
        if name == "parity_resync" and plans < 5:
            raise RuntimeError(f"{name}: {plans} plans, fewer than 5")
        compiled = mirror_graphed is not False
        if check.differ or (compiled and (eager_fwd or check.checked != forwards.calls)) or \
                (not compiled and replayed):
            raise RuntimeError(f"{name}: {check.differ} of {check.checked} mirror forwards "
                               f"differ from the eager network; {eager_fwd} of "
                               f"{forwards.calls} eager, {replayed} replayed")
        launched = layers * (rounds.rounds + eager_fwd) + \
            captured_launches(layers, depth, n1 - n0) + 2 * layers * (f1 - f0)
        if path["bfloat16"] != launched or path["float32"] or \
                not rounds.rounds + (r1 - r0) or not forwards.calls:
            raise RuntimeError(f"{name}: launches {path} for {rounds.rounds} eager AIME rounds, "
                               f"{n1 - n0} programs captured ({r1 - r0} rounds replayed), "
                               f"{forwards.calls} mirror forwards ({f1 - f0} programs "
                               f"captured, {replayed} replayed)")
        out[name] = (path["bfloat16"], layers * (r1 - r0 + replayed), summary)
    built = [p.capture_s for p in programs.programs() if p not in before
             and p.kind == "mirror_forward"]
    log(f"[parity] mirror forward programs captured in {built} s")
    out["parity_playback"][2]["mirror_programs_built"] = built
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
    """Launches of the fusion kernels by a demo-configuration driver run as
    a command (counted in its own process): kernel B a positive multiple of
    6 times (6 fusion layers per forward), kernel A never."""
    if n["float32"] != 0 or n["bfloat16"] <= 0 or n["bfloat16"] % 6:
        raise RuntimeError(f"scripts {name}: kernel launches {n}")


def add_launches(total, n):
    for v in total:
        total[v] += n[v]


def read_json(path):
    with open(path) as f:
        return json.load(f)


def run_driver(fa, name, main, argv, plans=True):
    """One driver's main(argv) in this process, the launch counts set to 0
    just before and read just after (KernelRuns); exit code 0 or raise.
    A driver that `plans` (under the demo configuration) is held to its
    AIME rounds (KernelRuns.hold). Returns (its launches by variant,
    seconds, the held runs or None)."""
    log(f"[scripts] {name} " + " ".join(argv))
    t = time.perf_counter()
    with KernelRuns(fa) as runs:
        rc = main(argv)
    wall = time.perf_counter() - t
    if rc != 0:
        raise RuntimeError(f"scripts {name}: exit code {rc}")
    log(f"[scripts] {name}: compiled programs built {runs.built}")
    return runs.counts, wall, hold_demo_runs(runs, name) if plans else None


def hold_demo_runs(runs, name):
    """KernelRuns.hold for kernel B under the demo configuration: launched 6
    times per eager AIME round and by each AIME-growing program captured,
    executed 6 times per round the replays ran, kernel A never."""
    from mind_tpu_torch.config import planner_config_for_demo

    cfg = planner_config_for_demo("demo_1")
    return runs.hold(f"scripts {name}", "bfloat16", cfg.net.n_scene_layer,
                     cfg.scen_tree.max_depth)


def phase_scripts(fa):
    """(scripts) the drivers' main([...]) in this process on synthetic_av2
    scenes at 215 ticks, outputs in a temporary directory, each check
    fatal: run_all_demos (both modes, demos 1 and 2; and its episode mode
    once more as a subprocess, the CLI itself, beside the in-process
    run_all_demos and parity_run) PASS with 3 plans a demo and
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

        def held(name, runs):
            summary.setdefault("kernel_b_executions", {})[name] = runs[1]
            summary.setdefault("condition_kernel", {})[name] = {"runs": runs[2],
                                                                "launches": runs[3]}

        def driver(name, mod, argv, plans=True):
            n, wall, runs = run_driver(fa, name, mod.main, argv, plans)
            summary["seconds"][name] = wall
            if runs is not None:
                held(name, runs)
            add_launches(total, n)
            return n

        # run_all_demos: both modes in this process; the episode mode as a CLI,
        # a subprocess that runs beside this process's run_all_demos and
        # parity_run free run (checks: their rates are printed, not held,
        # and are not the speed record's)
        cmd = [sys.executable, "-m", "mind_tpu_torch.scripts.run_all_demos", "--mode",
               "episode", "--demos", "1", *steps, "--episode-json", out("cli.json")]
        log("[scripts] " + " ".join(cmd[1:]) + " (beside the next two drivers)")
        t_cli = time.perf_counter()
        with open(out("cli.out"), "w") as cli_out:
            cli_proc = subprocess.Popen(cmd, stdout=cli_out, text=True)
        try:
            n = driver("run_all_demos", run_all_demos, [
                "--mode", "both", "--demos", "1,2", *steps, "--json-out", out("host.json"),
                "--episode-json", out("episode.json"), "--report", out("DEMOS.md")])
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

            # the north star: native_bal's free-run parity, then its throughput
            t = time.perf_counter()
            with open(out("free.log"), "w") as f, contextlib.redirect_stdout(f), \
                    KernelRuns(fa) as runs:
                parity_run.main(["--demos", "1", "--skip", "playback", "resync", "--free-modes",
                                 "native_bal", "--synthetic"])
            summary["seconds"]["parity_run_free"] = time.perf_counter() - t
            n = runs.counts
            held("parity_run_free", hold_demo_runs(runs, "parity_run"))
            add_launches(total, n)
            rc = cli_proc.wait(timeout=max(1.0, SCRIPTS_TIMEOUT_S - (time.perf_counter() - t_cli)))
        finally:
            if cli_proc.poll() is None:
                cli_proc.kill()
                cli_proc.wait()
        summary["seconds"]["run_all_demos_cli_beside"] = time.perf_counter() - t_cli
        stdout = open(out("cli.out")).read()
        (cli,) = read_json(out("cli.json"))["rows"] if rc == 0 else (None,)
        if rc != 0 or "EPISODE DEMOS PASS" not in stdout or cli["plan_calls"] != SCRIPTS_PLANS:
            raise RuntimeError(f"scripts run_all_demos CLI: exit code {rc}, "
                               f"stdout ends {stdout[-2000:]}")
        demo_launches("run_all_demos CLI", cli["launches"])
        add_launches(total, cli["launches"])
        n = driver("bench_north_star", bench_north_star, [
            "--policy", "native_bal", "--demos", "1", *steps, "--free-log", out("free.log"),
            "--out", out("north_star.json")])
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
        (strict,) = read_json(out("strict.json"))["per_demo"]
        if strict["fail_cycle"] != -1 or strict["plan_calls"] != ep_rows[0]["plan_calls"] or \
                not positive(strict["steps_per_s"]) or strict["launches"] != n:
            raise RuntimeError(f"scripts bench_strict: {strict}, float32 {ep_rows[0]}")
        summary["strict"] = dict(strict, float32_steps_per_s=ep_rows[0]["steps_per_sec"])

        # the precision-policy matrix
        n = driver("bench_exec_ab", bench_exec_ab, [*steps, "--out", out("exec_ab.json")])
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
                                                   "--out", out(name + ".json")], plans=False)
            r = read_json(out(name + ".json"))
            gap = r["kernel_vs_plain"]
            if n[variant] != 6 * r["fusion_passes"] or not r["fusion_passes"] or n[other] or \
                    r["launches"] != n or not gap["cls_prob"] < TOL_NET_CLS or \
                    not gap["positions_m"] < TOL_NET_POS or not positive(r["full_fwd_ms"]):
                raise RuntimeError(f"scripts {name}: launches {n}, {r}")
            summary[name] = r
        n = driver("bench_fusion", bench_fusion, ["--reps", str(SCRIPTS_FUSION_REPS),
                                                  "--out", out("fusion.json")], plans=False)
        r = read_json(out("fusion.json"))
        gap = r["kernel_vs_plain"]
        if n != {"float32": 6 * r["kernel_forwards"], "bfloat16": 0} or r["launches"] != n or \
                not gap["cls_prob"] < TOL_NET_CLS or not gap["positions_m"] < TOL_NET_POS:
            raise RuntimeError(f"scripts bench_fusion: launches {n}, {r}")
        summary["bench_fusion"] = r

        # the playback parity's stage-by-stage dump
        n = driver("diag_playback", diag_playback, [
            "--demo", "demo_1", *steps, "--worst", "3", "--out", out("diag.json")])
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
DIST_RANKS, DIST_K, DIST_PER_RANK, DIST_TICKS = 2, 8, 2, 15
DIST_TRAIN_STEPS = 3
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
    deterministic cuDNN (as the ranks run them; compiled where the mesh is
    on one card, eagerly across cards)."""
    from mind_tpu_torch.models import train
    from mind_tpu_torch.parallel.scale import make_tree_batch, parallel_tree_solve
    from mind_tpu_torch.planner.ilqr import ILQRConfig
    from mind_tpu_torch.sim.episode import program_rounds, run_episode_monte_carlo

    out = {}
    sim = spec.build(dev)
    walls = []
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    rounds = program_rounds()
    t = time.perf_counter()
    out["results"] = run_episode_monte_carlo(sim, k=DIST_K, chunk=DIST_PER_RANK, seg_cycles=10,
                                             mesh=mesh, chunk_walls=walls)
    torch.cuda.synchronize()
    out.update(wall_s=time.perf_counter() - t, chunk_walls=walls,
               launches=dict(fa.fused_edge_attention.launches_by_variant),
               aime_rounds=program_rounds() - rounds)
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
    out["train_compiled"] = step.program is not None
    return out


def train_job_runs(label, tr):
    """A rank's training job ran the compiled step's two programs around the
    all-reduce: one capture, the later steps replays counted on the device,
    kernel A launched 6 times by the first call's eager step and 6 by the
    capture, B never. Returns kernel A's executions by the replays."""
    if tr["captures"] != 1 or tr["replays"] != DIST_TRAIN_STEPS - 1 or \
            tr["launches"] != {"float32": 2 * 6, "bfloat16": 0}:
        raise RuntimeError(f"{label}: training launches {tr['launches']}, "
                           f"{tr['captures']} captures, {tr['replays']} replays in "
                           f"{DIST_TRAIN_STEPS} steps")
    return 6 * tr["replays"]


def hold_dist(label, ranks, seq):
    """Each rank's copies, trees and training equal to the sequential
    mesh's, to the bit, and the parameters equal across ranks; kernel B
    executed by the ranks' sweeps as often as by the sequential one (the
    same shards: as many AIME rounds of the compiled episode programs,
    counted on the device), launched in multiples of 6 (the programs'
    captures), kernel A never; each rank's training as train_job_runs
    holds it. Returns the summary of the comparison."""
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
        if n["float32"] != 0 or n["bfloat16"] <= 0 or n["bfloat16"] % 6:
            raise RuntimeError(f"{label}: rank {r}'s launches: sweep {n}")
        train_job_runs(f"{label}: rank {r}", tr)
    total = sum(rank["monte_carlo"]["aime_rounds"] for rank in ranks)
    if total != seq["aime_rounds"] or not total or seq["launches"]["float32"] != 0:
        raise RuntimeError(f"{label}: the ranks' programs ran {total} AIME rounds, the "
                           f"sequential sweep's {seq['aime_rounds']} (launches {seq['launches']})")
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
            "train_setup_and_first_step_s_per_rank": [
                (rank["train"]["setup_s"], rank["train"]["first_step_s"]) for rank in ranks],
            "train_sequential_compiled": seq["train_compiled"],
            "rank_job_s": [rank["seconds"] for rank in ranks],
            "train_losses": seq["losses"],
            "launches_by_rank": [{"monte_carlo": rank["monte_carlo"]["launches"],
                                  "train": rank["train"]["launches"]} for rank in ranks],
            "aime_rounds": {"ranks": [rank["monte_carlo"]["aime_rounds"] for rank in ranks],
                            "one_process": seq["aime_rounds"]},
            "one_process_launches": seq["launches"]}


def phase_dist(dcfg, fa, synthetic_av2):
    """(dist) the shards run at the same time, one process per shard
    (parallel/launch.py): (a)-(c) two ranks on the one card (gloo) run the
    Monte-Carlo sweep, the 1024-tree solve (2 x 512) and 3 training steps,
    each held to the bit against the sequential two-shard mesh here; (c)
    also rank 0 alone on nccl (the whole batch) against the unsharded step; (d)
    with two cards or more, one rank per card on nccl against the
    sequential mesh across the two cards. Each rank trains through the
    compiled step's two programs around the all-reduce. Returns ({variant:
    the ranks' launches}, kernel A's executions by the ranks' training
    replays, summary)."""
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
    launches, executions = {"float32": 0, "bfloat16": 0}, 0
    with tempfile.TemporaryDirectory() as data_root:
        spec = demo_spec("demo_1", SEED, data_root, ticks=DIST_TICKS, planner_cfg=dcfg,
                         enable_timestep=1.0, target_velocity=TARGET_VELOCITY)
        jobs = dist_jobs(spec, cfg.net, batch)
        # (c)'s nccl rank: rank 0 of the same world, alone in an nccl group
        train_kw = dict(jobs)["train"]
        torch.cuda.empty_cache()
        t, t_epoch = time.perf_counter(), time.time()
        ranks = launch(target, DIST_RANKS, args=(jobs + [("train_on_nccl", train_kw)],),
                       ranks_per_card=DIST_RANKS, timeout=DIST_TIMEOUT_S)
        summary["launch_s"] = time.perf_counter() - t
        summary["rank_start_s"] = [rank["seconds"]["start"] - t_epoch for rank in ranks]
        seq = dist_sequential(fa, make_mesh(DIST_RANKS, device=dev), spec, cfg.net, batch, dev)
        summary["gloo_on_the_card"] = ranks[0]["collectives_on_device"]
        summary["one_card"] = hold_dist("dist (a)-(c)", ranks, seq)
        for rank in ranks:
            for job in ("monte_carlo", "train"):
                for v, n in rank[job]["launches"].items():
                    launches[v] += n
            executions += 6 * rank["train"]["replays"]
        # (c) nccl: rank 0 alone in an nccl group, the whole batch, against
        # the unsharded step
        nccl = {"train": ranks[0]["train_on_nccl"], "seconds": ranks[0]["seconds"]}
        if ranks[1]["train_on_nccl"] is not None:
            raise RuntimeError("dist (c): rank 1 ran the nccl rank's training")
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
        executions += train_job_runs("dist (c) nccl", nccl["train"])
        launches["float32"] += nccl["train"]["launches"]["float32"]
        summary["nccl_train"] = {"losses": want, "launches": nccl["train"]["launches"],
                                 "replays": nccl["train"]["replays"],
                                 "step_ms": {k: 1e3 * v / nccl["train"]["timed_steps"]
                                             for k, v in nccl["train"]["times"].items()},
                                 "setup_and_first_step_s": (nccl["train"]["setup_s"],
                                                            nccl["train"]["first_step_s"]),
                                 "rank_job_s": nccl["seconds"]["train_on_nccl"]}
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
                executions += 6 * rank["train"]["replays"]
        else:
            log(f"[dist] (d) not run: {cards} CUDA device; one rank per card on nccl and the "
                "sequential mesh across cards need two")
            summary["two_cards"] = f"not run: {cards} CUDA device"
    summary["seconds"] = time.perf_counter() - t_phase
    log("[dist] " + json.dumps(summary))
    return launches, executions, summary


def main() -> int:
    global T0, PEAKS, BUILD
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
    # 0. probe and 1. build side by side: the probe is a subprocess, the build
    # nvcc's; nothing runs on the card before the probe has passed
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        probe = pool.submit(phase_probe)
        tiled_build = BUILD = phase_build(fa)
        probe_s = probe.result()   # raises where the probe failed
    laps = {"probe_and_build": time.perf_counter() - T0}
    # the CPU halves of phases 7 and 4 run in a child beside the card's phases
    cpu_child = CpuReferences()

    def lap(name):
        """Seconds of the phase that just ended, since the previous lap."""
        laps[name] = time.perf_counter() - T0 - sum(laps.values())
    cfg = PlannerConfig()
    A, L = cfg.max_actors, cfg.max_lanes
    scene = synthetic_scene(SEED, A, L, n_agents=40)

    # 2. kernels vs plain at the main path's shapes and token mask
    token_mask = torch.tensor(np.concatenate([scene.present, scene.lane_mask, [True]]),
                              device=dev)
    entries = phase_kernel_check(fa, dev, token_mask)
    entries.append(phase_condition_kernel(dev))
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

    # the first cycle again on the CPU, through the plain version, in the
    # child (held where phase 7 reads the child's results, after 12b)
    out0, best0, buf0 = first
    cpu_child.send(buf0)
    # phase 14's training batch, built now so that the child runs its CPU
    # steps beside the card's phases
    t = time.perf_counter()
    train_batch = training_batch(PlannerConfig(), dev, synthetic_av2)
    cpu_child.send(train_batch)
    log(f"[train] batch of {train_batch.actors.shape[0]} scenes built in "
        f"{time.perf_counter() - t:.2f} s and sent to the CPU child")

    # 4a. the host tree generator, compiled and eager, against the device AIME,
    # float32 network
    host_tree_launches, host_tree_executions, host_tree = phase_host_tree(
        cfg, net, scene, aime, scene_statics, fa, dev)
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

    loop_runs, loop, loop_sim6, loop_plans6 = phase_closed_loop(dcfg, fa, syn, LANE_W,
                                                                AV2_ORIGIN)
    loop_ego = loop_sim6.ego_trajectory()
    lap("closed_loop")
    command_runs, command = phase_demo_command(fa, loop, loop_plans6, loop_ego, card)
    lap("demo_command")
    # [widths] (e): the networks' plan cycles, whose CPU forwards the child
    # computes beside the phases that follow; then the rest of the tiled
    # build starts, for (a)-(c) after (dist)
    tiled_build.join_networks()
    widths_runs = {"float32": [0, 0], "bfloat16": [0, 0]}
    widths_cycles = widths_plan_cycles(fa, dev, cpu_child, widths_runs)
    tiled_build.release()
    lap("widths_plan_cycles")
    with tempfile.TemporaryDirectory() as data_root:
        prog_b, prog_a, prog_cond, plan_progs = phase_plan_programs(
            dcfg, fa, loop, loop_sim6, loop_plans6, data_root, card)
        del loop_sim6, loop_plans6
        lap("plan_programs")
        execs = phase_exec_resolve(float32_cfg, data_root)
        lap("exec_resolve")
        graph = phase_graph_vs_eager(cfg, net, scene, aime, scene_statics, dev)
        lap("graph_vs_eager")
        episode_launches, episode, eager_episode = phase_episode(dcfg, fa, data_root, loop_ego,
                                                                 loop["plan_calls"])
        lap("episode")
        compiled_launches, compiled_executions, cond_launches, compiled = phase_compiled(
            dcfg, fa, data_root, loop_ego, eager_episode, episode)
        lap("compiled")
        batched_launches, batched = phase_batched_episode(dcfg, fa, data_root)
        lap("batched_episode")
        mc_launches, monte_carlo = phase_monte_carlo(dcfg, fa, data_root)
        lap("monte_carlo")
        # 12a-b. the float64 mirror against the planner, on demo_1's configuration
        # file with the loop's scenario, whose map loop_sim wrote under demo_1's seq_id
        parity = phase_parity(dcfg, fa, data_root, syn)
        lap("parity")
        # 12c. the scale-out runners' compiled programs
        scaleout_b, scaleout_cond, scaleout = phase_scaleout_programs(dcfg, fa, data_root, card)
        lap("scaleout_programs")
        # 7. (and phase 4's reference plan) last in this block: the child that
        # runs their CPU halves has had the phases above to finish
        out_cpu, best_cpu, cpu_plan_s = cpu_child.get("plan")
        log(f"[reference] CPU plain plan: out={out_cpu.tolist()} best={best_cpu} "
            f"in {cpu_plan_s:.1f} s (in the child)")
        if out_cpu[2] != out0[2] or best_cpu != best0 or \
                np.abs(out_cpu[:2] - out0[:2]).max() > 1e-3:
            raise RuntimeError(f"card plan {out0} (tree {best0}) disagrees with the CPU "
                               f"plan {out_cpu} (tree {best_cpu})")
        loop32_runs, loop32 = phase_float32_loop(float32_cfg(), fa, data_root, cpu_child)
        lap("float32_loop")
    from mind_tpu_torch.ops import graph_control

    cond0 = graph_control.set_conditional_any.launches
    scale = phase_tree_scale()
    scale_cond = graph_control.set_conditional_any.launches - cond0
    lap("tree_scale")
    (train_launches, train_eager_launches, train_executions), training = phase_training(
        fa, dev, train_batch, cpu_child)
    lap("training")
    bench_launches, bench = phase_bench()
    lap("bench")
    scripts_launches, scripts = phase_scripts(fa)
    lap("scripts")
    cond0 = graph_control.set_conditional_any.launches
    dist_launches, dist_executions, dist = phase_dist(dcfg, fa, synthetic_av2)
    dist_cond = graph_control.set_conditional_any.launches - cond0
    lap("dist")
    # [widths] (a)-(c), here so that the background build of the tiled widths
    # has had the phases since the demo command: both kernels alone at the
    # other widths of their domain
    tiled_build.join()
    widths_by_width, widths_gap, widths_refused = phase_widths_kernels(fa, dev, token_mask)
    for e, variant in zip(entries, ("float32", "bfloat16")):
        e["by_width"] = {"128/128/8": {k: e[k] for k in ("ms", "plain_ms", "bound_ms",
                                                         "bound_by", "max_abs_err")},
                         **{k: {x: v for x, v in r.items() if x != "by_case"}
                            for k, r in widths_by_width[variant].items()}}
        e["batch_gap_32_vs_8_by_width"] = {k: g[variant] for k, g in widths_gap.items()}
    lap("widths_kernels")
    # [widths] (d)-(f): the 4-head, 32-wide network's plans and training steps
    with tempfile.TemporaryDirectory() as data_root:
        widths_runs, widths_cond, widths = phase_widths_network(
            fa, dev, data_root, train_batch, cpu_child, widths_runs, widths_cycles)
    cpu_child.get("done")
    widths.update(refused_outside_the_domain=widths_refused, batch_gaps=widths_gap)
    lap("widths_network")
    # launches per path; "launches" stays the sum over the paths that run the kernel
    entries[0]["launches_by_path"] = {"plan_cycles": entries[0]["launches"],
                                      "host_tree": host_tree_launches,
                                      "plan_programs": prog_a[0],
                                      "float32_loop": loop32_runs[0],
                                      "training": train_launches,
                                      "training_eager": train_eager_launches,
                                      "bench": bench_launches["float32"],
                                      "scripts": scripts_launches["float32"],
                                      "dist": dist_launches["float32"],
                                      "widths": widths_runs["float32"][0]}
    entries[1]["launches_by_path"] = {"plan_cycles": entries[1]["launches"],
                                      "closed_loop": loop_runs[0],
                                      "demo_command": command_runs[0],
                                      "plan_programs": prog_b[0],
                                      "episode": episode_launches,
                                      "batched_episode": batched_launches,
                                      "monte_carlo": mc_launches,
                                      **{k: v[0] for k, v in parity.items()},
                                      "scaleout_programs": scaleout_b[0],
                                      "bench": bench_launches["bfloat16"],
                                      "scripts": scripts_launches["bfloat16"],
                                      "dist": dist_launches["bfloat16"],
                                      "widths": widths_runs["bfloat16"][0]}
    # the compiled programs launch kernel B (A) when they capture; their
    # replays execute it layers x the device's AIME rounds
    entries[1]["launches_by_path"]["compiled_episode"] = compiled_launches
    entries[0]["executions_by_path"] = {"host_tree": host_tree_executions,
                                        "plan_programs": prog_a[1],
                                        "float32_loop": loop32_runs[1],
                                        "training": train_executions,
                                        "dist": dist_executions,
                                        "widths": widths_runs["float32"][1]}
    cond_scripts = scripts["condition_kernel"].values()
    entries[1]["executions_by_path"] = {"compiled_episode_timed": compiled_executions,
                                        "closed_loop": loop_runs[1],
                                        "demo_command": command_runs[1],
                                        "plan_programs": prog_b[1],
                                        "scaleout_programs": scaleout_b[1],
                                        **{k: v[1] for k, v in parity.items()},
                                        "scripts": sum(scripts["kernel_b_executions"].values()),
                                        "widths": widths_runs["bfloat16"][1]}
    entries[2]["launches_by_path"] = {"compiled_episode": cond_launches,
                                      "closed_loop": loop_runs[3],
                                      "demo_command": command_runs[3],
                                      "plan_programs": prog_cond[0],
                                      "float32_loop": loop32_runs[3],
                                      "scaleout_programs": scaleout_cond[0],
                                      "tree_scale": scale_cond,
                                      "scripts": sum(c["launches"] for c in cond_scripts),
                                      "dist_in_process": dist_cond,
                                      "widths": widths_cond[0]}
    entries[2]["executions_by_path"] = {
        "compiled_episode_timed": compiled["condition_kernel_runs_timed"],
        "closed_loop": loop_runs[2], "demo_command": command_runs[2],
        "plan_programs": prog_cond[1], "float32_loop": loop32_runs[2],
        "scaleout_programs": scaleout_cond[1],
        "tree_scale": scale["condition_kernel_runs"],
        "scripts": sum(c["runs"] for c in cond_scripts),
        "widths": widths_cond[1]}
    for e in entries:
        e["launches"] = sum(e["launches_by_path"].values())

    # 16. report
    log("[phases] " + json.dumps({"probe_s": probe_s, "float32": cycles32,
                                  "host_tree": host_tree, "demo_bf16": cycles16,
                                  "demo_net_err": net_err, "closed_loop": loop,
                                  "demo_command": command, "plan_programs": plan_progs,
                                  "float32_loop": loop32, "exec_resolve": execs,
                                  "graph_vs_eager": graph, "episode": episode,
                                  "compiled": compiled,
                                  "batched_episode": batched, "monte_carlo": monte_carlo,
                                  **{k: v[2] for k, v in parity.items()},
                                  "scaleout_programs": scaleout,
                                  "tree_scale": scale, "training": training,
                                  "bench_wall_s": bench["wall_s"],
                                  "scripts_s": scripts["seconds"], "dist": dist,
                                  "widths": widths,
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
    try:
        rc = main()
    finally:
        if BUILD is not None:
            BUILD.close()
    sys.exit(rc)
