"""Smoke run of the PyTorch port (mind_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure ends the run with a non-zero exit and no
result line):
  1. build the CUDA kernel (mind_tpu_torch/ops/csrc/fusion_attention.cu,
     sm_90a) from the checkout;
  2. hold the kernel against its plain PyTorch version at the main path's
     shapes (B = 8 AIME nodes, N = 48 + 80 + 1 = 129 tokens, D = 128) for
     both update_edge values, and time both against the card's bound;
  3. load the trained ScenePredNet weights from the committed archive;
  4. run plan cycles of fused_plan_core at full width on a seeded synthetic
     scene (48 actor slots, 80 lane segments, 256-point target lane),
     rolling the observation window between cycles; the first cycle is held
     against the same cycle on the CPU through the plain version;
  5. print per-phase times, the kernel table and the card.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit from nvidia-smi, and before that one JSON line
{"kernels": [...]}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_CYCLES = 3
SEED = 0
PEAK_F32_FLOPS = 67e12     # H100 SXM, float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3
TOL_KERNEL = 2e-4


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
    fa.build_kernel()
    log(f"[build] fusion_attention.cu built and loaded in {time.perf_counter() - t:.3f} s")
    if fa.build_kernel.log:
        log(fa.build_kernel.log.strip())


def phase_kernel_check(fa, dev, key_mask):
    """Kernel vs plain at B = 8, N = 129 on random inputs with the main
    path's token mask; returns the kernel table entry (launches filled in
    later)."""
    B, N, D, H = key_mask.shape[0], key_mask.shape[1], 128, 8
    g = torch.Generator(device="cpu").manual_seed(SEED)
    rn = lambda *s, sc=0.08: (torch.randn(*s, generator=g) * sc).to(dev)
    w = fa.FusionWeights(**{
        f: (rn(D, D) if f.startswith("w") else
            1 + rn(D, sc=0.1) if f.endswith("_g") else rn(D, sc=0.1))
        for f in fa.FusionWeights._fields})
    node = rn(B, N, D, sc=1.0)
    edge = rn(B, N, N, D, sc=0.5)
    err, ms, plain_ms, bound_ms = {}, {}, {}, {}
    for ue in (True, False):
        out, edge_out = fa.fused_edge_attention(node, edge, key_mask, w, H, ue)
        torch.cuda.synchronize()
        ref_out, ref_edge = fa.fused_edge_attention_ref(node, edge, key_mask, w, H, ue)
        err[ue] = max((out - ref_out).abs().max().item(),
                      (edge_out - ref_edge).abs().max().item())
        if not ue and edge_out is not edge:
            raise RuntimeError("passthrough must return the input edge")
        ms[ue] = cuda_time_ms(lambda: fa.fused_edge_attention(node, edge, key_mask, w, H, ue))
        plain_ms[ue] = cuda_time_ms(
            lambda: fa.fused_edge_attention_ref(node, edge, key_mask, w, H, ue))
        bound_ms[ue] = 1e3 * max(fa.fused_edge_attention_flops(B, N, D, ue) / PEAK_F32_FLOPS,
                                 fa.fused_edge_attention_bytes(B, N, D, ue) / PEAK_HBM_BYTES)
        log(f"[kernel] update_edge={ue}: max_abs_err={err[ue]:.3e} kernel={ms[ue]:.4f} ms "
            f"plain={plain_ms[ue]:.4f} ms bound={bound_ms[ue]:.4f} ms "
            f"({fa.fused_edge_attention_flops(B, N, D, ue) / 1e9:.2f} GFLOP, "
            f"{fa.fused_edge_attention_bytes(B, N, D, ue) / 1e6:.1f} MB)")
        if not err[ue] < TOL_KERNEL:
            raise RuntimeError(f"kernel disagrees with plain: {err[ue]} >= {TOL_KERNEL}")
    # a forward runs 5 launches with the edge update and 1 without: the
    # table gives the mean per launch of that mix
    mix = lambda d: (5 * d[True] + d[False]) / 6
    return {
        "name": "fused_edge_attention",
        "route": "cuda",
        "source": "mind_tpu_torch/ops/csrc/fusion_attention.cu",
        "replaces": "mind_tpu/ops/fusion_attention.py:95 (_kernel, pallas_call at :182)",
        "launches": None,
        "max_abs_err": max(err.values()),
        "ms": mix(ms), "plain_ms": mix(plain_ms), "bound_ms": mix(bound_ms),
        "bound_by": "operations",
        "library_ms": None,
        "shape": f"B={B} N={N} D={D} heads={H} float32",
        "by_update_edge": {str(k).lower(): {"ms": ms[k], "plain_ms": plain_ms[k],
                                            "bound_ms": bound_ms[k], "max_abs_err": err[k]}
                           for k in (True, False)},
    }


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from mind_tpu_torch.common.kinematics import kine_propagate
    from mind_tpu_torch.config import DEFAULT_WEIGHTS, PlannerConfig
    from mind_tpu_torch.models.weights import load_scene_pred
    from mind_tpu_torch.ops import fusion_attention as fa
    from mind_tpu_torch.planner import aime_device as aime
    from mind_tpu_torch.planner import planner as tplanner
    from mind_tpu_torch.planner.trajectory_tree import make_cost_params
    from mind_tpu_torch.synthetic import scene_statics, synthetic_scene

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")
    cfg = PlannerConfig()
    A, L = cfg.max_actors, cfg.max_lanes
    scene = synthetic_scene(SEED, A, L, n_agents=40)

    # 1. build
    phase_build(fa)

    # 2. kernel vs plain at the main path's shapes and token mask
    token_mask = torch.tensor(np.concatenate([scene.present, scene.lane_mask, [True]]),
                              device=dev)
    entry = phase_kernel_check(fa, dev, token_mask[None].expand(
        cfg.scen_tree.max_branch_nodes, -1).contiguous())

    # 3. trained weights
    t = time.perf_counter()
    net = load_scene_pred(cfg.net, DEFAULT_WEIGHTS, dev)
    log(f"[weights] {DEFAULT_WEIGHTS.name}: {sum(p.numel() for p in net.parameters())} "
        f"parameters loaded in {time.perf_counter() - t:.3f} s")

    # 4. plan cycles on the card
    pdt = getattr(torch, cfg.pipeline_dtype)
    world = World(scene)
    buf = fill_buffer(aime, scene, pdt, dev)
    statics = scene_statics(scene, pdt, dev)
    mods = (tplanner, make_cost_params)
    first = None
    fa.fused_edge_attention.launches = 0
    total_rounds = 0
    cycles = []
    for c in range(N_CYCLES):
        report = {}
        before = fa.fused_edge_attention.launches
        t = time.perf_counter()
        out = plan_once(mods, net, cfg, world, buf, statics, dev, report)
        wall = time.perf_counter() - t
        launched = fa.fused_edge_attention.launches - before
        rounds = report["rounds"]
        total_rounds += rounds
        log(f"[plan {c}] out={out.tolist()} rounds={rounds} trees={int(report['trees'].n_trees)} "
            f"best={int(report['best'])} launches={launched} wall={wall * 1e3:.1f} ms | "
            + " ".join(f"{k}={report[k] * 1e3:.1f} ms"
                       for k in ("aime", "cost_topology", "solve", "selection")))
        if out.shape != (4,) or not np.isfinite(out).all():
            raise RuntimeError(f"plan output not finite: {out}")
        if out[2] != 1.0:
            raise RuntimeError("plan failed: no scenario tree (ok = 0)")
        if launched != cfg.net.n_scene_layer * rounds:
            raise RuntimeError(f"{launched} kernel launches for {rounds} AIME rounds")
        cycles.append({"wall_ms": wall * 1e3, "rounds": rounds,
                       **{k: report[k] * 1e3 for k in ("aime", "cost_topology", "solve",
                                                        "selection")}})
        if first is None:
            first = (out, int(report["best"]), buf, world.x0())
        world.step(out[:2], kine_propagate)
        states = torch.tensor(world.state, device=dev)
        buf = aime.obs_buffer_update(buf, states, torch.tensor(scene.present, device=dev))
    entry["launches"] = fa.fused_edge_attention.launches
    if entry["launches"] != cfg.net.n_scene_layer * total_rounds or entry["launches"] == 0:
        raise RuntimeError("the main path did not run through the kernel")

    # the first cycle again on the CPU, through the plain version
    out0, best0, buf0, x00 = first
    cpu = torch.device("cpu")
    net_cpu = load_scene_pred(cfg.net, DEFAULT_WEIGHTS, cpu)
    world_cpu = World(scene)
    buf_cpu = aime.DeviceObsBuffer(*(t.cpu() for t in buf0))
    report = {}
    t = time.perf_counter()
    out_cpu = plan_once(mods, net_cpu, cfg, world_cpu, buf_cpu,
                        scene_statics(scene, pdt, cpu), cpu, report)
    log(f"[reference] CPU plain plan: out={out_cpu.tolist()} best={int(report['best'])} "
        f"in {time.perf_counter() - t:.1f} s")
    if out_cpu[2] != out0[2] or int(report["best"]) != best0 or \
            np.abs(out_cpu[:2] - out0[:2]).max() > 1e-3:
        raise RuntimeError(f"card plan {out0} (tree {best0}) disagrees with the CPU "
                           f"plan {out_cpu} (tree {int(report['best'])})")

    # 5. report
    log("[phases] " + json.dumps({"cycles": cycles}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
