"""The whole ScenePredNet forward with the fusion kernel against the plain
core, at the planner's shapes (PlannerConfig: 48 actors + 80 lanes + 1 cls
= 129 tokens; float32 network, kernel A) (counterpart of the JAX package's
scripts/bench_fusion.py, which decided use_pallas_fusion from it).

    python -m mind_tpu_torch.scripts.bench_fusion [--batch 6] [--reps 50]
        [--out outputs/torch/fusion.json] [--device cpu]

Inputs are normal draws from a seeded torch.Generator (masks all present,
target RPE zero), the network seeded too. After 2 s of warm-up (the card's
clocks ramp up under load) each path runs two windows of --reps forwards,
in the turns plain, kernel, kernel, plain, each window timed on the host
clock between synchronizes, then the card's busy time per forward of each
under torch.profiler. Prints and writes ms per forward of each, the
speedup, the largest difference of the regression outputs and the
kernels' launches over the kernel path's forwards. It needs a card unless --device cpu (where both paths are the
plain core).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from mind_tpu_torch.scripts import (OUT, device_name, launched_since, launches, synchronize,
                                    write_json)
from mind_tpu_torch.scripts.bench_forward_split import (device_busy_ms, forward_gap, plain_core,
                                                        warm_up)


def fusion_inputs(cfg, A: int, L: int, batch: int, device, seed: int = 0):
    """The JAX script's inputs, drawn on the CPU from `seed`."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g).to(device)
    ones = lambda *s: torch.ones(*s, dtype=torch.bool, device=device)
    N = A + L
    return (rn(batch, A, cfg.obs_len - 2, cfg.in_actor), ones(batch, A),
            rn(batch, L, 10, cfg.in_lane), ones(batch, L), rn(batch, N, N, cfg.d_rpe_in),
            rn(batch, 10, cfg.in_lane), torch.zeros(batch, 20, device=device))


def time_paths(net, inputs, reps: int, device):
    """({"plain": ms, "kernel": ms} per forward on the host clock, the same
    as the card's busy ms (None off the card), {path: last output}, the
    kernel path's forwards): after bench_forward_split's warm-up, two
    windows of `reps` forwards per path, in the turns plain, kernel, kernel,
    plain, each window synchronized on the host clock."""
    import torch

    forwards = []

    def kernel():
        forwards.append(1)
        return net(*inputs)

    def plain():
        with plain_core(net):
            return net(*inputs)

    paths = {"plain": plain, "kernel": kernel}
    total, out = dict.fromkeys(paths, 0.0), {}
    with torch.no_grad():
        warm_up(list(paths.values()), device)
        for name in ("plain", "kernel", "kernel", "plain"):
            synchronize(device)
            t0 = time.perf_counter()
            for _ in range(reps):
                out[name] = paths[name]()
            synchronize(device)
            total[name] += time.perf_counter() - t0
        busy = {k: device_busy_ms(fn, device) for k, fn in paths.items()}
    return ({k: t / (2 * reps) * 1e3 for k, t in total.items()}, busy, out, len(forwards))


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m mind_tpu_torch.scripts.bench_fusion",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=str(OUT / "fusion.json"))
    ap.add_argument("--device", help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from mind_tpu_torch.common.device import resolve_device
    from mind_tpu_torch.config import PlannerConfig
    from mind_tpu_torch.models.weights import load_scene_pred

    opts = _parse(argv)
    device = resolve_device(opts.device)
    pcfg = PlannerConfig()
    net = load_scene_pred(pcfg.net, None, device, seed=0)
    inputs = fusion_inputs(pcfg.net, pcfg.max_actors, pcfg.max_lanes, opts.batch, device)
    launched_before = launches()
    ms, busy, outs, forwards = time_paths(net, inputs, opts.reps, device)
    out = {"device": device_name(device), "batch": opts.batch, "plain_ms": ms["plain"],
           "kernel_ms": ms["kernel"], "speedup": ms["plain"] / ms["kernel"],
           "plain_device_busy_ms": busy["plain"], "kernel_device_busy_ms": busy["kernel"],
           "max_reg_diff": (outs["plain"][1] - outs["kernel"][1]).abs().max().item(),
           "kernel_vs_plain": forward_gap(outs["kernel"], outs["plain"]),
           "launches": launched_since(launched_before), "kernel_forwards": forwards}
    print(json.dumps(out))
    write_json(opts.out, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
