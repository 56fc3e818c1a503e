"""The scene-prediction forward split by submodule at the planner's batch
shape (B = 8 nodes, A = 48 actors, L = 80 lanes), with the plain path's
FLOPs and MFU (counterpart of the JAX package's
scripts/bench_forward_split.py).

    python -m mind_tpu_torch.scripts.bench_forward_split [--compute-dtype bfloat16|float32]
        [--no-kernel] [--out outputs/torch/forward_split.json] [--device cpu]

The network is seeded (load_scene_pred(seed=0)) at NetConfig's widths; the
default bfloat16 runs kernel B, float32 kernel A, and --no-kernel runs the
plain fusion core in their place (the module attribute swapped, restored on
exit). Times are medians of 10 host-clock runs, each ended by a
synchronize, after 2 s of warm-up (the card's clocks ramp up under load;
the submodules, timed last, after one call each):
the whole forward on the chosen path and on the plain core, timed in turns,
and ActorNet, LaneNet (lanes and target nodes), FusionNet and SceneDecoder
on the chosen path and the inputs the whole forward gives them; beside the
two whole forwards, the card's busy time per forward under torch.profiler
(the union of its kernels' intervals), which the host's launches can leave
far below the host-clock time. The
FLOPs are bench.py's count (FlopCounterMode on the plain path of a CPU
copy; products and convolutions); MFU divides them by the time of the
chosen path's and of the plain forward, and the card's dense bf16 peak
(utils/device_specs.py); none off the card. The output
also holds the fusion kernels' launches and the FusionNet passes that
reach the kernel wrapper (6 launches per pass on the card), and the
largest gap between the chosen path's outputs and the plain core's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from mind_tpu_torch.scripts import (OUT, device_name, launched_since, launches, synchronize,
                                    write_json)

A, L, B = 48, 80, 8
TIMED_RUNS = 10
WARM_S = 2.0
SUBMODULES = ("ActorNet_0", "LaneNet_0", "FusionNet_0", "SceneDecoder_0")


@contextlib.contextmanager
def plain_core(net):
    """The network's fusion layers on the plain version of their core (the
    variant of its compute dtype) within the block."""
    from mind_tpu_torch.models import scene_pred
    from mind_tpu_torch.ops import fusion_attention as fa

    scene_pred.fused_edge_attention = fa._PLAIN[net.cfg.compute_dtype]
    try:
        yield
    finally:
        scene_pred.fused_edge_attention = fa.fused_edge_attention


def warm_up(fns, device):
    """Run `fns` in turn, synchronized, for WARM_S seconds at least: the
    card's clocks ramp up under load, and a forward timed on an idle card
    reads up to twice its warm time."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARM_S:
        for fn in fns:
            fn()
        synchronize(device)


def timed_turns(fns, device, warm: bool = True) -> list:
    """The median seconds of each of `fns` over TIMED_RUNS synchronized
    host-clock runs, after warm_up (or, on a card already warm, one call
    each), timed in turns (each round in the reverse order of the last), so
    that all see the same clocks."""
    if warm:
        warm_up(fns, device)
    else:
        for fn in fns:
            fn()
    ts = [[] for _ in fns]
    for r in range(TIMED_RUNS):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            t0 = time.perf_counter()
            fns[i]()
            synchronize(device)
            ts[i].append(time.perf_counter() - t0)
    return [sorted(t)[len(t) // 2] for t in ts]


def device_busy_ms(fn, device, runs: int = 5):
    """The card's busy time per call of fn(): the union of its kernels'
    intervals under torch.profiler over `runs` calls, in ms; None off the
    card. Against the host-clock time it shows how far the host's launches
    hold the card back."""
    if device.type != "cuda":
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        synchronize(device)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy, end = busy + e - s, e
        elif e > end:
            busy, end = busy + e - end, e
    return busy / runs / 1e3


def zero_inputs(cfg, device, batch: int = B):
    """bench_forward_split.py's inputs: zero features, every token present."""
    import torch

    z = lambda *s: torch.zeros(s, device=device)
    N = A + L
    return (z(batch, A, cfg.obs_len - 2, cfg.in_actor),
            torch.ones(batch, A, dtype=torch.bool, device=device),
            z(batch, L, 10, cfg.in_lane), torch.ones(batch, L, dtype=torch.bool, device=device),
            z(batch, N, N, cfg.d_rpe_in), z(batch, 10, cfg.in_lane), z(batch, 20))


def forward_gap(got, want) -> dict:
    """The largest differences of two forwards' (cls_prob, reg, vel)."""
    return {"cls_prob": (got[0] - want[0]).abs().max().item(),
            "positions_m": (got[1][..., :2] - want[1][..., :2]).abs().max().item(),
            "velocity": (got[2] - want[2]).abs().max().item()}


def split(net, inputs, device, kernel: bool = True) -> dict:
    """The times (ms) of the whole forward on the chosen path and on the
    plain core, timed in turns, and of each submodule on the chosen path on
    its own inputs (captured by one forward); the kernels' launches over
    the FusionNet passes that reach them, and the largest gaps between the
    chosen path's outputs and the plain core's."""
    import torch

    from mind_tpu_torch.models import scene_pred
    from mind_tpu_torch.ops import fusion_attention as fa

    path = contextlib.nullcontext if kernel else lambda: plain_core(net)

    def chosen():
        with path():
            return net(*inputs)

    def plain():
        with plain_core(net):
            return net(*inputs)

    calls, passes = {}, []
    counter = net.FusionNet_0.register_forward_pre_hook(
        lambda m, a: passes.append(scene_pred.fused_edge_attention is fa.fused_edge_attention))
    launched_before = launches()
    with torch.no_grad():
        try:
            hooks = [getattr(net, name).register_forward_pre_hook(
                lambda m, a, name=name: calls.setdefault(name, []).append(a))
                for name in SUBMODULES]
            try:
                chosen()
            finally:
                for h in hooks:
                    h.remove()
            t_full, t_plain = timed_turns([chosen, plain], device)
            busy = [device_busy_ms(fn, device) for fn in (chosen, plain)]
            got, want = chosen(), plain()
            with path():
                sub = {name: timed_turns([lambda name=name: [getattr(net, name)(*a)
                                                             for a in calls[name]]], device,
                                         warm=False)[0]
                       for name in SUBMODULES}
            n_launch = launched_since(launched_before)
        finally:
            counter.remove()
    return {"full_fwd_ms": t_full * 1e3, "plain_fwd_ms": t_plain * 1e3,
            "full_fwd_device_busy_ms": busy[0], "plain_fwd_device_busy_ms": busy[1],
            "actor_net_ms": sub["ActorNet_0"] * 1e3, "lane_net_ms": sub["LaneNet_0"] * 1e3,
            "fusion_net_ms": sub["FusionNet_0"] * 1e3, "decoder_ms": sub["SceneDecoder_0"] * 1e3,
            "kernel": kernel, "launches": n_launch, "fusion_passes": sum(passes),
            "kernel_vs_plain": forward_gap(got, want)}


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m mind_tpu_torch.scripts.bench_forward_split",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-kernel", action="store_true", help="the plain fusion core")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--out", default=str(OUT / "forward_split.json"))
    ap.add_argument("--device", help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    import torch

    from mind_tpu_torch.bench import network_flops
    from mind_tpu_torch.common.device import resolve_device
    from mind_tpu_torch.config import NetConfig
    from mind_tpu_torch.models.weights import load_scene_pred
    from mind_tpu_torch.utils import device_specs

    opts = _parse(argv)
    device = resolve_device(opts.device)
    cfg = NetConfig(compute_dtype=opts.compute_dtype)
    net = load_scene_pred(cfg, None, device, seed=0)
    inputs = zero_inputs(cfg, device)
    out = split(net, inputs, device, kernel=not opts.no_kernel)
    flops = network_flops(cfg, inputs)
    mfu = {}
    if device.type == "cuda":
        peak = device_specs.peaks(torch.cuda.get_device_name(device)).bf16_flops
        mfu = {k: flops / (out[f"{k}_fwd_ms"] * 1e-3) / peak for k in ("full", "plain")}
    out.update(plain_flops=flops, mfu_full_path=mfu.get("full"),
               mfu_plain_path=mfu.get("plain"), compute_dtype=opts.compute_dtype, batch=B,
               device=device_name(device))
    print(json.dumps(out, indent=1))
    write_json(opts.out, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
