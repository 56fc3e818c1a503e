"""Dry run of the distributed mesh (the counterpart of the JAX package's
`__graft_entry__.py::dryrun_multichip`), and the rank workloads it runs.

    python -m mind_tpu_torch.parallel.dryrun --nproc N [--device cpu|cuda] [--ranks-per-card R]

starts N ranks (parallel/launch.py; without --device, on the cards) and runs
dryrun_multichip's three workloads on that world:

1. a data-parallel training step (models/train.py::make_train_step on the
   rank's `DistMesh`) on make_dummy_batch, 2 scenes per rank: the loss
   finite and the parameters equal on every rank, to the bit. The network
   is dryrun_multichip's (DRYRUN_NET: 2 fusion layers, 32 wide, 4 heads,
   12 predicted frames), float32; on the card its layer cores run kernel A
   at 32 / 32 / 4;
2. a sharded tree solve (parallel/scale.py::parallel_tree_solve), 4
   branching trees per rank, 5 iterations: every cost finite, every rank
   holding the same whole result;
3. a sharded Monte-Carlo episode (sim/episode.py::run_episode_monte_carlo),
   one perturbed copy per rank over 10 ticks (2 planning cycles from tick
   0), against the same copies in one process on rank 0: the same failing
   cycle, the ego within 1e-3 m. dryrun_multichip's settings: demo_1's
   planner configuration with the trained weights, a float32 network and a
   float64 solve; synthetic.py::synthetic_av2(0) stands in for demo_1's log.

It prints one line per workload and exits non-zero if any check fails.

The rank workloads (`train`, `train_on_nccl`, `tree_solve`, `monte_carlo`)
take the rank's `DistMesh` first and return host objects; `workloads` runs
several on one world. `chip_smoke.py` and `tests/test_torch_dist.py` launch them too.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# the JAX dry run's Monte-Carlo tolerance: sharded against one program, metres
TOL_MC_EGO = 1e-3
# the JAX dry run's training network (__graft_entry__.py::dryrun_multichip)
DRYRUN_NET = dict(n_scene_layer=2, n_fpn_scale=2, d_actor=32, d_lane=32, d_embed=32, d_rpe=32,
                  n_scene_head=4, pred_len=12)


def _launches():
    from mind_tpu_torch.ops import fusion_attention as fa

    return dict(fa.fused_edge_attention.launches_by_variant)


def _sync(mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def train(mesh, net_cfg, batch, steps: int, lr: float = 1e-4, optimizer: str = "adamw",
          seed: int = 0, net_state: Optional[dict] = None,
          deterministic_cudnn: bool = False) -> dict:
    """`steps` data-parallel steps of init_scene_pred(net_cfg, seed) (or
    `net_state` loaded over it) on the whole `batch` (CPU tensors; the rank
    trains on its shard), through make_train_step: on the card the
    compiled step's two programs around the all-reduce.
    Returns the global losses, the parameters after the last step (CPU),
    the seconds before the first step and of the first step, the step's
    seconds summed over the steps
    after the first (`timed_steps` of them; a compiled step's under "step",
    an eager one's by phase), this
    rank's kernel launches by variant over all the steps, and, compiled,
    the programs' captures and the steps they replayed (counted on the
    device; 0 and 0 eagerly)."""
    t = time.perf_counter()
    from mind_tpu_torch.models import train as tr
    from mind_tpu_torch.ops import fusion_attention as fa

    torch.backends.cudnn.deterministic = deterministic_cudnn
    net = tr.init_scene_pred(net_cfg, seed, device=mesh.device)
    if net_state is not None:
        net.load_state_dict(net_state)
    opt = {"adam": tr.adam, "adamw": tr.adamw}[optimizer](net.parameters(), lr)
    step = tr.make_train_step(net, opt, mesh=mesh)
    batch = batch.to(mesh.device)
    times = {}
    fa.reset_launch_counts()
    setup_s = time.perf_counter() - t   # the network, optimizer and step made
    t = time.perf_counter()
    losses = [step(batch).item()]
    first_step_s = time.perf_counter() - t   # on the card: its warm-up step and capture
    losses += [step(batch, times=times).item() for _ in range(steps - 1)]
    prog = step.program if mesh.device.type == "cuda" else None
    return {"losses": losses, "times": times, "timed_steps": steps - 1, "launches": _launches(),
            "setup_s": setup_s, "first_step_s": first_step_s,
            "captures": len(prog.capture_s()) if prog else 0,
            "replays": prog.replays() if prog else 0,
            "params": {k: p.detach().cpu() for k, p in net.named_parameters()}}


def train_on_nccl(mesh, **kwargs) -> Optional[dict]:
    """`train` (its keyword arguments) on rank 0 alone, as the one rank of
    an nccl group made beside the world's own: the whole batch, the
    all-reduce on the card. A world of ranks that share a card runs on
    gloo, whose ranks cannot all join one nccl group (nccl takes one rank a
    card), but one rank can: this runs the nccl path without a launch of
    its own. Every rank takes part in making the group; the others return
    None."""
    import torch.distributed as dist

    from mind_tpu_torch.parallel.mesh import DistMesh

    if mesh.device.type != "cuda":
        raise ValueError(f"nccl runs on CUDA cards; the rank is on {mesh.device}")
    group = dist.new_group([0], backend="nccl")
    if mesh.rank != 0:
        return None
    return train(DistMesh(0, 1, mesh.device, group, "nccl"), **kwargs)


def tree_solve(mesh, n_trees: int, n_nodes: int, max_nodes: int, max_levels: int,
               max_width: int, n_exo: int, seed: int = 0, max_iterations: int = 20,
               dtype: Optional[torch.dtype] = None, timed: bool = False) -> dict:
    """parallel_tree_solve of make_tree_batch(...) on the rank's device
    (the float leaves cast to `dtype` where given); with `timed`, a first
    call that captures and a second one timed between barriers. Returns
    the whole (us, J) on the CPU and the timed call's ms."""
    import torch.distributed as dist

    from mind_tpu_torch.parallel.scale import make_tree_batch, parallel_tree_solve
    from mind_tpu_torch.planner.ilqr import ILQRConfig

    topo, nodes, params, x0 = make_tree_batch(n_trees, n_nodes, max_nodes, max_levels,
                                              max_width, n_exo, seed, device=mesh.device)
    if dtype is not None:
        cast = lambda tree: type(tree)(*(t.to(dtype) if isinstance(t, torch.Tensor)
                                         and t.is_floating_point() else t for t in tree))
        nodes, params, x0 = cast(nodes), cast(params), x0.to(dtype)
    cfg = ILQRConfig(max_iterations=max_iterations)
    solve = lambda: parallel_tree_solve(mesh, topo, nodes, params, x0, cfg)
    ms = None
    if timed:
        solve()
        _sync(mesh)
        dist.barrier(group=mesh.group)
        t = time.perf_counter()
    us, J = solve()
    if timed:
        _sync(mesh)
        ms = (time.perf_counter() - t) * 1e3
    return {"us": us.cpu(), "J": J.cpu(), "ms": ms}


def monte_carlo(mesh, spec, k: int, chunk: int = 1, seg_cycles: int = 10,
                horizon: Optional[int] = None, seed: int = 0,
                deadline: Optional[float] = None, single: bool = False) -> dict:
    """run_episode_monte_carlo(mesh=<this rank>) on `spec`
    (sim/simulator.py::SimSpec) built on the rank's device: every copy's
    EpisodeResult, this rank's chunk walls, the sweep's wall seconds (the
    ranks start it together, after a barrier), the build seconds, this
    rank's kernel launches by variant over the sweep and the AIME rounds
    its compiled episode programs ran (kernel B runs a layer's worth each;
    none off the card). With `single`, rank 0 then runs the same k copies
    as one chunk in this one process (`single_results`)."""
    import torch.distributed as dist

    from mind_tpu_torch.ops import fusion_attention as fa
    from mind_tpu_torch.sim.episode import program_rounds, run_episode_monte_carlo

    t = time.perf_counter()
    sim = spec.build(mesh.device)
    build_s = time.perf_counter() - t
    kw = dict(k=k, seed=seed, horizon=horizon, seg_cycles=seg_cycles)
    walls = []
    dist.barrier(group=mesh.group)
    fa.reset_launch_counts()
    rounds = program_rounds()
    t = time.perf_counter()
    res = run_episode_monte_carlo(sim, chunk=chunk, deadline=deadline, mesh=mesh,
                                  chunk_walls=walls, **kw)
    _sync(mesh)
    out = {"results": res, "chunk_walls": walls, "wall_s": time.perf_counter() - t,
           "build_s": build_s, "launches": _launches(), "aime_rounds": program_rounds() - rounds}
    if single and mesh.rank == 0:
        out["single_results"] = run_episode_monte_carlo(sim, chunk=k, **kw)
    return out


def collectives_on_device(mesh) -> dict:
    """Which collectives the world's backend takes on tensors of the rank's
    device: {name: "ok", or the error it raised}. parallel/mesh.py moves
    gloo's tensors through the host whatever this finds."""
    import torch.distributed as dist

    out = {}
    x = torch.full((4,), float(mesh.rank + 1), device=mesh.device)
    calls = {"all_reduce": lambda: dist.all_reduce(x.clone(), group=mesh.group),
             "broadcast": lambda: dist.broadcast(x.clone(), src=0, group=mesh.group),
             "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in
                                                    range(mesh.world_size)], x, group=mesh.group)}
    for name, call in calls.items():
        try:
            call()
            out[name] = "ok"
        except Exception as e:   # noqa: BLE001 - the finding is the error itself
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
        _sync(mesh)
        dist.barrier(group=mesh.group)
    return out


WORKLOADS = {"train": train, "train_on_nccl": train_on_nccl, "tree_solve": tree_solve,
             "monte_carlo": monte_carlo, "collectives_on_device": collectives_on_device}


def workloads(mesh, jobs: Sequence[Tuple[str, dict]]) -> dict:
    """Each (workload name, keyword arguments) of `jobs` in turn on this
    rank: {name: result}, and under "seconds" the epoch time the jobs
    started at ("start") and each job's seconds."""
    out, seconds = {}, {"start": time.time()}
    for name, kw in jobs:
        t = time.perf_counter()
        out[name] = WORKLOADS[name](mesh, **kw)
        seconds[name] = time.perf_counter() - t
    out["seconds"] = seconds
    return out


def _params_equal(ranks) -> bool:
    first = ranks[0]["params"]
    return all(torch.equal(r["params"][k], v) for r in ranks[1:] for k, v in first.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where the ranks run (default: the CUDA cards)")
    ap.add_argument("--ranks-per-card", type=int, default=1)
    args = ap.parse_args(argv)

    from mind_tpu_torch.config import NetConfig, planner_config_for_demo
    from mind_tpu_torch.models.train import make_dummy_batch
    from mind_tpu_torch.parallel.launch import launch
    from mind_tpu_torch.synthetic import demo_spec

    n = args.nproc
    tag = f"dryrun({n})"
    net_cfg = NetConfig(**DRYRUN_NET)
    batch = make_dummy_batch(net_cfg, batch_size=2 * n, n_actors=4, n_lanes=8, device="cpu")
    pc = planner_config_for_demo("demo_1")
    if not pc.ckpt_path:
        raise RuntimeError("demo_1's planner configuration names no trained weights")
    pc.net.compute_dtype = "float32"
    pc.traj_tree.solve_dtype = "float64"
    steps = 10   # 2 planning cycles
    failed = []
    with tempfile.TemporaryDirectory() as data_root:
        spec = demo_spec("demo_1", 0, data_root, ticks=steps, planner_cfg=pc,
                         enable_timestep=0.0)
        jobs = [("train", dict(net_cfg=net_cfg, batch=batch, steps=1)),
                ("tree_solve", dict(n_trees=4 * n, n_nodes=12, max_nodes=16, max_levels=16,
                                    max_width=4, n_exo=4, max_iterations=5)),
                ("monte_carlo", dict(spec=spec, k=n, chunk=1, seg_cycles=2, horizon=steps,
                                     single=True))]
        t = time.perf_counter()
        ranks = launch("mind_tpu_torch.parallel.dryrun:workloads", n, args=(jobs,),
                       device=args.device, ranks_per_card=args.ranks_per_card, timeout=1800)
        wall = time.perf_counter() - t

    tr = [r["train"] for r in ranks]
    loss = tr[0]["losses"][0]
    ok = np.isfinite(loss) and _params_equal(tr) and len({r["losses"][0] for r in tr}) == 1
    print(f"{tag}: train loss={loss:.4f}, parameters equal on all {n} ranks "
          f"{'OK' if ok else 'FAILED'}")
    failed += [] if ok else ["train"]

    ts = [r["tree_solve"] for r in ranks]
    us, J = ts[0]["us"], ts[0]["J"]
    ok = (tuple(us.shape) == (4 * n, 16, 2) and bool(torch.isfinite(J).all())
          and all(torch.equal(r["us"], us) and torch.equal(r["J"], J) for r in ts))
    print(f"{tag}: sharded tree solve J_mean={float(J.mean()):.2f} over {n} ranks "
          f"{'OK' if ok else 'FAILED'}")
    failed += [] if ok else ["tree_solve"]

    mc = [r["monte_carlo"] for r in ranks]
    got, want = mc[0]["results"], mc[0]["single_results"]
    dev = max((float(np.abs(a.ego_states - b.ego_states).max()) for a, b in zip(got, want)),
              default=float("inf"))
    ok = (len(got) == len(want) == n and all(a.fail_cycle == b.fail_cycle
                                             for a, b in zip(got, want))
          and dev < TOL_MC_EGO
          and all(len(r["results"]) == n and all(np.array_equal(a.ego_states, b.ego_states)
                                                 for a, b in zip(r["results"], got))
                  for r in mc))
    print(f"{tag}: sharded Monte-Carlo episode ({n} perturbed closed-loop lanes, 1/rank, "
          f"{steps} ticks, trained weights) against the single-process run, max dev "
          f"{dev:.3e} m {'OK' if ok else 'FAILED'}")
    failed += [] if ok else ["monte_carlo"]
    where = "the CPU" if args.device == "cpu" else f"the cards, {args.ranks_per_card} per card"
    print(f"{tag}: {wall:.1f} s, {n} ranks on {where}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
