"""Scale bench: a batch of random branching contingency trees solved by
the tree iLQR, in trees/s (counterpart of the JAX package's
scripts/bench_scale.py; BASELINE.json's "1024 parallel scenario trees with
full iLQR").

    python -m mind_tpu_torch.scripts.bench_scale [--trees 1024] [--iters 20]
        [--json-out outputs/torch/scale_bench.json] [--device cpu]

parallel/scale.py::parallel_tree_solve of make_tree_batch's trees (24
nodes of 32 slots, 24 levels, width 4, 4 exo agents) on a one-device mesh:
one warm solve (CUDA graph captures), then the mean of 3 synchronized ones.
`devices` is the mesh's size: the driver runs on one card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from mind_tpu_torch.scripts import OUT, device_name, synchronize, write_json

N_REP = 3


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m mind_tpu_torch.scripts.bench_scale",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json-out", default=str(OUT / "scale_bench.json"))
    ap.add_argument("--device", help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    import torch

    from mind_tpu_torch.common.device import resolve_device
    from mind_tpu_torch.parallel.mesh import make_mesh
    from mind_tpu_torch.parallel.scale import make_tree_batch, parallel_tree_solve
    from mind_tpu_torch.planner.ilqr import ILQRConfig

    opts = _parse(argv)
    device = resolve_device(opts.device)
    mesh = make_mesh(1, device=device)
    tree = make_tree_batch(opts.trees, n_nodes=24, max_nodes=32, max_levels=24, max_width=4,
                           n_exo=4, branching=True, device=device)
    cfg = ILQRConfig(max_iterations=opts.iters)
    _, J = parallel_tree_solve(mesh, *tree, ilqr_cfg=cfg)
    if not torch.isfinite(J).all():
        raise RuntimeError("a tree's cost is not finite")
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(N_REP):
        parallel_tree_solve(mesh, *tree, ilqr_cfg=cfg)
        synchronize(device)
    wall = (time.perf_counter() - t0) / N_REP
    row = {
        "metric": f"{opts.trees} branching contingency-tree iLQR solves "
                  f"({opts.iters} iters, 1x {device_name(device)})",
        "value": opts.trees / wall,
        "unit": "trees/s",
        "detail": {"wall_s_per_batch": wall, "n_trees": opts.trees, "max_nodes": 32,
                   "ilqr_iters": opts.iters, "devices": 1, "device": device_name(device)},
    }
    print(json.dumps(row))
    write_json(opts.json_out, row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
