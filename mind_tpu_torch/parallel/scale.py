"""Scale-out workload (port of mind_tpu/parallel/scale.py): a batch of
randomized contingency trees with full iLQR, the tree axis cut into one
shard per mesh shard.

The solver (planner/ilqr.py) takes a batch axis of trees; each shard is one
batched solve on its device: on a card one compiled program, the whole
solve one CUDA graph with the iterations a WHILE node (parallel/programs.py,
the JAX package's `jax.jit(jax.vmap(solve))`). The shards of a `Mesh` run in
turn in one process, those of a `DistMesh` at the same time, one rank each
(parallel/launch.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from typing import Optional

from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.ops import graph_control
from mind_tpu_torch.ops.potential import CostParams, NodeCostData
from mind_tpu_torch.parallel.mesh import gather_shards, replicate, shard_rollouts
from mind_tpu_torch.parallel.programs import TreeSolveInputs, tree_solve_body
from mind_tpu_torch.planner import programs
from mind_tpu_torch.planner.ilqr import ILQRConfig, TreeTopology, build_topology, ilqr_solve


def _random_tree_parents(rng, n_nodes: int, max_levels: int, max_width: int,
                         branch_p: float = 0.2) -> list[int]:
    """Random branching parent list shaped like AIME cost-tree output: chains
    of cost nodes that fork at contingency branch points (reference
    trajectory_tree.py:36-50 builds such trees from scenario nodes).

    Node i's parent is node i-1 (chain growth) except with probability
    branch_p it forks off any earlier node, subject to the depth and
    per-level width caps of the fixed-shape topology tables. The numpy draws
    are the JAX package's, in the same order."""
    parents = [-1]
    depth = [0]
    width = np.zeros(max_levels, np.int64)
    width[0] = 1
    for i in range(1, n_nodes):
        def has_room(j):
            return depth[j] + 1 < max_levels and width[depth[j] + 1] < max_width
        if rng.random() < branch_p:
            cands = [j for j in range(i) if has_room(j)]
        else:
            cands = [i - 1] if has_room(i - 1) else \
                [j for j in range(i) if has_room(j)]
        if not cands:
            break
        p = int(rng.choice(cands))
        parents.append(p)
        depth.append(depth[p] + 1)
        width[depth[p] + 1] += 1
    return parents


def make_tree_batch(n_trees: int, n_nodes: int, max_nodes: int,
                    max_levels: int, max_width: int, n_exo: int, seed: int = 0,
                    branching: bool = True, device=None):
    """A batch of randomized branching cost trees for scale tests and
    benchmarks: the JAX package's topologies and cost data for the seed, as
    float32 tensors on `device` (the card unless the caller passes the
    CPU). Returns (topo, nodes, params, x0); topo has a leading [n_trees]
    axis when branching, and is one shared chain with branching=False."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    t = lambda x, dtype=None: torch.as_tensor(np.asarray(x, dtype), device=device)
    if branching:
        topos = []
        for _ in range(n_trees):
            n_i = int(rng.integers(max(2, n_nodes // 2), n_nodes + 1))
            parents = _random_tree_parents(rng, n_i, max_levels, max_width)
            topos.append(build_topology(parents, max_nodes, max_levels,
                                        max_width=max_width, as_numpy=True))
        topo = TreeTopology(*(t(np.stack(xs)) for xs in zip(*topos)))
    else:
        topo = build_topology(list(range(-1, n_nodes - 1)), max_nodes, max_levels,
                              max_width=max_width, device=device)

    lane = np.stack([np.linspace(-50, 200, 64), np.zeros(64)], axis=1)
    f32 = np.float32
    params = CostParams(
        field_offset=t([-51.0, -51.0], f32),
        res=t(0.4, f32),
        grid_n=256,
        tgt_seg_start=t(lane[:-1], f32),
        tgt_seg_end=t(lane[1:], f32),
        tgt_seg_mask=t(np.ones(63, bool)),
        w_tgt=t(1.0, f32),
        w_ego=t(1.0, f32),
        w_ego_cov_offset=t(1.0, f32),
        w_exo=t(10.0, f32),
        w_exo_cov_offset=t(2.5, f32),
        w_exo_cost_offset=t(10.0, f32),
        w_des_state=t([0, 0, 0.1, 0, 1.0, 10.0], f32),
        des_state=t([0, 0, 4.0, 0, 0, 0], f32),
        w_state_con=t([0, 0, 50.0, 50.0, 50.0, 500.0], f32),
        state_lb=t([-1e5, -1e5, 0.0, -10.0, -6.0, -0.2], f32),
        state_ub=t([1e5, 1e5, 8.0, 10.0, 4.0, 0.2], f32),
        w_ctrl=t([5.0, 5.0], f32),
    )

    MN = max_nodes
    nodes = NodeCostData(
        prob=t(np.ones((n_trees, MN)), f32),
        ego_mean=t(rng.normal(0, 5, (n_trees, MN, 2)), f32),
        ego_cov=t(np.full((n_trees, MN), 0.5), f32),
        exo_mean=t(rng.normal(10, 10, (n_trees, MN, n_exo, 2)), f32),
        exo_cov=t(np.full((n_trees, MN, n_exo), 0.5), f32),
        exo_mask=t(np.ones((n_trees, MN, n_exo), bool)),
    )
    x0 = t(rng.normal(0, 1, (n_trees, 6)), f32)
    return topo, nodes, params, x0


def parallel_tree_solve(mesh, topo: TreeTopology, nodes: NodeCostData,
                        params: CostParams, x0,
                        ilqr_cfg: ILQRConfig = ILQRConfig(max_iterations=20),
                        graphed: Optional[bool] = None, with_iterations: bool = False):
    """Solve a [n_trees] batch of contingency problems, the trees cut into
    one contiguous shard per mesh shard, each shard one batched solve from
    zero controls on its device. On a `Mesh` the shards run one after
    another and (us [n_trees, MN, 2], J [n_trees]) come back on its first
    device; on a `DistMesh` each rank solves its own shard at the same time
    as the others, and every rank gets the whole (us, J) in tree order on
    its device (parallel/mesh.py::gather_shards). `with_iterations` adds
    the iteration counts [n_trees].

    `topo` may be one TreeTopology shared by all trees, or a batched one
    (leaves with a leading [n_trees] axis, as make_tree_batch gives) with
    every tree's own branching structure.

    `graphed` (None: on a CUDA device; True on the CPU raises) solves each
    shard through its compiled program (`programs.tree_solve_body`, cached
    per solver settings, device and shard shapes: captured at its first
    call, replayed with no host read inside, its inputs copied in and its
    outputs copied out on the device); False runs the solver directly (on
    a card one captured iteration per replay, a host read after each: the
    bit-exact reference)."""
    n = x0.shape[0]
    MN = topo.parent.shape[-1]
    if topo.parent.dim() == 1:
        topo = TreeTopology(*(x[None].expand((n,) + x.shape) for x in topo))
    parts = []
    for (topo_i, nodes_i, x0_i), params_i in zip(shard_rollouts(mesh, (topo, nodes, x0)),
                                                 replicate(mesh, params)):
        if programs.compiled(x0_i.device, graphed):
            inputs = TreeSolveInputs(topo_i, nodes_i, params_i, x0_i)
            # one set per solver configuration and device, as the JAX jit cache
            prog = programs.program_set(f"tree_solve {tuple(ilqr_cfg)!r}", None,
                                        x0_i.device).program(
                "tree_solve", functools.partial(tree_solve_body, cfg=ilqr_cfg), inputs)
            us, J, its = graph_control.clone(prog(None, inputs))
        else:
            us0 = torch.zeros((x0_i.shape[0], MN, 2), dtype=x0_i.dtype, device=x0_i.device)
            _, us, info = ilqr_solve(topo_i, x0_i, us0, nodes_i, params_i, ilqr_cfg)
            J, its = info["J"], info["iterations"]
        parts.append((us, J, its) if with_iterations else (us, J))
    return gather_shards(mesh, parts)
