"""Cost-tree topology construction on the device (port of
mind_tpu/planner/cost_topology.py).

Turns AIME tree metadata into the padded TreeTopology + (slot, step) index
arrays the batched iLQR consumes: one cost node per even prediction step of
every end-flagged scenario node; a node's first cost node hangs off its
parent scenario node's last cost node; levels are global prediction
half-steps, so sorting candidates by (level, slot) yields a topological
order with contiguous levels. The JAX package vmaps over trees; here the
tree axis T is written out.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mind_tpu_torch.planner.ilqr import TreeTopology

S_MAX = 30  # max cost nodes per scenario node (60 pred steps / 2)


class DeviceCostTrees(NamedTuple):
    topo: TreeTopology          # leaves stacked [T, ...]
    cost_slot: torch.Tensor     # [T, MNC] scenario slot per cost node
    cost_step: torch.Tensor     # [T, MNC] even step within the slot's slice
    tree_mask: torch.Tensor     # [T] real trees
    n_trees: torch.Tensor       # []


def device_cost_topology(parent, depth, duration, start_t, end_flag, tree_id,
                         max_trees: int, max_cost_nodes: int,
                         max_levels: int, max_width: int) -> DeviceCostTrees:
    MN = parent.shape[0]
    MNC = max_cost_nodes
    T = max_trees
    dev = parent.device
    parent, depth, duration, start_t, tree_id = (
        x.long() for x in (parent, depth, duration, start_t, tree_id))
    big = MN * S_MAX + 7
    ar_mn = torch.arange(MN, device=dev)

    # roots = depth-1 end nodes, in slot order
    is_root = end_flag & (depth == 1)
    root_order = torch.argsort(torch.where(is_root, ar_mn, torch.full_like(ar_mn, big)),
                               stable=True)
    n_trees = is_root.sum()
    roots = root_order[:T]                                   # [T]
    tree_mask = torch.arange(T, device=dev) < n_trees

    half_dur = duration // 2

    member = end_flag[None] & (tree_id[None] == roots[:, None])   # [T, MN]
    steps = torch.arange(S_MAX, device=dev)
    valid = member[:, :, None] & (steps[None, None] < half_dur[None, :, None])  # [T, MN, S]
    level = (start_t // 2)[:, None] + steps[None, :]                        # [MN, S]

    key = torch.where(valid, (level * MN + ar_mn[:, None])[None], torch.full_like(valid, big,
                                                                                dtype=torch.long))
    flat_key = key.reshape(T, -1)
    order = torch.argsort(flat_key, dim=-1, stable=True)      # [T, MN*S]
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(MN * S_MAX, device=dev).expand(T, -1))

    n_c = valid.reshape(T, -1).sum(-1)                        # [T]
    sel = order[:, :MNC]
    c_slot = sel // S_MAX
    c_s = sel % S_MAX
    c_valid = torch.arange(MNC, device=dev)[None] < torch.clamp(n_c, max=MNC)[:, None]

    # parent cost node: previous step of the same slot, or the parent
    # scenario node's last cost node; the root child's first node hangs
    # off x0 (scenario parent is the AIME root, slot 0)
    p_slot = parent[c_slot]
    # a -1 parent indexes the last slot, as a negative jnp index does; those
    # nodes attach to x0 below, so the value is unused
    par_flat = torch.where(
        c_s > 0,
        c_slot * S_MAX + (c_s - 1),
        p_slot * S_MAX + torch.clamp(half_dur[torch.where(p_slot >= 0, p_slot, MN - 1)] - 1,
                                     min=0),
    )
    root_attach = (c_s == 0) & (p_slot <= 0)
    par_rank = torch.gather(rank, 1, torch.clamp(par_flat, 0, MN * S_MAX - 1))
    c_parent = torch.where(root_attach | ~c_valid, torch.full_like(par_rank, -1), par_rank)
    c_parent = torch.where(c_parent >= MNC, torch.full_like(c_parent, -1), c_parent)

    # level table: candidates are already sorted by level, so the in-level
    # position is rank minus the level's start offset
    c_level = level.reshape(-1)[sel]                          # [T, MNC]
    lv = torch.clamp(c_level, 0, max_levels - 1)
    level_counts = torch.zeros((T, max_levels), dtype=torch.long, device=dev)
    level_counts.scatter_add_(1, lv, c_valid.long())
    level_start = torch.cat([torch.zeros((T, 1), dtype=torch.long, device=dev),
                             torch.cumsum(level_counts, dim=1)[:, :-1]], dim=1)
    w = torch.arange(MNC, device=dev)[None] - torch.gather(level_start, 1, lv)
    ok = c_valid & (w >= 0) & (w < max_width)
    lvl_idx = torch.where(ok, lv, torch.full_like(lv, max_levels))
    w_idx = torch.where(ok, w, torch.zeros_like(w))
    table = torch.full((T, max_levels + 1, max_width), -1, dtype=torch.long, device=dev)
    t_idx = torch.arange(T, device=dev)[:, None].expand(T, MNC)
    ids = torch.arange(MNC, device=dev)[None].expand(T, MNC)
    # (level, width) cells of ok entries are distinct; the rest land in the
    # dump row max_levels, where write order does not matter
    table[t_idx, lvl_idx, w_idx] = ids
    table = table[:, :max_levels]

    topo = TreeTopology(parent=c_parent, node_mask=c_valid, level_table=table)
    return DeviceCostTrees(topo=topo, cost_slot=c_slot, cost_step=2 * c_s,
                           tree_mask=tree_mask, n_trees=n_trees)
