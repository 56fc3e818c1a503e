"""AIME scenario-tree growth on the device (port of
mind_tpu/planner/aime_device.py).

Branch-set selection, slot allocation, window slicing, prediction rounds,
prune/merge, branch-time rule, end-flag propagation, probability
renormalization and per-root-child tree ids all run as tensor code with
fixed shapes. The JAX package skips an empty round with lax.cond; here the
round loop reads one flag per round on the host and stops at the first
empty round (later rounds would be no-ops).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.config import PlannerConfig
from mind_tpu_torch.planner.scene_prep import (
    OBS_LEN,
    LaneGraphStatic,
    TargetLaneStatic,
    prepare_node_inputs,
)
from mind_tpu_torch.planner.scenario_tree import PRED_LEN, SEQ_LEN, NodeSlots, _decode_node


class DeviceObsBuffer(NamedTuple):
    """Rolling 10 Hz observation window [A, 50] (float64 by default: the
    observation stream is the root of the decision pipeline)."""

    pos: torch.Tensor       # [A, 50, 2]
    ang: torch.Tensor       # [A, 50]
    vel: torch.Tensor       # [A, 50, 2]
    observed: torch.Tensor  # [A, 50] bool

    @classmethod
    def create(cls, max_actors: int, dtype=torch.float64,
               device=None) -> "DeviceObsBuffer":
        device = resolve_device(device)
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        return cls(pos=z(max_actors, OBS_LEN, 2), ang=z(max_actors, OBS_LEN),
                   vel=z(max_actors, OBS_LEN, 2),
                   observed=torch.zeros((max_actors, OBS_LEN), dtype=torch.bool,
                                        device=device))


def obs_buffer_update(buf: DeviceObsBuffer, states, present) -> DeviceObsBuffer:
    """Shift the window and append one frame. states [A, 4] = [x, y, v, yaw]
    per slot; present [A] marks slots observed this trigger. Absent slots
    repeat their previous frame unobserved (reference planner.py:85-91).
    Returns new tensors; `buf` is not modified."""
    states = states.to(buf.pos.dtype)

    def roll(x):
        return torch.cat([x[:, 1:], x[:, -1:]], dim=1)

    pos, ang, vel, obs = roll(buf.pos), roll(buf.ang), roll(buf.vel), roll(buf.observed)
    x, y, v, yaw = states[:, 0], states[:, 1], states[:, 2], states[:, 3]
    new_pos = torch.stack([x, y], dim=-1)
    new_vel = torch.stack([v * torch.cos(yaw), v * torch.sin(yaw)], dim=-1)
    p = present[:, None]
    pos[:, -1] = torch.where(p, new_pos, pos[:, -1])
    ang[:, -1] = torch.where(present, yaw, ang[:, -1])
    vel[:, -1] = torch.where(p, new_vel, vel[:, -1])
    obs[:, -1] = present
    return DeviceObsBuffer(pos, ang, vel, obs)


def nn_fill_window(buf: DeviceObsBuffer):
    """Masked nearest-neighbor fill of pos/ang (forward, then leading-edge
    backfill) and zeroed velocity at unobserved frames (reference
    utils.py:315-325)."""
    T = buf.pos.shape[1]
    idx = torch.arange(T, device=buf.pos.device)[None, :]
    prev = torch.cummax(torch.where(buf.observed, idx, torch.full_like(idx, -1)), dim=1).values
    first = torch.argmax(buf.observed.to(torch.uint8), dim=1)   # first observed frame
    fill = torch.where(prev >= 0, prev, first[:, None])          # [A, T]
    pos = torch.gather(buf.pos, 1, fill[..., None].expand(-1, -1, 2))
    ang = torch.gather(buf.ang, 1, fill)
    vel = torch.where(buf.observed[..., None], buf.vel, torch.zeros_like(buf.vel))
    return pos, ang, vel, buf.observed.to(torch.float32)


class DeviceTreeState(NamedTuple):
    """Fixed-width scenario tree (slot 0 = root, no trajectory)."""

    slots: NodeSlots
    parent: torch.Tensor       # [MN] long (-1 root)
    depth: torch.Tensor        # [MN] long
    prob: torch.Tensor         # [MN] float64 joint path probability
    start_t: torch.Tensor      # [MN] prediction start (parent's end)
    duration: torch.Tensor     # [MN] covered steps (end_t - start_t)
    end_flag: torch.Tensor     # [MN] bool in the end set
    branch_flag: torch.Tensor  # [MN] bool awaiting expansion
    active: torch.Tensor       # [MN] bool slot in use
    n_nodes: torch.Tensor      # [] long


class AimeMeta(NamedTuple):
    """Per-plan tree summary."""

    parent: torch.Tensor     # [MN]
    duration: torch.Tensor   # [MN]
    end_flag: torch.Tensor   # [MN] bool (after ancestor propagation)
    tree_id: torch.Tensor    # [MN] root-child ancestor slot (-1 if none)
    norm_prob: torch.Tensor  # [MN] float64 renormalized path probability
    n_nodes: torch.Tensor    # []


def _init_tree_state(cfg, max_actors: int, dtype, device) -> DeviceTreeState:
    MN = cfg.scen_tree.max_tree_nodes
    A = max_actors
    kw = dict(device=device)
    slots = NodeSlots(
        pos=torch.zeros((MN, A, SEQ_LEN, 2), dtype=dtype, **kw),
        ang=torch.zeros((MN, A, SEQ_LEN), dtype=dtype, **kw),
        vel=torch.zeros((MN, A, SEQ_LEN, 2), dtype=dtype, **kw),
        # covariance stays f64 whatever the pipeline dtype
        cov=torch.full((MN, A, SEQ_LEN), 1e-5, dtype=torch.float64, **kw),
        tgt_pts=torch.zeros((MN, 11, 2), dtype=dtype, **kw),
    )
    long = dict(dtype=torch.long, **kw)
    prob = torch.zeros((MN,), dtype=torch.float64, **kw)
    prob[0] = 1.0
    flag0 = torch.zeros((MN,), dtype=torch.bool, **kw)
    flag0[0] = True
    return DeviceTreeState(
        slots=slots,
        parent=torch.full((MN,), -1, **long),
        depth=torch.zeros((MN,), **long),
        prob=prob,
        start_t=torch.zeros((MN,), **long),
        duration=torch.zeros((MN,), **long),
        end_flag=torch.zeros((MN,), dtype=torch.bool, **kw),
        branch_flag=flag0,
        active=flag0.clone(),
        n_nodes=torch.ones((), **long),
    )


def _scatter_rows(arr, write, val):
    """arr[write] = val with a dump row at index MN for dropped writes."""
    MN = arr.shape[0]
    a = torch.cat([arr, arr.new_zeros((1,) + arr.shape[1:])], dim=0)
    a[write] = val.to(arr.dtype)
    return a[:MN]


def aime_grow_tree(net, cfg: PlannerConfig, buf: DeviceObsBuffer, actor_type,
                   actor_mask, lane_static: LaneGraphStatic,
                   tgt_static: TargetLaneStatic
                   ) -> Tuple[DeviceTreeState, AimeMeta, int]:
    """Grow the full scenario tree: up to max_depth rounds, each one batched
    network forward over max_branch_nodes nodes. `net` is the batched
    ScenePredNet. Returns (state, meta, number of rounds run)."""
    scen = cfg.scen_tree
    MN = scen.max_tree_nodes
    B = scen.max_branch_nodes
    A = actor_mask.shape[0]
    M = cfg.net.num_modes
    dev = buf.pos.device
    dtype = buf.pos.dtype  # pipeline dtype (see PlannerConfig.pipeline_dtype)
    f32 = torch.float32

    root_pos, root_ang, root_vel, root_obs = nn_fill_window(buf)
    root_cov = torch.full((A, OBS_LEN), 1e-5, dtype=torch.float64, device=dev)
    state = _init_tree_state(cfg, A, dtype, dev)
    ar_MN = torch.arange(MN, device=dev)
    ar_obs = torch.arange(OBS_LEN, device=dev)

    def one_round(state: DeviceTreeState) -> DeviceTreeState:
        # --- branch-set selection (top-B by prob among branch_flag) ---
        key = torch.where(state.branch_flag, 1.0 + state.prob,
                          torch.zeros_like(state.prob))
        order = torch.argsort(-key, stable=True)
        rank = torch.empty_like(order)
        rank[order] = ar_MN
        selected = state.branch_flag & (rank < B)
        overflow = state.branch_flag & ~selected
        nb = selected.sum()
        sel = order[:B]                    # [B] node ids (garbage past nb)
        bmask = torch.arange(B, device=dev) < nb

        # --- windows: 50 frames from the clipped duration d <= PRED_LEN,
        # so the slice always fits the 110 frames ---
        d = torch.clamp(state.duration[sel], 0, PRED_LEN)
        t_idx = d[:, None] + ar_obs                                     # [B, 50]
        is_root = (sel == 0)[:, None, None]

        def window(slot_arr, root):
            w = slot_arr[sel]                                   # [B, A, 110, ...]
            idx = t_idx[:, None, :].expand(B, A, OBS_LEN)
            if w.dim() == 4:
                idx = idx[..., None].expand(B, A, OBS_LEN, w.shape[-1])
            w = torch.gather(w, 2, idx)
            r = is_root if w.dim() == 3 else is_root[..., None]
            return torch.where(r, root[None].to(w.dtype), w)

        win_pos = window(state.slots.pos, root_pos)
        win_ang = window(state.slots.ang, root_ang)
        win_vel = window(state.slots.vel, root_vel)
        win_cov = window(state.slots.cov, root_cov)
        win_obs = torch.where(is_root, root_obs[None], torch.ones_like(root_obs)[None])
        probs_b = state.prob[sel]
        end_t_b = state.start_t[sel] + state.duration[sel]    # node's own cur_t

        # --- prediction + decode ---
        prep = prepare_node_inputs(win_pos, win_ang, win_vel, win_obs, actor_type,
                                   actor_mask, lane_static, tgt_static,
                                   scen.tar_time_ahead)
        # the network consumes float32 casts of the prepared inputs
        with torch.no_grad():
            cls, reg, vel = net(
                prep.actors.to(f32), prep.actor_mask, prep.lanes.to(f32),
                prep.lane_mask, prep.rpe.to(f32), prep.tgt_nodes.to(f32),
                prep.tgt_rpe.to(f32))
        out = _decode_node(cls, reg, vel, prep, win_pos, win_ang, win_vel,
                           win_cov, probs_b, end_t_b, actor_mask, tgt_static, scen)

        # --- slot allocation ---
        valid = out.keep & bmask[:, None]                     # [B, M]
        vflat = valid.reshape(-1)
        dst = state.n_nodes + torch.cumsum(vflat.long(), 0) - 1
        ok = vflat & (dst < MN)
        write = torch.where(ok, dst, torch.full_like(dst, MN))  # MN = dump slot

        b_idx = torch.arange(B, device=dev).repeat_interleave(M)
        parents_f = sel[b_idx]
        start_f = end_t_b[b_idx]
        t_b_f = out.t_b.reshape(-1)
        end_c = t_b_f >= PRED_LEN
        dur_f = torch.where(end_c, torch.full_like(t_b_f, PRED_LEN), t_b_f) - start_f
        depth_f = state.depth[parents_f] + 1
        branch_c = ~end_c & (depth_f < scen.max_depth)

        flat = lambda x: x.reshape((B * M,) + x.shape[2:])
        new_slots = NodeSlots(
            pos=_scatter_rows(state.slots.pos, write, flat(out.pos)),
            ang=_scatter_rows(state.slots.ang, write, flat(out.ang)),
            vel=_scatter_rows(state.slots.vel, write, flat(out.vel)),
            cov=_scatter_rows(state.slots.cov, write, flat(out.cov)),
            tgt_pts=_scatter_rows(state.slots.tgt_pts, write,
                                  out.tgt_pts.repeat_interleave(M, dim=0)),
        )
        return DeviceTreeState(
            slots=new_slots,
            parent=_scatter_rows(state.parent, write, parents_f),
            depth=_scatter_rows(state.depth, write, depth_f),
            prob=_scatter_rows(state.prob, write, out.prob.reshape(-1)),
            start_t=_scatter_rows(state.start_t, write, start_f),
            duration=_scatter_rows(state.duration, write, dur_f),
            # overflowed branch nodes degrade to end nodes; expanded branch
            # flags are consumed, children may set fresh ones
            end_flag=_scatter_rows(state.end_flag | overflow, write, end_c),
            branch_flag=_scatter_rows(torch.zeros_like(state.branch_flag), write,
                                      branch_c),
            active=_scatter_rows(state.active, write, torch.ones_like(ok)),
            n_nodes=torch.clamp(state.n_nodes + ok.sum(), max=MN),
        )

    rounds = 0
    for _ in range(scen.max_depth):
        if not bool(state.branch_flag.any()):   # one host read per round
            break
        state = one_round(state)
        rounds += 1

    # --- end-flag propagation to ancestors ---
    end = state.end_flag
    safe_par = torch.where(state.parent >= 0, state.parent, torch.full_like(state.parent, MN))
    for _ in range(scen.max_depth):
        # integer count of end children (exact in any order), then > 0
        child_end = torch.zeros((MN + 1,), dtype=torch.long, device=dev)
        child_end.index_add_(0, safe_par, (end & state.active).long())
        end = end | (child_end[:MN] > 0)
    end = end & state.active

    # --- renormalized probabilities over end-flagged children, per level ---
    norm = torch.zeros((MN,), dtype=torch.float64, device=dev)
    norm[0] = 1.0
    contrib = torch.where(end, state.prob, torch.zeros_like(state.prob))
    totals = _segment_sum(contrib, safe_par, MN + 1)
    for dd in range(1, scen.max_depth + 1):
        at_d = state.active & end & (state.depth == dd)
        par = torch.where(at_d, state.parent, torch.zeros_like(state.parent))
        t = totals[par]
        n = torch.where(t > 0, state.prob / torch.clamp(t, min=1e-12) * norm[par],
                        torch.zeros_like(t))
        norm = torch.where(at_d, n, norm)

    # --- root-child ancestor (tree id) ---
    anc = torch.arange(MN, device=dev)
    for _ in range(scen.max_depth):
        par = state.parent[anc]
        anc = torch.where((par >= 0) & (state.depth[anc] > 1), par, anc)
    tid = torch.where(end & state.active & (state.depth >= 1), anc, torch.full_like(anc, -1))

    meta = AimeMeta(parent=state.parent, duration=state.duration,
                    end_flag=end, tree_id=tid, norm_prob=norm,
                    n_nodes=state.n_nodes)
    return state._replace(end_flag=end), meta, rounds


def _segment_sum(vals, seg, n_seg: int):
    """out[s] = sum of vals[k] with seg[k] == s, as a one-hot reduction:
    no atomics, so the order of the sum does not change from run to run
    (index_add_ on CUDA would add in a varying order)."""
    onehot = (seg[None, :] == torch.arange(n_seg, device=seg.device)[:, None])
    return (onehot.to(vals.dtype) * vals[None, :]).sum(dim=1)
