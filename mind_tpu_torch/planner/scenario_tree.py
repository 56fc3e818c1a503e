"""AIME rounds with host bookkeeping (port of mind_tpu/planner/scenario_tree.py).

`_decode_node` turns the network outputs of B branch nodes into their M
candidate child hists and flags: denormalization to the global frame,
covariance accumulation, probability and target-lane prune, greedy
bearing-topology merge and the branch-time rule (reference
scenario_tree.py:281-412,592-611). The JAX package vmaps it over nodes;
here B is a leading axis.

`ScenarioTreeGenerator` grows a tree with the host keeping the tree
bookkeeping (parent ids, depth, slot allocation) and the device keeping
the trajectories in fixed node slots: each round is one batched scene
preparation, network forward and decode over the B branch slots, then one
host read of the keep / probability / branch-time flags. The round
(`round_body`) and the next round's window gather (`window_body`) are the
JAX package's jitted `_round_fn` and `_window_fn`: on the card they run as
compiled programs (planner/programs.py), eagerly with `graphed=False`.
The device path (aime_device.aime_grow_tree) does the bookkeeping on the
device as well; the two give the same trees.
"""

from __future__ import annotations

import copy
import functools
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from mind_tpu_torch.common.batch_invariant import mv
from mind_tpu_torch.common.geometry import points_polyline_dist
from mind_tpu_torch.common.tree import Node, Tree
from mind_tpu_torch.config import PlannerConfig
from mind_tpu_torch.ops import graph_control
from mind_tpu_torch.parallel.mesh import tree_map
from mind_tpu_torch.planner import programs
from mind_tpu_torch.planner.scene_prep import (OBS_LEN, LaneGraphStatic, SceneInputs,
                                               TargetLaneStatic, per_node, prepare_node_inputs,
                                               rot_of)

SEQ_LEN = 110  # obs 50 + pred 60
PRED_LEN = 60


class NodeSlots(NamedTuple):
    """Fixed-width storage for scenario-tree nodes."""

    pos: torch.Tensor      # [MN, A, 110, 2] global
    ang: torch.Tensor      # [MN, A, 110]
    vel: torch.Tensor      # [MN, A, 110, 2]
    cov: torch.Tensor      # [MN, A, 110] float64
    tgt_pts: torch.Tensor  # [MN, 11, 2]


class RoundOutputs(NamedTuple):
    pos: torch.Tensor      # [B, M, A, 110, 2]
    ang: torch.Tensor      # [B, M, A, 110]
    vel: torch.Tensor      # [B, M, A, 110, 2]
    cov: torch.Tensor      # [B, M, A, 110] float64
    tgt_pts: torch.Tensor  # [B, 11, 2]
    prob: torch.Tensor     # [B, M] float64 joint path probability
    keep: torch.Tensor     # [B, M] bool survived prune+merge
    t_b: torch.Tensor      # [B, M] branch time (== PRED_LEN if none)
    mode_prob: torch.Tensor  # [B, M] raw cls prob (diagnostics)


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def _rotate(v, r):
    """v [..., 2] -> r v, i.e. out_e = sum_d r[e, d] v_d."""
    return mv(r, v)


def _decode_node(cls, reg, vel_pred, inputs: SceneInputs,
                 win_pos, win_ang, win_vel, win_cov,
                 parent_prob, cur_t, actor_mask,
                 tgt_static: TargetLaneStatic, cfg) -> RoundOutputs:
    """Decode B branch nodes' M modes.

    cls [B, M], reg [B, A, M, 60, 5], vel_pred [B, A, M, 60, 2]; windows
    [B, A, 50, ...] in the global frame; parent_prob [B]; cur_t [B];
    actor_mask [A] and the target lane once, or per node with the B axis.
    Bulk arithmetic runs at the window dtype (pipeline dtype);
    probabilities and covariance accumulation always run in float64."""
    dtype = win_pos.dtype
    f64 = torch.float64
    cls64 = cls.to(f64)
    cls = cls.to(dtype)
    cov_p64 = torch.maximum(reg[..., 2], reg[..., 3]).to(f64)   # [B, A, M, 60]
    reg = reg.to(dtype)
    vel_pred = vel_pred.to(dtype)
    B, A, M = reg.shape[:3]
    dev = reg.device
    actor_mask = per_node(actor_mask, 1, B)                       # [B, A]
    orig, rot, theta = inputs.orig, inputs.rot, inputs.theta
    a_ctrs, a_vecs = inputs.actor_ctrs, inputs.actor_vecs
    a_theta = torch.atan2(a_vecs[..., 1], a_vecs[..., 0])        # [B, A]
    a_rot = rot_of(a_theta)[:, :, None, None]                     # [B, A, 1, 1, 2, 2]
    g_rot = rot[:, None, None, None]                              # [B, 1, 1, 1, 2, 2]

    # instance -> scene -> global for all modes at once
    pos_p = _rotate(reg[..., :2], a_rot) + a_ctrs[:, :, None, None]
    pos_g = _rotate(pos_p, g_rot) + orig[:, None, None, None]     # [B, A, M, 60, 2]
    vel_g = _rotate(_rotate(vel_pred, a_rot), g_rot)
    ang_g = (torch.atan2(vel_pred[..., 1], vel_pred[..., 0])
             + a_theta[:, :, None, None] + theta[:, None, None, None])

    # [B, A, M, 60] max sigma, accumulated in f64 onto the last window cov
    cov_g = cov_p64 + win_cov.to(f64)[:, :, None, -1:]

    # new 110-frame hists per mode -> [B, M, A, 110, ...]
    def cat(win, pred):
        win = win[:, None].expand((B, M) + win.shape[1:])
        return torch.cat([win, pred.transpose(1, 2)], dim=3)

    hist_pos = cat(win_pos, pos_g)
    hist_ang = cat(win_ang, ang_g)
    hist_vel = cat(win_vel, vel_g)
    hist_cov = cat(win_cov.to(f64), cov_g)

    prob = cls64 * parent_prob.to(f64)[:, None]                   # [B, M]

    # prune: improbable scenes (scenario_tree.py:369-370)
    keep = prob >= cfg.prune_prob

    # prune: ego diverging from the target lane (scenario_tree.py:373-379)
    ego_mean = hist_pos[:, :, 0, -1]                              # [B, M, 2]
    ego_cov = hist_cov[:, :, 0, -1]                               # [B, M]
    d_tgt = points_polyline_dist(ego_mean, per_node(tgt_static.points, 2, B)[:, None],
                                 per_node(tgt_static.mask, 1, B)[:, None])
    keep &= (d_tgt - ego_cov) <= cfg.tar_dist_thres

    # bearing-topology signature per exo (scenario_tree.py:382-394)
    rel = pos_g - pos_g[:, :1]                                    # [B, A, M, 60, 2]
    rel = rel / (torch.linalg.vector_norm(rel, dim=-1, keepdim=True) + 1e-12)
    bear = torch.atan2(rel[..., 1], rel[..., 0])                  # [B, A, M, 60]
    topo = _wrap(bear[..., 1:] - bear[..., :-1]).sum(-1)          # [B, A, M]
    topo = topo[:, 1:].transpose(1, 2)                            # [B, M, A-1]
    exo_valid = actor_mask[:, None, 1:]                           # [B, 1, A-1]

    # greedy merge in descending-probability order (scenario_tree.py:397-410);
    # the sort is stable, as jnp.argsort is
    order = torch.argsort(-cls, dim=-1, stable=True)              # [B, M]
    keep_sorted = torch.gather(keep, 1, order)
    topo_sorted = torch.gather(topo, 1, order[..., None].expand_as(topo))
    sel = torch.zeros((B, M), dtype=torch.bool, device=dev)
    for i in range(M):
        diff = _wrap(topo_sorted - topo_sorted[:, i:i + 1])       # [B, M, A-1]
        differs = (((diff.abs() - cfg.merge_thres) > 0) & exo_valid).any(-1)
        ok = torch.where(sel, differs, torch.ones_like(differs)).all(-1)
        sel[:, i] = keep_sorted[:, i] & ok
    keep_final = torch.zeros_like(sel).scatter(1, order, sel)

    # branch time (scenario_tree.py:592-611), index arithmetic replicated
    cur_t = cur_t.long()
    compare_t = OBS_LEN + cur_t + (cur_t == 0).long()             # [B]
    # an unused branch slot can carry cur_t = 60; its index is clamped, as
    # a jnp gather clamps it
    compare_t = torch.clamp(compare_t, 0, SEQ_LEN - 1)
    ts = torch.arange(SEQ_LEN, device=dev)
    in_range = (ts[None] >= cur_t[:, None] + 1) & (ts[None] < PRED_LEN) & (ts[None] % 2 == 0)
    idx = torch.clamp(OBS_LEN + ts, 0, SEQ_LEN - 1)
    denom = torch.gather(hist_cov, 3, compare_t[:, None, None, None].expand(B, M, A, 1))
    ratio = hist_cov[..., idx] / denom                            # [B, M, A, 110]
    trig = ((ratio > cfg.cov_change_rate) & actor_mask[:, None, :, None]).any(2)
    trig &= in_range[:, None]
    any_trig = trig.any(-1)
    first_t = torch.argmax(trig.to(torch.uint8), dim=-1)          # first True
    t_b = torch.where(any_trig, first_t, torch.full_like(first_t, PRED_LEN))

    return RoundOutputs(
        pos=hist_pos, ang=hist_ang, vel=hist_vel, cov=hist_cov,
        tgt_pts=inputs.tgt_pts,
        prob=prob, keep=keep_final, t_b=t_b, mode_prob=cls,
    )


class RoundInputs(NamedTuple):
    """What a round reads. The windows are the B branch slots' [B, A, 50,
    ...], or round 0's root window [A, 50, ...], which the body broadcasts
    to the B slots (stride-0 views, as the JAX package's broadcast_to)."""

    win_pos: torch.Tensor
    win_ang: torch.Tensor
    win_vel: torch.Tensor
    win_cov: torch.Tensor
    win_obs: torch.Tensor
    actor_type: torch.Tensor          # [A, 7]
    actor_mask: torch.Tensor          # [A] bool
    probs: torch.Tensor               # [B] float64 parent path probabilities
    cur_ts: torch.Tensor              # [B] long
    lane_static: LaneGraphStatic
    tgt_static: TargetLaneStatic      # n_points a long tensor [] (a capture would bake an int)


class WindowInputs(NamedTuple):
    """What the next round's window gather reads."""

    slots: NodeSlots
    ids: torch.Tensor                 # [B] long slot per branch node
    durations: torch.Tensor           # [B] long


def round_body(net, inp: RoundInputs, *, scen_cfg):
    """One AIME round over the B branch slots (the JAX `_round_fn`): scene
    prep, one network forward and the decode. Returns ((RoundOutputs, the
    flags [B, M, 3] float64: keep, probability, branch time, for the host's
    one read), the round as a long tensor [])."""
    B = inp.probs.shape[0]
    win = inp[:5]
    if inp.win_ang.dim() == 2:   # round 0: the root window
        win = tuple(w[None].expand((B,) + w.shape) for w in win)
    win_pos, win_ang, win_vel, win_cov, win_obs = win
    prep = prepare_node_inputs(win_pos, win_ang, win_vel, win_obs, inp.actor_type,
                               inp.actor_mask, inp.lane_static, inp.tgt_static,
                               scen_cfg.tar_time_ahead)
    f32 = torch.float32
    cls, reg, vel = net(prep.actors.to(f32), prep.actor_mask, prep.lanes.to(f32),
                        prep.lane_mask, prep.rpe.to(f32), prep.tgt_nodes.to(f32),
                        prep.tgt_rpe.to(f32))
    out = _decode_node(cls, reg, vel, prep, win_pos, win_ang, win_vel, win_cov, inp.probs,
                       inp.cur_ts, inp.actor_mask, inp.tgt_static, scen_cfg)
    f64 = torch.float64
    flags = torch.stack([out.keep.to(f64), out.prob, out.t_b.to(f64)], dim=-1)
    return (out, flags), torch.ones((), dtype=torch.long, device=flags.device)


def window_body(net, inp: WindowInputs):
    """Obs windows of the next round's branch nodes (the JAX `_window_fn`):
    window = hist[:, d : d+50] (update_obser semantics); d is clamped so the
    window fits, as a dynamic slice clamps it. Returns ((pos, ang, vel,
    cov), None)."""
    d = torch.clamp(inp.durations, 0, PRED_LEN)
    t_idx = d[:, None, None] + torch.arange(OBS_LEN, device=d.device)   # [B, 1, 50]

    def one(arr):
        w = arr[inp.ids]                                       # [B, A, 110, ...]
        idx = t_idx.expand(w.shape[:2] + (OBS_LEN,))
        if w.dim() == 4:
            idx = idx[..., None].expand(w.shape[:2] + (OBS_LEN, w.shape[-1]))
        return torch.gather(w, 2, idx)

    s = inp.slots
    return (one(s.pos), one(s.ang), one(s.vel), one(s.cov)), None


def node_slots(MN: int, A: int, dtype, device, like: bool = False) -> NodeSlots:
    """A tree's node slots, zero with the covariances at 1e-5; `like`:
    stride-0 views that give only their shapes and dtypes."""
    def full(shape, value, dt):
        if like:
            return torch.full((), value, dtype=dt, device=device).expand(shape)
        return torch.full(shape, value, dtype=dt, device=device)

    return NodeSlots(
        pos=full((MN, A, SEQ_LEN, 2), 0.0, dtype),
        ang=full((MN, A, SEQ_LEN), 0.0, dtype),
        vel=full((MN, A, SEQ_LEN, 2), 0.0, dtype),
        # f64 like the device path: covariance carries decisions
        cov=full((MN, A, SEQ_LEN), 1e-5, torch.float64),
        tgt_pts=full((MN, 11, 2), 0.0, dtype),
    )


class ScenarioTreeGenerator:
    """Host orchestrator around the batched AIME round (reference
    scenario_tree.py:38-108). `net` is the ScenePredNet; the statics live
    on its device.

    `graphed` (None: on a CUDA device) runs the round and the window gather
    through compiled programs of the configuration's program set
    (planner/programs.py, shared with every planner and generator of the
    configuration): each round copies its inputs in, replays the round's
    CUDA graph with no host sync and reads the flags once; round 0, whose
    window is the root's, is a program of its own. The node slots are the
    set's, lent to one tree at a time: the window program reads them where
    they lie. `graphed=False` runs the same bodies eagerly on fresh slots;
    True on the CPU raises."""

    def __init__(self, cfg: PlannerConfig, net, lane_static: LaneGraphStatic,
                 tgt_static: TargetLaneStatic, max_actors: int,
                 graphed: Optional[bool] = None):
        self.cfg = cfg
        self.scen_cfg = cfg.scen_tree
        self.net = net
        self.device = next(net.parameters()).device
        programs.compiled(self.device, graphed)   # raises for True on the CPU
        self.graphed = graphed
        self.lane_static = lane_static
        # the target lane's length as data
        self.tgt_static = tgt_static._replace(
            n_points=torch.as_tensor(tgt_static.n_points, dtype=torch.long, device=self.device))
        self.A = max_actors
        self.B = cfg.scen_tree.max_branch_nodes
        self.MN = cfg.scen_tree.max_tree_nodes
        self.bodies = {   # what a round bakes, kept from later changes of cfg
            "tree_round": functools.partial(round_body,
                                            scen_cfg=copy.deepcopy(cfg.scen_tree)),
            "tree_window": window_body}
        self._signature = programs.config_signature(cfg)
        self.last_rounds = 0   # the rounds the last branch_aime ran

    def program_set(self) -> programs.ProgramSet:
        """The compiled programs of this generator's configuration and
        device, shared with every planner and generator of both."""
        return programs.program_set(self._signature, self.net, self.device)

    def _run(self, kind: str, inputs, compiled: bool, keep=()):
        """The body `kind` on `inputs`: its program (copy in, replay) or
        eagerly (host tensors uploaded first)."""
        if compiled:
            prog = self.program_set().program(kind, self.bodies[kind], inputs, keep)
            return prog(self.net, inputs)
        inputs = tree_map(lambda t: t.to(self.device), inputs)
        return self.bodies[kind](self.net, inputs)[0]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def branch_aime(self, root_window, actor_type, actor_mask) -> List[Tree]:
        """Grow the scenario tree; returns host scenario trees (one per
        surviving root child, probabilities renormalized) whose node data is
        [prob, traj [A,dur,2], cov [A,dur], tgt_pts] like the reference's
        get_scenario_tree export (scenario_tree.py:208-272). root_window is
        (pos, ang, vel, cov, observed) of [A, 50, ...]."""
        A, B, MN = self.A, self.B, self.MN
        dev = self.device
        compiled = programs.compiled(dev, self.graphed)

        # host tree bookkeeping
        tree = Tree()
        tree.add_node(Node(0, None, {"end": False, "terminated": False}))
        node_meta = {0: {"prob": 1.0, "cur_t": 0, "t_b": 0, "duration": 0}}
        next_slot = 1  # slot 0 unused (root has no trajectory)

        dtype = root_window[0].dtype
        if compiled:   # the set's slots, reset in place
            slots = self.program_set().lent(
                "node_slots", node_slots(MN, A, dtype, dev, like=True)).tensors
            for t, fill in zip(slots, (0.0, 0.0, 0.0, 1e-5, 0.0)):
                t.fill_(fill)
        else:
            slots = node_slots(MN, A, dtype, dev)
        win_obs_later = torch.ones((B, A, OBS_LEN), dtype=torch.float32, device=dev)

        # round state: the root window for the branch set
        window, keep_win = tuple(root_window), ()
        branch_keys = [0]
        probs = np.zeros(B, np.float64)
        probs[0] = 1.0
        cur_ts = np.zeros(B, np.int64)

        self.last_rounds = 0
        for _depth in range(self.scen_cfg.max_depth):
            out, flags = self._run("tree_round", RoundInputs(
                *window, actor_type, actor_mask, torch.from_numpy(probs),
                torch.from_numpy(cur_ts), self.lane_static, self.tgt_static), compiled,
                keep=keep_win)
            self.last_rounds += 1
            # the round's one host read
            flags = flags.cpu().numpy()
            keep, prob, t_b = flags[..., 0] > 0.5, flags[..., 1], flags[..., 2].astype(np.int64)

            # assemble children on host; copy their hists into slots
            scatter_src = []  # (b, m) per new node
            scatter_dst = []
            new_branch = []   # (key, cur_t_new, duration)
            for bi, parent_key in enumerate(branch_keys):
                made_child = False
                for m in range(keep.shape[1]):
                    if not keep[bi, m]:
                        continue
                    if next_slot >= MN:
                        break
                    key = next_slot
                    next_slot += 1
                    made_child = True
                    cur_t = int(cur_ts[bi])
                    tb = int(t_b[bi, m])
                    child_depth = tree.get_node(parent_key).depth + 1
                    is_end = tb >= PRED_LEN
                    end_t = PRED_LEN if is_end else tb
                    duration = end_t - cur_t
                    tree.add_node(Node(key, parent_key, {"end": False, "terminated": False}))
                    node_meta[key] = {"prob": float(prob[bi, m]), "cur_t": cur_t, "t_b": tb,
                                      "duration": duration}
                    scatter_src.append((bi, m))
                    scatter_dst.append(key)
                    if is_end:
                        tree.get_node(key).data["end"] = True
                    elif child_depth >= self.scen_cfg.max_depth:
                        tree.get_node(key).data["terminated"] = True
                    else:
                        new_branch.append((key, end_t, duration))
                if not made_child:
                    tree.get_node(parent_key).data["terminated"] = True

            if scatter_dst:
                src = torch.tensor(scatter_src, device=dev)
                src_b, src_m = src[:, 0], src[:, 1]
                dst = torch.tensor(scatter_dst, device=dev)
                slots.pos[dst] = out.pos[src_b, src_m]
                slots.ang[dst] = out.ang[src_b, src_m]
                slots.vel[dst] = out.vel[src_b, src_m]
                slots.cov[dst] = out.cov[src_b, src_m]
                slots.tgt_pts[dst] = out.tgt_pts[src_b].to(dtype)

            if not new_branch:
                break

            # overflow: keep the highest-probability branch nodes
            if len(new_branch) > B:
                new_branch.sort(key=lambda kd: -node_meta[kd[0]]["prob"])
                for key, _, _ in new_branch[B:]:
                    tree.get_node(key).data["end"] = True  # degrade to end node
                new_branch = new_branch[:B]

            ids = np.zeros(B, np.int64)
            durs = np.zeros(B, np.int64)
            probs = np.zeros(B, np.float64)
            cur_ts = np.zeros(B, np.int64)
            branch_keys = []
            for i, (key, end_t, duration) in enumerate(new_branch):
                ids[i] = key
                durs[i] = duration
                probs[i] = node_meta[key]["prob"]
                cur_ts[i] = end_t
                branch_keys.append(key)
            # pad inactive slots with the first entry (masked by probs = 0)
            ids[len(new_branch):] = ids[0]
            durs[len(new_branch):] = durs[0]

            # the next round's windows, which it reads where the gather wrote them
            wins = self._run("tree_window", WindowInputs(
                slots, torch.from_numpy(ids), torch.from_numpy(durs)), compiled,
                keep=graph_control.tensors(slots))
            window = (*wins, win_obs_later)
            keep_win = wins if compiled else ()

        return self._export(tree, node_meta, slots)

    # ------------------------------------------------------------------
    def _export(self, tree: Tree, node_meta, slots: NodeSlots) -> List[Tree]:
        """Mark end paths, renormalize probabilities, split per root child
        (reference get_scenario_tree)."""
        # mark ancestors of end nodes
        for key in list(tree.nodes):
            if tree.get_node(key).data.get("end"):
                k = key
                while k is not None:
                    tree.get_node(k).data["end"] = True
                    k = tree.get_node(k).parent_key

        root = tree.get_root()
        end_children = [k for k in root.children_keys if tree.get_node(k).data.get("end")]
        if not end_children:
            return []

        # pull hists for all end-flagged nodes in one transfer each
        flagged = [k for k in tree.nodes if k != 0 and tree.get_node(k).data.get("end")]
        ids = torch.tensor(flagged, device=slots.pos.device)
        pos_h = slots.pos[ids].cpu().numpy()
        cov_h = slots.cov[ids].cpu().numpy()
        tgt_h = slots.tgt_pts[ids].cpu().numpy()
        hist = {k: i for i, k in enumerate(flagged)}

        # renormalized probability per node (BFS from root)
        norm_prob = {0: 1.0}
        queue = [0]
        while queue:
            k = queue.pop(0)
            kids = [c for c in tree.get_node(k).children_keys if tree.get_node(c).data.get("end")]
            total = sum(node_meta[c]["prob"] for c in kids)
            for c in kids:
                norm_prob[c] = node_meta[c]["prob"] / total * norm_prob[k]
                queue.append(c)

        def node_payload(k):
            i = hist[k]
            d = node_meta[k]["duration"]
            # padded actor axis; pair with the plan's actor_mask
            traj = pos_h[i][:, OBS_LEN:OBS_LEN + d]    # [A, d, 2]
            cov = cov_h[i][:, OBS_LEN:OBS_LEN + d]     # [A, d]
            return [norm_prob[k], traj, cov, tgt_h[i]]

        scen_trees = []
        for rc in end_children:
            st = Tree()
            st.add_node(Node(rc, None, node_payload(rc)))
            queue = [rc]
            while queue:
                k = queue.pop(0)
                for c in tree.get_node(k).children_keys:
                    if not tree.get_node(c).data.get("end"):
                        continue
                    st.add_node(Node(c, k, node_payload(c)))
                    queue.append(c)
            scen_trees.append(st)
        return scen_trees
