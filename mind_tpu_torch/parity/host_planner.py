"""HostRefPlanner: the full MIND plan cycle in host numpy (float64) with
reference control flow, for end-to-end parity certification (port of
mind_tpu/parity/host_planner.py).

Mirrors the reference MINDPlanner.plan (reference planners/mind/
planner.py:104-145): process_data -> branch_aime (Python while-loop over
variable branch sets, reference scenario_tree.py:38-108) -> per scenario
tree warm-start + full tree-iLQR (planner.py:174-178) -> min-cost selection
(planner.py:180-198) -> first child's [accel, steer] as the control
(planner.py:141-145).

Only the prediction network forward is shared with the device path (the
same ScenePredNet, same weights, on its device); every other stage —
observation windows, scene normalization, RPE, high-level command, mode
decode, prune/merge/branch-time, probability renormalization, cost trees,
the tree-iLQR solve and trajectory selection — is an independent numpy
implementation (host_scene.py, host_ilqr.py). The mirror plans in the
global frame, in float64; the device planner plans in a local frame offset
by MINDPlanner.origin.

Public surface matches MINDPlanner so a MINDAgent can bind either:
update_observation / update_state_ctrl / update_target_lane / plan.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.common.geometry import resample_polyline
from mind_tpu_torch.config import OptPhaseConfig, PlannerConfig
from mind_tpu_torch.data.semantic_map import (
    LocalSemanticMap,
    SemanticMap,
    build_lane_graph,
    lane_graph_features,
)
from mind_tpu_torch.models.train import init_scene_pred
from mind_tpu_torch.parity.host_ilqr import HostCostNode, HostCostParams, host_ilqr_solve
from mind_tpu_torch.parity.host_scene import (
    OBS_LEN,
    PRED_LEN,
    HostObsBuffer,
    decode_node_np,
    prepare_node_inputs_np,
)
from mind_tpu_torch.parallel.mesh import tree_map
from mind_tpu_torch.planner import programs
from mind_tpu_torch.planner.planner import MAX_TGT_PTS, type_onehot


class ForwardInputs(NamedTuple):
    """The padded branch batch of one network forward, float32 but the
    masks."""

    actors: torch.Tensor       # [Bpad, A, ...]
    actor_mask: torch.Tensor   # [Bpad, A] bool
    lanes: torch.Tensor        # [Bpad, L, 10, 16]
    lane_mask: torch.Tensor    # [Bpad, L] bool
    rpe: torch.Tensor
    tgt_nodes: torch.Tensor
    tgt_rpe: torch.Tensor


def forward_body(net, inp: ForwardInputs):
    """One network forward over the branch batch (the JAX mirror's jitted
    `batched_apply`): cls [Bpad, M], reg [Bpad, A, M, 60, 5] and vel [Bpad,
    A, M, 60, 2] flattened per node into one float64 [Bpad, ...] for the
    host's one read, and the forward as a long tensor []."""
    cls, reg, vel = net(*inp)
    B = cls.shape[0]
    packed = torch.cat([x.reshape(B, -1) for x in (cls, reg, vel)], dim=1).to(torch.float64)
    return packed, torch.ones((), dtype=torch.long, device=packed.device)


@dataclass
class HostScenNode:
    key: int
    parent: Optional[int]
    prob: float          # joint path probability (pre-renormalization)
    cur_t: int           # prediction step where this node's segment starts
    t_b: int
    duration: int
    hist_pos: np.ndarray  # [A, 110, 2]
    hist_ang: np.ndarray
    hist_vel: np.ndarray
    hist_cov: np.ndarray  # [A, 110]
    tgt_pts: np.ndarray
    end: bool = False
    terminated: bool = False
    children: List[int] = field(default_factory=list)
    norm_prob: float = 0.0


class HostRefPlanner:
    """Drop-in (slow, float64) reference-semantics planner. `graphed` (None:
    on a CUDA device) runs each round's network forward as a compiled
    program of the mirror's own program set of the configuration
    (planner/programs.py), one replay and one read a round; False runs the
    same body eagerly; True on the CPU raises. The set is the mirror's even
    where the network is shared: its ProgramNet loads the live network, so
    a stale weight copy in the device planner's programs still shows as a
    deviation."""

    def __init__(self, cfg: PlannerConfig, smp: SemanticMap,
                 lcl_smp: LocalSemanticMap, shared_net=None,
                 record_debug: bool = False, device=None,
                 graphed: Optional[bool] = None):
        self.cfg = cfg
        self.smp = smp
        self.lcl_smp = lcl_smp
        self.state: Optional[np.ndarray] = None
        self.ctrl: Optional[np.ndarray] = None
        self.gt_tgt_lane: Optional[np.ndarray] = None
        self.obs_buffer = HostObsBuffer(cfg.max_actors)
        self.diagnostics: Dict[str, int] = {
            "plans": 0, "plan_failures": 0, "branch_overflows": 0}
        # record_debug: keep per-plan decision internals (mode probs,
        # prune/merge/branch margins per expansion, per-tree selection
        # costs) in self.debug — the stage-by-stage divergence dump the
        # playback diagnostic compares against the device planner
        self.record_debug = record_debug
        self.debug: Optional[dict] = None

        # the network: the device planner's ScenePredNet (MINDPlanner.net),
        # or one seeded from cfg.seed in eval mode on `device` (the card
        # unless the caller names the CPU)
        if shared_net is not None:
            self.net = shared_net
        else:
            self.net = init_scene_pred(cfg.net, seed=cfg.seed,
                                       device=resolve_device(device))
            self.net.apply_compute_dtype().eval()
        self.device = next(self.net.parameters()).device
        programs.compiled(self.device, graphed)   # raises for True on the CPU
        self.graphed = graphed
        self._signature = programs.config_signature(cfg, mirror=True)

        self._init_statics()

    # ------------------------------------------------------------------
    def _init_statics(self):
        """Static per-scenario tensors, same construction as
        MINDPlanner._init_statics (lane graph + ~1 m resampled target lane,
        reference planner.py:147-171 / utils.py:345-483)."""
        cfg = self.cfg
        graph = build_lane_graph(self.smp.map_data, np.zeros(2), np.eye(2),
                                 cfg.scen_tree.seg_length,
                                 cfg.scen_tree.seg_n_node)
        feats = lane_graph_features(graph)
        L = cfg.max_lanes
        n = feats.shape[0]
        self.lane_feats = np.zeros((L, 10, 16))
        self.lane_feats[:n] = feats
        self.lane_anchors = np.zeros((L, 2))
        self.lane_anchors[:n] = graph["lane_ctrs"]
        self.lane_vecs = np.tile(np.array([1.0, 0.0]), (L, 1))
        self.lane_vecs[:n] = graph["lane_vecs"]
        self.lane_mask = np.zeros(L, bool)
        self.lane_mask[:n] = True

        lane = self.lcl_smp.target_lane
        info = self.lcl_smp.target_lane_info
        pts, src = resample_polyline(lane, 1.0)
        info_rows = np.concatenate([
            info[0][:, None], info[1], info[2], info[3],
            info[4][:, None], info[5][:, None],
        ], axis=-1).astype(float)[src]
        P = MAX_TGT_PTS
        self.tgt_points = np.full((P, 2), 1e6)
        self.tgt_points[:len(pts)] = pts
        self.tgt_info = np.zeros((P, 12))
        self.tgt_info[:len(pts)] = info_rows
        self.tgt_n = len(pts)
        self.eval_lane = np.asarray(lane, float)

    # ------------------------------------------------------------------
    # public surface (mirrors MINDPlanner)
    # ------------------------------------------------------------------
    def update_observation(self, observations):
        self.obs_buffer.update(observations, type_onehot)

    def update_state_ctrl(self, state, ctrl):
        self.state = np.asarray(state, float)
        self.ctrl = np.asarray(ctrl, float)

    def update_target_lane(self, gt_tgt_lane):
        self.gt_tgt_lane = np.asarray(gt_tgt_lane, float)

    def plan(self) -> Tuple[bool, Optional[np.ndarray], Optional[list]]:
        actor_mask = self.obs_buffer.actor_mask()
        if not actor_mask[0]:
            return False, None, None
        if self.record_debug:
            self.debug = {"rounds": []}

        nodes = self._branch_aime(actor_mask)
        trees = self._export_trees(nodes)
        self.last_n_trees = len(trees)
        self.last_n_nodes = len(nodes)
        if not trees:
            self.diagnostics["plan_failures"] += 1
            return False, None, None

        exo_valid = actor_mask[1:]
        x0 = np.concatenate([self.state, self.ctrl])
        tv = float(self.lcl_smp.target_velocity)
        warm_p = self._cost_params(self.cfg.traj_tree.warm, x0, tv, warm=True)
        full_p = self._cost_params(self.cfg.traj_tree.full, x0, tv, warm=False)

        best_cost, best_xs, best_us = np.inf, None, None
        tree_costs = []
        tt = self.cfg.traj_tree
        for root_key in trees:
            cost_nodes = self._cost_tree(nodes, root_key, exo_valid)
            us0 = np.zeros((len(cost_nodes), 2))
            warm = host_ilqr_solve(
                cost_nodes, x0, us0, warm_p, dt=tt.dt, wb=tt.wheelbase,
                max_iterations=tt.warm_max_iterations, rel_tol=tt.rel_tol,
                n_line_search=tt.n_line_search, mu_max=tt.max_reg)
            full = host_ilqr_solve(
                cost_nodes, x0, warm.us, full_p, dt=tt.dt, wb=tt.wheelbase,
                max_iterations=tt.max_iterations, rel_tol=tt.rel_tol,
                n_line_search=tt.n_line_search, mu_max=tt.max_reg)
            cost = self._evaluate(full.xs, full.us, x0, tv)
            tree_costs.append(float(cost))
            if cost < best_cost:
                best_cost, best_xs, best_us = cost, full.xs, full.us

        if self.record_debug:
            order = np.sort(tree_costs)
            self.debug.update({
                "n_nodes": len(nodes),
                "scen_nodes": [
                    {"key": k, "parent": nd.parent, "cur_t": nd.cur_t,
                     "t_b": nd.t_b, "duration": nd.duration,
                     "prob": float(nd.prob),
                     "norm_prob": float(nd.norm_prob),
                     "end": bool(nd.end)}
                    for k, nd in nodes.items() if k != 0],
                "tree_roots": list(trees),
                "tree_costs": tree_costs,
                "best_root": int(trees[int(np.argmin(tree_costs))]),
                "selection_margin": (float(order[1] - order[0])
                                     if len(order) > 1 else float("inf")),
            })

        ctrl = best_xs[0, 4:6].copy()   # first cost node's [a, steer]
        if not np.isfinite(ctrl).all():
            self.diagnostics["plan_failures"] += 1
            return False, None, None
        self.diagnostics["plans"] += 1
        return True, ctrl, None

    # ------------------------------------------------------------------
    # AIME (reference scenario_tree.py:38-108)
    # ------------------------------------------------------------------
    def _branch_aime(self, actor_mask) -> Dict[int, HostScenNode]:
        cfg = self.cfg
        scen = cfg.scen_tree
        A = cfg.max_actors
        Bpad = scen.max_branch_nodes

        root_pos, root_ang, root_vel, root_obs = self.obs_buffer.window()
        root_cov = np.full((A, OBS_LEN), 1e-5)

        nodes: Dict[int, HostScenNode] = {
            0: HostScenNode(key=0, parent=None, prob=1.0, cur_t=0, t_b=0,
                            duration=0, hist_pos=None, hist_ang=None,
                            hist_vel=None, hist_cov=None, tgt_pts=None)
        }
        next_key = 1
        branch = [0]

        for _depth in range(scen.max_depth):
            if not branch:
                break
            if len(branch) > Bpad:
                # the reference has no width limit; the production path
                # degrades overflow to end nodes — record the divergence
                self.diagnostics["branch_overflows"] += 1

            # windows: root uses the NN-filled buffer; deeper nodes slide
            # their own 110-frame hist by their duration (update_obser,
            # reference scenario_tree.py:467-567)
            windows = []
            for key in branch:
                nd = nodes[key]
                if key == 0:
                    windows.append((root_pos, root_ang, root_vel, root_cov,
                                    root_obs))
                else:
                    d = nd.duration
                    windows.append((
                        nd.hist_pos[:, d:d + OBS_LEN],
                        nd.hist_ang[:, d:d + OBS_LEN],
                        nd.hist_vel[:, d:d + OBS_LEN],
                        nd.hist_cov[:, d:d + OBS_LEN],
                        np.ones((A, OBS_LEN)),
                    ))

            preps = [
                prepare_node_inputs_np(
                    wp, wa, wv, wo, self.obs_buffer.types,
                    self.lane_feats, self.lane_anchors, self.lane_vecs,
                    self.tgt_points, self.tgt_info, self.tgt_n,
                    scen.tar_time_ahead)
                for (wp, wa, wv, wc, wo) in windows
            ]

            cls_b, reg_b, vel_b = self._predict(preps, actor_mask)

            new_branch = []
            for bi, key in enumerate(branch):
                nd = nodes[key]
                wp, wa, wv, wc, _ = windows[bi]
                cur_t = nd.cur_t + nd.duration   # this node's end time
                dec = decode_node_np(
                    cls_b[bi], reg_b[bi], vel_b[bi], preps[bi],
                    wp, wa, wv, wc, nd.prob, cur_t, actor_mask,
                    self.tgt_points, self.tgt_n, scen)
                if self.record_debug:
                    self.debug["rounds"].append({
                        "branch_key": key, "cur_t": cur_t,
                        "mode_probs": dec.prob.tolist(),
                        "keep": dec.keep.tolist(),
                        "t_b": dec.t_b.tolist(),
                        "prune_margin": dec.prune_margin.tolist(),
                        "tgt_margin": dec.tgt_margin.tolist(),
                        "merge_gap": dec.merge_gap.tolist(),
                    })
                made_child = False
                for m in range(len(dec.prob)):
                    if not dec.keep[m]:
                        continue
                    made_child = True
                    tb = int(dec.t_b[m])
                    is_end = tb >= PRED_LEN
                    end_t = PRED_LEN if is_end else tb
                    child = HostScenNode(
                        key=next_key, parent=key, prob=float(dec.prob[m]),
                        cur_t=cur_t, t_b=tb, duration=end_t - cur_t,
                        hist_pos=dec.pos[m], hist_ang=dec.ang[m],
                        hist_vel=dec.vel[m], hist_cov=dec.cov[m],
                        tgt_pts=dec.tgt_pts)
                    nodes[next_key] = child
                    nd.children.append(next_key)
                    depth = self._depth(nodes, next_key)
                    if is_end:
                        child.end = True
                    elif depth >= scen.max_depth:
                        child.terminated = True
                    else:
                        new_branch.append(next_key)
                    next_key += 1
                if not made_child:
                    nd.terminated = True
            branch = new_branch
        return nodes

    def program_set(self) -> programs.ProgramSet:
        """The compiled programs of the mirrors of this configuration and
        device (never a device planner's)."""
        return programs.program_set(self._signature, self.net, self.device)

    def _forward(self, inputs: ForwardInputs) -> torch.Tensor:
        """forward_body on the host batch `inputs`: its program (copy in,
        replay; a batch past max_branch_nodes is another program) or
        eagerly. Returns the packed outputs on the device."""
        if programs.compiled(self.device, self.graphed):
            prog = self.program_set().program("mirror_forward", forward_body, inputs)
            return prog(self.net, inputs)
        return forward_body(self.net, tree_map(lambda t: t.to(self.device), inputs))[0]

    @torch.no_grad()
    def _predict(self, preps, actor_mask):
        """One padded network forward over the branch batch (the shared
        network; padding rows reuse the first node's inputs and are
        discarded, so the forward has the device path's batch shape) and
        one read of its outputs, as float64."""
        Bpad = max(self.cfg.scen_tree.max_branch_nodes, len(preps))
        idx = list(range(len(preps))) + [0] * (Bpad - len(preps))
        f32 = np.float32
        actors = np.stack([preps[i].actors for i in idx]).astype(f32)
        lanes = np.stack([preps[i].lanes for i in idx]).astype(f32)
        rpe = np.stack([preps[i].rpe for i in idx]).astype(f32)
        tgt_nodes = np.stack([preps[i].tgt_nodes for i in idx]).astype(f32)
        tgt_rpe = np.stack([preps[i].tgt_rpe for i in idx]).astype(f32)
        amask = np.broadcast_to(actor_mask, (Bpad,) + actor_mask.shape)
        lmask = np.broadcast_to(self.lane_mask, (Bpad,) + self.lane_mask.shape)
        packed = self._forward(ForwardInputs(*(
            torch.from_numpy(np.ascontiguousarray(x))
            for x in (actors, amask, lanes, lmask, rpe, tgt_nodes, tgt_rpe))))
        n = len(preps)
        out = packed[:n].cpu().numpy()   # the one read
        A, M = actors.shape[1], self.cfg.net.num_modes
        r = M + A * M * PRED_LEN * 5
        return (out[:, :M], out[:, M:r].reshape(n, A, M, PRED_LEN, 5),
                out[:, r:].reshape(n, A, M, PRED_LEN, 2))

    @staticmethod
    def _depth(nodes, key):
        d = 0
        while nodes[key].parent is not None:
            key = nodes[key].parent
            d += 1
        return d

    # ------------------------------------------------------------------
    # export + renormalization (reference scenario_tree.py:208-272)
    # ------------------------------------------------------------------
    def _export_trees(self, nodes: Dict[int, HostScenNode]) -> List[int]:
        """Mark ancestors of end nodes, renormalize probabilities over
        end-flagged siblings; returns the root-child keys (one scenario tree
        each)."""
        for key in list(nodes):
            if nodes[key].end:
                k = key
                while k is not None:
                    nodes[k].end = True
                    k = nodes[k].parent

        root = nodes[0]
        end_children = [k for k in root.children if nodes[k].end]
        if not end_children:
            return []

        root.norm_prob = 1.0
        queue = [0]
        while queue:
            k = queue.pop(0)
            kids = [c for c in nodes[k].children if nodes[c].end]
            total = sum(nodes[c].prob for c in kids)
            for c in kids:
                nodes[c].norm_prob = nodes[c].prob / total * nodes[k].norm_prob
                queue.append(c)
        return end_children

    # ------------------------------------------------------------------
    # cost trees (reference trajectory_tree.py:28-122)
    # ------------------------------------------------------------------
    def _cost_tree(self, nodes, root_key: int,
                   exo_valid: np.ndarray) -> List[HostCostNode]:
        """DFS over the scenario tree, one cost node per even step."""
        out: List[HostCostNode] = []
        stack = [(root_key, -1)]
        while stack:
            key, last = stack.pop()
            nd = nodes[key]
            traj = nd.hist_pos[:, OBS_LEN:OBS_LEN + nd.duration]
            cov = nd.hist_cov[:, OBS_LEN:OBS_LEN + nd.duration]
            for i in range(0, nd.duration, 2):
                out.append(HostCostNode(
                    parent=last, prob=nd.norm_prob,
                    ego_mean=traj[0, i], ego_cov=float(cov[0, i]),
                    exo_mean=traj[1:, i][exo_valid],
                    exo_cov=cov[1:, i][exo_valid]))
                last = len(out) - 1
            for c in nd.children:
                if nodes[c].end:
                    stack.append((c, last))
        return out

    def _cost_params(self, phase: OptPhaseConfig, x0, tv: float,
                     warm: bool) -> HostCostParams:
        n, _ = phase.smooth_grid_size
        res = phase.smooth_grid_res
        field_size = (n - 1) * res
        offset = np.array([x0[0] - 0.5 * field_size,
                           x0[1] - 0.5 * field_size])
        return HostCostParams(
            field_offset=offset, res=res, grid_n=n,
            tgt_lane=self.gt_tgt_lane,
            w_tgt=phase.w_tgt,
            w_ego=0.0 if warm else phase.w_ego,
            w_ego_cov_offset=phase.w_ego_cov_offset,
            w_exo=0.0 if warm else phase.w_exo,
            w_exo_cov_offset=phase.w_exo_cov_offset,
            w_exo_cost_offset=phase.w_exo_cost_offset,
            w_des_state=np.diag(phase.w_des_state()).copy(),
            des_state=np.array([0, 0, tv, 0, 0, 0], float),
            w_state_con=np.diag(phase.w_state_con()).copy(),
            state_lb=np.asarray(phase.state_lower_bound, float),
            state_ub=np.asarray(phase.state_upper_bound, float),
            w_ctrl=np.array([phase.w_ctrl, phase.w_ctrl], float),
        )

    # ------------------------------------------------------------------
    # selection (reference planner.py:180-198)
    # ------------------------------------------------------------------
    def _evaluate(self, xs, us, x0, tv: float) -> float:
        cfg = self.cfg
        lane = self.eval_lane

        def node_cost(x, u):
            seg = lane[1:] - lane[:-1]
            len_sq = np.sum(seg * seg, axis=-1)
            len_sq = np.where(len_sq > 0, len_sq, 1.0)
            t = np.clip(np.sum((x[:2] - lane[:-1]) * seg, axis=-1) / len_sq,
                        0.0, 1.0)
            proj = lane[:-1] + t[:, None] * seg
            d = float(np.min(np.linalg.norm(x[:2] - proj, axis=-1)))
            return (cfg.comfort_acc_weight * u[0] ** 2
                    + cfg.comfort_str_weight * u[1] ** 2
                    + cfg.efficiency_weight * (tv - x[2]) ** 2
                    + cfg.target_weight * d)

        total = sum(node_cost(xs[i], us[i]) for i in range(len(xs)))
        total += node_cost(x0, np.zeros(2))
        return total / (len(xs) + 1)
