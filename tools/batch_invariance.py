"""Batch invariance on the card: does a scene planned in a batch of S
compute what it computes alone?

    python3 tools/batch_invariance.py [--scenes 4] [--float32]

On S synthetic plan-cycle scenes (`synthetic.py::synthetic_scene`, seeds
0..S-1, 40 agents) at full width under the demo configuration (bf16 network,
trained weights; `--float32`: the float32 defaults), with the same inputs
each time:
1. network: one forward of the S * B nodes of the first AIME round, as AIME
   makes it (under batch_invariant.scenes(S)), against the forward of each
   scene's B nodes alone (max abs gap of cls, reg, vel),
   and the first modules whose outputs differ (scenes 0 and 1); chip_smoke.py
   holds the fusion kernels alone, 32 nodes against each 8;
2. AIME: the batched aime_grow_tree against each scene's alone (rounds, the
   tree metadata equal or not, max gap of the positions of the slots);
3. solve: the batched two-phase solve of the S * 6 trees of the batched
   AIME against each scene's 6 trees alone on the same cost nodes (equal
   iteration counts or not, max gap of xs), and the selection costs.
`--solver` instead holds the tree iLQR's pieces (rollout, cost expansion,
backward sweep, policy rollout, tree cost) on make_tree_batch's 1024 trees
against the first 256 alone. Prints one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mind_tpu_torch.common import batch_invariant  # noqa: E402
from mind_tpu_torch.config import PlannerConfig, planner_config_for_demo  # noqa: E402
from mind_tpu_torch.models.weights import load_scene_pred  # noqa: E402
from mind_tpu_torch.ops.potential import select_trees  # noqa: E402
from mind_tpu_torch.planner import aime_device as aime  # noqa: E402
from mind_tpu_torch.planner import planner as tplanner  # noqa: E402
from mind_tpu_torch.planner.cost_topology import device_cost_topology  # noqa: E402
from mind_tpu_torch.planner.trajectory_tree import (evaluate_traj_tree,  # noqa: E402
                                                    gather_cost_nodes, make_cost_params,
                                                    torch_dtype, two_phase_solve)
from mind_tpu_torch.sim.episode import _stack  # noqa: E402
from mind_tpu_torch.synthetic import scene_statics, synthetic_scene  # noqa: E402


class Recorder:
    """The network, keeping the inputs of its first call."""

    def __init__(self, net):
        self.net, self.inputs = net, None

    def __call__(self, *inputs):
        if self.inputs is None:
            self.inputs = inputs
        return self.net(*inputs)


def scene_inputs(cfg, scene, dev):
    pdt = torch_dtype(cfg.pipeline_dtype)
    buf = aime.DeviceObsBuffer.create(scene.history.shape[0], pdt, dev)
    for f in range(scene.history.shape[1]):
        buf = aime.obs_buffer_update(buf, torch.tensor(scene.history[:, f], device=dev),
                                     torch.tensor(scene.present, device=dev))
    st = scene_statics(scene, pdt, dev)
    x0 = np.concatenate([scene.history[0, -1], [0.0, 0.0]])
    tt = cfg.traj_tree
    wp, fp = (make_cost_params(ph, x0, st.cost_lane, scene.target_vel,
                               tplanner.MAX_COST_TGT_PTS, w, dev)
              for ph, w in ((tt.warm, True), (tt.full, False)))
    return dict(buf=buf, types=torch.tensor(scene.types, device=dev),
                amask=torch.tensor(scene.present, device=dev), lane=st.lane, tgt=st.tgt,
                segs=st.eval_segs, x0=torch.tensor(x0, device=dev), wp=wp, fp=fp,
                tv=scene.target_vel)


def gap(a, b):
    return float((a.float() - b.float()).abs().max())


def first_differing_modules(net, inputs, B, s=0, n=5):
    """The first modules, in call order, whose output for nodes s * B ..
    (s + 1) * B - 1 differs between the whole batch and those B nodes alone
    (module name, output shape, max abs gap)."""
    records = []

    def hook(name):
        def fn(_, __, output):
            if isinstance(output, torch.Tensor):
                records.append((name, output))
        return fn

    handles = [m.register_forward_hook(hook(name)) for name, m in net.named_modules() if name]
    try:
        with batch_invariant.scenes(inputs[0].shape[0] // B):
            net(*inputs)
        whole, records[:] = list(records), []
        net(*(x[s * B:(s + 1) * B] for x in inputs))
        alone = list(records)
    finally:
        for h in handles:
            h.remove()
    rows = inputs[0].shape[0]
    out = []
    for (name, a), (_, b) in zip(whole, alone):
        if a.shape[0] == rows and b.shape[0] == B:
            a = a[s * B:(s + 1) * B]
        elif a.shape[0] % rows == 0 and b.shape[0] == a.shape[0] // rows * B:
            k = a.shape[0] // rows          # rows folded into the leading axis, node-major
            a = a[s * B * k:(s + 1) * B * k]
        if a.shape != b.shape:
            continue
        g = gap(a, b)
        if g > 0:
            out.append((name, list(b.shape), g))
            if len(out) == n:
                break
    return out


def solver_gaps(dev, n=1024, cut=256):
    """The tree iLQR's pieces on make_tree_batch's 1024 trees (the scale
    test's sizes) against the same on the first 256 alone, on identical
    inputs: the max abs gap of each piece's outputs, and of one batched
    product alone."""
    from mind_tpu_torch.ops.potential import cost_node_eval, node_aligned
    from mind_tpu_torch.parallel.scale import make_tree_batch
    from mind_tpu_torch.planner import ilqr as il

    topo, nodes, params, x0 = make_tree_batch(n, 24, 32, 24, 4, 4, device=dev)
    params = node_aligned(params, 2)
    cfg = il.ILQRConfig(max_iterations=10)
    lv = il._levels_in_use(topo)
    g = torch.Generator(device="cpu").manual_seed(0)
    us = (torch.randn(n, 32, 2, generator=g) * 0.3).to(dev)

    def pieces(k):
        t = il.TreeTopology(*(x[:k] for x in topo))
        nd = type(nodes)(*(x[:k] for x in nodes))
        xs = il._rollout(t, x0[:k], us[:k], cfg.dt, cfg.wheelbase, lv)
        d = il._derivatives(xs, us[:k], nd, params, t.node_mask, cfg.dt, cfg.wheelbase)
        kk, KK, _ = il._backward(t, d, torch.ones(k, device=dev), lv)
        xs2, us2 = il._rollout_policy(t, x0[:k], xs, us[:k], kk, KK,
                                      torch.full((k,), 0.5, device=dev), cfg.dt, cfg.wheelbase, lv)
        return {"rollout": xs, "cost_terms": cost_node_eval(xs, us[:k], nd, params)[1],
                "derivatives": d[3], "backward_k": kk, "backward_K": KK,
                "policy_rollout": xs2, "tree_cost": il._tree_cost(t, xs2, us2, nd, params)}

    whole, alone = pieces(n), pieces(cut)
    out = {k: gap(whole[k][:cut], alone[k]) for k in whole}
    a = torch.randn(n * 16, 6, 6, generator=g).to(dev)
    b = torch.randn(n * 16, 6, 6, generator=g).to(dev)
    out["bmm_6x6"] = gap((a @ b)[:cut * 16], a[:cut * 16] @ b[:cut * 16])
    return out


@torch.no_grad()
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--solver", action="store_true",
                    help="only the tree iLQR's pieces on 1024 trees against 256 alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("batch_invariance: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.solver:
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "solver_gap_1024_vs_256": solver_gaps(dev)}))
        return 0
    if args.float32:
        cfg = PlannerConfig()
        cfg.ckpt_path = str(Path(__file__).resolve().parent.parent / "mind_tpu_torch" / "weights"
                            / "scene_pred_demo_600.npz")
    else:
        cfg = planner_config_for_demo("demo_1")
    net = load_scene_pred(cfg.net, cfg.ckpt_path, dev)
    S, B, T = args.scenes, cfg.scen_tree.max_branch_nodes, tplanner.MAX_TREES
    ins = [scene_inputs(cfg, synthetic_scene(s, cfg.max_actors, cfg.max_lanes, n_agents=40), dev)
           for s in range(S)]
    st = lambda k: _stack([i[k] for i in ins], dev)
    ts = lambda k: torch.stack([i[k] for i in ins])
    out = {"device": torch.cuda.get_device_name(0), "scenes": S, "config":
           "float32" if args.float32 else "demo_1 (bf16 network)"}

    # 1. the network on the first round's nodes
    rec = Recorder(net)
    state_b, meta_b, rounds_b = aime.aime_grow_tree(rec, cfg, st("buf"), ts("types"),
                                                    ts("amask"), st("lane"), st("tgt"))
    with batch_invariant.scenes(S):
        full = net(*rec.inputs)
    out["network_gap"] = []
    for s in range(S):
        alone = net(*(x[s * B:(s + 1) * B] for x in rec.inputs))
        out["network_gap"].append([gap(a[s * B:(s + 1) * B], b) for a, b in zip(full, alone)])
    # the same batch twice: run-to-run
    with batch_invariant.scenes(S):
        again = net(*rec.inputs)
    out["network_rerun_gap"] = [gap(a, b) for a, b in zip(full, again)]
    out["network_first_differing_modules"] = {
        s: first_differing_modules(net, rec.inputs, B, s) for s in range(min(S, 2))}

    # 2. AIME
    out["aime"] = []
    for s, i in enumerate(ins):
        st_s, meta_s, r_s = aime.aime_grow_tree(net, cfg, *aime.scene_axis(
            i["buf"], i["types"], i["amask"], i["lane"], i["tgt"]))
        act = st_s.active[0]
        same = all(torch.equal(getattr(meta_b, f)[s], getattr(meta_s, f)[0])
                   for f in ("parent", "duration", "end_flag", "tree_id"))
        out["aime"].append({"rounds": int(r_s), "meta_equal": same,
                            "pos_gap": gap(state_b.slots.pos[s][act], st_s.slots.pos[0][act]),
                            "norm_prob_gap": gap(meta_b.norm_prob[s], meta_s.norm_prob[0])})
    out["aime_rounds_batched"] = int(rounds_b)

    # 3. the solve on the batched trees, all at once and per scene
    tt = cfg.traj_tree
    ilqr, warm = tplanner.ilqr_configs(cfg)
    dct = device_cost_topology(state_b.parent, state_b.depth, state_b.duration, state_b.start_t,
                               state_b.end_flag, meta_b.tree_id, T, tt.max_cost_nodes,
                               tt.max_depth_levels, tt.max_width_hint)
    scene = torch.arange(S, device=dev).repeat_interleave(T)
    nodes = gather_cost_nodes(state_b.slots, meta_b.norm_prob, dct.cost_slot, dct.cost_step,
                              dct.topo.node_mask, ts("amask"), scene,
                              dtype=torch_dtype(ilqr.dtype))
    x0s = ts("x0")
    wp_b, fp_b = st("wp"), st("fp")
    xs_b, us_b, info_b = two_phase_solve(dct.topo, x0s.index_select(0, scene), nodes,
                                         select_trees(wp_b, scene), select_trees(fp_b, scene),
                                         ilqr, warm, active=dct.tree_mask)
    segs = tuple(x.index_select(0, scene) for x in st("segs"))
    tv = torch.tensor([i["tv"] for i in ins], dtype=torch.float64, device=dev).index_select(0, scene)
    x0t = x0s.index_select(0, scene)
    cost_b = evaluate_traj_tree(xs_b, us_b, dct.topo.node_mask, dct.topo.node_mask.sum(-1),
                                x0t, *segs, tv, tplanner.selection_weights(cfg))
    out["solve"] = []
    for s, i in enumerate(ins):
        g = slice(s * T, (s + 1) * T)
        m = dct.tree_mask[g]
        xs, us, info = two_phase_solve(type(dct.topo)(*(x[g] for x in dct.topo)), i["x0"],
                                       type(nodes)(*(x[g] for x in nodes)), i["wp"], i["fp"],
                                       ilqr, warm, active=m)
        cost = evaluate_traj_tree(xs, us, dct.topo.node_mask[g], dct.topo.node_mask[g].sum(-1),
                                  x0t[g], *(x[g] for x in segs), tv[g],
                                  tplanner.selection_weights(cfg))
        its = lambda inf, k, sl=slice(None): inf[k][sl][m].tolist()
        out["solve"].append({
            "trees": int(m.sum()),
            "iterations_batched": its(info_b, "iterations", g),
            "iterations_alone": its(info, "iterations"),
            "warm_batched": its(info_b, "warm_iterations", g),
            "warm_alone": its(info, "warm_iterations"),
            "xs_gap": gap(xs_b[g][m], xs[m]) if bool(m.any()) else 0.0,
            "selection_cost_gap": gap(cost_b[g][m], cost[m]) if bool(m.any()) else 0.0})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
