"""Batched tree-structured iLQR (port of mind_tpu/planner/ilqr.py).

The JAX package vmaps a `lax.while_loop` solver over trees; here a batch
axis G of trees is written out and the loop runs until no tree is active.
Finished trees keep their state while the others iterate, as under vmap.
The loop is `graph_control.device_while` over the run mask: inside a
captured program (the episode program, sim/episode.py) a WHILE node of
its CUDA graph, with no host read; on the CPU an eager loop with one host
read per iteration. On the card outside a program, the loop body
(`_iterate`) is one captured CUDA graph, replayed REPLAYS_PER_READ times per
host read of the run mask.

- topology as index arrays: `level_table[g, l]` lists the node slots at
  tree depth l (padded with -1); `parent[g, n]` is each node's parent slot
  (-1 = attached to the root state x0);
- forward rollout: a Python loop over all depth levels of the topology
  (as the JAX package's fixed shapes: a level that holds no node writes
  only the dump slot MN and adds zeros in the backward sweep, so it changes
  nothing), each level one batched dynamics step gathered from parents,
  with the dump slot MN for the -1 ids;
- derivatives: the analytic jacobians of the bicycle step and the cost
  expansion of ops/potential.py at (x_new, u) per node;
- backward pass: reverse level loop with the children's value sums added
  into their parents (the contingency sum of solver.py:349-350) through a
  one-hot product, so the sum order is fixed (no atomics); its small matrix
  products are summed in an order that does not depend on the number of
  trees (`_mm`), so a tree solves the same alone or in a batch;
- line search: all alphas rolled out in parallel, first improving alpha
  taken (the reference's first-accept backtrack);
- Levenberg-Marquardt schedule per tree; a non-PD Quu is a rejected step.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

# a tree's result must not depend on how many trees share its solve
from mind_tpu_torch.common.batch_invariant import mm as _mm, mv as _mv
from mind_tpu_torch.common.kinematics import ext_bicycle_jacobians, ext_bicycle_step
from mind_tpu_torch.ops import graph_control
from mind_tpu_torch.ops.potential import (CostParams, NodeCostData, cost_node_eval, node_aligned,
                                          tree_axis_fields)


class TreeTopology(NamedTuple):
    parent: torch.Tensor       # [..., MN] long, -1 = child of the root state x0
    node_mask: torch.Tensor    # [..., MN] bool
    level_table: torch.Tensor  # [..., LV, W] long node ids per depth level, -1 pad


class ILQRConfig(NamedTuple):
    dt: float = 0.2
    wheelbase: float = 2.5
    max_iterations: int = 100
    rel_tol: float = 1e-6
    n_line_search: int = 10
    mu_init: float = 1.0
    mu_min: float = 1e-6
    mu_max: float = 1e10
    delta_0: float = 2.0
    # solve precision ("float32" | "float64"), applied at two_phase_solve entry
    dtype: str = "float32"


def _rows(a, ids):
    """a [G, R, ...] gathered at ids [G, W] -> [G, W, ...]."""
    g = torch.arange(a.shape[0], device=a.device)[:, None]
    return a[g, ids]


def _levels_in_use(topo: TreeTopology) -> int:
    """Number of leading levels that hold a node in any tree (one host read;
    for reports: the solve runs every level)."""
    used = (topo.level_table >= 0).any(-1).any(0)   # [LV]
    return int(used.nonzero().max()) + 1 if bool(used.any()) else 0


def _rollout(topo: TreeTopology, x0, us, dt, wb, n_levels):
    """Tree forward rollout: xs[n] = f(xs[parent[n]] or x0, us[n]).
    topo [G, ...], x0 [G, 6], us [G, MN, 2] -> xs [G, MN, 6]."""
    G, MN = us.shape[:2]
    xs = x0.new_zeros((G, MN + 1, x0.shape[-1]))
    for lv in range(n_levels):
        ids = topo.level_table[:, lv]                           # [G, W]
        valid = ids >= 0
        safe = torch.clamp(ids, 0, MN - 1)
        par = torch.where(valid, _rows(topo.parent, safe), torch.full_like(ids, -1))
        has_par = (par >= 0)[..., None]
        x_prev = torch.where(has_par, _rows(xs, torch.clamp(par, min=0)), x0[:, None])
        x_new = ext_bicycle_step(x_prev, _rows(us, safe), dt, wb)
        write = torch.where(valid, ids, torch.full_like(ids, MN))
        g = torch.arange(G, device=xs.device)[:, None]
        xs[g, write] = x_new
    return xs[:, :MN]


def _rollout_policy(topo: TreeTopology, x0, xs_nom, us_nom, k, K, alpha, dt, wb,
                    n_levels):
    """Closed-loop tree re-rollout under the affine policy
    u = u_nom + alpha*k + K (x_parent_new - x_parent_nom) (solver.py:202-240).
    All tensors carry the batch axis G; alpha [G]."""
    G, MN = us_nom.shape[:2]
    xs = x0.new_zeros((G, MN + 1, x0.shape[-1]))
    us = us_nom.new_zeros((G, MN + 1, us_nom.shape[-1]))
    g = torch.arange(G, device=xs.device)[:, None]
    for lv in range(n_levels):
        ids = topo.level_table[:, lv]
        valid = ids >= 0
        safe = torch.clamp(ids, 0, MN - 1)
        par = torch.where(valid, _rows(topo.parent, safe), torch.full_like(ids, -1))
        has_par = (par >= 0)[..., None]
        safe_par = torch.clamp(par, min=0)
        x_prev_new = torch.where(has_par, _rows(xs, safe_par), x0[:, None])
        x_prev_nom = torch.where(has_par, _rows(xs_nom, safe_par), x0[:, None])
        du = _mv(_rows(K, safe), x_prev_new - x_prev_nom)
        u_new = _rows(us_nom, safe) + alpha[:, None, None] * _rows(k, safe) + du
        x_new = ext_bicycle_step(x_prev_new, u_new, dt, wb)
        write = torch.where(valid, safe, torch.full_like(ids, MN))
        xs[g, write] = x_new
        us[g, write] = u_new
    return xs[:, :MN], us[:, :MN]


def _derivatives(xs, us, nodes: NodeCostData, params: CostParams, node_mask, dt, wb):
    """Dynamics jacobians + cost expansion at (x_new, u) per node."""
    F_x, F_u = ext_bicycle_jacobians(xs, dt, wb)
    L, L_x, L_u, L_xx, L_uu = cost_node_eval(xs, us, nodes, params)
    m = node_mask
    zero = torch.zeros((), dtype=L.dtype, device=L.device)
    L = torch.where(m, L, zero)
    L_x = torch.where(m[..., None], L_x, zero)
    L_u = torch.where(m[..., None], L_u, zero)
    L_xx = torch.where(m[..., None, None], L_xx, zero)
    L_uu = torch.where(m[..., None, None], L_uu,
                       torch.eye(L_uu.shape[-1], dtype=L_uu.dtype, device=L_uu.device))
    return F_x, F_u, L, L_x, L_u, L_xx, L_uu


def _tree_cost(topo: TreeTopology, xs, us, nodes, params):
    l = cost_node_eval(xs, us, nodes, params)[0]
    return torch.where(topo.node_mask, l, torch.zeros_like(l)).sum(-1)


def _backward(topo: TreeTopology, derivs, mu, n_levels):
    """Leaf-to-root Riccati sweep with child-value aggregation. Returns
    (k [G, MN, 2], K [G, MN, 2, 6], pd_ok [G]). Parent V accumulates the
    SUM of its children's V (solver.py:344-350)."""
    F_x, F_u, _, L_x, L_u, L_xx, L_uu = derivs
    G, MN, n_x = F_x.shape[:3]
    n_u = F_u.shape[-1]
    dt_, dev = F_x.dtype, F_x.device
    V_x = torch.zeros((G, MN + 1, n_x), dtype=dt_, device=dev)
    V_xx = torch.zeros((G, MN + 1, n_x, n_x), dtype=dt_, device=dev)
    # dump row MN: padded level entries (-1) must not alias a real slot
    k = torch.zeros((G, MN + 1, n_u), dtype=dt_, device=dev)
    K = torch.zeros((G, MN + 1, n_u, n_x), dtype=dt_, device=dev)
    eye = torch.eye(n_x, dtype=dt_, device=dev)
    pd_ok = torch.ones(G, dtype=torch.bool, device=dev)
    g = torch.arange(G, device=dev)[:, None]
    slots = torch.arange(MN + 1, device=dev)
    mu = mu[:, None, None, None]

    for lv in reversed(range(n_levels)):
        ids = topo.level_table[:, lv]                           # [G, W]
        valid = ids >= 0
        safe = torch.clamp(ids, 0, MN - 1)
        f_x, f_u = _rows(F_x, safe), _rows(F_u, safe)
        v_x, v_xx = _rows(V_x, safe), _rows(V_xx, safe)
        f_xT, f_uT = f_x.transpose(-1, -2), f_u.transpose(-1, -2)

        Q_x = _rows(L_x, safe) + _mv(f_xT, v_x)
        Q_u = _rows(L_u, safe) + _mv(f_uT, v_x)
        Q_xx = _rows(L_xx, safe) + _mm(_mm(f_xT, v_xx), f_x)
        V_reg = v_xx + mu * eye
        f_uT_V = _mm(f_uT, V_reg)
        Q_ux = _mm(f_uT_V, f_x)
        Q_uu = _rows(L_uu, safe) + _mm(f_uT_V, f_u)

        # PD check for 2x2 Quu: leading minor > 0 and det > 0
        a, b = Q_uu[..., 0, 0], Q_uu[..., 0, 1]
        c, d = Q_uu[..., 1, 0], Q_uu[..., 1, 1]
        det = a * d - b * c
        pd = (a > 0) & (det > 0)
        pd_ok = pd_ok & torch.where(valid, pd, torch.ones_like(pd)).all(-1)

        # closed-form 2x2 inverse
        inv_det = 1.0 / torch.where(det != 0, det, torch.ones_like(det))
        Quu_inv = torch.stack([torch.stack([d, -b], -1),
                               torch.stack([-c, a], -1)], -2) * inv_det[..., None, None]
        k_n = -_mv(Quu_inv, Q_u)
        K_n = -_mm(Quu_inv, Q_ux)

        Kt = K_n.transpose(-1, -2)
        Q_uxT = Q_ux.transpose(-1, -2)
        v_x_new = (Q_x
                   + _mv(Kt, _mv(Q_uu, k_n))
                   + _mv(Kt, Q_u)
                   + _mv(Q_uxT, k_n))
        v_xx_new = Q_xx + _mm(_mm(Kt, Q_uu), K_n) + _mm(Kt, Q_ux) + _mm(Q_uxT, K_n)
        v_xx_new = 0.5 * (v_xx_new + v_xx_new.transpose(-1, -2))

        write_kK = torch.where(valid, safe, torch.full_like(ids, MN))
        k[g, write_kK] = k_n
        K[g, write_kK] = K_n

        # add into parents (root children into the dump slot MN) as a one-hot
        # product over the level's W entries: a fixed-order sum
        par = torch.where(valid, _rows(topo.parent, safe), torch.full_like(ids, -1))
        write = torch.where(par >= 0, par, torch.full_like(par, MN))
        onehot = (write[..., None] == slots).to(dt_) * valid[..., None].to(dt_)  # [G, W, MN+1]
        oh_t = onehot.transpose(1, 2)                                            # [G, MN+1, W]
        V_x = V_x + _mm(oh_t, v_x_new)
        V_xx = V_xx + _mm(oh_t, v_xx_new.reshape(G, -1, n_x * n_x)).reshape(V_xx.shape)
    return k[:, :MN], K[:, :MN], pd_ok


class _Inputs(NamedTuple):
    """What one solve's iterations read: the trees, their start, cost data
    and parameters (per-tree leaves aligned to the nodes), the active mask,
    and the same expanded to the G * NA line-search rollouts (built once per
    solve, outside the iteration)."""

    topo: TreeTopology
    x0: torch.Tensor         # [G, 6]
    nodes: NodeCostData
    params: CostParams
    active: torch.Tensor     # [G] bool
    topo_r: TreeTopology     # [G * NA, ...]
    x0_r: torch.Tensor       # [G * NA, 6]
    nodes_r: NodeCostData
    params_r: CostParams     # per-tree leaves [G * NA, 1, ...]
    alpha_r: torch.Tensor    # [G * NA]


class _State(NamedTuple):
    """The solver's loop state, per tree; the last seven fields are the
    derivatives at the current (xs, us)."""

    xs: torch.Tensor
    us: torch.Tensor
    J_opt: torch.Tensor
    mu: torch.Tensor
    delta: torch.Tensor
    accepted: torch.Tensor
    converged: torch.Tensor
    diverged: torch.Tensor
    it: torch.Tensor
    F_x: torch.Tensor
    F_u: torch.Tensor
    L: torch.Tensor
    L_x: torch.Tensor
    L_u: torch.Tensor
    L_xx: torch.Tensor
    L_uu: torch.Tensor


def _sel(m, new, old):
    return torch.where(m.view((-1,) + (1,) * (new.dim() - 1)), new, old)


def _running(st: _State, active, cfg: ILQRConfig):
    return active & ~st.converged & ~st.diverged & (st.it < cfg.max_iterations)


def _iterate(inp: _Inputs, st: _State, cfg: ILQRConfig, n_levels: int) -> _State:
    """One iteration of every running tree: derivative refresh where the
    last step was accepted, backward sweep, parallel line search, LM and
    convergence update. A tree that does not run keeps its state, so extra
    calls after the last iteration change nothing. No host read: this is
    the body that a CUDA graph captures."""
    dt, wb, NA = cfg.dt, cfg.wheelbase, cfg.n_line_search
    G = st.xs.shape[0]
    run = _running(st, inp.active, cfg)
    # where nothing was accepted, _sel keeps the old derivatives
    fresh = _derivatives(st.xs, st.us, inp.nodes, inp.params, inp.topo.node_mask, dt, wb)
    derivs = tuple(_sel(st.accepted, n, o) for n, o in zip(fresh, st[9:]))

    k, K, pd_ok = _backward(inp.topo, derivs, st.mu, n_levels)

    # parallel line search over all alphas
    rep = lambda t: t.repeat_interleave(NA, dim=0)     # [G, ...] -> [G*NA, ...]
    xs_c, us_c = _rollout_policy(inp.topo_r, inp.x0_r, rep(st.xs), rep(st.us), rep(k), rep(K),
                                 inp.alpha_r, dt, wb, n_levels)
    J_c = _tree_cost(inp.topo_r, xs_c, us_c, inp.nodes_r, inp.params_r).view(G, NA)
    J_opt = st.J_opt
    improved = (J_c < J_opt[:, None]) & pd_ok[:, None]
    any_improved = improved.any(-1)
    first = torch.argmax(improved.to(torch.uint8), dim=-1)  # first improving alpha
    pick = torch.arange(G, device=J_c.device) * NA + first
    xs_new, us_new = xs_c[pick], us_c[pick]
    J_new = J_c.gather(1, first[:, None])[:, 0]

    conv_new = any_improved & (((J_opt - J_new) / J_opt).abs() < cfg.rel_tol)

    # LM schedule (solver.py:153-158, 194-198)
    mu, delta = st.mu, st.delta
    delta_acc = torch.clamp(delta, max=1.0) / cfg.delta_0
    mu_acc = mu * delta_acc
    mu_acc = torch.where(mu_acc <= cfg.mu_min, torch.zeros_like(mu_acc), mu_acc)
    delta_rej = torch.clamp(delta, min=1.0) * cfg.delta_0
    mu_rej = torch.clamp(mu * delta_rej, min=cfg.mu_min)

    acc = any_improved
    upd = lambda new, old: _sel(run, new, old)
    return _State(
        xs=upd(_sel(acc, xs_new, st.xs), st.xs),
        us=upd(_sel(acc, us_new, st.us), st.us),
        J_opt=upd(torch.where(acc, J_new, J_opt), J_opt),
        mu=upd(torch.where(acc, mu_acc, mu_rej), mu),
        delta=upd(torch.where(acc, delta_acc, delta_rej), delta),
        accepted=upd(acc, st.accepted),
        converged=upd(conv_new, st.converged),
        diverged=upd(~acc & (mu_rej >= cfg.mu_max), st.diverged),
        it=st.it + run.long(),
        F_x=derivs[0], F_u=derivs[1], L=derivs[2], L_x=derivs[3], L_u=derivs[4],
        L_xx=derivs[5], L_uu=derivs[6])


def _signature(tree):
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if isinstance(tree, tuple):
        return tuple(_signature(x) for x in tree)
    return tree


# Replays of the captured iteration per host read of the run mask. A finished
# tree is masked out of every update, so the replays after the last iteration
# change nothing: k trades host reads against idle replays. On the H100 one
# replay of the plan-cycle scene's iteration (30 levels, 6 trees) takes
# ~18 ms, far more than a host read, so k = 1 is the faster (chip_smoke.py
# times both; PERF.md section 5).
REPLAYS_PER_READ = 1


class _GraphedIteration:
    """`_iterate` captured as one CUDA graph, on static input and state
    tensors that are allocated outside the graph's memory pool; the body
    copies the new state into the static state, so the graph keeps no
    tensor of its own alive and graphs can share one pool. The warm-up and
    the capture run on the cache's side stream, whose cuBLAS workspace the
    warm-up allocates outside the pool: a capture on a stream without one
    would allocate it inside and keep it there."""

    def __init__(self, inp: _Inputs, st: _State, cfg: ILQRConfig, n_levels: int, pool, side):
        self.inp = graph_control.empty_like(inp)
        self.state = graph_control.empty_like(st)
        self.cfg, self.n_levels = cfg, n_levels
        self.load(inp, st)
        # warm up on the side stream (cuBLAS handle and workspace, allocator)
        side.wait_stream(torch.cuda.current_stream(st.xs.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._body()
        torch.cuda.current_stream(st.xs.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=side):
            self._body()

    def _body(self):
        graph_control.assign(self.state, _iterate(self.inp, self.state, self.cfg, self.n_levels))

    def load(self, inp: _Inputs, st: _State):
        graph_control.assign(self.inp, inp)
        graph_control.assign(self.state, st)

    def solve(self, inp: _Inputs, st: _State) -> _State:
        self.load(inp, st)
        while bool(_running(self.state, self.inp.active, self.cfg).any()):   # one host read
            for _ in range(REPLAYS_PER_READ):
                self.graph.replay()
        return _State(*(t.clone() for t in self.state))


class _GraphCache:
    """One captured iteration per (device, solver settings, levels, input
    shapes and dtypes), all in one memory pool: graphs run one at a
    time on the caller's stream, and none keeps a tensor in the pool. One
    side stream per device serves every warm-up and capture."""

    def __init__(self):
        self.graphs = {}
        self.pool = None
        self.streams = {}

    def get(self, inp: _Inputs, st: _State, cfg: ILQRConfig, n_levels: int):
        dev = st.xs.device
        key = (dev, cfg, n_levels, _signature(inp), _signature(st))
        g = self.graphs.get(key)
        if g is None:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            side = self.streams.setdefault(dev, torch.cuda.Stream(device=dev))
            # the capture (torch.cuda.graph) and its warm-up belong to the
            # current device: make it the state's one
            with torch.cuda.device(dev):
                g = self.graphs[key] = _GraphedIteration(inp, st, cfg, n_levels, self.pool, side)
        return g


_GRAPHS = _GraphCache()


@functools.lru_cache(maxsize=None)
def _alphas(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The line search's step sizes 1.1^-(i^2), i < n, made once per dtype
    and device: a captured program cannot copy them from the host."""
    return torch.tensor(1.1 ** (-np.arange(n, dtype=np.float64) ** 2), dtype=dtype, device=device)


def _solve_loop(inp: _Inputs, st: _State, cfg: ILQRConfig, n_levels: int) -> _State:
    """The iterations as a device_while over the run mask, on a copy of
    `st` updated in place (a WHILE node inside a captured program, an
    eager loop with one host read per iteration outside)."""
    st = graph_control.clone(st)
    graph_control.device_while(
        lambda: _running(st, inp.active, cfg),
        lambda: graph_control.assign(st, _iterate(inp, st, cfg, n_levels)))
    return st


def ilqr_solve(topo: TreeTopology, x0, us_init, nodes: NodeCostData,
               params: CostParams, cfg: ILQRConfig = ILQRConfig(), active=None,
               graphed=None):
    """Fit the tree iLQR on a batch of G trees. topo fields [G, ...], x0
    [6] or [G, 6], us_init [G, MN, 2], nodes fields [G, MN, ...]; `params`
    shared, or with per-tree leaves [G, ...] (ops/potential.py); `active`
    [G] bool leaves trees out whose result is not needed (they keep their
    start). Returns (xs [G, MN, 6], us [G, MN, 2], info dict of [G]).

    The iterations run over every level of the topology (a level without
    a node changes nothing). Inside a captured program (graph_control) they
    are a WHILE node of its graph. Outside one, on a CUDA device each
    iteration is one replay of a captured CUDA graph (`_GraphedIteration`),
    with one host read of the run mask per REPLAYS_PER_READ replays; on the
    CPU the same `_iterate` runs eagerly, one host read per iteration.
    `graphed=False` runs the eager loop on the card too, to hold the two
    against each other; a capture that fails raises."""
    dt, wb = cfg.dt, cfg.wheelbase
    G, MN = us_init.shape[:2]
    dt_, dev = us_init.dtype, us_init.device
    in_program = graph_control.capturing()
    if graphed is None:
        graphed = dev.type == "cuda" and not in_program
    if graphed and (dev.type != "cuda" or in_program):
        raise ValueError(f"a graphed solve needs a CUDA device outside a captured program, "
                         f"got {dev}")
    x0 = x0.expand(G, x0.shape[-1])
    n_levels = topo.level_table.shape[-2]
    if active is None:
        active = torch.ones(G, dtype=torch.bool, device=dev)

    NA = cfg.n_line_search
    alphas = _alphas(NA, dt_, dev)
    rep = lambda t: t.repeat_interleave(NA, dim=0)     # [G, ...] -> [G*NA, ...]
    per_tree = tree_axis_fields(params)
    for f in per_tree:
        if getattr(params, f).shape[0] != G:
            raise ValueError(f"cost parameter {f} has {getattr(params, f).shape[0]} trees, "
                             f"the batch {G}")
    params_r = node_aligned(params._replace(**{f: rep(getattr(params, f)) for f in per_tree}), 2)
    params = node_aligned(params, 2)
    inp = _Inputs(topo=topo, x0=x0, nodes=nodes, params=params, active=active,
                  topo_r=TreeTopology(*(rep(t) for t in topo)), x0_r=rep(x0),
                  nodes_r=NodeCostData(*(rep(t) for t in nodes)), params_r=params_r,
                  alpha_r=alphas.repeat(G))

    xs = _rollout(topo, x0, us_init, dt, wb, n_levels)
    derivs = _derivatives(xs, us_init, nodes, params, topo.node_mask, dt, wb)
    zeros = lambda dtype: torch.zeros(G, dtype=dtype, device=dev)
    st = _State(xs, us_init, derivs[2].sum(-1), torch.full((G,), cfg.mu_init, dtype=dt_, device=dev),
                torch.full((G,), cfg.delta_0, dtype=dt_, device=dev), zeros(torch.bool),
                zeros(torch.bool), zeros(torch.bool), zeros(torch.long), *derivs)

    if graphed:
        st = _GRAPHS.get(inp, st, cfg, n_levels).solve(inp, st)
    else:
        st = _solve_loop(inp, st, cfg, n_levels)

    info = {"iterations": st.it, "J": st.J_opt, "converged": st.converged,
            "diverged": st.diverged}
    return st.xs, st.us, info


def build_topology(parent_list, max_nodes: int, max_levels: int,
                   max_width: int | None = None, device=None,
                   as_numpy: bool = False) -> TreeTopology:
    """Host helper: parent indices (-1 root-attached) -> padded TreeTopology
    of one tree. Nodes must be indexed parents before children. Pass
    `max_width` to stack trees of different shapes, and `as_numpy=True` to
    get numpy arrays: a caller that stacks several trees uploads them once
    instead of making tensors per tree."""
    n = len(parent_list)
    if n > max_nodes:
        raise ValueError(f"{n} cost nodes exceed max_nodes={max_nodes}")
    parent = np.full(max_nodes, -1, np.int64)
    parent[:n] = parent_list
    mask = np.zeros(max_nodes, bool)
    mask[:n] = True
    depth = np.zeros(max_nodes, np.int64)
    for i, p in enumerate(parent_list):
        depth[i] = 0 if p < 0 else depth[p] + 1
    levels = [[] for _ in range(max_levels)]
    for i in range(n):
        levels[depth[i]].append(i)
    width = max_width or max((len(l) for l in levels), default=1) or 1
    if any(len(l) > width for l in levels):
        raise ValueError("level width exceeds max_width")
    table = np.full((max_levels, width), -1, np.int64)
    for l, ids in enumerate(levels):
        table[l, :len(ids)] = ids
    if as_numpy:
        return TreeTopology(parent=parent, node_mask=mask, level_table=table)
    return TreeTopology(parent=torch.as_tensor(parent, device=device),
                        node_mask=torch.as_tensor(mask, device=device),
                        level_table=torch.as_tensor(table, device=device))
