"""Training of ScenePredNet: winner-takes-all scene loss, train step,
data-parallel step (port of mind_tpu/models/train.py).

The JAX package trains with jax.value_and_grad of its loss, and jax.grad
cannot pass a Pallas call, so its training differentiates the plain XLA
formulation of the fusion core. Here every training forward launches the
fusion kernel on the card, and the core's backward differentiates the plain
version (ops/fusion_attention.py::FusedEdgeAttentionFn): the same gradient.
Only the float32 network is trained, as in the JAX package.

Optimizers: optax.adam(lr) is torch.optim.Adam(lr) (betas 0.9, 0.999, eps
1e-8 in both); optax.adamw(lr) is `adamw(params, lr)` below, since optax's
default weight decay is 1e-4 and torch's 1e-2. The train step keeps the
torch optimizer's state (its state_dict is the checkpoint format) but
updates it with optax's formula on tensors (adam_update), so that the step
reads nothing from the host and can be captured whole
(models/train_program.py). optax updates every leaf, a parameter the loss
does not reach included (zero gradient: its moments decay, and AdamW's
decay applies); so does the train step.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.config import NetConfig
from mind_tpu_torch.models.scene_pred import ScenePredNet
from mind_tpu_torch.parallel.mesh import (DistMesh, all_reduce_sum, mesh_size,
                                          shard_rollouts, tree_map)


class Batch(NamedTuple):
    """One padded training batch (B scenes)."""

    actors: torch.Tensor      # [B, A, 48, 14]
    actor_mask: torch.Tensor  # [B, A]
    lanes: torch.Tensor       # [B, L, 10, 16]
    lane_mask: torch.Tensor   # [B, L]
    rpe: torch.Tensor         # [B, N, N, 5]
    tgt_nodes: torch.Tensor   # [B, 10, 16]
    tgt_rpe: torch.Tensor     # [B, 20]
    gt_pos: torch.Tensor      # [B, A, F, 2] future positions (instance frame)
    gt_mask: torch.Tensor     # [B, A, F] valid future steps

    def to(self, device) -> "Batch":
        return tree_map(lambda t: t.to(device), self)


def scene_loss(cls_prob, reg, gt_pos, gt_mask, eps=1e-6):
    """Winner-takes-all joint loss per scene: the mode with the lowest joint
    scene displacement gets the Laplace NLL, and the classification pushes
    probability onto it. cls_prob [..., M], reg [..., A, M, F, 5], gt_pos
    [..., A, F, 2], gt_mask [..., A, F] -> [...]. Ties go to the first mode,
    as jnp.argmin breaks them."""
    sigma = torch.clamp(reg[..., 2:4], min=eps)
    err = (reg[..., :2] - gt_pos.unsqueeze(-3)).abs()               # [..., A, M, F, 2]
    best = _winner(err, gt_mask, eps)                               # [...]

    def winner(x):                                                  # [..., A, M, F, 2]
        idx = best[..., None, None, None, None].expand(x.shape[:-3] + (1,) + x.shape[-2:])
        return torch.gather(x, -3, idx).squeeze(-3)                 # [..., A, F, 2]

    s_best = winner(sigma)
    nll = torch.log(2 * s_best) + winner(err) / s_best
    reg_loss = torch.where(gt_mask[..., None], nll, 0.0).sum((-3, -2, -1)) / (
        gt_mask.sum((-2, -1)) * 2 + eps)
    cls_loss = -torch.log(torch.gather(cls_prob, -1, best[..., None])[..., 0] + eps)
    return reg_loss + 0.5 * cls_loss


def _winner(err, gt_mask, eps):
    m = gt_mask.unsqueeze(-2).unsqueeze(-1).expand(err.shape)
    dims = (-4, -2, -1)
    ade = torch.where(m, err, 0.0).sum(dims) / (m.sum(dims) * 2 + eps)   # [..., M]
    return torch.argmin(ade, dim=-1)


def winning_modes(reg, gt_pos, gt_mask, eps=1e-6):
    """The mode scene_loss trains, per scene: the lowest joint displacement
    (the first on ties). Only where it is mode 0, into which the decoder
    puts the target lane, does the target branch get a gradient."""
    return _winner((reg[..., :2] - gt_pos.unsqueeze(-3)).abs(), gt_mask, eps)


def loss_fn(net, batch: Batch):
    """Mean of the per-scene losses over one batched forward."""
    cls_prob, reg, _vel = net(batch.actors, batch.actor_mask, batch.lanes, batch.lane_mask,
                              batch.rpe, batch.tgt_nodes, batch.tgt_rpe)
    return scene_loss(cls_prob, reg, batch.gt_pos, batch.gt_mask).mean()


def shift_invariant_params(cfg: NetConfig) -> list:
    """The parameters whose exact gradient is zero: biases that add the same
    number to every logit one softmax normalizes (each fusion layer's key
    bias, the mode attention's key biases, the mode logits' bias). Their
    computed gradients are rounding noise (about 1e-9 of the whole
    gradient's norm), which two correct computations need not share."""
    return ([f"FusionNet_0.RelaFusionLayer_{i}.b_k" for i in range(cfg.n_scene_layer)]
            + [f"SceneDecoder_0.SelfAttentionEncoderLayer_{i}.Dense_1.bias" for i in range(2)]
            + ["SceneDecoder_0.Dense_0.bias"])


def adamw(params, lr: float):
    """optax.adamw(lr) with its defaults (b1 0.9, b2 0.999, eps 1e-8,
    weight decay 1e-4)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def adam(params, lr: float):
    """optax.adam(lr) with its defaults."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


STATE_KEYS = ("step", "exp_avg", "exp_avg_sq")   # torch Adam's state of a parameter


def adam_groups(optimizer) -> list:
    """(parameters, lr, b1, b2, eps, decoupled weight decay) of each group of
    a torch Adam or AdamW, which the train step updates with optax's
    formula; raises for what optax.adam and optax.adamw do not compute
    (amsgrad, maximize, Adam's L2 weight decay)."""
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        raise TypeError(f"the train step updates with optax's Adam or AdamW; got "
                        f"{type(optimizer).__name__}")
    out = []
    for g in optimizer.param_groups:
        decoupled = isinstance(optimizer, torch.optim.AdamW) or g.get("decoupled_weight_decay")
        if g.get("amsgrad") or g.get("maximize") or (g["weight_decay"] and not decoupled):
            raise ValueError("optax's Adam has no amsgrad, maximize or L2 weight decay")
        b1, b2 = g["betas"]
        out.append((list(g["params"]), float(g["lr"]), float(b1), float(b2), float(g["eps"]),
                    float(g["weight_decay"]) if decoupled else 0.0))
    return out


def bind_state(optimizer, params, held=None) -> list:
    """The optimizer's state of each parameter as [step, exp_avg,
    exp_avg_sq] (torch Adam's layout, so `optimizer.state_dict()` stays the
    checkpoint format), made where missing: zeros, the step a float32 [] on
    the parameter's device (a loaded one comes back on the host). With
    `held` (an earlier result), every tensor the optimizer holds that is not
    held's (a load_state_dict replaced it) is copied into held's, which goes
    back into the optimizer: the tensors a captured update addresses stay
    the optimizer's own."""
    out = []
    for i, p in enumerate(params):
        st = optimizer.state[p]
        ts = []
        for j, k in enumerate(STATE_KEYS):
            t = st.get(k)
            if held is not None:
                mine = held[i][j]
                if t is not mine:
                    if t is None:
                        mine.zero_()
                    else:
                        mine.copy_(torch.as_tensor(t))
                    st[k] = t = mine
            elif t is None or t.device != p.device:
                new = (torch.zeros((), dtype=torch.float32, device=p.device) if k == "step"
                       else torch.zeros_like(p, memory_format=torch.preserve_format))
                if t is not None:
                    new.copy_(torch.as_tensor(t))
                st[k] = t = new
            ts.append(t)
        out.append(ts)
    return out


@torch.no_grad()
def adam_update(groups, grads, state):
    """One optax Adam / AdamW update of every parameter of `groups`
    (adam_groups) from its gradient in `grads` and its `state` (bind_state),
    in place, with no host read: the step count is a tensor, and optax's
    bias corrections 1 - b^count are computed from it in float64 and cast,
    as optax computes them under the JAX package's x64. The moments follow
    optax's (1 - b) g + b m; the update m_hat / (sqrt(v_hat) + eps), plus wd
    times the parameter for AdamW, times -lr, added to the parameter. optax
    updates every leaf: a parameter without gradient has a zero one here.
    Its one count is the first parameter's step of each group (all of a
    group's steps advance together)."""
    i = 0
    for params, lr, b1, b2, eps, wd in groups:
        n = len(params)
        g = grads[i:i + n]
        steps, mus, nus = (list(x) for x in zip(*state[i:i + n]))
        i += n
        torch._foreach_add_(steps, 1.0)
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(nus, b2)
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1.0 - b2)
        torch._foreach_add_(nus, sq)
        count = steps[0].double()
        bc1 = (1.0 - b1 ** count).float()
        bc2 = (1.0 - b2 ** count).float()
        upd = torch._foreach_div(mus, bc1)
        den = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(upd, den)
        if wd:
            torch._foreach_add_(upd, torch._foreach_mul(params, wd))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class StepBody:
    """The train step's work on `net`'s parameters, gradients and optimizer
    state, in two parts that read nothing from the host: `grads_of` (the
    gradients zeroed in place, forward, the mean scene loss and backward
    per shard, the loss into a tensor) and `update` (adam_update), with
    `all_reduce` between them on a DistMesh. The gradients are allocated
    once, here, and stay `p.grad` (`bind` puts them back where a caller
    replaced them): a captured step addresses them, as it addresses the
    optimizer's state (bind_state)."""

    def __init__(self, net: ScenePredNet, optimizer, mesh=None):
        if net.cfg.compute_dtype != "float32":
            raise ValueError("only the float32 network is trained (as in the JAX package)")
        self.net, self.optimizer, self.mesh = net, optimizer, mesh
        self.groups = adam_groups(optimizer)
        self.params = [p for g in self.groups for p in g[0]]   # what the optimizer trains
        self.device = self.params[0].device
        self.ranked = isinstance(mesh, DistMesh)
        with torch.no_grad():
            self.grads = [torch.zeros_like(p) for p in self.params]
        self.state = None
        self.bind()

    def bind(self):
        """Before a step: the groups' hyperparameters read anew (a changed
        one is a new program, as jit retraces for a new constant), the
        gradients back into `p.grad` where a caller replaced them, the
        optimizer's state bound (bind_state; the first time made)."""
        self.groups = adam_groups(self.optimizer)
        if [id(p) for g in self.groups for p in g[0]] != [id(p) for p in self.params]:
            raise ValueError("the optimizer's parameters changed after make_train_step")
        for p, g in zip(self.params, self.grads):
            if p.grad is not g:
                p.grad = g
        self.state = bind_state(self.optimizer, self.params, self.state)

    def hyperparameters(self) -> tuple:
        """What an update bakes: each group's lr, b1, b2, eps and decay."""
        return tuple(g[1:] for g in self.groups)

    def one_device(self) -> bool:
        """Whether every shard runs on the parameters' device."""
        if self.mesh is None or self.ranked:
            return True
        index = lambda d: (d.type, d.index if d.index is not None or d.type != "cuda"
                           else torch.cuda.current_device())
        return all(index(torch.device(d)) == index(self.device) for d in self.mesh.devices)

    def shard_losses(self, batch):
        """(loss, share of the batch) per shard this process runs, made one
        at a time, so a shard's activations are freed by its backward
        before the next runs."""
        net, mesh = self.net, self.mesh
        if mesh is None:
            yield loss_fn(net, batch), 1.0
            return
        share = 1.0 / mesh_size(mesh)
        if self.ranked:
            yield loss_fn(net, shard_rollouts(mesh, batch)[0]), share
            return
        for dev, shard in zip(mesh.devices, shard_rollouts(mesh, batch)):
            state = {k: v.to(dev) for k, v in (*net.named_parameters(), *net.named_buffers())}
            replica = lambda *inputs: torch.func.functional_call(net, state, inputs)
            yield loss_fn(replica, shard), share

    def grads_of(self, batch: Batch, loss_out: torch.Tensor, clock=None, spent=None):
        """The gradients of the batch's mean scene loss into the gradients
        (this rank's shard, weighted by its share, on a DistMesh), the loss
        into `loss_out` (a float32 [])."""
        clock = clock or (lambda: 0.0)
        torch._foreach_zero_(self.grads)
        total = torch.zeros((), device=self.device)
        t = clock()
        for loss, share in self.shard_losses(batch):
            t_fwd = clock()
            if spent is not None:
                spent["forward"] += t_fwd - t
            (loss * share).backward()
            total = total + loss.detach().to(self.device) * share
            t = clock()
            if spent is not None:
                spent["backward"] += t - t_fwd
        loss_out.copy_(total)

    def all_reduce(self, loss_out: torch.Tensor):
        """The gradients and the loss summed over the ranks (a DistMesh),
        in place, outside any captured program: gloo's sum runs on the
        host."""
        all_reduce_sum(self.mesh, self.grads + [loss_out.reshape(1)])

    def update(self):
        adam_update(self.groups, self.grads, self.state)

    def run(self, batch: Batch, loss_out: torch.Tensor, times: Optional[dict] = None):
        """One step run eagerly on `batch`, its loss into `loss_out`; with a
        dict `times`, the phases' seconds added to it."""
        device = self.device
        clock = (lambda: _sync(device)) if times is not None else None
        spent = {"forward": 0.0, "backward": 0.0} if times is not None else None
        self.grads_of(batch, loss_out, clock, spent)
        t = clock() if clock else 0.0
        if self.ranked:
            self.all_reduce(loss_out)
            if clock:
                t_sum = clock()
                spent["all_reduce"] = t_sum - t
                t = t_sum
        self.update()
        if times is not None:
            spent["optimizer"] = clock() - t
            for k, v in spent.items():
                times[k] = times.get(k, 0.0) + v

    def eager(self, batch: Batch, times: Optional[dict] = None) -> torch.Tensor:
        """One step on the caller's batch, eagerly (the reference of the
        compiled one); returns its loss."""
        self.bind()
        loss = torch.zeros((), device=self.device)
        self.run(batch, loss, times)
        return loss


def make_train_step(net: ScenePredNet, optimizer, mesh=None, graphed: Optional[bool] = None):
    """train_step(batch, times=None) -> loss (a new 0-d tensor each call):
    forward, the mean scene loss, backward, one optimizer step over `net`'s
    parameters. `optimizer` is a torch Adam or AdamW (`adam`, `adamw`); the
    step updates its state in place with optax's formula (adam_update), so
    `optimizer.state_dict()` checkpoints it and load_state_dict restores it.
    N calls make N steps.

    On a CUDA device the step is compiled (`graphed` None or True;
    models/train_program.py): each call copies the batch into static
    buffers and replays one captured CUDA graph of the whole step (two
    around the all-reduce on a DistMesh), with every host synchronization
    an error. `graphed=False` runs the same body eagerly: the reference,
    equal to the compiled step to the bit. On the CPU the body runs eagerly
    on the program's buffers (None), or on the caller's batch (False);
    `graphed=True` raises.

    With a `Mesh`, the batch's leading axis is cut into one shard per device
    (parallel/mesh.py::shard_rollouts); each shard runs on its device with
    the parameters copied there, and its loss, weighted by its share of the
    batch, is back-propagated into the one set of gradients of `net`'s
    parameters, before one optimizer step. The shards run one after another.
    A mesh whose shards are all on the parameters' device is compiled; one
    that spans cards runs eagerly under `graphed=None` (one CUDA graph
    cannot span devices; `graphed=True` raises): across cards, a DistMesh
    is what compiles.

    With a `DistMesh` (one rank of parallel/launch.py; `net` and the whole
    batch on the rank's device), the rank runs forward and backward on its
    own shard with the same weighting, the gradients are summed over the
    ranks (`all_reduce_sum`, between the two programs when compiled)
    before the optimizer step, so every rank keeps the same parameters, and
    the returned loss is the global one.

    Both are the counterpart of mind_tpu/models/train.py::dp_shardings,
    where XLA sums the gradients over the chips.

    With a dict `times`, the step synchronizes the device and adds
    seconds to it: a compiled step its whole time under "step" (a replay
    cannot be cut; a program's first call also captures it), an eager one
    (`graphed=False`, or the CPU) its phases under "forward", "backward",
    "optimizer" and, on a `DistMesh`, "all_reduce" (the gradients' sum over
    the ranks).

    The returned step has `.body` (StepBody) and, on the program path,
    `.program` (train_program.TrainStep: captures, capture seconds and the
    replays counted on the device).
    """
    body = StepBody(net, optimizer, mesh)
    if graphed and body.device.type != "cuda":
        raise ValueError(f"a compiled train step runs on a CUDA device; got {body.device}")
    spans = body.device.type == "cuda" and not body.one_device()
    if graphed and spans:
        raise ValueError("a compiled train step runs on one device; the mesh spans "
                         f"{[str(d) for d in mesh.devices]}")
    program = None
    if graphed is not False and not spans:   # spans: the sequential mesh across cards, eagerly
        from mind_tpu_torch.models.train_program import TrainStep

        program = TrainStep(body)
    run = program or body.eager

    def train_step(batch: Batch, times: Optional[dict] = None):
        return run(batch, times)

    train_step.body, train_step.program = body, program
    return train_step


def _lecun_normal_(t, fan_in: int, gen):
    """flax's lecun_normal: a normal of variance 1 / fan_in truncated at two
    standard deviations (the scale corrected for the truncation)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        t.copy_(torch.nn.init.trunc_normal_(torch.empty(t.shape), 0.0, std, -2 * std, 2 * std,
                                            generator=gen))


def init_scene_pred(cfg: NetConfig, seed: int = 0, device=None) -> ScenePredNet:
    """A float32 ScenePredNet in train mode on `device` (the card unless the
    caller passes a CPU device) with flax's initializer families, drawn on
    the CPU from an explicit generator (the same values on every device):
    lecun-normal for dense and convolution kernels and the fusion core's
    matrices, zeros for biases, ones for normalization scales. Not the JAX
    package's values: the tests carry those across with params_from_flax."""
    device = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.random.fork_rng(devices=[]):   # construction leaves the caller's RNG alone
        net = ScenePredNet(cfg)
    for name, p in net.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() >= 2:
            # torch layout [out, in] / [out, in, k]; the core's own [in, out]
            fan_in = p.shape[0] if leaf.startswith("w_") else int(np.prod(p.shape[1:]))
            _lecun_normal_(p, fan_in, gen)
        elif leaf == "weight" or leaf.endswith("_scale"):
            torch.nn.init.ones_(p)
        else:
            torch.nn.init.zeros_(p)
    return net.to(device).train()


def make_dummy_batch(cfg: NetConfig, batch_size: int, n_actors: int, n_lanes: int,
                     seed: int = 0, device=None) -> Batch:
    """Random inputs and targets from numpy's default_rng(seed), drawn in the
    JAX package's order: the same seed gives the same arrays."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    To = cfg.obs_len - 2
    N = n_actors + n_lanes
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
    ones = lambda *s: torch.ones(s, dtype=torch.bool, device=device)
    return Batch(
        actors=f(batch_size, n_actors, To, cfg.in_actor),
        actor_mask=ones(batch_size, n_actors),
        lanes=f(batch_size, n_lanes, 10, cfg.in_lane),
        lane_mask=ones(batch_size, n_lanes),
        rpe=f(batch_size, N, N, cfg.d_rpe_in),
        tgt_nodes=f(batch_size, 10, cfg.in_lane),
        tgt_rpe=f(batch_size, 20),
        gt_pos=f(batch_size, n_actors, cfg.pred_len, 2),
        gt_mask=ones(batch_size, n_actors, cfg.pred_len),
    )
