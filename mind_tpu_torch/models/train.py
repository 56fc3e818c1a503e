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
default weight decay is 1e-4 and torch's 1e-2. optax updates every leaf,
a parameter the loss does not reach included (zero gradient: its moments
decay, and AdamW's decay applies), where torch skips a parameter without a
gradient; the train step gives such parameters a zero gradient, so both
update the same set.
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


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def make_train_step(net: ScenePredNet, optimizer, mesh=None):
    """train_step(batch, times=None) -> loss (a 0-d tensor): forward, the
    mean scene loss, backward, one optimizer step over `net`'s parameters.

    With a `Mesh`, the batch's leading axis is cut into one shard per device
    (parallel/mesh.py::shard_rollouts); each shard runs on its device with
    the parameters copied there, and its loss, weighted by its share of the
    batch, is back-propagated into the one set of gradients of `net`'s
    parameters, before one optimizer step. The shards run one after another.

    With a `DistMesh` (one rank of parallel/launch.py; `net` and the whole
    batch on the rank's device), the rank runs forward and backward on its
    own shard with the same weighting, the gradients are summed over the
    ranks (`all_reduce_sum`) before the optimizer step, so every rank keeps
    the same parameters, and the returned loss is the global one.

    Both are the counterpart of mind_tpu/models/train.py::dp_shardings,
    where XLA sums the gradients over the chips.

    With a dict `times`, the step synchronizes the device between its
    phases and adds their seconds under "forward", "backward", "optimizer"
    and, on a `DistMesh`, "all_reduce" (the gradients' sum over the ranks).
    """
    if net.cfg.compute_dtype != "float32":
        raise ValueError("only the float32 network is trained (as in the JAX package)")
    params = [p for p in net.parameters() if p.requires_grad]
    device = params[0].device
    ranked = isinstance(mesh, DistMesh)

    def shard_losses(batch):
        """(loss, share of the batch) per shard this process runs, made one
        at a time, so a shard's activations are freed by its backward
        before the next runs."""
        if mesh is None:
            yield loss_fn(net, batch), 1.0
            return
        share = 1.0 / mesh_size(mesh)
        if ranked:
            yield loss_fn(net, shard_rollouts(mesh, batch)[0]), share
            return
        for dev, shard in zip(mesh.devices, shard_rollouts(mesh, batch)):
            state = {k: v.to(dev) for k, v in (*net.named_parameters(), *net.named_buffers())}
            replica = lambda *inputs: torch.func.functional_call(net, state, inputs)
            yield loss_fn(replica, shard), share

    def train_step(batch: Batch, times: Optional[dict] = None):
        clock = (lambda: _sync(device)) if times is not None else (lambda: 0.0)
        spent = {"forward": 0.0, "backward": 0.0}
        optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), device=device)
        t = clock()
        for loss, share in shard_losses(batch):
            t_fwd = clock()
            spent["forward"] += t_fwd - t
            (loss * share).backward()
            total = total + loss.detach().to(device) * share
            t = clock()
            spent["backward"] += t - t_fwd
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if ranked:
            total = total.reshape(1)
            all_reduce_sum(mesh, [p.grad for p in params] + [total])
            total = total[0]
            t_sum = clock()
            spent["all_reduce"] = t_sum - t
            t = t_sum
        optimizer.step()
        if times is not None:
            spent["optimizer"] = clock() - t
            for k, v in spent.items():
                times[k] = times.get(k, 0.0) + v
        return total

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
