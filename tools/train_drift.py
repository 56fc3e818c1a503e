"""How far two trainings of a narrow network part over some steps, and
why: the port's train step (mind_tpu_torch/models/train.py::make_train_step,
its program path on the CPU) against jax.jit of mind_tpu's train_step,
from the same seeded parameters and batch (the network and batch of
tests/test_torch_train.py). Runs on the CPU; imports both packages.

    python tools/train_drift.py [--opt adamw] [--lr 1e-3] [--seed 1] [--steps 20]

Per step it prints the loss's relative difference from JAX's trajectory of

- port:  the port's step (adam_update, optax's formula on tensors);
- torch: the port's forward and backward with torch.optim's own step;
- self:  JAX itself, from parameters moved by one float32 ulp each;

and, as the relative norm of the parameters apart (the shift-invariant
biases of models/train.py::shift_invariant_params left out),

- same_grads: adam_update and torch.optim against optax, all three fed
  the same gradients (JAX's, along its own trajectory).

Where `same_grads` stays at rounding level and `self` parts as far as
`port`, the two trainings part because the trajectory magnifies rounding,
not because the updates differ.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

TINY = dict(n_scene_layer=2, n_fpn_scale=2, d_actor=32, d_lane=32, d_embed=32, d_rpe=32,
            n_scene_head=4, pred_len=12)
A, L, B = 4, 8, 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--opt", default="adamw", choices=("adam", "adamw"))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=1, help="the batch's seed")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)

    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(ROOT))
    import jax
    import jax.numpy as jnp
    import optax
    import torch
    from flax.traverse_util import flatten_dict

    jax.config.update("jax_platforms", "cpu")
    from mind_tpu.config import NetConfig
    from mind_tpu.models import init_scene_pred
    from mind_tpu.models.train import make_dummy_batch, make_train_step, scene_loss
    from mind_tpu_torch.config import NetConfig as TNetConfig
    from mind_tpu_torch.models import train as tt
    from mind_tpu_torch.models.weights import load_scene_pred, params_from_flax

    torch.set_num_threads(2)
    K, lr = args.steps, args.lr
    jcfg = NetConfig(**TINY, use_pallas_fusion=False)
    _, params0, _ = init_scene_pred(jcfg, A, L, seed=0)
    jbatch = make_dummy_batch(jcfg, B, A, L, seed=args.seed)
    joptimizer = getattr(optax, args.opt)(lr)
    model, jstep = make_train_step(jcfg, joptimizer)
    jstep = jax.jit(jstep)

    def jloss(params):
        def one(a, am, l, lm, r, tn, tr, gp, gm):
            cls_prob, reg, _ = model.apply(params, a, am, l, lm, r, tn, tr)
            return scene_loss(cls_prob, reg, gp, gm)
        return jnp.mean(jax.vmap(one)(*jbatch))

    jgrad = jax.jit(jax.grad(jloss))
    to_port = lambda tree: params_from_flax(
        {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()})

    def jax_run(params):
        state, losses, grads = joptimizer.init(params), [], []
        for _ in range(K):
            grads.append(jgrad(params))
            params, state, loss = jstep(params, state, jbatch)
            losses.append(float(loss))
        return losses, grads

    want, jtrees = jax_run(params0)
    jgrads = [to_port(g) for g in jtrees]
    rng = np.random.default_rng(0)
    ulp = lambda x: x * (1 + np.float32(2 ** -23)
                         * rng.choice([-1, 1], size=x.shape).astype(np.float32))
    self_losses, _ = jax_run(jax.tree.map(ulp, params0))

    batch = tt.Batch(*(torch.from_numpy(np.array(x)) for x in jbatch))
    state0 = to_port(params0)

    def port_net():
        net = load_scene_pred(TNetConfig(**TINY), None, torch.device("cpu"))
        net.load_state_dict(state0, strict=True)
        return net.train()

    def port_run(torch_step: bool):
        net = port_net()
        opt = getattr(tt, args.opt)(net.parameters(), lr)
        step = tt.make_train_step(net, opt)
        losses = []
        for _ in range(K):
            if torch_step:
                opt.zero_grad(set_to_none=True)
                loss = tt.loss_fn(net, batch)
                loss.backward()
                for p in net.parameters():
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                opt.step()
            else:
                loss = step(batch)
            losses.append(float(loss.detach()))
        return losses

    port, torch_losses = port_run(False), port_run(True)

    # the same gradients (JAX's) through optax, adam_update and torch.optim
    noise = set(tt.shift_invariant_params(TNetConfig(**TINY)))
    names = [k for k, _ in port_net().named_parameters()]
    jp, jstate = params0, joptimizer.init(params0)
    nets = (port_net(), port_net())
    opts = [getattr(tt, args.opt)(n.parameters(), lr) for n in nets]
    groups = tt.adam_groups(opts[0])
    held = tt.bind_state(opts[0], [p for g in groups for p in g[0]])
    same = []
    for i in range(K):
        upd, jstate = joptimizer.update(jtrees[i], jstate, jp)   # optax, eagerly
        jp = optax.apply_updates(jp, upd)
        tt.adam_update(groups, [jgrads[i][k] for k in names], held)
        for k, p in nets[1].named_parameters():
            p.grad = jgrads[i][k].clone()
        opts[1].step()
        ref = to_port(jp)
        kept = [k for k in names if k not in noise]
        dist = []
        for n in nets:
            got = dict(n.named_parameters())
            d = sum(float(((got[k].detach().double() - ref[k].double()) ** 2).sum()) for k in kept)
            s = sum(float((ref[k].double() ** 2).sum()) for k in kept)
            dist.append((d / s) ** 0.5)
        same.append(dist)

    print(f"{args.opt} lr={lr} batch seed={args.seed}")
    print("step  port      torch     self      same_grads(adam_update)  same_grads(torch.optim)")
    rel = lambda a, b: abs(a - b) / abs(b)
    for i in range(K):
        print(f"{i + 1:4d}  {rel(port[i], want[i]):.2e}  {rel(torch_losses[i], want[i]):.2e}  "
              f"{rel(self_losses[i], want[i]):.2e}  {same[i][0]:.2e}                 "
              f"{same[i][1]:.2e}")


if __name__ == "__main__":
    main()
