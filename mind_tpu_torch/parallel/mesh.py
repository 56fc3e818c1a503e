"""Device meshes and sharding (port of mind_tpu/parallel/mesh.py).

The JAX package's mesh is a `jax.sharding.Mesh` with one 'data' axis, and
XLA places each shard. Here a mesh is the 1-D list of torch devices that
axis names; `shard_rollouts` cuts the leading axis into one contiguous
shard per device and `replicate` copies to each, and the callers run each
shard on its device. A mesh may name one device more than once (the CPU
tests use such a mesh).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch


class Mesh(NamedTuple):
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)


def make_mesh(n_devices: Optional[int] = None, device=None,
              axis_names: Sequence[str] = ("data",)) -> Mesh:
    """1-D mesh over the first n_devices CUDA cards (default: all), or, with
    `device`, over that one device named n_devices times (default once)."""
    if device is not None:
        devs = (torch.device(device),) * (n_devices or 1)
    else:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n < 1 or n > count:
            raise RuntimeError(f"a mesh of {n} CUDA devices, {count} present: pass device='cpu' "
                               "for a CPU mesh")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    return Mesh(devs, tuple(axis_names))


def tree_map(fn, tree):
    """`fn` applied to every tensor leaf of nested (named) tuples; other
    leaves stay."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        out = [tree_map(fn, x) for x in tree]
        return tuple(out) if type(tree) is tuple else type(tree)(*out)
    return tree


def shard_rollouts(mesh: Mesh, tree):
    """One shard per device: the leading (batch) axis of every tensor leaf
    cut into len(mesh.devices) contiguous equal parts, part i on device i.
    Returns a list of trees."""
    n = len(mesh.devices)
    out = []
    for i, d in enumerate(mesh.devices):
        def part(x):
            if x.shape[0] % n:
                raise ValueError(f"a leading axis of {x.shape[0]} does not divide over {n} devices")
            k = x.shape[0] // n
            return x[i * k:(i + 1) * k].to(d)
        out.append(tree_map(part, tree))
    return out


def replicate(mesh: Mesh, tree):
    """A copy of every tensor leaf on each device; a list of trees."""
    return [tree_map(lambda x: x.to(d), tree) for d in mesh.devices]
