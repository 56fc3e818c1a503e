"""Device meshes and sharding (port of mind_tpu/parallel/mesh.py).

The JAX package's mesh is a `jax.sharding.Mesh` with one 'data' axis, and
XLA places each shard and runs the shards at the same time. The port has
two meshes over that axis:

- `Mesh` (`make_mesh`): the 1-D tuple of torch devices the axis names, in
  one process. `shard_rollouts` cuts the leading axis into one contiguous
  shard per device and `replicate` copies to each; the callers run the
  shards one after another. A mesh may name one device more than once (the
  CPU tests use such a mesh).
- `DistMesh`: one rank's view of a mesh whose shards run at the same time,
  one process per shard under torch.distributed (`parallel/launch.py`
  starts the ranks). `shard_rollouts` gives the rank its own shard, cut as
  `Mesh` cuts it, `replicate` gives the caller's tree back uncopied, and
  `gather_shards` returns the whole leading axis on every rank, as a JAX
  global array reads whole.

Callers hold both the same way: `shard_rollouts` and `replicate` return the
shards THIS process runs (every shard in one process; one on a rank), and
`gather_shards` takes one result per such shard and returns all of them in
shard order.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch


class Mesh(NamedTuple):
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)


class DistMesh(NamedTuple):
    """This process's rank of `world_size`, its device and the process
    group the shards' collectives run in (`backend` its backend)."""

    rank: int
    world_size: int
    device: torch.device
    group: Any
    backend: str
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


def mesh_size(mesh) -> int:
    """The number of shards of the mesh's axis."""
    return mesh.world_size if isinstance(mesh, DistMesh) else len(mesh.devices)


def local_shards(mesh) -> List[Tuple[int, torch.device]]:
    """(shard index, device) of each shard this process runs, in order."""
    if isinstance(mesh, DistMesh):
        return [(mesh.rank, mesh.device)]
    return list(enumerate(mesh.devices))


def tree_map(fn, tree):
    """`fn` applied to every tensor leaf of nested (named) tuples; other
    leaves stay."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        out = [tree_map(fn, x) for x in tree]
        return tuple(out) if type(tree) is tuple else type(tree)(*out)
    return tree


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _leaves(x)]
    return []


def _rebuild(tree, leaves):
    """`tree` with its tensor leaves taken in order from the iterator."""
    return tree_map(lambda _: next(leaves), tree)


def shard_rollouts(mesh, tree) -> list:
    """The shards this process runs: the leading (batch) axis of every
    tensor leaf cut into mesh_size(mesh) contiguous equal parts, part i on
    the device of shard i. A list of trees: one per device of a `Mesh`, the
    rank's own one of a `DistMesh`."""
    n = mesh_size(mesh)
    out = []
    for i, d in local_shards(mesh):
        def part(x):
            if x.shape[0] % n:
                raise ValueError(f"a leading axis of {x.shape[0]} does not divide over {n} devices")
            k = x.shape[0] // n
            return x[i * k:(i + 1) * k].to(d)
        out.append(tree_map(part, tree))
    return out


def replicate(mesh, tree) -> list:
    """The tree once per shard this process runs: a copy on each device of
    a `Mesh`; on a `DistMesh`, the caller's tree itself (a no-op: each rank
    holds its own)."""
    if isinstance(mesh, DistMesh):
        return [tree]
    return [tree_map(lambda x: x.to(d), tree) for d in mesh.devices]


def gather_shards(mesh, parts: list):
    """The whole leading axis, in shard order, from one part per shard this
    process runs (as `shard_rollouts` orders them). A part is a tree of
    tensors (leaves concatenated along dim 0, onto the mesh's first device
    or the rank's device) or a list of objects (concatenated). On a
    `DistMesh` every rank gets the whole: tensors travel as host copies
    under gloo and on the card under nccl; lists as pickles."""
    if len(parts) != len(local_shards(mesh)):
        raise ValueError(f"{len(parts)} parts for {len(local_shards(mesh))} shards")
    if isinstance(mesh, DistMesh):
        import torch.distributed as dist

        if isinstance(parts[0], list):
            got = [None] * mesh.world_size
            dist.all_gather_object(got, parts[0], group=mesh.group)
            return [x for part in got for x in part]
        mine = _leaves(parts[0])
        if mesh.backend != "nccl":
            mine = [t.cpu() for t in mine]
        whole = []
        for t in mine:
            got = [torch.empty_like(t) for _ in range(mesh.world_size)]
            dist.all_gather(got, t.contiguous(), group=mesh.group)
            whole.append(torch.cat(got).to(mesh.device))
        return _rebuild(parts[0], iter(whole))
    if isinstance(parts[0], list):
        return [x for part in parts for x in part]
    first = mesh.devices[0]
    cols = zip(*(_leaves(p) for p in parts))
    return _rebuild(parts[0], iter([torch.cat([t.to(first) for t in col]) for col in cols]))


def all_reduce_sum(mesh: DistMesh, tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place, in one collective over one
    flat buffer (of the tensors' common dtype): on the card under nccl, as
    a host copy under gloo. Every rank gets the same bits."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    buf = flat if mesh.backend == "nccl" else flat.cpu()
    dist.all_reduce(buf, group=mesh.group)
    flat = buf.to(flat.device)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def rank0_decides(mesh, flag: bool) -> bool:
    """Rank 0's `flag` on every rank of a `DistMesh` (a decision that ends a
    loop of collectives must be the same on all ranks); the flag itself on
    any other mesh."""
    if not isinstance(mesh, DistMesh):
        return bool(flag)
    import torch.distributed as dist

    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=dev)
    dist.broadcast(t, src=0, group=mesh.group)
    return bool(t.item())
