"""Start the ranks of a distributed mesh: one process per shard under
torch.distributed, each running one function given by module path (the
counterpart of the JAX package's mesh, where XLA runs every device's shard
at the same time).

    from mind_tpu_torch.parallel.launch import launch
    results = launch("mind_tpu_torch.parallel.dryrun:train", 2, args=(...), device="cpu")

Each rank calls `fn(mesh, *args, **kwargs)` with its
`parallel.mesh.DistMesh` and returns a picklable result (host objects:
numpy arrays, CPU tensors); `launch` returns the results in rank order.

- Rendezvous: a FileStore in a temporary directory (no TCP port).
- Devices: rank r runs on card r // ranks_per_card after
  torch.cuda.set_device, or on the CPU when the caller passes
  device="cpu". Without a card and without device="cpu", `launch` raises.
- Backend (a rule, not a fallback): nccl when every rank has a card of its
  own; gloo on the CPU and when ranks share a card (NCCL refuses two ranks
  on one device). Asking for nccl where it cannot run raises.
- Failures: a rank that raises makes `launch` raise with that rank's
  traceback, and the other ranks are ended, so none is left waiting in a
  collective; a world that outlives `timeout` is ended and raises. No
  partial result is ever returned.
- Threads: each CPU rank runs torch.set_num_threads(rank_threads(nproc)),
  its share of the caller's threads.
- Kernels: with cards, the fusion kernels are compiled once in the caller
  before the ranks start (nvcc only: the caller creates no CUDA context),
  so the ranks load them and do not race to build them.
"""

from __future__ import annotations

import importlib
import os
import pickle
import sys
import tempfile
import time
from datetime import timedelta
from typing import NamedTuple, Optional, Sequence

import torch

_BACKENDS = ("gloo", "nccl")


class _Spec(NamedTuple):
    target: str
    nproc: int
    device: str            # "cpu" or "cuda"
    ranks_per_card: int
    backend: str
    threads: int
    workdir: str
    timeout: float
    args: tuple
    kwargs: dict
    rank_kwargs: Optional[Sequence[dict]]


def rank_threads(nproc: int) -> int:
    """The CPU threads each of `nproc` CPU ranks runs: its share of this
    process's torch threads, at least one."""
    return max(1, torch.get_num_threads() // nproc)


def choose_backend(device: str, ranks_per_card: int, backend: Optional[str] = None) -> str:
    """The backend rule: nccl when every rank has a card of its own, gloo
    on the CPU and when ranks share a card. An explicit `backend` is
    checked against the rule, never replaced."""
    rule = "nccl" if device == "cuda" and ranks_per_card == 1 else "gloo"
    if backend is None:
        return rule
    if backend not in _BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {_BACKENDS}")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("nccl runs on CUDA cards only; the CPU ranks take gloo")
        if ranks_per_card != 1:
            raise ValueError(f"nccl takes one rank per card, got {ranks_per_card} per card")
        if not torch.distributed.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL backend")
    return backend


def launch(target: str, nproc: int, args: tuple = (), kwargs: Optional[dict] = None, *,
           device: Optional[str] = None, ranks_per_card: int = 1,
           backend: Optional[str] = None, timeout: float = 600.0,
           rank_kwargs: Optional[Sequence[dict]] = None) -> list:
    """Run `target` ("package.module:function") on `nproc` ranks of one
    world and return each rank's result, in rank order. `rank_kwargs`, one
    dict per rank, adds keyword arguments of that rank alone. Raises with
    the failing rank's traceback if any rank raises, and TimeoutError if
    the world is not done within `timeout` seconds."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    if nproc < 1 or ranks_per_card < 1:
        raise ValueError(f"nproc {nproc} and ranks_per_card {ranks_per_card} must be >= 1")
    if rank_kwargs is not None and len(rank_kwargs) != nproc:
        raise ValueError(f"{len(rank_kwargs)} rank_kwargs for {nproc} ranks")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
        device = "cuda"
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: 'cpu' or 'cuda'")
    backend = choose_backend(device, ranks_per_card, backend)
    if device == "cuda":
        cards = -(-nproc // ranks_per_card)
        if cards > torch.cuda.device_count():
            raise RuntimeError(f"{nproc} ranks at {ranks_per_card} per card need {cards} cards, "
                               f"{torch.cuda.device_count()} present")
        from mind_tpu_torch.ops.fusion_attention import compile_kernels

        compile_kernels()
    module, _, name = target.partition(":")
    if not module or not name:
        raise ValueError(f"target {target!r}: 'package.module:function'")
    main = getattr(sys.modules["__main__"], "__file__", None)
    if main is not None and not os.path.exists(main):
        raise RuntimeError(f"the ranks re-import the caller's main module, which is not a file "
                           f"({main}): run the caller as a script or a module")
    with tempfile.TemporaryDirectory(prefix="mind_dist_") as workdir:
        spec = _Spec(target, nproc, device, ranks_per_card, backend, rank_threads(nproc),
                     workdir, timeout, tuple(args), dict(kwargs or {}), rank_kwargs)
        # the ranks read the spec from a file: a start pipe that carried it
        # would block this process on a rank that died before reading it all
        with open(_spec_path(workdir), "wb") as f:
            pickle.dump(spec, f)
        ctx = mp.start_processes(_rank_main, args=(workdir,), nprocs=nproc, join=False,
                                 start_method="spawn")
        end = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, end - time.monotonic()), grace_period=2.0):
                if time.monotonic() >= end:
                    raise TimeoutError(f"{target} on {nproc} ranks: not done within {timeout} s")
        except ProcessException as e:
            raise RuntimeError(_failures(target, ctx, e)) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            for path in ctx.error_files:
                if os.path.exists(path):
                    os.unlink(path)
        out = []
        for r in range(nproc):
            with open(_result_path(workdir, r), "rb") as f:
                out.append(pickle.load(f))
        return out


def _failures(target: str, ctx, first) -> str:
    """Every failed rank's traceback (the first to end and any that failed
    after it, waiting on it), in rank order."""
    out = []
    for r, path in enumerate(ctx.error_files):
        if os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb") as f:
                out.append(f"rank {r} failed:\n{pickle.load(f)}")
    return f"{target}: " + ("\n".join(out) or f"rank {first.error_index} failed: {first}")


def _spec_path(workdir: str) -> str:
    return os.path.join(workdir, "spec.pkl")


def _result_path(workdir: str, rank: int) -> str:
    return os.path.join(workdir, f"rank{rank}.pkl")


def _rank_main(rank: int, workdir: str) -> None:
    """One rank: its device first, then the process group, then the target;
    its result is pickled for the caller. A raise ends the rank at once (no
    teardown that could wait on a failed peer)."""
    import torch.distributed as dist

    from mind_tpu_torch.common.device import resolve_device
    from mind_tpu_torch.parallel.mesh import DistMesh

    with open(_spec_path(workdir), "rb") as f:
        spec = pickle.load(f)

    if spec.device == "cuda":
        index = rank // spec.ranks_per_card
        torch.cuda.set_device(index)
        device = resolve_device(torch.device("cuda", index))
    else:
        torch.set_num_threads(spec.threads)
        device = torch.device("cpu")
    store = dist.FileStore(os.path.join(spec.workdir, "store"), spec.nproc)
    dist.init_process_group(spec.backend, store=store, rank=rank, world_size=spec.nproc,
                            timeout=timedelta(seconds=spec.timeout))
    module, _, name = spec.target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    mesh = DistMesh(rank, spec.nproc, device, dist.group.WORLD, spec.backend)
    kwargs = dict(spec.kwargs, **(spec.rank_kwargs[rank] if spec.rank_kwargs else {}))
    result = fn(mesh, *spec.args, **kwargs)
    tmp = _result_path(spec.workdir, rank) + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, _result_path(spec.workdir, rank))
    dist.destroy_process_group()
