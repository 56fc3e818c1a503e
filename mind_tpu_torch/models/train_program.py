"""The train step as a compiled program (the JAX package jits its step:
scripts/train_demo_weights.py's `jax.jit(train_step)`, and
__graft_entry__.py's jit over mind_tpu/models/train.py::dp_shardings).

`TrainStep(body)` runs a models/train.py::StepBody through static buffers:
each call copies the batch in (one `_foreach_copy_` per dtype from the
device, one copy a tensor from the host) and runs the step into a loss
buffer, returning a new tensor holding the loss (a caller may keep every
step's loss on the device).

- On the card the whole step (the gradients zeroed, forward, the scene
  loss, backward through the fusion kernel's Function, adam_update) is one
  CUDA graph captured with `torch.cuda.graph`, which routes the
  allocations of every thread by the capturing stream: backward runs on
  autograd's own device thread. On a DistMesh the step is two graphs, the
  gradients and the update, and the ranks' sum (`all_reduce_sum`, gloo
  runs it on the host) runs between them, outside both. Replays run with
  every host synchronization an error (`graph_control.no_host_sync`).
- On the CPU the same body runs eagerly on the buffers, so that the tests
  hold what is copied in.

A program's first call is its warm-up: the step run eagerly on the
capture's side stream (so that cuBLAS workspaces and allocator caches exist
outside the pool), which is that call's step; then the capture, which
runs nothing. Every later call replays. N calls make N steps.

What a capture bakes is its key: the batch's shapes and dtypes, cuDNN's
and TF32's settings (the convolutions' algorithm is chosen at the
capture), the groups' hyperparameters, the parameters' addresses. A new
key is a new program: its own buffers and graphs, its own warm-up. The
gradients, the optimizer's state, the buffers and the loss are allocated
before any capture, outside the graphs' pool, graph_control.shared_pool:
the planner's programs and these replay one at a time on the caller's
stream, and none keeps a tensor alive in it. The warm-ups and captures run
on graph_control's capture stream. A load_state_dict of the optimizer
puts new state tensors in place; StepBody.bind copies them into the ones
the graphs address.
`replays` counts on the device the steps the graphs ran (the warm-ups
not), so a kernel the step launches runs layers x replays times in them.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from mind_tpu_torch.models.train import Batch, StepBody, _sync
from mind_tpu_torch.ops import graph_control
from mind_tpu_torch.planner.programs import _buffers, copy_in

class _Program:
    """One key's static batch buffers, loss, replay counter and graphs
    (None before the first call and on the CPU)."""

    def __init__(self, batch: Batch, device: torch.device):
        self.inputs = _buffers(batch, device, frozenset())
        self.loss = torch.zeros((), dtype=torch.float32, device=device)
        self.replays = torch.zeros((), dtype=torch.long, device=device)
        self.graphs = None
        self.capture_s = None
        self.capture_reserved = None   # bytes the capture added to the device's reserve


class TrainStep:
    """make_train_step's program path (module docstring): `programs` by
    key, `replays()` the steps replayed over all of them (a host read),
    `capture_s()` their capture seconds in the order captured."""

    def __init__(self, body: StepBody):
        self.body = body
        self.device = body.device   # a CUDA tensor's device has its index
        self.programs: dict = {}

    def _key(self, batch: Batch) -> tuple:
        b = torch.backends
        return (tuple((tuple(t.shape), t.dtype) for t in graph_control.tensors(batch)),
                b.cudnn.deterministic, b.cudnn.benchmark, b.cudnn.allow_tf32,
                b.cuda.matmul.allow_tf32, self.body.hyperparameters(),
                tuple(p.data_ptr() for p in self.body.params))

    def replays(self) -> int:
        return sum(int(p.replays) for p in self.programs.values())

    def capture_s(self) -> list:
        return [p.capture_s for p in self.programs.values() if p.capture_s is not None]

    def __call__(self, batch: Batch, times: Optional[dict] = None) -> torch.Tensor:
        body = self.body
        body.bind()
        key = self._key(batch)
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = _Program(batch, self.device)
        if self.device.type != "cuda":
            copy_in(prog.inputs, batch)
            body.run(prog.inputs, prog.loss, times)
            return prog.loss.clone()
        t = _sync(self.device) if times is not None else 0.0
        with torch.cuda.device(self.device):
            copy_in(prog.inputs, batch)
            if prog.graphs is None:
                self._warm_up_and_capture(prog)
            else:
                with graph_control.no_host_sync():
                    prog.graphs[0].replay()
                if body.ranked:
                    body.all_reduce(prog.loss)
                    with graph_control.no_host_sync():
                        prog.graphs[1].replay()
            loss = prog.loss.clone()
        if times is not None:
            times["step"] = times.get("step", 0.0) + _sync(self.device) - t
        return loss

    def _warm_up_and_capture(self, prog: _Program):
        """The step eagerly on the side stream (this call's step), then its
        capture (which runs nothing). A capture that fails raises."""
        body, dev = self.body, self.device
        caller, side = torch.cuda.current_stream(dev), graph_control._stream(dev, 0)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            body.grads_of(prog.inputs, prog.loss)
        if body.ranked:
            caller.wait_stream(side)
            body.all_reduce(prog.loss)
            side.wait_stream(caller)
        with torch.cuda.stream(side):
            body.update()
        caller.wait_stream(side)

        def grads():
            body.grads_of(prog.inputs, prog.loss)
            prog.replays.add_(1)

        def whole():
            grads()
            body.update()

        t = time.perf_counter()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()   # as torch.cuda.graph does: the reserve below is the pool's
        reserved = torch.cuda.memory_reserved(dev)
        parts = (grads, body.update) if body.ranked else (whole,)
        pool, graphs = graph_control.shared_pool(dev).id, []
        for fn in parts:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool, stream=side):
                fn()
            graphs.append(g)
        prog.graphs = graphs
        prog.capture_s = time.perf_counter() - t
        prog.capture_reserved = torch.cuda.memory_reserved(dev) - reserved
