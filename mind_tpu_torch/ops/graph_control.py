"""Device-side loops and branches in captured CUDA graphs.

The JAX package keeps its control flow on the device: the tree iLQR is a
`lax.while_loop` (mind_tpu/planner/ilqr.py), AIME skips an empty round
with a `lax.cond` (mind_tpu/planner/aime_device.py) and the episode program
plans under a `lax.cond` on the enable tick (mind_tpu/sim/episode.py); on a
GPU, XLA lowers both into conditional nodes of a CUDA graph. This module is
their counterpart in the port, two primitives written once for two modes:

- eager (nothing is being captured on this thread: the CPU, or the card
  outside a program): `device_while(pred_fn, body_fn)` is a Python while
  with one host read of `pred_fn().any()` per test, `device_if(pred,
  body_fn)` an if with one host read of `pred.any()`;
- captured (inside `GraphProgram`'s capture): each adds a WHILE or IF node
  to the graph, whose condition the hand-written kernel in
  `csrc/graph_control.cu` sets on the device to `any(mask)` (before the
  node, and for a WHILE again at the end of its body), with no host read.
  The body is captured into the node's body graph on a stream of its own
  for each nesting depth.

A body returns nothing: it writes its results into tensors that exist
before the node. What a captured body allocates lives in the program's
memory pool and is scratch of that body.

`GraphProgram(fn, device)` runs fn once eagerly with every body run once on
the streams the capture uses (so that cuBLAS workspaces and allocator caches
exist before the capture; results of that run are scratch), then captures
fn whole with all its allocations in one memory pool per device
(`torch.cuda.MemPool`), shared by every program of the device: programs run
one at a time on the caller's stream, and none keeps a tensor of its own
alive in the pool. Tensors that live across replays (a program's inputs,
state and outputs) are allocated before the capture, outside the pool.

The library is built by nvcc with the fusion kernels
(`fusion_attention.compile_kernels`) and loaded with ctypes. Conditional
nodes need CUDA 12.4 or later in the toolkit and in the driver: `load`
raises with the versions it found, and nothing falls back to host reads.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable, Optional

import torch

IF, WHILE = 0, 1
MIN_CUDA = 12040   # conditional graph nodes (cudaGraphConditionalHandleCreate and their bodies)

_lib = None
_lock = threading.Lock()
_active = threading.local()   # .program: the _Recording of this thread, or absent
_STREAMS: dict = {}           # (device index, depth) -> torch.cuda.Stream
_POOLS: dict = {}             # device index -> torch.cuda.MemPool


def load() -> ctypes.CDLL:
    """Build (fusion_attention.compile_kernels) and load the library, and
    check that the runtime and the driver take conditional nodes; raises
    otherwise."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from mind_tpu_torch.ops.fusion_attention import compile_kernels

        lib = ctypes.CDLL(str(compile_kernels()["graph_control"]))
        ptr, i32, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
        sigs = {
            "gc_versions": [ctypes.POINTER(i32), ctypes.POINTER(i32)],
            "gc_set_conditional_any": [u64, ptr, i32, ptr, ptr],
            "gc_begin_capture": [ptr],
            "gc_end_capture": [ptr, ctypes.POINTER(ptr)],
            "gc_instantiate": [ptr, ctypes.POINTER(ptr)],
            "gc_launch": [ptr, ptr],
            "gc_destroy": [ptr, ptr],
            "gc_handle_create": [ptr, ctypes.POINTER(u64)],
            "gc_add_conditional": [ptr, u64, i32, ctypes.POINTER(ptr)],
            "gc_begin_body": [ptr, ptr],
            "gc_end_body": [ptr],
            "gc_dot_print": [ptr, ctypes.c_char_p],
        }
        for name, args in sigs.items():
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i32
        lib.gc_error_string.argtypes = [i32]
        lib.gc_error_string.restype = ctypes.c_char_p
        rt, drv = i32(), i32()
        _check(lib, lib.gc_versions(ctypes.byref(rt), ctypes.byref(drv)), "cudaRuntimeGetVersion")
        if rt.value < MIN_CUDA or drv.value < MIN_CUDA:
            raise RuntimeError(f"conditional graph nodes need CUDA >= {MIN_CUDA}; the runtime is "
                               f"{rt.value}, the driver {drv.value}")
        load.versions = {"runtime": rt.value, "driver": drv.value}
        _lib = lib
        return lib


load.versions = None


def _check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({lib.gc_error_string(err).decode()})")


def set_conditional_any_ref(mask: torch.Tensor) -> torch.Tensor:
    """Plain version of the condition kernel: any(mask), a bool tensor []."""
    return mask.any()


def set_conditional_any(handle: int, mask: torch.Tensor, executions: Optional[torch.Tensor]):
    """Launch the condition kernel on the current (capturing) stream: set
    the conditional `handle` to any(mask) on the device, adding one to the
    int64 counter `executions` (None: no counter). A CPU mask has no graph
    and raises; the eager primitives use `set_conditional_any_ref`."""
    if mask.device.type != "cuda":
        raise ValueError(f"a graph conditional is set on the card, the mask is on {mask.device}")
    if mask.dtype != torch.bool:
        raise TypeError(f"the mask has dtype {mask.dtype}, expected torch.bool")
    if executions is not None and (executions.dtype != torch.int64
                                   or executions.device != mask.device):
        raise ValueError("executions must be an int64 tensor on the mask's device")
    lib = load()
    m = mask.reshape(-1)
    if not m.is_contiguous():
        m = m.contiguous()
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    _check(lib, lib.gc_set_conditional_any(handle, m.data_ptr(), m.numel(),
                                           None if executions is None else executions.data_ptr(),
                                           stream), "set_conditional_any launch")
    set_conditional_any.launches += 1


set_conditional_any.launches = 0   # launches of the condition kernel (captures included)


class _Recording:
    """A program's warm-up (capturing False) or capture on this thread."""

    def __init__(self, device: torch.device, executions: torch.Tensor, capturing: bool):
        self.device, self.executions, self.capturing = device, executions, capturing
        self.depth = 0
        self.bodies = []   # body graphs of the conditional nodes (raw handles)

    def run_body(self, body_fn: Callable[[], None], after: Optional[Callable[[], None]] = None):
        """Warm-up: body_fn (then `after`) once, on the next depth's stream."""
        outer = torch.cuda.current_stream(self.device)
        s = _stream(self.device, self.depth + 1)
        s.wait_stream(outer)
        self.depth += 1
        try:
            with torch.cuda.stream(s):
                body_fn()
                if after is not None:
                    after()
        finally:
            self.depth -= 1
        outer.wait_stream(s)

    def node(self, kind: int, mask: torch.Tensor, body_fn: Callable[[], None],
             pred_fn: Optional[Callable[[], torch.Tensor]] = None):
        """Capture: the condition kernel on `mask`, a conditional node of
        `kind`, and body_fn (then, for a WHILE, the condition kernel on
        pred_fn()) into its body graph."""
        lib = load()
        outer = torch.cuda.current_stream(self.device).cuda_stream
        handle = ctypes.c_ulonglong()
        _check(lib, lib.gc_handle_create(outer, ctypes.byref(handle)), "cudaGraphConditionalHandleCreate")
        set_conditional_any(handle.value, mask, self.executions)
        body = ctypes.c_void_p()
        _check(lib, lib.gc_add_conditional(outer, handle.value, kind, ctypes.byref(body)),
               "cudaGraphAddNode (conditional)")
        self.bodies.append(body.value)
        s = _stream(self.device, self.depth + 1)
        _check(lib, lib.gc_begin_body(s.cuda_stream, body), "cudaStreamBeginCaptureToGraph")
        self.depth += 1
        try:
            with torch.cuda.stream(s):
                body_fn()
                if kind == WHILE:
                    set_conditional_any(handle.value, pred_fn(), self.executions)
        finally:
            self.depth -= 1
            err = lib.gc_end_body(s.cuda_stream)
        _check(lib, err, "cudaStreamEndCapture (conditional body)")


def _recording() -> Optional[_Recording]:
    return getattr(_active, "program", None)


def capturing() -> bool:
    """Whether this thread is warming up or capturing a GraphProgram (the
    primitives then build a program instead of running eagerly)."""
    return _recording() is not None


@contextlib.contextmanager
def _recorded(rec: _Recording):
    if _recording() is not None:
        raise RuntimeError("a GraphProgram is already being recorded on this thread")
    _active.program = rec
    try:
        yield rec
    finally:
        _active.program = None


def device_while(pred_fn: Callable[[], torch.Tensor], body_fn: Callable[[], None]):
    """while any(pred_fn()): body_fn(). Eagerly one host read per test;
    inside a capture a WHILE node (the counterpart of lax.while_loop)."""
    rec = _recording()
    if rec is None:
        while bool(set_conditional_any_ref(pred_fn())):   # one host read per test
            body_fn()
    elif not rec.capturing:
        pred_fn()
        rec.run_body(body_fn, pred_fn)
    else:
        rec.node(WHILE, pred_fn(), body_fn, pred_fn)


def device_if(pred: torch.Tensor, body_fn: Callable[[], None]):
    """if any(pred): body_fn(). Eagerly one host read; inside a capture an
    IF node (the counterpart of lax.cond with a branch that does nothing)."""
    rec = _recording()
    if rec is None:
        if bool(set_conditional_any_ref(pred)):   # one host read
            body_fn()
    elif not rec.capturing:
        rec.run_body(body_fn)
    else:
        rec.node(IF, pred, body_fn)


@contextlib.contextmanager
def no_host_sync():
    """Every host synchronization of the device raises inside (a replay of a
    captured program has none)."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def tensors(tree) -> list:
    """The tensors of nested tuples (NamedTuples), in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in tensors(x)]
    return []


def assign(dst, src):
    """Copy every tensor of `src` into the tensor of `dst` at its place (a
    body's results into the state that outlives it)."""
    for d, s in zip(tensors(dst), tensors(src), strict=True):
        d.copy_(s)


def empty_like(tree):
    """`tree` with every tensor replaced by a new contiguous one of its
    shape, dtype and device (other leaves kept)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=tree.device)
    if isinstance(tree, tuple):
        items = [empty_like(x) for x in tree]
        return tuple(items) if type(tree) is tuple else type(tree)(*items)
    return tree


def clone(tree):
    """`tree` with every tensor copied into a new one (empty_like, assign)."""
    out = empty_like(tree)
    assign(out, tree)
    return out


def _stream(device: torch.device, depth: int) -> torch.cuda.Stream:
    """The stream that captures nesting depth `depth` (0: the program
    itself) on `device`, the same for every program."""
    key = (device.index, depth)
    s = _STREAMS.get(key)
    if s is None:
        s = _STREAMS[key] = torch.cuda.Stream(device=device)
    return s


def shared_pool(device) -> torch.cuda.MemPool:
    """The memory pool that every program of `device` captures into."""
    device = _cuda_device(device)
    pool = _POOLS.get(device.index)
    if pool is None:
        with torch.cuda.device(device):
            pool = _POOLS[device.index] = torch.cuda.MemPool()
    return pool


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"a GraphProgram runs on a CUDA device, got {device}")
    return torch.device("cuda", device.index if device.index is not None
                        else torch.cuda.current_device())


class GraphProgram:
    """`fn` (no arguments, no result: it reads and writes tensors allocated
    before) captured into one CUDA graph with its device_while and
    device_if as conditional nodes; `replay()` launches it on the current
    stream. A capture that fails raises. `executions` counts the condition
    kernel's runs on the device (warm-up and replays)."""

    def __init__(self, fn: Callable[[], None], device):
        self.device = _cuda_device(device)
        lib = load()
        self.executions = torch.zeros((), dtype=torch.int64, device=self.device)
        self.graph = self.exec = None
        with torch.cuda.device(self.device):
            caller = torch.cuda.current_stream(self.device)
            s0 = _stream(self.device, 0)
            # warm-up on the capture's streams
            s0.wait_stream(caller)
            with _recorded(_Recording(self.device, self.executions, False)), torch.cuda.stream(s0):
                fn()
            caller.wait_stream(s0)
            torch.cuda.synchronize(self.device)
            # the warm-up's cached scratch goes back to the device before the
            # capture reserves the program's own in the pool: a large batch's
            # two do not fit side by side
            torch.cuda.empty_cache()
            rec = _Recording(self.device, self.executions, True)
            graph = ctypes.c_void_p()
            with _recorded(rec), torch.cuda.stream(s0), \
                    torch.cuda.use_mem_pool(shared_pool(self.device), self.device):
                _check(lib, lib.gc_begin_capture(s0.cuda_stream), "cudaStreamBeginCapture")
                try:
                    fn()
                finally:
                    err = lib.gc_end_capture(s0.cuda_stream, ctypes.byref(graph))
            self.graph = graph.value
            _check(lib, err, "cudaStreamEndCapture")
            exe = ctypes.c_void_p()
            _check(lib, lib.gc_instantiate(graph, ctypes.byref(exe)), "cudaGraphInstantiate")
            self.exec = exe.value
        self.bodies = rec.bodies

    def replay(self):
        """Launch the graph on the current stream (no host synchronization)."""
        lib = load()
        _check(lib, lib.gc_launch(self.exec, torch.cuda.current_stream(self.device).cuda_stream),
               "cudaGraphLaunch")

    def dot(self, path: str):
        """Write the graph, conditional bodies and kernel names included, as
        a DOT file (cudaGraphDebugDotPrint)."""
        lib = load()
        _check(lib, lib.gc_dot_print(self.graph, str(path).encode()), "cudaGraphDebugDotPrint")

    def close(self):
        if self.graph is not None or self.exec is not None:
            lib = load()
            err = lib.gc_destroy(self.graph, self.exec)
            self.graph = self.exec = None
            _check(lib, err, "cudaGraphExecDestroy")
