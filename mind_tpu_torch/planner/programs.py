"""The planner's compiled programs (the JAX MINDPlanner's `_aime_fn`,
`_solve_fn` and `_fused_fn`, mind_tpu/planner/planner.py:393-503).

The JAX planner jits each stage of its plan once per planner; the host
calls it with the plan's arrays and reads the device once after it. Here a
stage is a body, `body(net, inputs) -> (outputs, rounds)`, that reads
nothing from the host: `inputs` and `outputs` are nested tuples of tensors,
`rounds` the AIME rounds it ran as a long tensor [] (None where it runs no
AIME). A `PlanProgram` holds static buffers for the body's inputs, its
outputs and a network of its own:

- on the card the first call captures the body into one CUDA graph
  (`graph_control.GraphProgram`: AIME's rounds IF nodes, the iLQR loops
  WHILE nodes); every call copies its inputs and, where they changed, the
  caller's weights into the buffers and replays the graph with every host
  synchronization an error (`graph_control.no_host_sync`);
- on the CPU the same body runs eagerly on the buffers, so that the tests
  hold what is copied in (an input the capture would bake shows there as a
  planner planning with another planner's data).

Inputs on the host (CPU tensors) go to their buffers in one host-to-device
copy each; inputs on the device in one `torch._foreach_copy_` per dtype. An
input buffer may be another program's (`keep`): the staged solve reads the
AIME program's slots where that program wrote them, with no copy.

Programs are cached per configuration (`config_signature`: every
PlannerConfig field but the weights' path and seed and the phases' cost
weights and bounds, which are data) and device (`ProgramSet`), then per
body and input shapes and dtypes: one program serves every planner of a
configuration, as `sim/episode.py`'s episode programs do, whatever its map,
target lane, target velocity, cost parameters and weights. The scale-out
runners' programs (parallel/programs.py) live in the same sets; a body
without a network (the tree solve) has a set without one. State that a
set's programs carry across calls in place (a batched runner's observation
window) is `Lent` to one holder at a time.
"""

from __future__ import annotations

import dataclasses
import json
import time
import weakref
from collections import defaultdict
from typing import Callable, List, Optional

import torch

from mind_tpu_torch.ops import graph_control


def config_signature(cfg, **extra) -> str:
    """The configuration that shapes a compiled program (the JAX package's
    episode `_cfg_signature`): every PlannerConfig field but the weights'
    path and seed (weights are data) and the phases' cost weights and
    bounds (cost parameters, data); `extra` joins it (the episode's vehicle
    and step)."""
    d = dataclasses.asdict(cfg)
    d.pop("ckpt_path", None)
    d.pop("seed", None)
    for ph in ("warm", "full"):
        phase = d["traj_tree"][ph]
        d["traj_tree"][ph] = {k: phase[k] for k in ("smooth_grid_res", "smooth_grid_size")}
    return json.dumps({"cfg": d, **extra}, sort_keys=True, default=str)


def signature(tree):
    """Shapes, dtypes and devices of a tree's tensors (other leaves as they
    are): what a captured program is specialized to."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), str(tree.dtype), str(tree.device))
    if isinstance(tree, tuple):
        return tuple(signature(x) for x in tree)
    return tree


def _buffers(tree, device, keep: frozenset):
    """A contiguous buffer on `device` for every tensor of `tree`, but the
    tensors in `keep` (by id), which stay themselves."""
    if isinstance(tree, torch.Tensor):
        if id(tree) in keep:
            return tree
        return torch.empty(tree.shape, dtype=tree.dtype, device=device)
    if isinstance(tree, tuple):
        items = [_buffers(x, device, keep) for x in tree]
        return tuple(items) if type(tree) is tuple else type(tree)(*items)
    return tree


def copy_in(dst, src):
    """Copy every tensor of `src` into the tensor of `dst` at its place:
    host tensors one copy each, device tensors one `_foreach_copy_` per
    dtype; a tensor that is its own destination is skipped."""
    groups = defaultdict(lambda: ([], []))
    for d, s in zip(graph_control.tensors(dst), graph_control.tensors(src), strict=True):
        if d is s:
            continue
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"input of shape {tuple(s.shape)} {s.dtype} for a buffer of "
                             f"{tuple(d.shape)} {d.dtype}")
        if s.device != d.device:
            d.copy_(s)   # one host-to-device copy
        else:
            ds, ss = groups[s.dtype]
            ds.append(d)
            ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


class ProgramNet:
    """A network of the programs' own, into which each call copies the
    caller's weights unless they are the ones it copied last: the same
    network object (held weakly), each of its tensors at the same address
    and version (`_version` counts in-place writes, a load_state_dict's
    too; `p.data = ...` moves the address). The caller's tensors are listed
    once per network object: a parameter replaced by another object is not
    seen (write its values in place, as load_state_dict does)."""

    def __init__(self, net):
        import copy

        self.net = copy.deepcopy(net)
        self._mine = self._tensors(self.net)
        self._last = None      # weakref to the caller's network
        self._theirs = None    # its tensors, in the order of self._mine
        self._key = None
        self.copies = 0   # weight copies made (a skipped call makes none)

    @staticmethod
    def _tensors(net) -> dict:
        return dict(net.named_parameters()) | dict(net.named_buffers())

    def load(self, net, force: bool = False):
        """The caller's weights into this network (the same architecture:
        the configuration's signature holds the network's); raises where it
        differs."""
        if self._last is None or self._last() is not net:
            mine, theirs = self._mine, self._tensors(net)
            if mine.keys() != theirs.keys() or any(t.shape != theirs[k].shape
                                                   for k, t in mine.items()):
                raise ValueError("the network differs in its architecture from the program's")
            self._last, self._key = weakref.ref(net), None
            self._theirs = [theirs[k] for k in mine]
        key = [(t.data_ptr(), t._version) for t in self._theirs]
        if not force and key == self._key:
            return
        with torch.no_grad():
            copy_in(tuple(self._mine.values()), tuple(self._theirs))
        self._key = key
        self.copies += 1


class PlanProgram:
    """One body on static buffers (module docstring). `rounds` counts on the
    device the AIME rounds that its replays ran (on the CPU, its eager
    runs); `program` is the GraphProgram (None before the first call and
    on the CPU), `capture_s` the seconds its capture took. `net` is None
    for a body that runs no network (it then gets None)."""

    def __init__(self, kind: str, body: Callable, inputs, net: ProgramNet, device,
                 keep=()):
        self.kind, self.body, self.net = kind, body, net
        self.device = torch.device(device)
        self.inputs = _buffers(inputs, self.device, frozenset(id(t) for t in keep))
        self.outputs = None
        self.rounds = torch.zeros((), dtype=torch.long, device=self.device)
        self.program = None
        self.capture_s = None

    def _run(self):
        out, rounds = self.body(self.net.net if self.net is not None else None, self.inputs)
        if self.outputs is None:   # the first (eager or warm-up) run: outside the pool
            self.outputs = graph_control.empty_like(out)
        graph_control.assign(self.outputs, out)
        if rounds is not None:
            self.rounds.add_(rounds)

    def __call__(self, net, inputs):
        """Copy `inputs` and `net`'s weights in, then run the body: a replay
        of its graph on the card (the first call captures it; a failed
        capture raises), eagerly on the CPU. Returns the output buffers."""
        if self.net is not None:
            self.net.load(net)
        copy_in(self.inputs, inputs)
        if self.device.type != "cuda":
            self._run()
            return self.outputs
        if self.program is None:
            t = time.perf_counter()
            self.program = graph_control.GraphProgram(self._run, self.device)
            self.capture_s = time.perf_counter() - t
            self.rounds.zero_()   # the replays' rounds, not the warm-up's
        with graph_control.no_host_sync():
            self.program.replay()
        return self.outputs


class Lent:
    """Tensors that the programs of a set read and write in place across
    calls (a batched runner's observation window), lent to one holder at a
    time, so that the programs that address them serve every holder: a
    holder that takes them over copies the previous holder's values out
    into that one's own tensors (where it lives on) and its own in. While
    one holder runs, nothing is copied. A holder that resets the state at
    each use takes `.tensors` without `take`: there is nothing to hand
    over. Allocated once, outside the programs' pool."""

    def __init__(self, like):
        self.tensors = graph_control.empty_like(like)
        self._holder = None   # (weakref to the holder, its own tensors)

    def holds(self, holder) -> bool:
        return self._holder is not None and self._holder[0]() is holder

    def take(self, holder, own):
        """The lent tensors, holding `holder`'s state: unless it holds them
        already, the previous holder's state is copied out into its own
        tensors and `own` (holder's tensors, like the lent ones) in."""
        if self.holds(holder):
            return self.tensors
        if self._holder is not None and self._holder[0]() is not None:
            graph_control.assign(self._holder[1], self.tensors)
        graph_control.assign(self.tensors, own)
        self._holder = (weakref.ref(holder), own)
        return self.tensors


class ProgramSet:
    """The programs of one configuration on one device, sharing one
    ProgramNet (None: bodies without a network), and the state they lend
    (`lent`)."""

    def __init__(self, net, device):
        self.net = ProgramNet(net) if net is not None else None
        self.device = device
        self.programs: dict = {}
        self._lent: dict = {}

    def lent(self, name: str, like) -> Lent:
        """The set's `Lent` tensors `name` of like's shapes and dtypes."""
        key = (name, signature(like))
        if key not in self._lent:
            self._lent[key] = Lent(like)
        return self._lent[key]

    def program(self, kind: str, body: Callable, inputs, keep=()) -> PlanProgram:
        """The program of `kind` for inputs of these shapes and dtypes (and
        these kept buffers), made at the first call."""
        key = (kind, signature(inputs), tuple(id(t) for t in keep))
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = PlanProgram(kind, body, inputs, self.net, self.device,
                                                    keep)
        return prog


# One ProgramSet per (configuration signature, device), as the JAX
# package's jit caches: every planner of a configuration shares it
_SETS: dict = {}


def program_set(signature_: str, net, device) -> ProgramSet:
    key = (signature_, str(device))
    ps = _SETS.get(key)
    if ps is None:
        ps = _SETS[key] = ProgramSet(net, device)
    return ps


def programs() -> List[PlanProgram]:
    """Every planner program of this process that has run (on the card:
    captured), each with its kind, `.rounds` and `.program`."""
    return [p for ps in _SETS.values() for p in ps.programs.values()
            if p.program is not None or (p.device.type != "cuda" and p.outputs is not None)]


def compiled(device: torch.device, graphed: Optional[bool]) -> bool:
    """Whether a plan runs through the programs: `graphed` None means on a
    CUDA device; True on the CPU raises."""
    if graphed is None:
        return device.type == "cuda"
    if graphed and device.type != "cuda":
        raise ValueError(f"compiled plans run on a CUDA device; got {device}")
    return bool(graphed)
