"""Parameter checkpoints (port of mind_tpu/models/checkpoint.py, orbax ->
torch.save).

`save_params(path, params, step)` writes `path/<step>/params.pt` (a state
dict) and, given an optimizer state, `path/<step>/opt_state.pt`;
`load_params` restores a step (the latest by default) onto a template's
devices and types, as the JAX version restores onto the template's
shardings. Files are read with torch.load(weights_only=True).

`save_flax_npz` writes the flat flax-layout archive that
models/weights.py::load_scene_pred reads (the layout of
mind_tpu_torch/weights/scene_pred_demo_600.npz), so weights trained by the
port feed its planner.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

PARAMS, OPT_STATE = "params.pt", "opt_state.pt"


def _state(x) -> dict:
    return x.state_dict() if hasattr(x, "state_dict") else dict(x)


def _save(obj, path: Path):
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_params(path, params, step: int = 0, opt_state=None) -> str:
    """Write `params` (a module or a state dict) and, if given, `opt_state`
    (an optimizer or its state dict) under path/<step>/; returns that
    directory."""
    d = Path(path).absolute() / str(int(step))
    d.mkdir(parents=True, exist_ok=True)
    _save({k: v.detach().cpu() for k, v in _state(params).items()}, d / PARAMS)
    if opt_state is not None:
        _save(_state(opt_state), d / OPT_STATE)
    return str(d)


def steps(path) -> list:
    """The steps saved under `path`, ascending."""
    path = Path(path)
    if not path.is_dir():
        return []
    return sorted(int(p.name) for p in path.iterdir()
                  if p.name.isdigit() and (p / PARAMS).is_file())


def _step_dir(path, step: Optional[int]) -> Path:
    if step is None:
        saved = steps(path)
        if not saved:
            raise FileNotFoundError(f"no checkpoint under {path}")
        step = saved[-1]
    return Path(path).absolute() / str(int(step))


def load_params(path, like, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The state dict saved at `step` (default: the latest) with every
    tensor on the device and of the type of `like`'s (a module or a state
    dict) tensor of the same name; the key sets must be equal."""
    saved = torch.load(_step_dir(path, step) / PARAMS, map_location="cpu", weights_only=True)
    like = _state(like)
    if set(saved) != set(like):
        raise KeyError(f"checkpoint keys differ from the template's: missing "
                       f"{sorted(set(like) - set(saved))[:8]}, extra {sorted(set(saved) - set(like))[:8]}")
    return {k: v.to(device=like[k].device, dtype=like[k].dtype) for k, v in saved.items()}


def load_opt_state(path, optimizer, step: Optional[int] = None):
    """Restore `optimizer` from the state saved at `step` (default: the
    latest); torch moves the state onto its parameters' devices."""
    optimizer.load_state_dict(torch.load(_step_dir(path, step) / OPT_STATE, map_location="cpu",
                                         weights_only=True))
    return optimizer


def flax_layout(state_dict) -> Dict[str, np.ndarray]:
    """The port's state dict as the flat flax archive: "params/" + the
    module path joined by "/", float32, a Dense kernel [in, out], a Conv
    kernel [k, in, out] and a norm's "scale"; the fusion core's own
    parameters keep their names and [in, out] layout. The inverse of
    models/weights.py::params_from_flax."""
    out = {}
    for key, t in _state(state_dict).items():
        parts = key.split(".")
        a = t.detach().to("cpu", torch.float32)
        if parts[-1] == "weight":
            if a.dim() == 1:
                parts[-1] = "scale"
            else:
                parts[-1] = "kernel"
                a = a.t() if a.dim() == 2 else a.permute(2, 1, 0)
        out["/".join(["params", *parts])] = np.ascontiguousarray(a.numpy())
    return out


def save_flax_npz(path, params) -> str:
    """Write `params` (a module or a state dict) as the flax-layout .npz
    archive that models/weights.py::load_scene_pred reads."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **flax_layout(params))
    os.replace(tmp, path)
    return str(path)
