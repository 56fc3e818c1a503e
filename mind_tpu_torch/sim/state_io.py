"""Simulation-state checkpoint / resume (port of mind_tpu/sim/state_io.py;
the .npz has the same keys and meaning, so a state saved by either package
loads in the other).

The reference has no mid-run recovery: a plan failure terminates and replay
exhaustion freezes the agent (SURVEY.md §5 failure detection). Here the full
simulation state — every agent's kinematic state, replay cursor, trigger
clocks and the planner's rolling observation buffer — serializes to one .npz
so a run can resume exactly where it stopped.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from mind_tpu_torch.planner.aime_device import DeviceObsBuffer
from mind_tpu_torch.planner.trajectory_tree import torch_dtype
from mind_tpu_torch.sim.agents import CustomizedAgent, MINDAgent


def save_sim_state(sim, path: str | Path) -> str:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}
    meta = {"sim_time": sim.sim_time, "agents": []}
    for i, a in enumerate(sim.agents):
        am = {
            "id": a.id,
            "rec_step": int(a.rec_step),
            "timestep": float(a.timestep),
        }
        arrays[f"state_{i}"] = np.asarray(a.state, np.float64)
        arrays[f"ctrl_{i}"] = np.asarray(a.ctrl, np.float64)
        if isinstance(a, CustomizedAgent):
            am.update(
                is_enable=bool(a.is_enable),
                last_pl_tri=a.last_pl_tri,
                enable_timestep=float(a.enable_timestep),
            )
            if isinstance(a, MINDAgent) and a.planner is not None:
                buf = a.planner.obs_buffer
                arrays[f"buf_pos_{i}"] = buf.buf.pos.cpu().numpy()
                arrays[f"buf_ang_{i}"] = buf.buf.ang.cpu().numpy()
                arrays[f"buf_vel_{i}"] = buf.buf.vel.cpu().numpy()
                arrays[f"buf_obs_{i}"] = buf.buf.observed.cpu().numpy()
                arrays[f"buf_types_{i}"] = buf.types
                arrays[f"buf_active_{i}"] = buf.active
                arrays[f"buf_present_{i}"] = buf.last_present
                am["buf_slots"] = buf.slots
        meta["agents"].append(am)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    return str(path)


def load_sim_state(sim, path: str | Path) -> None:
    data = np.load(Path(path), allow_pickle=False)
    meta = json.loads(bytes(data["__meta__"]).decode())
    sim.sim_time = float(meta["sim_time"])
    by_id = {a.id: a for a in sim.agents}
    for i, am in enumerate(meta["agents"]):
        a = by_id[am["id"]]
        a.state = data[f"state_{i}"].copy()
        a.ctrl = data[f"ctrl_{i}"].copy()
        a.rec_step = int(am["rec_step"])
        a.timestep = float(am["timestep"])
        if isinstance(a, CustomizedAgent):
            a.is_enable = bool(am["is_enable"])
            a.last_pl_tri = am["last_pl_tri"]
            a.enable_timestep = float(am["enable_timestep"])
            if isinstance(a, MINDAgent) and a.planner is not None and \
                    f"buf_pos_{i}" in data:
                buf = a.planner.obs_buffer
                # back to the planner's device and pipeline dtype
                pd = dict(dtype=torch_dtype(a.planner.cfg.pipeline_dtype),
                          device=buf.device)
                buf.buf = DeviceObsBuffer(
                    pos=torch.tensor(data[f"buf_pos_{i}"], **pd),
                    ang=torch.tensor(data[f"buf_ang_{i}"], **pd),
                    vel=torch.tensor(data[f"buf_vel_{i}"], **pd),
                    observed=torch.tensor(data[f"buf_obs_{i}"], device=buf.device),
                )
                buf.types = data[f"buf_types_{i}"].copy()
                buf.active = data[f"buf_active_{i}"].copy()
                buf.last_present = data[f"buf_present_{i}"].copy()
                buf.slots = {k: int(v) for k, v in am["buf_slots"].items()}
                buf._ver += 1  # invalidate device-copy caches
