"""Device-resident replay simulation (port of mind_tpu/sim/replay.py).

The reference steps Python agent objects per tick (simulator.py:51-107); for
replay (non-reactive) agents that loop is a pure gather over resampled logs.
The JAX package runs it as a `lax.scan` over ticks; here every tick is
gathered at once with one index tensor, and the perturbed rollout's
position integration is one cumulative sum over the tick axis, so no Python
loop runs over ticks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mind_tpu_torch.common.device import resolve_device
from mind_tpu_torch.data.loader import TrajBundle


class ReplayScene(NamedTuple):
    """Padded device tensors for one scenario's replay logs (or, with a
    leading axis S, for stacked scenarios)."""

    pos: torch.Tensor    # [N, T, 2]
    ang: torch.Tensor    # [N, T]
    vel: torch.Tensor    # [N, T]
    valid: torch.Tensor  # [N, T] bool
    mask: torch.Tensor   # [N] real agents


def scene_from_bundle(bundle: TrajBundle, max_agents: Optional[int] = None,
                      max_steps: Optional[int] = None, device=None) -> ReplayScene:
    """Replay tensors of a TrajBundle on `device` (the CUDA card unless the
    caller passes a CPU device), padded to max_agents x max_steps."""
    device = resolve_device(device)
    n, t = bundle.pos.shape[:2]
    N = max_agents or n
    T = max_steps or t
    pos = np.zeros((N, T, 2), np.float32)
    ang = np.zeros((N, T), np.float32)
    vel = np.zeros((N, T), np.float32)
    valid = np.zeros((N, T), bool)
    mask = np.zeros(N, bool)
    pos[:n, :t] = bundle.pos[:, :T]
    ang[:n, :t] = bundle.ang[:, :T]
    vel[:n, :t] = bundle.vel[:, :T]
    valid[:n, :t] = bundle.has_flag[:, :T]
    mask[:n] = True
    return ReplayScene(*(torch.tensor(x, device=device) for x in (pos, ang, vel, valid, mask)))


def _rec_steps(scene: ReplayScene, horizon: int):
    """Log step read at each tick: t + 1, held at the last step (the
    reference advances rec_step before update_state)."""
    T = scene.pos.shape[-2]
    return torch.clamp(torch.arange(1, horizon + 1, device=scene.pos.device), max=T - 1)


def replay_rollout(scene: ReplayScene, horizon: int):
    """Full replay rollout: states[t] = log state at step t+1. Returns
    ([H, N, 4] states, [H, N] valid)."""
    rec = _rec_steps(scene, horizon)
    state = torch.stack([scene.pos[:, rec, 0], scene.pos[:, rec, 1],
                         scene.vel[:, rec], scene.ang[:, rec]], dim=-1)   # [N, H, 4]
    return state.transpose(0, 1), scene.valid[:, rec].transpose(0, 1)


def perturbed_rollout(scene: ReplayScene, horizon: int, offsets, dt: float = 0.02):
    """Monte-Carlo rollout: every agent replays its log velocity/heading
    profile but integrates position from a perturbed initial state via the
    kinematic bicycle's position update. offsets: [N, 2] initial position
    perturbation, or [K, N, 2] for K rollouts at once. Returns
    [H, N, 4] (or [K, H, N, 4]) states."""
    rec = _rec_steps(scene, horizon)
    v, yaw = scene.vel[:, rec], scene.ang[:, rec]                     # [N, H]
    step = torch.stack([v * torch.cos(yaw), v * torch.sin(yaw)], dim=-1) * dt
    offsets = torch.as_tensor(offsets, dtype=scene.pos.dtype, device=scene.pos.device)
    start = scene.pos[:, 0] + offsets                                   # [..., N, 2]
    xy = start[..., None, :] + torch.cumsum(step, dim=1)              # [..., N, H, 2]
    vy = torch.stack([v, yaw], dim=-1).expand(xy.shape[:-1] + (2,))
    return torch.cat([xy, vy], dim=-1).transpose(-3, -2)


def batched_replay(scenes: ReplayScene, horizon: int):
    """Rollout across stacked scenes ([S, ...] leading axis): the 'all four
    demos as one batched rollout' configuration. Returns ([S, H, N, 4]
    states, [S, H, N] valid)."""
    rec = _rec_steps(scenes, horizon)
    state = torch.stack([scenes.pos[:, :, rec, 0], scenes.pos[:, :, rec, 1],
                         scenes.vel[:, :, rec], scenes.ang[:, :, rec]], dim=-1)  # [S, N, H, 4]
    return state.transpose(1, 2), scenes.valid[:, :, rec].transpose(1, 2)
