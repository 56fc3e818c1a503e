"""Kinematic bicycle models (port of mind_tpu/common/kinematics.py)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class VehicleParam:
    wb: float = 3.0
    max_spd: float = 15.0
    max_acc: float = 6.0
    max_str: float = float(np.deg2rad(45.0))
    max_dstr: float = float(np.deg2rad(30.0))

    @property
    def max_dec(self) -> float:
        return -self.max_acc


def kine_propagate(state, ctrl, dt, wb=2.5, max_spd=20.0,
                   max_steer=float(np.deg2rad(45.0)), max_acc=6.0, max_dec=-6.0):
    """One Euler step of the kinematic bicycle on state [..., x, y, v, yaw]:
    clips accel/steer inputs, integrates, clips speed (reference
    common/kinematics.py:22-36). Shapes broadcast over leading axes."""
    x, y, v, yaw = state[..., 0], state[..., 1], state[..., 2], state[..., 3]
    a = torch.clamp(ctrl[..., 0], max_dec, max_acc)
    delta = torch.clamp(ctrl[..., 1], -max_steer, max_steer)
    new_v = torch.clamp(v + a * dt, -max_spd, max_spd)
    return torch.stack([
        x + v * torch.cos(yaw) * dt,
        y + v * torch.sin(yaw) * dt,
        new_v,
        yaw + v / wb * torch.tan(delta) * dt,
    ], dim=-1)


def kine_propagate_np(state, ctrl, dt, wb=2.5, max_spd=20.0,
                      max_steer=float(np.deg2rad(45.0)), max_acc=6.0, max_dec=-6.0):
    """Numpy form of `kine_propagate` on one state [x, y, v, yaw], float64
    on the host: the simulator's 50 Hz step of a closed-loop agent."""
    x, y, v, yaw = state
    a = np.clip(ctrl[0], max_dec, max_acc)
    delta = np.clip(ctrl[1], -max_steer, max_steer)
    out = np.array([
        x + v * np.cos(yaw) * dt,
        y + v * np.sin(yaw) * dt,
        v + a * dt,
        yaw + v / wb * np.tan(delta) * dt,
    ])
    out[2] = np.clip(out[2], -max_spd, max_spd)
    return out


def ext_bicycle_step(x, u, dt: float, wb: float = 2.5):
    """Extended-state bicycle of the trajectory optimizer: state
    [x, y, v, yaw, a, steer], control [jerk, steer-rate]."""
    px, py, v, q, a, s = (x[..., i] for i in range(6))
    da, ds = u[..., 0], u[..., 1]
    return torch.stack([
        px + v * torch.cos(q) * dt,
        py + v * torch.sin(q) * dt,
        v + a * dt,
        q + v / wb * torch.tan(s) * dt,
        a + da * dt,
        s + ds * dt,
    ], dim=-1)


def ext_bicycle_jacobians(x, dt: float, wb: float):
    """Analytic (f_x [..., 6, 6], f_u [..., 6, 2]) of `ext_bicycle_step`
    (the derivatives the reference compiles through Theano). Each entry is
    written as forward-mode differentiation evaluates it (d tan = 1 + tan^2,
    d(v / wb) = 1 / wb), so the values agree with jax.jacfwd to the ulp."""
    v, q, s = x[..., 2], x[..., 3], x[..., 5]
    f_x = torch.eye(6, dtype=x.dtype, device=x.device).expand(
        x.shape[:-1] + (6, 6)).clone()
    f_x[..., 0, 2] = torch.cos(q) * dt
    f_x[..., 0, 3] = -v * torch.sin(q) * dt
    f_x[..., 1, 2] = torch.sin(q) * dt
    f_x[..., 1, 3] = v * torch.cos(q) * dt
    f_x[..., 2, 4] = dt
    f_x[..., 3, 2] = (1.0 / wb) * torch.tan(s) * dt
    f_x[..., 3, 5] = v / wb * (1.0 + torch.tan(s) ** 2) * dt
    f_u = torch.zeros(x.shape[:-1] + (6, 2), dtype=x.dtype, device=x.device)
    f_u[..., 4, 0] = dt
    f_u[..., 5, 1] = dt
    return f_x, f_u
