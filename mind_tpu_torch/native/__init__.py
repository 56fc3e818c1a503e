"""Native (C++) execution re-solver: the float64 two-phase tree iLQR of the
winning scenario tree on the host CPU (port of mind_tpu/native/__init__.py).

With `TrajTreeConfig.exec_resolve_mode="native"` the executed control of a
plan comes from this solver (`exec_ilqr.cpp`, the port's own copy of the JAX
package's source), fed with the winner tree's float64 cost-node data that
`fused_plan_core(return_exec_payload=True)` packs into one vector
(`pack_exec_payload` / `unpack_exec_payload`). On the card a batch of one
tree is launch-bound; in C++ it is a few milliseconds of native float64.

The library is a plain `extern "C"` shared object loaded through ctypes,
built with g++ at first use into `_build/` beside this file (listed in
.gitignore), its name keyed by a hash of the source. IEEE-strict flags
(`-ffp-contract=off`, no fast-math) keep the arithmetic bit-compatible with
numpy where the operation order matches. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "exec_ilqr.cpp"
_BUILD_DIR = _DIR / "_build"
_CXX_FLAGS = ["-O2", "-ffp-contract=off", "-fPIC", "-shared", "-std=c++17"]
_lock = threading.Lock()
_lib = None

N_PHASE_PARAMS = 42


def _library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_CXX_FLAGS).encode())
    return _BUILD_DIR / f"libmind_exec_{h.hexdigest()[:12]}.so"


def _build() -> Path:
    """Compile the shared library once per source hash; raises on failure."""
    so = _library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *_CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """Build (if needed) and load the native library. Raises on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int32)
        up = ctypes.POINTER(ctypes.c_uint8)
        lib.mind_exec_two_phase_solve.restype = ctypes.c_int
        lib.mind_exec_two_phase_solve.argtypes = [
            ctypes.c_int, ip, dp, dp, dp,            # n, parents, prob, ego_mean, ego_cov
            ctypes.c_int, dp, dp, up,                # n_exo, exo_mean, exo_cov, exo_mask
            dp, ctypes.c_int,                        # tgt_pts, n_tgt
            dp, dp, dp,                              # x0, warm_params, full_params
            ctypes.c_double, ctypes.c_double,        # dt, wb
            ctypes.c_int, ctypes.c_int,              # warm/full max iters
            ctypes.c_double, ctypes.c_int,           # rel_tol, n_line_search
            ctypes.c_double,                         # mu_max
            dp, dp, dp,                              # out_xs, out_us, out_info
        ]
        lib.mind_exec_ilqr_solve.restype = ctypes.c_int
        lib.mind_exec_ilqr_solve.argtypes = [
            ctypes.c_int, ip, dp, dp, dp,
            ctypes.c_int, dp, dp, up,
            dp, ctypes.c_int,
            dp, dp, dp,                              # x0, us_init, params
            ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_double,
            dp, dp, dp,
        ]
        _lib = lib
        return lib


def pack_phase_params(field_offset, res, grid_n, w_tgt, w_ego,
                      w_ego_cov_offset, w_exo, w_exo_cov_offset,
                      w_exo_cost_offset, w_des_state, des_state, w_state_con,
                      state_lb, state_ub, w_ctrl) -> np.ndarray:
    """Flat 42-double phase-parameter block (layout: exec_ilqr.cpp
    PhaseParams::unpack)."""
    out = np.zeros(N_PHASE_PARAMS, np.float64)
    out[0:2] = np.asarray(field_offset, np.float64)
    out[2] = float(res)
    out[3] = float(grid_n)
    out[4] = float(w_tgt)
    out[5] = float(w_ego)
    out[6] = float(w_ego_cov_offset)
    out[7] = float(w_exo)
    out[8] = float(w_exo_cov_offset)
    out[9] = float(w_exo_cost_offset)
    out[10:16] = np.asarray(w_des_state, np.float64)
    out[16:22] = np.asarray(des_state, np.float64)
    out[22:28] = np.asarray(w_state_con, np.float64)
    out[28:34] = np.asarray(state_lb, np.float64)
    out[34:40] = np.asarray(state_ub, np.float64)
    out[40:42] = np.asarray(w_ctrl, np.float64)
    return out


def _np(x, dtype=None):
    """A tensor (any device) or array as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def pack_cost_params(p, field_offset=None) -> Tuple[np.ndarray, np.ndarray]:
    """The port's CostParams (ops/potential.py) -> (flat phase block, real
    target-lane points [n_tgt, 2]). `field_offset` optionally overrides the
    per-plan grid origin."""
    seg_mask = _np(p.tgt_seg_mask)
    starts = _np(p.tgt_seg_start, np.float64)
    ends = _np(p.tgt_seg_end, np.float64)
    n_seg = int(seg_mask.sum())
    pts = np.concatenate([starts[:n_seg], ends[n_seg - 1:n_seg]], axis=0) \
        if n_seg else np.zeros((1, 2))
    off = _np(field_offset if field_offset is not None else p.field_offset, np.float64)
    flat = pack_phase_params(
        off, _np(p.res), int(p.grid_n), _np(p.w_tgt), _np(p.w_ego),
        _np(p.w_ego_cov_offset), _np(p.w_exo), _np(p.w_exo_cov_offset),
        _np(p.w_exo_cost_offset), _np(p.w_des_state), _np(p.des_state),
        _np(p.w_state_con), _np(p.state_lb), _np(p.state_ub), _np(p.w_ctrl))
    return flat, np.ascontiguousarray(pts, np.float64)


class ExecPayload(NamedTuple):
    """The winner tree of one plan as the native re-solve takes it: the
    plan's 4 numbers [ctrl(2), ok, max_iterations] and the tree's float64
    parent row, node mask and cost-node data (MN cost nodes, E exo slots)."""

    out: np.ndarray        # [4]
    parent: np.ndarray     # [MN] int32, -1 = child of x0
    node_mask: np.ndarray  # [MN] bool
    prob: np.ndarray       # [MN]
    ego_mean: np.ndarray   # [MN, 2]
    ego_cov: np.ndarray    # [MN]
    exo_mean: np.ndarray   # [MN, E, 2]
    exo_cov: np.ndarray    # [MN, E]
    exo_mask: np.ndarray   # [MN, E] bool


def payload_size(MN: int, E: int) -> int:
    """Length of the packed payload: 4 + MN*(3+2+1) + MN*E*(2+1+1)."""
    return 4 + MN * (3 + 2 + 1) + MN * E * (2 + 1 + 1)


def pack_exec_payload(out, parent, node_mask, prob, ego_mean, ego_cov, exo_mean, exo_cov,
                      exo_mask):
    """One float64 vector in the layout of `unpack_exec_payload` (tensors,
    on any device; the result stays on theirs, so the host reads it once).
    The JAX package's fused_plan_core packs the same layout."""
    import torch

    parts = (out, parent, node_mask, prob, ego_mean, ego_cov, exo_mean, exo_cov, exo_mask)
    return torch.cat([t.to(torch.float64).reshape(-1) for t in parts])


def unpack_exec_payload(flat, MN: int, E: int) -> ExecPayload:
    """Split the packed payload; raises unless its length is exactly
    payload_size(MN, E)."""
    flat = np.asarray(flat, np.float64)
    if flat.ndim != 1 or flat.size != payload_size(MN, E):
        raise ValueError(f"exec payload of shape {flat.shape}: expected "
                         f"{payload_size(MN, E)} values for MN={MN}, E={E}")
    sizes = [4, MN, MN, MN, 2 * MN, MN, 2 * MN * E, MN * E, MN * E]
    out, parent, mask, prob, ego_mean, ego_cov, exo_mean, exo_cov, exo_mask = \
        np.split(flat, np.cumsum(sizes)[:-1])
    return ExecPayload(out=out, parent=parent.astype(np.int32), node_mask=mask > 0.5,
                       prob=prob, ego_mean=ego_mean.reshape(MN, 2), ego_cov=ego_cov,
                       exo_mean=exo_mean.reshape(MN, E, 2), exo_cov=exo_cov.reshape(MN, E),
                       exo_mask=exo_mask.reshape(MN, E) > 0.5)


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _tree_args(parents, prob, ego_mean, ego_cov, exo_mean, exo_cov, exo_mask, tgt_pts):
    """Contiguous float64 / int32 / uint8 copies of one tree's data, with
    the shapes checked before any pointer reaches the library."""
    parents = np.ascontiguousarray(parents, np.int32)
    n = len(parents)
    prob = np.ascontiguousarray(prob, np.float64)
    ego_mean = np.ascontiguousarray(ego_mean, np.float64)
    ego_cov = np.ascontiguousarray(ego_cov, np.float64)
    exo_mean = np.ascontiguousarray(exo_mean, np.float64)
    exo_cov = np.ascontiguousarray(exo_cov, np.float64)
    exo_mask = np.ascontiguousarray(exo_mask, np.uint8)
    tgt_pts = np.ascontiguousarray(tgt_pts, np.float64)
    n_exo = exo_mean.shape[1] if exo_mean.ndim == 3 else 0
    if (prob.shape != (n,) or ego_mean.shape != (n, 2) or ego_cov.shape != (n,)
            or exo_cov.shape != (n, n_exo) or exo_mask.shape != (n, n_exo)
            or (n_exo and exo_mean.shape != (n, n_exo, 2)) or tgt_pts.ndim != 2
            or tgt_pts.shape[1] != 2 or (parents >= np.arange(n)).any()):
        raise ValueError("native solve: inconsistent tree arrays")
    return parents, n, prob, ego_mean, ego_cov, n_exo, exo_mean, exo_cov, exo_mask, tgt_pts


def two_phase_solve(parents, prob, ego_mean, ego_cov, exo_mean, exo_cov,
                    exo_mask, tgt_pts, x0, warm_flat, full_flat, *, dt, wb,
                    warm_max_iterations, max_iterations, rel_tol,
                    n_line_search, mu_max):
    """Native two-phase tree iLQR over the REAL (unpadded) cost nodes: the
    warm solve from zero controls with the warm-phase cost, then the full
    solve from the warm controls. Returns (xs [n,6], us [n,2], info dict);
    the executed control is xs[0, 4:6]."""
    lib = load()
    (parents, n, prob, ego_mean, ego_cov, n_exo, exo_mean, exo_cov, exo_mask,
     tgt_pts) = _tree_args(parents, prob, ego_mean, ego_cov, exo_mean, exo_cov, exo_mask,
                           tgt_pts)
    x0 = np.ascontiguousarray(x0, np.float64)
    warm_flat = np.ascontiguousarray(warm_flat, np.float64)
    full_flat = np.ascontiguousarray(full_flat, np.float64)
    if x0.shape != (6,) or warm_flat.shape != (N_PHASE_PARAMS,) \
            or full_flat.shape != (N_PHASE_PARAMS,):
        raise ValueError("native solve: x0 must be [6], phase blocks [42]")

    xs = np.zeros((n, 6), np.float64)
    us = np.zeros((n, 2), np.float64)
    info = np.zeros(4, np.float64)
    rc = lib.mind_exec_two_phase_solve(
        n, parents.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _dp(prob), _dp(ego_mean), _dp(ego_cov),
        n_exo, _dp(exo_mean), _dp(exo_cov),
        exo_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _dp(tgt_pts), len(tgt_pts),
        _dp(x0), _dp(warm_flat), _dp(full_flat),
        float(dt), float(wb), int(warm_max_iterations), int(max_iterations),
        float(rel_tol), int(n_line_search), float(mu_max),
        _dp(xs), _dp(us), _dp(info))
    if rc != 0:
        raise RuntimeError(f"mind_exec_two_phase_solve failed rc={rc}")
    return xs, us, {"J": float(info[0]), "warm_iterations": int(info[1]),
                    "iterations": int(info[2]), "converged": bool(info[3])}


def ilqr_solve(parents, prob, ego_mean, ego_cov, exo_mean, exo_cov, exo_mask,
               tgt_pts, x0, us_init, params_flat, *, dt, wb, max_iterations,
               rel_tol, n_line_search, mu_max):
    """Single-phase native solve from `us_init`."""
    lib = load()
    (parents, n, prob, ego_mean, ego_cov, n_exo, exo_mean, exo_cov, exo_mask,
     tgt_pts) = _tree_args(parents, prob, ego_mean, ego_cov, exo_mean, exo_cov, exo_mask,
                           tgt_pts)
    x0 = np.ascontiguousarray(x0, np.float64)
    us_init = np.ascontiguousarray(us_init, np.float64)
    params_flat = np.ascontiguousarray(params_flat, np.float64)
    if x0.shape != (6,) or us_init.shape != (n, 2) or params_flat.shape != (N_PHASE_PARAMS,):
        raise ValueError("native solve: x0 must be [6], us_init [n, 2], params [42]")

    xs = np.zeros((n, 6), np.float64)
    us = np.zeros((n, 2), np.float64)
    info = np.zeros(4, np.float64)
    rc = lib.mind_exec_ilqr_solve(
        n, parents.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _dp(prob), _dp(ego_mean), _dp(ego_cov),
        n_exo, _dp(exo_mean), _dp(exo_cov),
        exo_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _dp(tgt_pts), len(tgt_pts),
        _dp(x0), _dp(us_init), _dp(params_flat),
        float(dt), float(wb), int(max_iterations), float(rel_tol),
        int(n_line_search), float(mu_max),
        _dp(xs), _dp(us), _dp(info))
    if rc != 0:
        raise RuntimeError(f"mind_exec_ilqr_solve failed rc={rc}")
    return xs, us, {"J": float(info[0]), "iterations": int(info[1]),
                    "converged": bool(info[3])}
