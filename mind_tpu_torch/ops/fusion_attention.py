"""Fused edge-conditioned fusion-layer core: CUDA kernel + plain PyTorch twin.

The fusion layer's hot path builds an edge-conditioned memory
mem[i, j] = relu(LN(edge[i,j] Wm_e + node[i] Wm_s + node[j] Wm_t + bm)),
optionally updates the edge from it, projects it to keys/values and attends
each target j over its memory column (mind_tpu/ops/fusion_attention.py).

`fused_edge_attention` launches the hand-written sm_90a kernel in
`csrc/fusion_attention.cu` (the port of the TPU kernel
mind_tpu/ops/fusion_attention.py::_kernel) for CUDA tensors, and runs the
plain twin `fused_edge_attention_ref` for CPU tensors. There is no fallback
between the two: a CUDA tensor goes to the kernel or raises.

The kernel is built with nvcc at first use into `_build/` beside this file
(listed in .gitignore), as a shared library with a C interface loaded with
ctypes. The library name carries a hash of the source, so an edited kernel
is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

_SRC = Path(__file__).resolve().parent / "csrc" / "fusion_attention.cu"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class FusionWeights(NamedTuple):
    """Explicit parameters of the fused block (all [in, out] layout)."""

    wm_e: torch.Tensor   # [E, D] memory proj, edge slice
    wm_s: torch.Tensor   # [D, D] memory proj, source-node slice
    wm_t: torch.Tensor   # [D, D] memory proj, target-node slice
    bm: torch.Tensor     # [D]
    ln_m_g: torch.Tensor  # [D] memory LayerNorm
    ln_m_b: torch.Tensor
    wq: torch.Tensor     # [D, D]
    bq: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    we: torch.Tensor     # [D, E] edge update proj
    be: torch.Tensor
    ln_e1_g: torch.Tensor  # [E] inner edge LN
    ln_e1_b: torch.Tensor
    ln_e2_g: torch.Tensor  # [E] residual edge LN
    ln_e2_b: torch.Tensor


def _ln(x, g, b, eps=1e-5):
    """Two-pass LayerNorm, as the TPU kernel and its jnp twin compute it."""
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * g + b


def fused_edge_attention_ref(node, edge, key_mask, w: FusionWeights,
                             n_head: int, update_edge: bool = True):
    """Plain PyTorch semantics, batched. node [B, N, D], edge [B, N, N, E]
    (edge[b, i, j] conditions source i -> target j), key_mask [B, N] bool.
    Returns (attn_out [B, N, D], edge_new [B, N, N, E]); edge_new is the
    input edge itself when `update_edge` is False."""
    B, N, D = node.shape
    dh = D // n_head
    mem = (torch.einsum("bije,ed->bijd", edge, w.wm_e)
           + (node @ w.wm_s)[:, :, None, :]
           + (node @ w.wm_t)[:, None, :, :]
           + w.bm)
    mem = torch.relu(_ln(mem, w.ln_m_g, w.ln_m_b))

    if update_edge:
        eu = torch.relu(_ln(torch.einsum("bijd,de->bije", mem, w.we) + w.be,
                            w.ln_e1_g, w.ln_e1_b))
        edge_new = _ln(edge + eu, w.ln_e2_g, w.ln_e2_b)
    else:
        edge_new = edge

    q = (node @ w.wq + w.bq).reshape(B, N, n_head, dh)
    k = (mem @ w.wk + w.bk).reshape(B, N, N, n_head, dh)
    v = (mem @ w.wv + w.bv).reshape(B, N, N, n_head, dh)
    logits = torch.einsum("bjhd,bijhd->bhji", q, k) * (1.0 / dh ** 0.5)
    logits = torch.where(key_mask[:, None, None, :], logits,
                         torch.full((), -1e9, dtype=logits.dtype,
                                    device=logits.device))
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhji,bijhd->bjhd", attn, v).reshape(B, N, D)
    return out @ w.wo + w.bo, edge_new


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return _BUILD_DIR / f"libfusion_attention_{digest}.so"


def build_kernel() -> ctypes.CDLL:
    """Compile the kernel (once per source hash) and load it. Raises on any
    build failure; never returns a library that did not build."""
    if build_kernel.lib is not None:
        return build_kernel.lib
    so = _library_path()
    if not so.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the fusion kernel cannot be built")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        build_kernel.log = res.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.fused_edge_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 25 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.fused_edge_attention_width.restype = ctypes.c_int
    lib.fused_edge_attention_heads.restype = ctypes.c_int
    build_kernel.lib = lib
    return lib


build_kernel.lib = None
build_kernel.log = ""


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def fused_edge_attention(node, edge, key_mask, w: FusionWeights, n_head: int,
                         update_edge: bool = True):
    """Fused layer core. CPU tensors run `fused_edge_attention_ref`; CUDA
    tensors launch the sm_90a kernel (float32, D = E = 128, 8 heads) and
    raise on anything it does not take. With `update_edge=False` the input
    edge is returned as it is (no copy)."""
    if node.device.type == "cpu":
        return fused_edge_attention_ref(node, edge, key_mask, w, n_head,
                                        update_edge)
    if node.device.type != "cuda":
        raise ValueError(f"unsupported device {node.device}")
    lib = build_kernel()
    D = lib.fused_edge_attention_width()
    if n_head != lib.fused_edge_attention_heads():
        raise ValueError(f"kernel is built for {lib.fused_edge_attention_heads()}"
                         f" heads, got {n_head}")
    B, N = node.shape[0], node.shape[1]
    dev, f32 = node.device, torch.float32
    _check("node", node, (B, N, D), f32, dev)
    _check("edge", edge, (B, N, N, D), f32, dev)
    _check("key_mask", key_mask, (B, N), torch.bool, dev)
    for name, t in w._asdict().items():
        _check(name, t, (D, D) if name.startswith("w") else (D,), f32, dev)
    out = torch.empty((B, N, D), dtype=f32, device=dev)
    edge_out = torch.empty_like(edge) if update_edge else edge
    err = lib.fused_edge_attention_f32(
        node.data_ptr(), edge.data_ptr(), key_mask.data_ptr(),
        *(t.data_ptr() for t in w),
        out.data_ptr(), edge_out.data_ptr(), B, N, int(update_edge),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_edge_attention launch failed: CUDA error {err}")
    fused_edge_attention.launches += 1
    return out, edge_out


fused_edge_attention.launches = 0


def fused_edge_attention_flops(batch: int, n: int, d: int,
                               update_edge: bool) -> int:
    """Operations of one call (2 per multiply-add), from its shapes: the
    three (four with the edge update) [d x d] products per (i, j) pair plus
    the per-token projections; LayerNorm and softmax are counted as lower
    order terms."""
    pair_mm = 4 if update_edge else 3
    pairs = batch * n * n
    tokens = batch * n
    return 2 * d * d * (pair_mm * pairs + 4 * tokens) + 4 * pairs * d


def fused_edge_attention_bytes(batch: int, n: int, d: int,
                               update_edge: bool) -> int:
    """Bytes that one call must move: inputs read once, outputs written
    once (float32), weights included."""
    edge = batch * n * n * d * 4
    node = batch * n * d * 4
    weights = (7 * d * d + 13 * d) * 4
    return edge * (2 if update_edge else 1) + 2 * node + batch * n + weights
