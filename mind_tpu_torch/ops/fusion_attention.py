"""Fused edge-conditioned fusion-layer core: two CUDA kernels + plain PyTorch twins.

The fusion layer's hot path builds an edge-conditioned memory
mem[i, j] = relu(LN(edge[i,j] Wm_e + node[i] Wm_s + node[j] Wm_t + bm)),
optionally updates the edge from it, projects it to keys/values and attends
each target j over its memory column (mind_tpu/ops/fusion_attention.py).

`fused_edge_attention` dispatches on the type of the weights it is given:

- float32 weights: the float32 kernel `csrc/fusion_attention.cu` (plain FMA,
  held to 2e-4 against `fused_edge_attention_ref`);
- bfloat16 weights: the tensor-core kernel `csrc/fusion_attention_bf16.cu`,
  the mode the TPU kernel runs under compute_dtype="bfloat16": bf16 operands
  into every 128-wide product, float32 accumulation, float32 LayerNorms,
  softmax, residual and outputs. Its plain version is
  `fused_edge_attention_bf16_ref`.

Both are hand-written for sm_90a and are the ports of the TPU kernel
mind_tpu/ops/fusion_attention.py::_kernel. CUDA tensors launch the kernel of
their variant or raise; CPU tensors run the variant's plain version. There is
no fallback between the two.

The kernels are built with nvcc at first use into `_build/` beside this file
(listed in .gitignore), one shared library with a C interface per source,
compiled side by side and loaded with ctypes. A library's name carries a hash
of its source and of the shared header, so an edited kernel is rebuilt.

Gradients. A kernel writes into buffers of its own, which autograd cannot
see, so under grad mode (an input or weight that requires grad)
`fused_edge_attention` goes through `FusedEdgeAttentionFn`:

- forward: the same dispatch as without grad (the variant's kernel on CUDA
  tensors, its plain version on CPU tensors); it saves only the inputs and
  weights, none of the [B, N, N, 128] intermediates;
- backward (`fused_edge_attention_vjp`): recomputes the core from those
  inputs with the variant's plain version and returns torch.autograd.grad
  of it. That is the gradient the JAX package's training takes: jax.grad
  cannot pass pallas_call, so it differentiates fused_edge_attention_ref.
  Here the plain version is the formula of the backward only; every
  training forward launches the kernel. There is no backward kernel.

Under no_grad (every serving path) the Function is not entered.
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

_CSRC = Path(__file__).resolve().parent / "csrc"
_COMMON = _CSRC / "fusion_common.cuh"
# every CUDA source of the port, each with the headers it includes: the two
# fusion kernels and the graph-control library (ops/graph_control.py)
_SRCS = {"float32": (_CSRC / "fusion_attention.cu", _COMMON),
         "bfloat16": (_CSRC / "fusion_attention_bf16.cu", _COMMON),
         "graph_control": (_CSRC / "graph_control.cu",)}
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


def _round_bf16(x):
    """A float32 activation as a bf16-operand product sees it."""
    return x.to(torch.bfloat16).to(torch.float32)


def fused_edge_attention_bf16_ref(node, edge, key_mask, w: FusionWeights,
                                  n_head: int, update_edge: bool = True):
    """Plain PyTorch version of the bf16 operand mode, on any device: the
    same function as `fused_edge_attention_ref` with the operands of every
    128-wide product rounded to bf16 and everything else (accumulation, bias
    adds, LayerNorms, logits, softmax, the residual edge + eu) in float32.

    node [B, N, D] and edge [B, N, N, E] may be bfloat16 or float32; the
    weights are bfloat16 (their values are used as they are), biases and
    LayerNorm parameters any float type here (the kernel takes them in
    bfloat16, as the bf16 network holds them). Returns float32 (attn_out, edge_new);
    with `update_edge` False edge_new is the input edge as float32."""
    f32 = torch.float32
    B, N, D = node.shape
    dh = D // n_head
    p = {k: t.to(f32) for k, t in w._asdict().items()}
    nb = _round_bf16(node)
    mem = (torch.einsum("bije,ed->bijd", _round_bf16(edge), p["wm_e"])
           + (nb @ p["wm_s"])[:, :, None, :]
           + (nb @ p["wm_t"])[:, None, :, :]
           + p["bm"])
    mem = _round_bf16(torch.relu(_ln(mem, p["ln_m_g"], p["ln_m_b"])))

    edge32 = edge.to(f32)
    if update_edge:
        eu = torch.relu(_ln(torch.einsum("bijd,de->bije", mem, p["we"]) + p["be"],
                            p["ln_e1_g"], p["ln_e1_b"]))
        edge_new = _ln(edge32 + eu, p["ln_e2_g"], p["ln_e2_b"])
    else:
        edge_new = edge32

    q = (nb @ p["wq"] + p["bq"]).reshape(B, N, n_head, dh)
    k = (mem @ p["wk"] + p["bk"]).reshape(B, N, N, n_head, dh)
    v = (mem @ p["wv"] + p["bv"]).reshape(B, N, N, n_head, dh)
    logits = torch.einsum("bjhd,bijhd->bhji", q, k) * (1.0 / dh ** 0.5)
    logits = torch.where(key_mask[:, None, None, :], logits,
                         torch.full((), -1e9, dtype=f32, device=logits.device))
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhji,bijhd->bjhd", attn, v).reshape(B, N, D)
    return _round_bf16(out) @ p["wo"] + p["bo"], edge_new


def _library_path(variant: str) -> Path:
    files = _SRCS[variant]
    h = hashlib.sha256(b"".join(f.read_bytes() for f in files))
    return _BUILD_DIR / f"lib{files[0].stem}_{h.hexdigest()[:12]}.so"


def compile_kernels() -> dict:
    """Compile every CUDA source of the port (both fusion kernels and
    csrc/graph_control.cu) where its library is missing (once per source
    hash, one nvcc per source, all side by side); returns {name: path}.
    Runs nvcc only: it neither loads a library nor touches a card, so a
    process can build for others it starts (parallel/launch.py). Raises on
    any build failure."""
    paths = {v: _library_path(v) for v in _SRCS}
    missing = [v for v, so in paths.items() if not so.exists()]
    if missing:
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the fusion kernels cannot be built")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for v in missing:
            tmp = paths[v].with_suffix(f".{os.getpid()}.tmp")
            procs[v] = (tmp, subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_SRCS[v][0])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        results = {v: (tmp, proc.communicate()[1], proc.returncode)
                   for v, (tmp, proc) in procs.items()}
        for v, (tmp, err, rc) in results.items():
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {_SRCS[v][0].name} ({rc}):\n{err}")
            build_kernels.log[v] = err
            os.replace(tmp, paths[v])
    return paths


def build_kernels() -> dict:
    """Compile both kernels (compile_kernels) and load them; returns
    {"float32": CDLL, "bfloat16": CDLL}. Raises on any build failure;
    never returns a library that did not build."""
    if build_kernels.libs is not None:
        return build_kernels.libs
    paths = compile_kernels()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = {v: ctypes.CDLL(str(paths[v])) for v in ("float32", "bfloat16")}
    fn = libs["float32"].fused_edge_attention_f32
    fn.argtypes = [ptr] * 29 + [i32] * 3 + [ptr]
    fn.restype = i32
    fn = libs["bfloat16"].fused_edge_attention_bf16
    fn.argtypes = [ptr, i32, ptr, i32] + [ptr] * 27 + [i32] * 4 + [ptr]
    fn.restype = i32
    for lib, stem in ((libs["float32"], "fused_edge_attention"),
                      (libs["bfloat16"], "fused_edge_attention_bf16")):
        getattr(lib, stem + "_width").restype = i32
        getattr(lib, stem + "_heads").restype = i32
    build_kernels.libs = libs
    return libs


build_kernels.libs = None
build_kernels.log = {}


def _check(name, t, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _launched(variant):
    fused_edge_attention.launches += 1
    fused_edge_attention.launches_by_variant[variant] += 1


def _launch_f32(node, edge, key_mask, w, n_head, update_edge):
    lib = build_kernels()["float32"]
    D = lib.fused_edge_attention_width()
    if n_head != lib.fused_edge_attention_heads():
        raise ValueError(f"kernel is built for {lib.fused_edge_attention_heads()}"
                         f" heads, got {n_head}")
    B, N = node.shape[0], node.shape[1]
    dev, f32 = node.device, (torch.float32,)
    _check("node", node, (B, N, D), f32, dev)
    _check("edge", edge, (B, N, N, D), f32, dev)
    _check("key_mask", key_mask, (B, N), (torch.bool,), dev)
    for name, t in w._asdict().items():
        _check(name, t, (D, D) if name.startswith("w") else (D,), f32, dev)
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    out = new(B, N, D)
    edge_out = torch.empty_like(edge) if update_edge else edge
    # scratch of the call's three launches: per-token projections, folded keys,
    # per-head softmax-weighted memory
    sp, tp, qk, ctx = new(B * N, D), new(B * N, D), new(B * N, n_head, D), new(B * N, n_head, D)
    # the launch and its cudaFuncSetAttribute apply to the current device:
    # make it the tensors' one
    with torch.cuda.device(dev):
        err = lib.fused_edge_attention_f32(
            node.data_ptr(), edge.data_ptr(), key_mask.data_ptr(),
            *(t.data_ptr() for t in w),
            sp.data_ptr(), tp.data_ptr(), qk.data_ptr(), ctx.data_ptr(),
            out.data_ptr(), edge_out.data_ptr(), B, N, int(update_edge),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_edge_attention launch failed: CUDA error {err}")
    _launched("float32")
    return out, edge_out


def _launch_bf16(node, edge, key_mask, w, n_head, update_edge):
    lib = build_kernels()["bfloat16"]
    D = lib.fused_edge_attention_bf16_width()
    if n_head != lib.fused_edge_attention_bf16_heads():
        raise ValueError(f"kernel is built for {lib.fused_edge_attention_bf16_heads()}"
                         f" heads, got {n_head}")
    B, N = node.shape[0], node.shape[1]
    dev = node.device
    bf16, f32 = torch.bfloat16, torch.float32
    _check("node", node, (B, N, D), (bf16, f32), dev)
    _check("edge", edge, (B, N, N, D), (bf16, f32), dev)
    _check("key_mask", key_mask, (B, N), (torch.bool,), dev)
    # weights, biases and LayerNorm parameters as the bf16 network holds them
    for name, t in w._asdict().items():
        _check(name, t, (D, D) if name.startswith("w") else (D,), (bf16,), dev)
    new = lambda *s: torch.empty(s, dtype=f32, device=dev)
    out = new(B, N, D)
    write_cast = not update_edge and edge.dtype != f32
    edge_out = new(B, N, N, D) if update_edge or write_cast else edge
    sp, tp, q, attn = (new(B * N, D) for _ in range(4))
    with torch.cuda.device(dev):   # as in _launch_f32
        err = lib.fused_edge_attention_bf16(
            node.data_ptr(), int(node.dtype == bf16), edge.data_ptr(), int(edge.dtype == bf16),
            key_mask.data_ptr(),
            *(t.data_ptr() for t in w),
            sp.data_ptr(), tp.data_ptr(), q.data_ptr(), attn.data_ptr(),
            out.data_ptr(), edge_out.data_ptr(), B, N, int(update_edge), int(write_cast),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_edge_attention (bf16) launch failed: CUDA error {err}")
    _launched("bfloat16")
    return out, edge_out


def fused_edge_attention(node, edge, key_mask, w: FusionWeights, n_head: int,
                         update_edge: bool = True):
    """Fused layer core; the variant follows the type of `w.wm_e`.

    float32 weights: CPU tensors run `fused_edge_attention_ref`, CUDA tensors
    launch the float32 kernel (float32 everywhere, D = E = 128, 8 heads). With
    `update_edge=False` the input edge is returned as it is (no copy).

    bfloat16 weights: CPU tensors run `fused_edge_attention_bf16_ref`, CUDA
    tensors launch the tensor-core kernel (node and edge bfloat16 or float32).
    Both outputs are float32; with `update_edge=False` a float32 input edge is
    returned as it is and a bfloat16 one is written out as float32.

    A CUDA tensor launches its kernel or raises on anything it does not take.
    Under grad mode, with an input or weight that requires grad, the call
    goes through FusedEdgeAttentionFn (module docstring)."""
    variant = {torch.float32: "float32", torch.bfloat16: "bfloat16"}.get(w.wm_e.dtype)
    if variant is None:
        raise TypeError(f"weights have dtype {w.wm_e.dtype}: float32 or bfloat16 expected")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (node, edge, *w)):
        return FusedEdgeAttentionFn.apply(node, edge, key_mask, n_head, update_edge, variant, *w)
    return _dispatch(variant, node, edge, key_mask, w, n_head, update_edge)


def _dispatch(variant, node, edge, key_mask, w, n_head, update_edge):
    if node.device.type == "cpu":
        return _PLAIN[variant](node, edge, key_mask, w, n_head, update_edge)
    if node.device.type != "cuda":
        raise ValueError(f"unsupported device {node.device}")
    launch = _launch_f32 if variant == "float32" else _launch_bf16
    return launch(node, edge, key_mask, w, n_head, update_edge)


_PLAIN = {"float32": fused_edge_attention_ref, "bfloat16": fused_edge_attention_bf16_ref}


def fused_edge_attention_vjp(variant, node, edge, key_mask, w, n_head, update_edge,
                             g_out, g_edge, needs):
    """Gradients of the layer core with respect to (node, edge, *w): the
    variant's plain version recomputed from the inputs and differentiated
    by autograd against the output gradients g_out, g_edge (None where an
    output has none). `needs` says, per input, whether its gradient is
    wanted; the others, and inputs the core does not use (the edge update's
    weights without the edge update), get None."""
    leaves = [t.detach().requires_grad_(bool(n)) for t, n in zip((node, edge, *w), needs)]
    with torch.enable_grad():
        out, edge_new = _PLAIN[variant](leaves[0], leaves[1], key_mask,
                                        FusionWeights(*leaves[2:]), n_head, update_edge)
    pairs = [(o, g) for o, g in ((out, g_out), (edge_new, g_edge))
             if g is not None and o.requires_grad]
    wrt = [t for t in leaves if t.requires_grad]
    if not pairs or not wrt:
        return [None] * len(leaves)
    grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                     allow_unused=True))
    return [next(grads) if t.requires_grad else None for t in leaves]


class FusedEdgeAttentionFn(torch.autograd.Function):
    """The layer core under autograd: forward as `fused_edge_attention`
    dispatches it (kernel on CUDA tensors, plain version on CPU tensors),
    backward `fused_edge_attention_vjp`. apply(node, edge, key_mask, n_head,
    update_edge, variant, *weights); variant "float32" takes any float type
    on the CPU (the plain formula is type-generic; gradcheck runs it in
    float64), and its kernel only float32."""

    @staticmethod
    def forward(ctx, node, edge, key_mask, n_head, update_edge, variant, *w):
        ctx.n_head, ctx.update_edge, ctx.variant = n_head, update_edge, variant
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(node, edge, key_mask, *w)
        return _dispatch(variant, node, edge, key_mask, FusionWeights(*w), n_head, update_edge)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out, g_edge):
        node, edge, key_mask, *w = ctx.saved_tensors
        needs = ctx.needs_input_grad
        grads = fused_edge_attention_vjp(ctx.variant, node, edge, key_mask, w, ctx.n_head,
                                         ctx.update_edge, g_out, g_edge,
                                         (needs[0], needs[1], *needs[6:]))
        return (grads[0], grads[1], None, None, None, None, *grads[2:])


fused_edge_attention.launches = 0          # calls that launched a kernel, both variants
fused_edge_attention.launches_by_variant = {"float32": 0, "bfloat16": 0}


def reset_launch_counts():
    fused_edge_attention.launches = 0
    for k in fused_edge_attention.launches_by_variant:
        fused_edge_attention.launches_by_variant[k] = 0


def fused_edge_attention_flops(batch: int, n: int, d: int, update_edge: bool,
                               variant: str = "float32", n_head: int = 8) -> int:
    """Operations of one call (2 per multiply-add), from its shapes; LayerNorm
    and softmax are counted as lower order terms.

    "float32" counts the folded form, the least work that computes the
    function: per (i, j) pair one [d x d] product (two with the edge update)
    plus the per-head logit and weighted-memory sums (2 n_head d), and six
    [d x d] products per token (Wm_s, Wm_t, Wq, the folded keys, Wv, Wo).
    "bfloat16" counts the form its kernel and the TPU kernel run: three (four)
    [d x d] products per pair and four per token. "unfolded" is that count for
    the float32 function, kept for comparison."""
    pairs = batch * n * n
    tokens = batch * n
    if variant == "float32":
        pair_macs = d * d * (2 if update_edge else 1) + 2 * n_head * d
        return 2 * (pair_macs * pairs + 6 * d * d * tokens) + 4 * pairs * d
    if variant not in ("bfloat16", "unfolded"):
        raise ValueError(variant)
    pair_mm = 4 if update_edge else 3
    return 2 * d * d * (pair_mm * pairs + 4 * tokens) + 4 * pairs * d


def fused_edge_attention_bytes(batch: int, n: int, d: int, update_edge: bool,
                               edge_bytes: int = 4, node_bytes: int = 4,
                               weight_bytes: int = 4) -> int:
    """Bytes that one call must move: inputs read once, outputs written once
    (float32 outputs), weights included. The defaults are the float32
    variant; the bf16 variant has 2-byte weights and a 2- or 4-byte node and
    edge, and writes a float32 edge whenever it updates or casts it."""
    pairs = batch * n * n * d
    edge_out = pairs * 4 if update_edge or edge_bytes != 4 else 0
    node = batch * n * d * (node_bytes + 4)
    weights = 7 * d * d * weight_bytes + 12 * d * 4
    return pairs * edge_bytes + edge_out + node + batch * n + weights
