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
  into every product, float32 accumulation, float32 LayerNorms, softmax,
  residual and outputs. Its plain version is `fused_edge_attention_bf16_ref`.

Both are hand-written for sm_90a and are the ports of the TPU kernel
mind_tpu/ops/fusion_attention.py::_kernel. CUDA tensors launch the kernel of
their variant or raise; CPU tensors run the variant's plain version. There is
no fallback between the two.

Widths. Like the TPU kernel, the plain versions and the kernels take any
node width D >= 1, edge width E >= 1 and head count that divides D
(`kernel_domain` refuses only what the JAX function refuses). Each library
picks its layout at compile time (`kernel_layout`): "resident" (D and E
multiples of 16 from 16 to 128, at most 16 heads of a width that is a
multiple of 8: the weights stay in shared memory, as for the main path's
128 / 128 / 8; kernel B's main kernel there is persistent, one block a
multiprocessor walking tiles of 8 columns fed by bulk copies through a ring
of stages, `resident_schedule` mirrors its order) or "tiled" (every other
shape: csrc/fusion_tiled.cuh runs
every per-pair product as one product over all the call's pairs, in tiles of
128 pairs fed through a ring of shared-memory stages, on wgmma in bf16 and a
register-tiled FMA product in float32; kernel A folds keys and values from a
head width of 8; the LayerNorms run in the products' epilogues up to 128
wide and in row passes above). The tiled route's intermediates lie in a
pair scratch the wrapper allocates per call (`pair_scratch_bytes`).
`kernel_smem` mirrors each library's layout in Python; a library whose own
numbers differ is refused when it is loaded. No weight is padded or re-laid
on the host.

The kernels are built with nvcc at first use into `_build/` beside this file
(listed in .gitignore), one shared library with a C interface per source and
shape (D, E, heads): every width is a compile-time constant of its library,
so no run-time width test or index costs the main path's library anything.
`compile_kernels` builds the libraries it is asked for side by side (one nvcc
each), and a call at a shape not built yet builds that shape's library of its
variant. A library's name carries its shape and a hash of its source and of
the shared header, so an edited kernel is rebuilt.

Gradients. A kernel writes into buffers of its own, which autograd cannot
see, so under grad mode (an input or weight that requires grad)
`fused_edge_attention` goes through `FusedEdgeAttentionFn`:

- forward: the same dispatch as without grad (the variant's kernel on CUDA
  tensors, its plain version on CPU tensors); it saves only the inputs and
  weights, none of the [B, N, N, E] intermediates;
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
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_COMMON = _CSRC / "fusion_common.cuh"
# every CUDA source of the port, each with the headers it includes: the two
# fusion kernels and the graph-control library (ops/graph_control.py)
_TILED = _CSRC / "fusion_tiled.cuh"
_SRCS = {"float32": (_CSRC / "fusion_attention.cu", _COMMON, _TILED),
         "bfloat16": (_CSRC / "fusion_attention_bf16.cu", _COMMON, _TILED),
         "graph_control": (_CSRC / "graph_control.cu",)}
VARIANTS = ("float32", "bfloat16")
FULL_WIDTH = (128, 128, 8)   # (D, E, heads) of the main path's network
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class FusionWeights(NamedTuple):
    """Explicit parameters of the fused block (all [in, out] layout)."""

    wm_e: torch.Tensor   # [E, D] memory proj, edge slice (be, ln_e1_*, ln_e2_*: [E])
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
    be: torch.Tensor     # [E]
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
    product rounded to bf16 and everything else (accumulation, bias
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


def kernel_domain(d: int, e: int, n_head: int):
    """None where the card's kernels take node width d, edge width e and
    n_head heads; else why not. A pure function of the three widths: it
    builds, loads and launches nothing. The kernels take what the JAX
    function takes: widths from 1 up and any head count that divides D (its
    reshape to [N, heads, D / heads] refuses any other)."""
    for name, x in (("D", d), ("E", e)):
        if x < 1:
            return f"{name} = {x}: a width must be at least 1"
    if n_head < 1 or d % n_head:
        return (f"{n_head} heads at D = {d}: a head count that does not divide D, which the "
                f"JAX function cannot compute either")
    return None


def kernel_layout(d: int, e: int, n_head: int) -> str:
    """The layout a library at (d, e, n_head) is built in, as
    csrc/fusion_common.cuh's Widths::RESIDENT decides it: "resident" (D and E
    multiples of 16 from 16 to 128, at most 16 heads of a width that is a
    multiple of 8) or "tiled" (csrc/fusion_tiled.cuh). It sets the float32
    call's scratch."""
    resident = (all(x % 16 == 0 and 16 <= x <= 128 for x in (d, e)) and n_head <= 16
                and (d // n_head) % 8 == 0)
    return "resident" if resident else "tiled"


class SmemLayout(NamedTuple):
    """A library's layout as kernel_smem mirrors it."""

    layout: str      # "resident" or "tiled"
    regime: str      # "resident"; tiled: "epilogue" (D <= 128: the memory LayerNorm in
    #                  the first product's epilogue) or "row pass"
    tj: int          # resident: (scene, target) columns a block; tiled: 0
    dynamic: int     # the largest dynamic shared memory of a kernel (bytes)
    static: tuple    # static shared memory of each kernel (kernel_names' order), bytes
    scratch: int     # tiled: pair scratch bytes a (source, target) pair; resident: 0
    fold: bool       # keys and values folded (kernel A resident, and tiled from dh = 8)
    tile: tuple      # tiled: (pairs, columns) of a product's tile and its stages; else ()
    edge_ln: str     # tiled: "epilogue" (E <= 128) or "row pass"; resident: ""
    pair_bytes: tuple  # tiled: scratch a pair of S (float32 products), M (memory rows)
    #                    and L (logits): each buffer of a call is 256-byte aligned
    blocks: int = 0  # kernel B resident: blocks a multiprocessor of its persistent grid


# the card's opt-in shared memory a block, less 1 KB
SMEM_BUDGET = 232448 - 1024
STATIC_LIMIT = 48 * 1024       # static shared memory a kernel may declare
_TOK, _TOKEN_KC = 8, 1280      # fusion_common.cuh: tokens a block, staged k a chunk
# fusion_tiled.cuh: pairs a tile, the widest row whose LayerNorm runs in an
# epilogue, the float32 product's stages (each 128 rows of 20 floats and 16
# rows of the tile's columns),
# the bf16 product's stages and stage bytes, the fold products' k a step and
# the bf16 product's mbarriers (static shared memory)
TILE_PAIRS, EPI_MAX = 128, 128
_F_STAGES = 4
_H_STAGES, _H_A_BYTES, _H_BK = 4, 128 * 64 * 2, 64
_Q_K, _MBARRIERS = 32, 2 * 4 * 8


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# csrc/fusion_attention_bf16.cu: kernel B's resident main kernel. Columns a
# tile, sources a chunk, a weight's TMA box (64 k rows of 64 columns, bf16),
# an edge box (a chunk's 64 rows of 128 bytes) and the most stages of its ring
B_TILE_COLS, B_CHUNK_SOURCES, _B_W_BOX, _B_E_BOX, _B_STAGES_MAX = 8, 8, 64 * 64 * 2, 64 * 128, 4


def _layout_b(d: int, e: int, n_head: int) -> tuple:
    """(dynamic shared memory, stages) of kernel B's resident main kernel,
    as LayoutB computes them: the four weights in 64 x 64 boxes, the seven
    LayerNorm and bias vectors in float32, a tile's tp and q rows (padded by
    8 floats; the softmax merge's scratch after the tile), the stages (the
    chunk's rows as float32 in edge boxes of 32 columns, and sp of 8 sources
    in two scenes; 1 KB aligned), an mbarrier each and two more, and 1 KB to
    align the base; as many stages as fit SMEM_BUDGET, up to 4."""

    def wbytes(k, n):
        return -(-k // 64) * (_round_up(n, 64) // 64) * _B_W_BOX

    weights = wbytes(e, d) + wbytes(d, e) + 2 * wbytes(d, d)
    vectors = (2 * d + 5 * e) * 4
    tile = max(2 * B_TILE_COLS * (d + 8) * 4, 8 * B_TILE_COLS * n_head * 2 * 4)
    fixed = _round_up(weights + vectors + tile, 1024) + 2 * 8 + 1024
    per_stage = _round_up(-(-e // 32) * _B_E_BOX + 2 * B_CHUNK_SOURCES * d * 4, 1024) + 8
    stages = next(s for s in range(_B_STAGES_MAX, 1, -1)
                  if fixed + s * per_stage <= SMEM_BUDGET)
    return fixed + stages * per_stage, stages


class ResidentTile(NamedTuple):
    """A tile of kernel B's resident main kernel, as resident_schedule walks it."""

    block: int       # the block that takes it
    tile: int        # its index: columns 8 tile .. 8 tile + 7 of B N
    columns: tuple   # its columns below B N, each (scene, target)
    chunks: tuple    # per chunk (first source, consumer group, stage, the stage's use)


def resident_schedule(batch: int, n: int, sms: int = 132, blocks_per_sm: int = 1,
                      stages: int = 2) -> list:
    """Kernel B's resident main kernel's static schedule over B = batch
    scenes of n nodes, on `sms` multiprocessors: the grid of
    min(tiles, sms * blocks_per_sm) persistent blocks, block k taking tiles
    k, k + grid, ...; a tile's chunks of 8 sources loaded in order through
    the block's ring (chunk t of the block's sequence into stage t % stages,
    its (t // stages)-th use; chunks stages and later by the group that
    frees the stage) and consumed by group ch % 2. A pure mirror of
    edge_attention_bf16_persistent's loops: the tests walk it."""
    cols = batch * n
    ntiles = -(-cols // B_TILE_COLS)
    nch = -(-n // B_CHUNK_SOURCES)
    grid = min(ntiles, sms * blocks_per_sm)
    out = []
    for block in range(grid):
        t = 0
        for tile in range(block, ntiles, grid):
            c0 = tile * B_TILE_COLS
            columns = tuple(divmod(c, n) for c in range(c0, min(c0 + B_TILE_COLS, cols)))
            chunks = []
            for ch in range(nch):
                chunks.append((ch * B_CHUNK_SOURCES, ch % 2, t % stages, t // stages))
                t += 1
            out.append(ResidentTile(block, tile, columns, tuple(chunks)))
    return out


def resident_column_plan(n: int) -> tuple:
    """How kernel B's resident main kernel splits one column's n sources:
    for each of the 8 consumer warps (4 group + warp), the sources it folds
    into its online softmax, in order (chunk ch to group ch % 2, sources
    8 ch + 2 warp and + 1 to warp `warp`); then the merge: warps 0, 2, 4, 6
    summed in that order, 1, 3, 5, 7 likewise, and the two sums added. A
    function of n alone, so a column computes the same in any batch."""
    split = [[] for _ in range(8)]
    for ch in range(-(-n // B_CHUNK_SOURCES)):
        for warp in range(4):
            for hh in range(2):
                i = ch * B_CHUNK_SOURCES + 2 * warp + hh
                if i < n:
                    split[4 * (ch % 2) + warp].append(i)
    return tuple(tuple(x) for x in split), ((0, 2, 4, 6), (1, 3, 5, 7))


def tiled_fold(variant: str, d: int, n_head: int) -> bool:
    """Whether the tiled route folds keys and values: kernel A from a head
    width of 8 (fusion_tiled.cuh Layout::FOLD). Below it the fold saves
    less than a factor of 8 and its folded keys take B N D^2 / dh floats;
    kernel B never folds (its bf16 rounding of mem before Wk and Wv is what
    the JAX bf16 mode computes)."""
    return variant == "float32" and d // n_head >= 8


def kernel_names(variant: str, d: int, e: int, n_head: int) -> tuple:
    """The library's kernels, in the order its attrs function reports them
    (kernels_of in csrc/fusion_attention*.cu)."""
    bf = variant == "bfloat16"
    if kernel_layout(d, e, n_head) == "resident":
        return (("token_proj bf16 node", "token_proj float32 node", "main bf16 edge",
                 "main float32 edge", "out_proj") if bf else ("token_proj", "main", "out_proj"))
    # kernel A's per-token products run on token products, kernel B's on
    # the per-token kernels of the resident layout
    names = ["token_proj bf16 node", "token_proj float32 node", "cast bf16 edge",
             "cast float32 edge"] if bf else ["token_proj"]
    fold = tiled_fold(variant, d, n_head)
    if fold:
        names.append("fold_keys")
    names.append("product memory")
    if d > EPI_MAX:
        names.append("memory pass")
    if e <= EPI_MAX:
        names += ["product edge bf16 edge", "product edge float32 edge"] if bf else \
            ["product edge"]
    else:
        names += ["product edge"] + (["edge pass bf16 edge", "edge pass float32 edge"] if bf
                                     else ["edge pass"])
    if fold:
        names += ["logits fold", "softmax", "context fold", "fold_values"]
    elif logits_epilogue(variant, d, n_head):
        names += ["product keys", "product values", "softmax", "attention"]
    else:
        names += ["product keys, values", "logits", "softmax", "attention"]
    return tuple(names + ["out_proj"])


def logits_epilogue(variant: str, d: int, n_head: int) -> bool:
    """Whether the tiled route's key product writes the logits in its
    epilogue (fusion_tiled.cuh Layout::EPI_LOGITS_OK): unfolded, where no
    head straddles two tiles (bf16: the head width divides the tile's 64 or
    128 columns; float32: it divides a thread's 4 adjacent columns). Else
    the key product writes k and a pass takes the logits from it."""
    dh = d // n_head
    if variant == "bfloat16":
        return (64 if d <= 64 else 128) % dh == 0
    return not tiled_fold(variant, d, n_head) and 4 % dh == 0


def kernel_smem(variant: str, d: int, e: int, n_head: int) -> SmemLayout:
    """The shared memory and scratch of the library of `variant` at (d, e,
    n_head), computed as its sources compute them (LayoutA in
    csrc/fusion_attention.cu, LayoutB in csrc/fusion_attention_bf16.cu,
    tiled::Layout in csrc/fusion_tiled.cuh, and the per-token kernels'
    static arrays in csrc/fusion_common.cuh). A pure function: the loader
    holds each library's own numbers to it, and the tests walk it over any
    grid."""
    bf = variant == "bfloat16"
    layout = kernel_layout(d, e, n_head)
    fold = layout == "resident" and not bf
    dp = _round_up(d, 16)
    kc = dp if dp * _TOK * 4 * (2 if fold else 1) <= 40960 else _TOKEN_KC
    token_proj = _TOK * kc * 4 + (_TOK * dp * 4 if fold else 0)
    if fold:
        tk = _TOK // 2 if (_TOK * n_head + _TOK) * d * 4 > STATIC_LIMIT else _TOK
        out_proj = tk * n_head * d * 4 + tk * kc * 4
    else:
        out_proj = _TOK * kc * 4
    if layout == "resident":
        if bf:   # LayoutB: the persistent kernel, everything in dynamic shared memory
            tj = B_TILE_COLS
            dynamic, stages = _layout_b(d, e, n_head)
            static = (token_proj, 0, out_proj)
            return SmemLayout(layout, "resident", tj, dynamic, static, 0, fold,
                              (tj * B_CHUNK_SOURCES, tj, stages), "", (), 1)
        # LayoutA: Wm_e, We, two chunk buffers, the folded keys, the logits
        tj = 4 if n_head * d > 1024 else 8
        r = 8 * tj
        dynamic = 4 * (2 * e * d + 2 * r * max(d, e) + tj * n_head * d + r * n_head)
        # token_proj, the main kernel (its column offsets), out_proj
        static = (token_proj, 12 * tj, out_proj)
        return SmemLayout(layout, "resident", tj, dynamic, static, 0, fold, (), "", ())
    fold = tiled_fold(variant, d, n_head)
    epi_mem, epi_edge = d <= EPI_MAX, e <= EPI_MAX
    bn_d = 64 if d <= 64 else 128
    bn_e = 64 if e <= 64 else 128
    bn = max(bn_d, bn_e)
    ldm = _round_up(max(d, e), 8) if bf else _round_up(d, 4)
    need_s = not epi_mem or not epi_edge or not fold
    pair_bytes = (_round_up(max(d, e), 4) * 4 if need_s else 0, ldm * (2 if bf else 4),
                  n_head * 4)
    dynamic = (_H_STAGES * (_H_A_BYTES + _H_BK * bn * 2) + 1024) if bf else \
        _F_STAGES * (TILE_PAIRS * 20 + 16 * bn) * 4
    # the per-token products: tiles of 64 rows by the least of 8, 16, 32, 64
    # columns that holds the heads (the fold's logits and context), the
    # columns of a head (the folded values) or D (the folded keys, sp, tp,
    # q and the output product); _Q_K k a step, each row padded by 4 floats
    def fold_static(cols):
        tn = next(t for t in (8, 16, 32, 64) if cols <= t or t == 64)
        return _Q_K * (64 + 4) * 4 + _Q_K * (tn + 4) * 4

    per_kernel = {"token_proj": fold_static(d), "out_proj": out_proj if bf else fold_static(d),
                  "token_proj bf16 node": token_proj, "token_proj float32 node": token_proj,
                  "logits fold": fold_static(n_head), "context fold": fold_static(n_head),
                  "fold_keys": fold_static(d), "fold_values": fold_static(d // n_head)}
    static = tuple(per_kernel.get(k, _MBARRIERS if bf and k.startswith("product") else 0)
                   for k in kernel_names(variant, d, e, n_head))
    return SmemLayout(layout, "epilogue" if epi_mem else "row pass", 0, dynamic, static,
                      sum(pair_bytes), fold, (TILE_PAIRS, bn, _H_STAGES if bf else _F_STAGES),
                      "epilogue" if epi_edge else "row pass", pair_bytes)


def pair_scratch_bytes(variant: str, d: int, e: int, n_head: int, batch: int, n: int) -> int:
    """Bytes of the tiled route's pair scratch for a call over B = batch
    scenes of n nodes (B n^2 pairs, B n tokens): S, M and L a pair and the
    softmax statistics (8 bytes a token and head), each 256-byte aligned, as
    tiled::pair_scratch_bytes computes it; 0 in the resident layout."""
    pair_bytes = kernel_smem(variant, d, e, n_head).pair_bytes
    if not pair_bytes:
        return 0
    pairs, tokens = batch * n * n, batch * n
    return sum(_round_up(pairs * x, 256) for x in pair_bytes) + \
        _round_up(tokens * n_head * 8, 256)


def check_domain(d: int, e: int, n_head: int) -> None:
    """Raise ValueError, before anything is built or launched, where
    kernel_domain refuses (d, e, n_head)."""
    why = kernel_domain(d, e, n_head)
    if why is not None:
        raise ValueError(f"fused_edge_attention on the card: {why}")


def _qk_scale(d: int, n_head: int) -> float:
    """1 / sqrt(dh) as the JAX kernel computes it: jnp.float32(1.0 / dh**0.5)."""
    return float(np.float32(1.0 / (d // n_head) ** 0.5))


def _library_path(name: str, shape=None) -> Path:
    files = _SRCS[name]
    h = hashlib.sha256(b"".join(f.read_bytes() for f in files))
    tag = "" if shape is None else "_{}x{}x{}".format(*shape)
    return _BUILD_DIR / f"lib{files[0].stem}{tag}_{h.hexdigest()[:12]}.so"


def _nvcc_defines(shape) -> list:
    d, e, n_head = shape
    return [f"-DFUSION_D={d}", f"-DFUSION_E={e}", f"-DFUSION_NH={n_head}",
            f"-DFUSION_QK_SCALE={_qk_scale(d, n_head)!r}"]


def compile_kernels(shapes=(FULL_WIDTH,), variants=VARIANTS) -> dict:
    """Compile the graph-control library (csrc/graph_control.cu) and, for
    each (D, E, heads) in `shapes` and each of `variants`, that shape's
    fusion library, where it is missing (once per source hash; one nvcc per
    library, all side by side); returns {"graph_control": path,
    (variant, shape): path}. Records each build's seconds and nvcc's report
    in build_kernels.seconds and build_kernels.log. Runs nvcc only: it
    neither loads a library nor touches a card, so a process can build for
    others it starts (parallel/launch.py). Raises ValueError for a shape
    outside the domain, and on any build failure."""
    shapes = [tuple(int(x) for x in sh) for sh in shapes]
    for sh in shapes:
        check_domain(*sh)
    targets = {"graph_control": ("graph_control", None)}
    targets.update({(v, sh): (v, sh) for sh in shapes for v in variants})
    paths = {k: _library_path(*t) for k, t in targets.items()}
    missing = [k for k, path in paths.items() if not path.exists()]
    if missing:
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the fusion kernels cannot be built")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for k in missing:
            name, sh = targets[k]
            tmp = paths[k].with_suffix(f".{os.getpid()}.tmp")
            defines = [] if sh is None else _nvcc_defines(sh)
            procs[k] = (tmp, subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, *defines, "-o", str(tmp), str(_SRCS[name][0])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        failed = []
        for k, (tmp, proc) in procs.items():
            err = proc.communicate()[1]
            label = k if k == "graph_control" else "{} {}/{}/{}".format(k[0], *k[1])
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {label} ({proc.returncode}):\n{err}")
                continue
            build_kernels.seconds[label] = time.perf_counter() - t0
            build_kernels.log[label] = err
            os.replace(tmp, paths[k])
        if failed:
            raise RuntimeError("\n".join(failed))
    return paths


_ARGTYPES = {"float32": [ctypes.c_void_p] * 30 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
             "bfloat16": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_void_p] * 28 + [ctypes.c_int] * 4 + [ctypes.c_void_p]}
_ENTRY = {"float32": "fused_edge_attention_f32", "bfloat16": "fused_edge_attention_bf16"}
_SHAPE_FN = {"float32": "fused_edge_attention_shape",
             "bfloat16": "fused_edge_attention_bf16_shape"}
_ATTRS_FN = {"float32": "fused_edge_attention_attrs", "bfloat16": "fused_edge_attention_bf16_attrs"}
_SCRATCH_FN = {"float32": "fused_edge_attention_scratch",
               "bfloat16": "fused_edge_attention_bf16_scratch"}
_MAX_KERNELS = 16
_LIBS = {}   # (variant, shape) -> loaded library


def _load(variant, shape, path):
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, _ENTRY[variant])
    fn.argtypes, fn.restype = _ARGTYPES[variant], ctypes.c_int
    built = (ctypes.c_int * 16)()
    getattr(lib, _SHAPE_FN[variant])(built)
    if tuple(built[:3]) != shape:
        raise RuntimeError(f"{path.name} is built for {tuple(built[:3])}, not {shape}")
    # {bytes, 0 resident / 1 tiled, columns a block, fold, tile rows, tile
    # columns, stages, epilogue LayerNorms (1 memory, 2 edge), S, M, L a pair}
    # and, from kernel B's library, blocks a multiprocessor (kernel A's
    # library writes none: 0)
    (lib.smem_bytes, layout, lib.tj, fold, rows, cols, stages, epi, *pair) = built[3:14]
    lib.pair_bytes, lib.scratch_bytes = tuple(pair), sum(pair)
    mirror = kernel_smem(variant, *shape)
    own = (("resident", "tiled")[layout], lib.tj, lib.smem_bytes, bool(fold),
           (rows, cols, stages) if layout or rows else (), lib.pair_bytes if layout else (),
           (("row pass", "epilogue")[epi & 1], ("row pass", "epilogue")[epi >> 1])
           if layout else ("resident", ""), built[14])
    want = (mirror.layout, mirror.tj, mirror.dynamic, mirror.fold, mirror.tile,
            mirror.pair_bytes, (mirror.regime, mirror.edge_ln), mirror.blocks)
    if own != want:
        raise RuntimeError(f"{path.name}'s layout (layout, columns a block, shared memory, "
                           f"fold, tile, scratch a pair, LayerNorms, blocks a "
                           f"multiprocessor) {own} is not its mirror's {want}")
    scratch_fn = getattr(lib, _SCRATCH_FN[variant])
    scratch_fn.argtypes, scratch_fn.restype = [ctypes.c_longlong] * 2, ctypes.c_longlong
    for b, n in ((1, 1), (3, 40), (8, 129)):
        if scratch_fn(b, n) != pair_scratch_bytes(variant, *shape, b, n):
            raise RuntimeError(f"{path.name}'s pair scratch at B = {b}, N = {n} is "
                               f"{scratch_fn(b, n)} B, its mirror's "
                               f"{pair_scratch_bytes(variant, *shape, b, n)}")
    _LIBS[(variant, shape)] = lib
    return lib


def build_kernels(shapes=(FULL_WIDTH,)) -> dict:
    """Compile (compile_kernels) and load both variants' libraries for each
    (D, E, heads) in `shapes`; returns {(variant, shape): CDLL}. Raises on
    any build failure; never returns a library that did not build."""
    shapes = [tuple(int(x) for x in sh) for sh in shapes]
    keys = [(v, sh) for sh in shapes for v in VARIANTS]
    if any(k not in _LIBS for k in keys):
        paths = compile_kernels(shapes)
        for k in keys:
            if k not in _LIBS:
                _load(*k, paths[k])
    return {k: _LIBS[k] for k in keys}


build_kernels.log = {}       # library -> nvcc's report (ptxas: registers, spills)
build_kernels.seconds = {}   # library -> seconds from its build's start to its end


def kernel_library(variant: str, shape) -> ctypes.CDLL:
    """The loaded library of `variant` at (D, E, heads) `shape`, built at
    first use. Raises ValueError outside the domain, before any build."""
    shape = tuple(int(x) for x in shape)
    lib = _LIBS.get((variant, shape))
    if lib is None:
        check_domain(*shape)
        lib = _load(variant, shape, compile_kernels((shape,), (variant,))[(variant, shape)])
    return lib


def kernel_attrs(variant: str, shape) -> dict:
    """{kernel: {"static", "local", "regs"}} of the library of `variant` at
    `shape` (built and loaded at first use), named by kernel_names: each
    kernel's static shared memory, local memory (spills and stack) in bytes
    and registers a thread, as cudaFuncGetAttributes gives them. Needs a
    card."""
    lib = kernel_library(variant, shape)
    names = kernel_names(variant, *shape)
    out = (ctypes.c_int * (3 * _MAX_KERNELS))()
    count = getattr(lib, _ATTRS_FN[variant])(out)
    if count < 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {-count}")
    if count != len(names):
        raise RuntimeError(f"the library reports {count} kernels, its mirror names {names}")
    return {k: {"static": out[3 * i], "local": out[3 * i + 1], "regs": out[3 * i + 2]}
            for i, k in enumerate(names)}


def _scratch(lib, batch, n, dev):
    """The tiled route's pair scratch for a call over `batch` scenes of `n`
    nodes (pair_scratch_bytes, which the loader held the library to), or
    None where the library has none (the resident layout)."""
    if not lib.scratch_bytes:
        return None
    pairs, tokens = batch * n * n, batch * n
    nbytes = sum(_round_up(pairs * x, 256) for x in lib.pair_bytes) + \
        _round_up(tokens * lib.pair_bytes[2] * 2, 256)
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


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


_EDGE_VECTORS = ("be", "ln_e1_g", "ln_e1_b", "ln_e2_g", "ln_e2_b")


def weight_shape(name: str, d: int, e: int) -> tuple:
    """Shape of FusionWeights field `name` at node width d, edge width e, as
    the JAX layer declares it: wm_e [E, D], we [D, E], the other matrices
    [D, D]; be and the two edge LayerNorms [E], the other vectors [D]."""
    if name == "wm_e":
        return (e, d)
    if name == "we":
        return (d, e)
    if name.startswith("w"):
        return (d, d)
    return (e,) if name in _EDGE_VECTORS else (d,)


def _check_call(node, edge, key_mask, w, n_head, node_types, edge_types, weight_types):
    """The launchers' checks, in order: the domain (ValueError before any
    build or launch), then every tensor's device, type, shape, contiguity
    and alignment. Returns (B, N, D, E)."""
    if node.dim() != 3 or edge.dim() != 4:
        raise ValueError(f"node must be [B, N, D] and edge [B, N, N, E], got "
                         f"{tuple(node.shape)} and {tuple(edge.shape)}")
    B, N, D = node.shape
    E = edge.shape[-1]
    check_domain(D, E, n_head)
    dev = node.device
    _check("node", node, (B, N, D), node_types, dev)
    _check("edge", edge, (B, N, N, E), edge_types, dev)
    _check("key_mask", key_mask, (B, N), (torch.bool,), dev)
    for name, t in w._asdict().items():
        _check(name, t, weight_shape(name, D, E), weight_types, dev)
    return B, N, D, E


def _raise_for(err, lib, variant):
    if err == -1:   # ERR_SMEM: nothing was launched
        raise ValueError(f"fused_edge_attention ({variant}): the layout's {lib.smem_bytes} B "
                         f"of shared memory exceed this device's opt-in limit")
    if err == -2:   # ERR_TMA: the pair steps were not launched
        raise RuntimeError(f"fused_edge_attention ({variant}): a TMA tensor map could not be "
                           f"encoded (libcuda has no cuTensorMapEncodeTiled, or it refused "
                           f"the map)")
    if err != 0:
        raise RuntimeError(f"fused_edge_attention ({variant}) launch failed: CUDA error {err}")


def _launched(variant):
    fused_edge_attention.launches += 1
    fused_edge_attention.launches_by_variant[variant] += 1


def _launch_f32(node, edge, key_mask, w, n_head, update_edge):
    f32 = (torch.float32,)
    B, N, D, E = _check_call(node, edge, key_mask, w, n_head, f32, f32, f32)
    lib = kernel_library("float32", (D, E, n_head))
    dev = node.device
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    out = new(B, N, D)
    edge_out = torch.empty_like(edge) if update_edge else edge
    # per-token scratch of the call: projections, then the folded keys and
    # per-head softmax-weighted memory where it folds, or q and the
    # attention sum; the tiled route's pair scratch
    fold = kernel_layout(D, E, n_head) == "resident" or tiled_fold("float32", D, n_head)
    per_token = (n_head, D) if fold else (D,)
    sp, tp, qk, ctx = new(B * N, D), new(B * N, D), new(B * N, *per_token), new(B * N, *per_token)
    scratch = _scratch(lib, B, N, dev)
    # the launch and its cudaFuncSetAttribute apply to the current device:
    # make it the tensors' one
    with torch.cuda.device(dev):
        err = lib.fused_edge_attention_f32(
            node.data_ptr(), edge.data_ptr(), key_mask.data_ptr(),
            *(t.data_ptr() for t in w),
            sp.data_ptr(), tp.data_ptr(), qk.data_ptr(), ctx.data_ptr(),
            out.data_ptr(), edge_out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            B, N, int(update_edge), torch.cuda.current_stream(dev).cuda_stream)
    _raise_for(err, lib, "float32")
    _launched("float32")
    return out, edge_out


def _launch_bf16(node, edge, key_mask, w, n_head, update_edge):
    bf16, f32 = torch.bfloat16, torch.float32
    # weights, biases and LayerNorm parameters as the bf16 network holds them
    B, N, D, E = _check_call(node, edge, key_mask, w, n_head, (bf16, f32), (bf16, f32),
                             (bf16,))
    lib = kernel_library("bfloat16", (D, E, n_head))
    dev = node.device
    new = lambda *s: torch.empty(s, dtype=f32, device=dev)
    out = new(B, N, D)
    write_cast = not update_edge and edge.dtype != f32
    edge_out = new(B, N, N, E) if update_edge or write_cast else edge
    sp, tp, q, attn = (new(B * N, D) for _ in range(4))
    scratch = _scratch(lib, B, N, dev)
    with torch.cuda.device(dev):   # as in _launch_f32
        err = lib.fused_edge_attention_bf16(
            node.data_ptr(), int(node.dtype == bf16), edge.data_ptr(), int(edge.dtype == bf16),
            key_mask.data_ptr(),
            *(t.data_ptr() for t in w),
            sp.data_ptr(), tp.data_ptr(), q.data_ptr(), attn.data_ptr(),
            out.data_ptr(), edge_out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            B, N, int(update_edge), int(write_cast), torch.cuda.current_stream(dev).cuda_stream)
    _raise_for(err, lib, "bfloat16")
    _launched("bfloat16")
    return out, edge_out


def fused_edge_attention(node, edge, key_mask, w: FusionWeights, n_head: int,
                         update_edge: bool = True):
    """Fused layer core; the variant follows the type of `w.wm_e`.

    float32 weights: CPU tensors run `fused_edge_attention_ref`, CUDA tensors
    launch the float32 kernel (float32 everywhere). With `update_edge=False`
    the input edge is returned as it is (no copy).

    bfloat16 weights: CPU tensors run `fused_edge_attention_bf16_ref`, CUDA
    tensors launch the tensor-core kernel (node and edge bfloat16 or float32).
    Both outputs are float32; with `update_edge=False` a float32 input edge is
    returned as it is and a bfloat16 one is written out as float32.

    A CUDA tensor launches its kernel or raises on anything it does not take:
    ValueError, before any build or launch, for widths outside
    `kernel_domain` (the JAX function's own domain). Under grad mode, with an input or weight that requires grad, the call
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
                               variant: str = "float32", n_head: int = 8,
                               e: int | None = None) -> int:
    """Operations of one call (2 per multiply-add), from its shapes: node
    width d, edge width e (d where not given), n_head heads; LayerNorm and
    softmax are counted as lower order terms.

    "float32" counts the folded form, the least work that computes the
    function: per (i, j) pair the [e x d] memory product (and the [d x e]
    edge update) plus the per-head logit and weighted-memory sums (2 n_head
    d), and six [d x d] products per token (Wm_s, Wm_t, Wq, the folded keys,
    Wv, Wo). "bfloat16" counts the form its kernel and the TPU kernel run:
    per pair the memory product, the edge update, the two [d x d] key and
    value products and the q.k and attention.v sums (4 d), and four [d x d]
    products per token. "unfolded" is that count for the float32 function,
    kept for comparison."""
    e = d if e is None else e
    pairs = batch * n * n
    tokens = batch * n
    edge_macs = e * d * (2 if update_edge else 1)
    if variant == "float32":
        pair_macs = edge_macs + 2 * n_head * d
        return 2 * (pair_macs * pairs + 6 * d * d * tokens) + 4 * pairs * d
    if variant not in ("bfloat16", "unfolded"):
        raise ValueError(variant)
    return 2 * ((edge_macs + 2 * d * d) * pairs + 4 * d * d * tokens) + 4 * pairs * d


def fused_edge_attention_bytes(batch: int, n: int, d: int, update_edge: bool,
                               edge_bytes: int = 4, node_bytes: int = 4,
                               weight_bytes: int = 4, e: int | None = None) -> int:
    """Bytes that one call must move: inputs read once, outputs written once
    (float32 outputs), weights included, at node width d and edge width e (d
    where not given). The defaults are the float32 variant; the bf16 variant
    has 2-byte weights and a 2- or 4-byte node and edge, and writes a float32
    edge whenever it updates or casts it. The weights counted are Wm_e
    [e x d], the six [d x d] and the twelve vectors (seven d wide, five e
    wide) at 4 bytes; We [d x e], read with the edge update, is left out, as
    in every count recorded since the kernels were written (at 128 wide 0.4%
    of a B = 1 call, 0.05% of B = 8)."""
    e = d if e is None else e
    pairs = batch * n * n * e
    edge_out = pairs * 4 if update_edge or edge_bytes != 4 else 0
    node = batch * n * d * (node_bytes + 4)
    weights = (e * d + 6 * d * d) * weight_bytes + (7 * d + 5 * e) * 4
    return pairs * edge_bytes + edge_out + node + batch * n + weights
