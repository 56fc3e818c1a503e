"""Build both fused edge-attention kernels and hold each against its plain
PyTorch version on the GPU, then time them.

    python3 tools/check_fusion_kernels.py [--reps 20] [--runs 5] [--no-time] [--profile]
        [--products] [--shape D,E,HEADS ...] [--grid] [--batch B ...]
        [--variant float32|bfloat16] [--weights auto|fan_in|unscaled] [--root DIR] [--trace]

Prints each library's build seconds and nvcc's ptxas report (registers,
spills, shared memory), its layout against the Python mirror
(fusion_attention.py::kernel_smem: the route (fold, tile, stages), where the
LayerNorms run, dynamic and static shared memory, the pair scratch of a call
at the shape's B and N) and each kernel's local memory, the max abs error of
each variant at the shape's B and N (chip_smoke.py::widths_batch: B = 8,
N = 129 up to 1024 wide, B = 2 up to 2048, B = 1, N = 33 above) and at a
ragged smaller call for both update_edge values (and both node and edge
types of the bf16 variant), and the time per call from CUDA events (the
median and the spread of --runs runs of --reps calls) with its TFLOP/s
(fused_edge_attention_flops) and share of its bound, at each (D, E, heads)
asked for: the full width 128,128,8 by default, the full width and
chip_smoke.py's widths grid with --grid; at B and N, the float32 plain
version's and kernel's errors against the plain version in float64 beside
each output's largest value. `--batch` replaces the shape's B (N stays
widths_batch's). `--products` times each product of the tiled route alone
(the memory product, the edge update, a key or value product: S = X W over
the call's B N^2 pairs) against torch.matmul on the same operands, with its
error and TFLOP/s. `--profile` splits, per variant, shape, B and case (kernel
A: a float32 edge with and without the edge update; kernel B: a bf16 edge
with it, a float32 edge with and without it), the device time of one call
between token_proj, the main kernel or pair products, the row and softmax
passes and out_proj (torch.profiler). `--trace` builds kernel B's resident
library with its clock64 marks (-DFUSION_TRACE) and splits a consumer
group's cycles a chunk between the steps of its main loop. `--root DIR` imports mind_tpu_torch
(its kernel sources and build directory) from another checkout, such as a
parent commit unpacked with `git archive`, so that one call can time both.
Exits non-zero if a kernel does not build, does not launch or misses its
tolerance. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# --root: mind_tpu_torch from another checkout; chip_smoke.py stays this one's
if "--root" in sys.argv[:-1]:
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--root") + 1]).resolve()))
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
from mind_tpu_torch.ops import fusion_attention as fa  # noqa: E402
from mind_tpu_torch.synthetic import fusion_inputs  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
TOL_MEAN = 1e-4   # kernel B's mean abs error, as chip_smoke.py holds it
# the profile's groups of kernels, by name (the first group that matches)
GROUPS = (("token_proj", ("token_proj_kernel", "TokenProj", "FoldKeys")),
          ("out_proj", ("out_proj_kernel", "OutProj", "FoldValues")),
          ("main kernel or pair products", ("product_f32", "product_bf16",
                                            "edge_attention_f32_kernel",
                                            "edge_attention_bf16")),
          ("row passes", ("mem_pass", "edge_pass", "cast_pass", "logits_pass", "softmax_stats",
                          "attn_pass", "token_product")))


def group_of(name):
    return next((g for g, keys in GROUPS if any(k in name for k in keys)), "other")


def bound_ms(variant, b, n, d, e, h, ue, edge_bytes):
    """The least time of one call on the card (operations or bytes) and what
    bounds it, as chip_smoke.kernel_cases counts it."""
    from mind_tpu_torch.utils import device_specs

    pk = device_specs.peaks(torch.cuda.get_device_name(0))
    flops = fa.fused_edge_attention_flops(b, n, d, ue, variant, h, e=e)
    if variant == "float32":
        nbytes, peak = fa.fused_edge_attention_bytes(b, n, d, ue, e=e), pk.f32_flops
    else:
        nbytes, peak = fa.fused_edge_attention_bytes(b, n, d, ue, edge_bytes, edge_bytes, 2,
                                                     e=e), pk.bf16_flops
    t_ops, t_bytes = 1e3 * flops / peak, 1e3 * nbytes / pk.hbm_bytes
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes"), flops


def time_products(d, e, h, b, n, dev, reps):
    """Each product of the tiled route alone at the call's pairs, against
    torch.matmul of the same operands: max abs error, ms, TFLOP/s."""
    rows = b * n * n
    g = torch.Generator(device="cpu").manual_seed(0)
    for variant in fa.VARIANTS:
        lib = fa.kernel_library(variant, (d, e, h))
        fn = getattr(lib, "fused_edge_attention" + ("" if variant == "float32" else "_bf16")
                     + "_product")
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        dt = torch.float32 if variant == "float32" else torch.bfloat16
        for which, (k, nn) in enumerate(((e, d), (d, e), (d, d))):
            lda = -(-k // 8) * 8
            x = (torch.randn(rows, lda, generator=g) * 0.5).to(dev, dt)
            w = (torch.randn(k, nn, generator=g) * (1 / k) ** 0.5).to(dev, dt)
            c = torch.empty(rows, nn, dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                err = fn(which, x.data_ptr(), lda, w.data_ptr(), c.data_ptr(), nn, rows, stream)
                if err != 0:
                    raise RuntimeError(f"product {which} of {variant} {d}/{e}/{h}: error {err}")

            run()
            torch.cuda.synchronize()
            want = x[:, :k].float() @ w.float()
            err = (c - want).abs().max().item()
            ms = cs.cuda_time_ms(run, reps)
            lib_ms = cs.cuda_time_ms(lambda: x[:, :k] @ w, reps)
            tf = 2 * rows * k * nn / ms / 1e9
            print(f"product {variant} {d}/{e}/{h} #{which} [{rows} x {k}] x [{k} x {nn}]: "
                  f"err {err:.3e} (|max| {want.abs().max().item():.3e}) {ms:.4f} ms "
                  f"{tf:.1f} TFLOP/s; torch.matmul {lib_ms:.4f} ms", flush=True)
            del x, w, c, want
            torch.cuda.empty_cache()



# the steps of kernel B's resident main loop between its trace marks
TRACE_STEPS = ("waiting for the chunk", "edge fragments, memory product",
               "tile rows, memory epilogue", "edge update product, residual",
               "stage release, edge LayerNorm and stores", "key product", "logits",
               "value product, softmax update", "weighted values", "merge")


def trace_resident(shape, batches, dev, reps):
    """Kernel B's resident main kernel built with -DFUSION_TRACE (its source's
    clock64 marks): per B, the cycles a consumer group's first thread spends
    in each step of its chunks (summed over the blocks and divided by the
    group's chunks), for the float32 edge with the edge update."""
    d, e, h = shape
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    path = fa._BUILD_DIR / f"libfusion_trace_{d}x{e}x{h}.so"
    subprocess.run([nvcc, *fa._NVCC_FLAGS, *fa._nvcc_defines(shape), "-DFUSION_TRACE", "-o",
                    str(path), str(fa._SRCS["bfloat16"][0])], check=True, capture_output=True)
    saved = fa._LIBS.pop(("bfloat16", shape), None)
    lib = fa._load("bfloat16", shape, path)
    trace = lib.fused_edge_attention_bf16_trace
    trace.argtypes, trace.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    out = (ctypes.c_ulonglong * 24)()
    nch = -(-129 // 8)
    for b in batches:
        node, edge, mask, w = make_inputs(b, 129, dev, "bfloat16", torch.float32, d, e)
        fa.fused_edge_attention(node, edge, mask, w, h, True)
        torch.cuda.synchronize()
        trace(out, 1)
        for _ in range(reps):
            fa.fused_edge_attention(node, edge, mask, w, h, True)
        torch.cuda.synchronize()
        if trace(out, 1) != 0:
            raise RuntimeError("reading the trace failed")
        ntiles = -(-b * 129 // 8)
        blocks = min(ntiles, torch.cuda.get_device_properties(dev).multi_processor_count)
        tiles = ntiles * reps
        for grp, chunks in ((0, tiles * -(-nch // 2)), (1, tiles * (nch // 2))):
            row = out[12 * grp:12 * grp + 12]
            print(f"trace {d}/{e}/{h} B={b} group {grp}: {row[0] / chunks:.0f} cycles a chunk; "
                  + ", ".join(f"{name} {row[k + 1] / chunks:.0f} ({100 * row[k + 1] / row[0]:.1f}%)"
                              for k, name in enumerate(TRACE_STEPS))
                  + f"; a block's loop {row[0] / (blocks * reps):.0f} cycles on average, "
                  f"{row[11]:.0f} the longest", flush=True)
        del node, edge, w
    fa._LIBS.pop(("bfloat16", shape))
    if saved is not None:
        fa._LIBS[("bfloat16", shape)] = saved


def make_inputs(b, n, dev, variant, edge_dtype, d=128, e=128, fan_in=False):
    w, node, edge = fusion_inputs(b, n, d, dev, e=e, fan_in=fan_in)
    mask = (torch.arange(n, device=dev) < n - 5)[None].expand(b, -1).contiguous()
    if variant == "bfloat16":
        w = fa.FusionWeights(*(t.to(torch.bfloat16) for t in w))
        # as the network calls it: node and edge bf16 in the first layer,
        # both float32 after it
        node, edge = node.to(edge_dtype), edge.to(edge_dtype)
    return node, edge, mask, w


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--runs", type=int, default=5, help="timed runs of --reps calls each")
    ap.add_argument("--batch", type=int, nargs="+", default=None,
                    help="B of the checks, times and profiles (default: widths_batch's)")
    ap.add_argument("--variant", choices=fa.VARIANTS, default=None, help="one variant only")
    ap.add_argument("--root", default=None,
                    help="import mind_tpu_torch from this checkout (read before the imports)")
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--trace", action="store_true",
                    help="kernel B's resident main loop step by step (clock64 marks)")
    ap.add_argument("--products", action="store_true",
                    help="time each product of the tiled route alone")
    ap.add_argument("--shape", nargs="+", default=["128,128,8"],
                    help="(D, E, heads) as D,E,HEADS")
    ap.add_argument("--grid", action="store_true", help="chip_smoke.py's widths grid")
    ap.add_argument("--weights", choices=("auto", "fan_in", "unscaled"), default="auto",
                    help="matrices at 0.08, or scaled by fan-in (fusion_inputs); auto: "
                         "scaled past 512 wide or 64 heads, as chip_smoke.py draws them")
    args = ap.parse_args()
    shapes = [fa.FULL_WIDTH, *cs.WIDTHS_GRID] if args.grid else \
        [tuple(int(x) for x in sh.split(",")) for sh in args.shape]
    if not torch.cuda.is_available():
        print("check_fusion_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = (args.variant,) if args.variant else fa.VARIANTS
    print(f"mind_tpu_torch from {Path(fa.__file__).resolve().parents[2]}", flush=True)
    t = time.perf_counter()
    fa.build_kernels(shapes)
    print(f"built in {time.perf_counter() - t:.1f} s: {fa.build_kernels.seconds}")
    for lib, text in fa.build_kernels.log.items():
        print(f"--- nvcc, {lib} ---\n{text.strip()}")
    failed = False
    for d, e, H in shapes:
        big, n_big = cs.widths_batch(d, e)
        for variant in variants:
            mirror = fa.kernel_smem(variant, d, e, H)
            lib, attrs = fa.kernel_library(variant, (d, e, H)), fa.kernel_attrs(variant, (d, e, H))
            static = max(a["static"] for a in attrs.values())
            ok = lib.smem_bytes == mirror.dynamic and static == max(mirror.static)
            failed |= not ok
            route = ("resident, " + f"{lib.tj} columns a block" if mirror.layout == "resident" else
                     f"tiled, {'fold' if mirror.fold else 'no fold'}, tile {mirror.tile[0]} x "
                     f"{mirror.tile[1]}, {mirror.tile[2]} stages, memory LayerNorm "
                     f"{mirror.regime}, edge LayerNorms {mirror.edge_ln}")
            scratch = fa.pair_scratch_bytes(variant, d, e, H, big, n_big)
            print(f"{variant} {d}/{e}/{H}: {route}; shared memory {lib.smem_bytes} B dynamic "
                  f"(mirror {mirror.dynamic}), {static} B static (mirror {max(mirror.static)}), "
                  f"pair scratch {scratch} B a call at B={big} N={n_big}; "
                  f"{'ok' if ok else 'FAIL'}; kernels {json.dumps(attrs)}", flush=True)
        if args.products and fa.kernel_layout(d, e, H) == "tiled":
            time_products(d, e, H, big, n_big, dev, args.reps)
        fan_in = args.weights == "fan_in" or (args.weights == "auto" and
                                               (max(d, e) > 512 or H > 64))
        refs = {"float32": fa.fused_edge_attention_ref, "bfloat16": fa.fused_edge_attention_bf16_ref}
        calls = [(b, n_big) for b in (args.batch or (big,))]
        timed = {}   # (variant, B, edge type, update_edge) -> cuda_time_spread
        for variant in variants:
            ref = refs[variant]
            edge_types = (torch.float32,) if variant == "float32" else \
                (torch.float32, torch.bfloat16)
            for b, n in calls + [(min(big, 3), 40 if n_big == 129 else 17)]:
                for edge_dtype in edge_types:
                    node, edge, mask, w = make_inputs(b, n, dev, variant, edge_dtype, d, e,
                                                      fan_in)
                    for ue in (True, False):
                        out, edge_out = fa.fused_edge_attention(node, edge, mask, w, H, ue)
                        torch.cuda.synchronize()
                        ref_out, ref_edge = ref(node, edge, mask, w, H, ue)
                        d_out, d_edge = (out - ref_out).abs(), (edge_out - ref_edge).abs()
                        e_out, e_edge = d_out.max().item(), d_edge.max().item()
                        m_out, m_edge = d_out.mean().item(), d_edge.mean().item()
                        ok = e_out < TOL[variant] and e_edge < TOL[variant] and (
                            variant == "float32" or max(m_out, m_edge) < TOL_MEAN)
                        failed |= not ok
                        line = (f"{variant} {d}/{e}/{H} B={b} N={n} "
                                f"node,edge={str(edge_dtype)[6:]} update_edge={ue} "
                                f"{'fan-in' if fan_in else 'unscaled'} weights: "
                                f"err out={e_out:.3e} edge={e_edge:.3e} "
                                f"(mean {m_out:.2e}, {m_edge:.2e}) "
                                f"max|out|={ref_out.abs().max().item():.3e} "
                                f"{'ok' if ok else 'FAIL'}")
                        if variant == "float32" and n == n_big:
                            # the float32 plain version's own error, and the
                            # kernel's, against the plain version in float64
                            w64 = fa.FusionWeights(*(t.double() for t in w))
                            out64 = fa.fused_edge_attention_ref(node.double(), edge.double(),
                                                                mask, w64, H, ue)[0]
                            line += (f" | against float64: plain "
                                     f"{(ref_out - out64).abs().max().item():.3e}, kernel "
                                     f"{(out - out64).abs().max().item():.3e}")
                            del w64, out64
                        if not args.no_time and n == n_big:
                            t = cs.cuda_time_spread(
                                lambda: fa.fused_edge_attention(node, edge, mask, w, H, ue),
                                args.runs, args.reps)
                            ms = t["ms"]
                            timed[(variant, b, edge_dtype, ue)] = t
                            bms, by, flops = bound_ms(variant, b, n, d, e, H, ue,
                                                      edge.element_size())
                            line += (f" | {ms:.4f} ms per call (median of {args.runs} runs "
                                     f"of {args.reps}; {t['lo']:.4f}-{t['hi']:.4f}), "
                                     f"{flops / ms / 1e9:.1f} TFLOP/s, bound {bms:.4f} ms by "
                                     f"{by}: {100 * bms / ms:.1f}% of it")
                        print(line, flush=True)
            # the forward's mix (chip_smoke.kernel_cases' weights: kernel A 5
            # calls with the edge update and 1 without; kernel B the first
            # layer's bf16 edge, 4 float32 edges with the update, 1 without)
            mixes = {"float32": ((torch.float32, True, 5), (torch.float32, False, 1)),
                     "bfloat16": ((torch.bfloat16, True, 1), (torch.float32, True, 4),
                                  (torch.float32, False, 1))}[variant]
            for b, _ in calls:
                cases = [(timed.get((variant, b, dt, ue)), wgt) for dt, ue, wgt in mixes]
                if all(t is not None for t, _ in cases):
                    mix = {k: sum(t[k] * wgt for t, wgt in cases) / sum(w for _, w in cases)
                           for k in ("ms", "lo", "hi")}
                    print(f"mix {variant} {d}/{e}/{H} B={b} N={n_big}: {mix['ms']:.4f} ms "
                          f"(spread {mix['lo']:.4f}-{mix['hi']:.4f})", flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        # kernel A: a float32 edge with and without the edge update; kernel
        # B: as the network calls it, a bf16 edge with the update (the first
        # layer) and a float32 edge with and without it
        cases = {"float32": ((torch.float32, True), (torch.float32, False)),
                 "bfloat16": ((torch.bfloat16, True), (torch.float32, True),
                              (torch.float32, False))}
        for d, e, H in shapes:
            big, n = cs.widths_batch(d, e)
            for b, variant, (edge_dtype, ue) in ((b, v, c) for b in (args.batch or (big,))
                                                 for v in variants for c in cases[v]):
                node, edge, mask, w = make_inputs(b, n, dev, variant, edge_dtype, d, e,
                                                  max(d, e) > 512 or H > 64)
                fa.fused_edge_attention(node, edge, mask, w, H, ue)
                torch.cuda.synchronize()
                reps = max(1, min(args.reps, 5 if max(d, e) > 512 else args.reps))
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        fa.fused_edge_attention(node, edge, mask, w, H, ue)
                    torch.cuda.synchronize()
                by_name = {}
                for ev in prof.events():
                    if ev.device_type == torch.autograd.DeviceType.CUDA:
                        by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                            ev.time_range.elapsed_us()
                by_group = {}
                for name, us in by_name.items():
                    by_group[group_of(name)] = by_group.get(group_of(name), 0.0) + us
                total = sum(by_group.values())
                print(f"profile {variant} {d}/{e}/{H} B={b} N={n} "
                      f"edge={str(edge_dtype)[6:]} update_edge={ue}: "
                      f"{total / reps:.2f} us of device time a call; "
                      + ", ".join(f"{g} {us / reps:.2f} us ({100 * us / total:.1f}%)"
                                  for g, us in sorted(by_group.items(), key=lambda kv: -kv[1])))
                for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
                    print(f"  {us / reps:9.2f}  {name[:110]}")
                del node, edge, w
                torch.cuda.empty_cache()
    if args.trace:
        for sh in shapes:
            if fa.kernel_layout(*sh) == "resident":
                trace_resident(sh, args.batch or (8,), dev, args.reps)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
