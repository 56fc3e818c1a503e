"""Build both fused edge-attention kernels and hold each against its plain
PyTorch version on the GPU, then time them.

    python3 tools/check_fusion_kernels.py [--reps 20] [--no-time] [--profile]
        [--shape D,E,HEADS ...] [--grid] [--weights auto|fan_in|unscaled]

Prints each library's build seconds and nvcc's ptxas report (registers,
spills, shared memory), its layout against the Python mirror
(fusion_attention.py::kernel_smem: regime, columns a block, dynamic and
static shared memory, scratch) and each kernel's local memory, the max abs
error of each variant at the shape's B and N (chip_smoke.py::widths_batch:
B = 8, N = 129 up to 1024 wide, B = 2 up to 2048, B = 1, N = 33 above) and
at a ragged smaller call for both update_edge values (and both node and edge
types of the bf16 variant), and the time per call from CUDA events, at each
(D, E, heads) asked for: the full width 128,128,8 by default, the full width
and chip_smoke.py's widths grid with --grid; at B and N, the float32
plain version's and kernel's errors against the plain version in float64
beside each output's largest value. `--profile` adds, per variant, the device
time of each kernel of one call (prologue, main, epilogue and the wrapper's
own small copies) from torch.profiler. Exits non-zero if a kernel does not build,
does not launch or misses its tolerance. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from mind_tpu_torch.ops import fusion_attention as fa  # noqa: E402
from mind_tpu_torch.synthetic import fusion_inputs  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


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
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--profile", action="store_true")
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
    t = time.perf_counter()
    fa.build_kernels(shapes)
    print(f"built in {time.perf_counter() - t:.1f} s: {fa.build_kernels.seconds}")
    for lib, text in fa.build_kernels.log.items():
        print(f"--- nvcc, {lib} ---\n{text.strip()}")
    failed = False
    for d, e, H in shapes:
        for variant in fa.VARIANTS:
            mirror = fa.kernel_smem(variant, d, e, H)
            lib, attrs = fa.kernel_library(variant, (d, e, H)), fa.kernel_attrs(variant, (d, e, H))
            static = max(a["static"] for a in attrs.values())
            ok = lib.smem_bytes == mirror.dynamic and static == max(mirror.static)
            failed |= not ok
            print(f"{variant} {d}/{e}/{H}: {mirror.regime}, {lib.tj} columns a block, "
                  f"shared memory {lib.smem_bytes} B dynamic (mirror {mirror.dynamic}), "
                  f"{static} B static (mirror {max(mirror.static)}), scratch "
                  f"{lib.scratch_bytes} B a block; {'ok' if ok else 'FAIL'}; kernels "
                  f"{json.dumps(attrs)}", flush=True)
        big, n_big = cs.widths_batch(d, e)
        fan_in = args.weights == "fan_in" or (args.weights == "auto" and
                                               (max(d, e) > 512 or H > 64))
        for variant, ref in (("float32", fa.fused_edge_attention_ref),
                             ("bfloat16", fa.fused_edge_attention_bf16_ref)):
            edge_types = (torch.float32,) if variant == "float32" else \
                (torch.float32, torch.bfloat16)
            for b, n in ((big, n_big), (min(big, 3), 40 if n_big == 129 else 17)):
                for edge_dtype in edge_types:
                    node, edge, mask, w = make_inputs(b, n, dev, variant, edge_dtype, d, e,
                                                      fan_in)
                    for ue in (True, False):
                        out, edge_out = fa.fused_edge_attention(node, edge, mask, w, H, ue)
                        torch.cuda.synchronize()
                        ref_out, ref_edge = ref(node, edge, mask, w, H, ue)
                        e_out = (out - ref_out).abs().max().item()
                        e_edge = (edge_out - ref_edge).abs().max().item()
                        ok = e_out < TOL[variant] and e_edge < TOL[variant]
                        failed |= not ok
                        line = (f"{variant} {d}/{e}/{H} B={b} N={n} "
                                f"node,edge={str(edge_dtype)[6:]} update_edge={ue} "
                                f"{'fan-in' if fan_in else 'unscaled'} weights: "
                                f"err out={e_out:.3e} edge={e_edge:.3e} "
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
                            ms = cs.cuda_time_ms(
                                lambda: fa.fused_edge_attention(node, edge, mask, w, H, ue),
                                args.reps)
                            line += f" | {ms:.4f} ms per call"
                        print(line, flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        d, e, H = shapes[0]
        for variant in ("float32", "bfloat16"):
            node, edge, mask, w = make_inputs(8, 129, dev, variant, torch.float32, d, e)
            for ue in (True, False):
                fa.fused_edge_attention(node, edge, mask, w, H, ue)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(args.reps):
                        fa.fused_edge_attention(node, edge, mask, w, H, ue)
                    torch.cuda.synchronize()
                by_name = {}
                for ev in prof.events():
                    if ev.device_type == torch.autograd.DeviceType.CUDA:
                        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us()
                print(f"profile {variant} update_edge={ue}, us per call:")
                for name, us in sorted(by_name.items(), key=lambda kv: -kv[1]):
                    print(f"  {us / args.reps:9.2f}  {name[:90]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
