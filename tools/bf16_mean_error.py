"""Kernel B's mean error against its plain version beside the plain
version's own spread, on the GPU.

    python3 tools/bf16_mean_error.py

For each shape (512 / 512 / 16, 256 / 256 / 8, 768 / 768 / 12 at B = 8,
N = 129, unscaled weights, the edge update on), with a bf16 and a float32
node and edge: the mean / max abs difference of `out` and of the edge
between the kernel and the plain version on the card, between the plain
version on the CPU and on the card (the spread two summation orders of the
same function give), and between the kernel and the plain version on the
CPU. chip_smoke.py holds kernel B's mean error under 1e-4 with these
weights up to 512 wide. Needs a CUDA device.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mind_tpu_torch.ops import fusion_attention as fa  # noqa: E402
from mind_tpu_torch.synthetic import fusion_inputs  # noqa: E402


def gap(a, b):
    d = (a.double().cpu() - b.double().cpu()).abs()
    return f"{d.mean().item():.2e}/{d.max().item():.1e}"


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_mean_error: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, N, bf = 8, 129, torch.bfloat16
    for d, e, h in ((512, 512, 16), (256, 256, 8), (768, 768, 12)):
        w, node, edge = fusion_inputs(B, N, d, dev, 0, e=e)
        mask = (torch.arange(N, device=dev) < N - 5)[None].expand(B, -1).contiguous()
        w16 = fa.FusionWeights(*(t.to(bf) for t in w))
        w16_cpu = fa.FusionWeights(*(t.cpu() for t in w16))
        for dt in (bf, torch.float32):
            x, ed = node.to(dt), edge.to(dt)
            out, edge_out = fa.fused_edge_attention(x, ed, mask, w16, h, True)
            p_out, p_edge = fa.fused_edge_attention_bf16_ref(x, ed, mask, w16, h, True)
            c_out, c_edge = fa.fused_edge_attention_bf16_ref(x.cpu(), ed.cpu(), mask.cpu(),
                                                             w16_cpu, h, True)
            print(f"{d}/{e}/{h} {str(dt)[6:]} (mean/max): kernel - plain out "
                  f"{gap(out, p_out)} edge {gap(edge_out, p_edge)} | plain on the CPU - "
                  f"plain on the card out {gap(c_out, p_out)} edge {gap(c_edge, p_edge)} | "
                  f"kernel - plain on the CPU out {gap(out, c_out)} edge {gap(edge_out, c_edge)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
