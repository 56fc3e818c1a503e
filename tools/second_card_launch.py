"""Launch both fused edge-attention kernels on the second card while the
first one is the current device, and hold each against its plain version.

    python3 tools/second_card_launch.py [--root DIR]

The tensors live on cuda:1 and torch's current device stays cuda:0, as in a
sequential mesh whose second shard runs on cuda:1. A kernel launch applies
to the current device, so a wrapper that does not make the tensors' device
current fails there (or computes nothing). `--root` runs the package of
another checkout (e.g. a `git archive` of an older commit unpacked under
`_archive/`), so the two can be compared in one call. Prints one JSON line
per variant ({"variant", "ok", "max_abs_err" or "error"}); exits non-zero
if a variant fails or errs, and with 2 on a machine with fewer than two
cards.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

D, N, B, H = 128, 129, 8, 8
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout whose mind_tpu_torch runs")
    args = ap.parse_args(argv)
    if torch.cuda.device_count() < 2:
        print(f"needs two CUDA devices, {torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from mind_tpu_torch.ops import fusion_attention as fa
    from mind_tpu_torch.synthetic import fusion_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    second = torch.device("cuda", 1)
    w, node, edge = fusion_inputs(B, N, D, second)
    mask = (torch.arange(N, device=second) < N - 5)[None].expand(B, -1).contiguous()
    failed = False
    for variant in ("float32", "bfloat16"):
        ref = fa.fused_edge_attention_ref if variant == "float32" else \
            fa.fused_edge_attention_bf16_ref
        row = {"variant": variant, "root": args.root, "current_device": torch.cuda.current_device(),
               "tensors_on": str(second)}
        try:   # a failed launch can poison the context: the next call raises too
            wv = w if variant == "float32" else fa.FusionWeights(
                *(t.to(torch.bfloat16) for t in w))
            with torch.no_grad():
                out, edge_out = fa.fused_edge_attention(node, edge, mask, wv, H)
                torch.cuda.synchronize(second)
                want, want_edge = ref(node, edge, mask, wv, H)
            err = max((out - want).abs().max().item(), (edge_out - want_edge).abs().max().item())
            row.update(ok=err < TOL[variant], max_abs_err=err)
        except Exception as e:   # noqa: BLE001 - the error is the finding
            row.update(ok=False, error=f"{type(e).__name__}: {e}")
        failed |= not row["ok"]
        print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
