"""Peak rates of the CUDA cards the port is measured on, keyed by the name
that `torch.cuda.get_device_name` and `nvidia-smi --query-gpu=name` report.

Rooflines and MFU divide by these: dense bf16 on the tensor cores, float32
outside them, and device-memory bandwidth. The rates hold at the card's
full power limit; a card set below it runs slower under load, so a result
should carry the power limit beside it. A card missing from the table
raises rather than borrowing another card's peaks.
"""

from __future__ import annotations

from typing import NamedTuple


class DevicePeaks(NamedTuple):
    bf16_flops: float   # dense bf16 on the tensor cores, FLOP/s
    f32_flops: float    # float32 outside the tensor cores, FLOP/s
    hbm_bytes: float    # device memory bandwidth, bytes/s


PEAKS = {
    # NVIDIA H100 Tensor Core GPU data sheet, SXM5 column (700 W): 989.4
    # TFLOP/s bf16 dense (1,979 with sparsity), 67 TFLOP/s float32, 3.35 TB/s
    "NVIDIA H100 80GB HBM3": DevicePeaks(989.4e12, 67e12, 3.35e12),
    # the same data sheet, PCIe column (350 W): 756 TFLOP/s bf16 dense
    # (1,513 with sparsity), 51.2 TFLOP/s float32, 2.0 TB/s
    "NVIDIA H100 PCIe": DevicePeaks(756e12, 51.2e12, 2.0e12),
}


def peaks(name: str) -> DevicePeaks:
    """The peak rates of the card called `name`; raises ValueError naming
    the card where the table has no row for it."""
    try:
        return PEAKS[name]
    except KeyError:
        raise ValueError(f"no peak rates for the card {name!r}: add its data sheet's row to "
                         f"mind_tpu_torch/utils/device_specs.py (known: {sorted(PEAKS)})") from None
