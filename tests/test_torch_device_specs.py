"""The table of the cards' peak rates (mind_tpu_torch/utils/device_specs.py)
that chip_smoke.py's bounds and the benchmark's MFU divide by: a known card
by the name nvidia-smi and torch report, and an unknown one raising with
its name."""

import pytest

from mind_tpu_torch.utils import device_specs


@pytest.mark.parametrize("name, bf16, f32, hbm", [
    ("NVIDIA H100 80GB HBM3", 989.4e12, 67e12, 3.35e12),
    ("NVIDIA H100 PCIe", 756e12, 51.2e12, 2.0e12),
])
def test_known_cards(name, bf16, f32, hbm):
    p = device_specs.peaks(name)
    assert (p.bf16_flops, p.f32_flops, p.hbm_bytes) == (bf16, f32, hbm)


def test_unknown_card_raises_and_names_it():
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-80GB"):
        device_specs.peaks("NVIDIA A100-SXM4-80GB")
