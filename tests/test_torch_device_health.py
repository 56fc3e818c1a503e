"""The card's health probe (mind_tpu_torch/utils/device_health.py, the
counterpart of mind_tpu/utils/tpu_health.py): a fresh subprocess that must
print its marker within the timeout."""

import time

import torch

from mind_tpu_torch.utils import device_health


def test_probe_is_false_without_a_card():
    assert device_health.probe_once() is torch.cuda.is_available()


def test_probe_reads_the_marker(monkeypatch):
    monkeypatch.setattr(device_health, "_PROBE_CODE", "print('PROBE_OK', 1.0)")
    assert device_health.probe_once(timeout_s=60) is True
    monkeypatch.setattr(device_health, "_PROBE_CODE", "print('something else')")
    assert device_health.probe_once(timeout_s=60) is False


def test_hanging_probe_is_killed_at_its_timeout(monkeypatch):
    monkeypatch.setattr(device_health, "_PROBE_CODE", "import time; time.sleep(120)")
    t = time.perf_counter()
    assert device_health.probe_once(timeout_s=1.0) is False
    assert time.perf_counter() - t < 30
