"""PyTorch + CUDA port of mind_tpu for NVIDIA Hopper GPUs (see README.md).

Imports torch and numpy only; entry points run on the CUDA card unless the
caller passes device="cpu".
"""
