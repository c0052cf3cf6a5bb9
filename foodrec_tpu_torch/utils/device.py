# coding: utf-8
"""Device resolution: `cuda` unless the caller asks for the CPU, and never a
quiet fallback to the CPU when CUDA is asked for and absent."""

import os

import torch


def resolve_device(device="cuda"):
    """`torch.device` for "cuda", "cuda:N" or "cpu"; raises when CUDA is
    requested but `torch.cuda.is_available()` is false. Under a launcher
    that sets LOCAL_RANK (torchrun), "cuda" is this rank's card,
    cuda:LOCAL_RANK % device_count."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; pass "
            "use_gpu: False (or device='cpu') to run on the CPU")
    if (device.type == "cuda" and device.index is None
            and "LOCAL_RANK" in os.environ):
        device = torch.device(
            "cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    return device
