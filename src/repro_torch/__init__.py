"""PyTorch port of the model stack, for one NVIDIA H100.

A second package beside ``repro`` (the JAX reference). It imports torch,
numpy and the standard library only; never jax, never ``repro``. Module
names mirror the reference's so each counterpart is easy to find.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :func:`repro_torch.device.resolve_device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
