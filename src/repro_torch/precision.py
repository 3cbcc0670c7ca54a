"""Precision of the zoo models' convolutions, set per thread by an engine.

The counterpart of ``jax.default_matmul_precision``: the ``xnnpack`` engine
runs its subgraphs inside :func:`bf16_convs`, and the zoo models read
:func:`conv_precision` when they build a convolution. A context variable
is per thread, so one Worker's setting never reaches another's.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

_CONV_PRECISION = contextvars.ContextVar("conv_precision", default="highest")


def conv_precision() -> str:
    """``"highest"`` (the operands' own dtype) or ``"bfloat16"``."""
    return _CONV_PRECISION.get()


@contextlib.contextmanager
def bf16_convs() -> Iterator[None]:
    """Compute every zoo convolution inside the block in bf16."""
    token = _CONV_PRECISION.set("bfloat16")
    try:
        yield
    finally:
        _CONV_PRECISION.reset(token)
