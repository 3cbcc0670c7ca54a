"""Hand-written Hopper kernels, each with its plain PyTorch version.

Ported: the flash-attention kernel (``repro.kernels.flash_attention``).
Not yet ported: ``int8_quant`` and ``ssd_scan`` (see ROADMAP.md).
"""
from .flash_attention import flash_attention, flash_attention_plain
from .ops import flash_attention_bshd
from .ref import attention_ref
