"""Hand-written Hopper kernels, each with its plain PyTorch version.

Ported: the flash-attention kernel (``repro.kernels.flash_attention``) and
the Mamba2 SSD chunk scan (``repro.kernels.ssd_scan``).
Not yet ported: ``int8_quant`` (see ROADMAP.md).
"""
from .flash_attention import flash_attention, flash_attention_plain
from .ops import flash_attention_bshd, ssd_bshp
from .ref import attention_ref, ssd_ref
from .ssd_scan import ssd_scan, ssd_scan_plain
