"""Hand-written Hopper kernels, each with its plain PyTorch version.

Every Pallas TPU kernel of the JAX package has its counterpart here: the
flash-attention kernel (``repro.kernels.flash_attention``), the Mamba2 SSD
chunk scan (``repro.kernels.ssd_scan``) and the int8 row quantizer
(``repro.kernels.int8_quant``). One more stands for the JAX package's
XLA-compiled scheduler loop: :mod:`.batchsim_advance`, the compiled batch
tier's event loop (``repro.core.batchsim_compiled``).
"""
from .flash_attention import flash_attention, flash_attention_plain
from .int8_quant import quantize_int8, quantize_int8_plain
from .ops import dequantize_rows, flash_attention_bshd, quantize_rows, ssd_bshp
from .ref import attention_ref, ssd_ref
from .ssd_scan import ssd_scan, ssd_scan_plain
