"""Hand-written Hopper kernels, each with its plain PyTorch version.

Every Pallas TPU kernel of the JAX package has its counterpart here: the
flash-attention kernel (``repro.kernels.flash_attention``), the Mamba2 SSD
chunk scan (``repro.kernels.ssd_scan``) and the int8 row quantizer
(``repro.kernels.int8_quant``). Two more stand for code the JAX package
leaves to XLA: :mod:`.batchsim_advance`, the compiled batch tier's event
loop (``repro.core.batchsim_compiled``), :mod:`.adamw`, AdamW's update
fused into one pass as XLA fuses it in the reference's jitted train step
(``repro.train.optimizer``), and :mod:`.moe_dispatch`, the MoE layer's
dispatch and combine, which XLA fuses in the reference's ``moe_ffn``
(``repro.models.moe``).
"""
from .adamw import adamw_update, adamw_update_plain
from .flash_attention import flash_attention, flash_attention_plain
from .int8_quant import quantize_int8, quantize_int8_plain
from .moe_dispatch import moe_combine, moe_combine_plain, moe_fill, moe_fill_plain
from .ops import (combine_expert_rows, dequantize_rows, fill_expert_slots, flash_attention_bshd,
                  quantize_rows, ssd_bshp)
from .ref import attention_ref, ssd_ref
from .ssd_scan import ssd_scan, ssd_scan_plain
