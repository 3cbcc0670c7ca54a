"""The four assigned input shapes and per-(arch × shape) input specs
(port of ``repro.launch.shapes``).

:func:`input_specs` returns tensors on the meta device in place of the
reference's ``jax.ShapeDtypeStruct``\\ s: shapes and dtypes (int32 tokens),
no storage. Decode shapes describe the serve step: ONE new token with a
cache of ``seq_len``, the port's :func:`init_cache` on the meta device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..models.transformer import _dtype, init_cache


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# sliding window turned on for the attention archs at long context, so that
# the step stays sub-quadratic (the reference's choice). Its decode ring
# forgets the window once it wraps, in the reference and here alike
# (ROADMAP Queue 3, R4).
LONG_CONTEXT_WINDOW = 8_192


def config_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-specific config adjustments (long-context window)."""
    if shape.name == "long_500k" and cfg.uses_attention and not cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def cross_src_shape(cfg: ModelConfig, batch: int) -> Optional[Tuple[int, ...]]:
    """Stub modality embeddings (the allowed frontend carve-out)."""
    if cfg.arch_type == "vlm":
        return (batch, cfg.num_image_tokens, cfg.d_model)
    if cfg.is_encoder_decoder:
        return (batch, cfg.encoder_seq_len, cfg.d_model)
    return None


def cross_len(cfg: ModelConfig) -> int:
    if cfg.arch_type == "vlm":
        return cfg.num_image_tokens
    if cfg.is_encoder_decoder:
        return cfg.encoder_seq_len
    return 0


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Meta tensors for one (arch, shape) step invocation."""
    cfg = config_for_shape(cfg, shape)
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")
    out: Dict[str, Any] = {}
    if shape.kind == "train":
        out["tokens"] = meta((b, s))
        out["labels"] = meta((b, s))
    elif shape.kind == "prefill":
        out["tokens"] = meta((b, s))
    else:  # decode
        out["token"] = meta((b, 1))
        out["caches"] = init_cache(cfg, b, s, cross_len=cross_len(cfg), device="meta")
        out["cache_len"] = meta(())
    cs = cross_src_shape(cfg, b)
    if cs is not None and shape.kind in ("train", "prefill"):
        out["cross_src"] = meta(cs, _dtype(cfg))
    return out
