"""Load the reference's parameters into the port's models.

The reference's parameter pytree, as nested dicts and tuples of numpy
arrays in its layouts (``wq`` (D, H, hd); blocks stacked over pattern
repetitions, ``blocks[j][...][r]``; an encoder's blocks stacked over its
layers, ``encoder["blocks"][...][r]``), becomes a :class:`Transformer` that
computes the same function. Every subtree of a block (``attn``, ``xattn``,
``cross``, ``ssm``, ``mlp``, ``moe``, the norms) crosses over as it is.
Every array keeps its dtype: a bf16 model's ``ssm`` subtree keeps
``A_log``, ``dt_bias`` and ``D`` in f32, and its ``moe`` router is f32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from .transformer import Transformer


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: reinterpret the bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def _unstack(tree: Dict[str, Any], r: int, device: torch.device) -> Dict[str, Any]:
    return {k: _unstack(v, r, device) if isinstance(v, dict) else _tensor(v[r], device)
            for k, v in tree.items()}


def params_from_jax(np_params: Dict[str, Any], cfg: ModelConfig,
                    device: Optional[torch.device | str] = None) -> Transformer:
    dev = resolve_device(device)
    tensors: Dict[str, Any] = {
        "embed": _tensor(np_params["embed"], dev),
        "final_norm": _tensor(np_params["final_norm"], dev),
    }
    if not cfg.tie_embeddings:
        tensors["head"] = _tensor(np_params["head"], dev)
    pattern = cfg.layout_pattern
    tensors["blocks"] = [
        _unstack(np_params["blocks"][layer % len(pattern)], layer // len(pattern), dev)
        for layer in range(cfg.num_layers)
    ]
    if cfg.is_encoder_decoder:
        enc = np_params["encoder"]
        tensors["encoder"] = {
            "blocks": [_unstack(enc["blocks"], r, dev) for r in range(cfg.encoder_layers)],
            "final_norm": _tensor(enc["final_norm"], dev),
        }
    return Transformer(cfg, tensors)


def zoo_weights_from_jax(model: Any) -> Dict[int, np.ndarray]:
    """A reference ``ExecutableMobileModel``'s per-layer conv weights.

    Read from its ``_weights`` (numpy float32, HWIO, one per ``conv`` /
    ``dwconv`` layer), duck-typed; pass the result as ``weights`` to
    :class:`repro_torch.zoo.ExecutableMobileModel` to get the same function.
    """
    return {int(lid): np.array(w, dtype=np.float32) for lid, w in model._weights.items()}
