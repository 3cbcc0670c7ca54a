"""Checkpointing: msgpack-serialized leaves with atomic writes.

Port of ``repro.train.checkpoint``, file for file interchangeable with it:
the same payload keys (``step``, ``meta``, ``params``, ``opt``), each array
as ``{"dtype", "shape", "data"}`` (bf16 as its uint16 bits under the dtype
name ``bfloat16``), the leaves in JAX's flatten order (dict keys sorted,
tuples in order, ``OptState(step, inner)`` as ``step`` then ``inner``'s
sorted keys), and a write to a temporary file renamed into place. A model's
parameters are its reference leaves (:func:`~repro_torch.models.convert.param_leaves`):
blocks stacked per pattern position. The reference also writes its
``treedef_*`` strings but never reads them; the port writes its own
description of the leaves there. The codec is the port's own
(:mod:`repro_torch.train._msgpack`).
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.convert import Leaf, flatten, param_leaves, to_numpy
from ..models.transformer import Transformer
from . import _msgpack


def _leaves(tree: Any) -> List[Any]:
    """Leaves (tensors or :class:`Leaf`) of a model, a list of leaves, an
    ``OptState`` or a tree of tensors, in JAX's flatten order."""
    if isinstance(tree, Transformer):
        return param_leaves(tree)
    return flatten(tree)


def _value(leaf: Any) -> torch.Tensor:
    return leaf.value() if isinstance(leaf, Leaf) else leaf


def _encode_array(t: torch.Tensor) -> Dict[str, Any]:
    arr = to_numpy(t)
    if t.dtype == torch.bfloat16:
        return {"dtype": "bfloat16", "shape": list(arr.shape), "data": arr.tobytes()}
    return {"dtype": arr.dtype.str, "shape": list(arr.shape), "data": arr.tobytes()}


def _decode_array(d: Dict[str, Any]) -> torch.Tensor:
    shape = tuple(d["shape"])
    if d["dtype"] == "bfloat16":
        raw = np.frombuffer(d["data"], dtype=np.uint16).reshape(shape)
        return torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
    arr = np.frombuffer(d["data"], dtype=np.dtype(d["dtype"])).reshape(shape)
    return torch.from_numpy(arr.copy())


def _describe(leaves: List[Any]) -> str:
    return (f"repro_torch: {len(leaves)} leaves in JAX flatten order, shapes "
            + str([list(x.shape) for x in leaves]))


def save_checkpoint(path: str, params: Any, opt_state: Any = None,
                    step: int = 0, meta: Optional[Dict] = None) -> None:
    flat_p = _leaves(params)
    payload = {
        "step": int(step),
        "meta": meta or {},
        "treedef_params": _describe(flat_p),
        "params": [_encode_array(_value(a)) for a in flat_p],
    }
    if opt_state is not None:
        flat_o = _leaves(opt_state)
        payload["treedef_opt"] = _describe(flat_o)
        payload["opt"] = [_encode_array(_value(a)) for a in flat_o]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(_msgpack.packb(payload))
        os.replace(tmp, path)   # atomic
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _assign(leaf: Any, value: torch.Tensor) -> None:
    if isinstance(leaf, Leaf):
        leaf.assign(value.to(device=leaf.tensors[0].device, dtype=leaf.dtype))
        return
    if tuple(value.shape) != tuple(leaf.shape):
        raise ValueError(f"shape {tuple(value.shape)} for a leaf of {tuple(leaf.shape)}")
    with torch.no_grad():
        leaf.copy_(value.to(device=leaf.device, dtype=leaf.dtype))


def restore_checkpoint(path: str, params_like: Any, opt_state_like: Any = None
                       ) -> Tuple[Any, Any, int, Dict]:
    """Reads ``path`` into ``params_like`` and ``opt_state_like`` in place,
    each array cast to its leaf's dtype, and returns them with the step and
    the metadata."""
    with open(path, "rb") as f:
        payload = _msgpack.unpackb(f.read())
    flat_p = _leaves(params_like)
    arrays = [_decode_array(d) for d in payload["params"]]
    if len(arrays) != len(flat_p):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, structure expects {len(flat_p)}"
        )
    for leaf, a in zip(flat_p, arrays):
        _assign(leaf, a)
    opt_state = None
    if opt_state_like is not None and "opt" in payload:
        flat_o = _leaves(opt_state_like)
        arrays_o = [_decode_array(d) for d in payload["opt"]]
        if len(arrays_o) != len(flat_o):
            raise ValueError(f"checkpoint has {len(arrays_o)} optimizer leaves, "
                             f"structure expects {len(flat_o)}")
        for leaf, a in zip(flat_o, arrays_o):
            _assign(leaf, a)
        opt_state = opt_state_like
    return params_like, opt_state, payload["step"], payload.get("meta", {})
