"""Carry parameters between the reference's pytree and the port's models.

The reference's parameter pytree, as nested dicts and tuples of numpy
arrays in its layouts (``wq`` (D, H, hd); blocks stacked over pattern
repetitions, ``blocks[j][...][r]``; an encoder's blocks stacked over its
layers, ``encoder["blocks"][...][r]``), becomes a :class:`Transformer` that
computes the same function. Every subtree of a block (``attn``, ``xattn``,
``cross``, ``ssm``, ``mlp``, ``moe``, the norms) crosses over as it is.
Every array keeps its dtype: a bf16 model's ``ssm`` subtree keeps
``A_log``, ``dt_bias`` and ``D`` in f32, and its ``moe`` router is f32.

The other way, :func:`param_tree` gives a :class:`Transformer`'s tensors in
the reference's tree, each stacked leaf a :class:`Leaf` of the per-layer
tensors it stacks; :func:`flatten` lists a tree's leaves in JAX's flatten
order (dict keys sorted, tuples in order), the order of the reference's
checkpoints and optimizer states; :func:`params_to_jax` is the inverse of
:func:`params_from_jax`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from .transformer import Block, Transformer


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


@dataclass
class Leaf:
    """One leaf of the reference's tree: its tensor, or the per-layer
    tensors that the reference stacks along a leading axis."""

    tensors: List[torch.Tensor]
    stacked: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        t = tuple(self.tensors[0].shape)
        return (len(self.tensors),) + t if self.stacked else t

    @property
    def dtype(self) -> torch.dtype:
        return self.tensors[0].dtype

    def value(self) -> torch.Tensor:
        """The reference's array: the stack of the tensors, or the tensor."""
        return torch.stack(self.tensors) if self.stacked else self.tensors[0]

    def assign(self, value: torch.Tensor) -> None:
        """Copies ``value`` (the reference's shape) into the tensors in place."""
        if tuple(value.shape) != self.shape:
            raise ValueError(f"shape {tuple(value.shape)} for a leaf of {self.shape}")
        with torch.no_grad():
            if self.stacked:
                for t, row in zip(self.tensors, value):
                    t.copy_(row)
            else:
                self.tensors[0].copy_(value)


def flatten(tree: Any) -> List[Any]:
    """Leaves of a tree of dicts, tuples and lists in JAX's flatten order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in flatten(t)]
    return [tree]


def tree_leaves(tree: Any) -> List[Leaf]:
    """A tree of tensors as :class:`Leaf` objects, in JAX's flatten order."""
    return [t if isinstance(t, Leaf) else Leaf([t]) for t in flatten(tree)]


def _block_tree(blk: Block) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name in ("ln1", "attn", "xattn", "ssm", "ln_cross", "cross", "ln2", "mlp", "moe"):
        value = getattr(blk, name)
        if value is None:
            continue
        out[name] = dict(value.items()) if isinstance(value, torch.nn.ParameterDict) else value
    return out


def _stack(trees: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else Leaf([t[k] for t in trees], stacked=True)
            for k, v in trees[0].items()}


def param_tree(model: Transformer) -> Dict[str, Any]:
    """The model's parameters in the reference's tree: ``blocks`` a tuple
    over pattern positions of stacked :class:`Leaf` trees (repetition r of
    position j is layer ``r·|pattern| + j``), an encoder's blocks stacked
    over its layers; the other leaves are the tensors themselves."""
    cfg = model.cfg
    tree: Dict[str, Any] = {"embed": model.embed, "final_norm": model.final_norm}
    if model.head is not None:
        tree["head"] = model.head
    period = len(cfg.layout_pattern)
    tree["blocks"] = tuple(
        _stack([_block_tree(model.blocks[r * period + j]) for r in range(cfg.pattern_repeats)])
        for j in range(period))
    if model.encoder is not None:
        tree["encoder"] = {
            "blocks": _stack([_block_tree(b) for b in model.encoder.blocks]),
            "final_norm": model.encoder.final_norm,
        }
    return tree


def param_leaves(model: Transformer) -> List[Leaf]:
    """The model's parameters as the reference's leaves, in its flatten order."""
    return tree_leaves(param_tree(model))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bf16 as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_to_jax(model: Transformer) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: the reference's numpy tree,
    blocks restacked per pattern position as ``blocks[j][...][r]``; bf16
    leaves as their uint16 bits (:func:`to_numpy`)."""
    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(conv(v) for v in tree)
        return to_numpy(tree.value() if isinstance(tree, Leaf) else tree)
    return conv(param_tree(model))
