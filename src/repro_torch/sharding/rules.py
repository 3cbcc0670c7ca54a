"""Logical-axis → mesh-axis sharding rules (port of ``repro.sharding.rules``).

Parameters carry *logical axis* names (``repro_torch.models.*_spec``); this
module resolves them to :class:`PartitionSpec`\\ s for a mesh, with the
reference's divisibility checks and choices:

* ``ffn`` / ``vocab`` / ``experts`` / ``ssm_inner`` → tensor-parallel over
  the "model" axis;
* ``heads`` → "model" when the head count divides the axis, else replicate.
  There is deliberately no fallback to sharding ``head_dim`` (see
  :func:`spec_for_shape`);
* ``embed`` → FSDP storage sharding over the data axes ("pod", "data");
* ``layers`` (the stacked axis of the reference's tree) → never sharded.

A :class:`PartitionSpec` is a tuple, one entry per tensor dim: a mesh axis
name, a tuple of names, or None. It compares equal, as a tuple, to the
reference's ``jax.sharding.PartitionSpec``. :func:`placements` turns one into
``torch.distributed.tensor`` placements (``Shard(d)``, ``Replicate()``) for
a ``DeviceMesh`` with the reference's axis names. Every function takes the
mesh as a ``DeviceMesh`` or as a mapping of axis name → size; the rules
read nothing else of it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

# preference-ordered candidate mesh axes per logical axis
DEFAULT_RULES: Dict[Optional[str], Tuple[Any, ...]] = {
    "embed": (("pod", "data"), ("data",)),
    "vocab": (("model",),),
    "ffn": (("model",),),
    "experts": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "head_dim": (),
    "ssm_inner": (("model",),),
    "ssm_heads": (("model",),),
    "layers": (),
    None: (),
}


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis, a tuple of axes, or None."""

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """Axis name → size of a ``DeviceMesh`` (or of a mapping, as given)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes_size(shape: Mapping[str, int], axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def spec_for_shape(
    logical: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh: Any,
    rules: Optional[Dict] = None,
) -> PartitionSpec:
    """Resolve one leaf's logical axes to a PartitionSpec."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_shape(mesh)
    used: set = set()
    out = []
    # When `heads` cannot shard over the model axis, head_dim is NOT sharded
    # in its place: a head_dim-sharded QK^T contraction all-reduces the score
    # tensors (the reference measured 22 TB per prefill_32k step on
    # qwen2.5-32b). Attention weights replicate over "model" instead, and
    # FSDP over the data axes still shards their storage.
    for name, dim in zip(logical, shape):
        assigned = None
        for cand in rules.get(name, ()):
            cand = tuple(cand)
            if any(a in used for a in cand) or any(a not in sizes for a in cand):
                continue
            n = _axes_size(sizes, cand)
            if dim % n == 0 and dim >= n:
                assigned = cand
                used.update(cand)
                break
        out.append(assigned[0] if assigned is not None and len(assigned) == 1
                   else (assigned if assigned else None))
    while out and out[-1] is None:       # trailing Nones, as the reference trims them
        out.pop()
    return P(*out)


def is_spec_leaf(x: Any) -> bool:
    """A tuple of axis names (or None): one leaf of a spec tree."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def map_tree(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts, tuples and lists (spec
    tuples are leaves), with ``rest`` trees of the same structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not is_spec_leaf(tree):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as ``jax.sharding.NamedSharding`` pairs them."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def tree_shardings(spec_tree: Any, shape_tree: Any, mesh: Any,
                   rules: Optional[Dict] = None) -> Any:
    """(logical-axes tree, tree of tensors or shapes) → NamedSharding tree."""
    def leaf(axes, t):
        shape = t if isinstance(t, (tuple, torch.Size)) else t.shape
        return NamedSharding(mesh, spec_for_shape(tuple(axes), tuple(shape), mesh, rules))
    return map_tree(leaf, spec_tree, shape_tree)


def batch_spec(mesh: Any, batch: int) -> PartitionSpec:
    """Shard the batch dim over as many data axes as divide it."""
    sizes = mesh_shape(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    chosen: Tuple[str, ...] = ()
    for k in range(len(axes), 0, -1):
        cand = tuple(axes[:k])
        n = _axes_size(sizes, cand)
        if batch % n == 0 and batch >= n:
            chosen = cand
            break
    if not chosen:
        return P(None)
    return P(chosen if len(chosen) > 1 else chosen[0])


def data_sharding(mesh: Any, batch: int, *trailing: Optional[str]) -> NamedSharding:
    return NamedSharding(mesh, P(*batch_spec(mesh, batch), *trailing))


def cache_spec(cfg, mesh: Any, name: str, shape: Sequence[int]) -> PartitionSpec:
    """The spec of one of the port's per-layer cache tensors (the
    reference's stacked spec without its leading layers axis).

    K/V caches (B, S, Kv, hd): batch over the data axes when it divides,
    else the sequence over "data"; Kv over "model" when it divides, else the
    sequence over "model" (context parallelism: decode attention then
    reduces a distributed softmax, where sharding head_dim made the
    reference's compiler replicate the cache). SSM states (B, H, P, N):
    batch over data, H over model. Conv states (B, w-1, C): batch over
    data, C over model.
    """
    sizes = mesh_shape(mesh)
    model = sizes.get("model", 1)

    def baxes(b):
        bspec = batch_spec(mesh, b)
        return bspec[0] if len(bspec) else None
    if name in ("k", "v", "ck", "cv") and cfg.num_kv_heads and shape[2] == cfg.num_kv_heads:
        b, s, kv, _ = shape
        ba = baxes(b)
        seq_ax = "data" if ba is None and "data" in sizes and s % sizes["data"] == 0 else None
        kv_ax = "model" if kv % model == 0 else None
        if kv_ax is None and seq_ax != "model" and s % model == 0:
            seq2 = ("model",) if seq_ax is None else (seq_ax, "model")
            return P(ba, seq2 if len(seq2) > 1 else seq2[0], None, None)
        return P(ba, seq_ax, kv_ax, None)
    if name == "state":
        b, h = shape[0], shape[1]
        return P(baxes(b), "model" if h % model == 0 else None)
    if name == "conv":
        b, c = shape[0], shape[2]
        return P(baxes(b), None, "model" if c % model == 0 else None)
    return P()


def cache_shardings(cfg, mesh: Any, caches: Sequence[Dict[str, Any]]) -> Any:
    """NamedShardings for the port's decode caches (one dict per layer)."""
    return [{k: NamedSharding(mesh, cache_spec(cfg, mesh, k, tuple(t.shape)))
             for k, t in c.items()} for c in caches]


def placements(mesh: Any, spec: Sequence[Any]) -> tuple:
    """``torch.distributed.tensor`` placements of ``spec`` on ``mesh``, one
    per mesh dim: ``Shard(d)`` where tensor dim d names the mesh dim,
    ``Replicate()`` elsewhere. A dim sharded over several axes ("pod",
    "data") is split over them in mesh order, major first, as JAX does."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh_shape(mesh):
        dim = next((d for d, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def local_shape(mesh: Any, spec: Sequence[Any], shape: Sequence[int]) -> Tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor under ``spec``."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for d, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                out[d] //= sizes[a]
    return tuple(out)
