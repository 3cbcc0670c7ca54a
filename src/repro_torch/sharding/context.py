"""Activation-sharding context (port of ``repro.sharding.context``).

The model code is mesh-agnostic; the launcher declares which mesh axes
carry the batch (and model) dimension of activations, and the forward pass
pins activations to that layout at block boundaries, where the reference
puts ``with_sharding_constraint``. Here a pin is a ``redistribute`` of a
``DTensor``: dim 0 sharded over the batch axes, the other dims as given and
replicated elsewhere.

Outside a context, and on a plain tensor (the 1×1 mesh, the CPU tests, the
card's own runs), every function returns its input unchanged. The state is
the process's, as the reference keeps it, so that the forward recomputed
by remat in the backward sees the same context as the forward did.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

_STATE = {"batch_axes": None, "model_axis": None}


@contextlib.contextmanager
def activation_sharding(batch_axes: Optional[Tuple[str, ...]],
                        model_axis: Optional[str] = "model"):
    old = dict(_STATE)
    _STATE["batch_axes"] = batch_axes
    _STATE["model_axis"] = model_axis
    try:
        yield
    finally:
        _STATE.update(old)


def batch_axes() -> Optional[Tuple[str, ...]]:
    return _STATE["batch_axes"]


def _pin(x: torch.Tensor, dim_axes) -> torch.Tensor:
    """Redistribute DTensor ``x`` so that dim i is sharded over the mesh
    axes ``dim_axes[i]`` names (a name or a tuple), replicated elsewhere."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    placements = []
    for name in mesh.mesh_dim_names:
        dim = next((d for d, a in enumerate(dim_axes)
                    if a == name or (isinstance(a, tuple) and name in a)), None)
        placements.append(Replicate() if dim is None else Shard(dim))
    if tuple(placements) == tuple(x.placements):
        return x
    return x.redistribute(mesh, placements)


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Pin dim 0 of an activation to the declared batch axes."""
    ba = _STATE["batch_axes"]
    if ba is None:
        return x
    return _pin(x, (tuple(ba),))


def constrain_axes(x: torch.Tensor, *dim_axes: Optional[str]) -> torch.Tensor:
    """Pin specific dims: dim 0 to the batch axes, others as given.

    ``dim_axes`` covers dims 1..n; callers must pre-check divisibility for
    any 'model'-axis assignment.
    """
    ba = _STATE["batch_axes"]
    if ba is None:
        return x
    return _pin(x, (tuple(ba),) + tuple(dim_axes))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K) and w (K, N); on a mesh, partitioned as
    the reference's compiler partitions it from the shardings, one mesh dim
    at a time: x's batch dim 0 sharded keeps it so (w gathered: FSDP); x's
    K sharded like w's K gives a partial sum (row-parallel); w's N sharded
    gathers x and shards the output's N (column-parallel); anything else is
    gathered. ``DTensor``'s own choice would recompute the product on every
    rank of a mesh dim that it leaves replicated. A row-parallel output is
    all-reduced at once. In the backward, the
    gradient of a gathered operand is summed over the mesh dims whose ranks
    each used it for a part of the product (FSDP's reduction)."""
    if type(x) is torch.Tensor:
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from .collectives import summing_grads
    last = x.ndim - 1
    r = Replicate()
    cols = []                            # (x, w, out) per mesh dim
    x_sum, w_sum = [], []                # dims over which a gradient is a part
    for i, (px, pw) in enumerate(zip(x.placements, w.placements)):
        if px == Shard(0) and last > 0:
            cols.append((px, r, px))
            w_sum.append(i)
        elif px == Shard(last) and pw == Shard(0):
            cols.append((px, pw, Partial()))
        elif pw == Shard(1):
            cols.append((r, pw, Shard(last)))
            x_sum.append(i)
        else:
            cols.append((r, r, r))
    px, pw, po = (list(c) for c in zip(*cols))
    mesh = x.device_mesh
    x, w = x.redistribute(mesh, px), w.redistribute(mesh, pw)

    def local(x, w):
        # a gathered w meets this rank's rows only, a gathered x its columns
        return torch.matmul(summing_grads(x, mesh, x_sum), summing_grads(w, mesh, w_sum))
    out = local_map(local, out_placements=po, in_placements=(px, pw), device_mesh=mesh)(x, w)
    if Partial() in po:                  # summed once here: DTensor would sum a partial
        return out.redistribute(mesh, [r if p == Partial() else p for p in po])   # at each use
    return out
