"""Meshes for the production topology (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` with the reference's axis
names. Everything is a function, so importing this module creates no
process group and touches no device.

* :func:`make_host_mesh` is the 1×1 mesh of one process: on the card unless
  the caller asks for the CPU (:func:`~repro_torch.device.resolve_device`).
  The steps run on it, with plain tensors.
* :func:`make_production_mesh` is the reference's 16×16 pod slice or
  2×16×16 two-pod mesh: 256 or 512 ranks of a fake process group
  (``torch.testing._internal.distributed.fake_pg``), with which no rank
  exists and no collective moves a byte. It is for the dry run only
  (meta tensors); a step given real tensors on it raises.

The process group is the process's. This module replaces a group that it
made itself when another mesh needs another one, and never one that it did
not make.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

_OWNED = {"key": None}                   # (backend, world size) of the group made here


def required_devices(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def _group(backend: str, world_size: int, store_fn) -> None:
    """Ensures the default process group is ``backend`` over ``world_size``
    ranks, with this process as rank 0."""
    key = (backend, world_size)
    if dist.is_initialized():
        if _OWNED["key"] == key:
            return
        if _OWNED["key"] is None:
            raise RuntimeError(
                f"a process group this module did not make is initialized "
                f"({dist.get_backend()}, {dist.get_world_size()} ranks); a {backend} "
                f"group of {world_size} ranks cannot replace it")
        dist.destroy_process_group()
        _OWNED["key"] = None
    dist.init_process_group(backend, store=store_fn(), rank=0, world_size=world_size)
    _OWNED["key"] = key


def release() -> None:
    """Destroys the process group this module made, if any."""
    if _OWNED["key"] is not None and dist.is_initialized():
        dist.destroy_process_group()
    _OWNED["key"] = None


def _fake_store():
    # private to torch's tests: imported only here, on the dry run's path
    from torch.testing._internal.distributed.fake_pg import FakeStore   # registers "fake"
    return FakeStore()


def make_fake_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` over a fake process group of as many ranks: no
    rank exists, and meta tensors are all it can run."""
    _group("fake", math.prod(shape), _fake_store)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16×16 = 256-rank pod slice, or 2×16×16 = 512-rank two-pod mesh, over
    a fake process group: for the dry run on the meta device only."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_fake_mesh((16, 16), ("data", "model"))


def make_host_mesh(device: Optional[Union[str, torch.device]] = None) -> DeviceMesh:
    """1×1 mesh of this process: on the card by default, on the CPU when
    asked. A one-rank group (gloo, and NCCL for the card) backs it."""
    dev = resolve_device(device)
    backend = "gloo" if dev.type == "cpu" else "cpu:gloo,cuda:nccl"
    _group(backend, 1, dist.HashStore)
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))


def make_lane_mesh(chips_data: int, chips_model: int,
                   device: Optional[Union[str, torch.device]] = None) -> DeviceMesh:
    """A lane sub-mesh for the multi-model serving adaptation: the
    (chips_data, chips_model) mesh over the ranks of the initialized
    process group, which the caller starts (one process per card)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_lane_mesh needs an initialized process group "
                           "(one rank per card)")
    return init_device_mesh(dev.type, (chips_data, chips_model),
                            mesh_dim_names=("data", "model"))
