"""Per-device FLOPs, memory traffic and collective bytes of what the port
runs: the counterpart of ``repro.launch.hlo_analysis``.

The reference reads XLA's partitioned HLO, fusions and loop trip counts
included. The port has no HLO: it runs eagerly, one ATen op (or one of its
custom ops, K2 and K3) at a time, and ``DTensor`` turns each op on a
sharded tensor into local ops on the shards plus the collectives that
bring the shards into place. :class:`OpCounter`, a dispatch mode, sees
those local ops and counts, per device:

* FLOPs by ``torch.utils.flop_counter``'s formulas (the products:
  ``mm``, ``bmm``, ``addmm``, convolutions, attention) and the formulas K2
  and K3 register (:func:`register_kernel_formulas`); elementwise work
  counts no FLOPs, as in the reference;
* traffic as the bytes of every input and output of every op that moves
  data (views, allocations and collectives move none here): the port does
  not fuse, so each op's operands cross HBM, where the reference counts
  only a fusion's boundary;
* collective bytes (each collective's input) and counts, by the
  reference's names, from the ``_c10d_functional`` ops.

So this is a different yardstick from the reference's. Its traffic is what
an unfused eager step moves, larger than what XLA's fused module moves for
the same step; its FLOPs are the same products' FLOPs. A run with plain
meta tensors (the 1×1 mesh) is one device's whole step.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# functional-collective ops that move nothing themselves
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}
# ops that move no bytes in an eager run: allocations and bookkeeping
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "detach", "alias", "lift_fresh", "set_", "resize_", "record_stream"}


@dataclass
class OpStats:
    """The fields of the reference's ``HLOStats``, per device."""

    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_op: Dict[str, float] = field(default_factory=dict)
    collective_count: Dict[str, int] = field(default_factory=dict)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def register_kernel_formulas() -> None:
    """K2's and K3's FLOP formulas, registered once per process (the
    package re-exports the functions under the modules' names)."""
    for name in ("flash_attention", "ssd_scan"):
        importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.kernels.{name}"
                                ).register_flop_formulas()


class OpCounter(TorchDispatchMode):
    """Counts :class:`OpStats` over the ops run under it (``with OpCounter() as c``)."""

    def __init__(self) -> None:
        super().__init__()
        register_kernel_formulas()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.stats = OpStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run first: its local ops and collectives come back here
            return NotImplemented
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins):
            return out                   # DTensor's shape inference, not a device op
        self._count(func, args, kwargs, out, ins)
        return out

    def _count(self, func, args, kwargs, out, ins) -> None:
        s = self.stats
        packet = func._overloadpacket
        name = func.__name__.split(".")[0]
        namespace = func.namespace
        if namespace in ("_c10d_functional", "c10d_functional"):
            if name not in _NOT_COLLECTIVES:
                kind = COLLECTIVES.get(name, name)
                n = sum(_nbytes(t) for t in ins)
                s.collective_bytes += n
                s.collective_by_op[kind] = s.collective_by_op.get(kind, 0) + n
                s.collective_count[kind] = s.collective_count.get(kind, 0) + 1
            return
        if packet in self._formulas:
            s.flops += self._formulas[packet](*args, **kwargs, out_val=out)
        if func.is_view or name in _NO_TRAFFIC:
            return
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if name == "copy_":              # reads src, writes dst once
            ins = ins[1:]
        s.traffic_bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)


def analyze(fn, *args: Any, **kwargs: Any):
    """Runs ``fn(*args, **kwargs)`` under an :class:`OpCounter`; returns
    (its result, the :class:`OpStats`)."""
    with OpCounter() as counter:
        result = fn(*args, **kwargs)
    return result, counter.stats
