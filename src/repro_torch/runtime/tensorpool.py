"""Tensor Pool and Zero-Copy Shared Buffer (paper §5.3), over device memory;
port of ``repro.runtime.tensorpool``.

``TensorPool`` pre-allocates and recycles memory buffers in 2048-byte
chunks (the paper's chunk size) so repeated inferences reuse the same
device memory. Each backing store is a ``torch.empty(size, uint8)`` on the
pool's device, ``size`` rounded up to chunk multiples so one buffer serves
many tensor shapes; ``acquire`` returns a typed view of it.

``SharedBufferTransport`` is the analogue of the ION/DMA-BUF shared
buffer: producers hand consumers a reference to the same backing store
(zero-copy) instead of copying through a staging buffer.

The same sequence of ``acquire`` and ``release`` calls gives the same
:class:`PoolStats` as the reference.
"""
from __future__ import annotations

import math
import threading
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import torch

from ..core.memlayout import CHUNK, rounded_chunk_bytes
from ..device import resolve_device

__all__ = [
    "CHUNK", "rounded_chunk_bytes", "TensorPoolOOM", "PoolStats",
    "TensorPool", "SharedBufferTransport",
]


class TensorPoolOOM(MemoryError):
    """Raised by :meth:`TensorPool.acquire` when a capacity-bounded pool
    would exceed its budget even after recycling every free buffer."""


@dataclass
class PoolStats:
    mallocs: int = 0
    reuses: int = 0
    frees: int = 0
    #: double-releases and foreign (never-acquired) buffers, ignored rather
    #: than pooled — each one would otherwise alias or pollute the free list
    rejected_frees: int = 0
    bytes_allocated: int = 0
    memcpy_bytes: int = 0
    memcpy_calls: int = 0
    #: high-water mark of bytes held by live (unreleased) acquisitions
    peak_bytes_in_use: int = 0
    #: acquisitions refused because they would exceed ``capacity_bytes``
    oom_rejections: int = 0


class TensorPool:
    """Chunk-granular buffer pool with free-list reuse.

    Outstanding buffers are tracked by backing store: a release is only
    honored for a buffer this pool handed out and that is not already back
    in the free list. The backing store of a released tensor is found
    through its storage (``untyped_storage().data_ptr()``), so any view of a
    pooled buffer releases it, as any numpy view does in the reference.
    Double releases and foreign tensors are ignored and counted in
    ``stats.rejected_frees``; honored releases count in ``stats.frees`` on
    the pooled path too (``frees + rejected_frees`` = release calls).

    The registry holds its buffers weakly, and each handed-out view keeps
    its buffer alive (as a numpy view's ``.base`` does): a caller that drops
    a view without releasing it does not pin the memory. The known limit of
    the reference holds too: a *stale* release of a view whose buffer was
    already recycled to a new owner is indistinguishable from the new
    owner's release.
    """

    def __init__(self, enabled: bool = True,
                 capacity_bytes: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if capacity_bytes is not None and capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be positive (or None)")
        self.enabled = enabled
        self.device = resolve_device(device)
        self._capacity = capacity_bytes
        self._free: Dict[int, List[torch.Tensor]] = {}
        self._lock = threading.Lock()
        # storage address -> backing store, for buffers handed out and not
        # yet released
        self._outstanding: "weakref.WeakValueDictionary[int, torch.Tensor]" = (
            weakref.WeakValueDictionary())
        self.stats = PoolStats()

    def capacity(self) -> Optional[int]:
        """Byte budget this pool enforces, or ``None`` when unbounded."""
        return self._capacity

    def bytes_in_use(self) -> int:
        """Chunk-rounded bytes currently held by unreleased acquisitions.

        Only meaningful when ``enabled``; a disabled pool tracks nothing
        and reports 0.
        """
        with self._lock:
            return self._in_use_locked()

    def _in_use_locked(self) -> int:
        return sum(buf.numel() for buf in self._outstanding.values())

    def _reserve(self, size: int) -> None:
        # called under self._lock; capacity counts live acquisitions only
        # (free-list buffers are recyclable, not occupied)
        in_use = self._in_use_locked()
        if self._capacity is not None and in_use + size > self._capacity:
            self.stats.oom_rejections += 1
            raise TensorPoolOOM(
                f"acquire of {size} B exceeds pool capacity "
                f"{self._capacity} B ({in_use} B in use)")
        if in_use + size > self.stats.peak_bytes_in_use:
            self.stats.peak_bytes_in_use = in_use + size

    @staticmethod
    def _view(buf: torch.Tensor, shape: Tuple[int, ...], dtype: torch.dtype,
              nbytes: int) -> torch.Tensor:
        out = buf[:nbytes].view(dtype).reshape(shape)
        out._pool_base = buf            # keeps the backing store alive
        return out

    def acquire(self, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        shape = tuple(int(d) for d in shape)
        nbytes = math.prod(shape) * dtype.itemsize
        size = rounded_chunk_bytes(nbytes)
        if self.enabled:
            with self._lock:
                bucket = self._free.get(size)
                if bucket:
                    self._reserve(size)
                    buf = bucket.pop()
                    self.stats.reuses += 1
                    self._outstanding[buf.untyped_storage().data_ptr()] = buf
                    return self._view(buf, shape, dtype, nbytes)
                self._reserve(size)
        self.stats.mallocs += 1
        self.stats.bytes_allocated += size
        buf = torch.empty(size, dtype=torch.uint8, device=self.device)
        if self.enabled:
            with self._lock:
                self._outstanding[buf.untyped_storage().data_ptr()] = buf
        return self._view(buf, shape, dtype, nbytes)

    def release(self, arr: torch.Tensor) -> None:
        if not self.enabled:
            self.stats.frees += 1
            return
        with self._lock:
            base = self._outstanding.pop(arr.untyped_storage().data_ptr(), None)
            if base is None:
                # double release (already back in the free list) or a
                # foreign tensor this pool never handed out: pooling it
                # would alias future acquisitions, so ignore it.
                self.stats.rejected_frees += 1
                return
            self.stats.frees += 1
            self._free.setdefault(base.numel(), []).append(base)

    def stage(self, src: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Copy ``src`` into a pooled buffer (the marshalling path), converted
        to ``dtype`` when given."""
        dst = self.acquire(tuple(src.shape), dtype or src.dtype)
        dst.copy_(src)
        self.stats.memcpy_calls += 1
        self.stats.memcpy_bytes += dst.numel() * dst.element_size()
        return dst


@dataclass
class TransportStats:
    zero_copies: int = 0
    staged_copies: int = 0
    staged_bytes: int = 0


class SharedBufferTransport:
    """Inter-worker tensor hand-off: zero-copy when enabled, staged copy
    through the pool otherwise (the paper's pre-DMA-BUF baseline)."""

    def __init__(self, pool: TensorPool, zero_copy: bool = True):
        self.pool = pool
        self.zero_copy = zero_copy
        self.stats = TransportStats()

    def transfer(self, tensor: torch.Tensor) -> torch.Tensor:
        if self.zero_copy:
            self.stats.zero_copies += 1
            return tensor            # same backing store crosses the boundary
        out = self.pool.stage(tensor)
        self.stats.staged_copies += 1
        self.stats.staged_bytes += tensor.numel() * tensor.element_size()
        return out
