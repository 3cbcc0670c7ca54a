"""Tensor-memory chunk layout (copy of ``repro.core.memlayout``).

The runtime's :class:`~repro_torch.runtime.tensorpool.TensorPool` allocates
in fixed 2 KiB chunks (paper §5.3) so freed buffers re-serve any request of
the same rounded size. The chunk math lives here, apart from the pool, as
in the reference, where the static analyzer bounds residency with it.
"""
from __future__ import annotations

CHUNK = 2048  # bytes, paper §5.3


def rounded_chunk_bytes(nbytes: int) -> int:
    """Bytes actually consumed by an ``nbytes`` allocation: rounded up to
    the chunk quantum, minimum one chunk (a zero-byte tensor still holds a
    chunk — the pool hands out real buffers, never aliases of nothing)."""
    return max(CHUNK, ((int(nbytes) + CHUNK - 1) // CHUNK) * CHUNK)
