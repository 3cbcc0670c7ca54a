"""Processor descriptors (copy of ``repro.core.processors``).

The paper targets a Snapdragon 8 Gen 2 (CPU/GPU/NPU); :func:`mobile_processors`
describes it. The record keeps the reference's lane fields (``chips``,
``peak_flops``, ``hbm_bw``); the reference's TPU lanes (``tpu_lanes``) have
no counterpart here yet: their H100 version waits for constants fit on the
card (ROADMAP).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Processor:
    """One execution resource the scheduler can map subgraphs onto."""

    pid: int
    name: str
    kind: str                       # 'cpu' | 'gpu' | 'npu' | 'tpu-lane'
    # Analytic-backend parameters -------------------------------------------
    # effective MAC/s by (dtype, backend); missing entries are unsupported
    # and fall back with `fallback_penalty`.
    throughput: Tuple[Tuple[Tuple[str, str], float], ...] = ()
    invocation_overhead: float = 50e-6   # fixed cost per subgraph execution
    layer_overhead: float = 2e-6         # dispatch cost per layer in a subgraph
    # Non-linearity of execution time (§2.1.2): single-layer subgraphs are
    # `fragmentation_ratio` times slower per MAC than the whole fused graph.
    fragmentation_ratio: float = 1.0
    fallback_penalty: float = 30.0       # NNAPI-like worst case (Table 2)
    # Tensor-memory budget in bytes for weights + live activations on this
    # processor (chunk-rounded per runtime/tensorpool.py). 0 = unconstrained;
    # the static analyzer (repro.analysis) rejects schedules whose peak
    # residency lower bound provably exceeds a nonzero budget.
    memory_capacity: int = 0
    # TPU-lane parameters ------------------------------------------------------
    chips: int = 0
    peak_flops: float = 0.0
    hbm_bw: float = 0.0

    def thr(self, dtype: str, backend: str) -> Optional[float]:
        for (dt, be), v in self.throughput:
            if dt == dtype and be == backend:
                return v
        return None


def mobile_processors() -> Tuple[Processor, ...]:
    """CPU/GPU/NPU of the paper's Galaxy S23 Ultra, calibrated so the
    analytic backend reproduces the magnitudes of Tables 2–4.

    Throughputs are effective MAC/s fitted from Table 3 (best-config fp16)
    across the nine models; per-config ratios follow Table 2's structure
    (XNNPACK vs default, NNAPI disaster, fp16 ≈ 2× fp32 where supported).
    """
    cpu = Processor(
        pid=0, name="CPU", kind="cpu",
        throughput=(
            (("fp32", "default"), 18e9),
            (("fp16", "default"), 26e9),
            (("fp32", "xnnpack"), 30e9),
            (("fp16", "xnnpack"), 38e9),
            (("fp32", "nnapi"), 0.9e9),
            (("fp16", "nnapi"), 0.9e9),
            (("int8", "default"), 40e9),
            (("int8", "xnnpack"), 55e9),
        ),
        invocation_overhead=120e-6,
        layer_overhead=4e-6,
        fragmentation_ratio=1.05,   # Table 4: CPU estimated ≈ measured
    )
    gpu = Processor(
        pid=1, name="GPU", kind="gpu",
        throughput=(
            (("fp32", "default"), 90e9),
            (("fp16", "default"), 170e9),
            (("int8", "default"), 200e9),
        ),
        invocation_overhead=400e-6,  # kernel scheduling overheads (Table 4 GPU)
        layer_overhead=12e-6,
        fragmentation_ratio=1.25,
    )
    npu = Processor(
        pid=2, name="NPU", kind="npu",
        throughput=(
            (("fp16", "default"), 1.6e12),
            (("int8", "default"), 2.6e12),
        ),
        invocation_overhead=150e-6,
        layer_overhead=1e-6,
        # Table 4: Σ(layers)/measured on NPU is 1.4×–3.45× -> heavy loss of
        # intra-NPU operator parallelism when fragmented.
        fragmentation_ratio=2.4,
    )
    return (cpu, gpu, npu)

