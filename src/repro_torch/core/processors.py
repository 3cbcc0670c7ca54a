"""Processor descriptors (copy of ``repro.core.processors``): mobile SoC
processors and H100 lanes.

The paper targets a Snapdragon 8 Gen 2 (CPU/GPU/NPU); :func:`mobile_processors`
describes it. :func:`gpu_lanes`, the counterpart of the reference's
``tpu_lanes``, describes lanes: disjoint groups of H100s of one node with
different card counts: the datasheet's peak rates, and the copy bandwidth
and launch costs measured on the card.
Both are described by the same :class:`Processor` record.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

# NVIDIA H100 SXM datasheet figures (dense, at the full 700 W power limit);
# not measurements. The roofline (``launch.roofline``) divides by these.
H100_PEAK_FLOPS_BF16 = 989e12         # FLOP/s, tensor cores
H100_PEAK_FLOPS_F32 = 67e12           # FLOP/s, CUDA cores (outside the tensor cores)
H100_HBM_BW = 3.35e12                 # bytes/s, HBM3
H100_HBM_BYTES = 80e9                 # bytes
H100_NVLINK_BW = 450e9                # bytes/s per direction, NVLink 4 (18 links)

# Per-card figures of one NVIDIA H100 80GB HBM3 at its 700 W power limit,
# measured by chip_smoke.py's ``lanes`` phase (CUDA events, min of 5 runs):
# a bf16 cuBLAS product's rate by its size (FLOPs of one product, FLOP/s),
# a device-to-device copy's bandwidth, an empty kernel's launch and a CUDA
# graph's launch. NVLink between lanes cannot be measured on one card: the
# lanes use the datasheet's bandwidth above.
H100_GEMM_RATES: Tuple[Tuple[float, float], ...] = (
    (3.3554e7, 1.6221e12), (2.6844e8, 1.2998e13), (2.1475e9, 9.7620e13),   # 256³ .. 1024³
    (1.7180e10, 6.6028e14), (1.3744e11, 7.5408e14), (1.0995e12, 7.9437e14),  # 2048³ .. 8192³
)
H100_GEMM_PEAK_MEASURED = max(rate for _, rate in H100_GEMM_RATES)
H100_COPY_BW = 3.0304e12              # bytes/s (read + write)
H100_LAUNCH_OVERHEAD = 6.97e-6        # s, one empty kernel
H100_GRAPH_LAUNCH_OVERHEAD = 6.81e-6  # s, one CUDA graph of one empty kernel
# The lane backend's efficiency ramp (the reference's form, see
# ``profiler.LaneRooflineBackend``) fit to H100_GEMM_RATES over the
# datasheet's bf16 peak by ``profiler.fit_efficiency_ramp``.
H100_MIN_WORK_PER_CARD = 1.5612e10    # FLOPs per card from which the rate is flat
H100_EFF_SCALE = 0.73561
H100_EFF_FLOOR = 6.5071e-5
NODE_GPUS = 8


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


def gpu_lanes(spec: Sequence[int] = (4, 2, 1, 1), node_gpus: int = NODE_GPUS
              ) -> Tuple[Processor, ...]:
    """Partition a node's H100s into heterogeneous lanes (the counterpart of
    the reference's ``tpu_lanes`` over a pod slice).

    Card counts must sum to at most ``node_gpus``. Raw capacity is recorded
    here (the datasheet's bf16 peak, the measured copy bandwidth); how the
    rate falls for small work per card is the lane backend's
    (:class:`~repro_torch.core.profiler.LaneRooflineBackend`). A subgraph
    runs as one CUDA graph (``invocation_overhead``), each layer a launch.
    The int8 and fp16 rates keep the datasheet's 2:1 ratio.
    """
    if sum(spec) > node_gpus:
        raise ValueError(f"lanes {tuple(spec)} exceed the node's {node_gpus} cards")
    return tuple(
        Processor(
            pid=i, name=f"lane{i}x{cards}", kind="gpu-lane",
            chips=cards,
            peak_flops=cards * H100_PEAK_FLOPS_BF16,
            hbm_bw=cards * H100_COPY_BW,
            invocation_overhead=H100_GRAPH_LAUNCH_OVERHEAD,
            layer_overhead=H100_LAUNCH_OVERHEAD,
            fragmentation_ratio=1.15,
            throughput=((("fp16", "default"), cards * H100_PEAK_FLOPS_BF16 / 2),
                        (("int8", "default"), cards * H100_PEAK_FLOPS_BF16)),
        )
        for i, cards in enumerate(spec))
