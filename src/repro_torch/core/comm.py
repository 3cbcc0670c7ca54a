"""Communication cost modeling (paper §4.1); copy of ``repro.core.comm``.

Inter-processor data transfer = RPC overhead (marshalling/unmarshalling,
piecewise-linear in data size with a knee at 1 MiB) + transfer time at the
main-memory bandwidth (≈40 GB/s on the paper's Galaxy S23U).

``PiecewiseLinearCommModel.fit`` performs the paper's piecewise-linear
regression; ``microbenchmark_host`` produces real (size, seconds) samples on
this machine by timing serialize+copy round-trips, which is the
device-in-the-loop way to calibrate the model where no Galaxy S23U exists.

:data:`LANE_COMM_MODEL` is the counterpart of the reference's
``TPU_COMM_MODEL``: the boundary between two lanes of H100s, a launch plus
the transfer over NVLink.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from .processors import H100_LAUNCH_OVERHEAD, H100_NVLINK_BW

MIB = float(1 << 20)

# Galaxy S23U constants measured in the paper.
PAPER_MEMORY_BW = 40e9  # bytes/s (§4.1, STREAM on Galaxy S23U)


@dataclass(frozen=True)
class PiecewiseLinearCommModel:
    """``cost(n) = a_lo + b_lo*n`` below the knee, ``a_hi + b_hi*n`` above,
    plus ``n / bandwidth`` transfer time."""

    a_lo: float
    b_lo: float
    a_hi: float
    b_hi: float
    knee: float = MIB
    bandwidth: float = PAPER_MEMORY_BW

    def rpc_overhead(self, nbytes: float) -> float:
        if nbytes < self.knee:
            return max(0.0, self.a_lo + self.b_lo * nbytes)
        return max(0.0, self.a_hi + self.b_hi * nbytes)

    def transfer_time(self, nbytes: float) -> float:
        return nbytes / self.bandwidth

    def cost(self, nbytes: float) -> float:
        if nbytes <= 0:
            return 0.0
        return self.rpc_overhead(nbytes) + self.transfer_time(nbytes)

    @classmethod
    def fit(
        cls,
        samples: Sequence[Tuple[float, float]],
        knee: float = MIB,
        bandwidth: float = PAPER_MEMORY_BW,
    ) -> "PiecewiseLinearCommModel":
        """Least-squares fit of the two linear regions around a fixed knee.

        ``samples`` are (bytes, seconds) of *total* observed cost; the
        transfer component ``bytes/bandwidth`` is subtracted before fitting
        the RPC overhead, matching the paper's decomposition.
        """
        lo = [(n, t - n / bandwidth) for n, t in samples if n < knee]
        hi = [(n, t - n / bandwidth) for n, t in samples if n >= knee]

        def linfit(pts: List[Tuple[float, float]]) -> Tuple[float, float]:
            if not pts:
                return 0.0, 0.0
            if len(pts) == 1:
                return max(0.0, pts[0][1]), 0.0
            xs = np.array([p[0] for p in pts])
            ys = np.array([p[1] for p in pts])
            A = np.stack([np.ones_like(xs), xs], axis=1)
            coef, *_ = np.linalg.lstsq(A, ys, rcond=None)
            return float(coef[0]), float(coef[1])

        a_lo, b_lo = linfit(lo)
        a_hi, b_hi = linfit(hi)
        if not lo:
            a_lo, b_lo = a_hi, b_hi
        if not hi:
            a_hi, b_hi = a_lo, b_lo
        return cls(a_lo=a_lo, b_lo=b_lo, a_hi=a_hi, b_hi=b_hi, knee=knee, bandwidth=bandwidth)


# A model calibrated to the shape of the paper's Fig. 5 measurements on the
# Galaxy S23U: ~60 us fixed RPC dispatch below 1 MiB with a shallow slope,
# then a steeper marshalling slope above the knee.
PAPER_COMM_MODEL = PiecewiseLinearCommModel(
    a_lo=60e-6, b_lo=25e-12, a_hi=90e-6, b_hi=45e-12, knee=MIB, bandwidth=PAPER_MEMORY_BW
)



# H100 lane-boundary model: one launch (measured) and NVLink's bandwidth
# (datasheet; one card cannot measure it). Used by the lane adaptation.
LANE_COMM_MODEL = PiecewiseLinearCommModel(
    a_lo=H100_LAUNCH_OVERHEAD, b_lo=0.0, a_hi=H100_LAUNCH_OVERHEAD, b_hi=0.0,
    knee=MIB, bandwidth=H100_NVLINK_BW,
)


def quantization_cost(nbytes: float, bandwidth: float = PAPER_MEMORY_BW) -> float:
    """(De)quantization pass cost when producer/consumer dtypes differ (§5.1).

    Modeled as one streaming read+write over the tensor.
    """
    if nbytes <= 0:
        return 0.0
    return 2.0 * nbytes / bandwidth + 10e-6


def microbenchmark_host(
    sizes: Iterable[int] = (1 << 12, 1 << 16, 1 << 20, 1 << 22, 1 << 24),
    repeats: int = 5,
) -> List[Tuple[float, float]]:
    """Measure real serialize+copy round-trip times on this host.

    This is the microbenchmark role from §4.1 — producing (bytes, seconds)
    samples for :meth:`PiecewiseLinearCommModel.fit`.
    """
    samples: List[Tuple[float, float]] = []
    for n in sizes:
        src = np.random.default_rng(0).integers(0, 255, size=n, dtype=np.uint8)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            blob = src.tobytes()               # marshalling
            out = np.frombuffer(blob, dtype=np.uint8).copy()  # unmarshal + copy
            best = min(best, time.perf_counter() - t0)
        assert out.shape == src.shape
        samples.append((float(n), best))
    return samples
