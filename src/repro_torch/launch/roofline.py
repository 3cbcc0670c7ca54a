"""Roofline of a dry run (port of ``repro.launch.roofline``).

Three terms per (arch × shape × mesh), all in seconds, per device:

    compute    = FLOPs / peak FLOP/s
    memory     = traffic bytes / HBM bandwidth
    collective = collective bytes / NVLink bandwidth

The counts come from :mod:`repro_torch.launch.op_analysis` (an eager
step's ops, not XLA's fused module; see there). The hardware is one NVIDIA
H100 SXM, by its datasheet (dense rates, at the full 700 W power limit):
989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM3, 80 GB, and NVLink 4
at 450 GB/s in each direction. These are datasheet figures, not
measurements (kept in :mod:`repro_torch.core.processors`); a card set
below 700 W runs slower.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..core.processors import (  # noqa: F401  (H100_PEAK_FLOPS_F32: chip_smoke.py's bounds)
    H100_HBM_BW,
    H100_HBM_BYTES as HBM_PER_DEVICE,
    H100_NVLINK_BW,
    H100_PEAK_FLOPS_BF16,
    H100_PEAK_FLOPS_F32,
)


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    per_device_flops: float
    per_device_bytes: float
    collective_bytes: float           # per device
    collective_by_op: Dict[str, int]
    model_flops: float                # 6·N·D or 2·N·D (global, useful work)
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    useful_ratio: float               # model_flops / (per_device_flops × chips)
    memory_per_device: Optional[float] = None   # arguments only, no temporaries
    fits_hbm: Optional[bool] = None
    notes: str = ""

    def as_dict(self) -> Dict:
        return dict(self.__dict__)

    @property
    def t_max(self) -> float:
        """The largest term: the least time the step could take."""
        return max(self.t_compute, self.t_memory, self.t_collective)


def model_flops(cfg, shape) -> float:
    """Useful-work FLOPs: 6·N_active·tokens (train) / 2·N_active·tokens."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # one token per sequence


def build_report(arch: str, shape, mesh_name: str, chips: int, stats, cfg,
                 memory_per_device: Optional[float] = None) -> RooflineReport:
    flops = float(stats.flops)
    bytes_ = float(stats.traffic_bytes)
    terms = {
        "compute": flops / H100_PEAK_FLOPS_BF16,
        "memory": bytes_ / H100_HBM_BW,
        "collective": stats.collective_bytes / H100_NVLINK_BW,
    }
    mf = model_flops(cfg, shape)
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        per_device_flops=flops, per_device_bytes=bytes_,
        collective_bytes=float(stats.collective_bytes),
        collective_by_op={k: int(v) for k, v in stats.collective_by_op.items()},
        model_flops=mf,
        t_compute=terms["compute"], t_memory=terms["memory"],
        t_collective=terms["collective"],
        bottleneck=max(terms, key=terms.get),
        useful_ratio=mf / max(flops * chips, 1.0),
        memory_per_device=memory_per_device,
        fits_hbm=(memory_per_device < HBM_PER_DEVICE) if memory_per_device else None,
    )
