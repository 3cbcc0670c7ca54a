"""The paper's measured profiling data (Tables 2, 3, 4, 6), Galaxy S23 Ultra;
copy of ``repro.zoo.profiles``.

These numbers seed the :class:`~repro.core.profiler.TableBackend` so the
paper-faithful experiments use the paper's own device measurements — the
honest substitute for a Galaxy S23U in this environment (DESIGN.md §2).

Units: seconds. Keys: model name -> (processor kind, dtype, backend) -> s.
"""
from __future__ import annotations

from typing import Dict, Tuple

# Table 6: models with MAC counts and parameter counts.
MODEL_SPECS: Dict[str, Dict[str, float]] = {
    "face_det":    {"macs": 39.2e6,    "params": 0.6e6,  "layers": 12, "input": (1, 128, 128, 3)},
    "selfie_seg":  {"macs": 72.3e6,    "params": 0.1e6,  "layers": 14, "input": (1, 256, 256, 3)},
    "hand_det":    {"macs": 410.8e6,   "params": 2.0e6,  "layers": 18, "input": (1, 192, 192, 3)},
    "pose_det":    {"macs": 444.2e6,   "params": 3.4e6,  "layers": 18, "input": (1, 224, 224, 3)},
    "tcmonodepth": {"macs": 2313.2e6,  "params": 0.2e6,  "layers": 22, "input": (1, 256, 256, 3)},
    "fast_scnn":   {"macs": 2358.9e6,  "params": 1.1e6,  "layers": 20, "input": (1, 512, 512, 3)},
    "yolov8n":     {"macs": 4891.3e6,  "params": 3.2e6,  "layers": 24, "input": (1, 640, 640, 3)},
    "mosaic":      {"macs": 22055.1e6, "params": 1.8e6,  "layers": 28, "input": (1, 512, 512, 3)},
    "fastsam_s":   {"macs": 22325.1e6, "params": 11.8e6, "layers": 28, "input": (1, 640, 640, 3)},
}

MODEL_NAMES = tuple(MODEL_SPECS.keys())

_MS = 1e-3

# Table 2: CPU execution times by (dtype, backend), ms.
_TABLE2_CPU: Dict[str, Dict[Tuple[str, str], float]] = {
    #                 (fp32,default) (fp16,default) (fp32,xnnpack) (fp16,xnnpack) (fp32,nnapi) (fp16,nnapi)
    "face_det":    {("fp32", "default"): 2.6,  ("fp16", "default"): 6.0,  ("fp32", "xnnpack"): 1.6,  ("fp16", "xnnpack"): 5.5,  ("fp32", "nnapi"): 201.0,  ("fp16", "nnapi"): 208.5},
    "selfie_seg":  {("fp32", "default"): 4.3,  ("fp16", "default"): 3.5,  ("fp32", "xnnpack"): 3.1,  ("fp16", "xnnpack"): 3.6,  ("fp32", "nnapi"): 106.8,  ("fp16", "nnapi"): 110.2},
    "hand_det":    {("fp32", "default"): 24.3, ("fp16", "default"): 5.8,  ("fp32", "xnnpack"): 8.5,  ("fp16", "xnnpack"): 7.9,  ("fp32", "nnapi"): 198.5,  ("fp16", "nnapi"): 205.1},
    "pose_det":    {("fp32", "default"): 16.3, ("fp16", "default"): 6.1,  ("fp32", "xnnpack"): 8.7,  ("fp16", "xnnpack"): 8.0,  ("fp32", "nnapi"): 286.0,  ("fp16", "nnapi"): 287.7},
    "tcmonodepth": {("fp32", "default"): 93.8, ("fp16", "default"): 73.2},
    "fast_scnn":   {("fp32", "default"): 73.2, ("fp16", "default"): 37.3},
    "yolov8n":     {("fp32", "default"): 73.0, ("fp16", "default"): 58.6, ("fp32", "xnnpack"): 74.5, ("fp16", "xnnpack"): 61.6, ("fp32", "nnapi"): 638.7,  ("fp16", "nnapi"): 642.9},
    "mosaic":      {("fp32", "default"): 582.5, ("fp16", "default"): 252.6, ("fp32", "xnnpack"): 373.7, ("fp16", "xnnpack"): 213.0, ("fp32", "nnapi"): 1211.7, ("fp16", "nnapi"): 1208.4},
    "fastsam_s":   {("fp32", "default"): 314.6, ("fp16", "default"): 220.3, ("fp32", "xnnpack"): 297.4, ("fp16", "xnnpack"): 192.4, ("fp32", "nnapi"): 1255.8, ("fp16", "nnapi"): 1256.8},
}

# Table 3: best-config times per processor (fp16), ms.
_TABLE3: Dict[str, Dict[str, float]] = {
    #               CPU    GPU    NPU
    "face_det":    {"cpu": 1.6,   "gpu": 1.9,  "npu": 0.3},
    "selfie_seg":  {"cpu": 3.1,   "gpu": 6.5,  "npu": 1.0},
    "hand_det":    {"cpu": 5.8,   "gpu": 4.9,  "npu": 1.2},
    "pose_det":    {"cpu": 6.1,   "gpu": 4.9,  "npu": 1.1},
    "tcmonodepth": {"cpu": 73.2,  "gpu": 31.7, "npu": 32.4},
    "fast_scnn":   {"cpu": 37.3,  "gpu": 12.9, "npu": 22.0},
    "yolov8n":     {"cpu": 58.6,  "gpu": 16.0, "npu": 5.3},
    "mosaic":      {"cpu": 213.0, "gpu": 83.8, "npu": 163.9},
    "fastsam_s":   {"cpu": 192.4, "gpu": 43.4, "npu": 9.1},
}

# Table 4: Estimated/Measured ratios (Σ per-layer vs whole graph) — the
# non-linearity of execution time. Used to validate fragmentation_penalty.
TABLE4_RATIO: Dict[str, Dict[str, float]] = {
    "face_det":    {"cpu": 0.99, "gpu": 0.68, "npu": 1.42},
    "selfie_seg":  {"cpu": 1.05, "gpu": 0.85, "npu": 2.75},
    "hand_det":    {"cpu": 1.01, "gpu": 0.83, "npu": 1.69},
    "pose_det":    {"cpu": 1.00, "gpu": 0.80, "npu": 1.97},
    "tcmonodepth": {"cpu": 0.99, "gpu": 0.92, "npu": 2.13},
    "fast_scnn":   {"cpu": 0.95, "gpu": 0.84, "npu": 2.86},
    "yolov8n":     {"cpu": 1.00, "gpu": 0.88, "npu": 2.40},
    "mosaic":      {"cpu": 0.97, "gpu": 0.93, "npu": 3.45},
    "fastsam_s":   {"cpu": 1.01, "gpu": 0.90, "npu": 1.70},
}


def paper_profile_tables() -> Dict[str, Dict[Tuple[str, str, str], float]]:
    """Flatten Tables 2/3 into the TableBackend schema.

    CPU entries come straight from Table 2. GPU/NPU: Table 3 gives the best
    fp16 configuration; fp32 on GPU is synthesized at 1.9× fp16 (half-rate
    fp32 ALUs), int8 on NPU at 0.65× fp16 (the Hexagon int8 path), int8 on
    CPU at 0.75× of the best CPU fp16 — consistent with the relative orders
    reported in §2.1.1. NNAPI-like catastrophic fallbacks only exist for the
    CPU rows where the paper measured them.
    """
    tables: Dict[str, Dict[Tuple[str, str, str], float]] = {}
    for name in MODEL_NAMES:
        t: Dict[Tuple[str, str, str], float] = {}
        for (dt, be), ms in _TABLE2_CPU[name].items():
            t[("cpu", dt, be)] = ms * _MS
        cpu_fp16_best = min(
            ms for (dt, be), ms in _TABLE2_CPU[name].items() if dt == "fp16"
        )
        t[("cpu", "int8", "default")] = 0.75 * cpu_fp16_best * _MS
        t[("cpu", "int8", "xnnpack")] = 0.70 * cpu_fp16_best * _MS
        gpu = _TABLE3[name]["gpu"]
        npu = _TABLE3[name]["npu"]
        t[("gpu", "fp16", "default")] = gpu * _MS
        t[("gpu", "fp32", "default")] = 1.9 * gpu * _MS
        t[("gpu", "int8", "default")] = 0.9 * gpu * _MS  # little int8 gain on mobile GPUs
        t[("npu", "fp16", "default")] = npu * _MS
        t[("npu", "int8", "default")] = 0.65 * npu * _MS
        tables[name] = t
    return tables


def best_processor_times_s() -> Dict[str, Dict[str, float]]:
    """Table 3 in seconds (best config per processor)."""
    return {
        name: {kind: ms * _MS for kind, ms in row.items()}
        for name, row in _TABLE3.items()
    }
