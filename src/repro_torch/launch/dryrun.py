"""Multi-pod dry run: every (arch × shape × mesh) step on the meta device
(port of ``repro.launch.dryrun``).

For each combination the step's arguments are built as meta ``DTensor``\\ s
over a fake process group of 256 ranks (16×16) or 512 (2×16×16), and the
step runs under :class:`~repro_torch.launch.op_analysis.OpCounter`: nothing
is allocated and no rank exists, but every op is dispatched as on one
device of the mesh, each collective included. The record holds the
reference's fields: ``ok``, ``error``, the three roofline terms for the
H100 (:mod:`repro_torch.launch.roofline`), ``bottleneck``,
``useful_ratio``, ``memory_per_device`` and ``fits_hbm``. The memory is
the local shards of the arguments (parameters, optimizer state, caches,
inputs): arguments, no temporaries, where the reference reads the
compiler's memory analysis. Beside the memory term, which counts every
eager op's bytes (the port runs unfused), ``t_memory_fused`` is the time
to move the bytes a fully fused step could not avoid
(:func:`fused_bytes_per_device`). A combination that fails is recorded
with ``ok: false`` and its error, never dropped.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
Results: results/dryrun_torch/<arch>__<shape>__<mesh>.json

``--mesh host`` runs the 1×1 mesh on plain meta tensors: one device's
whole step, with no process group.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch

from ..configs import ALIASES, get_config
from ..models.convert import flatten
from ..train.optimizer import optimizer_for_config
from .mesh import make_production_mesh
from .op_analysis import analyze
from .roofline import H100_HBM_BW, build_report
from .shapes import INPUT_SHAPES, InputShape, config_for_shape
from .steps import make_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
MESHES = ("single", "multi", "host")


def _mesh(mesh_name: str):
    if mesh_name == "host":
        return {"data": 1, "model": 1}
    return make_production_mesh(multi_pod=(mesh_name == "multi"))


def _local_bytes(t: torch.Tensor) -> int:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


def arg_bytes_per_device(args: Any) -> float:
    """Bytes of one device's shards of the step's arguments."""
    total = 0
    for a in args:
        if isinstance(a, torch.nn.Module):
            total += sum(_local_bytes(p) for p in a.parameters())
        else:
            for t in flatten(a):
                for x in getattr(t, "tensors", [t]):        # a Leaf's per-layer tensors
                    if isinstance(x, torch.Tensor):
                        total += _local_bytes(x)
    return float(total)


def fused_bytes_per_device(kind: str, args: Any) -> float:
    """The bytes a fully fused step must move on one device: every argument
    read once and, for a train step, the parameters and optimizer state
    written once and the gradients written and read once. A lower bound
    beside the memory term, which counts every eager op's bytes."""
    total = arg_bytes_per_device(args)
    if kind == "train":
        total += 3 * arg_bytes_per_device(args[:1]) + arg_bytes_per_device(args[1:2])
    return total


def run_one(arch: str, shape: Union[str, InputShape], mesh_name: str, save: bool = True,
            verbose: bool = True, cfg=None) -> Dict:
    """One combination's record; ``shape`` is a name of ``INPUT_SHAPES`` or
    an :class:`InputShape`, ``cfg`` the config when not ``get_config(arch)``."""
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    cfg = cfg or get_config(arch)
    record: Dict = {"arch": arch, "shape": shape.name, "mesh": mesh_name, "ok": False}
    t0 = time.time()
    try:
        mesh = _mesh(mesh_name)
        chips = 1 if isinstance(mesh, dict) else mesh.size()
        record["chips"] = int(chips)
        opt = optimizer_for_config(cfg)
        step, args = make_step(cfg, mesh, shape, optimizer=opt)
        t_build = time.time() - t0
        mem = arg_bytes_per_device(args)
        fused = fused_bytes_per_device(shape.kind, args)
        _, stats = analyze(step, *args)
        t_run = time.time() - t0 - t_build
        rep = build_report(arch, shape, mesh_name, chips, stats,
                           config_for_shape(cfg, shape), mem)
        record.update(rep.as_dict())
        record.update({
            "ok": True,
            "optimizer": opt,
            "build_s": round(t_build, 2),
            "run_s": round(t_run, 2),
            "memory_note": "arguments, no temporaries",
            "fused_bytes_per_device": fused,
            "t_memory_fused": fused / H100_HBM_BW,
            "collective_count": dict(stats.collective_count),
        })
        if verbose:
            print(f"[dryrun] {arch} × {shape.name} × {mesh_name}: OK run={t_run:.1f}s "
                  f"mem/dev={mem / 2**30:.2f}GiB bottleneck={rep.bottleneck} "
                  f"terms=({rep.t_compute:.4f},{rep.t_memory:.4f},{rep.t_collective:.4f})s "
                  f"useful={rep.useful_ratio:.2f}")
    except Exception as e:               # the record keeps the failure; the sweep goes on
        record["error"] = f"{type(e).__name__}: {e}"[:2000]
        record["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch} × {shape.name} × {mesh_name}: FAIL {record['error'][:300]}")
    record["seconds"] = round(time.time() - t0, 2)
    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        path = os.path.join(RESULTS_DIR, f"{arch}__{shape.name}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1, default=str)
    return record


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ALIASES), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both", "host"], default="single")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = sorted(ALIASES) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    n_ok = n_fail = 0
    for mesh_name in meshes:
        for arch in archs:
            for shape_name in shapes:
                rec = run_one(arch, shape_name, mesh_name)
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
