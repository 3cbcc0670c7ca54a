"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` is a source with a plain ``extern "C"`` interface.
It is compiled by ``nvcc`` for ``sm_90a`` into
``build/repro_torch/<name>-<hash>.so`` at the root of the checkout, keyed by
a hash of the source, the shared headers beside it (``csrc/*.cuh``, on the
include path) and the flags, and loaded with ``ctypes``. A
missing ``nvcc`` or a failed build raises. :func:`require` is the wrappers'
refusal of inputs a kernel does not take.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the shared headers' directory on the include path (a copy of a source
# built elsewhere, as a probe builds one, finds them too)
NVCC_INCLUDES = ("-I", str(CSRC))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every missing library, all ``nvcc`` processes at once.

    Returns the compiler's diagnostics (``-Xptxas -v``: registers, shared
    memory, spills) for each source it compiled.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: Dict[str, Tuple[subprocess.Popen, Path, Path]] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *NVCC_INCLUDES, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The compiled ``csrc/<name>.cu``, built first if it is missing."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def require(name: str, checks: Sequence[Tuple[bool, str]], *inputs) -> None:
    """Raises ``ValueError`` for the first failed (ok, message) pair of
    ``checks``, naming ``name`` and each input's shape, dtype, strides and
    device (None where absent); nothing where all hold."""
    for ok, msg in checks:
        if not ok:
            got = "; ".join("None" if t is None else
                            f"{tuple(t.shape)} {t.dtype} strides {t.stride()} on {t.device}"
                            for t in inputs)
            raise ValueError(f"{name}: want {msg}; got {got}")
