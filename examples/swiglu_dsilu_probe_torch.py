"""Which form of SiLU's derivative matches ATen's compiled ``silu_backward``:
B8's adjoint (``csrc/swiglu.cu``) built with each form of its term
``1 + g·(1 − σ)`` (``dsilu``: one fma, or the product and the sum each
rounded) and of ``1 + expf(-g)`` (as written, as F.silu writes it, or
``__fadd_rn``), each held against the plain adjoint (``silu_backward`` on
the card) on every bf16 g, with several dh each, in f32 and bf16.

    PYTHONPATH=src python examples/swiglu_dsilu_probe_torch.py

Needs the card and ``nvcc``; builds the variants under
``build/swiglu_probe/`` (all at once) and prints one JSON line a variant and
dtype: the elements of dg and du whose bits differ from the plain
adjoint's, of the 65,536 g values times ``DH`` gradients each. Exits 1 where
the committed form (``as_built``) differs anywhere.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import swiglu as sw
from repro_torch.kernels.build import CSRC, NVCC_FLAGS, NVCC_INCLUDES, _nvcc

OUT = Path(__file__).resolve().parents[1] / "build" / "swiglu_probe"
DH = 8                                   # gradients a g value
DSILU = "return __fmaf_rn(g, __fsub_rn(1.0f, sig), 1.0f);"
DEN = "const float den = 1.0f + expf(-x);"
VARIANTS = {
    "as_built": [],
    "dsilu_rounded": [(DSILU, "return __fadd_rn(1.0f, __fmul_rn(g, __fsub_rn(1.0f, sig)));")],
    "den_rn": [(DEN, "const float den = __fadd_rn(1.0f, expf(-x));")],
    "dsilu_rounded_den_rn": [
        (DSILU, "return __fadd_rn(1.0f, __fmul_rn(g, __fsub_rn(1.0f, sig)));"),
        (DEN, "const float den = __fadd_rn(1.0f, expf(-x));")],
}


def build_all() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, edits in VARIANTS.items():
        src = (CSRC / "swiglu.cu").read_text()
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"{tag}: {old!r} not in swiglu.cu")
            src = src.replace(old, new)
        path = OUT / f"swiglu_{tag}.cu"
        path.write_text(src)
        cmd = [_nvcc(), *NVCC_FLAGS, *NVCC_INCLUDES, "-o", str(path.with_suffix(".so")), str(path)]
        procs[tag] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for tag, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {tag}:\n{log}")
        libs[tag] = sw._bind(ctypes.CDLL(str(OUT / f"swiglu_{tag}.so")))
    return libs


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    libs = build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    pats = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        # every bf16 g (its f32 value in f32), each beside DH gradients and up values
        g = pats.cuda().to(dtype)[:, None].expand(-1, DH).contiguous()
        dh = (torch.randn(g.shape, generator=gen, device="cuda") * 2).to(dtype)
        u = (torch.randn(g.shape, generator=gen, device="cuda") * 2).to(dtype)
        want_dg, want_du = sw.swiglu_bwd_plain(dh, g, u)
        nan = torch.isnan(want_dg)
        for tag, lib in libs.items():
            sw._lib = lambda lib=lib: lib
            dg, du = sw.swiglu_bwd(dh, g, u)
            torch.cuda.synchronize()
            same_nan = bool(torch.equal(torch.isnan(dg), nan))
            dg_diff = int((bits(dg) != bits(want_dg))[~nan].sum())
            du_diff = int((bits(du) != bits(want_du))[~torch.isnan(want_du)].sum())
            print(json.dumps({"variant": tag, "dtype": str(dtype), "elements": g.numel(),
                              "dg_differing": dg_diff, "du_differing": du_diff,
                              "nan_where_plain": same_nan, "smi": smi}), flush=True)
            if tag == "as_built":
                ok &= dg_diff == 0 and du_diff == 0 and same_nan
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
