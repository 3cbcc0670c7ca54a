"""Time design alternatives of B2's fill (``moe_fill_kernel``) on the card.

Builds each variant's library and times it in turns with the committed
kernel and ``torch.index_select`` (over the rows with a zero row appended,
each slot's token from the same route table), at the four shapes
``chip_smoke.py`` times B2 at: olmoe-1b-7b's, kimi-k2's and
jamba-1.5-large's prefill (4 x 1024 tokens) and olmoe's decode (4 tokens).
Every variant must give the plain fill's buffer bit for bit.

Variants:

* ``bulk_s<S>_<KB>k``: ``moe_fill_bulk_probe.cu`` beside this script, the
  token's row staged in a shared-memory ring of S stages of at most KB KB
  by 1-D bulk copies and bulk-stored to its slots;
* ``zero_runs_of_32``: the committed source with each warp given 32
  consecutive slot rows to test and zero instead of rows a grid's worth of
  warps apart.

Usage, on a machine with the card and ``nvcc``:
    PYTHONPATH=src python examples/moe_fill_probe_torch.py
"""
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels.build import CSRC, NVCC_FLAGS, NVCC_INCLUDES, _nvcc

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "moe_fill_probe"
SRC = (CSRC / "moe_dispatch.cu").read_text()
BULK = Path(__file__).resolve().parent / "moe_fill_bulk_probe.cu"
RINGS = ((4, 16), (8, 4), (2, 16))        # (stages, KB a stage)

ZERO_RUNS_OF_32 = r"""  for (int64_t base = w * 32; base < slots; base += warps * 32) {
    const int64_t r = base + lane;
    bool empty = false;
    if (r < slots) {
      const int64_t e = r / cap;
      empty = r - e * cap >= kept[e];
    }
    for (unsigned m = __ballot_sync(FULL, empty); m; m &= m - 1) {
      U* o = out + (base + __ffs(m) - 1) * units;
      for (int64_t j = lane; j < units; j += 32) __stcs(o + j, U{});
    }
  }
}
"""


def zero_runs_of_32(src: str) -> str:
    head = src.index("  for (int64_t first = w; first < slots; first += 32 * warps) {")
    return src[:head] + ZERO_RUNS_OF_32 + src[src.index("\n}\n", head) + 3:]


def build_all() -> dict:
    """Each variant's library, every nvcc at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "zero_runs_of_32.cu").write_text(zero_runs_of_32(SRC))
    jobs = {"zero_runs_of_32": (OUT / "zero_runs_of_32.cu", ())}
    for stages, kb in RINGS:
        jobs[f"bulk_s{stages}_{kb}k"] = (BULK, (f"-DSTAGES={stages}",
                                                f"-DMAX_PIECE={kb * 1024}"))
    procs = {}
    for name, (cu, defines) in jobs.items():
        so = OUT / f"{name}.so"
        procs[name] = (subprocess.Popen([_nvcc(), *NVCC_FLAGS, *NVCC_INCLUDES, *defines,
                                         "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(json.dumps({"variant": name, "ptxas": [
            line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]}))
        lib = ctypes.CDLL(str(so))
        lib.moe_fill.argtypes, lib.moe_fill.restype = md._FILL_ARGTYPES, ctypes.c_int
        lib.moe_error_string.argtypes, lib.moe_error_string.restype = [ctypes.c_int], ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> None:
    spec = importlib.util.spec_from_file_location("chip_smoke_b2", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    committed = md._lib()
    libs = {"committed": committed, **build_all()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for case in smoke.B2_CASES[:4]:
        inp = smoke.b2_inputs(case, gen)
        t, k, e, cap, rows, r = inp["t"], inp["k"], inp["e"], inp["cap"], inp["rows"], inp["routes"]
        padded = torch.cat([rows, rows.new_zeros((1, inp["d"]))])
        live = r.dest >= 0
        src = torch.full((e * cap,), t, dtype=torch.long, device="cuda")
        src[r.dest[live].long()] = torch.arange(t, device="cuda")[:, None].expand(t, k)[live]
        want = md.moe_fill_plain(rows, r.dest, r.kept, cap).view(torch.int16)

        def variant(lib):
            def call():
                md._lib = lambda: lib
                return md.moe_fill(rows, r.dest, r.kept, cap)
            return call
        contenders = {name: variant(lib) for name, lib in libs.items()}
        for name, fn in contenders.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int16), want):
                raise AssertionError(f"{name} differs from the plain fill at {case[0]}")
        contenders["index_select"] = lambda: torch.index_select(padded, 0, src)
        iters = 20 if t > smoke.SERVE_BATCH else 200
        turns = {name: [] for name in contenders}
        for name in list(contenders) + list(reversed(contenders)):
            turns[name].append(smoke.cuda_ms(contenders[name], iters=iters, warmup=2))
        print(json.dumps({"case": case[0], "tokens": t, "k": k, "experts": e, "d": inp["d"],
                          "capacity": cap, "ms": {n: min(v) for n, v in turns.items()},
                          "turns_ms": turns, "smi": smi}), flush=True)
        del inp, rows, r, padded, src, want
        torch.cuda.empty_cache()
    md._lib = lambda: committed


if __name__ == "__main__":
    sys.exit(main())
