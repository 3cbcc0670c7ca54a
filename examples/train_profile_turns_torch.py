"""phi4-mini-3.8b's and mamba2-1.3b's train steps on the card, profiled as a
checkout's ``chip_smoke.py`` profiles them: for holding two checkouts of the
port against each other in turns (a, b, b, a) within one call.

    python examples/train_profile_turns_torch.py --root <checkout> --label <name>

Puts ``<checkout>/src`` first on the path, builds that checkout's training
kernels, and runs ``train_phase`` of ``<checkout>/chip_smoke.py`` for each
of ``--archs`` (full width and depth, bf16, AdamW, remat, 4 × 1024 tokens:
two warm-up steps, the counted steps on the host clock, then one step under
``torch.profiler`` split into the kernels, cuBLAS, the optimizer and the
rest), printing its JSON line with ``--label``.
"""
import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

STEPS = {"phi4-mini-3.8b": 8, "mamba2-1.3b": 6}      # chip_smoke.py's counted steps
# chip_smoke.py's launch counters: its name, the module and the wrapper
KERNELS = (("flash_attention", "flash_attention", "flash_attention"),
           ("flash_attention_bwd", "flash_attention", "flash_attention_bwd"),
           ("ssd_scan", "ssd_scan", "ssd_scan"), ("ssd_scan_bwd", "ssd_scan", "ssd_scan_bwd"),
           ("int8_quant", "int8_quant", "quantize_int8"),
           ("batchsim_advance", "batchsim_advance", "batchsim_advance"),
           ("adamw", "adamw", "adamw_update"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="the checkout to profile")
    ap.add_argument("--label", required=True)
    ap.add_argument("--archs", nargs="*", default=list(STEPS))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke_of_root", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.emit = lambda obj: print(json.dumps({"label": args.label, **obj}), flush=True)

    import torch
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    build.build([n for n in ("flash_attention_sm90", "flash_attention_bwd_sm90", "ssd_scan_sm90",
                             "ssd_scan_bwd_sm90", "adamw") if (csrc / f"{n}.cu").exists()])
    counters = {}
    for name, module, wrapper in KERNELS:
        try:
            counters[name] = getattr(importlib.import_module(f"repro_torch.kernels.{module}"),
                                     wrapper)
        except ModuleNotFoundError:       # a checkout from before the kernel
            continue
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    for arch in args.archs:
        smoke.train_phase(smi, counters, arch, STEPS[arch])


if __name__ == "__main__":
    main()
