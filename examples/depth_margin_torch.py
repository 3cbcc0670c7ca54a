"""How far a bf16 prefill's logits lie from their plain version, over draws.

``chip_smoke.py``'s ``depth_check`` holds a served model's prefill through
the kernels to the same prefill with the kernels' plain versions (K2's, K3's,
B2's, B4's and B5's), within 2% of the largest logit, on one draw of tokens. This script repeats that check
for one model over several token draws and adds an f32 witness: the same
weights cast to f32 (exact for bf16 values), its prefill with the plain
attention and scan, the expert choices pinned as in ``depth_check``
(``chip_smoke.witness_model``: the experts stay the model's own tensors,
each cast to f32 only while its products run). Per draw it prints, each
over the largest logit of the plain bf16 prefill:

- ``kernel_vs_plain``: the check's own quantity (bf16 kernels against the
  bf16 plain path; ``depth_check``'s limit is 0.02);
- ``kernel_vs_f32``, ``plain_vs_f32``: each bf16 path against the f32 one.
  If the plain path lies as far from f32 as the kernels do, the spread is
  bf16's and the limit sits inside it; if only the kernels do, they are at
  fault;
- ``f32_kernel_vs_plain``: the kernels on their f32 route against the f32
  plain path, the same routing: a fault of the MoE path or of the kernels
  shows here above f32 rounding (~1e-5).

``--no-witness`` leaves the f32 witness out (kimi-k2's ``depth_check``
keeps the 2% check): only ``kernel_vs_plain`` is printed.
The model is cut as ``depth_check`` cuts it (``SERVED_MODELS``) unless
``--layers`` says otherwise.

Usage, on a machine with the card and ``nvcc``:
    PYTHONPATH=src python examples/depth_margin_torch.py \\
        [--arch olmoe-1b-7b] [--layers N] [--draws 8] [--no-witness] [--out FILE]
``--device cpu --smoke`` runs the model's smoke config on the CPU, where
every kernel takes its plain version (the kernel columns are then 0).
"""
import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402  (depth_check's cut, routing and sizes)

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_plain  # noqa: E402
from repro_torch.models import forward_prefill, init_params  # noqa: E402


def prefill(model, tokens, cross, kernels: bool, mode: str, chosen: list) -> torch.Tensor:
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.inference_mode())
        stack.enter_context(smoke.routing(mode, chosen))
        if not kernels:
            stack.enter_context(mock.patch.object(ops, "flash_attention", flash_attention_plain))
            stack.enter_context(mock.patch.object(ops, "ssd_scan", ssd_scan_plain))
            stack.enter_context(smoke.b2_plain())
            stack.enter_context(smoke.norm_conv_plain())
        return forward_prefill(model, tokens, smoke.SERVE_PROMPT + 1, cross)[0].float()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--layers", type=int, default=None,
                    help="layers to keep (default: depth_check's cut of the model)")
    ap.add_argument("--draws", type=int, default=8)
    ap.add_argument("--out", type=Path, default=None, help="also write the rows here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    ap.add_argument("--no-witness", dest="witness", action="store_false",
                    help="no f32 copy of the model: kernels against plain in bf16 only")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("depth_margin: no CUDA device", file=sys.stderr)
        return 2
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip() if dev.type == "cuda" else "cpu")
    full = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cut = ({"num_layers": args.layers} if args.layers is not None else
           next(c for arch, c, _ in smoke.SERVED_MODELS if arch == args.arch))
    cfg = smoke.cut_config(full, cut)
    model = init_params(cfg, seed=0, device=dev)
    smoke.open_gates(model)
    model32 = smoke.witness_model(model) if args.witness else None
    columns = (("kernel_vs_plain", "kernel_vs_f32", "plain_vs_f32", "f32_kernel_vs_plain")
               if args.witness else ("kernel_vs_plain",))
    rows = []
    for draw in range(args.draws):
        gen = torch.Generator(device=dev)
        gen.manual_seed(draw)
        tokens = torch.randint(0, cfg.vocab_size, (smoke.SERVE_BATCH, smoke.SERVE_PROMPT),
                               generator=gen, device=dev)
        cross = (smoke.random_cross_src(cfg, smoke.SERVE_BATCH, gen)
                 if dev.type == "cuda" else None)
        cross32 = None if cross is None else cross.float()
        chosen = []
        lk = prefill(model, tokens, cross, True, "record", chosen)
        runs = {}
        for name, m, x, kernels in (("plain", model, cross, False),
                                    ("f32", model32, cross32, False),
                                    ("f32_kernel", model32, cross32, True)):
            if m is not None:
                runs[name] = prefill(m, tokens, x, kernels, "replay", list(chosen))
        scale = float(runs["plain"].abs().max())

        def rel(a, b):
            return float((a - b).abs().max()) / scale
        row = {"arch": cfg.name, "layers": cfg.num_layers, "draw": draw,
               "max_abs_logit": scale, "kernel_vs_plain": rel(lk, runs["plain"])}
        if args.witness:
            row.update(kernel_vs_f32=rel(lk, runs["f32"]),
                       plain_vs_f32=rel(runs["plain"], runs["f32"]),
                       f32_kernel_vs_plain=rel(runs["f32_kernel"], runs["f32"]))
        row.update(limit=2e-2, smi=smi)
        print(json.dumps(row), flush=True)
        rows.append(row)
    worst = max(rows, key=lambda r: r["kernel_vs_plain"])
    summary = {"arch": cfg.name, "draws": len(rows),
               "over_limit": sum(r["kernel_vs_plain"] > r["limit"] for r in rows),
               **{k: [min(r[k] for r in rows), max(r[k] for r in rows)] for k in columns},
               "worst_draw": worst["draw"], "smi": smi}
    print(json.dumps(summary), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(r) for r in rows + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
