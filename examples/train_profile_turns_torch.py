"""phi4-mini-3.8b's, mamba2-1.3b's and olmoe-1b-7b's train steps on the
card, and with ``--prefills`` served prefills, each checkout's step profiled
by one measurement: for holding two checkouts of the port against each
other in turns (a, b, b, a) within one call.

    python examples/train_profile_turns_torch.py --root <checkout> --label <name>
    python examples/train_profile_turns_torch.py --root <checkout> --label <name> \
        --archs --prefills qwen3-14b mamba2-1.3b

Puts ``<checkout>/src`` first on the path, builds that checkout's training
kernels, and runs ``train_phase`` of ``<checkout>/chip_smoke.py`` for each
of ``--archs`` (bf16, AdamW, remat, 4 × 1024 tokens; phi4 and mamba2 at full
width and depth, olmoe cut to 8 of its 16 layers: two warm-up steps, the
counted steps on the host clock, then one step under ``torch.profiler``),
printing its JSON line with ``--label``. The profiled step is split by
``train_profile`` of the ``chip_smoke.py`` beside this script, whatever the
checkout: the kernels by name, cuBLAS, the optimizer, the rest, and the
rest by op and input shapes (``rest_by_op``) and the copies at K2's and
K3's operand shapes (``layout_copies``), so both checkouts are read by the
same code. ``--prefills``: each model at full width and depth (bf16, random
weights from seed 0) runs one warm-up prefill of 4 × 1024 tokens through
``models.forward_prefill``, then ``--prefill-reps`` profiled prefills; each
prints its device time, the port's kernels and the copies at K2's and K3's
operand shapes.
"""
import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

# chip_smoke.py's counted steps and depth cut
STEPS = {"phi4-mini-3.8b": (8, None), "mamba2-1.3b": (6, None),
         "olmoe-1b-7b": (6, {"num_layers": 8})}
# chip_smoke.py's launch counters: its name, the module and the wrapper
KERNELS = (("flash_attention", "flash_attention", "flash_attention"),
           ("flash_attention_bwd", "flash_attention", "flash_attention_bwd"),
           ("ssd_scan", "ssd_scan", "ssd_scan"), ("ssd_scan_bwd", "ssd_scan", "ssd_scan_bwd"),
           ("int8_quant", "int8_quant", "quantize_int8"),
           ("batchsim_advance", "batchsim_advance", "batchsim_advance"),
           ("adamw", "adamw", "adamw_update"),
           *((n, "moe_dispatch", n) for n in ("moe_fill", "moe_combine", "moe_fill_bwd",
                                              "moe_combine_bwd")),
           *((n, "rms_norm", n) for n in ("rms_norm_fwd", "gated_rms_norm_fwd", "rms_norm_bwd",
                                          "gated_rms_norm_bwd")),
           *((n, "causal_conv", n) for n in ("causal_conv1d_fwd", "causal_conv1d_bwd")),
           *((n, "cross_entropy", n) for n in ("cross_entropy_fwd", "cross_entropy_bwd")),
           *((n, "rope", n) for n in ("rope_qk_fwd", "rope_qk_bwd")),
           *((n, "swiglu", n) for n in ("swiglu_fwd", "swiglu_bwd")))
HERE = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="the checkout to profile")
    ap.add_argument("--label", required=True)
    ap.add_argument("--archs", nargs="*", default=list(STEPS))
    ap.add_argument("--prefills", nargs="*", default=[])
    ap.add_argument("--prefill-reps", type=int, default=2)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    smoke = load(root / "chip_smoke.py", "chip_smoke_of_root")
    smoke.emit = lambda obj: print(json.dumps({"label": args.label, **obj}), flush=True)
    here = load(HERE / "chip_smoke.py", "chip_smoke_here")

    def profile(model, opt, state, tokens, labels, **kw):
        return here.train_profile(model, opt, state, tokens, labels, operand_shapes=(
            here.k2k3_operand_shapes(model.cfg, *tokens.shape)))
    smoke.train_profile = profile

    import torch
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    build.build([n for n in ("flash_attention_sm90", "flash_attention_bwd_sm90", "ssd_scan_sm90",
                             "ssd_scan_bwd_sm90", "adamw", "moe_dispatch", "rms_norm",
                             "causal_conv1d", "cross_entropy", "rope", "swiglu")
                 if (csrc / f"{n}.cu").exists()])
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
        steps, cut = STEPS[arch]
        smoke.train_phase(smi, counters, arch, steps, cut)
    for arch in args.prefills:
        for rec in prefill_profiles(here, arch, args.prefill_reps):
            print(json.dumps({"label": args.label, "phase": "prefill_profile", "arch": arch,
                              **rec, "smi": smi}), flush=True)


def prefill_profiles(here, arch: str, reps: int) -> list:
    """Device ms of ``reps`` profiled prefills of ``arch`` (4 × 1024 tokens):
    the busy time, the port's kernels by name, the ten largest kernels and
    each ``aten::copy_`` at K2's and K3's operand shapes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import stub_cross_src
    from repro_torch.models import forward_prefill, init_params
    batch, prompt = here.SERVE_BATCH, here.SERVE_PROMPT
    cfg = get_config(arch)
    dev = torch.device("cuda")
    model = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen, device=dev)
    cross = stub_cross_src(cfg, batch, dev, model.embed.dtype)
    shapes = here.k2k3_operand_shapes(cfg, batch, prompt)
    out = []
    with torch.inference_mode():
        forward_prefill(model, tokens, prompt + 1, cross)                  # warm-up
        for _ in range(reps):
            with here.profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA,
                               record_shapes=True) as prof:
                forward_prefill(model, tokens, prompt + 1, cross)
            kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            copies = [[e.key, str(e.input_shapes)[:160], e.self_device_time_total / 1e3, e.count]
                      for e in prof.key_averages(group_by_input_shape=True)
                      if e.device_type == DeviceType.CPU and e.key == "aten::copy_"
                      and e.self_device_time_total > 0
                      and any(list(x) in shapes for x in e.input_shapes)]
            port = {k: sum(e.self_device_time_total for e in kernels if here.named(k, e.key)) / 1e3
                    for k in here.PORT_KERNELS}
            out.append({"device_busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
                        "port_kernels_ms": {k: v for k, v in port.items() if v},
                        "layout_copies": copies,
                        "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count] for e in
                                sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]]})
    del model
    torch.cuda.empty_cache()
    return out


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


if __name__ == "__main__":
    main()
