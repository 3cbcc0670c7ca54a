"""olmoe-1b-7b served on the card through a checkout's port and profiled by
this repo's ``chip_smoke.moe_profile``: for holding two checkouts of the
port against each other in turns (a, b, b, a) within one call.

    python examples/moe_profile_turns_torch.py --root <checkout> --label <name>

Puts ``<checkout>/src`` first on the path and builds that checkout's
serving kernels. olmoe at full width and depth, bf16, random weights from
seed 0, 4 requests of 1024 random prompt tokens (seed 3): ``generate`` of
32 greedy tokens once to warm up and ``--runs`` times on the host clock,
then ``moe_profile`` of one prefill and of 8 decode steps, as
``chip_smoke.py``'s phase ``profile`` takes them, and a SHA-256 of the bits
of every MoE layer's output and of the logits of one prefill, for holding
two checkouts' outputs equal. Prints one JSON line with ``--label``. A checkout from before B2 has no ``moe_dispatch``: its fill
counts under the split's ``rest``, its ``_combine`` under ``combine_ops``.
"""
import argparse
import hashlib
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

ARCH, BATCH, PROMPT, NEW, DECODE_PROFILED = "olmoe-1b-7b", 4, 1024, 32, 8


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="the checkout to serve")
    ap.add_argument("--label", required=True)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_profiler", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import generate
    from repro_torch.models import forward_decode, forward_prefill, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    build.build([n for n in ("flash_attention_sm90", "moe_dispatch")
                 if (csrc / f"{n}.cu").exists()])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    model = init_params(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=g, device=dev)
    with torch.inference_mode():
        generate(model, tokens, NEW)
        served = [generate(model, tokens, NEW) for _ in range(args.runs)]
        _, caches, clen = forward_prefill(model, tokens, PROMPT + DECODE_PROFILED + 1)

        def decode_steps():
            c, n = caches, clen
            for _ in range(DECODE_PROFILED):
                _, c, n = forward_decode(model, tokens[:, -1:], c, n)
        prefill = smoke.moe_profile(lambda: forward_prefill(model, tokens, PROMPT + 1))
        decode = smoke.moe_profile(decode_steps)
        moe_sha, logits_sha = output_digests(model, tokens, forward_prefill)
    keep = ("wall_ms", "device_busy_ms", "moe_ffn_ms", "moe_calls", "b2_launches", "split_ms",
            "dispatch_split_ms")
    print(json.dumps({"label": args.label, "arch": ARCH, "batch": BATCH, "prompt": PROMPT,
                      "prefill_s": [r.prefill_s for r in served],
                      "decode_step_ms": [r.decode_s / NEW * 1e3 for r in served],
                      "prefill_ids_sample": served[0].ids[0, :8].tolist(),
                      "moe_outputs_sha256": moe_sha, "prefill_logits_sha256": logits_sha,
                      "prefill": {k: prefill[k] for k in keep},
                      f"decode_{DECODE_PROFILED}_steps": {k: decode[k] for k in keep},
                      "smi": smi}), flush=True)


def output_digests(model, tokens, forward_prefill):
    """SHA-256 of the bits of every MoE layer's output, in the order the
    layers run, and of the logits, over one prefill."""
    import torch
    transformer = importlib.import_module("repro_torch.models.transformer")
    moe_ffn = transformer.moe_ffn
    moe_sha = hashlib.sha256()

    def recorded(*args, **kw):
        out = moe_ffn(*args, **kw)
        first = out[0] if isinstance(out, tuple) else out
        moe_sha.update(first.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return out
    with mock.patch.object(transformer, "moe_ffn", recorded):
        logits = forward_prefill(model, tokens, PROMPT + 1)[0]
    logits_sha = hashlib.sha256(logits.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return moe_sha.hexdigest(), logits_sha.hexdigest()


if __name__ == "__main__":
    main()
