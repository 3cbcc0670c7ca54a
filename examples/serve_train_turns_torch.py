"""Served prefill and decode times and phi4-mini-3.8b train steps of the
``repro_torch`` on ``PYTHONPATH``, on the card: for holding two checkouts
of the port against each other in turns (a, b, b, a) within one call.

    PYTHONPATH=<checkout>/src python examples/serve_train_turns_torch.py --label <name>

Each served model (full width and depth, bf16, random weights from seed 0)
serves ``--reps`` times 4 requests of 1024 prompt tokens and
``--new-tokens`` greedy tokens through ``launch.serve.generate`` after one
warm-up; phi4-mini-3.8b trains ``--train-steps`` steps (4 × 1024, AdamW,
remat) through ``train.train_step`` after two warm-up steps (none with
``--train-steps 0``). Uses only
what every checkout of the port since its training slice has, and prints
one JSON line per model and one for training, each step on the host clock
around synchronised work, with ``nvidia-smi``'s name and power limit,
and per train step the caching allocator's retries (a retry frees the
cached blocks and allocates again) and the collector's full collections.
"""
import argparse
import gc
import json
import subprocess
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch.serve import generate, stub_cross_src
from repro_torch.models import init_params, param_leaves
from repro_torch.train import DataConfig, MarkovDataset, make_optimizer, train_step

ARCHS = ("qwen3-14b", "olmoe-1b-7b", "mamba2-1.3b", "whisper-medium")
BATCH, PROMPT = 4, 1024


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--archs", nargs="*", default=list(ARCHS))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--train-steps", type=int, default=4)
    args = ap.parse_args()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    for arch in args.archs:
        cfg = get_config(arch)
        model = init_params(cfg, seed=0, device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=dev)
        cross = stub_cross_src(cfg, BATCH, dev, model.embed.dtype)
        generate(model, tokens, 2, cross)                                  # warm-up
        runs = [generate(model, tokens, args.new_tokens, cross) for _ in range(args.reps)]
        print(json.dumps({"label": args.label, "arch": arch, "prefill_s": [r.prefill_s for r in runs],
                          "decode_s_per_token": [r.decode_s / args.new_tokens for r in runs],
                          "smi": smi}), flush=True)
        del model, runs
        torch.cuda.empty_cache()

    if not args.train_steps:
        return
    cfg = get_config("phi4-mini-3.8b")
    model = init_params(cfg, seed=0, device=dev)
    model.requires_grad_(True)
    opt = make_optimizer("adamw", lr=1e-3)
    state = opt[0](param_leaves(model))
    data = MarkovDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=PROMPT, batch_size=BATCH))
    it = data.batches()
    step_s, retries, full_gcs = [], [], []
    for i in range(2 + args.train_steps):
        r0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        g0 = gc.get_stats()[2]["collections"]
        tokens, labels = (torch.from_numpy(a).to(dev, torch.int64) for a in next(it))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = train_step(model, opt, state, tokens, labels, None, remat=True)
        float(loss)
        torch.cuda.synchronize()
        if i >= 2:
            step_s.append(time.perf_counter() - t0)
            retries.append(torch.cuda.memory_stats().get("num_alloc_retries", 0) - r0)
            full_gcs.append(gc.get_stats()[2]["collections"] - g0)
    print(json.dumps({"label": args.label, "arch": cfg.name, "train_step_s": step_s,
                      "alloc_retries": retries, "full_collections": full_gcs,
                      "smi": smi}), flush=True)


if __name__ == "__main__":
    main()
