"""One checkout's train steps through B4's and B5's adjoint kernels against
the same steps through their plain versions, on the card: for telling
whether two checkouts' adjoints differ by the order of their f32 sums or by
a bias that the optimizer would carry from step to step.

    python examples/norm_conv_loss_spread_torch.py --root <checkout> --label <name>

Puts ``<checkout>/src`` first on the path and reads ``<checkout>/chip_smoke.py``
for the train phase's batch, sequence and learning rate. Two references:
``plain_adjoint``, the kernels' Functions with each adjoint's plain version
(``rms_norm_bwd_plain``, ``gated_rms_norm_bwd_plain``,
``causal_conv1d_bwd_plain``: the same f32 arithmetic, summed in PyTorch's
order) in place of its kernel; and ``plain``, ``train_swaps``' stand-ins
(B4's and B5's plain forwards, which autograd differentiates in the model's
dtype: ``norm`` for phi4-mini-3.8b, ``norm_conv`` for mamba2-1.3b). For
each of ``--archs``, at full width and depth, bf16, weights from seed 0,
remat on, ``MarkovDataset`` batches from seed 0, it prints one JSON line
with ``--label``:

* ``grad``: one backward on the first batch through the kernels and through
  each reference, every leaf's relative error (the norm of the difference
  over the reference gradient's norm) and its projection on the reference
  gradient (``(g_k - g_r)·g_r / |g_r|²``: a bias along the gradient shows
  there, a difference of sum orders averages out): the largest, the median
  and the five largest leaves;
* ``losses``: ``--steps`` AdamW steps (``train_step``) from the same weights
  through the kernels and through each reference, each step's loss, and the
  kernels' minus each reference's.

Run it on two checkouts: if both checkouts' kernels lie as far from the
plain path as each other, step for step and leaf for leaf, their difference
is one of rounding.
"""
import argparse
import contextlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

KINDS = {"mamba2-1.3b": "norm_conv", "phi4-mini-3.8b": "norm"}


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="the checkout to run")
    ap.add_argument("--label", required=True)
    ap.add_argument("--archs", nargs="*", default=list(KINDS))
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    smoke = load(root / "chip_smoke.py", "chip_smoke_of_root")

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import forward_train, init_params, param_leaves
    from repro_torch.train import (DataConfig, MarkovDataset, cross_entropy_loss,
                                   make_optimizer, train_step)
    from repro_torch.kernels import build
    ops = importlib.import_module("repro_torch.kernels.ops")
    build.build([p.stem for p in build.CSRC.glob("*.cu")])      # all at once
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")

    def swapped(swaps):
        stack = contextlib.ExitStack()
        for name, stand_in in swaps.items():
            stack.enter_context(mock.patch.object(ops, name, stand_in))
        return stack

    rn = importlib.import_module("repro_torch.kernels.rms_norm")
    cc = importlib.import_module("repro_torch.kernels.causal_conv")

    def plain_adjoints():
        stack = contextlib.ExitStack()
        for mod, name in ((rn, "rms_norm_bwd"), (rn, "gated_rms_norm_bwd"),
                          (cc, "causal_conv1d_bwd")):
            stack.enter_context(mock.patch.object(mod, name, getattr(mod, f"{name}_plain")))
        return stack

    for arch in args.archs:
        cfg = get_config(arch)
        plain = smoke.train_swaps(KINDS[arch])[0]
        refs = {"plain_adjoint": plain_adjoints, "plain": lambda: swapped(plain)}
        data = MarkovDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=smoke.TRAIN_SEQ,
                                        batch_size=smoke.TRAIN_BATCH, seed=0))
        it = data.batches()
        batches = [tuple(torch.from_numpy(a).to(dev, torch.int64) for a in next(it))
                   for _ in range(args.steps)]

        model = init_params(cfg, seed=0, device=dev)
        model.requires_grad_(True)

        def grads():
            model.zero_grad(set_to_none=True)
            loss = cross_entropy_loss(forward_train(model, batches[0][0], None, remat=True),
                                      batches[0][1])
            loss.backward()
            out = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
            model.zero_grad(set_to_none=True)
            return out
        got = grads()
        grad = {}
        for ref, ctx in refs.items():
            with ctx():
                want = grads()
            rel, proj = {}, {}
            for n, w in ((n, w) for n, w in want.items() if n in got):
                w32, d32 = w.float(), got[n].float() - w.float()
                sq = float((w32 * w32).sum())
                rel[n] = float(d32.norm()) / max(sq ** 0.5, 1e-30)
                proj[n] = float((d32 * w32).sum()) / max(sq, 1e-30)
            del want
            grad[ref] = {"leaves": len(rel), "max_rel_err": max(rel.values()),
                         "median_rel_err": statistics.median(rel.values()),
                         "max_abs_projection": max(abs(v) for v in proj.values()),
                         "median_abs_projection": statistics.median(abs(v) for v in proj.values()),
                         "largest": sorted(([n, rel[n], proj[n]] for n in rel),
                                           key=lambda e: -e[1])[:5]}
        del got, model
        torch.cuda.empty_cache()

        losses = {}
        for how in ("kernels", *refs):
            model = init_params(cfg, seed=0, device=dev)
            model.requires_grad_(True)
            opt = make_optimizer("adamw", lr=smoke.TRAIN_LR)
            state = opt[0](param_leaves(model))
            with refs[how]() if how in refs else contextlib.nullcontext():
                run = []
                for tokens, labels in batches:
                    state, loss = train_step(model, opt, state, tokens, labels, None, remat=True)
                    run.append(float(loss))
            losses[how] = run
            del model, opt, state
            torch.cuda.empty_cache()
        diff = {ref: [a - b for a, b in zip(losses["kernels"], losses[ref])] for ref in refs}
        print(json.dumps({"label": args.label, "arch": arch, "kind": KINDS[arch], "smi": smi,
                          "batch": smoke.TRAIN_BATCH, "seq": smoke.TRAIN_SEQ, "grad": grad,
                          "losses": losses, "kernels_minus": diff,
                          "max_abs_loss_diff": {r: max(abs(v) for v in d)
                                                for r, d in diff.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
