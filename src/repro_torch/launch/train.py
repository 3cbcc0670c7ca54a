"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Port of ``repro.launch.train``. The reference trains the reduced smoke
variant on a single device and the full configuration on a mesh through
the train step of ``launch.steps``; here the device decides: on the card
(the default) the full configuration at full width and depth, each step
:func:`~repro_torch.launch.steps.make_train_step`'s on the card's 1×1 mesh
(:func:`~repro_torch.launch.mesh.make_host_mesh`; remat on, which the full
configuration needs to fit), given to ``train`` as its step; on the CPU
(``--device cpu``) the smoke variant through ``train_step``, remat off
unless ``--remat``. Data is the synthetic Markov stream, the optimizer the
one :func:`~repro_torch.train.optimizer.optimizer_for_config` picks.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import ALIASES, get_config, get_smoke_config
from ..device import resolve_device
from ..train import TrainConfig, train
from ..train.optimizer import optimizer_for_config
from .mesh import make_host_mesh, release
from .shapes import InputShape
from .steps import make_train_step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ALIASES), default="phi4-mini-3.8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--remat", action="store_true",
                    help="remat for the smoke configuration too (always on for the full one)")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    smoke = dev.type == "cpu"
    cfg = get_smoke_config(args.arch) if smoke else get_config(args.arch)
    remat = args.remat or not smoke
    opt = optimizer_for_config(cfg)
    print(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"optimizer={opt} device={dev} remat={remat}")

    cross_fn = None
    if cfg.arch_type == "vlm":
        def cross_fn(b):
            return torch.ones((b, cfg.num_image_tokens, cfg.d_model)) * 0.01
    if cfg.is_encoder_decoder:
        def cross_fn(b):
            return torch.ones((b, cfg.encoder_seq_len, cfg.d_model)) * 0.01

    tcfg = TrainConfig(
        steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        lr=args.lr, optimizer=opt, log_every=max(args.steps // 10, 1),
        checkpoint_path=args.checkpoint, remat=remat,
    )
    try:
        step = None
        if not smoke:
            step, _ = make_train_step(cfg, make_host_mesh(dev),
                                      InputShape("train", args.seq, args.batch, "train"),
                                      optimizer=opt, lr=args.lr)
        res = train(cfg, tcfg, cross_src_fn=cross_fn, device=dev, step_fn=step)
    finally:
        release()
    print(f"[train] loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
          f"(floor {res.loss_floor:.3f}); {res.tokens_per_s:,.0f} tok/s")


if __name__ == "__main__":
    main()
