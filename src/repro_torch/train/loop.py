"""Training loop: config-driven trainer on the card, or on the CPU when asked.

Port of ``repro.train.loop``: the same ``TrainConfig``, resume rule, data
and loss; the model is a :class:`~repro_torch.models.transformer.Transformer`
made trainable, updated in place by the optimizer. One step is the
module-level :func:`train_step`, so tests can drive it on converted weights.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..kernels import ops
from ..models.config import ModelConfig
from ..models.convert import param_leaves
from ..models.transformer import Transformer, forward_train, init_params
from .checkpoint import restore_checkpoint, save_checkpoint
from .data import DataConfig, MarkovDataset
from .optimizer import OptState, make_optimizer


@dataclass
class TrainConfig:
    steps: int = 200
    batch_size: int = 8
    seq_len: int = 64
    lr: float = 3e-3
    optimizer: str = "adamw"
    log_every: int = 20
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 100
    seed: int = 0
    # recompute each pattern repetition in the backward; the reference's
    # loop trains without (loop.py's ``remat=False``), its mesh step with
    remat: bool = False


@dataclass
class TrainResult:
    losses: List[float]
    steps: int
    tokens_per_s: float
    loss_floor: float             # data-generating entropy


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The reference's loss, ``-mean(log_softmax(f32 logits)[label])``: B6
    (:func:`repro_torch.kernels.ops.cross_entropy_loss`) on the card, its
    plain versions on the CPU, the eager chain on meta tensors."""
    return ops.cross_entropy_loss(logits, labels)


def train_step(model: Transformer, opt: Tuple[Callable, Callable], opt_state: OptState,
               tokens: torch.Tensor, labels: torch.Tensor,
               cross: Optional[torch.Tensor] = None, remat: bool = False,
               loss_fn: Callable = cross_entropy_loss) -> Tuple[OptState, torch.Tensor]:
    """One step: loss (``loss_fn(logits, labels)``) and gradients through
    :func:`forward_train`, then the optimizer's update (``opt`` is
    ``make_optimizer``'s (init, update)) in place. Returns (the new state,
    the loss before the update, detached). A parameter that gets no
    gradient takes zeros, as ``jax.grad`` gives it."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn(forward_train(model, tokens, cross, remat=remat), labels)
    loss.backward()
    params = param_leaves(model)
    grads = [[t.grad if t.grad is not None else torch.zeros_like(t) for t in leaf.tensors]
             for leaf in params]
    _, opt_state = opt[1](grads, opt_state, params)
    del grads
    model.zero_grad(set_to_none=True)
    return opt_state, loss.detach()


def train(model_cfg: ModelConfig, cfg: TrainConfig,
          cross_src_fn: Optional[Callable[[int], object]] = None,
          device: Optional[torch.device | str] = None,
          step_fn: Optional[Callable] = None) -> TrainResult:
    """The reference's ``train`` on ``device`` (the card unless the caller
    asks for the CPU); weights drawn from ``cfg.seed`` with the port's
    generator. Each step is :func:`train_step` unless the caller gives
    ``step_fn(model, opt_state, tokens, labels, cross_src) -> (model,
    opt_state, loss)`` over the state of ``make_optimizer(cfg.optimizer,
    lr=cfg.lr)`` (the launcher's mesh step)."""
    dev = resolve_device(device)
    model = init_params(model_cfg, seed=cfg.seed, device=dev)
    model.requires_grad_(True)
    opt = make_optimizer(cfg.optimizer, lr=cfg.lr)
    opt_state = opt[0](param_leaves(model))
    start_step = 0
    if cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
        model, opt_state, start_step, _ = restore_checkpoint(
            cfg.checkpoint_path, model, opt_state
        )
    data = MarkovDataset(DataConfig(
        vocab_size=model_cfg.vocab_size, seq_len=cfg.seq_len,
        batch_size=cfg.batch_size, seed=cfg.seed,
    ))

    cross_src = None
    if cross_src_fn:
        cross_src = torch.as_tensor(cross_src_fn(cfg.batch_size), device=dev)
    if step_fn is None:
        def step_fn(model, opt_state, tokens, labels, cross):
            opt_state, loss = train_step(model, opt, opt_state, tokens, labels, cross,
                                         remat=cfg.remat)
            return model, opt_state, loss

    losses: List[float] = []
    t0 = time.time()
    batches = data.batches(start_step)
    for step in range(start_step, cfg.steps):
        tokens, labels = next(batches)
        tokens = torch.from_numpy(tokens).to(dev)
        labels = torch.from_numpy(labels).to(dev, torch.int64)
        model, opt_state, loss = step_fn(model, opt_state, tokens, labels, cross_src)
        losses.append(float(loss))
        if cfg.log_every and (step + 1) % cfg.log_every == 0:
            print(f"step {step+1:5d}  loss {losses[-1]:.4f}")
        if cfg.checkpoint_path and (step + 1) % cfg.checkpoint_every == 0:
            save_checkpoint(cfg.checkpoint_path, model, opt_state, step + 1)
    dt = max(time.time() - t0, 1e-9)
    tokens_total = (cfg.steps - start_step) * cfg.batch_size * cfg.seq_len
    return TrainResult(
        losses=losses, steps=cfg.steps,
        tokens_per_s=tokens_total / dt,
        loss_floor=data.entropy(),
    )
