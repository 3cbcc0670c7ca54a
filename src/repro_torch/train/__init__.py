"""Training substrate: optimizers, data, checkpointing, loop (port of
``repro.train``)."""
from .checkpoint import restore_checkpoint, save_checkpoint
from .data import DataConfig, MarkovDataset
from .loop import TrainConfig, TrainResult, cross_entropy_loss, train, train_step
from .optimizer import (
    AdafactorConfig,
    AdamWConfig,
    OptState,
    adafactor,
    adamw,
    make_optimizer,
    optimizer_for_config,
)

__all__ = [k for k in dir() if not k.startswith("_")]
