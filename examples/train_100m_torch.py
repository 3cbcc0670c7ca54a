"""End-to-end training script of the PyTorch port: ~100M parameters.

The port of ``examples/train_100m.py``: a 12-layer/512-dim GQA decoder
(≈100M params with the 32k vocab, f32) on the synthetic Markov stream; loss
should fall from ~ln(V) toward the chain entropy. Checkpoints every 100
steps to ``--checkpoint`` and resumes from it if re-run. Runs on the card
unless ``--device cpu``.

Usage: PYTHONPATH=src python examples/train_100m_torch.py [--steps 300]
"""
import argparse

from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.train import TrainConfig, train


def model_100m() -> ModelConfig:
    return ModelConfig(
        name="demo-100m",
        arch_type="dense",
        num_layers=12,
        d_model=512,
        num_heads=8,
        num_kv_heads=2,
        d_ff=2048,
        vocab_size=32_768,
        layout_pattern=(ATTN,),
        dtype="float32",
        source="examples/train_100m.py",
    ).validate()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--checkpoint", default="build/train_100m_torch.msgpack")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()
    cfg = model_100m()
    n = cfg.param_count()
    print(f"model: {cfg.name}  params={n / 1e6:.1f}M")
    res = train(cfg, TrainConfig(
        steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        lr=1e-3, log_every=25,
        checkpoint_path=args.checkpoint, checkpoint_every=100,
    ), device=args.device)
    print(f"first loss {res.losses[0]:.3f} -> last {res.losses[-1]:.3f} "
          f"(floor = chain entropy {res.loss_floor:.3f})")
    print(f"throughput: {res.tokens_per_s:,.0f} tokens/s on {args.device or 'cuda'}")


if __name__ == "__main__":
    main()
