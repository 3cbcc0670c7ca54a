"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Prefill + greedy decode, as ``repro.launch.serve`` does: the prompt goes
through :func:`forward_prefill` (the flash-attention kernel in every
self-attention, cross-attention and encoder layer, the SSD scan kernel in
every Mamba2 layer), then each new token through :func:`forward_decode`.
A VLM or an encoder-decoder gets the reference's stub modality input
(:func:`stub_cross_src`). Runs on ``cuda`` unless ``--device`` says
otherwise.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional

import torch

from ..configs import ALIASES, get_smoke_config
from ..device import resolve_device
from ..models import ModelConfig, Transformer, forward_decode, forward_prefill, init_params


class Generation(NamedTuple):
    ids: torch.Tensor              # (B, new_tokens + 1) greedy ids
    prefill_logits: torch.Tensor   # (B, 1, V) last prompt position
    last_logits: torch.Tensor      # (B, 1, V) last decode step
    prefill_s: float               # host clock, device work included
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stub_cross_src(cfg: ModelConfig, batch: int, device: torch.device,
                   dtype: Optional[torch.dtype] = None) -> Optional[torch.Tensor]:
    """The reference's stub modality input, 0.01 everywhere: image patch
    embeddings (B, num_image_tokens, D) for a VLM, frame embeddings
    (B, encoder_seq_len, D) for an encoder-decoder; None for the others."""
    if cfg.arch_type == "vlm":
        length = cfg.num_image_tokens
    elif cfg.is_encoder_decoder:
        length = cfg.encoder_seq_len
    else:
        return None
    return torch.full((batch, length, cfg.d_model), 0.01, dtype=dtype or torch.float32,
                      device=device)


@torch.inference_mode()
def generate(model: Transformer, tokens: torch.Tensor, new_tokens: int,
             cross_src: Optional[torch.Tensor] = None) -> Generation:
    """Prefill ``tokens`` (B, S) (with ``cross_src``, see
    :func:`forward_prefill`), then ``new_tokens`` greedy decode steps.

    The caches hold ``S + new_tokens + 1`` slots. The first id comes from
    the prefill logits and one more from each decode step.
    """
    dev = model.device
    _sync(dev)
    t0 = time.perf_counter()
    max_len = tokens.shape[1] + new_tokens + 1
    logits, caches, clen = forward_prefill(model, tokens, max_len, cross_src)
    prefill_logits = logits
    tok = torch.argmax(logits[:, -1:], dim=-1)
    _sync(dev)
    t1 = time.perf_counter()
    out = [tok]
    for _ in range(new_tokens):
        logits, caches, clen = forward_decode(model, tok, caches, clen)
        tok = torch.argmax(logits, dim=-1)                      # (B, 1)
        out.append(tok)
    _sync(dev)
    t2 = time.perf_counter()
    return Generation(torch.cat(out, dim=1), prefill_logits, logits, t1 - t0, t2 - t1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ALIASES), default="qwen3-14b")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    model = init_params(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen).to(dev)
    cross = stub_cross_src(cfg, args.batch, dev, model.embed.dtype)
    res = generate(model, tokens, args.new_tokens, cross)
    print(f"[serve] arch={cfg.name} device={dev} generated {args.new_tokens} tokens × "
          f"batch {args.batch} in {res.decode_s:.2f}s "
          f"({args.new_tokens * args.batch / res.decode_s:.1f} tok/s)")
    print("[serve] sample ids:", res.ids[0, :16].tolist())


if __name__ == "__main__":
    main()
