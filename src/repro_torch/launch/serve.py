"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Prefill + greedy decode, as ``repro.launch.serve`` does: the prompt goes
through :func:`forward_prefill` (the flash-attention kernel in every
``attn`` layer, the SSD scan kernel in every ``ssm`` layer), then each new
token through :func:`forward_decode`. Runs on ``cuda`` unless ``--device``
says otherwise.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from ..configs import ALIASES, get_smoke_config
from ..device import resolve_device
from ..models import Transformer, forward_decode, forward_prefill, init_params


class Generation(NamedTuple):
    ids: torch.Tensor              # (B, new_tokens + 1) greedy ids
    prefill_logits: torch.Tensor   # (B, 1, V) last prompt position
    last_logits: torch.Tensor      # (B, 1, V) last decode step
    prefill_s: float               # host clock, device work included
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(model: Transformer, tokens: torch.Tensor, new_tokens: int) -> Generation:
    """Prefill ``tokens`` (B, S), then ``new_tokens`` greedy decode steps.

    The caches hold ``S + new_tokens + 1`` slots. The first id comes from
    the prefill logits and one more from each decode step.
    """
    dev = model.device
    _sync(dev)
    t0 = time.perf_counter()
    max_len = tokens.shape[1] + new_tokens + 1
    logits, caches, clen = forward_prefill(model, tokens, max_len)
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
    res = generate(model, tokens, args.new_tokens)
    print(f"[serve] arch={cfg.name} device={dev} generated {args.new_tokens} tokens × "
          f"batch {args.batch} in {res.decode_s:.2f}s "
          f"({args.new_tokens * args.batch / res.decode_s:.1f} tok/s)")
    print("[serve] sample ids:", res.ids[0, :16].tolist())


if __name__ == "__main__":
    main()
