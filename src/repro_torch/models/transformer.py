"""Model assembly for the dense decoder (block kind ``attn``).

Port of ``repro.models.transformer``. The reference stacks parameters over
pattern repetitions and scans; PyTorch runs eagerly, so the port keeps one
:class:`Block` per layer in an ``nn.ModuleList`` (layer ``r·|pattern| + j``
is repetition ``r`` of pattern position ``j``).

Entry points, as in the reference:
* :func:`forward_prefill` — last-token logits + populated caches;
* :func:`forward_decode` — one token against the caches (serve step).

Caches are one ``{"k", "v"}`` dict per layer, (B, S, Kv, hd), holding
post-RoPE keys. Unlike the reference's functional updates, the port
preallocates them at the serving capacity and writes each decoded token in
place.

Other block kinds and the encoder-decoder stack raise
``NotImplementedError``: they are later slices of the port (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from .attention import attention_output, blockwise_attention, decode_attention, project_qkv
from .config import ATTN, ModelConfig
from .layers import dense_init, init_attention, init_mlp, rms_norm, swiglu

Cache = Dict[str, torch.Tensor]

_NOT_PORTED = {
    "attn_moe": "MoE blocks (ROADMAP.md, Queue 1, slice 3)",
    "ssm": "Mamba2 SSD blocks (ROADMAP.md, Queue 1, slice 2)",
    "ssm_moe": "hybrid SSM+MoE blocks (ROADMAP.md, Queue 1, slice 3)",
    "ssm_mlp": "hybrid SSM blocks (ROADMAP.md, Queue 1, slice 3)",
    "cross": "cross-attention blocks (ROADMAP.md, Queue 1, slice 3)",
}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice has not ported."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            "(ROADMAP.md, Queue 1, slice 3)")
    for kind in cfg.layout_pattern:
        if kind != ATTN:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet: {_NOT_PORTED[kind]}")


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One ``attn`` block: pre-norm self-attention + pre-norm SwiGLU."""

    def __init__(self, tensors: Dict) -> None:
        super().__init__()
        self.ln1 = _frozen(tensors["ln1"])
        self.attn = nn.ParameterDict({k: _frozen(v) for k, v in tensors["attn"].items()})
        self.ln2: Optional[nn.Parameter] = None
        self.mlp: Optional[nn.ParameterDict] = None
        if "mlp" in tensors:
            self.ln2 = _frozen(tensors["ln2"])
            self.mlp = nn.ParameterDict({k: _frozen(v) for k, v in tensors["mlp"].items()})

    def ffn(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        if self.mlp is None:
            return x
        h = rms_norm(x, self.ln2, eps)
        return x + swiglu(h, self.mlp["w_gate"], self.mlp["w_up"], self.mlp["w_down"])


class Transformer(nn.Module):
    """Weights of a dense decoder, in the reference's layouts."""

    def __init__(self, cfg: ModelConfig, tensors: Dict) -> None:
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg.validate()
        self.embed = _frozen(tensors["embed"])                 # (V, D)
        self.final_norm = _frozen(tensors["final_norm"])
        self.head = None if cfg.tie_embeddings else _frozen(tensors["head"])   # (D, V)
        if len(tensors["blocks"]) != cfg.num_layers:
            raise ValueError(f"{len(tensors['blocks'])} blocks for {cfg.num_layers} layers")
        self.blocks = nn.ModuleList(Block(t) for t in tensors["blocks"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed.T if self.head is None else self.head
        return x @ head


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[torch.device | str] = None) -> Transformer:
    """Random weights with the reference's distributions, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    check_supported(cfg)                 # before drawing any weights
    dt = _dtype(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tensors: Dict = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), scale=0.02, dtype=dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        tensors["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype=dt)
    blocks = []
    for _ in range(cfg.num_layers):
        blk: Dict = {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=dev)}
        blk["attn"] = init_attention(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm, dtype=dt)
        if cfg.d_ff:
            blk["ln2"] = torch.ones((cfg.d_model,), dtype=dt, device=dev)
            blk["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dt)
        blocks.append(blk)
    tensors["blocks"] = blocks
    return Transformer(cfg, tensors)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _kv_cache(cfg: ModelConfig, batch: int, slots: int, dtype: torch.dtype,
              device: torch.device) -> List[Cache]:
    shape = (batch, slots, cfg.num_kv_heads, cfg.resolved_head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]


def init_cache(cfg: ModelConfig, batch: int, max_cache_len: int,
               dtype: Optional[torch.dtype] = None,
               device: Optional[torch.device | str] = None) -> List[Cache]:
    """Empty serving caches for :func:`forward_decode`; sliding-window
    models keep only the window."""
    check_supported(cfg)
    slots = min(max_cache_len, cfg.sliding_window) if cfg.sliding_window else max_cache_len
    return _kv_cache(cfg, batch, slots, dtype or _dtype(cfg), resolve_device(device))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward_prefill(model: Transformer, tokens: torch.Tensor,
                    max_cache_len: int) -> Tuple[torch.Tensor, List[Cache], int]:
    """Returns (last-token logits (B, 1, V), caches, cache_len).

    The caches hold ``max(max_cache_len, S)`` slots, the prompt's post-RoPE
    k/v first and zeros after.
    """
    cfg = model.cfg
    b, s = tokens.shape
    x = model.embed[tokens]
    pos = torch.arange(s, device=tokens.device).expand(b, s)
    caches = _kv_cache(cfg, b, max(max_cache_len, s), x.dtype, x.device)
    for blk, cache in zip(model.blocks, caches):
        h = rms_norm(x, blk.ln1, cfg.norm_eps)
        q, k, v = project_qkv(blk.attn, h, pos, cfg.rope_theta, cfg.qk_norm,
                              use_rope=True, norm_eps=cfg.norm_eps)
        attn = blockwise_attention(q, k, v, causal=True, window=cfg.sliding_window)
        x = x + attention_output(blk.attn, attn)
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
        x = blk.ffn(x, cfg.norm_eps)
    return model.logits(x[:, -1:]), caches, s


def forward_decode(model: Transformer, token: torch.Tensor, caches: List[Cache],
                   cache_len: int) -> Tuple[torch.Tensor, List[Cache], int]:
    """One new token (B, 1) against ``caches`` (updated in place).

    Returns (logits (B, 1, V), caches, cache_len + 1).
    """
    cfg = model.cfg
    b = token.shape[0]
    x = model.embed[token]
    pos = torch.full((b, 1), cache_len, dtype=torch.long, device=token.device)
    for blk, cache in zip(model.blocks, caches):
        slots = cache["k"].shape[1]
        write_pos = cache_len % slots if cfg.sliding_window else cache_len
        if write_pos >= slots:
            raise ValueError(f"cache full: {slots} slots, writing position {write_pos}")
        h = rms_norm(x, blk.ln1, cfg.norm_eps)
        q, k, v = project_qkv(blk.attn, h, pos, cfg.rope_theta, cfg.qk_norm,
                              use_rope=True, norm_eps=cfg.norm_eps)
        cache["k"][:, write_pos] = k[:, 0]
        cache["v"][:, write_pos] = v[:, 0]
        attn = decode_attention(q, cache["k"], cache["v"], write_pos + 1,
                                window=cfg.sliding_window)
        x = x + attention_output(blk.attn, attn)
        x = blk.ffn(x, cfg.norm_eps)
    return model.logits(x), caches, cache_len + 1
